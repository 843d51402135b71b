"""Runtime lock-order checker — the KTPU_LOCK_CHECK=1 instrumented locks (a
copy of the JAX package's ``analysis/lockcheck.py``; it imports no jax).

Every lock of the port's host modules (the store, queue, cache, metrics,
tracing, the memory ledger, the sidecar engine, the control plane) is
constructed through `make_lock(name)` / `make_rlock(name)`, which return
plain `threading.Lock`/`RLock` objects unless KTPU_LOCK_CHECK is set — in
which case they return a `CheckedLock` that records, per thread, the stack
of held locks and folds every observed (held -> acquired) pair into a
process-wide order graph.  An acquisition that closes a cycle in that graph
is a potential deadlock (two threads interleaving the two paths hang),
recorded as a `LockOrderViolation` with both witness stacks.

This is the runtime analog of golang's lock-order annotations / the kernel's
lockdep: cycles are detected from SINGLE-thread observations, so one run or
chaos storm under KTPU_LOCK_CHECK=1 is enough to flag an inversion that
would only hang under a rare two-thread interleaving.

Zero-cost when off: `make_lock` reads the env once per construction and
hands back a bare threading primitive — the hot paths never see a wrapper.
The JAX package's static half (``analysis/lockorder.py``, the AST graph) is
not ported.

Usage (tests/test_torch_lockcheck.py, the chaos storm):

    monkeypatch.setenv("KTPU_LOCK_CHECK", "1")
    lockcheck.reset()
    ... run the workload ...
    lockcheck.assert_clean()   # raises with witnesses on any cycle
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Set, Tuple


def enabled() -> bool:
    return os.environ.get("KTPU_LOCK_CHECK", "") not in ("", "0")


# --- process-wide order graph (guarded by its own plain lock) ---
_graph_lock = threading.Lock()
# edge (held -> acquired) -> witness: (thread name, held-stack at observation)
_edges: Dict[Tuple[str, str], Tuple[str, Tuple[str, ...]]] = {}
_violations: List["LockOrderViolation"] = []
# per-thread stacks of held locks, keyed by thread ident and guarded by
# _graph_lock (NOT threading.local: a plain Lock may legally be released by
# a thread other than its acquirer — lock handoff — and the release must
# purge the hold from the ACQUIRER's stack, else every later acquisition on
# that thread records false ordering edges)
_holds: Dict[int, List["CheckedLock"]] = {}


class LockOrderViolation(RuntimeError):
    """An acquisition order that closes a cycle in the observed graph."""

    def __init__(self, cycle: List[str], thread: str,
                 stack: Tuple[str, ...], witnesses: List[str]):
        self.cycle = cycle
        self.thread = thread
        self.stack = stack
        self.witnesses = witnesses
        super().__init__(
            "lock-order cycle " + " -> ".join(cycle)
            + f" (thread {thread!r} holding {list(stack)})\n  prior edges:\n  "
            + "\n  ".join(witnesses)
        )


def _stack() -> List["CheckedLock"]:
    """Current thread's hold stack (callers hold _graph_lock)."""
    return _holds.setdefault(threading.get_ident(), [])


def _find_path(src: str, dst: str) -> Optional[List[str]]:
    """DFS over the edge set: a path src ~> dst (callers hold _graph_lock)."""
    seen: Set[str] = {src}
    path = [src]

    def walk(cur: str) -> bool:
        if cur == dst:
            return True
        for (a, b) in _edges:
            if a == cur and b not in seen:
                seen.add(b)
                path.append(b)
                if walk(b):
                    return True
                path.pop()
        return False

    return path if walk(src) else None


def _note_intent(lock: "CheckedLock") -> None:
    """Fold the (held -> lock) ordering edges into the graph BEFORE the
    potentially-blocking acquire, lockdep-style: when the flagged
    interleaving actually deadlocks, the violation and witnesses are already
    recorded instead of both threads hanging inside acquire() with an empty
    graph."""
    with _graph_lock:
        st = _stack()
        # holds are tracked PER INSTANCE: only re-acquiring this exact lock
        # is a re-entrant hold (no new ordering information).  Two
        # *different* instances sharing a name (per-object locks like
        # StreamingHist._lock) must NOT collapse into one hold — their
        # nesting is real ordering.
        if any(x is lock for x in st):
            if not lock.reentrant:
                # the holder re-acquiring a non-reentrant lock blocks
                # forever — record the guaranteed self-deadlock first
                _violations.append(LockOrderViolation(
                    [lock.name, lock.name], threading.current_thread().name,
                    tuple(dict.fromkeys(x.name for x in st)),
                    [f"{lock.name} re-acquired by its own holder "
                     "(non-reentrant)"]))
            return
        name = lock.name
        held = tuple(dict.fromkeys(x.name for x in st))  # unique, ordered
        if not held:
            return
        tname = threading.current_thread().name
        for h in held:
            edge = (h, name)
            if edge in _edges:
                continue
            if h == name:
                # two distinct instances of one named lock nested: no
                # name-level order can serialize them — the mirror
                # nesting on another thread is an ABBA deadlock
                # (lockdep's same-class rule; annotate a true hierarchy
                # by giving the levels distinct names)
                _violations.append(LockOrderViolation(
                    [name, name], tname, held,
                    [f"{h} -> {name} (distinct instances of one name)"]))
                _edges[edge] = (tname, held)
                continue
            # does name ~> h already exist?  Then h -> name closes
            # a cycle: some earlier acquisition path orders name
            # before h, this one orders h before name.
            back = _find_path(name, h)
            if back is not None:
                cycle = back + [name]
                witnesses = [
                    f"{a} -> {b} (thread {w[0]!r}, holding {list(w[1])})"
                    for (a, b), w in _edges.items()
                    if a in cycle and b in cycle
                ]
                _violations.append(LockOrderViolation(
                    cycle, tname, held, witnesses))
            _edges[edge] = (tname, held)


def _push_hold(lock: "CheckedLock") -> None:
    with _graph_lock:
        _stack().append(lock)


def _record_release(lock: "CheckedLock") -> None:
    with _graph_lock:
        st = _stack()
        # release the most recent hold of `lock` (with-blocks unwind LIFO,
        # but explicit acquire/release pairs may interleave)
        for i in range(len(st) - 1, -1, -1):
            if st[i] is lock:
                del st[i]
                return
        # not held by this thread: a plain Lock released by a thread other
        # than its acquirer (lock handoff — legal for threading.Lock).
        # Purge the hold from the acquirer's stack, else that thread
        # records a false (lock -> X) edge on every later acquisition.
        for other in _holds.values():
            for i in range(len(other) - 1, -1, -1):
                if other[i] is lock:
                    del other[i]
                    return


class CheckedLock:
    """A Lock/RLock wrapper recording acquisition order per thread.

    Violations are RECORDED, not raised at the acquire site — raising inside
    arbitrary lock-holding code would corrupt the very invariants under
    test; the harness/test asserts `violations()` is empty at the end
    (`assert_clean`)."""

    def __init__(self, name: str, reentrant: bool = False):
        self.name = name
        self.reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if blocking:
            _note_intent(self)  # edges land before a deadlock can hang us
            got = self._inner.acquire(True, timeout)
        else:
            # a trylock cannot block, so it creates no deadlock ordering
            # until it SUCCEEDS (lockdep's trylock rule)
            got = self._inner.acquire(False)
            if got:
                _note_intent(self)
        if got:
            _push_hold(self)
        return got

    def release(self) -> None:
        # inner release FIRST: an illegal release (e.g. cross-thread RLock
        # release) raises here with the checker's hold records untouched —
        # recording first would purge the true owner's hold and silently
        # blind the checker to that thread's later ordering edges
        self._inner.release()
        _record_release(self)

    def __enter__(self) -> "CheckedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        locked = getattr(self._inner, "locked", None)
        return locked() if locked is not None else False

    def __repr__(self) -> str:
        kind = "RLock" if self.reentrant else "Lock"
        return f"CheckedLock({self.name!r}, {kind})"


def make_lock(name: str):
    """A mutex for `name` (e.g. "ClusterStore._lock"): plain threading.Lock
    unless KTPU_LOCK_CHECK is set."""
    if enabled():
        return CheckedLock(name, reentrant=False)
    return threading.Lock()


def make_rlock(name: str):
    """Re-entrant variant of make_lock."""
    if enabled():
        return CheckedLock(name, reentrant=True)
    return threading.RLock()


# --- reporting ---
def violations() -> List[LockOrderViolation]:
    with _graph_lock:
        return list(_violations)


def order_graph() -> Dict[Tuple[str, str], Tuple[str, Tuple[str, ...]]]:
    """The observed (held -> acquired) edges with their first witnesses."""
    with _graph_lock:
        return dict(_edges)


def reset() -> None:
    """Clear the order graph and violation list (test isolation).  Does not
    touch per-thread hold stacks — live threads keep their true holds."""
    with _graph_lock:
        _edges.clear()
        _violations.clear()


def assert_clean() -> None:
    """Raise the first recorded violation (with its witnesses), if any."""
    vs = violations()
    if vs:
        raise vs[0]


def report() -> Dict[str, object]:
    """Machine-readable summary for bench artifacts (harness lock_check
    block)."""
    with _graph_lock:
        return {
            "enabled": enabled(),
            "edges": sorted(f"{a} -> {b}" for a, b in _edges),
            "violations": [
                {"cycle": v.cycle, "thread": v.thread, "stack": list(v.stack)}
                for v in _violations
            ],
        }
