"""Scheduling queue: activeQ + backoffQ + unschedulablePods.

Analog of pkg/scheduler/backend/queue/scheduling_queue.go — PriorityQueue:

  - activeQ: heap ordered by the queue-sort plugin's Less (priority desc, then
    arrival — PrioritySort)
  - backoffQ: pods recently failed, re-activated after an exponential backoff
    (1s initial, doubling, 10s cap — DefaultPodInitialBackoffDuration /
    DefaultPodMaxBackoffDuration)
  - unschedulablePods: pods that failed with no backoff pending; moved back to
    activeQ/backoffQ when a cluster event that might make them schedulable
    arrives (MoveAllToActiveOrBackoffQueue), filtered through per-plugin
    QueueingHint callbacks — each registered plugin's (event, obj, old, pod)
    -> Queue/Skip hint, so irrelevant churn (e.g. a Node update that shrinks
    allocatable) wakes nobody (isSchedulableAfterNodeChange analogs)

A injectable clock makes backoff deterministic in tests (the reference uses
k8s.io/utils/clock/testing the same way — SURVEY.md §4).

The port's copy of the JAX package's ``scheduler/queue.py``, line for
line: the activeQ order, the backoff arithmetic and the seeded jitter RNG
are what the batch cycle's decisions rest on.
"""

from __future__ import annotations

import functools
import heapq
import itertools
import random
import time as _time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..api import types as t
from ..analysis.lockcheck import make_rlock

INITIAL_BACKOFF_S = 1.0
MAX_BACKOFF_S = 10.0

# Cluster event kinds (framework/types.go — ClusterEvent); plugins that fail a
# pod register which events may resolve the failure (EventsToRegister).
EV_NODE_ADD = "Node/Add"
EV_NODE_UPDATE = "Node/Update"
EV_POD_DELETE = "Pod/Delete"
EV_POD_ADD = "Pod/Add"
EV_ALL = "*"


class Clock:
    def now(self) -> float:
        return _time.monotonic()


class FakeClock(Clock):
    def __init__(self, start: float = 0.0):
        self.t = start

    def now(self) -> float:
        return self.t

    def step(self, dt: float) -> None:
        self.t += dt


@dataclass(order=True)
class _Item:
    sort_key: Tuple
    pod: t.Pod = field(compare=False)


def _locked(fn):
    """Run the method under the queue's re-entrant lock."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)

    return wrapper


class PriorityQueue:
    """Thread-safe: binding-cycle workers requeue/denominate concurrently with
    the scheduling thread's pop (the reference's queue takes its own lock —
    scheduling_queue.go guards activeQ/backoffQ with sync.Cond)."""

    def __init__(self, clock: Optional[Clock] = None, tracer=None,
                 initial_backoff_s: float = INITIAL_BACKOFF_S,
                 max_backoff_s: float = MAX_BACKOFF_S,
                 backoff_jitter: float = 0.0, jitter_seed: int = 0):
        self._lock = make_rlock("PriorityQueue._lock")
        self.clock = clock or Clock()
        # exponential backoff base/cap (podInitialBackoffSeconds /
        # podMaxBackoffSeconds — wired from SchedulerConfiguration), plus a
        # multiplicative jitter fraction: each push matures at
        # duration * (1 + U[0, jitter)).  A FIXED backoff synchronizes the
        # retry storm after a correlated failure (e.g. a sidecar outage
        # parks a whole wave at once, and 1 s later the whole wave retries
        # in one thundering cycle); jitter de-correlates the retries.  The
        # RNG is seeded so runs are reproducible — backoff_duration() stays
        # the pure base for tests/introspection, jitter applies at push.
        self.initial_backoff_s = initial_backoff_s
        self.max_backoff_s = max_backoff_s
        self.backoff_jitter = backoff_jitter
        self._jitter_rng = random.Random(jitter_seed)
        # queue-wait spans (enqueue -> pop) per pod, joining the pod's trace
        # (scheduler/tracing.py); timestamps are real perf_counter values —
        # span time is wall attribution, independent of the injectable
        # backoff clock
        self._tracer = tracer
        self._enq_at: Dict[str, float] = {}
        # uid -> first-admission perf_counter instant, kept across retries:
        # the arrival half of the pod_scheduling_sli_duration_seconds SLI
        # (metrics.go — arrival -> bind).  Unlike _enq_at this is stamped
        # UNCONDITIONALLY (the SLI is metrics-first, not gated on tracing)
        # and consumed/popped at bind publication (take_arrival) or delete,
        # so the table stays bounded by in-flight pods.
        self._arrival_at: Dict[str, float] = {}
        # uid -> latest activeQ-pop instant (tracer-gated, like _enq_at):
        # the queue_wait/wave_wait boundary of the per-pod SLI phase
        # decomposition (pod_sli_phase_duration_seconds — scheduler.py
        # _observe_sli_phases).  Consumed at bind publication (take_popped)
        # or delete, so the table stays bounded like _arrival_at.
        self._popped_at: Dict[str, float] = {}
        # uids whose pop stamp was restored from a checkpoint
        # (restore_popped): the post-restore re-pop must NOT overwrite it —
        # the pod already left the queue once, in the dead leader, and its
        # queue_wait ended there; everything after (blackout included) is
        # wave_wait.  Cleared with the stamp at take_popped/delete.
        self._popped_pinned: Set[str] = set()
        self._seq = itertools.count()
        self._active: List[_Item] = []  # heap
        self._active_uids: Set[str] = set()
        self._backoff: List[Tuple[float, int, t.Pod]] = []  # (ready_at, seq, pod)
        # uid -> (pod, events, hints); hints: event kind -> [(obj, old, pod)
        # -> bool] callbacks (QueueingHintFn — scheduling_queue.go: a parked
        # pod wakes on a registered event only if SOME failing plugin's hint
        # answers Queue; hintless kinds wake unconditionally)
        self._unschedulable: Dict[str, Tuple[t.Pod, Set[str], Dict]] = {}
        self._attempts: Dict[str, int] = {}
        self._arrival: Dict[str, int] = {}
        self._nominated: Dict[str, Tuple[t.Pod, str]] = {}  # uid -> (pod, node)
        # uid -> count of STALE backoff entries to swallow (set at delete();
        # entries pushed before the delete mature earlier than any pushed
        # after a re-add, so draining by count pairs them correctly)
        self._gone: Dict[str, int] = {}
        self._in_backoff: Dict[str, int] = {}  # uid -> live backoff entries
        self._parked_at: Dict[str, float] = {}  # uid -> when parked unschedulable
        # gate-parked pods (backoff=False, e.g. SchedulingGates) wait for
        # their re-add event only — the leftover flush must NOT resurrect
        # them past PreEnqueue
        self._no_flush: Set[str] = set()
        # bumps on every move_all_to_active_or_backoff: schedulers compare
        # against their cycle-start value to detect a move that fired while
        # the cycle ran (the reference's moveRequestCycle guard)
        self.move_seq = 0
        # flushUnschedulablePodsLeftover: parked pods whose events never fire
        # retry anyway after this long (podMaxInUnschedulablePodsDuration, 5m)
        self.max_unschedulable_s = 300.0

    @_locked
    def __len__(self) -> int:
        self._flush_backoff()
        return len(self._active)

    @property
    @_locked
    def pending_total(self) -> int:
        return len(self._active) + len(self._backoff) + len(self._unschedulable)

    @_locked
    def depths(self) -> Dict[str, int]:
        """Per-pool depths in ONE lock acquisition — the queue-pool
        observability sample the batch cycle stamps onto /metrics at each
        cycle boundary (scheduler.py — _sample_queue_depths).  `parked` is
        the backoff+unschedulable union the deferred-commit gate keys on;
        the pools are reported separately so an operator can tell a retry
        storm (backoff) from an event-starved park (unschedulable).
        Matured backoff entries flush first (the __len__/pop convention) —
        a pod whose backoff just expired is activeQ work THIS cycle, and
        reporting it as backoff would under-count the peak at exactly the
        retry-storm moment these gauges diagnose."""
        self._flush_backoff()
        return {
            "active": len(self._active_uids),
            "backoff": len(self._backoff),
            "unschedulable": len(self._unschedulable),
            "parked": len(self._backoff) + len(self._unschedulable),
        }

    @property
    @_locked
    def parked_total(self) -> int:
        """Pods waiting OUTSIDE the activeQ (backoff + unschedulable) — the
        set a cluster-event move could wake.  The batch cycle's deferred
        commit fan-out (scheduler.py — _flush_deferred_binds) is exactly
        serial-equivalent only when this is 0: with nobody parked, the
        deferred binds' AssignedPodAdd moves are no-ops, so delaying them
        into the next device step's window cannot change any queue state."""
        return len(self._backoff) + len(self._unschedulable)

    def _key(self, pod: t.Pod) -> Tuple:
        # PrioritySort.Less: higher priority first, then FIFO by first arrival
        arr = self._arrival.setdefault(pod.uid, next(self._seq))
        return (-pod.priority, arr)

    @_locked
    def add(self, pod: t.Pod) -> None:
        if pod.uid in self._active_uids:
            return
        # a re-added pod supersedes any parked copy (AddUnschedulableIfNotPresent
        # dedupe — without this the leftover flush could resurrect a stale copy)
        self._unschedulable.pop(pod.uid, None)
        self._parked_at.pop(pod.uid, None)
        self._no_flush.discard(pod.uid)
        heapq.heappush(self._active, _Item(self._key(pod), pod))
        self._active_uids.add(pod.uid)
        # first admission wins across retries: arrival -> bind is the SLI
        self._arrival_at.setdefault(pod.uid, _time.perf_counter())
        if self._tracer is not None and self._tracer.enabled:
            # first activation wins: a superseding re-add keeps the original
            # enqueue instant (the wait the pod actually experienced)
            self._enq_at.setdefault(pod.uid, _time.perf_counter())

    def _flush_backoff(self) -> None:
        now = self.clock.now()
        # flushUnschedulablePodsLeftover: event-parked pods retry eventually
        # even if their registered events never fire
        for uid, since in list(self._parked_at.items()):
            if uid not in self._unschedulable:
                del self._parked_at[uid]
            elif uid in self._no_flush:
                continue  # gated: only its registered event may move it
            elif now - since >= self.max_unschedulable_s:
                pod = self._unschedulable.pop(uid)[0]
                del self._parked_at[uid]
                self._push_backoff(pod)
        while self._backoff and self._backoff[0][0] <= now:
            _, _, pod = heapq.heappop(self._backoff)
            left = self._in_backoff.get(pod.uid, 1) - 1
            if left > 0:
                self._in_backoff[pod.uid] = left
            else:
                self._in_backoff.pop(pod.uid, None)
            stale = self._gone.get(pod.uid, 0)
            if stale > 0:
                if stale > 1:
                    self._gone[pod.uid] = stale - 1
                else:
                    del self._gone[pod.uid]
                continue
            self.add(pod)

    def _pop_one(self) -> Optional[t.Pod]:
        """Heap-drain step shared by pop()/pop_all() (caller holds the lock):
        skip superseded entries, bump the attempt counter."""
        while self._active:
            item = heapq.heappop(self._active)
            if item.pod.uid in self._active_uids:
                self._active_uids.discard(item.pod.uid)
                self._attempts[item.pod.uid] = self._attempts.get(item.pod.uid, 0) + 1
                tr = self._tracer
                if tr is not None and tr.enabled:
                    # latest pop wins: after a retry the wait that counts
                    # toward queue_wait is everything up to the pop that
                    # finally led to the bind — EXCEPT a checkpoint-restored
                    # stamp (pinned): the pod's queue_wait ended in the dead
                    # leader, and the re-pop is wave replay, not queueing
                    if item.pod.uid not in self._popped_pinned:
                        self._popped_at[item.pod.uid] = _time.perf_counter()
                    t0 = self._enq_at.pop(item.pod.uid, None)
                    if t0 is not None:
                        # enqueue -> pop as a finished span on the pod's
                        # trace chain (attempt = retry ordinal)
                        tr.record_span(
                            "queue.wait", start=t0, pod_uid=item.pod.uid,
                            pod=item.pod.uid,
                            attempt=self._attempts[item.pod.uid],
                        )
                return item.pod
        return None

    @_locked
    def pop(self) -> Optional[t.Pod]:
        """Next pod in activeQ order, or None if activeQ is empty
        (scheduling_queue.go — Pop; non-blocking variant)."""
        self._flush_backoff()
        return self._pop_one()

    @_locked
    def pop_all(self) -> List[t.Pod]:
        """Drain the activeQ in pop order under ONE lock acquisition — the
        batch cycle's bulk Pop (the reference pops one pod per cycle; the
        batched path would otherwise pay P lock round-trips per cycle)."""
        self._flush_backoff()
        out: List[t.Pod] = []
        while True:
            pod = self._pop_one()
            if pod is None:
                return out
            out.append(pod)

    @_locked
    def backoff_duration(self, pod_uid: str) -> float:
        n = max(0, self._attempts.get(pod_uid, 1) - 1)
        return min(self.max_backoff_s, self.initial_backoff_s * (2**n))

    def _push_backoff(self, pod: t.Pod) -> None:
        """Enter the backoffQ (caller holds the lock): jittered maturity —
        duration * (1 + U[0, jitter)), base already capped at
        max_backoff_s — so correlated failures fan their retries out
        instead of re-arriving as one storm."""
        d = self.backoff_duration(pod.uid)
        if self.backoff_jitter > 0.0:
            d *= 1.0 + self._jitter_rng.random() * self.backoff_jitter
        heapq.heappush(self._backoff, (self.clock.now() + d, next(self._seq), pod))
        self._in_backoff[pod.uid] = self._in_backoff.get(pod.uid, 0) + 1

    @_locked
    def add_unschedulable(self, pod: t.Pod, events: Optional[Set[str]] = None,
                          backoff: bool = True,
                          cycle_move_seq: Optional[int] = None,
                          hints: Optional[Dict] = None) -> None:
        """AddUnschedulableIfNotPresent.  With SPECIFIC events (QueueingHint
        registrations from the failing plugins) the pod parks in
        unschedulablePods until a matching cluster event moves it (through
        backoff) or the leftover flush expires; without them (or with only
        the wildcard) it takes the plain backoff retry path.

        cycle_move_seq is the caller's cycle-start move_seq: compared against
        the live value HERE, under the queue lock (the reference's
        moveRequestCycle guard inside AddUnschedulableIfNotPresent) — a move
        that fired during the cycle means the pod's wake event may already be
        gone, so it takes the plain backoff path instead of parking."""
        if cycle_move_seq is not None and self.move_seq != cycle_move_seq:
            events = None
        # gate-parked pods (backoff=False) enter here without ever passing
        # add(): their SLI clock starts at first admission too
        self._arrival_at.setdefault(pod.uid, _time.perf_counter())
        if events and EV_ALL not in events and backoff:
            self._unschedulable[pod.uid] = (pod, set(events), hints or {})
            self._parked_at[pod.uid] = self.clock.now()
        elif backoff:
            self._push_backoff(pod)
        else:
            self._unschedulable[pod.uid] = (pod, events or {EV_ALL}, hints or {})
            self._parked_at[pod.uid] = self.clock.now()
            self._no_flush.add(pod.uid)

    @_locked
    def move_all_to_active_or_backoff(self, event: str, obj=None, old=None) -> int:
        """MoveAllToActiveOrBackoffQueue on a cluster event; returns #moved.

        With the event OBJECT available, a parked pod's per-plugin
        QueueingHint callbacks decide Queue vs Skip (isPodWorthRequeuing);
        without it (obj None — e.g. a coalesced batch flush) matching event
        kinds wake unconditionally, the pre-hint conservative behavior."""
        self.move_seq += 1
        moved = []
        for uid, (pod, events, hints) in list(self._unschedulable.items()):
            if EV_ALL in events or event in events:
                fns = hints.get(event)
                if obj is not None and fns:
                    try:
                        if not any(fn(obj, old, pod) for fn in fns):
                            continue  # every failing plugin answered Skip
                    except Exception:  # noqa: BLE001 — hint bugs must not strand pods
                        pass
                moved.append(uid)
                del self._unschedulable[uid]
                self._parked_at.pop(uid, None)
                self._no_flush.discard(uid)
                self._push_backoff(pod)
        return len(moved)

    @_locked
    def take_arrival(self, pod_uid: str) -> Optional[float]:
        """Pop and return the pod's first-admission instant — called at
        bind publication so the SLI table never outlives the pods it
        tracks (a later re-add of the same uid restarts the clock)."""
        return self._arrival_at.pop(pod_uid, None)

    @_locked
    def take_popped(self, pod_uid: str) -> Optional[float]:
        """Pop and return the pod's latest activeQ-pop instant — the
        queue_wait/wave_wait boundary of the SLI phase decomposition.
        None when tracing was off or the pod never popped (same lifecycle
        as the queue.wait span it pairs with)."""
        self._popped_pinned.discard(pod_uid)
        return self._popped_at.pop(pod_uid, None)

    @_locked
    def stamp_arrival(self, pod_uid: str, at: float) -> None:
        """Override the pod's first-admission instant with an EXTERNAL
        arrival timestamp (perf_counter domain, possibly in the past) —
        the open-loop replay's coordinated-omission-safe clock
        (bench/loadgen.py): SLI age is measured from the TRACE arrival
        instant, never from send time, so a stalled replay cycle inflates
        p99 honestly instead of hiding the backlog.  Earliest stamp wins,
        matching add()'s first-admission-wins contract in either call
        order."""
        cur = self._arrival_at.get(pod_uid)
        if cur is None or at < cur:
            self._arrival_at[pod_uid] = at

    # --- crash-restart SLI continuity (scheduler/checkpoint.py) ---
    @_locked
    def export_arrivals(self) -> Dict[str, float]:
        """Per-pod first-admission AGE (seconds waited so far) for the
        checkpoint: ages are relative, so the restoring process's
        perf_counter base never needs to match the dead one's."""
        now = _time.perf_counter()
        return {uid: now - t for uid, t in self._arrival_at.items()}

    @_locked
    def restore_arrivals(self, ages: Dict[str, float]) -> int:
        """Re-base checkpointed admission ages onto this process's clock —
        a requeued pod's arrival->bind SLI keeps the wait it already
        served (failover inflates p99 honestly instead of restarting the
        clock).  Only pods the watch replay re-admitted are touched: a
        stale checkpoint entry for a pod that no longer exists must not
        seed an unbounded table.  Returns #restored."""
        now = _time.perf_counter()
        n = 0
        for uid, age in ages.items():
            if uid in self._arrival_at:
                self._arrival_at[uid] = now - max(0.0, float(age))
                n += 1
        return n

    @_locked
    def export_popped(self) -> Dict[str, float]:
        """Per-pod latest activeQ-pop AGE for the checkpoint — the
        queue_wait/wave_wait SLI-phase boundary rides the crash-restart
        state (same age-relative convention as export_arrivals).  Empty
        when tracing is off (the table is tracer-gated)."""
        now = _time.perf_counter()
        return {uid: now - t for uid, t in self._popped_at.items()}

    @_locked
    def restore_popped(self, ages: Dict[str, float]) -> int:
        """Re-base checkpointed pop stamps onto this process's clock and
        PIN them: a pod popped into a wave pre-kill keeps its original
        queue_wait — the takeover blackout and the replay re-pop both land
        in wave_wait, where the dead time actually passed (the telescoping
        invariant tests/test_storm_streaming.py asserts).  Gated like
        restore_arrivals on the watch replay having re-admitted the pod.
        Returns #restored."""
        now = _time.perf_counter()
        n = 0
        for uid, age in ages.items():
            if uid in self._arrival_at:
                self._popped_at[uid] = now - max(0.0, float(age))
                self._popped_pinned.add(uid)
                n += 1
        return n

    @_locked
    def delete(self, pod_uid: str) -> None:
        self._active_uids.discard(pod_uid)
        self._enq_at.pop(pod_uid, None)
        self._arrival_at.pop(pod_uid, None)
        self._popped_at.pop(pod_uid, None)
        self._popped_pinned.discard(pod_uid)
        self._unschedulable.pop(pod_uid, None)
        self._parked_at.pop(pod_uid, None)
        self._no_flush.discard(pod_uid)
        self._nominated.pop(pod_uid, None)
        if self._in_backoff.get(pod_uid):
            # every entry currently in backoff predates this delete: all stale
            self._gone[pod_uid] = self._in_backoff[pod_uid]

    # --- nominator (scheduling_queue.go — nominator: AddNominatedPod /
    # DeleteNominatedPodIfExists / NominatedPodsForNode) ---
    @_locked
    def add_nominated(self, pod: t.Pod, node_name: str) -> None:
        self._nominated[pod.uid] = (pod, node_name)

    @_locked
    def delete_nominated(self, pod_uid: str) -> None:
        self._nominated.pop(pod_uid, None)

    @_locked
    def nominated_pods_for_node(self, node_name: str) -> List[t.Pod]:
        return [p for p, n in self._nominated.values() if n == node_name]

    @property
    @_locked
    def nominated(self) -> Dict[str, Tuple[t.Pod, str]]:
        return dict(self._nominated)
