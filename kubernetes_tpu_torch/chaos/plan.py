"""Deterministic fault injection — the chaos plan and its injector.

The port's copy of the JAX package's ``chaos/plan.py``.  A seeded
`FaultPlan` names which invocation of which hook site fails and how, and
the `ChaosInjector` fires it deterministically, so a chaos parity test can
assert that under an injected plan the verdicts are the fault-free ones.

Hook sites with callers in the port:

  sidecar.rpc      runtime/client.py — the Schedule RPC: drop (error), hang
                   (sleep then error), partial (truncated response)
  sidecar.health   runtime/client.py — the Health RPC: drop
  pipeline.step    parallel/pipeline.py — the loop's fetch: error, nan;
                   recovered by _recover_wave's serial replay
  scheduler.step   scheduler/scheduler.py — the batch step: error, nan
                   (poisoned verdicts); recovered by the serial replay
  host.stall       scheduler/scheduler.py, parallel/pipeline.py — inside
                   the encode window
  kill.post_assume, kill.post_checkpoint, kill.mid_flush, kill.mid_step
                   scheduler/ — the bind path's process-death points
                   (kill.mid_step also the loop's fetch); restarted by
                   scheduler.run_restartable / run_ha_restartable
  kill.submit, kill.dispatch, kill.collect, kill.drain
                   parallel/pipeline.py — the streaming loop's; restarted
                   by run_stream_restartable

The rest of the JAX package's site table (compile.cache, kubelet.sync) is
kept whole, so a plan parses and a seed draws the same faults as there;
their callers are not ported.

Every fired fault emits a `fault_injected` span + a
`framework_fault_injected_total{site,action}` counter; every recovery the
components perform emits a `recovery` span + a
`framework_fault_recovery_total{site,action}` counter (record_recovery) —
the observability contract the tests assert on.

Knobs: KTPU_CHAOS_SEED=<int> installs FaultPlan.from_seed(seed);
KTPU_FAULT_PLAN="site:action@at[:param];..." installs an explicit plan
(`@*` = every invocation).
"""

from __future__ import annotations

import contextlib
import os
import random
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
from ..analysis.lockcheck import make_lock

# site -> the actions a seeded plan may draw for it
SITE_ACTIONS: Dict[str, Tuple[str, ...]] = {
    "sidecar.rpc": ("error", "hang", "partial"),
    "sidecar.health": ("error",),
    "pipeline.step": ("error", "nan"),
    "scheduler.step": ("error", "nan"),
    "compile.cache": ("corrupt",),
    "host.stall": ("stall",),
    "kubelet.sync": ("crash",),
    # process-death kill points (scheduler.kill family): a `kill` action
    # simulates kill -9 at an enumerated point of the bind path — it raises
    # ProcessKilled (BaseException: no component's Exception-level recovery
    # may "handle" it) and latches the module-wide killed() flag so the dead
    # instance's finally-blocks do nothing a SIGKILL'd process couldn't.
    # Recovery is a RESTART: scheduler.restart_scheduler builds a fresh
    # Scheduler on the surviving store and replays the checkpoint.
    "kill.post_assume": ("kill",),      # post cache.assume, pre checkpoint
    "kill.post_checkpoint": ("kill",),  # checkpoint durable, bind unpublished
    "kill.mid_flush": ("kill",),        # mid deferred-commit flush fan-out
    "kill.mid_step": ("kill",),         # mid device step, donated bufs in flight
    # the STREAMING kill family (parallel/pipeline.py): death points of the
    # pipelined loop itself.  Recovery is pipeline.run_stream_restartable —
    # a fresh loop replaying every wave the stream WAL has not committed.
    "kill.submit": ("kill",),           # wave accepted, nothing dispatched
    "kill.dispatch": ("kill",),         # dispatched, donated bufs in flight
    "kill.collect": ("kill",),          # verdicts fetched but uncommitted
    "kill.drain": ("kill",),            # final in-flight wave unharvested
}

# the kill-point family: excluded from seeded storms UNLESS explicitly
# requested (sites=) — a kill is only recoverable by a caller running the
# crash-restart protocol, and pre-existing seeds must keep producing the
# exact same plans (same seed -> same plan, bit for bit)
KILL_SITES: Tuple[str, ...] = (
    "kill.post_assume", "kill.post_checkpoint", "kill.mid_flush",
    "kill.mid_step",
)

# the streaming loop's kill points, a SEPARATE tuple on purpose: existing
# seeded storms and parity tests draw from KILL_SITES (from_seed(seed,
# sites=KILL_SITES) must keep producing identical plans), so new sites may
# only ever extend the site table at the end, never reshuffle that tuple
STREAM_KILL_SITES: Tuple[str, ...] = (
    "kill.submit", "kill.dispatch", "kill.collect", "kill.drain",
)

# every process-death site (what "has a kill been armed?" checks should use)
ALL_KILL_SITES: Tuple[str, ...] = KILL_SITES + STREAM_KILL_SITES

ALWAYS = -1  # Fault.at sentinel: fire on every invocation of the site


class FaultInjected(RuntimeError):
    """Raised by the injector for error/hang/crash actions; components treat
    it exactly like the organic failure it stands in for (an RpcError, an
    XLA runtime error, a plugin bug)."""

    def __init__(self, fault: "Fault"):
        super().__init__(f"injected fault {fault.site}:{fault.action}@{fault.at}")
        self.fault = fault


class ProcessKilled(BaseException):
    """Simulated kill -9 at an enumerated kill point.

    Deliberately a BaseException: every in-process recovery path catches
    Exception, and a SIGKILL'd process gets no chance to recover, flush or
    clean up — the only legitimate response is a restart from checkpoint +
    LIST/WATCH (scheduler.restart_scheduler).  The injector latches the
    module-wide killed() flag BEFORE raising so the dying instance's
    finally-blocks (deferred-bind flush, pipeline drain) see the process as
    dead and do nothing; the restart driver calls revive() once the
    replacement is constructed."""

    def __init__(self, fault: "Fault"):
        super().__init__(f"process killed at {fault.site}@{fault.at}")
        self.fault = fault


@dataclass(frozen=True)
class Fault:
    site: str
    action: str
    at: int = 0        # fires on invocations [at, at+count) of the site; ALWAYS = every one
    count: int = 1
    param: float = 0.0  # hang/stall seconds

    def spec(self) -> str:
        at = "*" if self.at == ALWAYS else (
            str(self.at) if self.count == 1 else f"{self.at}+{self.count}"
        )
        s = f"{self.site}:{self.action}@{at}"
        if self.param:
            s += f":{self.param}"
        return s

    def covers(self, n: int) -> bool:
        return self.at == ALWAYS or self.at <= n < self.at + self.count


class FaultPlan:
    """An ordered set of faults; first match per (site, invocation) wins."""

    def __init__(self, faults, seed: Optional[int] = None):
        self.faults: Tuple[Fault, ...] = tuple(faults)
        self.seed = seed
        for f in self.faults:
            if f.site not in SITE_ACTIONS:
                raise ValueError(f"unknown chaos site {f.site!r}")
            if f.action not in SITE_ACTIONS[f.site]:
                raise ValueError(
                    f"site {f.site!r} does not support action {f.action!r}"
                )

    def describe(self) -> str:
        head = f"seed={self.seed} " if self.seed is not None else ""
        return head + ";".join(f.spec() for f in self.faults)

    def match(self, site: str, n: int) -> Optional[Fault]:
        for f in self.faults:
            if f.site == site and f.covers(n):
                return f
        return None

    @classmethod
    def single(cls, site: str, action: str, at: int = 0, count: int = 1,
               param: float = 0.0) -> "FaultPlan":
        return cls([Fault(site, action, at, count, param)])

    @classmethod
    def parse(cls, text: str) -> "FaultPlan":
        """"site:action@at[:param];..." — `@*` fires every invocation,
        `@a+k` fires k consecutive invocations starting at a."""
        faults: List[Fault] = []
        for part in text.split(";"):
            part = part.strip()
            if not part:
                continue
            site, _, rest = part.partition(":")
            action, _, where = rest.partition("@")
            if not site or not action or not where:
                raise ValueError(f"bad fault spec {part!r} "
                                 "(want site:action@at[:param])")
            where, _, param = where.partition(":")
            if where == "*":
                at, count = ALWAYS, 1
            elif "+" in where:
                a, _, k = where.partition("+")
                at, count = int(a), int(k)
            else:
                at, count = int(where), 1
            faults.append(Fault(site.strip(), action.strip(), at, count,
                                float(param) if param else 0.0))
        return cls(faults)

    @classmethod
    def from_seed(cls, seed: int, n_faults: int = 8,
                  sites: Optional[Tuple[str, ...]] = None,
                  horizon: int = 12) -> "FaultPlan":
        """A deterministic storm: n_faults draws of (site, action, ordinal)
        over the first `horizon` invocations of each site.  Same seed ->
        same plan, bit for bit — replaying a failing seed reproduces the
        exact fault sequence.

        The default pool excludes the kill.* sites: a kill is recoverable
        only by a caller running the crash-restart protocol, and existing
        seeds must keep producing identical plans.  Pass sites= (e.g. from
        sites_matching("kill.*")) to storm the kill points."""
        rng = random.Random(seed)
        pool = tuple(sites) if sites else tuple(
            s for s in SITE_ACTIONS if s not in ALL_KILL_SITES
        )
        faults = []
        for _ in range(n_faults):
            site = pool[rng.randrange(len(pool))]
            actions = SITE_ACTIONS[site]
            action = actions[rng.randrange(len(actions))]
            param = round(rng.uniform(0.005, 0.03), 4) if action in (
                "hang", "stall"
            ) else 0.0
            faults.append(Fault(site, action, rng.randrange(horizon),
                                param=param))
        return cls(faults, seed=seed)


def sites_matching(pattern: str) -> Tuple[str, ...]:
    """Resolve a comma-separated fnmatch glob list against the site table
    (the JAX package's `bench.harness --chaos-sites`).  A `!glob` term excludes; with only
    exclusions the include set defaults to every site.  Examples:
    "kill.*" -> just the kill points; "*,!kill.*" -> everything else;
    "scheduler.*,kill.mid_flush" -> a targeted mix."""
    from fnmatch import fnmatchcase

    include: List[str] = []
    exclude: List[str] = []
    for p in pattern.split(","):
        p = p.strip()
        if not p:
            continue
        (exclude if p.startswith("!") else include).append(p.lstrip("!"))
    if not include:
        include = ["*"]
    return tuple(
        s for s in SITE_ACTIONS
        if any(fnmatchcase(s, p) for p in include)
        and not any(fnmatchcase(s, p) for p in exclude)
    )


class ChaosInjector:
    """Counts invocations per site and fires the plan's matching fault.

    Faults and recoveries are double-booked: on the injector's own Metrics
    (the process-wide chaos ledger) and, when the
    calling component passes its Metrics/Tracer, on those too — so
    `framework_fault_recovery_total{site,action}` shows up next to the
    scheduler's ordinary series and the spans land in whatever collector
    the run exports."""

    def __init__(self, plan: FaultPlan, metrics=None, tracer=None):
        from ..scheduler.metrics import Metrics
        from ..scheduler.tracing import Tracer

        self.plan = plan
        self.metrics = metrics if metrics is not None else Metrics()
        self.tracer = tracer if tracer is not None else Tracer(component="chaos")
        self._lock = make_lock("ChaosInjector._lock")
        self.counts: Dict[str, int] = {}

    def poke(self, site: str, tracer=None, metrics=None, **attrs) -> Optional[Fault]:
        """One invocation of `site`.  Returns None when nothing fires.  For
        error/hang/crash the matching FaultInjected is RAISED (hang sleeps
        param first); stall sleeps and returns the fault; data faults
        (nan/partial/corrupt) are returned for the caller to apply."""
        with self._lock:
            n = self.counts.get(site, 0)
            self.counts[site] = n + 1
        f = self.plan.match(site, n)
        if f is None:
            return None
        self._mark("fault_injected", "framework_fault_injected_total",
                   f, tracer, metrics, invocation=n, **attrs)
        if f.action == "kill":
            # latch BEFORE raising: the dying instance's unwind (finally
            # blocks included) must observe killed() and do nothing
            global _KILLED
            _KILLED = True
            raise ProcessKilled(f)
        if f.action in ("hang", "stall"):
            time.sleep(f.param or 0.01)
        if f.action in ("error", "hang", "crash"):
            raise FaultInjected(f)
        return f

    def _mark(self, span_name: str, counter: str, f: Fault, tracer, metrics,
              **attrs) -> None:
        now = time.perf_counter()
        for tr in {id(t): t for t in (tracer, self.tracer) if t is not None}.values():
            if tr.enabled:
                tr.record_span(span_name, start=now, end=now, site=f.site,
                               action=f.action, **attrs)
        for m in {id(m): m for m in (metrics, self.metrics) if m is not None}.values():
            m.inc_labeled(counter, site=f.site, action=f.action)

    def record_recovery(self, site: str, action: str, tracer=None,
                        metrics=None, start: Optional[float] = None,
                        **attrs) -> None:
        now = time.perf_counter()
        t0 = start if start is not None else now
        for tr in {id(t): t for t in (tracer, self.tracer) if t is not None}.values():
            if tr.enabled:
                tr.record_span("recovery", start=t0, end=now, site=site,
                               action=action, **attrs)
        for m in {id(m): m for m in (metrics, self.metrics) if m is not None}.values():
            m.inc_labeled("framework_fault_recovery_total",
                          site=site, action=action)

    def report(self) -> Dict[str, float]:
        """Injected/recovered counters for bench artifacts."""
        with self.metrics._lock:
            counters = {
                name + self.metrics.render_labels(key): v
                for name, series in self.metrics.labeled_counters.items()
                for key, v in series.items()
            }
        counters["chaos_sites_poked"] = float(sum(self.counts.values()))
        return counters


# --- the process-wide injector (None = chaos off; the poke fast path is one
# global read, so the disabled hot-path cost is a dict lookup away from zero)
_ACTIVE: Optional[ChaosInjector] = None
_FALLBACK_METRICS = None  # recoveries from ORGANIC faults still count
# the kill latch: True from the instant a kill fault fires until the restart
# driver revives — components' drain/flush/cleanup paths check killed() so a
# dead instance's finally-blocks do nothing a SIGKILL'd process couldn't
_KILLED = False


def killed() -> bool:
    """True while the simulated process is dead (a kill fault fired and no
    restart has revived it)."""
    return _KILLED


def revive() -> None:
    """Clear the kill latch — the restart driver's first act, called once
    the replacement scheduler is about to be constructed."""
    global _KILLED
    _KILLED = False


def install(plan: FaultPlan, metrics=None, tracer=None) -> ChaosInjector:
    global _ACTIVE
    _ACTIVE = ChaosInjector(plan, metrics=metrics, tracer=tracer)
    return _ACTIVE


def uninstall() -> None:
    global _ACTIVE
    _ACTIVE = None
    revive()  # a leaked kill latch must not outlive the plan (test hygiene)


def active() -> Optional[ChaosInjector]:
    return _ACTIVE


def enabled() -> bool:
    return _ACTIVE is not None


def poke(site: str, tracer=None, metrics=None, **attrs) -> Optional[Fault]:
    """The component-side hook: no-op (None) unless a plan is installed."""
    inj = _ACTIVE
    if inj is None:
        return None
    return inj.poke(site, tracer=tracer, metrics=metrics, **attrs)


def record_recovery(site: str, action: str, tracer=None, metrics=None,
                    start: Optional[float] = None, **attrs) -> None:
    """Recovery accounting — works with chaos OFF too (organic faults):
    the span lands on the caller's tracer and the counter on the caller's
    metrics plus the module ledger."""
    inj = _ACTIVE
    if inj is not None:
        inj.record_recovery(site, action, tracer=tracer, metrics=metrics,
                            start=start, **attrs)
        return
    global _FALLBACK_METRICS
    if _FALLBACK_METRICS is None:
        from ..scheduler.metrics import Metrics

        _FALLBACK_METRICS = Metrics()
    now = time.perf_counter()
    if tracer is not None and tracer.enabled:
        tracer.record_span("recovery", start=start if start is not None else now,
                           end=now, site=site, action=action, **attrs)
    for m in {id(m): m for m in (metrics, _FALLBACK_METRICS) if m is not None}.values():
        m.inc_labeled("framework_fault_recovery_total", site=site, action=action)


def maybe_install_from_env() -> Optional[ChaosInjector]:
    """KTPU_FAULT_PLAN (explicit spec) wins over KTPU_CHAOS_SEED (seeded
    storm).  Idempotent: an already-installed injector is kept."""
    if _ACTIVE is not None:
        return _ACTIVE
    spec = os.environ.get("KTPU_FAULT_PLAN")
    if spec:
        return install(FaultPlan.parse(spec))
    seed = os.environ.get("KTPU_CHAOS_SEED")
    if seed:
        return install(FaultPlan.from_seed(int(seed)))
    return None


@contextlib.contextmanager
def chaos_plan(plan: FaultPlan, metrics=None, tracer=None):
    """Scoped install for tests: always uninstalls, even on failure."""
    inj = install(plan, metrics=metrics, tracer=tracer)
    try:
        yield inj
    finally:
        uninstall()


# --- shared verdict validation (the NaN-verdict recovery gate) ---
def poisoned_verdicts(choices, n_nodes: int) -> bool:
    """True when a fetched choices vector cannot be decoded: non-finite
    entries (a NaN verdict), or indices outside [-1, n_nodes) (garbage from
    a corrupted readback).  The decode paths check this BEFORE indexing
    node_names, so a poisoned wave routes to the serial-oracle replay
    instead of crashing (or silently binding pods to the wrong node)."""
    ch = np.asarray(choices)
    if ch.size == 0:
        return False
    if np.issubdtype(ch.dtype, np.floating):
        if not bool(np.all(np.isfinite(ch))):
            return True
        ch = ch.astype(np.int64)
    elif not np.issubdtype(ch.dtype, np.integer):
        return True
    return bool(np.any((ch < -1) | (ch >= n_nodes)))


def poison(choices) -> np.ndarray:
    """The nan-action payload: a float copy with every 7th entry NaN —
    what a corrupted device readback looks like to the decode path."""
    ch = np.asarray(choices).astype(np.float64).copy()
    ch[:: 7] = np.nan
    return ch


class PoisonedWave(RuntimeError):
    """A wave whose verdicts failed poisoned_verdicts — recoverable by the
    serial-oracle replay, never by decoding as-is."""
