"""API Priority & Fairness — flow classification + shuffle-sharded fair queuing.

reference: staging/src/k8s.io/apiserver/pkg/util/flowcontrol —
apf_controller.go (match request -> FlowSchema by precedence -> priority
level) and fairqueuing/queueset/queueset.go (per-priority-level queue set:
a flow is hashed to a `hand_size` shuffle-shard of the level's queues, lands
on the shortest; dispatch picks the queue with the least virtual finish time,
so one elephant flow cannot starve mice sharing the level).  Seats/concurrency
are normalized to 1 seat per request; virtual time advances by 1/width per
dispatch, the reference's R(t) progress with unit service time.

The port's copy of the JAX package's ``scheduler/flowcontrol.py``, the same semantics with its imports
re-pointed at the port; tests/test_torch_*.py hold the two equal.
"""

from __future__ import annotations

import hashlib
import math
import os
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

from ..api import cluster as c
from .store import ClusterStore
from ..analysis.lockcheck import make_lock


class RequestRejected(Exception):
    """Queue full (or no schema matched) — HTTP 429 in the reference."""


@dataclass
class Request:
    user: str
    verb: str = "get"
    resource: str = "pods"
    namespace: str = ""
    # set by classify/enqueue
    flow: str = ""
    level: str = ""
    released: bool = False  # set by dispatch() (or immediately when exempt)
    _queue: Optional["_Queue"] = None


@dataclass
class _Queue:
    index: int
    requests: Deque[Request] = field(default_factory=deque)
    virtual_start: float = 0.0
    executing: int = 0


def _hand(flow_key: str, n_queues: int, hand_size: int) -> List[int]:
    """Shuffle-sharding dealer: derive `hand_size` distinct queue indices from
    the flow hash (fairqueuing — shufflesharding.Dealer.DealIntoHand)."""
    h = int.from_bytes(hashlib.sha256(flow_key.encode()).digest()[:8], "big")
    hand: List[int] = []
    remaining = list(range(n_queues))
    for _ in range(min(hand_size, n_queues)):
        h, idx = divmod(h, len(remaining))
        hand.append(remaining.pop(idx))
    return hand


class QueueSet:
    """One priority level's fair-queuing state."""

    def __init__(self, plc: c.PriorityLevelConfiguration, concurrency: int):
        self.plc = plc
        self.concurrency = max(1, concurrency)
        self.queues = [_Queue(i) for i in range(max(1, plc.queues))]
        self.in_flight = 0
        self.virtual_time = 0.0

    def enqueue(self, req: Request) -> None:
        if self.plc.exempt:
            # exempt levels never queue or limit (flowcontrol/v1 Exempt type)
            self.in_flight += 1
            req.released = True
            return
        hand = _hand(req.flow, len(self.queues), self.plc.hand_size)
        q = min((self.queues[i] for i in hand), key=lambda q: len(q.requests))
        if len(q.requests) >= self.plc.queue_length_limit:
            raise RequestRejected(
                f"too many requests for flow {req.flow!r} at level {self.plc.name}"
            )
        if not q.requests and q.executing == 0:
            # empty queue (re)joins at current virtual time (queueset.go —
            # the queue's virtual start clock catches up while idle)
            q.virtual_start = self.virtual_time
        q.requests.append(req)
        req._queue = q

    def dispatch(self) -> List[Request]:
        """Release as many requests as free seats allow, fair-queue order."""
        out: List[Request] = []
        while self.in_flight < self.concurrency:
            nonempty = [q for q in self.queues if q.requests]
            if not nonempty:
                break
            # least virtual finish time of the head request (width 1)
            q = min(nonempty, key=lambda q: (q.virtual_start, q.index))
            req = q.requests.popleft()
            q.virtual_start += 1.0
            q.executing += 1
            self.virtual_time = max(self.virtual_time, q.virtual_start - 1.0)
            self.in_flight += 1
            req.released = True
            out.append(req)
        return out

    def finish(self, req: Request) -> None:
        self.in_flight -= 1
        if req._queue is not None:
            req._queue.executing -= 1

    def cancel(self, req: Request) -> bool:
        """Remove a still-queued request (caller gave up waiting).  Returns
        False if the request was already released — the caller must then
        finish() it to return the seat."""
        q = req._queue
        if q is not None and req in q.requests:
            q.requests.remove(req)
            return True
        return False


DEFAULT_LEVELS = (
    c.PriorityLevelConfiguration(name="exempt", exempt=True),
    c.PriorityLevelConfiguration(name="leader-election", concurrency_shares=10,
                                 queues=16, hand_size=4),
    c.PriorityLevelConfiguration(name="workload-high", concurrency_shares=40),
    c.PriorityLevelConfiguration(name="workload-low", concurrency_shares=100),
    c.PriorityLevelConfiguration(name="catch-all", concurrency_shares=5,
                                 queues=1, hand_size=1),
)

DEFAULT_SCHEMAS = (
    c.FlowSchema(name="system-leader-election", priority_level="leader-election",
                 matching_precedence=100, resources=("leases",)),
    c.FlowSchema(name="kube-scheduler", priority_level="exempt",
                 matching_precedence=100, subjects=("system:kube-scheduler",)),
    c.FlowSchema(name="service-accounts", priority_level="workload-low",
                 matching_precedence=9000),
    c.FlowSchema(name="catch-all", priority_level="catch-all",
                 matching_precedence=10000),
)


class APFController:
    """apf_controller.go — owns the schema/level config and the queue sets.
    total_concurrency is divided between levels by concurrency_shares."""

    def __init__(self, store: ClusterStore, total_concurrency: int = 600):
        self.store = store
        self.total_concurrency = total_concurrency
        self._lock = make_lock("APFController._lock")  # guards all queue-set state
        if not store.objects["PriorityLevelConfiguration"]:
            for plc in DEFAULT_LEVELS:
                store.add_object("PriorityLevelConfiguration", plc)
        if not store.objects["FlowSchema"]:
            for fs in DEFAULT_SCHEMAS:
                store.add_object("FlowSchema", fs)
        self.queue_sets: Dict[str, QueueSet] = {}
        self.resync()

    def resync(self) -> None:
        levels: List[c.PriorityLevelConfiguration] = self.store.list_objects(
            "PriorityLevelConfiguration"
        )
        total_shares = sum(p.concurrency_shares for p in levels if not p.exempt) or 1
        for plc in levels:
            cl = max(1, round(self.total_concurrency * plc.concurrency_shares
                              / total_shares))
            existing = self.queue_sets.get(plc.name)
            if existing is None or existing.plc is not plc or existing.concurrency != cl:
                self.queue_sets[plc.name] = QueueSet(plc, cl)

    def classify(self, req: Request) -> Tuple[c.FlowSchema, QueueSet]:
        schemas = sorted(
            self.store.list_objects("FlowSchema"),
            key=lambda s: (s.matching_precedence, s.name),
        )
        for fs in schemas:
            if "*" not in fs.subjects and req.user not in fs.subjects:
                continue
            if "*" not in fs.resources and req.resource not in fs.resources:
                continue
            if "*" not in fs.verbs and req.verb not in fs.verbs:
                continue
            qs = self.queue_sets.get(fs.priority_level)
            if qs is None:
                continue
            return fs, qs
        raise RequestRejected(f"no FlowSchema matches request from {req.user!r}")

    def admit(self, req: Request) -> None:
        """Classify + enqueue.  Call dispatch() to release runnable requests."""
        fs, qs = self.classify(req)
        req.level = fs.priority_level
        if fs.distinguisher == "ByUser":
            req.flow = f"{fs.name}/{req.user}"
        elif fs.distinguisher == "ByNamespace":
            req.flow = f"{fs.name}/{req.namespace}"
        else:
            req.flow = fs.name
        with self._lock:
            qs.enqueue(req)

    def dispatch(self) -> List[Request]:
        with self._lock:
            out: List[Request] = []
            for qs in self.queue_sets.values():
                out.extend(qs.dispatch())
            return out

    def finish(self, req: Request) -> None:
        with self._lock:
            self.queue_sets[req.level].finish(req)

    def cancel(self, req: Request) -> None:
        """Caller gave up waiting (queue-wait timeout): dequeue, or if a
        concurrent dispatch already released it, return the seat — either way
        no seat leaks."""
        with self._lock:
            if not self.queue_sets[req.level].cancel(req) and req.released:
                self.queue_sets[req.level].finish(req)


# --- the streaming admission valve (overload-graceful open-loop intake) ---
#
# Where the QueueSet machinery above models the apiserver's request path,
# the valve below applies the same flow-control DOCTRINE — bounded queues,
# fair share per priority band, shed instead of unbounded backlog — to the
# scheduler's open-loop POD intake (bench/loadgen.py threads every due
# arrival through it).  Because flow control lives upstream of the
# component it protects, the valve's state legitimately survives a
# scheduler kill: the replay driver (the apiserver stand-in) holds it, and
# a leader takeover resumes against the same parked backlog.

WATERMARK_ENV = "KTPU_ADMIT_WATERMARK"
MAX_PARK_ENV = "KTPU_ADMIT_MAX_PARK_S"

# the counter pair the valve maintains (bench artifacts read them through
# report(); /metrics through the caller's Metrics)
ADMISSION_COUNTERS = (
    "scheduler_admission_parked_total",
    "scheduler_admission_shed_total",
)


class AdmissionValve:
    """Watermark-gated, priority-band fair-share admission over an arrival
    stream.  Items need `.priority` (the FlowSchedule band) and `.t` (their
    arrival instant in the caller's clock domain — the CO-honest base for
    shed waits); `offer()` is called once per driver cycle with that
    cycle's due arrivals and the current scheduler queue depth, in the same
    time domain throughout.  Deterministic by construction: FIFO within a
    band, bands served highest-first, no wall-clock reads — a replay under
    the same trace and knobs admits the identical sequence (the
    decision_crc parity gate covers valve-on runs too).

    Knobs: KTPU_ADMIT_WATERMARK (0 = valve off, the default — existing
    open-loop behavior is untouched), KTPU_ADMIT_MAX_PARK_S (staleness
    bound, default 30 virtual seconds)."""

    def __init__(self, watermark: Optional[int] = None,
                 max_park_s: Optional[float] = None, metrics=None):
        self.watermark = int(
            os.environ.get(WATERMARK_ENV, "0") if watermark is None
            else watermark
        )
        self.max_park_s = float(
            os.environ.get(MAX_PARK_ENV, "30") if max_park_s is None
            else max_park_s
        )
        self.metrics = metrics
        # (admission seq, first-offer instant, item): FIFO within a band is
        # the seq order; first-offer anchors the staleness bound
        self._parked: List[Tuple[int, float, object]] = []
        self._seq = 0
        self.parked_total = 0  # cumulative first-parks
        self.shed_total = 0
        self.shed_items: List[object] = []

    @property
    def enabled(self) -> bool:
        return self.watermark > 0

    @property
    def parked_count(self) -> int:
        return len(self._parked)

    def _floor(self) -> int:
        # the adapted wave never starves entirely: even saturated, a sliver
        # of the highest bands admits (apf's minimum concurrency shares)
        return max(1, self.watermark // 8)

    def _shed(self, entries, now: float) -> None:
        for _, first, item in entries:
            self.shed_total += 1
            self.shed_items.append(item)
            if self.metrics is not None:
                self.metrics.inc("scheduler_admission_shed_total")
                # CO-honest: the wait is measured from the arrival instant
                # the TRACE assigned, not from when the valve got around to
                # deciding — overload sheds with honestly long waits
                t = getattr(item, "t", None)
                self.metrics.hist("pod_admission_shed_wait_seconds").observe(
                    max(0.0, now - (t if t is not None else first))
                )

    def offer(self, items, depth: int, now: float) -> List[object]:
        """One driver cycle: merge `items` (this cycle's due arrivals) with
        the parked backlog and return what admits NOW, given the scheduler
        queue depth.  Under the watermark everything admits (the valve is
        invisible); over it, stale parks shed first, then a fair share per
        priority band of a budget that shrinks as depth grows."""
        if not self.enabled:
            return list(items)
        pool = list(self._parked)
        for item in items:
            pool.append((self._seq, now, item))
            self._seq += 1
        self._parked = []
        if not pool:
            return []
        if depth < self.watermark:
            return [item for _, _, item in pool]
        # saturated: shed past the staleness bound — admitting an arrival
        # whose bound already expired would be serving a request the
        # apiserver told the client to retry
        live, stale = [], []
        for e in pool:
            (stale if now - e[1] > self.max_park_s else live).append(e)
        self._shed(stale, now)
        # wave adaptation: the admitted budget shrinks linearly as depth
        # overshoots the watermark, never below the floor
        budget = max(self._floor(), 2 * self.watermark - depth)
        by_band: Dict[int, List] = {}
        for e in live:
            by_band.setdefault(getattr(e[2], "priority", 0), []).append(e)
        bands = sorted(by_band, reverse=True)
        share = math.ceil(budget / len(bands)) if bands else 0
        admitted: List = []
        # equal fair share per band, FIFO within the band...
        for b in bands:
            take = min(share, budget - len(admitted), len(by_band[b]))
            admitted.extend(by_band[b][:take])
            by_band[b] = by_band[b][take:]
        # ...then any leftover budget spills highest-band-first
        for b in bands:
            room = budget - len(admitted)
            if room <= 0:
                break
            admitted.extend(by_band[b][:room])
            by_band[b] = by_band[b][room:]
        newly_parked = 0
        for b in bands:
            for e in by_band[b]:
                if e[1] == now:  # first offer this cycle — count the park
                    newly_parked += 1
                self._parked.append(e)
        self._parked.sort(key=lambda e: e[0])  # FIFO across cycles
        self.parked_total += newly_parked
        if self.metrics is not None and newly_parked:
            self.metrics.inc("scheduler_admission_parked_total",
                             newly_parked)
        return [item for _, _, item in admitted]

    def flush(self, now: float) -> int:
        """End of stream: every still-parked arrival sheds (the driver is
        terminating; holding them would leak pods out of the accounting
        identity shed + scheduled + unschedulable == arrivals).  Returns
        the number shed."""
        n = len(self._parked)
        self._shed(self._parked, now)
        self._parked = []
        return n

    def report(self) -> Dict[str, float]:
        """Artifact block (bench/loadgen.py stamps it when enabled)."""
        return {
            "watermark": self.watermark,
            "max_park_s": self.max_park_s,
            "parked_total": self.parked_total,
            "shed_total": self.shed_total,
            "parked_now": len(self._parked),
        }
