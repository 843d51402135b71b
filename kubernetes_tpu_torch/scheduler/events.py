"""Event recorder (client-go tools/record — EventRecorder): the scheduler's
Scheduled / FailedScheduling / Preempted event stream, kept in-process as the
scheduling-decision log for parity debugging (SURVEY.md §5 observability).

When constructed with a store, events are ALSO published as "Event" API
objects with the reference's count aggregation (tools/record —
EventAggregator: identical (reason, object, node, message) bumps count and
lastSeen instead of minting a new object) — which is what `kubectl get
events` lists.

The port's copy of the JAX package's ``scheduler/events.py``.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import List, Optional
from ..analysis.lockcheck import make_lock


@dataclass(frozen=True)
class SchedulingEvent:
    reason: str  # Scheduled | FailedScheduling | Preempted
    pod: str
    node: str = ""
    message: str = ""


class EventRecorder:
    def __init__(self, capacity: int = 100_000, store=None,
                 publish_limit: int = 10_000, publish_qps: float = 200.0,
                 publish_burst: int = 512, metrics=None):
        self._lock = make_lock("EventRecorder._lock")
        self.events: List[SchedulingEvent] = []
        self.capacity = capacity
        self._store = store
        # events_publish_dropped_total: API-object publications the token
        # bucket refused.  Before this counter the drop was SILENT — the
        # in-memory decision log stayed complete while `kubectl get events`
        # quietly thinned out, with nothing on /metrics to say so.
        self._metrics = metrics
        self._seq = 0
        self._agg: dict = {}  # aggregation key -> Event object key
        # bounded Event-object footprint: oldest objects are deleted past the
        # limit (the reference bounds events with an etcd TTL instead)
        self.publish_limit = publish_limit
        self._published = deque()  # (obj key, agg key), insertion order
        # API-object publication is rate limited, dropping excess — the
        # reference's EventBroadcaster likewise drops events when the sink
        # can't keep up (client-go tools/record — record.go channel overflow;
        # the in-memory decision log above stays complete either way)
        self._qps = publish_qps
        self._tokens = float(publish_burst)
        self._burst = float(publish_burst)
        self._last_refill = time.monotonic()

    def record(self, reason: str, pod: str, node: str = "", message: str = "") -> None:
        with self._lock:
            if len(self.events) < self.capacity:
                self.events.append(SchedulingEvent(reason, pod, node, message))
            if self._store is not None:
                now = time.monotonic()
                self._tokens = min(
                    self._burst, self._tokens + (now - self._last_refill) * self._qps
                )
                self._last_refill = now
                if self._tokens >= 1.0:
                    self._tokens -= 1.0
                    self._publish(reason, pod, node, message)
                elif self._metrics is not None:
                    self._metrics.inc("events_publish_dropped_total")

    def _publish(self, reason: str, pod: str, node: str, message: str) -> None:
        from ..api.cluster import ClusterEvent

        ns, _, name = pod.partition("/")
        if not name:
            ns, name = "default", pod
        now = time.time()
        # aggregation key — the reference's aggregator key reduced
        key = f"{ns}/{name}.{reason}.{node}.{message}"
        existing = self._agg.get(key)
        if existing is not None:
            cur = self._store.get_object("Event", existing)
            if cur is not None:
                cur.count += 1
                cur.last_seen = now
                self._store.update_object("Event", cur)
                return
        self._seq += 1
        ev = ClusterEvent(
            name=f"{name}.{self._seq:08x}",
            namespace=ns,
            reason=reason,
            involved_object=f"Pod/{ns}/{name}",
            node=node,
            message=message,
            first_seen=now,
            last_seen=now,
        )
        self._store.add_object("Event", ev)
        self._agg[key] = ev.key
        self._published.append((ev.key, key))
        while len(self._published) > self.publish_limit:
            old_key, old_agg = self._published.popleft()
            self._store.delete_object("Event", old_key)
            if self._agg.get(old_agg) == old_key:
                del self._agg[old_agg]

    def by_reason(self, reason: str) -> List[SchedulingEvent]:
        with self._lock:
            return [e for e in self.events if e.reason == reason]
