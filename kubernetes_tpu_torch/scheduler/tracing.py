"""End-to-end span tracing — the part of the JAX package's
``scheduler/tracing.py`` span layer that the port uses: the Scheduler's
cycle spans (batch.cycle, batch.encode, batch.kernel, batch.commit,
queue.wait, bind, the per-pod scheduling.cycle / binding.cycle chain), the
sidecar server's schedule span (runtime/sidecar.py TPUScoreServer), which
joins the client's trace through the span context the client
(runtime/client.py) reads with ``current_span`` and stamps into the gRPC
metadata, and the chaos injector's fault and recovery spans (chaos/plan.py,
``Tracer.record_span``).

  Span            trace_id / span_id / parent_id / attributes over a
                  perf_counter interval, tagged with the emitting component.
  TraceCollector  thread-safe ring of finished spans + the pod-context table
                  (uid -> latest SpanContext).  `enabled` is THE hot-path
                  gate: every instrumentation site checks it before
                  allocating anything.
  Tracer          per-component handle: contextvar-based current-span for
                  same-thread parentage, `span_for_pod` for the explicit
                  pod-attached context that follows a pod from the queue
                  through the scheduling cycle to the binding cycle.

The JAX package's exporters (chrome_trace, tree_text) and `device_trace` (a
jax.profiler bridge) are not copied here: nothing in the port reads them
yet (ROADMAP A13).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import random
import time
from collections import OrderedDict, deque
from contextvars import ContextVar
from typing import Deque, Dict, Iterator, List, NamedTuple, Optional, Union

from ..analysis.lockcheck import make_lock


class SpanContext(NamedTuple):
    """The propagatable half of a span (OTel SpanContext)."""

    trace_id: str
    span_id: str


# id generation: a random per-process base + counter is ~20x cheaper than
# uuid4 per span and still unique across the collectors of one process
_rng = random.Random(os.urandom(8))
_ID_BASE = _rng.getrandbits(64)
_id_seq = itertools.count(1)


def _new_id() -> str:
    return f"{(_ID_BASE + next(_id_seq)) & 0xFFFFFFFFFFFFFFFF:016x}"


class Span:
    """One timed operation; start/end are time.perf_counter() values."""

    __slots__ = (
        "name", "component", "trace_id", "span_id", "parent_id",
        "start", "end", "attributes",
    )

    def __init__(
        self,
        name: str,
        component: str = "",
        trace_id: str = "",
        parent_id: str = "",
        attributes: Optional[Dict[str, object]] = None,
        start: Optional[float] = None,
    ):
        self.name = name
        self.component = component
        self.trace_id = trace_id or _new_id()
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.start = time.perf_counter() if start is None else start
        self.end: Optional[float] = None
        self.attributes: Dict[str, object] = attributes or {}

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def finish(self, end: Optional[float] = None) -> None:
        self.end = time.perf_counter() if end is None else end

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (
            f"Span({self.name!r}, component={self.component!r}, "
            f"trace={self.trace_id[:8]}, span={self.span_id[:8]}, "
            f"parent={self.parent_id[:8] if self.parent_id else '-'})"
        )


# same-thread parentage (OTel context API reduced to one contextvar)
_CURRENT: ContextVar[Optional[Span]] = ContextVar("ktpu_current_span", default=None)


def current_span() -> Optional[Span]:
    """The thread/task-local active span (None outside any span)."""
    return _CURRENT.get()


def current_trace_id() -> str:
    """The active span's trace id ("" outside any span / tracing off)."""
    s = _CURRENT.get()
    return s.trace_id if s is not None else ""


class TraceCollector:
    """Thread-safe in-process span ring + pod-context table.

    `enabled` is read un-locked on every hot-path check (a Python bool read
    is atomic); flipping it mid-run only starts/stops NEW spans.  The
    default is ENABLED (tracing is opt-OUT): span cost is ~1-2 us each at
    request granularity and the ring bounds memory; perf-sensitive callers
    inject TraceCollector(enabled=False).  The scheduler detaches a pod's
    context when its Deleted event arrives, so a recreated namespace/name
    does not chain into the dead pod's trace."""

    def __init__(self, capacity: int = 65536, enabled: bool = True,
                 max_pod_contexts: int = 65536):
        self.enabled = enabled
        self._lock = make_lock("TraceCollector._lock")
        self._spans: Deque[Span] = deque(maxlen=capacity)
        # spans evicted by the ring wrapping: a reader of phase totals
        # checks this to tell an incomplete trace from a short one
        self.spans_dropped: int = 0
        # uid -> latest SpanContext, LRU-bounded: a long-lived process
        # tracing millions of pods must not grow this table without bound
        self._pod_ctx: "OrderedDict[str, SpanContext]" = OrderedDict()
        self._max_pod_contexts = max_pod_contexts

    def add(self, span: Span) -> None:
        with self._lock:
            if (self._spans.maxlen is not None
                    and len(self._spans) == self._spans.maxlen):
                self.spans_dropped += 1
            self._spans.append(span)

    def spans(self, name: Optional[str] = None) -> List[Span]:
        with self._lock:
            out = list(self._spans)
        return out if name is None else [s for s in out if s.name == name]

    # -- pod-context propagation --
    def attach_pod(self, pod_uid: str, ctx: SpanContext) -> None:
        with self._lock:
            self._pod_ctx[pod_uid] = ctx
            self._pod_ctx.move_to_end(pod_uid)
            while len(self._pod_ctx) > self._max_pod_contexts:
                self._pod_ctx.popitem(last=False)

    def pod_context(self, pod_uid: str) -> Optional[SpanContext]:
        with self._lock:
            return self._pod_ctx.get(pod_uid)

    def detach_pod(self, pod_uid: str) -> None:
        with self._lock:
            self._pod_ctx.pop(pod_uid, None)


_DEFAULT = TraceCollector()


def default_collector() -> TraceCollector:
    """The process-wide collector components fall back to when none is
    injected — the analog of OTel's global TracerProvider."""
    return _DEFAULT


def set_enabled(on: bool) -> None:
    """Flip the process-wide collector (every component that was given no
    collector of its own writes to it)."""
    _DEFAULT.enabled = on


ParentLike = Union[None, Span, SpanContext]


def _resolve_parent(parent: ParentLike) -> Optional[SpanContext]:
    if parent is None:
        return None
    if isinstance(parent, Span):
        return parent.context
    return parent


class Tracer:
    """Per-component span factory over a collector."""

    def __init__(self, collector: Optional[TraceCollector] = None,
                 component: str = ""):
        self.collector = collector if collector is not None else _DEFAULT
        self.component = component

    @property
    def enabled(self) -> bool:
        """The cheap hot-path gate (klog.V(n).enabled shape): callers must
        check this before building span attributes."""
        return self.collector.enabled

    @contextlib.contextmanager
    def span(self, name: str, parent: ParentLike = None,
             **attributes: object) -> Iterator[Optional[Span]]:
        """Timed span; parent = explicit context, else the contextvar's
        current span, else a new trace root.  Yields None when disabled."""
        if not self.collector.enabled:
            yield None
            return
        ctx = _resolve_parent(parent)
        if ctx is None:
            cur = _CURRENT.get()
            if cur is not None:
                ctx = cur.context
        sp = Span(
            name,
            component=self.component,
            trace_id=ctx.trace_id if ctx else "",
            parent_id=ctx.span_id if ctx else "",
            attributes=dict(attributes) if attributes else None,
        )
        token = _CURRENT.set(sp)
        try:
            yield sp
        finally:
            _CURRENT.reset(token)
            sp.finish()
            self.collector.add(sp)

    @contextlib.contextmanager
    def span_for_pod(self, pod_uid: str, name: str,
                     **attributes: object) -> Iterator[Optional[Span]]:
        """Span parented under the pod's attached context (falling back to
        the current span / a new root), re-attaching itself as the pod's
        latest context — the chain a pod's trace follows across the queue,
        the scheduling cycle and the binding cycle."""
        if not self.collector.enabled:
            yield None
            return
        parent = self.collector.pod_context(pod_uid)
        with self.span(name, parent=parent, **attributes) as sp:
            if sp is not None:
                self.collector.attach_pod(pod_uid, sp.context)
            yield sp

    def record_span(self, name: str, start: float, end: Optional[float] = None,
                    parent: ParentLike = None, pod_uid: Optional[str] = None,
                    **attributes: object) -> Optional[Span]:
        """Record an already-elapsed interval as a finished span (parent: the
        explicit context, else the pod's attached context when `pod_uid` is
        given, else the current span, else a new trace root).  With pod_uid
        the span joins and re-attaches the pod's context chain."""
        if not self.collector.enabled:
            return None
        ctx = _resolve_parent(parent)
        if ctx is None and pod_uid is not None:
            ctx = self.collector.pod_context(pod_uid)
        if ctx is None:
            cur = _CURRENT.get()
            if cur is not None:
                ctx = cur.context
        sp = Span(
            name,
            component=self.component,
            trace_id=ctx.trace_id if ctx else "",
            parent_id=ctx.span_id if ctx else "",
            attributes=dict(attributes) if attributes else None,
            start=start,
        )
        sp.finish(end)
        self.collector.add(sp)
        if pod_uid is not None:
            self.collector.attach_pod(pod_uid, sp.context)
        return sp


def incremental_attrs(hoist_cache) -> dict:
    """Span attributes of a kernel step's class state (ops/incremental.py —
    HoistCache): whether the resident class hoist was hit, patched or
    rebuilt, the wave's class count and the dirty-node fraction the patch
    covered — stamped onto the scheduler's `batch.kernel` span.  None / an
    unarmed cache -> {}."""
    if hoist_cache is None:
        return {}
    last = getattr(hoist_cache, "last", None)
    if not last or last.get("action") in (None, "none"):
        return {}
    return {
        "hoist_cache": last["action"],
        "unique_classes": last["unique_classes"],
        "dirty_node_fraction": last["dirty_node_fraction"],
        "hoist_cols": last["patched_cols"],
    }


def mesh_attrs(mesh) -> dict:
    """Span attributes naming the device mesh a kernel step ran on (stamped
    onto the scheduler's `batch.kernel` span).  mesh=None -> one device
    (n_shards 1)."""
    return {"n_shards": int(mesh.size) if mesh is not None else 1}
