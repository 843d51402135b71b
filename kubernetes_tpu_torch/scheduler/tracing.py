"""End-to-end span tracing — the part of the JAX package's
``scheduler/tracing.py`` span layer that the sidecar uses: the server's
schedule span (runtime/sidecar.py TPUScoreServer) joins the client's trace
through the span context the client (runtime/client.py) reads with
``current_span`` and stamps into the gRPC metadata; the chaos injector
(chaos/plan.py) records its fault and recovery spans with
``Tracer.record_span``.

  Span            trace_id / span_id / parent_id / attributes over a
                  perf_counter interval, tagged with the emitting component.
  TraceCollector  thread-safe ring of finished spans.  `enabled` is THE
                  hot-path gate: every instrumentation site checks it before
                  allocating anything.
  Tracer          per-component handle: contextvar-based current-span for
                  same-thread parentage.

The JAX package's pod-context table, exporters (chrome_trace, tree_text)
and `device_trace` (a jax.profiler bridge) are not copied here: nothing in
the port reads them yet (ROADMAP A11, A13).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import random
import time
from collections import deque
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
    """Thread-safe in-process span ring.

    `enabled` is read un-locked on every hot-path check (a Python bool read
    is atomic); flipping it mid-run only starts/stops NEW spans.  The
    default is ENABLED (tracing is opt-OUT): span cost is ~1-2 us each at
    request granularity and the ring bounds memory; perf-sensitive callers
    inject TraceCollector(enabled=False)."""

    def __init__(self, capacity: int = 65536, enabled: bool = True):
        self.enabled = enabled
        self._lock = make_lock("TraceCollector._lock")
        self._spans: Deque[Span] = deque(maxlen=capacity)

    def add(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    def spans(self, name: Optional[str] = None) -> List[Span]:
        with self._lock:
            out = list(self._spans)
        return out if name is None else [s for s in out if s.name == name]


_DEFAULT = TraceCollector()


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

    def record_span(self, name: str, start: float, end: Optional[float] = None,
                    parent: ParentLike = None, **attributes: object) -> Optional[Span]:
        """Record an already-elapsed interval as a finished span (parent: the
        explicit context, else the current span, else a new trace root)."""
        if not self.collector.enabled:
            return None
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
            start=start,
        )
        sp.finish(end)
        self.collector.add(sp)
        return sp
