"""End-to-end span tracing — per-pod trace trees across the control plane (a
copy of the JAX package's ``scheduler/tracing.py``; one departure, named
below: ``device_trace``).

reference: component-base/tracing (OpenTelemetry spans in the apiserver and
kubelet).  This module is the in-process analog of that layer plus the
distributed-trace propagation the reference delegates to the OTel SDK:

  Span            trace_id / span_id / parent_id / attributes / events over
                  a perf_counter interval, tagged with the emitting component
                  (apiserver, queue, scheduler, kubelet, bench).
  TraceCollector  thread-safe ring of finished spans + the pod-context table
                  (uid -> latest SpanContext).  `enabled` is THE hot-path
                  gate, mirroring klog.V(n).enabled: every instrumentation
                  site checks it before allocating anything.
  Tracer          per-component handle: contextvar-based current-span for
                  same-thread parentage, `span_for_pod` for the explicit
                  pod-attached context that follows a pod across the
                  apiserver -> queue -> scheduling cycle -> binding cycle ->
                  kubelet sync boundary.

Pod context lives in a uid-keyed table on the collector rather than as an
attribute on the Pod object: pods are shallow-cloned constantly
(types.pod_clone, copy.copy status writes) and a carried attribute would
alternately leak through and vanish across those copies; the uid survives
every clone.

Exporters: `chrome_trace()` emits trace-event JSON loadable in Perfetto /
chrome://tracing (one pid per component, one tid per trace, "X" complete
events in microseconds); `tree_text()` renders parent-child trees for test
assertions.  `device_trace` is the port's own: a torch.profiler trace (CPU
activity, and CUDA activity whenever a card is present) written as a Chrome
trace, where the JAX package's bridges to jax.profiler;
bench/profiling.py reads it back and charges each kernel to its declared
sub-phase (ops/scopes.py).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import random
import time
from collections import OrderedDict, deque
from contextvars import ContextVar
from typing import Deque, Dict, Iterator, List, NamedTuple, Optional, Tuple, Union
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
    """One timed operation.  start/end are time.perf_counter() values; the
    exporter rebases them to microseconds."""

    __slots__ = (
        "name", "component", "trace_id", "span_id", "parent_id",
        "start", "end", "attributes", "events",
    )

    def __init__(
        self,
        name: str,
        component: str = "",
        trace_id: str = "",
        parent_id: str = "",
        start: Optional[float] = None,
        attributes: Optional[Dict[str, object]] = None,
    ):
        self.name = name
        self.component = component
        self.trace_id = trace_id or _new_id()
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.start = time.perf_counter() if start is None else start
        self.end: Optional[float] = None
        self.attributes: Dict[str, object] = attributes or {}
        self.events: List[Tuple[float, str, Dict[str, object]]] = []

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    @property
    def duration_s(self) -> float:
        return (self.end if self.end is not None else time.perf_counter()) - self.start

    def add_event(self, name: str, **attrs: object) -> None:
        """Point-in-time annotation (OTel span events)."""
        self.events.append((time.perf_counter(), name, attrs))

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
    """The thread/task-local active span (None outside any span).  klog's
    backend reads this to stamp trace_id/span_id onto every entry."""
    return _CURRENT.get()


def current_trace_id() -> str:
    """The active span's trace id ("" outside any span / tracing off) —
    the flight recorder stamps it so a post-mortem record joins back to
    the Perfetto trace of the cycle that produced it."""
    s = _CURRENT.get()
    return s.trace_id if s is not None else ""


class TraceCollector:
    """Thread-safe in-process span ring + pod-context table.

    `enabled` is read un-locked on every hot-path check (a Python bool read
    is atomic); flipping it mid-run only starts/stops NEW spans.  The
    default is ENABLED (tracing is opt-OUT) — span
    cost is ~1-2 µs each at cycle/pod granularity and the ring bounds
    memory; perf-sensitive callers inject TraceCollector(enabled=False)
    (the bench harness does) or flip set_enabled(False).  The scheduler
    detaches a pod's context when its Deleted event arrives, so a
    recreated namespace/name does not chain into the dead pod's trace."""

    def __init__(self, capacity: int = 65536, enabled: bool = True,
                 max_pod_contexts: int = 65536):
        self.enabled = enabled
        self._lock = make_lock("TraceCollector._lock")
        self._spans: Deque[Span] = deque(maxlen=capacity)
        # spans silently evicted by the ring wrapping: attribution reports
        # and trace exports read this to FLAG an incomplete trace instead of
        # under-counting phases (scheduler/attribution.py)
        self.spans_dropped: int = 0
        # uid -> latest SpanContext, LRU-bounded: a long-lived process tracing
        # millions of pods must not grow this table without bound
        self._pod_ctx: "OrderedDict[str, SpanContext]" = OrderedDict()
        self._max_pod_contexts = max_pod_contexts

    # -- span sink --
    def add(self, span: Span) -> None:
        with self._lock:
            if (self._spans.maxlen is not None
                    and len(self._spans) == self._spans.maxlen):
                self.spans_dropped += 1
            self._spans.append(span)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._pod_ctx.clear()
            self.spans_dropped = 0

    def spans(self, name: Optional[str] = None,
              trace_id: Optional[str] = None) -> List[Span]:
        with self._lock:
            out = list(self._spans)
        if name is not None:
            out = [s for s in out if s.name == name]
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        return out

    def traces(self) -> Dict[str, List[Span]]:
        """trace_id -> spans, in arrival order."""
        out: Dict[str, List[Span]] = {}
        for s in self.spans():
            out.setdefault(s.trace_id, []).append(s)
        return out

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

    # -- exporters --
    def chrome_trace(self) -> Dict:
        """Chrome trace-event JSON (the Perfetto / chrome://tracing format):
        one pid per component, one tid per trace, complete ("X") events in
        microseconds rebased to the earliest span."""
        spans = [s for s in self.spans() if s.end is not None]
        events: List[Dict] = []
        pids: Dict[str, int] = {}
        tids: Dict[str, int] = {}
        t0 = min((s.start for s in spans), default=0.0)
        for s in spans:
            pid = pids.setdefault(s.component or "process", len(pids) + 1)
            tid = tids.setdefault(s.trace_id, len(tids) + 1)
            args = {
                "trace_id": s.trace_id,
                "span_id": s.span_id,
                "parent_id": s.parent_id,
            }
            args.update({k: str(v) for k, v in s.attributes.items()})
            events.append({
                "name": s.name,
                "cat": s.component or "process",
                "ph": "X",
                "ts": round((s.start - t0) * 1e6, 3),
                "dur": round((s.end - s.start) * 1e6, 3),
                "pid": pid,
                "tid": tid,
                "args": args,
            })
            for ts, name, attrs in s.events:
                events.append({
                    "name": name,
                    "cat": s.component or "process",
                    "ph": "i",
                    "s": "t",
                    "ts": round((ts - t0) * 1e6, 3),
                    "pid": pid,
                    "tid": tid,
                    "args": {k: str(v) for k, v in attrs.items()},
                })
        for comp, pid in pids.items():
            events.append({
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": comp},
            })
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            # Perfetto ignores otherData; consumers (harness summary line,
            # attribution reports) read it to flag incomplete traces —
            # spans_dropped > 0 means the ring wrapped and phase totals
            # under-count
            "otherData": {
                "spans_dropped": self.spans_dropped,
                "spans_exported": len(spans),
                "capacity": self._spans.maxlen,
            },
        }

    def export_chrome_trace(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def tree_text(self, trace_id: Optional[str] = None) -> str:
        """Indented parent-child dump for test assertions and debugging."""
        lines: List[str] = []
        for tid, spans in self.traces().items():
            if trace_id is not None and tid != trace_id:
                continue
            by_id = {s.span_id: s for s in spans}
            children: Dict[str, List[Span]] = {}
            roots: List[Span] = []
            for s in spans:
                if s.parent_id and s.parent_id in by_id:
                    children.setdefault(s.parent_id, []).append(s)
                else:
                    roots.append(s)
            lines.append(f"trace {tid}")

            def walk(span: Span, depth: int) -> None:
                dur = f"{span.duration_s * 1e3:.3f}ms"
                lines.append(
                    f"{'  ' * depth}- {span.name} [{span.component}] {dur}"
                )
                for c in sorted(children.get(span.span_id, []),
                                key=lambda s: s.start):
                    walk(c, depth + 1)

            for r in sorted(roots, key=lambda s: s.start):
                walk(r, 1)
        return "\n".join(lines)


_DEFAULT = TraceCollector()


def default_collector() -> TraceCollector:
    """The process-wide collector components fall back to when none is
    injected — the analog of OTel's global TracerProvider."""
    return _DEFAULT


def set_enabled(on: bool) -> None:
    """Flip the process-wide collector.  A pod's trace only connects when
    every component writes to ONE collector, so the supported opt-out modes
    are: this global switch (all defaulted components at once), or injecting
    the SAME explicit collector — enabled or disabled — into every component
    (Scheduler(collector=...), APIServer(tracer=Tracer(col, ...)),
    HollowKubelet(tracer=...)); disabling only the scheduler's collector
    leaves defaulted apiserver/kubelet tracers running on the global one."""
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
        latest context — the cross-component chain a pod's trace follows."""
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
        """Record an already-elapsed interval (e.g. queue wait measured
        enqueue -> pop) as a finished span.  With pod_uid the span joins and
        re-attaches the pod's context chain."""
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
            start=start,
            attributes=dict(attributes) if attributes else None,
        )
        sp.finish(end)
        self.collector.add(sp)
        if pod_uid is not None:
            self.collector.attach_pod(pod_uid, sp.context)
        return sp


DEVICE_TRACE_FILE = "device_trace.json"


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[None]:
    """torch.profiler trace around a region, written to
    ``log_dir/device_trace.json`` (Chrome trace events; bench/profiling.py
    load_profile_events reads it) — the device half of a bench round's
    host-span trace.  It records CPU activity (every torch op and every
    ``record_function`` range, ops/scopes.py's sub-phases among them), and
    CUDA activity whenever a card is present: then each kernel launch (the
    port's ctypes launches included) comes with its ``cuda_runtime`` /
    ``cuda_driver`` call, joined by correlation id.  With a card present a
    trace that holds no CUDA kernel event raises: it never writes a
    CPU-only trace quietly in place of the device's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, DEVICE_TRACE_FILE)
    with profile(activities=acts) as prof:
        yield
        if on_card:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    if on_card:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        if not any(e.get("cat") == "kernel" for e in events):
            raise RuntimeError(f"device_trace: the CUDA trace in {path} holds no kernel event "
                               "(the profiler did not see the card's work)")


def incremental_attrs(hoist_cache) -> dict:
    """Span attributes attributing a kernel step's incremental warm-cycle
    state (ops/incremental.py — HoistCache): whether the resident class
    hoist was hit/patched/rebuilt, the wave's unique-class count, and the
    dirty-node fraction the patch covered — stamped onto the pipeline's
    `device.step` and the scheduler's `batch.kernel` spans so a bench run can
    attribute the warm-cycle win.  None / unarmed cache -> {}."""
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
    """Span attributes identifying the device mesh a kernel step ran on, so
    traces attribute time per route+mesh (stamped onto the pipeline's
    `device.step` and the scheduler's `batch.kernel` spans, and mirrored
    into the bench JSON as `n_shards`).  mesh=None -> the single-device
    path (n_shards 1)."""
    return {"n_shards": int(mesh.size) if mesh is not None else 1}
