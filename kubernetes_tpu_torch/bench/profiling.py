"""Measured kernel-interior sub-phase attribution on torch.profiler — the
port of the JAX package's ``bench/profiling.py``.

The port's regions sit under ``torch.profiler.record_function`` ranges
from the declared vocabulary (ops/scopes.py).  ``scheduler/tracing.py
device_trace`` writes a Chrome trace of a run; this module reads it back
and charges time to sub-phases:

  * on a card, every CUDA kernel event (``cat`` "kernel") is charged to the
    innermost declared range that encloses its LAUNCH on the host: the
    ``cuda_runtime`` or ``cuda_driver`` event with the kernel's correlation
    id gives the launching thread and instant.  The port's kernels are
    launched through ctypes, so they are no torch ops; the launch call is
    the only link to the range;
  * on the CPU (no CUDA activity in the trace), every leaf CPU op
    (``cat`` "cpu_op" with no op nested inside it) is charged to the
    innermost declared range around it.

Each event carries its range path (``path``, the enclosing
``record_function`` names outermost first, "/"-joined).  The JAX functions
key that path on (HLO module, op) through an HLO dump; here every event is
its own op (``op`` is the event's name with its index), and
``op_map_of(events)`` builds the JAX ``{module: {op: path}}`` map from the
events, so ``subphase_table``, ``render_subphases`` and
``merge_profile_spans`` are the JAX code.  ``enable_hlo_dump`` and
``parse_hlo_dumps`` have no counterpart: no compiler dump is needed when
the ranges are in the trace itself.

``wrapper_of(name)`` maps a kernel event's name back to the port's wrapper
(ops/kernels.py GLOBAL_NAMES), so a run can show that every kernel it
launched is in the profile and owned by a declared sub-phase.
"""

from __future__ import annotations

import bisect
import json
import os
import re
from typing import Any, Dict, List, Optional

from ..ops.scopes import SUBPHASES, subphase_of

_ROLLUP = "round_loop"


def dominant_phase(self_fractions: Dict[str, float], rollup: float) -> Optional[str]:
    """The table's dominant sub-phase: the round-loop ROLLUP competes
    against the phases outside the loop (the JAX package's
    analysis/costmodel.py:205)."""
    outside = {p: f for p, f in self_fractions.items() if p not in (_ROLLUP, "speculate", "repair")}
    outside[_ROLLUP] = rollup
    return max(outside, key=outside.get) if outside else None


def in_round_loop(path: str) -> bool:
    """Whether a scope path passes through the round loop at any depth (the
    JAX package's analysis/costmodel.py:220)."""
    return f"/{_ROLLUP}" in f"/{path}" or path == _ROLLUP


def _trace_path(profile_dir: str) -> Optional[str]:
    from ..scheduler.tracing import DEVICE_TRACE_FILE

    path = os.path.join(profile_dir, DEVICE_TRACE_FILE)
    return path if os.path.exists(path) else None


def _leaves(ops: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The ops with no op nested inside them on their thread."""
    out = []
    by_tid: Dict[Any, List[Dict[str, Any]]] = {}
    for e in ops:
        by_tid.setdefault(e["tid"], []).append(e)
    for evs in by_tid.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        for i, e in enumerate(evs):
            nxt = evs[i + 1] if i + 1 < len(evs) else None
            if nxt is None or nxt["ts"] >= e["ts"] + e["dur"]:
                out.append(e)
    return out


class _Ranges:
    """The record_function ranges of one thread, for innermost-enclosing
    lookups."""

    def __init__(self, ranges: List[Dict[str, Any]]):
        self.ranges = sorted(ranges, key=lambda r: (r["ts"], -r["dur"]))
        self.starts = [r["ts"] for r in self.ranges]

    def path_at(self, t0: float, t1: Optional[float] = None) -> str:
        """The '/'-joined names of the ranges enclosing [t0, t1], outermost
        first."""
        t1 = t0 if t1 is None else t1
        hi = bisect.bisect_right(self.starts, t0)
        enc = [r for r in self.ranges[:hi] if r["ts"] <= t0 and t1 <= r["ts"] + r["dur"]]
        enc.sort(key=lambda r: (r["ts"], -r["dur"]))
        return "/".join(r["name"] for r in enc)


def load_profile_events(profile_dir: str, device: Optional[str] = None) -> List[Dict[str, Any]]:
    """Per-event records [{module, op, name, ts_us, dur_us, path, tid}] from
    the trace ``device_trace`` wrote under `profile_dir`: CUDA kernels
    (module "cuda", ``ts_us`` the kernel's start on the card, ``launch_us``
    its launch on the host) when the trace holds any (or ``device`` is
    "cuda"), else the leaf CPU ops (module "cpu")."""
    path = _trace_path(profile_dir)
    if path is None:
        return []
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return []
    raw = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    ranges: Dict[Any, List[Dict[str, Any]]] = {}
    launches: Dict[Any, Dict[str, Any]] = {}
    kernels, cpu_ops = [], []
    for e in raw:
        cat = e.get("cat", "")
        rec = {"name": e.get("name", ""), "ts": float(e.get("ts", 0.0)), "dur": float(e.get("dur", 0.0)),
               "tid": (e.get("pid"), e.get("tid")), "args": e.get("args") or {}}
        if cat == "user_annotation":
            ranges.setdefault(rec["tid"], []).append(rec)
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = rec["args"].get("correlation")
            if corr is not None:
                launches.setdefault(corr, rec)
        elif cat == "kernel":
            kernels.append(rec)
        elif cat == "cpu_op":
            cpu_ops.append(rec)
    by_tid = {tid: _Ranges(r) for tid, r in ranges.items()}
    none = _Ranges([])
    on_card = device == "cuda" or (device is None and bool(kernels))
    events: List[Dict[str, Any]] = []
    if on_card:
        for k, e in enumerate(sorted(kernels, key=lambda e: e["ts"])):
            launch = launches.get(e["args"].get("correlation"))
            path = by_tid.get(launch["tid"], none).path_at(launch["ts"]) if launch is not None else ""
            events.append({"module": "cuda", "op": f"{e['name']}#{k}", "name": e["name"], "ts_us": e["ts"],
                           "dur_us": e["dur"], "path": path, "tid": launch["tid"] if launch else None,
                           "launch_us": launch["ts"] if launch else None, "linked": launch is not None})
    else:
        for k, e in enumerate(sorted(_leaves(cpu_ops), key=lambda e: e["ts"])):
            path = by_tid.get(e["tid"], none).path_at(e["ts"], e["ts"] + e["dur"])
            events.append({"module": "cpu", "op": f"{e['name']}#{k}", "name": e["name"], "ts_us": e["ts"],
                           "dur_us": e["dur"], "path": path, "tid": e["tid"]})
    return events


def scope_ranges(profile_dir: str) -> List[Dict[str, Any]]:
    """The declared sub-phase ranges of the trace [{name, ts_us, dur_us,
    tid}] (what a test holds each op's owner against)."""
    path = _trace_path(profile_dir)
    if path is None:
        return []
    with open(path) as f:
        doc = json.load(f)
    return [{"name": e["name"], "ts_us": float(e["ts"]), "dur_us": float(e["dur"]), "tid": (e.get("pid"), e.get("tid"))}
            for e in doc.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name") in SUBPHASES]


def op_map_of(events: List[Dict[str, Any]]) -> Dict[str, Dict[str, str]]:
    """The JAX package's {module: {op: scope path}} map, from the events'
    own paths."""
    out: Dict[str, Dict[str, str]] = {}
    for e in events:
        out.setdefault(e["module"], {})[e["op"]] = e["path"]
    return out


def _names_rx(wrapper: str):
    """A regex matching a demangled kernel signature that runs one of
    `wrapper`'s global functions (ops/kernels.py GLOBAL_NAMES)."""
    from ..ops.kernels import GLOBAL_NAMES

    return re.compile("|".join(rf"(?<![A-Za-z0-9_]){n}\b" for n in GLOBAL_NAMES[wrapper]))


def wrapper_of(kernel_name: str) -> Optional[str]:
    """The port's wrapper (an ops/kernels.py LAUNCHES key) whose CUDA
    source defines the kernel event `kernel_name`, or None for a kernel of
    torch's own (K3 and K7 share their globals: K3 is named)."""
    from ..ops.kernels import GLOBAL_NAMES

    return next((w for w in GLOBAL_NAMES if _names_rx(w).search(kernel_name)), None)


def events_of(events: List[Dict[str, Any]], wrapper: str) -> List[Dict[str, Any]]:
    """The kernel events of `events` that run one of `wrapper`'s global
    functions."""
    rx = _names_rx(wrapper)
    return [e for e in events if e["module"] == "cuda" and rx.search(e["name"])]


def _kernel_modules(op_map: Dict[str, Dict[str, Optional[str]]]) -> set:
    """The ANNOTATED modules — those whose op map carries at least one
    declared scope."""
    return {m for m, ops in op_map.items() if any(subphase_of(p) for p in ops.values() if p)}


def subphase_table(events: List[Dict[str, Any]], op_map: Optional[Dict[str, Dict[str, str]]] = None) -> Dict[str, Any]:
    """The measured sub-phase self-time table (the JAX function; `op_map`
    defaults to op_map_of(events)): every event of an annotated module is
    owned by exactly one sub-phase via its path (``unowned`` outside every
    scope), fractions sum to 1.0, ``round_loop_fraction`` is the rollup
    over events under the round loop."""
    if op_map is None:
        op_map = op_map_of(events)
    kernel_modules = _kernel_modules(op_map)
    self_us: Dict[str, float] = {}
    rollup_us = 0.0
    total_us = 0.0
    n_ops = 0
    for e in events:
        mod = e["module"]
        if mod not in kernel_modules:
            continue
        path = op_map[mod].get(e["op"], "")
        if path is None:
            continue
        phase = subphase_of(path) or "unowned"
        self_us[phase] = self_us.get(phase, 0.0) + e["dur_us"]
        if in_round_loop(path):
            rollup_us += e["dur_us"]
        total_us += e["dur_us"]
        n_ops += 1
    fractions = {p: (us / total_us if total_us else 0.0) for p, us in self_us.items()}
    rl = rollup_us / total_us if total_us else 0.0
    return {
        "subphases": {
            p: {"seconds": round(us / 1e6, 6), "fraction": round(fractions[p], 4)}
            for p, us in sorted(self_us.items(), key=lambda kv: -kv[1])
        },
        "round_loop_fraction": round(rl, 4),
        "dominant": dominant_phase(fractions, rl),
        "n_ops": n_ops,
        "kernel_modules": sorted(kernel_modules),
        "total_s": round(total_us / 1e6, 6),
        "incomplete": n_ops == 0,
    }


def render_subphases(table: Dict[str, Any], indent: str = "") -> str:
    """Human rows for one measured table (nested under device_kernel by
    the attribution renderer)."""
    lines = []
    rl = table.get("round_loop_fraction", 0.0)
    dom = table.get("dominant")
    for p, d in table.get("subphases", {}).items():
        # a dominant round_loop marks the ROLLUP row below, not the self
        # row (the loop's own plumbing is near-zero; its interior phases
        # carry the time)
        mark = "  <- dominant" if p == dom and p != "round_loop" else ""
        lines.append(
            f"{indent}{p:<16} {d['seconds']:>10.4f} {d['fraction']:>9.1%}"
            f"{mark}"
        )
    lines.append(
        f"{indent}{'round_loop(all)':<16} {'':>10} {rl:>9.1%}"
        + ("  <- dominant" if dom == "round_loop" else "")
    )
    return "\n".join(lines)


def merge_profile_spans(collector, events: List[Dict[str, Any]],
                        op_map: Optional[Dict[str, Dict[str, str]]] = None,
                        max_spans: int = 4096) -> int:
    """Merge the profiled sub-phase ops into the host span trace as
    children of `device.step` / `batch.kernel` spans, so one Perfetto
    export answers both "which phase" and "which kernel region" (the JAX
    function; `op_map` defaults to op_map_of(events)).

    The profiler and the host collector run on different clocks; the merge
    rebases by aligning the FIRST annotated device op to the start of the
    first device-kernel span (an offset, not a scale — both sides are
    monotonic microsecond clocks).  Each synthesized span parents under
    the device-kernel span whose window contains its midpoint (the first
    one otherwise).  Caps at `max_spans` spans, largest first."""
    from ..scheduler.tracing import Span

    if op_map is None:
        op_map = op_map_of(events)
    kernel_modules = _kernel_modules(op_map)
    evs = [
        e for e in events
        if e["module"] in kernel_modules
        and op_map[e["module"]].get(e["op"], "") is not None
    ]
    if not evs or collector is None:
        return 0
    anchors = sorted(
        (s for s in collector.spans()
         if s.name in ("device.step", "batch.kernel") and s.end is not None),
        key=lambda s: s.start,
    )
    if not anchors:
        return 0
    t0_prof = min(e["ts_us"] for e in evs) / 1e6
    offset = anchors[0].start - t0_prof
    evs.sort(key=lambda e: -e["dur_us"])
    n = 0
    for e in evs[:max_spans]:
        start = e["ts_us"] / 1e6 + offset
        end = start + e["dur_us"] / 1e6
        mid = (start + end) / 2
        parent = next(
            (a for a in anchors if a.start <= mid <= a.end), anchors[0]
        )
        path = op_map[e["module"]].get(e["op"], "")
        phase = subphase_of(path) or "unowned"
        sp = Span(
            f"device.{phase}", component="device",
            trace_id=parent.trace_id, parent_id=parent.span_id,
            start=start,
            attributes={"hlo_op": e["op"], "hlo_module": e["module"],
                        "op_name": path},
        )
        sp.finish(end)
        collector.add(sp)
        n += 1
    return n


__all__ = [
    "dominant_phase", "events_of", "in_round_loop", "load_profile_events", "merge_profile_spans", "op_map_of",
    "render_subphases", "scope_ranges", "subphase_table", "wrapper_of",
]
