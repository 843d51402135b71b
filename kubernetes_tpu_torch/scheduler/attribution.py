"""Cycle attribution engine — where does a scheduling cycle's wall go?

A copy of the JAX package's ``scheduler/attribution.py`` (it imports no
jax); the kernel-interior split it renders comes from the port's
bench/profiling.py, on torch.profiler.

This module turns a TraceCollector's spans into a machine-readable
per-cycle breakdown plus a rendered table, so a bench run can report where
the cycle goes (and carry the proof of which phase dominates the warm
cycle).

Model.  Spans OVERLAP by design (the whole point of the pipelined loop is
that `encode_overlap` runs concurrently with the previous wave's
`device.step`), so naive duration sums double-count.  Attribution is a
timeline sweep instead: within each cycle window, every instant is
attributed to exactly ONE phase — the highest-priority span active at that
instant — and instants covered by no span fall into `unattributed`.  Phase
fractions therefore sum to exactly 1.0 of cycle wall time, and host work
hidden under a running device step is correctly charged to the device
(it costs no wall).  This is the self-time / critical-path view: the
device kernel is the cycle's spine; host phases only surface where they
STICK OUT of it.

Phases (span name -> phase; priority high -> low):

  device_kernel    batch.kernel / device.step — the jitted filter/score/
                   commit program (the O(C²K) round loop lives here)
  allgather_stitch stitch / allgather spans, when a sharded path emits them
                   (the [C,N] score stitch is inside the jit today, so this
                   reads 0 unless a kernel-side span lands)
  hoist_update     hoist.update — the resident class-hoist patch/rebuild
                   (ops/incremental.py), a sub-phase of the encode window
  host_encode      batch.encode / encode_overlap — snapshot delta-encode +
                   dispatch
  decode           decode_overlap — verdict fetch -> {pod: node} dict
  bind_commit      batch.commit / commit_overlap / binding.cycle / bind —
                   the bind/commit fan-out
  queue_wait       queue.wait — pods waiting in the activeQ (lowest
                   priority: it only surfaces where the scheduler is
                   otherwise idle)
  other            any traced span outside the table (apiserver requests,
                   kubelet sync, chaos recovery, ...)
  unattributed     cycle wall covered by no span at all

Cycle windows are anchored on the cycle-level spans (`batch.cycle` when the
scheduler drove the run, else `device.step` / `batch.kernel` for the raw
pipelined loop): cycle k spans [anchor_k.start, anchor_{k+1}.start), the
last one extends to the latest span end.  Spans before the first anchor
(warmup encode) are reported in the run totals' pre-window, not any cycle.

`spans_dropped` from the collector is carried through: a wrapped ring means
phases under-count, so reports flag `complete: False` instead of lying.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# span name -> phase
PHASE_OF: Dict[str, str] = {
    "batch.kernel": "device_kernel",
    "device.step": "device_kernel",
    # kernel-interior sub-phase spans (bench/profiling.py —
    # merge_profile_spans): they live INSIDE device-kernel windows, so the
    # sweep charges their instants to device_kernel exactly as before; the
    # sub-phase split is reported one level down (report["device_subphases"])
    **{f"device.{p}": "device_kernel" for p in (
        "hoist", "score", "normalize", "round_loop", "speculate", "repair",
        "commit", "unowned",
    )},
    "stitch": "allgather_stitch",
    "allgather": "allgather_stitch",
    "hoist.update": "hoist_update",
    "batch.encode": "host_encode",
    "encode_overlap": "host_encode",
    "decode_overlap": "decode",
    "batch.commit": "bind_commit",
    "commit_overlap": "bind_commit",
    "binding.cycle": "bind_commit",
    "bind": "bind_commit",
    "queue.wait": "queue_wait",
}

# sweep priority: at any instant the highest-priority active phase owns it
PHASE_PRIORITY: Dict[str, int] = {
    "device_kernel": 7,
    "allgather_stitch": 6,
    "hoist_update": 5,
    "host_encode": 4,
    "decode": 3,
    "bind_commit": 2,
    "other": 1,
    "queue_wait": 0,
}

PHASES: Tuple[str, ...] = (
    "device_kernel", "allgather_stitch", "hoist_update", "host_encode",
    "decode", "bind_commit", "queue_wait", "other", "unattributed",
)

# cycle anchors, in preference order: the scheduler's cycle root, else the
# pipelined loop's device step, else the scheduler-path kernel span
_ANCHOR_NAMES = ("batch.cycle", "device.step", "batch.kernel")


def phase_of(name: str) -> str:
    return PHASE_OF.get(name, "other")


def _sweep(intervals: Sequence[Tuple[float, float, str]],
           w0: float, w1: float) -> Dict[str, float]:
    """Attribute every instant of [w0, w1] to the highest-priority phase
    active there (or `unattributed`).  intervals: (start, end, phase)."""
    out = {p: 0.0 for p in PHASES}
    if w1 <= w0:
        return out
    # clip to the window, drop empties
    clipped = []
    for s, e, p in intervals:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            clipped.append((s, e, p))
    bounds = sorted({w0, w1, *(s for s, _, _ in clipped),
                     *(e for _, e, _ in clipped)})
    # O(S·B) segment scan is fine at trace scale (<= 65536 spans per ring,
    # and cycle windows see a tiny slice of that); a heap sweep would only
    # matter past that
    events: List[Tuple[float, int, int]] = []  # (t, +1/-1, interval idx)
    for i, (s, e, _p) in enumerate(clipped):
        events.append((s, 1, i))
        events.append((e, -1, i))
    events.sort(key=lambda t: (t[0], -t[1]))
    active: Dict[int, str] = {}
    ei = 0
    for bi in range(len(bounds) - 1):
        t0, t1 = bounds[bi], bounds[bi + 1]
        while ei < len(events) and events[ei][0] <= t0:
            _, kind, i = events[ei]
            if kind > 0:
                active[i] = clipped[i][2]
            else:
                active.pop(i, None)
            ei += 1
        dt = t1 - t0
        if active:
            p = max(active.values(), key=lambda ph: PHASE_PRIORITY.get(ph, 1))
            out[p] += dt
        else:
            out["unattributed"] += dt
    return out


def _fractions(phases: Dict[str, float], wall: float) -> Dict[str, Dict[str, float]]:
    return {
        p: {
            "seconds": round(s, 6),
            "fraction": round(s / wall, 4) if wall > 0 else 0.0,
        }
        for p, s in phases.items()
    }


def attribute_spans(collector_or_spans, spans_dropped: Optional[int] = None,
                    device_subphases: Optional[Dict] = None) -> Dict:
    """The attribution report: per-cycle and whole-run phase breakdowns.

    Accepts a TraceCollector (reads .spans() and .spans_dropped) or a bare
    span iterable (pass spans_dropped explicitly for completeness
    flagging).  Returns a machine-readable dict — embedded in bench/harness
    JSON artifacts next to route_trace_counts; render_attribution() prints
    it as a table.

    `device_subphases` (bench/profiling.subphase_table, when the run
    captured a `--profile` device trace) embeds the kernel-interior
    sub-phase table one level below `device_kernel`: its fractions are
    shares WITHIN the device kernel (they sum to 1.0 there), and
    render_attribution nests the rows under the device_kernel line so one
    report answers both "which phase" and "which kernel region"."""
    if hasattr(collector_or_spans, "spans"):
        spans = collector_or_spans.spans()
        if spans_dropped is None:
            spans_dropped = getattr(collector_or_spans, "spans_dropped", 0)
    else:
        spans = list(collector_or_spans)
    spans_dropped = int(spans_dropped or 0)
    finished = [s for s in spans if s.end is not None]
    if not finished:
        return {
            "wall_s": 0.0, "n_cycles": 0, "n_spans": 0,
            "phases": _fractions({p: 0.0 for p in PHASES}, 0.0),
            "dominant_phase": None, "cycles": [],
            "spans_dropped": spans_dropped, "complete": spans_dropped == 0,
        }
    intervals = [(s.start, s.end, phase_of(s.name)) for s in finished]
    t_min = min(s.start for s in finished)
    t_max = max(s.end for s in finished)

    anchors: List = []
    for name in _ANCHOR_NAMES:
        anchors = sorted((s for s in finished if s.name == name),
                         key=lambda s: s.start)
        if anchors:
            break
    boundaries = [a.start for a in anchors] + [t_max]

    # bucket each interval into the cycle windows it overlaps (bisect on
    # the sorted window boundaries): per-cycle sweeps then only see their
    # own spans — O(S log C + overlaps) instead of O(C·S), which matters
    # when a long --stream run fills the 65536-span ring across thousands
    # of cycles
    n_cyc = len(anchors)
    buckets: List[List[Tuple[float, float, str]]] = [[] for _ in range(n_cyc)]
    for iv in intervals:
        s, e, _p = iv
        k0 = max(0, bisect.bisect_right(boundaries, s) - 1)
        k1 = min(n_cyc - 1, bisect.bisect_left(boundaries, e) - 1)
        for k in range(k0, k1 + 1):
            if s < boundaries[k + 1] and e > boundaries[k]:
                buckets[k].append(iv)

    cycles: List[Dict] = []
    for k in range(n_cyc):
        w0, w1 = boundaries[k], boundaries[k + 1]
        ph = _sweep(buckets[k], w0, w1)
        wall = w1 - w0
        c = {
            "cycle": k,
            "anchor": anchors[k].name,
            "wall_s": round(wall, 6),
            "phases": _fractions(ph, wall),
        }
        attrs = anchors[k].attributes or {}
        for key in ("wave", "pods", "n_shards"):
            if key in attrs:
                c[key] = attrs[key]
        cycles.append(c)

    # run totals over the cycle region (first anchor -> last end); the
    # pre-window (cold encode/warmup before any cycle anchor) is reported
    # separately so cycle fractions stay honest
    run0 = boundaries[0] if anchors else t_min
    totals = _sweep(intervals, run0, t_max)
    run_wall = t_max - run0
    nonzero = {p: s for p, s in totals.items() if p != "unattributed" and s > 0}
    dominant = max(nonzero, key=nonzero.get) if nonzero else None
    report = {
        "wall_s": round(run_wall, 6),
        "pre_window_s": round(run0 - t_min, 6),
        "n_cycles": len(anchors),
        "n_spans": len(finished),
        "phases": _fractions(totals, run_wall),
        "dominant_phase": dominant,
        "cycles": cycles,
        "spans_dropped": spans_dropped,
        "complete": spans_dropped == 0,
    }
    if device_subphases is not None:
        report["device_subphases"] = device_subphases
    return report


def render_attribution(report: Dict) -> str:
    """Human table for one attribution report (stderr next to the JSON
    artifact)."""
    lines = [
        f"cycle attribution: {report['n_cycles']} cycles, "
        f"{report['wall_s']:.3f}s wall, {report['n_spans']} spans"
        + ("" if report["complete"] else
           f"  [INCOMPLETE: {report['spans_dropped']} spans dropped — "
           "phase totals under-count]")
    ]
    lines.append(f"{'phase':<18} {'seconds':>10} {'fraction':>9}")
    sub = report.get("device_subphases")
    for p in PHASES:
        d = report["phases"].get(p)
        if d is None or d["seconds"] == 0.0:
            continue
        mark = "  <- dominant" if p == report.get("dominant_phase") else ""
        lines.append(f"{p:<18} {d['seconds']:>10.4f} {d['fraction']:>9.1%}{mark}")
        if p == "device_kernel" and sub and not sub.get("incomplete"):
            # the kernel-interior split (bench/profiling.py): fractions are
            # WITHIN device_kernel (self-time shares, sum to 1.0 there)
            from ..bench.profiling import render_subphases

            lines.append(render_subphases(sub, indent="  . "))
    for c in report.get("cycles", [])[:32]:
        top = sorted(
            ((p, d["fraction"]) for p, d in c["phases"].items()
             if d["seconds"] > 0),
            key=lambda t: -t[1],
        )[:3]
        tops = ", ".join(f"{p} {f:.0%}" for p, f in top)
        lines.append(
            f"  cycle {c['cycle']:<3} {c['wall_s']:>9.4f}s  {tops}"
        )
    if len(report.get("cycles", [])) > 32:
        lines.append(f"  ... {len(report['cycles']) - 32} more cycles")
    return "\n".join(lines)
