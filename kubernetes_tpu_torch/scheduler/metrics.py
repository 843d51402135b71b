"""Scheduler metrics (pkg/scheduler/metrics/metrics.go) — the port's copy of
the JAX package's ``scheduler/metrics.py`` registry, which the sidecar
engine (runtime/sidecar.py) fills and ``HealthServer`` serves at /metrics.

Histograms are STREAMING: fixed exponential buckets (factor 2, 1 us ...
~134 s, +Inf), O(buckets) memory and O(log buckets) per observe.  Quantiles
are bucket-resolved with log-linear interpolation and clamped to the
observed [min, max]; worst-case relative error is one bucket ratio (2x).
Histograms merge (StreamingHist.merge) and render in Prometheus exposition
format (Metrics.expose_text).  The JAX package's optional prometheus_client
mirror and its run-start reset hook are not copied: nothing here uses them.
"""

from __future__ import annotations

import bisect
import math
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from ..analysis.lockcheck import make_lock


# Fixed exponential bucket upper bounds: 1e-6 * 2^k seconds, k = 0..27
# (1 µs … ~134 s), +Inf implicit.  One layout for every series keeps
# histograms mergeable across waves, schedulers and scrape points; the
# range covers per-plugin extension points (µs) through the 50k×20k device
# step (tens of seconds) and queue-backoff-bounded SLIs.  PARITY.md
# records the layout and the quantile error bound it implies.
DEFAULT_BUCKET_BOUNDS: Tuple[float, ...] = tuple(
    1e-6 * (2.0 ** k) for k in range(28)
)

# Per-pod SLI phase decomposition: adjacent windows of the arrival → bind
# SLI, observed as pod_sli_phase_duration_seconds{phase=...} labeled
# StreamingHists at bind publication (scheduler.py — _observe_sli_phases;
# parallel/pipeline.py observes the wave-uniform analog).  The boundaries
# come from the span machinery's instants:
#   queue_wait     queue admission → activeQ pop (the queue.wait span)
#   wave_wait      pop → the deciding kernel's dispatch (batch.kernel start;
#                  the encode window in the pipelined loop)
#   device_kernel  kernel dispatch → the pod's decision ready (commit-ordinal
#                  estimate; the device.step window in the pipelined loop)
#   bind           decision ready → bind publication (deferred-commit
#                  latency included)
# The four instants are clamped to a monotone chain, so a pod's phases sum
# EXACTLY to its SLI sample — the attribution table's shares are exhaustive.
SLI_PHASES: Tuple[str, ...] = ("queue_wait", "wave_wait", "device_kernel", "bind")


class StreamingHist:
    """Bounded-memory streaming histogram: fixed buckets, O(1)-ish observe,
    mergeable, quantiles within bucket resolution.

    The per-instance lock serializes observers (binding-cycle worker
    threads bump the same series); `stats()` reads count + quantiles in ONE
    critical section so scrapers never see a torn (count, quantile) pair.
    """

    __slots__ = ("bounds", "counts", "count", "sum", "min", "max", "_lock")

    def __init__(self, bounds: Optional[Sequence[float]] = None):
        self.bounds: Tuple[float, ...] = tuple(bounds or DEFAULT_BUCKET_BOUNDS)
        # counts[i] pairs with bounds[i] (le); counts[-1] is the +Inf bucket
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.count: int = 0
        self.sum: float = 0.0
        self.min: float = math.inf
        self.max: float = -math.inf
        self._lock = make_lock("StreamingHist._lock")

    def observe(self, v: float, n: int = 1) -> None:
        """Record `v` (n times — a wave of identical per-pod samples costs
        one bucket bump, not n)."""
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.counts[i] += n
            self.count += n
            self.sum += v * n
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def observe_many(self, values) -> None:
        """Bulk-append samples (a batch wave's per-pod latency estimates:
        one observe() per pod would pay 50k lock round-trips).  Buckets the
        whole array outside the lock, then merges in one critical section."""
        import numpy as np

        vs = np.asarray(list(values) if not hasattr(values, "__len__") else values,
                        dtype=np.float64)
        if vs.size == 0:
            return
        idx = np.searchsorted(np.asarray(self.bounds), vs, side="left")
        binned = np.bincount(idx, minlength=len(self.counts))
        total = int(vs.size)
        s = float(vs.sum())
        lo = float(vs.min())
        hi = float(vs.max())
        with self._lock:
            for i in np.nonzero(binned)[0]:
                self.counts[int(i)] += int(binned[int(i)])
            self.count += total
            self.sum += s
            if lo < self.min:
                self.min = lo
            if hi > self.max:
                self.max = hi

    def merge(self, other: "StreamingHist") -> None:
        """Fold another histogram (same bucket layout) into this one —
        cross-wave / cross-shard aggregation."""
        if other.bounds != self.bounds:
            raise ValueError("cannot merge histograms with different buckets")
        with other._lock:
            counts = list(other.counts)
            count, s = other.count, other.sum
            lo, hi = other.min, other.max
        with self._lock:
            for i, c in enumerate(counts):
                self.counts[i] += c
            self.count += count
            self.sum += s
            if lo < self.min:
                self.min = lo
            if hi > self.max:
                self.max = hi

    # -- queries --
    def _quantile_locked(self, q: float) -> float:
        if self.count == 0:
            return 0.0
        target = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            prev = cum
            cum += c
            if cum >= target:
                frac = (target - prev) / c
                frac = min(1.0, max(0.0, frac))
                if i >= len(self.bounds):
                    # +Inf bucket: the observed max is the only upper bound
                    return self.max
                hi = self.bounds[i]
                lo = self.bounds[i - 1] if i > 0 else 0.0
                if lo <= 0.0:
                    val = hi * frac  # first bucket: linear from 0
                else:
                    val = lo * (hi / lo) ** frac  # log-linear within bucket
                # clamp to the observed envelope: a single-sample bucket
                # must report the sample's bucket, never exceed max/min
                return min(max(val, self.min), self.max)
        return self.max  # pragma: no cover — cum >= target always hits

    def quantile(self, q: float) -> float:
        with self._lock:
            return self._quantile_locked(q)

    def stats(self) -> Tuple[float, float, int]:
        """(p50, p99, count) read atomically — the scrape triple
        (Metrics.snapshot consumes this under the per-hist lock so count
        and quantiles can never tear against a concurrent observe_many)."""
        with self._lock:
            return (
                self._quantile_locked(0.5),
                self._quantile_locked(0.99),
                self.count,
            )

    def reset(self) -> None:
        """Zero every bucket IN PLACE (same object identity): hot paths
        cache hist handles (Scheduler._sli_hist, labeled_hist callers), so
        a run-start reset must clear the histogram they hold, not orphan
        it behind a fresh instance."""
        with self._lock:
            for i in range(len(self.counts)):
                self.counts[i] = 0
            self.count = 0
            self.sum = 0.0
            self.min = math.inf
            self.max = -math.inf

    def bucket_counts(self) -> List[Tuple[float, int]]:
        """(upper_bound, CUMULATIVE count) pairs, +Inf last — the
        Prometheus exposition shape."""
        with self._lock:
            out: List[Tuple[float, int]] = []
            cum = 0
            for i, ub in enumerate(self.bounds):
                cum += self.counts[i]
                out.append((ub, cum))
            out.append((math.inf, cum + self.counts[-1]))
            return out


# Back-compat alias: the registry's histogram type (pre-streaming code and
# tests referred to _Hist).
_Hist = StreamingHist


LabelKey = Tuple[Tuple[str, str], ...]


class Metrics:
    """One instance per scheduler or sidecar engine: a simple registry of
    counters, gauges and streaming histograms (plus labeled series)."""

    def __init__(self, ):
        # counters/gauges are bumped from binding-cycle worker threads too
        self._lock = make_lock("Metrics._lock")
        self.counters: Dict[str, float] = defaultdict(float)
        self.gauges: Dict[str, float] = defaultdict(float)
        self.hists: Dict[str, StreamingHist] = defaultdict(StreamingHist)
        # labeled histogram series: name -> {sorted (k, v) label pairs -> hist}
        # (framework_extension_point_duration_seconds{extension_point, plugin}
        # — metrics.go declares it with exactly these labels)
        self.labeled_hists: Dict[str, Dict[LabelKey, StreamingHist]] = {}
        # labeled counter series, same keying
        # (framework_fault_recovery_total{site, action} — chaos/plan.py)
        self.labeled_counters: Dict[str, Dict[LabelKey, float]] = {}

    def inc(self, name: str, v: float = 1.0) -> None:
        with self._lock:
            self.counters[name] += v

    def set(self, name: str, v: float) -> None:
        with self._lock:
            self.gauges[name] = v

    def set_max(self, name: str, v: float) -> None:
        """Raise a gauge to `v` if higher (peak-depth gauges: the queue-pool
        samples keep `<pool>_peak` high-water marks next to the live
        depths, so one scrape answers both 'now' and 'worst this run')."""
        with self._lock:
            if v > self.gauges.get(name, float("-inf")):
                self.gauges[name] = v

    def hist(self, name: str) -> StreamingHist:
        """The (unlabeled) histogram for `name`, created on first use — hot
        paths cache the returned handle so repeat observations skip the
        registry lock entirely (the SLI observes once per bound pod)."""
        with self._lock:
            return self.hists[name]

    def labeled_hist(self, name: str, **labels: str) -> StreamingHist:
        """The histogram for one label combination, created on first use —
        callers on hot paths cache the returned hist so repeat observations
        skip the registry lock entirely."""
        key: LabelKey = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            series = self.labeled_hists.setdefault(name, {})
            h = series.get(key)
            if h is None:
                h = series[key] = StreamingHist()
            return h

    def observe_labeled(self, name: str, v: float, **labels: str) -> None:
        self.labeled_hist(name, **labels).observe(v)

    def inc_labeled(self, name: str, v: float = 1.0, **labels: str) -> None:
        """Labeled counter bump (framework_fault_recovery_total{site,action}
        and friends) — appears in snapshot() under the Prometheus-rendered
        name, one entry per label combination."""
        key: LabelKey = tuple(sorted((k, str(val)) for k, val in labels.items()))
        with self._lock:
            series = self.labeled_counters.setdefault(name, {})
            series[key] = series.get(key, 0.0) + v

    def labeled_counter_total(self, name: str) -> float:
        """Sum across all label combinations of one labeled counter."""
        with self._lock:
            return sum(self.labeled_counters.get(name, {}).values())

    def labeled_counter_series(self, name: str) -> Dict[LabelKey, float]:
        """Consistent copy of one labeled counter's series (label key ->
        value) — artifact emitters aggregate from it (e.g. the harness's
        top unschedulable reasons from
        pod_unschedulable_reasons_total{reason})."""
        with self._lock:
            return dict(self.labeled_counters.get(name, {}))

    @staticmethod
    def render_labels(key: LabelKey) -> str:
        """Prometheus exposition form for a label key:
        {extension_point="Filter",plugin="NodeResourcesFit"}."""
        return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"

    def snapshot(self):
        """Consistent copies for scrapers: (counters, gauges,
        {hist: (p50, p99, count)}).  Labeled series appear in the hist dict
        under their Prometheus-rendered name —
        name{label="value",...} — one entry per label combination.  Each
        hist triple is read atomically under that hist's own lock
        (StreamingHist.stats), so count and quantiles never tear against a
        concurrent observe_many."""
        with self._lock:
            counters = dict(self.counters)
            gauges = dict(self.gauges)
            hists = dict(self.hists)
            labeled = {
                name: dict(series) for name, series in self.labeled_hists.items()
            }
            for name, series in self.labeled_counters.items():
                for key, v in series.items():
                    counters[name + self.render_labels(key)] = v
        out_hists = {name: h.stats() for name, h in hists.items()}
        for name, series in labeled.items():
            for key, h in series.items():
                out_hists[name + self.render_labels(key)] = h.stats()
        return counters, gauges, out_hists

    def observe(self, name: str, v: float) -> None:
        # called from binding-cycle worker threads: the defaultdict __missing__
        # must be serialized like inc/set; the observe itself takes the
        # hist's own lock
        with self._lock:
            h = self.hists[name]
        h.observe(v)

    def observe_many(self, name: str, values) -> None:
        """Bulk-append samples (a batch wave's per-pod latency estimates:
        one observe() call per pod would serialize 50k lock round-trips)."""
        if not hasattr(values, "__len__"):
            values = list(values)  # materialize a generator once
        with self._lock:
            h = self.hists[name]
        h.observe_many(values)

    def reset(self) -> None:
        """Clear every series; resident histograms start a fresh run with no
        cross-run bleed.  Histograms are zeroed IN PLACE rather than
        evicted: hot paths cache handles (Scheduler._sli_hist, the
        labeled_hist contract), and a post-reset observation through a
        cached handle must land in the registry's hist, not an orphan."""
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            for h in self.hists.values():
                h.reset()
            for series in self.labeled_hists.values():
                for h in series.values():
                    h.reset()
            self.labeled_counters.clear()

    # -- Prometheus text exposition --
    @staticmethod
    def _fmt(v: float) -> str:
        if v == math.inf:
            return "+Inf"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(float(v))

    def _render_hist(self, name: str, labels: str, h: StreamingHist,
                     lines: List[str]) -> None:
        with h._lock:
            cum = 0
            buckets: List[Tuple[float, int]] = []
            for i, ub in enumerate(h.bounds):
                cum += h.counts[i]
                buckets.append((ub, cum))
            buckets.append((math.inf, cum + h.counts[-1]))
            total, s = h.count, h.sum
        base = labels[1:-1] if labels else ""  # strip braces for composing
        for ub, c in buckets:
            lab = (base + "," if base else "") + f'le="{self._fmt(ub)}"'
            lines.append(f"{name}_bucket{{{lab}}} {c}")
        lines.append(f"{name}_sum{labels} {self._fmt(s)}")
        lines.append(f"{name}_count{labels} {total}")

    def expose_text(self) -> str:
        """The full registry in Prometheus text exposition format 0.0.4:
        counters (labeled series included), gauges, and streaming
        histograms as cumulative le-buckets + _sum/_count — the body the
        apiserver's /metrics route (scheduler/apiserver.py — MetricsServer)
        and the sidecar HealthServer serve."""
        lines: List[str] = []
        with self._lock:
            counters = dict(self.counters)
            gauges = dict(self.gauges)
            hists = dict(self.hists)
            labeled_h = {n: dict(s) for n, s in self.labeled_hists.items()}
            labeled_c = {n: dict(s) for n, s in self.labeled_counters.items()}
        for name in sorted(counters):
            lines.append(f"# TYPE {name} counter")
            lines.append(f"{name} {self._fmt(counters[name])}")
        for name in sorted(labeled_c):
            lines.append(f"# TYPE {name} counter")
            for key in sorted(labeled_c[name]):
                lines.append(
                    f"{name}{self.render_labels(key)} "
                    f"{self._fmt(labeled_c[name][key])}"
                )
        for name in sorted(gauges):
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {self._fmt(gauges[name])}")
        for name in sorted(hists):
            lines.append(f"# TYPE {name} histogram")
            self._render_hist(name, "", hists[name], lines)
        for name in sorted(labeled_h):
            lines.append(f"# TYPE {name} histogram")
            for key in sorted(labeled_h[name]):
                self._render_hist(
                    name, self.render_labels(key), labeled_h[name][key], lines
                )
        return "\n".join(lines) + "\n"
