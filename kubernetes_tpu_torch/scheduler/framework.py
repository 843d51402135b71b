"""Scheduler Framework — the plugin extension-point API and its runtime.

Analog of the reference's pkg/scheduler/framework/interface.go (one interface
per extension point: PreEnqueue, QueueingHint, PreFilter, Filter, PostFilter,
PreScore, Score+NormalizeScore, Reserve, Permit, PreBind, Bind, PostBind) and
framework/runtime/framework.go (frameworkImpl — RunFilterPlugins /
RunScorePlugins fan-out).  This host-side path IS the CPU fallback the north
star mandates: plugins here reproduce the kernels' semantics one pod at a time;
the TPU path replaces the per-pod Filter/Score fan-out with the batched kernel
while everything else (queue, binding cycle, preemption) is shared.

MaxNodeScore = 100 (interface.go — MaxNodeScore).

The port's copy of the JAX package's ``scheduler/framework.py``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..api import types as t
from ..api.snapshot import Snapshot

MAX_NODE_SCORE = 100

# Status codes (framework/interface.go — Code)
SUCCESS = "Success"
UNSCHEDULABLE = "Unschedulable"
UNSCHEDULABLE_AND_UNRESOLVABLE = "UnschedulableAndUnresolvable"
ERROR = "Error"


@dataclass
class Status:
    code: str = SUCCESS
    reasons: Tuple[str, ...] = ()
    # the plugin that produced a failing status (framework.go stamps this via
    # Status.WithPlugin; the queue derives QueueingHint events from it)
    plugin: str = ""

    @property
    def ok(self) -> bool:
        return self.code == SUCCESS

    @staticmethod
    def unschedulable(*reasons: str) -> "Status":
        return Status(UNSCHEDULABLE, reasons)


@dataclass
class CycleState:
    """Per-scheduling-cycle scratch shared between a plugin's extension points
    (framework/cycle_state.go — CycleState)."""

    data: Dict[str, object] = field(default_factory=dict)


@dataclass
class NodeInfo:
    """Aggregated scheduling view of one node (framework/types.go — NodeInfo)."""

    node: t.Node
    pods: List[t.Pod] = field(default_factory=list)
    requested: Dict[str, int] = field(default_factory=dict)

    def add_pod(self, pod: t.Pod, resources: Sequence[str]) -> None:
        from ..api.snapshot import pod_effective_requests

        self.pods.append(pod)
        for r, q in zip(resources, pod_effective_requests(pod, resources)):
            self.requested[r] = self.requested.get(r, 0) + q

    def remove_pod(self, pod: t.Pod, resources: Sequence[str]) -> None:
        from ..api.snapshot import pod_effective_requests

        self.pods = [q for q in self.pods if q.uid != pod.uid]
        for r, q in zip(resources, pod_effective_requests(pod, resources)):
            self.requested[r] = self.requested.get(r, 0) - q


class Plugin:
    """Base: a plugin implements any subset of the extension-point methods.
    Method absence == not registered at that point (the runtime checks with
    hasattr, mirroring the reference's per-point plugin lists)."""

    name: str = "Plugin"

    # PreEnqueue(pod) -> Status
    # EventsToRegister() -> list of event kinds that can make pods schedulable
    # PreFilter(state, snapshot, pod) -> Status
    # Filter(state, snapshot, pod, node_info) -> Status
    # PostFilter(state, snapshot, pod, filtered_statuses) -> (nominated_node, Status)
    # PreScore(state, snapshot, pod, nodes) -> Status
    # Score(state, snapshot, pod, node_info) -> float
    # NormalizeScore(state, snapshot, pod, scores) -> None (in place)
    # Reserve/Unreserve(state, snapshot, pod, node_name)
    # Permit(state, snapshot, pod, node_name) -> Status
    # PreBind/Bind/PostBind(state, snapshot, pod, node_name) -> Status


@dataclass
class PluginWeight:
    plugin: Plugin
    weight: float = 1.0


class Framework:
    """frameworkImpl: holds the enabled plugins per extension point and runs
    the fan-outs.  The Filter/Score fan-out here is the sequential CPU path;
    see ops/assign.py for the batched TPU equivalent.

    Observability: every plugin call at every extension point feeds the
    reference-named framework_extension_point_duration_seconds
    {extension_point, plugin} labeled histogram (metrics.go — the scheduler's
    per-extension-point latency attribution), and — when the tracer's
    collector is enabled — emits one child span per (extension point, plugin)
    under the current scheduling-cycle span.  The span path allocates nothing
    when tracing is off (the tracer.enabled gate, klog.V(n).enabled shape)."""

    def __init__(self, plugins: Sequence[PluginWeight], tracer=None, metrics=None):
        self.plugins = list(plugins)
        self.tracer = tracer
        self.metrics = metrics
        # (point, plugin) -> resolved _Hist: repeat observations skip the
        # metrics registry lock (Filter runs once per NODE per plugin)
        self._ep_hists: Dict[Tuple[str, str], object] = {}

    def _at(self, point: str) -> List[PluginWeight]:
        return [pw for pw in self.plugins if hasattr(pw.plugin, point)]

    def _run1(self, point: str, plugin: Plugin, fn, *args):
        """One plugin call at one extension point: labeled-histogram timing
        always, a child span only when tracing is enabled."""
        m = self.metrics
        tr = self.tracer
        if tr is not None and tr.enabled:
            with tr.span(f"{point}/{plugin.name}",
                         extension_point=point, plugin=plugin.name):
                return self._timed(point, plugin, fn, args) if m is not None else fn(*args)
        if m is None:
            return fn(*args)
        return self._timed(point, plugin, fn, args)

    def _ep_hist(self, point: str, name: str):
        key = (point, name)
        h = self._ep_hists.get(key)
        if h is None:
            h = self._ep_hists[key] = self.metrics.labeled_hist(
                "framework_extension_point_duration_seconds",
                extension_point=point, plugin=name,
            )
        return h

    def _timed(self, point: str, plugin: Plugin, fn, args):
        h = self._ep_hist(point, plugin.name)
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            h.observe(time.perf_counter() - t0)

    def run_pre_enqueue(self, pod: t.Pod) -> Status:
        for pw in self._at("PreEnqueue"):
            st = self._run1("PreEnqueue", pw.plugin, pw.plugin.PreEnqueue, pod)
            if not st.ok:
                return st
        return Status()

    def run_pre_filter(self, state: CycleState, snap: Snapshot, pod: t.Pod) -> Status:
        for pw in self._at("PreFilter"):
            st = self._run1("PreFilter", pw.plugin, pw.plugin.PreFilter,
                            state, snap, pod)
            if not st.ok:
                return st
        return Status()

    def run_filters(
        self, state: CycleState, snap: Snapshot, pod: t.Pod, info: NodeInfo
    ) -> Status:
        """Filter is the one per-NODE fan-out: a span per (node, plugin) call
        would flood the collector ring at cluster scale (N·P spans per pod),
        so traced runs ACCUMULATE per-plugin durations into the CycleState
        and the scheduler flushes one aggregate Filter/<plugin> span per
        cycle (scheduler._find_feasible).  The labeled histogram still sees
        every call."""
        from dataclasses import replace as _replace

        tr = self.tracer
        tracing = tr is not None and tr.enabled
        for pw in self._at("Filter"):
            if tracing:
                # one perf_counter pair feeds BOTH the labeled histogram and
                # the per-cycle span accumulator
                t0 = time.perf_counter()
                st = pw.plugin.Filter(state, snap, pod, info)
                dt = time.perf_counter() - t0
                if self.metrics is not None:
                    self._ep_hist("Filter", pw.plugin.name).observe(dt)
                agg = state.data.setdefault("_filter_trace", {})
                cur = agg.get(pw.plugin.name)
                agg[pw.plugin.name] = (
                    (cur[0] + dt, cur[1] + 1) if cur else (dt, 1)
                )
            else:
                st = self._run1("Filter", pw.plugin, pw.plugin.Filter,
                                state, snap, pod, info)
            if not st.ok:
                return st if st.plugin else _replace(st, plugin=pw.plugin.name)
        return Status()

    def events_for_plugins(self, plugin_names) -> set:
        """Union of the named plugins' EventsToRegister — the cluster events
        that could make a pod they rejected schedulable (QueueingHint's
        registration half).  Unknown plugins contribute the wildcard."""
        from ..scheduler.queue import EV_ALL

        out: set = set()
        by_name = {pw.plugin.name: pw.plugin for pw in self.plugins}
        for name in plugin_names:
            plugin = by_name.get(name)
            evs = getattr(plugin, "EventsToRegister", None)
            if plugin is None or evs is None:
                out.add(EV_ALL)
            else:
                out.update(evs())
        return out or {EV_ALL}

    def hints_for_plugins(self, plugin_names) -> Dict[str, list]:
        """event kind -> [QueueingHintFn(obj, old, pod) -> bool] from the
        named plugins (scheduling_queue.go — QueueingHintFn: per-EVENT-OBJECT
        Queue/Skip, the precise half of the QueueingHint machinery).

        A kind appears only when EVERY named plugin registering it supplies a
        hint — one hintless registrant means that kind must wake
        unconditionally, so it is left out (the queue's conservative path)."""
        by_name = {pw.plugin.name: pw.plugin for pw in self.plugins}
        fns: Dict[str, list] = {}
        unconditional: set = set()
        for name in plugin_names:
            plugin = by_name.get(name)
            evs = getattr(plugin, "EventsToRegister", None)
            if plugin is None or evs is None:
                continue
            hint = getattr(plugin, "queueing_hint", None)
            for ev in evs():
                if hint is None:
                    unconditional.add(ev)
                else:
                    fns.setdefault(ev, []).append(
                        lambda obj, old, pod, _h=hint, _e=ev: _h(_e, obj, old, pod)
                    )
        return {ev: h for ev, h in fns.items() if ev not in unconditional}

    def run_post_filters(
        self, state: CycleState, snap: Snapshot, pod: t.Pod, statuses: Dict[str, Status]
    ) -> Tuple[Optional[str], Status]:
        for pw in self._at("PostFilter"):
            nominated, st = self._run1("PostFilter", pw.plugin,
                                       pw.plugin.PostFilter,
                                       state, snap, pod, statuses)
            if st.ok:
                return nominated, st
        return None, Status.unschedulable("no postfilter plugin succeeded")

    def run_pre_score(
        self, state: CycleState, snap: Snapshot, pod: t.Pod, nodes: List[NodeInfo]
    ) -> None:
        for pw in self._at("PreScore"):
            self._run1("PreScore", pw.plugin, pw.plugin.PreScore,
                       state, snap, pod, nodes)

    def run_scores(
        self, state: CycleState, snap: Snapshot, pod: t.Pod, infos: List[NodeInfo]
    ) -> np.ndarray:
        """Weighted sum over Score plugins with per-plugin NormalizeScore —
        RunScorePlugins (framework.go ~:900).  One span/observation covers a
        plugin's whole node fan-out including NormalizeScore (the reference
        times RunScorePlugins per plugin the same way)."""
        total = np.zeros(len(infos), dtype=np.float32)
        for pw in self._at("Score"):
            raw = self._run1("Score", pw.plugin, self._score_one,
                             pw.plugin, state, snap, pod, infos)
            total += np.float32(pw.weight) * raw
        return total

    @staticmethod
    def _score_one(plugin, state, snap, pod, infos) -> np.ndarray:
        raw = np.array(
            [np.float32(plugin.Score(state, snap, pod, ni)) for ni in infos],
            dtype=np.float32,
        )
        if hasattr(plugin, "NormalizeScore"):
            plugin.NormalizeScore(state, snap, pod, raw)
        return raw

    def run_reserve(self, state, snap, pod, node_name) -> Status:
        for pw in self._at("Reserve"):
            st = self._run1("Reserve", pw.plugin, pw.plugin.Reserve,
                            state, snap, pod, node_name)
            if not st.ok:
                self.run_unreserve(state, snap, pod, node_name)
                return st
        return Status()

    def run_unreserve(self, state, snap, pod, node_name) -> None:
        for pw in reversed(self._at("Unreserve")):
            self._run1("Unreserve", pw.plugin, pw.plugin.Unreserve,
                       state, snap, pod, node_name)

    def run_permit(self, state, snap, pod, node_name) -> Status:
        for pw in self._at("Permit"):
            st = self._run1("Permit", pw.plugin, pw.plugin.Permit,
                            state, snap, pod, node_name)
            if not st.ok:
                return st
        return Status()

    def run_pre_bind(self, state, snap, pod, node_name) -> Status:
        for pw in self._at("PreBind"):
            st = self._run1("PreBind", pw.plugin, pw.plugin.PreBind,
                            state, snap, pod, node_name)
            if not st.ok:
                return st
        return Status()

    def run_bind(self, state, snap, pod, node_name) -> Status:
        for pw in self._at("Bind"):
            st = self._run1("Bind", pw.plugin, pw.plugin.Bind,
                            state, snap, pod, node_name)
            if st.code != "Skip":
                return st
        return Status(ERROR, ("no bind plugin",))

    def run_post_bind(self, state, snap, pod, node_name) -> None:
        for pw in self._at("PostBind"):
            self._run1("PostBind", pw.plugin, pw.plugin.PostBind,
                       state, snap, pod, node_name)
