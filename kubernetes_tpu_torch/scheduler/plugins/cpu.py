"""In-tree CPU plugins — the sequential fallback path.

Each class mirrors one reference plugin (pkg/scheduler/framework/plugins/...)
and delegates its semantics to the same helpers the parity oracle uses
(oracle/reference.py), so the CPU path, the TPU kernels, and the oracle share
one behavior definition.

Default enablement/weights: registry at the bottom (reference:
pkg/scheduler/framework/plugins/registry.go — NewInTreeRegistry +
apis/config/v1/default_plugins.go — getDefaultPlugins).

The port's copy of the JAX package's ``scheduler/plugins/cpu.py``; the
helpers are the port's own copy of the oracle's (oracle/reference.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ...api import types as t
from ...api.snapshot import Snapshot, pod_effective_requests
from ...oracle import reference as oref
from ..framework import (
    MAX_NODE_SCORE,
    CycleState,
    NodeInfo,
    Plugin,
    PluginWeight,
    Status,
)
from ..extender import ExtenderError
from ..queue import EV_NODE_ADD, EV_NODE_UPDATE, EV_POD_ADD, EV_POD_DELETE

f32 = np.float32


def _existing(snap: Snapshot, infos: Dict[str, NodeInfo]) -> List[Tuple[t.Pod, int]]:
    """(pod, node_index) ledger of running pods, in node order."""
    idx = {name: i for i, name in enumerate(infos)}
    out = []
    for name, ni in infos.items():
        for q in ni.pods:
            out.append((q, idx[name]))
    return out


class SchedulingGates(Plugin):
    """schedulinggates/scheduling_gates.go — PreEnqueue."""

    name = "SchedulingGates"

    def PreEnqueue(self, pod: t.Pod) -> Status:
        if pod.scheduling_gates:
            return Status.unschedulable(f"waiting for gates {pod.scheduling_gates}")
        return Status()


class TaintToleration(Plugin):
    """tainttoleration/taint_toleration.go — Filter + Score(reverse-normalized)."""

    name = "TaintToleration"

    _EVENTS = (EV_NODE_ADD, EV_NODE_UPDATE)

    def EventsToRegister(self):
        return self._EVENTS

    def Filter(self, state, snap, pod, info: NodeInfo) -> Status:
        if not oref._tolerates_all(pod, oref._node_taints(info.node)):
            return Status.unschedulable("node taint not tolerated")
        return Status()

    def Score(self, state, snap, pod, info: NodeInfo) -> float:
        return float(oref._intolerable_prefer_count(pod, oref._node_taints(info.node)))

    def NormalizeScore(self, state, snap, pod, scores: np.ndarray) -> None:
        mx = f32(scores.max()) if len(scores) else f32(0)
        if mx > 0:
            scores[:] = f32(MAX_NODE_SCORE) - f32(MAX_NODE_SCORE) * scores / mx
        else:
            scores[:] = f32(MAX_NODE_SCORE)


class NodeAffinity(Plugin):
    """nodeaffinity/node_affinity.go — Filter (required + nodeSelector) and
    Score (preferred terms, DefaultNormalizeScore)."""

    name = "NodeAffinity"

    _EVENTS = (EV_NODE_ADD, EV_NODE_UPDATE)

    def EventsToRegister(self):
        return self._EVENTS

    def Filter(self, state, snap, pod, info: NodeInfo) -> Status:
        if not oref._node_selection_ok(pod, info.node):
            return Status.unschedulable("node(s) didn't match Pod's node affinity/selector")
        return Status()

    def Score(self, state, snap, pod, info: NodeInfo) -> float:
        return float(oref._preferred_na_raw(pod, info.node))

    def NormalizeScore(self, state, snap, pod, scores: np.ndarray) -> None:
        mx = f32(scores.max()) if len(scores) else f32(0)
        scores[:] = scores * f32(MAX_NODE_SCORE) / mx if mx > 0 else f32(0.0)


class NodeName(Plugin):
    """nodename/node_name.go — Filter."""

    name = "NodeName"

    _EVENTS = (EV_NODE_ADD,)

    def EventsToRegister(self):
        return self._EVENTS

    def Filter(self, state, snap, pod, info: NodeInfo) -> Status:
        if pod.node_name and pod.node_name != info.node.name:
            return Status.unschedulable("node didn't match the requested node name")
        return Status()


class NodePorts(Plugin):
    """nodeports/node_ports.go — Filter."""

    name = "NodePorts"

    _EVENTS = (EV_NODE_ADD, EV_POD_DELETE)

    def EventsToRegister(self):
        return self._EVENTS

    def Filter(self, state, snap, pod, info: NodeInfo) -> Status:
        if oref._ports_conflict(pod, info.pods):
            return Status.unschedulable("node(s) didn't have free ports")
        return Status()


class NodeResourcesFit(Plugin):
    """noderesources/fit.go — Filter (fitsRequest over the shared ScaledState,
    the analog of computePodResourceRequest's PreFilter output) + Score
    (LeastAllocated / MostAllocated / RequestedToCapacityRatio per the
    profile's scoringStrategy pluginConfig)."""

    name = "NodeResourcesFit"

    def __init__(self, fit_strategy: str = "LeastAllocated",
                 rtcr_shape=((0.0, 0.0), (100.0, 10.0))):
        self.fit_strategy = fit_strategy
        self.rtcr_shape = tuple(rtcr_shape)

    _EVENTS = (EV_NODE_ADD, EV_NODE_UPDATE, EV_POD_DELETE)

    def EventsToRegister(self):
        return self._EVENTS

    def queueing_hint(self, event, obj, old, pod) -> bool:
        """noderesources/fit.go — isSchedulableAfterNodeChange: a Node/Update
        requeues a fit-rejected pod only if some allocatable GREW; shrinking
        or irrelevant updates (labels, heartbeats) cannot free capacity."""
        if event == EV_NODE_UPDATE and old is not None:
            new_alloc = getattr(obj, "allocatable", {})
            old_alloc = getattr(old, "allocatable", {})
            return any(
                v > old_alloc.get(r, 0) for r, v in new_alloc.items()
            )
        return True  # Node/Add and Pod/Delete always free capacity

    def Filter(self, state, snap, pod, info: NodeInfo) -> Status:
        sc = state.data["scaled"]
        i = sc.index[info.node.name]
        req = sc.req_of(pod)
        short = (req > 0) & (sc.used[i] + req > sc.alloc[i])
        if np.any(short):
            # upstream fitError vocabulary ("Insufficient cpu"), first
            # failing resource — the reason the diagnosis renderer
            # aggregates (same attribution rule as ops/explain.py)
            return Status.unschedulable(
                f"Insufficient {sc.resources[int(np.argmax(short))]}"
            )
        return Status()

    def Score(self, state, snap, pod, info: NodeInfo) -> float:
        sc = state.data["scaled"]
        i = sc.index[info.node.name]
        requested = sc.used[i] + sc.req_of(pod)
        if self.fit_strategy == "MostAllocated":
            return float(oref._most_allocated(requested, sc.alloc[i], sc.score_idx))
        if self.fit_strategy == "RequestedToCapacityRatio":
            return float(
                oref._rtcr(requested, sc.alloc[i], sc.score_idx, self.rtcr_shape)
            )
        return float(
            oref._least_allocated(requested, sc.alloc[i], sc.score_idx)
        )


class NodeResourcesBalancedAllocation(Plugin):
    """noderesources/balanced_allocation.go — Score."""

    name = "NodeResourcesBalancedAllocation"

    def Score(self, state, snap, pod, info: NodeInfo) -> float:
        sc = state.data["scaled"]
        i = sc.index[info.node.name]
        return float(
            oref._balanced(sc.used[i] + sc.req_of(pod), sc.alloc[i], sc.score_idx)
        )


class PodTopologySpread(Plugin):
    """podtopologyspread/{filtering,scoring}.go — Filter skew check + Score."""

    name = "PodTopologySpread"

    _EVENTS = (EV_NODE_ADD, EV_POD_ADD, EV_POD_DELETE)

    def EventsToRegister(self):
        return self._EVENTS

    def queueing_hint(self, event, obj, old, pod) -> bool:
        """podtopologyspread/plugin.go — isSchedulableAfterPodChange: only an
        assigned pod matching one of the rejected pod's spread selectors (in
        its namespace — spread is namespace-scoped) can change the skew."""
        if event in (EV_POD_ADD, EV_POD_DELETE) and hasattr(obj, "labels"):
            return any(
                c.label_selector is not None
                and getattr(obj, "namespace", "") == pod.namespace
                and c.label_selector.matches(obj.labels)
                for c in pod.topology_spread
            )
        return True  # Node/Add introduces a new topology domain

    def Filter(self, state, snap, pod, info: NodeInfo) -> Status:
        sc = state.data["scaled"]
        i = sc.index[info.node.name]
        ok, raw = oref._spread_eval(pod, sc.nodes, sc.node_ok_sel(pod), sc.existing, i)
        state.data.setdefault("spread_raw", {})[(pod.uid, i)] = raw
        if not ok:
            return Status.unschedulable("node(s) didn't satisfy topology spread")
        return Status()

    def Score(self, state, snap, pod, info: NodeInfo) -> float:
        sc = state.data["scaled"]
        i = sc.index[info.node.name]
        raw = state.data.get("spread_raw", {}).get((pod.uid, i))
        if raw is None:
            _, raw = oref._spread_eval(pod, sc.nodes, sc.node_ok_sel(pod), sc.existing, i)
        return float(raw)

    def NormalizeScore(self, state, snap, pod, scores: np.ndarray) -> None:
        mx = f32(scores.max()) if len(scores) else f32(0)
        if mx > 0:
            scores[:] = f32(MAX_NODE_SCORE) - f32(MAX_NODE_SCORE) * scores / mx
        else:
            scores[:] = f32(MAX_NODE_SCORE)


class ImageLocality(Plugin):
    """imagelocality/image_locality.go — Score (no NormalizeScore): summed MB
    of the pod's images already on the node, threshold-scaled to [0,100]."""

    name = "ImageLocality"

    def Score(self, state, snap, pod, info: NodeInfo) -> float:
        from ...oracle.reference import _image_score

        return float(_image_score(pod, info.node))


class InterPodAffinity(Plugin):
    """interpodaffinity/filtering.go — Filter (required affinity with first-pod
    waiver, own + symmetric anti-affinity) + scoring.go — Score (preferred
    terms, both directions, min/max-normalized)."""

    name = "InterPodAffinity"

    _EVENTS = (EV_NODE_ADD, EV_POD_ADD, EV_POD_DELETE)

    def EventsToRegister(self):
        return self._EVENTS

    def __init__(self, hard_pod_affinity_weight: float = 1.0):
        self.hard_pod_affinity_weight = hard_pod_affinity_weight

    @staticmethod
    def _term_matches(term, pod_ns, obj) -> bool:
        ns = term.namespaces or (pod_ns,)
        return (
            term.label_selector is not None
            and getattr(obj, "namespace", "") in ns
            and term.label_selector.matches(obj.labels)
        )

    def queueing_hint(self, event, obj, old, pod) -> bool:
        """interpodaffinity/plugin.go — isSchedulableAfterPodChange: an ADDED
        assigned pod helps only if it matches a required-affinity selector;
        a DELETED one helps only if it matched an anti-affinity selector (a
        blocker left) or itself owned an anti term matching this pod."""
        if event not in (EV_POD_ADD, EV_POD_DELETE) or not hasattr(obj, "labels"):
            return True  # Node/Add: new placement options
        a = pod.affinity
        if event == EV_POD_ADD:
            # an added pod can only help this pod's own REQUIRED affinity;
            # symmetric anti-affinity only gains blockers from adds
            return a is not None and any(
                self._term_matches(tm, pod.namespace, obj)
                for tm in a.required_pod_affinity
            )
        # EV_POD_DELETE: a pod this plugin rejected may have no affinity of
        # its OWN — existing pods' symmetric anti terms also reject — so the
        # departed pod's anti terms must be checked even when a is None
        if a is not None and any(
            self._term_matches(tm, pod.namespace, obj)
            for tm in a.required_pod_anti_affinity
        ):
            return True
        oa = getattr(obj, "affinity", None)
        if oa is not None:
            onm = getattr(obj, "namespace", "")
            return any(
                self._term_matches(tm, onm, pod)
                for tm in oa.required_pod_anti_affinity
            )
        return False

    def Filter(self, state, snap, pod, info: NodeInfo) -> Status:
        sc = state.data["scaled"]
        i = sc.index[info.node.name]
        if not oref._interpod_ok(pod, sc.nodes, sc.existing, i):
            return Status.unschedulable("node(s) didn't satisfy pod affinity/anti-affinity")
        return Status()

    def Score(self, state, snap, pod, info: NodeInfo) -> float:
        sc = state.data["scaled"]
        i = sc.index[info.node.name]
        return float(
            oref._interpod_pref_raw(
                pod, sc.nodes, sc.existing, i, self.hard_pod_affinity_weight
            )
        )

    def NormalizeScore(self, state, snap, pod, scores: np.ndarray) -> None:
        if not len(scores):
            return
        mx, mn = f32(scores.max()), f32(scores.min())
        if mx > mn:
            scores[:] = f32(MAX_NODE_SCORE) * (scores - mn) / (mx - mn)
        else:
            scores[:] = f32(0.0)


class VolumeBinding(Plugin):
    """volumebinding/volume_binding.go — PreBind: BindPodVolumes.  The
    feasibility half (FindPodVolumes) is folded into the snapshot by
    api/volumes.resolve_pod and shared with the batch paths; this plugin
    commits the chosen binding (static PV match or dynamic provisioning)."""

    name = "VolumeBinding"

    def __init__(self, store):
        self.store = store

    def PreBind(self, state, snap, pod, node_name) -> Status:
        if not pod.pvcs:
            return Status()
        from ..volumebinder import bind_pod_volumes

        err = bind_pod_volumes(self.store, pod, node_name)
        return Status() if err is None else Status.unschedulable(err)


class DefaultBinder(Plugin):
    """defaultbinder/default_binder.go — Bind: POST pods/{name}/binding."""

    name = "DefaultBinder"

    def __init__(self, store):
        self.store = store

    def Bind(self, state, snap, pod, node_name) -> Status:
        self.store.bind(pod.uid, node_name)
        return Status()


def _split_pdb_violating(
    pods: List[t.Pod], pdbs: List[t.PodDisruptionBudget]
) -> Tuple[List[t.Pod], List[t.Pod]]:
    """framework/preemption — filterPodsWithPDBViolation: a pod is "violating"
    if evicting it would exceed some matching PDB's disruptions_allowed,
    accounting for the evictions this very candidate set already charges."""
    remaining = {pdb.key: pdb.disruptions_allowed for pdb in pdbs}
    violating: List[t.Pod] = []
    non_violating: List[t.Pod] = []
    for q in pods:
        hit = [pdb for pdb in pdbs if pdb.matches(q)]
        if any(remaining[pdb.key] <= 0 for pdb in hit):
            violating.append(q)
        else:
            for pdb in hit:
                remaining[pdb.key] -= 1
            non_violating.append(q)
    return violating, non_violating


class DefaultPreemption(Plugin):
    """defaultpreemption/default_preemption.go + framework/preemption/
    preemption.go — Evaluator: PostFilter that picks victims on one node,
    evicts them, and nominates the node.

    Victim selection (SelectVictimsOnNode): remove all lower-priority pods;
    if the pod then passes every Filter, reprieve victims while still
    feasible — PDB-violating victims get reprieve priority first, then
    non-violating, each highest-priority-first — and count the PDB
    violations among the survivors.  Node choice (pickOneNodeForPreemption's
    lexicographic order): fewest PDB violations, lowest max victim priority,
    smallest priority sum, fewest victims, lowest node index.
    """

    name = "DefaultPreemption"

    def __init__(self, filter_fn, store, nominated_fn=None, extenders=()):
        self.filter_fn = filter_fn  # (state, snap, pod, NodeInfo) -> Status
        self.store = store
        # node_name -> [nominated pods] (the queue's nominator); preemption
        # must respect other preemptors' reservations (the reference's
        # SelectVictimsOnNode filters through RunFilterPluginsWithNominatedPods)
        self.nominated_fn = nominated_fn
        # preemption-capable extenders get the candidate map before the node
        # pick (extender.go — ProcessPreemption / SupportsPreemption)
        self.extenders = [e for e in extenders if e.cfg.preempt_verb]

    def PostFilter(self, state, snap, pod, statuses) -> Tuple[Optional[str], Status]:
        sc = state.data["scaled"]
        pdbs = list(getattr(self.store, "pdbs", {}).values())
        best = None  # ((violations, max_prio, sum_prio, count, node_idx), victims, name)
        # with preemption-capable extenders, ALL candidates are collected and
        # offered before the pick; without them the best is tracked streaming
        candidates: dict = {} if self.extenders else None
        for i, info in enumerate(sc.infos):
            lower = [q for q in info.pods if q.priority < pod.priority]
            if not lower:
                continue
            nom = [
                q
                for q in (self.nominated_fn(info.node.name) if self.nominated_fn else [])
                if q.uid != pod.uid and q.priority >= pod.priority
            ]
            nom_uids = {q.uid for q in nom}
            # nominated pods ride in the sim so their reservation holds and
            # they are never victims (they're not on the node, so not in lower)
            sim = NodeInfo(
                node=info.node,
                pods=[q for q in info.pods if q.priority >= pod.priority] + nom,
            )
            sc.push_sim(i, sim)
            try:
                if not self.filter_fn(state, snap, pod, sim).ok:
                    continue
                # reprieve: re-add while still feasible; violating pods first
                # so the final victim set avoids PDB damage when possible
                violating, non_violating = _split_pdb_violating(lower, pdbs)
                victims: List[t.Pod] = []
                viol_uids: set = set()
                n_violations = 0
                for group, counts in ((violating, True), (non_violating, False)):
                    for q in sorted(group, key=lambda q: (-q.priority, q.uid)):
                        sim.add_pod(q, sc.resources)
                        sc.refresh_sim(i, sim)
                        if self.filter_fn(state, snap, pod, sim).ok:
                            continue  # reprieved
                        sim.remove_pod(q, sc.resources)
                        sc.refresh_sim(i, sim)
                        victims.append(q)
                        if counts:
                            n_violations += 1
                            viol_uids.add(q.uid)
                if victims and nom:
                    # second pass of the two-pass nominated filter: feasibility
                    # must not DEPEND on a nominated pod that may never arrive
                    base = NodeInfo(
                        node=info.node,
                        pods=[q for q in sim.pods if q.uid not in nom_uids],
                    )
                    sc.refresh_sim(i, base)
                    if not self.filter_fn(state, snap, pod, base).ok:
                        continue
            finally:
                sc.pop_sim(i)
            if not victims:
                continue
            key = (
                n_violations,
                max(q.priority for q in victims),
                sum(q.priority for q in victims),
                len(victims),
                i,
            )
            if candidates is not None:
                # the pick happens after the extender round; each victim's
                # PDB classification from the reprieve pass rides along so a
                # trimmed set re-keys with the SAME semantics as streaming
                candidates[info.node.name] = (key, victims, viol_uids)
            else:
                if best is None or key < best[0]:
                    best = (key, victims, info.node.name)
        if candidates is not None:
            if not candidates:
                return None, Status.unschedulable("preemption: no candidates")
            node_map = {n: v for n, (_, v, _) in candidates.items()}
            for ext in self.extenders:
                try:
                    node_map = ext.process_preemption(pod, node_map)
                except ExtenderError as e:
                    if ext.cfg.ignorable:
                        continue
                    return None, Status.unschedulable(
                        f"preemption extender: {e}"
                    )
                if not node_map:
                    return None, Status.unschedulable(
                        "preemption: extenders rejected all candidates"
                    )
            best = None
            for node, kept in node_map.items():
                key0, orig, viol = candidates[node]
                kept_uids = {q.uid for q in kept}
                if kept_uids == {q.uid for q in orig}:
                    # untouched candidate: the streaming key stands as-is
                    key, chosen = key0, orig
                else:
                    # trimmed set: keep the ORIGINAL victim order and each
                    # victim's reprieve-time PDB classification (the
                    # reference echoes NumPDBViolations through the extender
                    # round rather than re-deriving it)
                    chosen = [q for q in orig if q.uid in kept_uids]
                    key = (
                        sum(1 for q in chosen if q.uid in viol),
                        max(q.priority for q in chosen),
                        sum(q.priority for q in chosen),
                        len(chosen),
                        key0[4],
                    )
                if best is None or key < best[0]:
                    best = (key, chosen, node)
        if best is None:
            return None, Status.unschedulable("preemption: no candidates")
        _, victims, node_name = best
        for q in victims:
            self.store.delete_pod(q.uid)
        return node_name, Status()


def default_plugins(
    store, filter_fn=None, nominated_fn=None, hard_pod_affinity_weight: float = 1.0,
    plugin_specs=(), extenders=(),
    fit_strategy: str = "LeastAllocated",
    rtcr_shape=((0.0, 0.0), (100.0, 10.0)),
) -> List[PluginWeight]:
    """The default profile — plugin set and weights mirroring
    default_plugins.go (NodeResourcesFit 1, BalancedAllocation 1,
    TaintToleration 3, NodeAffinity 2, PodTopologySpread 2, InterPodAffinity 2).

    `plugin_specs` (KubeSchedulerProfile.plugins) overrides per plugin name:
    weight replacement, or removal when enabled=False — the same lowering
    config.score_config applies for the batch kernels, so the two paths see
    one profile semantics."""
    # Score-plugin order mirrors the kernels' float32 accumulation order
    # (ops/assign.py: fit, balanced, taint, nodeAffinity, spread, image) so the
    # CPU path's weighted sum is bit-identical to the TPU/native paths.
    pls = [
        PluginWeight(SchedulingGates()),
        PluginWeight(NodeName()),
        PluginWeight(NodePorts()),
        PluginWeight(NodeResourcesFit(fit_strategy, rtcr_shape), 1.0),
        PluginWeight(NodeResourcesBalancedAllocation(), 1.0),
        PluginWeight(TaintToleration(), 3.0),
        PluginWeight(NodeAffinity(), 2.0),
        PluginWeight(PodTopologySpread(), 2.0),
        PluginWeight(InterPodAffinity(hard_pod_affinity_weight), 2.0),
        PluginWeight(ImageLocality(), 1.0),
    ]
    if filter_fn is not None:
        pls.append(
            PluginWeight(
                DefaultPreemption(filter_fn, store, nominated_fn, extenders)
            )
        )
    pls.append(PluginWeight(VolumeBinding(store)))
    pls.append(PluginWeight(DefaultBinder(store)))
    by_name = {s.name: s for s in plugin_specs}
    if by_name:
        # enabled=False disables the SCORE point only (weight 0) — exactly
        # what config.score_config does for the batch kernels, which always
        # keep feasibility filters.  Filters stay active on both paths.
        def _weight(pw: PluginWeight) -> float:
            s = by_name.get(getattr(pw.plugin, "name", ""))
            if s is None:
                return pw.weight
            return s.weight if s.enabled else 0.0

        pls = [PluginWeight(pw.plugin, _weight(pw)) for pw in pls]
    return pls


def default_registry() -> Dict[str, type]:
    """Name -> class registry (registry.go — NewInTreeRegistry)."""
    return {
        c.name: c
        for c in [
            SchedulingGates,
            NodeName,
            NodePorts,
            TaintToleration,
            NodeAffinity,
            NodeResourcesFit,
            NodeResourcesBalancedAllocation,
            PodTopologySpread,
            InterPodAffinity,
            ImageLocality,
            DefaultPreemption,
            VolumeBinding,
            DefaultBinder,
        ]
    }
