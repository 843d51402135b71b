"""The CPU reference's per-node helpers — the port's copy of the part of
the JAX package's ``oracle/reference.py`` (its lines 34-359) that the CPU
plugins (scheduler/plugins/cpu.py) and the what-if state
(scheduler/state.py) call: taints and tolerations, node selection, the fit
and balanced scores, host ports, topology spread, inter-pod affinity, the
preferred node-affinity and image scores.

These are the object-model semantics (string label matching, per-node
Python loops) with the score arithmetic in float32, mirroring the kernels
op for op, so the per-pod cycle and the batch cycle agree bit for bit.  The
oracle's whole-snapshot scheduler (``oracle_schedule``) is not copied: the
port's tests hold the port against the JAX package's.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..api import types as t
from ..ops.scores import MAX_NODE_SCORE

f32 = np.float32


def _tolerates_all(pod: t.Pod, taints) -> bool:
    # reference: component-helpers scheduling/corev1 — FindMatchingUntoleratedTaint
    for taint in taints:
        if taint.effect == t.PREFER_NO_SCHEDULE:
            continue
        if not any(tol.tolerates(taint) for tol in pod.tolerations):
            return False
    return True


def _intolerable_prefer_count(pod: t.Pod, taints) -> int:
    return sum(
        1
        for taint in taints
        if taint.effect == t.PREFER_NO_SCHEDULE
        and not any(tol.tolerates(taint) for tol in pod.tolerations)
    )


def _node_taints(nd: t.Node):
    ts = list(nd.taints)
    if nd.unschedulable:
        ts.append(t.Taint(key="node.kubernetes.io/unschedulable", effect=t.NO_SCHEDULE))
    return ts


def _matches_term(term: t.NodeSelectorTerm, labels: Dict[str, str]) -> bool:
    # reference: component-helpers nodeaffinity — nodeSelectorTermMatches;
    # a null/empty term matches no objects
    if not term.match_expressions:
        return False
    for req in term.match_expressions:
        has, val = req.key in labels, labels.get(req.key)
        if req.operator == t.OP_IN:
            if not has or val not in req.values:
                return False
        elif req.operator == t.OP_NOT_IN:
            if has and val in req.values:
                return False
        elif req.operator == t.OP_EXISTS:
            if not has:
                return False
        elif req.operator == t.OP_DOES_NOT_EXIST:
            if has:
                return False
        elif req.operator in (t.OP_GT, t.OP_LT):
            try:
                x, bound = int(val), int(req.values[0])
            except (TypeError, ValueError, IndexError):
                return False
            if not ((x > bound) if req.operator == t.OP_GT else (x < bound)):
                return False
        else:
            raise ValueError(req.operator)
    return True


def _node_selection_ok(pod: t.Pod, node: t.Node) -> bool:
    for k, v in pod.node_selector:
        if node.labels.get(k) != v:
            return False
    if pod.affinity and pod.affinity.required_node_terms:
        return any(_matches_term(tm, node.labels) for tm in pod.affinity.required_node_terms)
    return True


def _least_allocated(requested: np.ndarray, alloc: np.ndarray, idx) -> f32:
    vals = []
    for j in idx:
        a, r = f32(alloc[j]), f32(requested[j])
        vals.append(max(f32(0.0), (a - r) * f32(MAX_NODE_SCORE) / a) if a > 0 else f32(0.0))
    return f32(np.mean(np.array(vals, dtype=f32)))


def _most_allocated(requested: np.ndarray, alloc: np.ndarray, idx) -> f32:
    # noderesources/most_allocated.go — mostResourceScorer: 0 when alloc == 0
    # OR requested exceeds alloc (no clamp — f32 op-for-op mirror of
    # ops/scores.most_allocated)
    vals = []
    for j in idx:
        a, r = f32(alloc[j]), f32(requested[j])
        if a > 0 and r <= a:
            vals.append(f32(r * f32(MAX_NODE_SCORE) / a))
        else:
            vals.append(f32(0.0))
    return f32(np.mean(np.array(vals, dtype=f32)))


def _interp_shape_f32(util: f32, shape) -> f32:
    # ONE explicit f32 op order — y0 + t*(y1-y0) — mirrored verbatim by
    # ops/scores.interp_shape_f32 and the C++ interp_shape, so all engines
    # agree bit-for-bit.  Clamps outside the shape.
    xs = [f32(p[0]) for p in shape]
    ys = [f32(p[1]) for p in shape]
    if util <= xs[0]:
        return ys[0]
    for i in range(1, len(xs)):
        if util <= xs[i]:
            t = f32(f32(util - xs[i - 1]) / f32(xs[i] - xs[i - 1]))
            return f32(ys[i - 1] + f32(t * f32(ys[i] - ys[i - 1])))
    return ys[-1]


def _rtcr(requested: np.ndarray, alloc: np.ndarray, idx, shape) -> f32:
    # noderesources/requested_to_capacity_ratio.go (mirror of
    # ops/scores.requested_to_capacity_ratio)
    vals = []
    for j in idx:
        a, r = f32(alloc[j]), f32(requested[j])
        if a > 0:
            util = f32(r * f32(100.0) / a)
        else:
            # capacity == 0: the reference's resourceScoringFunction returns
            # rawScoringFunction(maxUtilization) — the shape score at 100% —
            # not 0 (requested_to_capacity_ratio.go)
            util = f32(100.0)
        vals.append(
            f32(_interp_shape_f32(util, shape) * f32(MAX_NODE_SCORE / 10.0))
        )
    return f32(np.mean(np.array(vals, dtype=f32)))


def _balanced(requested: np.ndarray, alloc: np.ndarray, idx) -> f32:
    fs, cnt = [], 0
    for j in idx:
        if alloc[j] > 0:
            fs.append(min(f32(1.0), f32(requested[j]) / f32(alloc[j])))
            cnt += 1
        else:
            fs.append(f32(0.0))
    n = f32(max(1, cnt))
    f = np.array(fs, dtype=f32)
    mean = f32(f.sum() / n)
    var = f32(np.where(np.array([alloc[j] > 0 for j in idx]), (f - mean) ** 2, f32(0)).sum() / n)
    return f32((f32(1.0) - f32(np.sqrt(var))) * f32(MAX_NODE_SCORE))


def _term_matches_pod(sel: Optional[t.LabelSelector], namespaces, pod: t.Pod) -> bool:
    if sel is None:
        return False
    return pod.namespace in namespaces and sel.matches(pod.labels)


def _aff_namespaces(term: t.PodAffinityTerm, owner: t.Pod):
    return tuple(sorted(term.namespaces)) if term.namespaces else (owner.namespace,)


def _ports_conflict(pod: t.Pod, existing_on_node) -> bool:
    mine = set(pod.host_ports)
    if not mine:
        return False
    for q in existing_on_node:
        if mine & set(q.host_ports):
            return True
    return False


def _spread_eval(pod, nodes, node_ok_sel, existing, n):
    """Per DoNotSchedule constraint feasibility + summed match counts for the
    score, mirroring ops/pairwise.spread_step."""
    ok = True
    raw = f32(0.0)
    for c in pod.topology_spread:
        key = c.topology_key
        # counts per domain over keyed nodes
        counts: Dict[str, int] = {}
        for q, qn in existing:
            val = nodes[qn].labels.get(key)
            if val is not None and _term_matches_pod(c.label_selector, (pod.namespace,), q):
                counts[val] = counts.get(val, 0) + 1
        has_key = key in nodes[n].labels
        if has_key:
            raw = f32(raw + f32(counts.get(nodes[n].labels[key], 0)))
        if c.when_unsatisfiable != t.DO_NOT_SCHEDULE:
            continue
        # minMatch over domains containing >= 1 node passing the node filter
        elig_domains = set()
        for i, nd in enumerate(nodes):
            if node_ok_sel[i] and key in nd.labels:
                elig_domains.add(nd.labels[key])
        if not has_key:
            ok = False
            continue
        min_match = min((counts.get(d, 0) for d in elig_domains), default=0)
        if counts.get(nodes[n].labels[key], 0) + 1 - min_match > c.max_skew:
            ok = False
    return ok, raw


def _interpod_ok(pod, nodes, existing, n) -> bool:
    """Mirrors ops/pairwise.interpod_required_ok."""
    aff = pod.affinity
    nd = nodes[n]
    if aff:
        # required affinity
        terms = aff.required_pod_affinity
        if terms:
            all_ok = True
            total_any = 0
            self_all = True
            for term in terms:
                ns = _aff_namespaces(term, pod)
                matches_in_dom = 0
                anywhere = 0
                for q, qn in existing:
                    val = nodes[qn].labels.get(term.topology_key)
                    if val is None or not _term_matches_pod(term.label_selector, ns, q):
                        continue
                    anywhere += 1
                    if nd.labels.get(term.topology_key) == val:
                        matches_in_dom += 1
                total_any += anywhere
                if term.topology_key not in nd.labels or matches_in_dom == 0:
                    all_ok = False
                if not _term_matches_pod(term.label_selector, ns, pod):
                    self_all = False
            if not all_ok and not (total_any == 0 and self_all):
                return False
        # own required anti-affinity
        for term in aff.required_pod_anti_affinity:
            ns = _aff_namespaces(term, pod)
            val = nd.labels.get(term.topology_key)
            if val is None:
                continue
            for q, qn in existing:
                if nodes[qn].labels.get(term.topology_key) == val and _term_matches_pod(
                    term.label_selector, ns, q
                ):
                    return False
    # existing pods' anti-affinity vs this pod
    for q, qn in existing:
        if not (q.affinity and q.affinity.required_pod_anti_affinity):
            continue
        for term in q.affinity.required_pod_anti_affinity:
            val = nodes[qn].labels.get(term.topology_key)
            if val is None:
                continue
            if nd.labels.get(term.topology_key) != val:
                continue
            if _term_matches_pod(term.label_selector, _aff_namespaces(term, q), pod):
                return False
    return True


def _interpod_pref_raw(pod, nodes, existing, n, hard_w: float = 1.0) -> f32:
    """Mirrors ops/pairwise.interpod_pref_raw: own preferred terms vs existing
    pods (anti negative) + existing pods' preferred terms vs this pod +
    existing pods' REQUIRED affinity terms vs this pod at hardPodAffinityWeight
    (interpodaffinity/scoring.go — processExistingPod)."""
    nd = nodes[n]
    raw = f32(0.0)
    if pod.affinity:
        for wt, sign in [
            *[(x, 1.0) for x in pod.affinity.preferred_pod_affinity],
            *[(x, -1.0) for x in pod.affinity.preferred_pod_anti_affinity],
        ]:
            term = wt.term
            val = nd.labels.get(term.topology_key)
            if val is None:
                continue
            ns = _aff_namespaces(term, pod)
            for q, qn in existing:
                if nodes[qn].labels.get(term.topology_key) == val and _term_matches_pod(
                    term.label_selector, ns, q
                ):
                    raw = f32(raw + f32(sign * wt.weight))
    for q, qn in existing:
        if not q.affinity:
            continue
        for term, w in [
            *[(x.term, float(x.weight)) for x in q.affinity.preferred_pod_affinity],
            *[(x.term, -float(x.weight)) for x in q.affinity.preferred_pod_anti_affinity],
            *(
                [(x, float(hard_w)) for x in q.affinity.required_pod_affinity]
                if hard_w
                else []
            ),
        ]:
            qval = nodes[qn].labels.get(term.topology_key)
            if qval is None:
                continue
            if nd.labels.get(term.topology_key) != qval:
                continue
            if _term_matches_pod(term.label_selector, _aff_namespaces(term, q), pod):
                raw = f32(raw + f32(w))
    return raw


def _preferred_na_raw(pod, nd) -> f32:
    from ..ops.bitplane import bf16_round_np

    raw = f32(0.0)
    if pod.affinity:
        for pt in pod.affinity.preferred_node_terms:
            if pt.preference.match_expressions and _matches_term(pt.preference, nd.labels):
                raw = f32(raw + f32(pt.weight))
    # the device stores this raw plane on the bf16 lattice (f32 under
    # KTPU_SCORE_DTYPE=f32, where bf16_round_np is the identity)
    # (ops/assign.py — _preferred_node_affinity_raw quantizes at the
    # producer); round identically so normalization sees the same inputs
    return f32(bf16_round_np(raw))


def _image_score(pod: t.Pod, nd: t.Node) -> f32:
    from ..api.snapshot import image_score_value

    sum_mb = sum(nd.images[im] // (1024 * 1024) for im in pod.images if im in nd.images)
    return image_score_value(np.float32(sum_mb))
