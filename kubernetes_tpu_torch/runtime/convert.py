"""proto <-> object-model conversion for the TPUScore sidecar protocol —
the port's copy of the JAX package's ``runtime/convert.py`` over the port's
types.  The wire (tpuscore.proto, tpuscore_pb2.py) is the JAX package's,
byte for byte.

The protobuf module is imported by the functions that build or read
messages, not at import: ``clone_pod`` (the session path's bind copies)
and the engine work without protobuf installed.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..api import types as t
from ..api.snapshot import Snapshot


def _pb():
    from . import tpuscore_pb2

    return tpuscore_pb2


# ---------- to proto ----------

def _quantities(d: Dict[str, int]):
    pb = _pb()
    return [pb.Quantity(resource=k, value=int(v)) for k, v in d.items()]


def _labels(d: Dict[str, str]):
    pb = _pb()
    return [pb.Label(key=k, value=v) for k, v in d.items()]


def _selector(sel: Optional[t.LabelSelector]) -> "pb.LabelSelector":
    pb = _pb()
    if sel is None:
        return pb.LabelSelector(present=False)
    return pb.LabelSelector(
        present=True,
        match_labels=[pb.Label(key=k, value=v) for k, v in sel.match_labels],
        match_expressions=[
            pb.LabelSelectorRequirement(key=e.key, op=e.operator, values=list(e.values))
            for e in sel.match_expressions
        ],
    )


def _nst(term: t.NodeSelectorTerm) -> "pb.NodeSelectorTerm":
    pb = _pb()
    return pb.NodeSelectorTerm(
        match_expressions=[
            pb.LabelSelectorRequirement(key=e.key, op=e.operator, values=list(e.values))
            for e in term.match_expressions
        ]
    )


def _pat(term: t.PodAffinityTerm) -> "pb.PodAffinityTerm":
    pb = _pb()
    return pb.PodAffinityTerm(
        topology_key=term.topology_key,
        selector=_selector(term.label_selector),
        namespaces=list(term.namespaces),
    )


def pod_to_proto(p: t.Pod) -> "pb.Pod":
    pb = _pb()
    msg = pb.Pod(
        name=p.name,
        namespace=p.namespace,
        uid=p.uid,
        requests=_quantities(p.requests),
        labels=_labels(p.labels),
        node_name=p.node_name,
        priority=p.priority,
        tolerations=[
            pb.Toleration(key=x.key, op=x.operator, value=x.value, effect=x.effect)
            for x in p.tolerations
        ],
        node_selector=[pb.Label(key=k, value=v) for k, v in p.node_selector],
        host_ports=[pb.HostPort(protocol=pr, port=po) for pr, po in p.host_ports],
        scheduling_gates=list(p.scheduling_gates),
        pod_group=p.pod_group,
        topology_spread=[
            pb.TopologySpreadConstraint(
                max_skew=c.max_skew,
                topology_key=c.topology_key,
                when_unsatisfiable=c.when_unsatisfiable,
                selector=_selector(c.label_selector),
            )
            for c in p.topology_spread
        ],
        images=list(p.images),
    )
    if p.affinity:
        msg.required_node_terms.extend(_nst(x) for x in p.affinity.required_node_terms)
        msg.preferred_node_terms.extend(
            pb.PreferredSchedulingTerm(weight=x.weight, preference=_nst(x.preference))
            for x in p.affinity.preferred_node_terms
        )
        msg.required_pod_affinity.extend(_pat(x) for x in p.affinity.required_pod_affinity)
        msg.required_pod_anti_affinity.extend(
            _pat(x) for x in p.affinity.required_pod_anti_affinity
        )
        msg.preferred_pod_affinity.extend(
            pb.WeightedPodAffinityTerm(weight=x.weight, term=_pat(x.term))
            for x in p.affinity.preferred_pod_affinity
        )
        msg.preferred_pod_anti_affinity.extend(
            pb.WeightedPodAffinityTerm(weight=x.weight, term=_pat(x.term))
            for x in p.affinity.preferred_pod_anti_affinity
        )
    return msg


def node_to_proto(n: t.Node) -> "pb.Node":
    pb = _pb()
    return pb.Node(
        name=n.name,
        allocatable=_quantities(n.allocatable),
        labels=_labels(n.labels),
        taints=[pb.Taint(key=x.key, value=x.value, effect=x.effect) for x in n.taints],
        unschedulable=n.unschedulable,
        images=[pb.ImageEntry(name=k, size_bytes=v) for k, v in n.images.items()],
    )


def pod_clone(pod: t.Pod, **overrides) -> t.Pod:
    """Shallow Pod clone: __new__ + __dict__ copy (about 4x cheaper than
    copy.copy at wave and bind rates), with field objects SHARED with the
    source: the invariant the encoder's identity-level interning and
    bind-absorb `is` checks rest on (the JAX package's types.pod_clone)."""
    q = t.Pod.__new__(t.Pod)
    d = pod.__dict__.copy()
    d.update(overrides)
    q.__dict__ = d
    return q


def clone_pod(rep: t.Pod, name: str, uid: str, node_name: str = "") -> t.Pod:
    """pod_clone with the session-path fields (the one shared clone idiom —
    field objects stay shared with the rep)."""
    return pod_clone(rep, name=name, uid=uid, node_name=node_name)


def wave_parts_from_proto(
    msg, rep_cache: Optional[dict] = None
) -> Tuple[List[str], List[t.Pod], "np.ndarray"]:
    """-> (uids, reps, inv) WITHOUT materializing per-pod objects — the
    encoder's pregrouped path (api/delta.py — encode_pregrouped) consumes
    the interned form directly.  `rep_cache` memoizes decoded reps by
    serialized spec bytes so successive waves reuse identical objects."""
    import numpy as np

    reps = []
    for s in msg.specs:
        if rep_cache is None:
            reps.append(pod_from_proto(s))
            continue
        kb = s.SerializeToString()
        rep = rep_cache.get(kb)
        if rep is None:
            if len(rep_cache) > 4096:
                rep_cache.clear()
            rep = pod_from_proto(s)
            rep_cache[kb] = rep
        reps.append(rep)
    inv = np.asarray(msg.spec_idx, dtype=np.int64)
    return list(msg.uids), reps, inv


def wave_from_proto(msg, rep_cache: Optional[dict] = None) -> List[t.Pod]:
    """Pod names are synthesized from uids (the session path keys verdicts by
    wave position, never by name).

    The per-pod clone is __new__ + __dict__ copy — ~4x cheaper than
    copy.copy's reduce machinery at 50k pods/wave, and field objects stay
    shared with the rep (what the encoder's identity-level interning keys
    on).  `rep_cache` (per-session) memoizes decoded reps by serialized
    spec bytes so SUCCESSIVE waves reuse the same rep objects — steady-state
    waves then hit the identity level instead of re-canonicalizing ~every
    spec every wave.  Plain dict cache: the client memoizes its spec
    messages, so identical specs serialize to identical bytes in practice;
    a miss just decodes again."""
    reps = []
    for s in msg.specs:
        if rep_cache is None:
            reps.append(pod_from_proto(s))
            continue
        kb = s.SerializeToString()
        rep = rep_cache.get(kb)
        if rep is None:
            if len(rep_cache) > 4096:
                rep_cache.clear()
            rep = pod_from_proto(s)
            rep_cache[kb] = rep
        reps.append(rep)
    out: List[t.Pod] = []
    append = out.append
    clone = pod_clone
    for uid, si in zip(msg.uids, msg.spec_idx):
        append(clone(reps[si], name=uid, uid=uid))
    return out


def snapshot_to_proto(s: Snapshot) -> "pb.Snapshot":
    pb = _pb()
    return pb.Snapshot(
        nodes=[node_to_proto(n) for n in s.nodes],
        pending_pods=[pod_to_proto(p) for p in s.pending_pods],
        bound_pods=[pod_to_proto(p) for p in s.bound_pods],
        pod_groups=[
            pb.PodGroup(name=g.name, min_member=g.min_member) for g in s.pod_groups.values()
        ],
    )


# ---------- from proto ----------

def _from_selector(msg) -> Optional[t.LabelSelector]:
    if not msg.present:
        return None
    return t.LabelSelector(
        match_labels=tuple((l.key, l.value) for l in msg.match_labels),
        match_expressions=tuple(
            t.LabelSelectorRequirement(key=e.key, operator=e.op, values=tuple(e.values))
            for e in msg.match_expressions
        ),
    )


def _from_nst(msg) -> t.NodeSelectorTerm:
    return t.NodeSelectorTerm(
        match_expressions=tuple(
            t.NodeSelectorRequirement(key=e.key, operator=e.op, values=tuple(e.values))
            for e in msg.match_expressions
        )
    )


def _from_pat(msg) -> t.PodAffinityTerm:
    return t.PodAffinityTerm(
        topology_key=msg.topology_key,
        label_selector=_from_selector(msg.selector),
        namespaces=tuple(msg.namespaces),
    )


def pod_from_proto(msg) -> t.Pod:
    affinity = None
    if (
        msg.required_node_terms
        or msg.preferred_node_terms
        or msg.required_pod_affinity
        or msg.required_pod_anti_affinity
        or msg.preferred_pod_affinity
        or msg.preferred_pod_anti_affinity
    ):
        affinity = t.Affinity(
            required_node_terms=tuple(_from_nst(x) for x in msg.required_node_terms),
            preferred_node_terms=tuple(
                t.PreferredSchedulingTerm(weight=x.weight, preference=_from_nst(x.preference))
                for x in msg.preferred_node_terms
            ),
            required_pod_affinity=tuple(_from_pat(x) for x in msg.required_pod_affinity),
            required_pod_anti_affinity=tuple(
                _from_pat(x) for x in msg.required_pod_anti_affinity
            ),
            preferred_pod_affinity=tuple(
                t.WeightedPodAffinityTerm(weight=x.weight, term=_from_pat(x.term))
                for x in msg.preferred_pod_affinity
            ),
            preferred_pod_anti_affinity=tuple(
                t.WeightedPodAffinityTerm(weight=x.weight, term=_from_pat(x.term))
                for x in msg.preferred_pod_anti_affinity
            ),
        )
    return t.Pod(
        name=msg.name,
        namespace=msg.namespace or "default",
        uid=msg.uid,
        requests={q.resource: int(q.value) for q in msg.requests},
        labels={l.key: l.value for l in msg.labels},
        node_name=msg.node_name,
        priority=msg.priority,
        tolerations=tuple(
            t.Toleration(key=x.key, operator=x.op or "Equal", value=x.value, effect=x.effect)
            for x in msg.tolerations
        ),
        node_selector=tuple(sorted((l.key, l.value) for l in msg.node_selector)),
        affinity=affinity,
        topology_spread=tuple(
            t.TopologySpreadConstraint(
                max_skew=c.max_skew,
                topology_key=c.topology_key,
                when_unsatisfiable=c.when_unsatisfiable or t.DO_NOT_SCHEDULE,
                label_selector=_from_selector(c.selector),
            )
            for c in msg.topology_spread
        ),
        host_ports=tuple((h.protocol, h.port) for h in msg.host_ports),
        scheduling_gates=tuple(msg.scheduling_gates),
        pod_group=msg.pod_group,
        images=tuple(msg.images),
    )


def node_from_proto(msg) -> t.Node:
    return t.Node(
        name=msg.name,
        allocatable={q.resource: int(q.value) for q in msg.allocatable},
        labels={l.key: l.value for l in msg.labels},
        taints=tuple(
            t.Taint(key=x.key, value=x.value, effect=x.effect) for x in msg.taints
        ),
        unschedulable=msg.unschedulable,
        images={e.name: int(e.size_bytes) for e in msg.images},
    )


def snapshot_from_proto(msg) -> Snapshot:
    return Snapshot(
        nodes=[node_from_proto(n) for n in msg.nodes],
        pending_pods=[pod_from_proto(p) for p in msg.pending_pods],
        bound_pods=[pod_from_proto(p) for p in msg.bound_pods],
        pod_groups={
            g.name: t.PodGroup(name=g.name, min_member=g.min_member) for g in msg.pod_groups
        },
    )
