"""Snapshot -> fixed-shape tensors on the device (the cold full encode).

The port of the JAX package's ``api/snapshot.py`` encoder (its
``encode_snapshot`` delegates to ``api/delta.py`` — ``build_cluster_side``,
``_pod_side`` and ``_assemble`` — whose cold path this module reproduces):
the host-side cluster state is lowered once per scheduling step into padded,
bucketed arrays, then moved to the device as one ``ClusterArrays``.

Tensor schema (N nodes, P pending pods, R resources, L node-label literals,
T taint vocab, S node-selector terms, E exprs/term, TT terms/pod — padded):

  node_valid[N]        bool   real node (padding rows are infeasible everywhere)
  node_alloc[N, R]     i32    allocatable, rescaled per resource to fit int32
  node_used[N, R]      i32    sum of bound pods' requests
  node_unsched[N]      bool   spec.unschedulable
  node_labels[N, L]    bool   literal incidence
  node_taint_ns[N, T]  bool   NoSchedule/NoExecute taints (hard)
  pod_valid[P]         bool
  pod_req[P, R]        i32    effective pod request (+1 synthetic "pods" resource)
  pod_prio[P]          i32    spec.priority
  pod_tol_ns[P, T]     bool   True = pod tolerates hard taint t
  pod_nodename[P]      i32    fixed node index, -1 unset, -2 named node missing
  pod_terms[P, TT]     i32    required node-selection term ids into sel_*, -1 pad
  pod_has_sel[P]       bool
  sel_mask[S, E, L]    bool   literal masks per term expression
  sel_kind[S, E]       i32    vocab.KIND_* per expression

Pending pods are sorted into activeQ order (priority desc, then arrival), so
tensor index == commit order in ops/assign.py.

This slice ports the fit-only stage set.  A snapshot that needs a stage the
port does not have yet (pod (anti-)affinity, topology spread, host ports,
images, volumes, resource claims, pod groups) raises NotImplementedError
here; it is never dropped.  PreferNoSchedule taints and preferred node
affinity are recorded as evidence flags, so ``ops.infer_score_config``
enables those stages exactly as the JAX package would, and
``ops.schedule_batch`` then refuses them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import types as t
from . import vocab as v

_BASE_RESOURCES = (t.CPU, t.MEMORY, t.PODS, t.EPHEMERAL_STORAGE)
_DEFAULT_POD_LIMIT = 1_000_000  # allocatable "pods" when a node does not declare it
_INT32_MAX = 2**31 - 1


def _round_up_pow2(n: int, minimum: int = 8) -> int:
    return max(minimum, 1 << max(0, math.ceil(math.log2(max(1, n)))))


def _bucket(n: int, minimum: int = 8) -> int:
    """Pad-and-bucket size: powers of two up to 2048, then multiples of 2048."""
    if n <= 2048:
        return _round_up_pow2(n, minimum)
    return ((n + 2047) // 2048) * 2048


@dataclass
class Snapshot:
    """Host-side cluster state handed to the encoder.  `bound_pods` are pods
    with node_name set; they contribute node_used."""

    nodes: List[t.Node] = field(default_factory=list)
    pending_pods: List[t.Pod] = field(default_factory=list)
    bound_pods: List[t.Pod] = field(default_factory=list)
    pod_groups: Dict[str, t.PodGroup] = field(default_factory=dict)
    pvs: List[t.PersistentVolume] = field(default_factory=list)
    pvcs: Dict[str, t.PersistentVolumeClaim] = field(default_factory=dict)
    storage_classes: Dict[str, object] = field(default_factory=dict)
    resource_slices: List[object] = field(default_factory=list)
    device_classes: Dict[str, object] = field(default_factory=dict)


@dataclass
class EncodingMeta:
    """Host-side metadata needed to decode kernel outputs back to names."""

    node_names: List[str]
    pod_names: List[str]  # in activeQ order == device pod index order
    pod_perm: np.ndarray  # pod_perm[device_pod_index] == pending_pods list index
    resources: List[str]
    resource_scale: np.ndarray  # i64[R]; device value * scale == canonical units
    label_vocab: v.LabelVocab
    taint_vocab: v.Interner
    n_nodes: int
    n_pods: int


# pod-axis fields (axis 0 is P) — what a pod prefix slices
POD_FIELDS = (
    "pod_valid", "pod_req", "pod_prio", "pod_tol_ns", "pod_nodename",
    "pod_terms", "pod_has_sel",
)
# field -> torch dtype
_DTYPES = {
    "node_valid": torch.bool, "node_alloc": torch.int32, "node_used": torch.int32,
    "node_unsched": torch.bool, "node_labels": torch.bool,
    "node_taint_ns": torch.bool, "pod_valid": torch.bool,
    "pod_req": torch.int32, "pod_prio": torch.int32, "pod_tol_ns": torch.bool,
    "pod_nodename": torch.int32, "pod_terms": torch.int32,
    "pod_has_sel": torch.bool, "sel_mask": torch.bool, "sel_kind": torch.int32,
}


@dataclass
class ClusterArrays:
    """The device-side snapshot: the fields the fit-only slice reads, as
    contiguous tensors on one device, plus two host-side evidence flags for
    the score stages this slice does not port."""

    node_valid: torch.Tensor
    node_alloc: torch.Tensor
    node_used: torch.Tensor
    node_unsched: torch.Tensor
    node_labels: torch.Tensor
    node_taint_ns: torch.Tensor
    pod_valid: torch.Tensor
    pod_req: torch.Tensor
    pod_prio: torch.Tensor
    pod_tol_ns: torch.Tensor
    pod_nodename: torch.Tensor
    pod_terms: torch.Tensor
    pod_has_sel: torch.Tensor
    sel_mask: torch.Tensor
    sel_kind: torch.Tensor
    # some node carries a PreferNoSchedule taint (TaintToleration score stage)
    has_prefer_taints: bool = False
    # some pod carries a preferred node-affinity term (NodeAffinity score stage)
    has_node_pref: bool = False

    @property
    def N(self) -> int:
        return self.node_alloc.shape[0]

    @property
    def P(self) -> int:
        return self.pod_req.shape[0]

    @property
    def R(self) -> int:
        return self.node_alloc.shape[1]

    @property
    def device(self) -> torch.device:
        return self.node_alloc.device

    def tensors(self) -> Dict[str, torch.Tensor]:
        return {f: getattr(self, f) for f in _DTYPES}

    def to(self, device) -> "ClusterArrays":
        return replace(self, **{k: x.to(device) for k, x in self.tensors().items()})

    def pod_prefix(self, k: int) -> "ClusterArrays":
        """The first k pods (activeQ order).  A prefix of the commit scan is
        itself a scan: the first k pods' choices do not depend on later pods."""
        return replace(self, **{f: getattr(self, f)[:k].contiguous() for f in POD_FIELDS})

    @classmethod
    def from_numpy(cls, arrays: Dict[str, np.ndarray], device, **flags) -> "ClusterArrays":
        dev = torch.device(device)
        out = {}
        for name, dt in _DTYPES.items():
            a = np.array(arrays[name])  # a writable, contiguous copy
            if dt is torch.bool:
                a = a != 0
            out[name] = torch.from_numpy(a).to(dt).to(dev)
        return cls(**out, **flags)


def _resource_axis(snap) -> List[str]:
    res = list(_BASE_RESOURCES)
    seen = set(res)
    for obj in snap.nodes:
        for k in obj.allocatable:
            if k not in seen:
                seen.add(k)
                res.append(k)
    for pod in [*snap.pending_pods, *snap.bound_pods]:
        for k in pod.requests:
            if k not in seen:
                seen.add(k)
                res.append(k)
    return res


def _scale_for(values) -> int:
    """Exact-where-possible int32 rescale: gcd unit, widened if the max still
    overflows (widening rounds requests up / allocatable down)."""
    nz = np.abs(np.asarray(values, dtype=np.int64).ravel())
    nz = nz[nz != 0]
    if nz.size == 0:
        return 1
    scale = max(1, int(np.gcd.reduce(nz)))
    m = int(nz.max())
    while m // scale > _INT32_MAX:
        scale *= 2
    return scale


def pod_effective_requests(pod, resources: Sequence[str]) -> List[int]:
    """Pod-level request vector; every pod consumes 1 of the synthetic "pods"
    resource (noderesources/fit.go — computePodResourceRequest)."""
    return [pod.requests.get(r, 0) if r != t.PODS else max(1, pod.requests.get(r, 1)) for r in resources]


def activeq_order(pods) -> np.ndarray:
    """Indices sorting pods into activeQ pop order: priority desc, arrival asc."""
    prio = np.fromiter((p.priority for p in pods), dtype=np.int64, count=len(pods))
    return np.argsort(-prio, kind="stable")


def _node_taints(nd) -> list:
    # spec.unschedulable is the synthetic node.kubernetes.io/unschedulable
    # NoSchedule taint, so NodeUnschedulable falls out of the taint filter
    ts = list(nd.taints)
    if nd.unschedulable:
        ts.append(t.Taint(key="node.kubernetes.io/unschedulable", effect=t.NO_SCHEDULE))
    return ts


def _pod_spec_key(pod) -> Tuple:
    """Everything this encoder reads from a pending pod: pods with equal keys
    get identical rows, so the per-pod work runs once per spec."""
    return (
        tuple(sorted(pod.requests.items())),
        pod.node_name,
        pod.priority,
        pod.tolerations,
        pod.node_selector,
        pod.affinity,
        bool(pod.scheduling_gates),
    )


def _refuse(what: str, queue: str) -> None:
    raise NotImplementedError(
        f"{what}: not ported to kubernetes_tpu_torch yet (ROADMAP.md {queue})"
    )


def _check_supported(snap) -> None:
    """Raise on anything that would need a stage this slice does not port."""
    if snap.pvs or snap.pvcs or (snap.resource_slices and snap.device_classes):
        _refuse("volumes / resource slices", "queue A5, api/volumes.py")
    if any(nd.volume_attach_limit for nd in snap.nodes):
        _refuse("volume attach limits", "queue A5, api/volumes.py")
    if snap.pod_groups:
        _refuse("pod groups", "queue A9, kernel B11")
    node_images = any(nd.images for nd in snap.nodes)
    for pending, pods in ((True, snap.pending_pods), (False, snap.bound_pods)):
        for pod in pods:
            a = pod.affinity
            if a is not None and (
                a.required_pod_affinity or a.required_pod_anti_affinity
                or a.preferred_pod_affinity or a.preferred_pod_anti_affinity
            ):
                _refuse(f"pod {pod.name!r}: pod (anti-)affinity", "queue A7, kernels B8/B9")
            if pod.host_ports:
                _refuse(f"pod {pod.name!r}: host ports", "queue A7, kernel B9 ports_ok")
            if pod.pvcs or pod.resource_claims:
                _refuse(f"pod {pod.name!r}: volumes / resource claims", "queue A5")
            if not pending:
                continue
            if pod.topology_spread:
                _refuse(f"pod {pod.name!r}: topology spread", "queue A7, kernel B9")
            if pod.pod_group:
                _refuse(f"pod {pod.name!r}: pod group", "queue A9, kernel B11")
            if pod.images and node_images:
                _refuse(f"pod {pod.name!r}: image locality", "queue A7, kernel B8")


def encode_snapshot(snap: Snapshot, device=None) -> Tuple[ClusterArrays, EncodingMeta]:
    """Cold full encode of `snap` onto `device` (the card unless the caller
    passes device="cpu")."""
    dev = resolve_device(device)
    _check_supported(snap)
    nodes = snap.nodes
    n = len(nodes)
    pending = snap.pending_pods
    perm = activeq_order(pending)
    pods = [pending[i] for i in perm]
    p = len(pods)
    N = _bucket(n)
    P = _bucket(p)
    resources = _resource_axis(snap)
    R = len(resources)
    node_index = {nd.name: i for i, nd in enumerate(nodes)}

    # --- pending pods grouped by spec (rows are built once per spec) ---
    spec_ids: Dict[Tuple, int] = {}
    reps: List = []
    inv = np.empty(p, dtype=np.int64)
    for i, pod in enumerate(pods):
        k = _pod_spec_key(pod)
        u = spec_ids.get(k)
        if u is None:
            u = spec_ids[k] = len(reps)
            reps.append(pod)
        inv[i] = u
    U = len(reps)

    # label keys some pending pod's node selection refers to
    referenced = set()
    for pod in reps:
        referenced.update(k for k, _ in pod.node_selector)
        if pod.affinity:
            for term in pod.affinity.required_node_terms:
                referenced.update(e.key for e in term.match_expressions)
            for pt in pod.affinity.preferred_node_terms:
                referenced.update(e.key for e in pt.preference.match_expressions)

    # --- node labels, interned by filtered profile ---
    lab = v.LabelVocab()
    prof_ids: Dict[Tuple, int] = {}
    prof_rows: List[List[int]] = []
    prof_inv = np.empty(n, dtype=np.int64)
    for i, nd in enumerate(nodes):
        fk = tuple(sorted((k, val) for k, val in nd.labels.items() if k in referenced))
        u = prof_ids.get(fk)
        if u is None:
            u = prof_ids[fk] = len(prof_rows)
            prof_rows.append(lab.add_labels(dict(fk)))
        prof_inv[i] = u
    L = max(1, len(lab))
    node_labels = np.zeros((N, L), dtype=bool)
    if n:
        uniq = np.zeros((len(prof_rows), L), dtype=bool)
        for u, lits in enumerate(prof_rows):
            uniq[u, lits] = True
        node_labels[:n] = uniq[prof_inv]

    # --- taints, interned by node profile ---
    taints = v.Interner()
    tprof_ids: Dict[Tuple, int] = {}
    tprof: List[list] = []
    tinv = np.empty(n, dtype=np.int64)
    for i, nd in enumerate(nodes):
        key = (nd.taints, nd.unschedulable)
        u = tprof_ids.get(key)
        if u is None:
            u = tprof_ids[key] = len(tprof)
            ts = _node_taints(nd)
            tprof.append(ts)
            for tn in ts:
                taints.intern((tn.key, tn.value, tn.effect))
        tinv[i] = u
    T = max(1, len(taints))
    taint_objs = [t.Taint(k, val, eff) for (k, val, eff) in taints.items]
    taint_is_pref = np.array([tn.effect == t.PREFER_NO_SCHEDULE for tn in taint_objs], dtype=bool)
    node_taint_ns = np.zeros((N, T), dtype=bool)
    if n:
        uniq = np.zeros((len(tprof), T), dtype=bool)
        for u, ts in enumerate(tprof):
            for tn in ts:
                if tn.effect != t.PREFER_NO_SCHEDULE:
                    uniq[u, taints.get((tn.key, tn.value, tn.effect))] = True
        node_taint_ns[:n] = uniq[tinv]

    # --- resources: raw int64, then the per-axis int32 rescale ---
    aprof: Dict[Tuple, List[int]] = {}
    alloc_raw = np.zeros((n, R), dtype=np.int64)
    for i, nd in enumerate(nodes):
        key = tuple(sorted(nd.allocatable.items()))
        row = aprof.get(key)
        if row is None:
            row = aprof[key] = [
                nd.allocatable.get(r, _DEFAULT_POD_LIMIT if r == t.PODS else 0)
                for r in resources
            ]
        alloc_raw[i] = row
    used_raw = np.zeros((n, R), dtype=np.int64)
    breq: Dict[Tuple, List[int]] = {}
    b_ni: List[int] = []
    b_req: List[List[int]] = []
    for q in snap.bound_pods:
        ni = node_index.get(q.node_name)
        if ni is None:
            continue
        key = tuple(sorted(q.requests.items()))
        row = breq.get(key)
        if row is None:
            row = breq[key] = pod_effective_requests(q, resources)
        b_ni.append(ni)
        b_req.append(row)
    if b_ni:
        np.add.at(used_raw, np.array(b_ni), np.array(b_req, dtype=np.int64))
    req_uniq = (
        np.array([pod_effective_requests(rp, resources) for rp in reps], dtype=np.int64)
        if U else np.zeros((1, R), dtype=np.int64)
    )
    stacked = np.concatenate([alloc_raw, req_uniq, used_raw], axis=0)
    scale = np.array([_scale_for(stacked[:, j]) for j in range(R)], dtype=np.int64)
    node_alloc = np.zeros((N, R), dtype=np.int32)
    node_alloc[:n] = alloc_raw // scale
    node_used = np.zeros((N, R), dtype=np.int32)
    node_used[:n] = -(-used_raw // scale)
    pod_req = np.zeros((P, R), dtype=np.int32)
    if p:
        pod_req[:p] = (-(-req_uniq // scale))[inv]

    # --- pod side, per unique spec, scattered through inv ---
    table = v.TermTable()
    Uq = max(1, U)
    u_valid = np.zeros(Uq, dtype=bool)
    u_prio = np.zeros(Uq, dtype=np.int32)
    u_tol = np.ones((Uq, T), dtype=bool)
    u_pin = np.full(Uq, -1, dtype=np.int32)
    term_lists: List[List[int]] = []
    has_node_pref = False
    for ui, pod in enumerate(reps):
        u_valid[ui] = not pod.scheduling_gates
        u_prio[ui] = pod.priority
        if pod.tolerations:
            for tid, taint in enumerate(taint_objs):
                if not taint_is_pref[tid]:
                    u_tol[ui, tid] = any(tol.tolerates(taint) for tol in pod.tolerations)
        elif taint_objs:
            u_tol[ui] = taint_is_pref
        if pod.node_name:
            u_pin[ui] = node_index.get(pod.node_name, -2)
        terms = v.pod_required_node_terms(pod, lab)
        term_lists.append([] if terms is None else [table.intern(tm) for tm in terms])
        if pod.affinity:
            # preferred terms share the term table (as in the JAX encoder);
            # their score stage is refused by ops.schedule_batch
            for pt in pod.affinity.preferred_node_terms:
                if pt.preference.match_expressions:
                    table.intern(v.lower_node_term(pt.preference.match_expressions, lab))
                    has_node_pref = True
    TT = max(1, max((len(x) for x in term_lists), default=1))
    u_terms = np.full((Uq, TT), -1, dtype=np.int32)
    for ui, ids in enumerate(term_lists):
        u_terms[ui, : len(ids)] = ids
    u_has_sel = np.array([bool(ids) for ids in term_lists] or [False], dtype=bool)

    pod_valid = np.zeros(P, dtype=bool)
    pod_prio = np.zeros(P, dtype=np.int32)
    pod_tol_ns = np.ones((P, T), dtype=bool)
    pod_nodename = np.full(P, -1, dtype=np.int32)
    pod_terms = np.full((P, TT), -1, dtype=np.int32)
    pod_has_sel = np.zeros(P, dtype=bool)
    if p:
        pod_valid[:p] = u_valid[inv]
        pod_prio[:p] = u_prio[inv]
        pod_tol_ns[:p] = u_tol[inv]
        pod_nodename[:p] = u_pin[inv]
        pod_terms[:p] = u_terms[inv]
        pod_has_sel[:p] = u_has_sel[inv]
    sel_mask, sel_kind = table.encode(L)

    node_valid = np.zeros(N, dtype=bool)
    node_valid[:n] = True
    node_unsched = np.zeros(N, dtype=bool)
    node_unsched[:n] = [nd.unschedulable for nd in nodes]

    arrays = ClusterArrays.from_numpy(
        dict(
            node_valid=node_valid, node_alloc=node_alloc, node_used=node_used,
            node_unsched=node_unsched, node_labels=node_labels,
            node_taint_ns=node_taint_ns, pod_valid=pod_valid, pod_req=pod_req,
            pod_prio=pod_prio, pod_tol_ns=pod_tol_ns, pod_nodename=pod_nodename,
            pod_terms=pod_terms, pod_has_sel=pod_has_sel, sel_mask=sel_mask,
            sel_kind=sel_kind,
        ),
        dev,
        has_prefer_taints=bool(taint_is_pref.any()),
        has_node_pref=has_node_pref,
    )
    meta = EncodingMeta(
        node_names=[nd.name for nd in nodes],
        pod_names=[pod.name for pod in pods],
        pod_perm=perm,
        resources=resources,
        resource_scale=scale,
        label_vocab=lab,
        taint_vocab=taints,
        n_nodes=n,
        n_pods=p,
    )
    return arrays, meta


def decode_choices(choices, meta: EncodingMeta) -> Dict[str, Optional[str]]:
    """choices i32[P] (node index or -1) -> {pod_name: node_name or None}."""
    c = torch.as_tensor(choices).cpu().numpy()[: meta.n_pods]
    return {
        name: (meta.node_names[int(k)] if k >= 0 else None)
        for name, k in zip(meta.pod_names, c)
    }
