"""Snapshot -> fixed-shape tensors on the device.

The port of the JAX package's ``api/snapshot.py``: the host-side types
(``Snapshot``, ``ClusterArrays``, ``EncodingMeta``), the shared encoding
rules (bucketing, the int32 rescale, activeQ order, the pod spec key and
its interner) and ``encode_snapshot``, which is a one-shot
``api/delta.py — DeltaEncoder``, as in the JAX package, so the cold encode
and the incremental one are one code body.

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
in the encoder (``_refuse``); it is never dropped.  PreferNoSchedule taints
and preferred node affinity are recorded as evidence flags, so
``ops.infer_score_config`` enables those stages exactly as the JAX package
would, and ``ops.schedule_batch`` then refuses them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

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
    # equivalence classes (ops/incremental.py — HoistCache): the class of each
    # pod row i32[P] (pods with equal spec keys share a class; padded rows
    # take class U, the padding class), the first row of each class i64[U1]
    # (the padding class points at row n_pods), and U1
    pod_class: Optional[np.ndarray] = None
    class_first_pod: Optional[np.ndarray] = None
    n_classes: int = 0


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

    FIELDS = tuple(_DTYPES)

    def tensors(self) -> Dict[str, torch.Tensor]:
        return {f: getattr(self, f) for f in self.FIELDS}

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
    """A pending pod's spec identity, the JAX package's api/snapshot.py
    _pod_spec_key: pods with equal keys get identical rows, so the per-pod
    work runs once per spec, and the keys ARE the equivalence classes
    (EncodingMeta.pod_class), which the class-wave route's commit order
    depends on, so they must partition pods exactly as the JAX encoder
    does (labels and the other fields this slice refuses included)."""
    return (
        tuple(sorted(pod.requests.items())),
        tuple(sorted(pod.labels.items())),
        pod.namespace,
        pod.node_name,
        pod.priority,
        pod.tolerations,
        pod.node_selector,
        pod.affinity,
        pod.topology_spread,
        pod.host_ports,
        pod.scheduling_gates,
        pod.pod_group,
        pod.images,
    )


def _refuse(what: str, queue: str) -> None:
    raise NotImplementedError(
        f"{what}: not ported to kubernetes_tpu_torch yet (ROADMAP.md {queue})"
    )


def _identity_key(pod) -> Tuple:
    """Field-object identity profile of a pod: pods copied from one template
    share these objects, so equal keys imply equal _pod_spec_key (the fast
    first level of SpecInterner).  Covers every field _pod_spec_key reads."""
    return (
        id(pod.requests), id(pod.labels), pod.namespace, pod.node_name,
        pod.priority, id(pod.tolerations), id(pod.node_selector),
        id(pod.affinity), id(pod.topology_spread), id(pod.host_ports),
        id(pod.scheduling_gates), pod.pod_group, id(pod.images),
    )


class SpecInterner:
    """A PERSISTENT two-level interner (the JAX package's api/snapshot.py:346,
    its Python path): identity profile -> canonical spec key survives across
    calls, so waves stamped from the same objects cost O(P) dict hits, not
    O(P) sorted canonicalizations.  Values keep the keyed pod alive, so a
    recycled id never aliases a live entry."""

    def __init__(self):
        self._keys: Dict[Tuple, Tuple] = {}

    def group(self, pods: Sequence):
        """-> (reps, inv, rep_keys): the same reps and inv as group_by_spec,
        plus each rep's canonical key."""
        if len(self._keys) > 2 * (len(pods) + 1024):
            self._keys.clear()
        cache = self._keys
        can_ids: Dict[Tuple, int] = {}
        reps: List = []
        rep_keys: List[Tuple] = []
        inv = np.empty(len(pods), dtype=np.int64)
        for i, pod in enumerate(pods):
            ik = _identity_key(pod)
            ent = cache.get(ik)
            if ent is None:
                ent = cache[ik] = (_pod_spec_key(pod), pod)
            k = ent[0]
            su = can_ids.get(k)
            if su is None:
                su = can_ids[k] = len(reps)
                reps.append(pod)
                rep_keys.append(k)
            inv[i] = su
        return reps, inv, tuple(rep_keys)


def group_by_spec(pods: Sequence) -> Tuple[List, np.ndarray]:
    """-> (reps, inv): the unique encoding specs in first-occurrence order
    and each pod's spec index (the JAX package's api/snapshot.py:508)."""
    reps, inv, _ = SpecInterner().group(pods)
    return reps, inv


def encode_snapshot(snap: Snapshot, device=None) -> Tuple[ClusterArrays, EncodingMeta]:
    """One-shot encode of `snap` onto `device` (the card unless the caller
    passes device="cpu"): a DeltaEncoder used for a single cycle, so the
    incremental path and this one are one code body (api/delta.py)."""
    from .delta import DeltaEncoder

    return DeltaEncoder(device).encode_device(snap)


def decode_choices(choices, meta: EncodingMeta) -> Dict[str, Optional[str]]:
    """choices i32[P] (node index or -1) -> {pod_name: node_name or None}."""
    c = torch.as_tensor(choices).cpu().numpy()[: meta.n_pods]
    return {
        name: (meta.node_names[int(k)] if k >= 0 else None)
        for name, k in zip(meta.pod_names, c)
    }
