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

The pairwise, port, preferred-term and image fields are listed on
``ClusterArrays``.  Volumes and resource claims are resolved into
node-affinity terms and extra resources before encoding (api/volumes.py).
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
    # node rows whose bound-pod contributions changed in THIS encode's sync
    # (api/delta.py — sync_bound); None = unknown (a fresh rebuild, or the
    # one-shot encoder).  The flight recorder's dirty_cols reads it
    dirty_nodes: Optional[np.ndarray] = None


# pod-axis fields (axis 0 is P) — what a pod prefix slices (m_pend is the
# one field whose pod axis is its last)
POD_FIELDS = (
    "pod_valid", "pod_req", "pod_prio", "pod_tol_ns", "pod_tol_pref", "pod_nodename",
    "pod_terms", "pod_has_sel", "pod_pref_terms", "pod_pref_weights", "pod_match_terms",
    "pod_match_vals", "pod_aff_self", "pod_aff_terms", "pod_anti_terms", "pod_pref_aff_terms",
    "pod_pref_aff_w", "pod_spread_terms", "pod_spread_maxskew", "pod_spread_hard", "pod_ports",
    "pod_group", "image_score",
)
# field -> torch dtype, in the JAX package's ClusterArrays order
_DTYPES = {
    "node_valid": torch.bool, "node_alloc": torch.int32, "node_used": torch.int32,
    "node_unsched": torch.bool, "node_labels": torch.bool,
    "node_taint_ns": torch.bool, "node_taint_pref": torch.bool, "pod_valid": torch.bool,
    "pod_req": torch.int32, "pod_prio": torch.int32, "pod_tol_ns": torch.bool,
    "pod_tol_pref": torch.bool, "pod_nodename": torch.int32, "pod_terms": torch.int32,
    "pod_has_sel": torch.bool, "sel_mask": torch.bool, "sel_kind": torch.int32,
    "pod_pref_terms": torch.int32, "pod_pref_weights": torch.float32,
    "node_dom": torch.int32, "term_key": torch.int32, "m_pend": torch.float32,
    "pod_match_terms": torch.int32, "pod_match_vals": torch.float32, "pod_aff_self": torch.bool,
    "term_counts0": torch.float32, "anti_counts0": torch.float32,
    "pod_aff_terms": torch.int32, "pod_anti_terms": torch.int32,
    "pod_pref_aff_terms": torch.int32, "pod_pref_aff_w": torch.float32, "pref_own0": torch.float32,
    "pod_spread_terms": torch.int32, "pod_spread_maxskew": torch.int32, "pod_spread_hard": torch.bool,
    "pod_ports": torch.bool, "node_ports0": torch.bool,
    "pod_group": torch.int32, "group_min": torch.int32,
    "image_score": None,  # the score storage dtype: ops/bitplane.py score_store_dtype
}


@dataclass
class ClusterArrays:
    """The device-side snapshot, the JAX package's ClusterArrays field for
    field (api/snapshot.py:127), as contiguous tensors on one device.

    Beyond the fit-only fields of the module docstring (S preferred-term
    slots PW, T2 pairwise terms over K topology keys and D domains — domain
    id D: the node lacks the key —, M matched-term slots, A1/A2/B/C
    affinity, anti-affinity, preferred and spread slots, PT host ports):

      node_taint_pref[N, T]   bool  PreferNoSchedule taints
      pod_tol_pref[P, T]      bool  True = pod tolerates PreferNoSchedule taint t
      pod_pref_terms[P, PW]   i32   preferred node-affinity term ids into sel_*, -1 pad
      pod_pref_weights[P, PW] f32
      node_dom[K, N]          i32   domain of node n under key k
      term_key[T2]            i32   topology key of each term
      m_pend[T2, P]           f32   pending pod p matches term t's selector + namespaces
      pod_match_terms[P, M]   i32   m_pend's nonzero rows per pod, -1 pad
      pod_match_vals[P, M]    f32
      pod_aff_self[P, A1]     bool  the pod matches its own required-affinity term
      term_counts0[T2, D+1]   f32   bound pods matching term t per domain
      anti_counts0[T2, D+1]   f32   bound pods owning anti-affinity term t per domain
      pref_own0[T2, D+1]      f32   weight sums of bound pods owning preferred term t
      pod_aff_terms[P, A1], pod_anti_terms[P, A2], pod_pref_aff_terms[P, B] i32
      pod_pref_aff_w[P, B]    f32   signed weights (anti-affinity negative)
      pod_spread_terms / pod_spread_maxskew[P, C] i32, pod_spread_hard[P, C] bool
      pod_ports[P, PT], node_ports0[N, PT] bool
      pod_group[P] i32 (-1: none), group_min[G] i32 minMember per group (G >= 1)
      image_score             bf16  [P, N] ImageLocality scores, [P, 1] zeros
                                    when no pod and node share an image
                                    (f32 under KTPU_SCORE_DTYPE=f32)
    """

    node_valid: torch.Tensor
    node_alloc: torch.Tensor
    node_used: torch.Tensor
    node_unsched: torch.Tensor
    node_labels: torch.Tensor
    node_taint_ns: torch.Tensor
    node_taint_pref: torch.Tensor
    pod_valid: torch.Tensor
    pod_req: torch.Tensor
    pod_prio: torch.Tensor
    pod_tol_ns: torch.Tensor
    pod_tol_pref: torch.Tensor
    pod_nodename: torch.Tensor
    pod_terms: torch.Tensor
    pod_has_sel: torch.Tensor
    sel_mask: torch.Tensor
    sel_kind: torch.Tensor
    pod_pref_terms: torch.Tensor
    pod_pref_weights: torch.Tensor
    node_dom: torch.Tensor
    term_key: torch.Tensor
    m_pend: torch.Tensor
    pod_match_terms: torch.Tensor
    pod_match_vals: torch.Tensor
    pod_aff_self: torch.Tensor
    term_counts0: torch.Tensor
    anti_counts0: torch.Tensor
    pod_aff_terms: torch.Tensor
    pod_anti_terms: torch.Tensor
    pod_pref_aff_terms: torch.Tensor
    pod_pref_aff_w: torch.Tensor
    pref_own0: torch.Tensor
    pod_spread_terms: torch.Tensor
    pod_spread_maxskew: torch.Tensor
    pod_spread_hard: torch.Tensor
    pod_ports: torch.Tensor
    node_ports0: torch.Tensor
    pod_group: torch.Tensor
    group_min: torch.Tensor
    image_score: torch.Tensor

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
        out = {f: getattr(self, f)[:k].contiguous() for f in POD_FIELDS}
        out["m_pend"] = self.m_pend[:, :k].contiguous()
        return replace(self, **out)

    @classmethod
    def from_numpy(cls, arrays: Dict[str, np.ndarray], device) -> "ClusterArrays":
        """From host arrays (the JAX package's field names and dtypes; a bf16
        field comes as its uint16 bit patterns or as ml_dtypes bf16, an f32
        one as its values; both land on the storage lattice,
        ops/bitplane.py scores_of_np).  A field beyond the fit-only ones
        that is missing takes the value the encoder gives a snapshot
        without that feature (no_feature_fields)."""
        from ..ops.bitplane import np_score_dtype, scores_of_np

        dev = torch.device(device)
        arrays = {**no_feature_fields(len(arrays["pod_req"]), len(arrays["node_alloc"]),
                                      np.shape(arrays["node_taint_ns"])[1]), **arrays}
        out = {}
        for name, dt in _DTYPES.items():
            a = np.array(arrays[name])  # a writable, contiguous copy
            if name == "image_score":
                x = scores_of_np(a)
            else:
                if dt is torch.bool:
                    a = a != 0
                x = torch.from_numpy(a).to(dt)
            out[name] = x.to(dev)
        return cls(**out)


def no_feature_fields(P: int, N: int, T: int) -> Dict[str, np.ndarray]:
    """The arrays the encoder gives a snapshot with no preferred terms, no
    pairwise terms, no host ports, no PreferNoSchedule taints and no images:
    one empty slot each, one term whose key no node has (D = 0)."""
    from ..ops.bitplane import np_score_dtype

    return dict(
        node_taint_pref=np.zeros((N, T), bool), pod_tol_pref=np.ones((P, T), bool),
        pod_pref_terms=np.full((P, 1), -1, np.int32), pod_pref_weights=np.zeros((P, 1), np.float32),
        node_dom=np.zeros((1, N), np.int32), term_key=np.zeros(1, np.int32), m_pend=np.zeros((1, P), np.float32),
        pod_match_terms=np.full((P, 1), -1, np.int32), pod_match_vals=np.zeros((P, 1), np.float32),
        pod_aff_self=np.zeros((P, 1), bool), term_counts0=np.zeros((1, 1), np.float32),
        anti_counts0=np.zeros((1, 1), np.float32), pod_aff_terms=np.full((P, 1), -1, np.int32),
        pod_anti_terms=np.full((P, 1), -1, np.int32), pod_pref_aff_terms=np.full((P, 1), -1, np.int32),
        pod_pref_aff_w=np.zeros((P, 1), np.float32), pref_own0=np.zeros((1, 1), np.float32),
        pod_spread_terms=np.full((P, 1), -1, np.int32), pod_spread_maxskew=np.zeros((P, 1), np.int32),
        pod_spread_hard=np.zeros((P, 1), bool), pod_ports=np.zeros((P, 1), bool),
        node_ports0=np.zeros((N, 1), bool), pod_group=np.full(P, -1, np.int32), group_min=np.ones(1, np.int32),
        image_score=np.zeros((P, 1), np_score_dtype()),
    )


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


_IMG_MIN_MB = 23.0  # imagelocality/image_locality.go — minThreshold (23 MB)
_IMG_MAX_MB = 1000.0  # maxThreshold


def image_score_value(sum_mb: float) -> np.float32:
    """ImageLocality score from summed present-image megabytes (f32):
    100 * (clip(sum) - min) / (max - min), rounded onto the bf16 lattice
    (the JAX package's api/snapshot.py:247)."""
    from ..ops.bitplane import bf16_round_np

    s = np.float32(min(max(float(sum_mb), _IMG_MIN_MB), _IMG_MAX_MB))
    return np.float32(bf16_round_np(
        (s - np.float32(_IMG_MIN_MB)) * np.float32(100.0) / np.float32(_IMG_MAX_MB - _IMG_MIN_MB)))


def _image_score_matrix(nodes, reps, inv, N: int, P: int) -> np.ndarray:
    """ImageLocality scores on the storage lattice [P, N] (bf16 bit patterns
    as uint16, or f32 under KTPU_SCORE_DTYPE=f32), or [P, 1] zeros when no pending pod and node share an image (the JAX package's
    api/snapshot.py:263).  Image sizes quantize to whole MB, so the sums are
    integer-exact in f32; the product runs over the unique specs `reps` and
    rows are gathered per pod through `inv`."""
    from ..ops.bitplane import np_score_dtype, quantize_scores_np

    img_ids: Dict[str, int] = {}
    for pod in reps:
        for im in pod.images:
            img_ids.setdefault(im, len(img_ids))
    if not img_ids or not any(nd.images for nd in nodes):
        return np.zeros((P, 1), dtype=np_score_dtype())
    I = len(img_ids)
    node_mb = np.zeros((N, I), dtype=np.float32)
    for i, nd in enumerate(nodes):
        for im, size in nd.images.items():
            j = img_ids.get(im)
            if j is not None:
                node_mb[i, j] = np.float32(size // (1024 * 1024))
    pod_has = np.zeros((len(reps), I), dtype=np.float32)
    for k, pod in enumerate(reps):
        for im in pod.images:
            pod_has[k, img_ids[im]] = 1.0
    raw = pod_has @ node_mb.T  # integer-valued f32 MB sums, [U, N]
    sc = np.clip(raw, _IMG_MIN_MB, _IMG_MAX_MB).astype(np.float32)
    scored = ((sc - np.float32(_IMG_MIN_MB)) * np.float32(100.0)
              / np.float32(_IMG_MAX_MB - _IMG_MIN_MB)).astype(np.float32)
    scored = quantize_scores_np(scored)
    out = np.zeros((P, N), dtype=scored.dtype)  # zero == the empty-image score
    if len(inv):
        out[: len(inv)] = scored[inv]
    return out


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
    does (labels included)."""
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
    """A PERSISTENT two-level interner (the JAX package's api/snapshot.py:346):
    identity profile -> canonical spec key survives across calls, so waves
    stamped from the same objects cost O(P) table hits, not O(P) sorted
    canonicalizations.  Entries keep the keyed pod alive, so a recycled id
    never aliases a live entry.

    The identity-profile pass runs in C (native/interner.c, loaded by
    native/pyintern.py), as in the JAX package; its build failing raises.
    ``native=False`` runs the Python loop, the plain version the C path is
    held to; grouping is identical on either path.  Two latches hand a
    workload the C pass cannot serve to the Python loop for good: pods
    whose profile fields are not identity-stable (three batches in a row
    with forced misses), or a slow path that keeps failing between lookup
    and insert (three batches in a row leaving provisional entries).
    ``path`` says which path the interner is on ("c" or "python")."""

    def __init__(self, native: bool = True):
        self._keys: Dict[Tuple, Tuple] = {}
        self._lib = self._h = None
        if native:
            from ..native import pyintern

            self._lib = pyintern.load()
            self._h = self._lib.interner_new()
            if not self._h:
                raise MemoryError("interner_new failed")
            self._canon: Dict[Tuple, int] = {}  # spec key -> persistent kid
            self._key_by_kid: List[Tuple] = []
            self._thrash_prov = 0
            self._thrash_forced = 0

    @property
    def path(self) -> str:
        return "c" if self._h else "python"

    def _release(self) -> None:
        """Free the C table (its pins on pods) and leave the C path."""
        if self._h:
            self._lib.interner_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self._release()
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass

    def group(self, pods: Sequence):
        """-> (reps, inv, rep_keys): the same reps and inv as group_by_spec,
        plus each rep's canonical key."""
        if self._h:
            return self._group_native(pods)
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

    def _group_native(self, pods: Sequence):
        """The JAX package's _group_native (api/snapshot.py:408-505)."""
        lib, h = self._lib, self._h
        if not isinstance(pods, list):
            pods = list(pods)
        n = len(pods)
        if int(lib.interner_prov(h)) != 0:
            # a prior batch left unresolved provisional entries: its slow
            # path raised, or a pod's profile fields are not identity-stable.
            # interner_lookup wipes the table once; if it keeps happening the
            # C pass cannot help this workload.  Counted apart from the
            # forced latch below: provisional leftovers come with zero forced
            # misses, so a shared counter would be reset and never latch.
            self._thrash_prov += 1
            if self._thrash_prov >= 3:
                self._release()
                return self.group(pods)
        else:
            # only a streak latches: isolated events never disable the C pass
            self._thrash_prov = 0
        # the Python loop's bounded-memory policy: the profile table and the
        # spec-key registry clear together (C entries hold kid indices into
        # _key_by_kid); kids restart from 0
        if int(lib.interner_count(h)) > 2 * (n + 1024) or len(self._key_by_kid) > 2 * (n + 1024):
            lib.interner_clear(h)
            self._canon.clear()
            self._key_by_kid.clear()
        keyid = np.empty(n, dtype=np.int64)
        miss = np.empty(n, dtype=np.int64)
        # PyDLL raises the pending Python exception after a call that set one
        n_miss = int(lib.interner_lookup(h, pods, keyid.ctypes.data, miss.ctypes.data))
        latch_forced = False
        if int(lib.interner_forced(h)) != 0:
            # identity-unstable pods bypass the pointer table: they resolve
            # through the value slow path below with no dedup in the batch;
            # a streak of such batches latches onto the Python loop
            self._thrash_forced += 1
            latch_forced = self._thrash_forced >= 3
        else:
            # a clean batch resets the FORCED streak only: provisional
            # strikes come in batches with zero forced misses by nature
            self._thrash_forced = 0
        if n_miss:
            # miss holds only UNIQUE missing profiles (duplicates in the
            # batch resolved to provisional markers in C), so the sorted
            # canonicalization runs once per distinct spec
            canon = self._canon
            kids = np.empty(n_miss, dtype=np.int64)
            for k in range(n_miss):
                key = _pod_spec_key(pods[int(miss[k])])
                kid = canon.get(key)
                if kid is None:
                    kid = canon[key] = len(self._key_by_kid)
                    self._key_by_kid.append(key)
                kids[k] = kid
            lib.interner_insert(h, pods, miss.ctypes.data, kids.ctypes.data, n_miss)
            # resolve the provisional markers -(m)-2 -> kids[m]
            neg = keyid < -1
            keyid[neg] = kids[-keyid[neg] - 2]
        percall = np.full(len(self._key_by_kid), -1, dtype=np.int64)
        inv = np.empty(n, dtype=np.int64)
        rep_idx = np.empty(n, dtype=np.int64)
        n_reps = int(lib.interner_canonicalize(keyid.ctypes.data, n, percall.ctypes.data,
                                               inv.ctypes.data, rep_idx.ctypes.data))
        reps = [pods[int(j)] for j in rep_idx[:n_reps]]
        rep_keys = tuple(self._key_by_kid[int(keyid[int(j)])] for j in rep_idx[:n_reps])
        if latch_forced:
            self._release()
        return reps, inv, rep_keys


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
