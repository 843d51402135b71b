"""Incremental (delta) snapshot encoding — the port of the JAX package's
``api/delta.py`` for the fit-only stage set.

The CLUSTER SIDE (node profiles, the label and taint vocabularies, raw
int64 resource usage, one record per bound pod) stays resident in a
``ClusterSide`` across scheduling cycles: newly bound and deleted pods are
absorbed as batched scatter updates, never a rebuild.  The POD SIDE (every
array keyed by the pending wave) is built per unique pod spec and scattered
through the wave's inverse index, and reused whole while the wave's specs
are unchanged.  The int32 rescale is re-derived from the raw values every
cycle, so a delta encode is bit-identical to a fresh one; whenever a delta
cannot keep that (a new referenced label key or resource kind, a node set
change, a bound pod with a resource the cache lacks) the cluster side is
rebuilt, which IS the one-shot path: ``api/snapshot.py encode_snapshot`` is
a ``DeltaEncoder`` used once.

Arrays handed out are never written in place: an array that changes is a
new object, one that does not is the SAME object, cycle after cycle
(``_cached``).  ``DeltaEncoder.to_device`` keys its resident tensors on that
identity (and on equal values), so an unchanged field comes back as the same
tensor and ``ops/incremental.py — HoistCache`` sees its static side
unchanged.  On the card every host-to-device copy goes into a newly
allocated tensor, from pinned staging, on a copy stream; the compute stream
waits on the copy's event, and a staging buffer is reused only once its
copy's event has completed.  So a step still running on device never sees
its inputs change, and encoding the next wave needs no host
synchronisation.  A bool field of two or more axes with a last axis of 64
or more travels packed (``_packed_put``) and kernel K9 ``unpack_planes``
unpacks it on the card.

The cluster side also keeps the pairwise state of the bound pods (the term
vocabulary, per-(term, domain) counts of matching pods, of anti-affinity and
preferred-term owners) and host-port occupancy as counts, so a bind or a
delete is a reversible scatter; a bound pod that brings a term or a port
the vocabulary lacks falls back to a rebuild, as in the JAX package.

Pod groups (gangs) become ``pod_group`` / ``group_min`` as in the JAX
package (api/delta.py:1333-1348), and the groups' (name, minMember) pairs
enter the pod side's cache key.

The sidecar's session path (``encode_pregrouped``, the JAX package's
api/delta.py:1033) encodes a wave that arrives interned -- spec reps, each
pod's spec index and the uids -- without one pod object per pending pod;
a bound copy the server clones from the rep is absorbed through the rep.

On a node mesh (``DeltaEncoder(mesh=)`` / ``set_mesh``, parallel/mesh.py;
the JAX package's api/delta.py:884-1000) every node-axis field is resident
PER SHARD, each shard's rows its own tensor on the shard's device, and every
other field once per device.  A node count the mesh does not divide is
padded host-side with permanently invalid nodes (``_pad_for_mesh``, the
rules of parallel/mesh.py -- pad_field), memoized by the host array's
identity, so the resident-reuse check still hits; a warm delta re-places
only the shards whose rows changed.  The arrays come back as a
``ShardedArrays``.  Changing the mesh drops the resident tensors.  On a
pods x nodes grid (parallel/mesh.py -- GridMesh; the JAX package's
api/delta.py:900-921, :960-962) the pod axis is padded too (invalid pods)
and every pod-axis field is resident per pod row on that row's devices,
beside the node columns: the arrays come back as a ``GridArrays``.  Across
ranks (a mesh of init_distributed) each rank places only its own blocks.

Volumes and resource claims (the JAX package's api/delta.py:266-295,
:715-730, :1015-1030): ``encode`` fingerprints the RAW snapshot -- the node
objects and the identity of every PV, PVC, StorageClass, ResourceSlice and
DeviceClass (``raw_fingerprints``) -- then resolves it (api/volumes.py) and
encodes the result.  Resolution builds new node objects every cycle, so the
cluster side is conditioned on the raw fingerprints: it stays on the delta
path while the storage state is stable and rebuilds when any of it is
replaced.  A bound pod with claims re-absorbs on the slow path (its
resolved spec is recomputed, never taken from its wave's rep).  The
sidecar's wire arrives resolved, so ``encode_pregrouped`` does not resolve.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import types as t
from . import vocab as v
from .pairwise import HARD, SOFT, PairwiseVocab, TermKey, _match_matrix, _term_of_affinity, _term_of_spread
from .volumes import resolve_snapshot
from .snapshot import (
    _DEFAULT_POD_LIMIT,
    ClusterArrays,
    EncodingMeta,
    SpecInterner,
    _bucket,
    _image_score_matrix,
    _node_taints,
    _pod_spec_key,
    _resource_axis,
    _round_up_pow2,
    _scale_for,
    activeq_order,
    pod_effective_requests,
)


# --------------------------------------------------------------------------
# wave fingerprint: what the cluster-side cache is conditioned on
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class WaveFingerprint:
    """Wave-derived inputs the cluster side depends on: two waves with
    equal fingerprints share one cluster-side cache."""

    referenced_keys: frozenset
    resources: Tuple[str, ...]
    term_seq: Tuple[TermKey, ...]  # pairwise terms in first-intern order
    port_seq: Tuple[Tuple[str, int], ...]


def _pod_pairwise_terms(pod):
    """(aff, anti, pref[(term, signed w)], spread[(term, maxSkew, mode)]) as
    TermKey tuples, in the canonical intern order."""
    aff: List[TermKey] = []
    anti: List[TermKey] = []
    pref: List[Tuple[TermKey, float]] = []
    spread: List[Tuple[TermKey, int, int]] = []
    if pod.affinity:
        for term in pod.affinity.required_pod_affinity:
            aff.append(_term_of_affinity(term, pod.namespace))
        for term in pod.affinity.required_pod_anti_affinity:
            anti.append(_term_of_affinity(term, pod.namespace))
        for wt in pod.affinity.preferred_pod_affinity:
            pref.append((_term_of_affinity(wt.term, pod.namespace), float(wt.weight)))
        for wt in pod.affinity.preferred_pod_anti_affinity:
            pref.append((_term_of_affinity(wt.term, pod.namespace), -float(wt.weight)))
    for c in pod.topology_spread:
        spread.append((_term_of_spread(c, pod.namespace), c.max_skew,
                       HARD if c.when_unsatisfiable == t.DO_NOT_SCHEDULE else SOFT))
    return aff, anti, pref, spread


def wave_fingerprint(reps: Sequence[t.Pod], resources: Sequence[str]) -> WaveFingerprint:
    referenced: set = set()
    term_seq: List[TermKey] = []
    seen_terms: set = set()
    port_seq: List[Tuple[str, int]] = []
    seen_ports: set = set()
    for pod in reps:
        for k, _ in pod.node_selector:
            referenced.add(k)
        if pod.affinity:
            for term in pod.affinity.required_node_terms:
                for e in term.match_expressions:
                    referenced.add(e.key)
            for pt in pod.affinity.preferred_node_terms:
                for e in pt.preference.match_expressions:
                    referenced.add(e.key)
        aff, anti, pref, spread = _pod_pairwise_terms(pod)
        for tk in [*aff, *anti, *(tk for tk, _ in pref), *(tk for tk, _, _ in spread)]:
            if tk not in seen_terms:
                seen_terms.add(tk)
                term_seq.append(tk)
        for pp in pod.host_ports:
            if pp not in seen_ports:
                seen_ports.add(pp)
                port_seq.append(pp)
    return WaveFingerprint(referenced_keys=frozenset(referenced), resources=tuple(resources),
                           term_seq=tuple(term_seq), port_seq=tuple(port_seq))


# --------------------------------------------------------------------------
# cluster side: resident, delta-updated state
# --------------------------------------------------------------------------


@dataclass
class _WaveView:
    """Snapshot-shaped view for the pregrouped (sidecar) encode: the wire
    carries no PV, PVC, class or slice (constraints arrive resolved by the
    client, runtime/client.py), so the storage fields stay empty."""

    nodes: list
    pending_pods: tuple
    bound_pods: list
    pod_groups: dict
    pvs: tuple = ()
    pvcs: dict = field(default_factory=dict)
    storage_classes: dict = field(default_factory=dict)
    resource_slices: tuple = ()
    device_classes: dict = field(default_factory=dict)


class _Fallback(Exception):
    """A delta cannot be absorbed bit-exactly — rebuild the cluster side."""


# One bound pod's contribution, for O(1) reversal on delete: (node row,
# request row, bound-spec row, host-port ids, anti-affinity term ids,
# preferred (term id, signed weight) pairs, the pod OBJECT).  Holding the
# object keeps it alive, so `rec[_OBJ] is q` is a sound unchanged-check.
_BoundRec = tuple
_NI, _REQ_U, _SPEC_U, _PORT_IDS, _ANTI_IDS, _PREF, _OBJ = range(7)

_EMPTY_DIRTY = np.empty(0, dtype=np.int64)

# the pod fields the bound-side absorb reads
BOUND_SPEC_FIELDS = ("labels", "namespace", "requests", "host_ports", "affinity")


def bound_spec_fields_match(a, b) -> bool:
    """Identity-first equality over BOUND_SPEC_FIELDS (copies made with
    replace share field objects, so the common case is five `is` checks)."""
    for f in BOUND_SPEC_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x is not y and x != y:
            return False
    return True


@dataclass
class ClusterSide:
    """Everything derivable from (nodes, bound pods, wave fingerprint); the
    node-axis arrays are UNPADDED ([n] rows): padding happens at assembly."""

    wfp: WaveFingerprint
    hpaw: float  # hardPodAffinityWeight: bound pods' required-affinity terms score at it
    nodes: List[t.Node]
    nodes_fp: Tuple
    node_index: Dict[str, int]
    lab: v.LabelVocab
    node_labels: np.ndarray  # bool[n, L]
    taints: v.Interner
    taint_objs: List[t.Taint]
    node_taint_ns: np.ndarray  # bool[n, T] hard taints
    node_taint_pref: np.ndarray  # bool[n, T] PreferNoSchedule taints
    alloc_raw: np.ndarray  # i64[n, R]
    alloc_uniq: np.ndarray  # the distinct allocatable rows (the rescale reads them)
    used_raw: np.ndarray  # i64[n, R]
    breq_uniq_ids: Dict[Tuple, int]
    breq_uniq: List[List[int]]  # raw effective-request rows of bound pods
    # pairwise: the vocabulary (wave terms first, then bound pods'), the
    # node -> domain map and the bound pods' per-(term, domain) counts
    voc: PairwiseVocab
    terms_list: List[TermKey]
    node_dom: np.ndarray  # i32[K, n]
    term_key: np.ndarray  # i32[T2]
    term_counts0: np.ndarray  # f32[T2, D+1]
    anti_counts0: np.ndarray
    pref_own0: np.ndarray
    # bound specs (labels, namespace, affinity): match column and own terms
    bspec_ids: Dict[Tuple, int]
    m_cols: List[np.ndarray]  # each f32[T2]
    bspec_anti: List[Tuple[int, ...]]
    bspec_pref: List[Tuple[Tuple[int, float], ...]]
    # host ports, as counts (an OR is not reversible, counts are)
    node_port_count: np.ndarray  # i32[n, PT]
    records: Dict[str, _BoundRec] = field(default_factory=dict)
    stats: Dict[str, int] = field(default_factory=lambda: {"rebuilds": 0, "deltas": 0})
    # padded-array cache for _assemble: name -> (key, array)
    pad_cache: Dict[str, Tuple] = field(default_factory=dict)
    # bumped whenever a sync changes used_raw, the counts or the ports;
    # versioned cache entries copy once per version, so handed-out arrays
    # are immutable
    mut_version: int = 0
    # fast bind-absorb: uid -> (wave id << 32 | position) into wave_store
    # [wave id -> [sorted pods, reps, inv list, pods not yet bound]]
    wave_ix: Dict[str, int] = field(default_factory=dict)
    wave_store: Dict[int, list] = field(default_factory=dict)
    wave_next: int = 0
    # bound-side info per wave rep: id(rep) -> (rep, (req row, spec row, port ids))
    rep_bound_info: Dict[int, Tuple] = field(default_factory=dict)
    # the PRE-resolution conditioning (raw_fingerprints): the raw node set's
    # identity and the storage state's; raw_refs pins every object they id()
    raw_nodes_fp: Tuple = ()
    storage_fp: Tuple = ()
    raw_refs: Tuple = ()
    # node rows whose bound-pod contributions changed in the last sync_bound
    # (None after a rebuild: everything)
    last_dirty_nodes: Optional[np.ndarray] = None


def _nodes_fp(nodes: Sequence[t.Node]) -> Tuple:
    return tuple((nd.name, id(nd)) for nd in nodes)


def raw_fingerprints(snap) -> Tuple:
    """(nodes fingerprint, storage fingerprint): the PRE-resolution cache
    conditioning, shared by the encoder and the sidecar's client
    (runtime/client.py) so the two cannot drift."""
    return (_nodes_fp(snap.nodes), _storage_fp(snap))


def raw_keepalive_refs(snap) -> Tuple:
    """Containers pinning every object the fingerprints id(): built only on
    a rebuild (copying a 20k-node list every cycle is measurable)."""
    return (list(snap.nodes), list(snap.pvs), dict(snap.pvcs), dict(snap.storage_classes),
            list(snap.resource_slices), dict(snap.device_classes))


def _storage_fp(snap) -> Tuple:
    """Identity fingerprint of every input of volumes.resolve_snapshot
    besides nodes and pods: PVs, PVCs, StorageClasses, ResourceSlices,
    DeviceClasses.  Objects are copy-on-write, so a state change replaces
    the object."""
    return (
        tuple(id(pv) for pv in snap.pvs),
        tuple((k, id(v)) for k, v in snap.pvcs.items()),
        tuple(sorted((k, id(v)) for k, v in snap.storage_classes.items())),
        tuple(id(sl) for sl in snap.resource_slices),
        tuple(sorted((k, id(v)) for k, v in snap.device_classes.items())),
    )


def _bound_spec_key(q) -> Tuple:
    return (tuple(sorted(q.labels.items())), q.namespace, q.affinity)


def _bound_term_ids(voc: PairwiseVocab, pod, hpaw: float, intern: bool):
    """Anti-affinity term ids and signed preferred (id, w) of a BOUND pod;
    its REQUIRED affinity terms score toward incoming pods at
    hardPodAffinityWeight (interpodaffinity/scoring.go — processExistingPod).
    Raises _Fallback on a term the vocabulary lacks when not interning."""
    get = voc.terms.intern if intern else voc.terms.get
    anti: List[int] = []
    pref: List[Tuple[int, float]] = []
    if pod.affinity:
        for term in pod.affinity.required_pod_anti_affinity:
            ti = get(_term_of_affinity(term, pod.namespace))
            if ti is None:
                raise _Fallback("new anti term from bound pod")
            anti.append(ti)
        for wt in pod.affinity.preferred_pod_affinity:
            ti = get(_term_of_affinity(wt.term, pod.namespace))
            if ti is None:
                raise _Fallback("new pref term from bound pod")
            pref.append((ti, float(wt.weight)))
        for wt in pod.affinity.preferred_pod_anti_affinity:
            ti = get(_term_of_affinity(wt.term, pod.namespace))
            if ti is None:
                raise _Fallback("new pref-anti term from bound pod")
            pref.append((ti, -float(wt.weight)))
        if hpaw:
            for term in pod.affinity.required_pod_affinity:
                ti = get(_term_of_affinity(term, pod.namespace))
                if ti is None:
                    raise _Fallback("new req-aff term from bound pod")
                pref.append((ti, float(hpaw)))
    return tuple(anti), tuple(pref)


def build_cluster_side(nodes: Sequence[t.Node], bound: Sequence[t.Pod], wfp: WaveFingerprint,
                       hpaw: float) -> ClusterSide:
    n = len(nodes)
    resources = list(wfp.resources)
    R = len(resources)
    node_index = {nd.name: i for i, nd in enumerate(nodes)}

    # --- label vocab over node labels, interned by filtered profile ---
    lab = v.LabelVocab()
    nlab_ids: Dict[Tuple, int] = {}
    nlab_rows: List[List[int]] = []
    nlab_inv = np.empty(n, dtype=np.int64)
    for i, nd in enumerate(nodes):
        fk = tuple(sorted((k, val) for k, val in nd.labels.items() if k in wfp.referenced_keys))
        u = nlab_ids.get(fk)
        if u is None:
            u = nlab_ids[fk] = len(nlab_rows)
            nlab_rows.append(lab.add_labels(dict(fk)))
        nlab_inv[i] = u
    L = max(1, len(lab))
    node_labels = np.zeros((n, L), dtype=bool)
    if n:
        uniq = np.zeros((len(nlab_rows), L), dtype=bool)
        for u, lits in enumerate(nlab_rows):
            uniq[u, lits] = True
        node_labels[:] = uniq[nlab_inv]

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
    node_taint_ns = np.zeros((n, T), dtype=bool)
    node_taint_pref = np.zeros((n, T), dtype=bool)
    if n:
        uns = np.zeros((len(tprof), T), dtype=bool)
        upref = np.zeros((len(tprof), T), dtype=bool)
        for u, ts in enumerate(tprof):
            for tn in ts:
                tid = taints.get((tn.key, tn.value, tn.effect))
                if tn.effect == t.PREFER_NO_SCHEDULE:
                    upref[u, tid] = True
                else:
                    uns[u, tid] = True
        node_taint_ns[:] = uns[tinv]
        node_taint_pref[:] = upref[tinv]

    # --- allocatable (raw), interned by profile ---
    aprof_ids: Dict[Tuple, int] = {}
    arows: List[List[int]] = []
    ainv = np.empty(n, dtype=np.int64)
    for i, nd in enumerate(nodes):
        key = tuple(sorted(nd.allocatable.items()))
        u = aprof_ids.get(key)
        if u is None:
            u = aprof_ids[key] = len(arows)
            arows.append([nd.allocatable.get(r, _DEFAULT_POD_LIMIT if r == t.PODS else 0) for r in resources])
        ainv[i] = u
    alloc_uniq = np.array(arows, dtype=np.int64) if arows else np.zeros((1, R), dtype=np.int64)
    alloc_raw = alloc_uniq[ainv] if n else np.zeros((0, R), dtype=np.int64)

    # --- pairwise vocab: the WAVE's terms and ports first, then bound pods' ---
    voc = PairwiseVocab(v.Interner(), v.Interner(), v.Interner(), v.Interner())
    for tk in wfp.term_seq:
        voc.terms.intern(tk)
    for pp in wfp.port_seq:
        voc.ports.intern(pp)

    # --- bound pods: one record each, requests and specs interned ---
    used_raw = np.zeros((n, R), dtype=np.int64)
    breq_uniq_ids: Dict[Tuple, int] = {}
    breq_uniq: List[List[int]] = []
    bspec_ids: Dict[Tuple, int] = {}
    bspec_reps: List[t.Pod] = []
    bspec_anti: List[Tuple[int, ...]] = []
    bspec_pref: List[Tuple[Tuple[int, float], ...]] = []
    records: Dict[str, _BoundRec] = {}
    rec_ni: List[int] = []
    rec_req: List[int] = []
    rec_spec: List[int] = []
    for q in bound:
        ni = node_index.get(q.node_name)
        if ni is None:
            continue
        rkey = tuple(sorted(q.requests.items()))
        ru = breq_uniq_ids.get(rkey)
        if ru is None:
            ru = breq_uniq_ids[rkey] = len(breq_uniq)
            breq_uniq.append(pod_effective_requests(q, resources))
        skey = _bound_spec_key(q)
        su = bspec_ids.get(skey)
        if su is None:
            su = bspec_ids[skey] = len(bspec_reps)
            bspec_reps.append(q)
            anti, pref = _bound_term_ids(voc, q, hpaw, intern=True)
            bspec_anti.append(anti)
            bspec_pref.append(pref)
        for proto, port in q.host_ports:
            voc.ports.intern((proto, port))
        if q.uid in records:
            raise ValueError(f"duplicate bound pod uid {q.uid!r} in snapshot")
        records[q.uid] = (ni, ru, su, tuple(voc.ports.get(pp) for pp in q.host_ports),
                          bspec_anti[su], bspec_pref[su], q)
        rec_ni.append(ni)
        rec_req.append(ru)
        rec_spec.append(su)

    # --- topology keys and domains over the node set ---
    for tk in [tm.topology_key for tm in voc.terms.items]:
        voc.topo_keys.intern(tk)
    K = max(1, len(voc.topo_keys))
    for nd in nodes:
        for tk in voc.topo_keys.items:
            if tk in nd.labels:
                voc.domains.intern((tk, nd.labels[tk]))
    D = len(voc.domains)
    node_dom = np.full((K, max(1, n)), D, dtype=np.int32)
    for i, nd in enumerate(nodes):
        for k, tk in enumerate(voc.topo_keys.items):
            if tk in nd.labels:
                node_dom[k, i] = voc.domains.get((tk, nd.labels[tk]))
    T2 = max(1, len(voc.terms))
    term_key = np.zeros(T2, dtype=np.int32)
    for ti, term in enumerate(voc.terms.items):
        term_key[ti] = voc.topo_keys.get(term.topology_key)

    terms_list = list(voc.terms.items)
    m_cols: List[np.ndarray] = []
    if bspec_reps and terms_list:
        m_u = _match_matrix(terms_list, bspec_reps)  # [T2, Ub]
        m_cols = [np.ascontiguousarray(m_u[:, j]) for j in range(m_u.shape[1])]
    elif bspec_reps:
        m_cols = [np.zeros(T2, dtype=np.float32) for _ in bspec_reps]

    cs = ClusterSide(
        wfp=wfp, hpaw=hpaw, nodes=list(nodes), nodes_fp=_nodes_fp(nodes), node_index=node_index,
        lab=lab, node_labels=node_labels, taints=taints, taint_objs=taint_objs,
        node_taint_ns=node_taint_ns, node_taint_pref=node_taint_pref,
        alloc_raw=alloc_raw, alloc_uniq=np.unique(alloc_raw, axis=0) if n else np.zeros((1, R), np.int64),
        used_raw=used_raw, breq_uniq_ids=breq_uniq_ids, breq_uniq=breq_uniq,
        voc=voc, terms_list=terms_list, node_dom=node_dom, term_key=term_key,
        term_counts0=np.zeros((T2, D + 1), dtype=np.float32),
        anti_counts0=np.zeros((T2, D + 1), dtype=np.float32),
        pref_own0=np.zeros((T2, D + 1), dtype=np.float32),
        bspec_ids=bspec_ids, m_cols=m_cols, bspec_anti=bspec_anti, bspec_pref=bspec_pref,
        node_port_count=np.zeros((max(1, n), max(1, len(voc.ports))), dtype=np.int32),
        records=records,
    )
    _apply_bound_batch(cs, np.array(rec_ni, dtype=np.int64), np.array(rec_req, dtype=np.int64),
                       np.array(rec_spec, dtype=np.int64), list(records.values()), sign=1)
    return cs


def _apply_bound_batch(cs: ClusterSide, ni: np.ndarray, req_u: np.ndarray, spec_u: np.ndarray,
                       recs: List[_BoundRec], sign: int) -> None:
    """Scatter-add (sign=+1) or -subtract (sign=-1) a batch of bound-pod
    contributions.  Every sum is integer-valued (weights are exact in f32
    below 2^24), so the order cannot change the result."""
    if len(ni) == 0:
        return
    np.add.at(cs.used_raw, ni, np.int64(sign) * np.array(cs.breq_uniq, dtype=np.int64)[req_u])
    if cs.terms_list:
        uniq, uinv = np.unique(spec_u, return_inverse=True)
        m_u = np.stack([cs.m_cols[int(u)] for u in uniq], axis=1)  # [T2, Uq]
        m = m_u[:, uinv]  # [T2, B]
        dom_cols = cs.node_dom[cs.term_key][:, ni]  # [T2, B]
        fs = np.float32(sign)
        for ti in np.flatnonzero(m_u.any(axis=1)):
            np.add.at(cs.term_counts0[ti], dom_cols[ti], fs * m[ti])
    for rec in recs:
        ni_r = rec[_NI]
        for ti in rec[_ANTI_IDS]:
            cs.anti_counts0[ti, cs.node_dom[cs.term_key[ti], ni_r]] += np.float32(sign)
        for ti, w in rec[_PREF]:
            cs.pref_own0[ti, cs.node_dom[cs.term_key[ti], ni_r]] += np.float32(sign) * np.float32(w)
        for pid in rec[_PORT_IDS]:
            cs.node_port_count[ni_r, pid] += sign


def sync_bound(cs: ClusterSide, bound: Sequence[t.Pod]) -> None:
    """Absorb the bound-pod diff (binds + deletes since the last cycle) into
    the resident cluster side.  Raises _Fallback, before anything moves,
    when a new bound pod needs a vocabulary entry the cache lacks (a term, a
    host port, a resource kind)."""
    cur: Dict[str, t.Pod] = {}
    for q in bound:
        if q.node_name in cs.node_index:
            cur[q.uid] = q
    gone: List[str] = []
    new: List[t.Pod] = []
    for uid, rec in cs.records.items():
        q = cur.get(uid)
        if q is None:
            gone.append(uid)
        elif rec[_OBJ] is not q:
            # the pod OBJECT was replaced: remove the old contribution,
            # re-add the new one
            gone.append(uid)
            new.append(q)
    for uid, q in cur.items():
        if uid not in cs.records:
            new.append(q)
    if not gone and not new:
        cs.last_dirty_nodes = _EMPTY_DIRTY
        return
    resources = list(cs.wfp.resources)
    res_set = set(resources)
    fresh_specs: List[t.Pod] = []

    def _spec_info(q) -> Tuple[int, int, Tuple[int, ...]]:
        """(request row, spec row, port ids): the sorting part, once per
        unique spec."""
        if any(k not in res_set for k in q.requests):
            raise _Fallback("new resource kind from bound pod")
        rkey = tuple(sorted(q.requests.items()))
        ru = cs.breq_uniq_ids.get(rkey)
        if ru is None:
            ru = cs.breq_uniq_ids[rkey] = len(cs.breq_uniq)
            cs.breq_uniq.append(pod_effective_requests(q, resources))
        skey = _bound_spec_key(q)
        su = cs.bspec_ids.get(skey)
        if su is None:
            anti, pref = _bound_term_ids(cs.voc, q, cs.hpaw, intern=False)
            su = cs.bspec_ids[skey] = len(cs.bspec_ids)
            cs.bspec_anti.append(anti)
            cs.bspec_pref.append(pref)
            fresh_specs.append(q)
        port_ids = []
        for pp in q.host_ports:
            pid = cs.voc.ports.get(pp)
            if pid is None:
                raise _Fallback("new host port from bound pod")
            port_ids.append(pid)
        return ru, su, tuple(port_ids)

    add_recs: List[_BoundRec] = []
    # a 50k-pod wave's absorb runs this loop 50k times per cycle: locals for
    # the hot attributes
    wave_pop = cs.wave_ix.pop
    wave_store = cs.wave_store
    rb = cs.rep_bound_info
    node_index = cs.node_index
    anti_l, pref_l = cs.bspec_anti, cs.bspec_pref
    append = add_recs.append
    for q in new:
        packed = wave_pop(q.uid, None)
        ent_wave = None
        if packed is not None:
            wid = packed >> 32
            went = wave_store.get(wid)
            if went is not None:
                i = packed & 0xFFFFFFFF
                rep_i = went[1][went[2][i]]
                # a pregrouped wave stores no pod objects: its rep is the
                # wave-time object (the server clones bound copies from it)
                ent_wave = (went[0][i] if went[0] is not None else rep_i, rep_i)
                went[3] -= 1  # drained waves release their pod lists
                if went[3] <= 0:
                    del wave_store[wid]
        if (
            ent_wave is not None
            # a pod with claims takes the slow path: its RESOLVED spec can
            # change between pending and bound as the PVC / PV state moves
            and not q.pvcs
            and not q.resource_claims
            # the wave-time spec stands in for the bound copy only while
            # every field the absorb reads is still equal
            and bound_spec_fields_match(q, ent_wave[0])
        ):
            rep = ent_wave[1]
            ent = rb.get(id(rep))
            if ent is None or ent[0] is not rep:
                ent = (rep, _spec_info(rep))
                rb[id(rep)] = ent
            ru, su, port_ids = ent[1]
        else:
            ru, su, port_ids = _spec_info(q)
        append((node_index[q.node_name], ru, su, port_ids, anti_l[su], pref_l[su], q))
    if fresh_specs:
        if cs.terms_list:
            m_new = _match_matrix(cs.terms_list, fresh_specs)
            cs.m_cols.extend(np.ascontiguousarray(m_new[:, j]) for j in range(len(fresh_specs)))
        else:
            cs.m_cols.extend(np.zeros(max(1, len(cs.terms_list)), dtype=np.float32) for _ in fresh_specs)
    # every vocabulary check passed: only now does the resident state move
    cs.stats["deltas"] += 1
    cs.mut_version += 1
    dirty_ni: List[int] = []
    if gone:
        recs = [cs.records.pop(uid) for uid in gone]
        dirty_ni.extend(r[_NI] for r in recs)
        _apply_bound_batch(cs, np.array([r[_NI] for r in recs], dtype=np.int64),
                           np.array([r[_REQ_U] for r in recs], dtype=np.int64),
                           np.array([r[_SPEC_U] for r in recs], dtype=np.int64), recs, sign=-1)
    if add_recs:
        for rec in add_recs:
            cs.records[rec[_OBJ].uid] = rec
        dirty_ni.extend(r[_NI] for r in add_recs)
        _apply_bound_batch(cs, np.array([r[_NI] for r in add_recs], dtype=np.int64),
                           np.array([r[_REQ_U] for r in add_recs], dtype=np.int64),
                           np.array([r[_SPEC_U] for r in add_recs], dtype=np.int64), add_recs, sign=1)
    cs.last_dirty_nodes = np.unique(np.array(dirty_ni, dtype=np.int64))


def _wave_compatible(cs: ClusterSide, wfp: WaveFingerprint) -> bool:
    """A cached cluster side serves a new wave EXACTLY (equal fingerprint)
    or as a SUPERSET (every label key, resource kind, term and port the wave
    needs already there; surplus entries are inert, so the decisions are
    the same)."""
    if cs.wfp == wfp:
        return True
    return (
        wfp.referenced_keys <= cs.wfp.referenced_keys
        and set(wfp.resources) <= set(cs.wfp.resources)
        and all(tk in cs.voc.terms for tk in wfp.term_seq)
        and all(pp in cs.voc.ports for pp in wfp.port_seq)
    )


# --------------------------------------------------------------------------
# host -> device
# --------------------------------------------------------------------------

# host arrays of two or more axes wider than this travel packed
PACK_MIN_WIDTH = 64


def _packable(a: np.ndarray) -> bool:
    """The JAX package's rule (its delta.py:974-980): a bool ndarray with
    two or more axes and a last axis of at least 64."""
    return isinstance(a, np.ndarray) and a.dtype == np.bool_ and a.ndim >= 2 and a.shape[-1] >= PACK_MIN_WIDTH


class _Staging:
    """Pinned host staging buffers for the card's copies.  A buffer is
    handed out again only once the event recorded after its last copy has
    completed (query(), never a wait)."""

    def __init__(self):
        self._bufs: List[list] = []  # [pinned uint8 tensor, event or None]

    def take(self, nbytes: int):
        for ent in self._bufs:
            if ent[0].numel() >= nbytes and (ent[1] is None or ent[1].query()):
                ent[1] = None
                return ent
        cap = max(4096, 1 << max(0, int(nbytes - 1).bit_length()))
        ent = [torch.empty(cap, dtype=torch.uint8, pin_memory=True), None]
        self._bufs.append(ent)
        return ent


# host dtype -> tensor dtype; packed words (uint32) travel as int32 bit
# patterns (ops/bitplane.py)
_TORCH_OF = {np.dtype(np.bool_): torch.bool, np.dtype(np.int32): torch.int32, np.dtype(np.uint32): torch.int32,
             np.dtype(np.float32): torch.float32}
# bf16 planes (image_score) travel as their uint16 bit patterns; under
# KTPU_SCORE_DTYPE=f32 the plane is f32 and travels as _TORCH_OF says
_BITS_OF = {np.dtype(np.uint16): (np.int16, torch.bfloat16)}


# --------------------------------------------------------------------------
# the encoder
# --------------------------------------------------------------------------


class DeltaEncoder:
    """Watch-cache-shaped encoder: ``encode(snap)`` each scheduling cycle.

    Cycle cost is O(wave) + O(bound-pod diff); the cluster side rebuilds only
    on node-set changes, wave-fingerprint changes or vocabulary growth.
    ``encode`` gives host arrays (numpy), ``to_device`` places them on
    `device` (the card unless the caller passes device="cpu"),
    ``encode_device`` does both.  ``stats`` counts full and delta cycles."""

    def __init__(self, device=None, *, hard_pod_affinity_weight: float = 1.0, debug_verify: bool = False,
                 mesh=None):
        self.device = resolve_device(device)
        # bound pods' required-affinity terms score toward incoming pods at
        # this weight (the JAX DeltaEncoder's hard_pod_affinity_weight)
        self.hpaw = hard_pod_affinity_weight
        self._cs: Optional[ClusterSide] = None
        # field (on a mesh: (field, shard) or (field, device)) -> (host array,
        # the block of it placed, device tensor)
        self._dev: Dict[object, Tuple] = {}
        self.stats = {"full": 0, "delta": 0, "verified": 0}
        # Cache validity rests on OBJECT IDENTITY (node fingerprint, record
        # `is` checks) under copy-on-write Node/Pod objects; debug_verify
        # cross-checks every delta cycle against a fresh rebuild to catch an
        # in-place mutation.
        self.debug_verify = debug_verify
        self._interner = SpecInterner()
        self._rep_key_memo: Dict[int, Tuple] = {}  # id(rep) -> (spec key, rep): encode_pregrouped
        self._copy_streams: Dict[torch.device, object] = {}  # card -> its copy stream
        self._staging = _Staging()
        self._mesh = None
        self._pad_memo: Dict[str, Tuple] = {}  # field -> (host array, padded array)
        self.set_mesh(mesh)

    # -- host side --
    def encode(self, snap):
        """-> (ClusterArrays of host numpy arrays, EncodingMeta).  The raw
        snapshot is fingerprinted, then resolved (api/volumes.py), then
        encoded."""
        fps = raw_fingerprints(snap)
        raw_snap = snap
        snap = resolve_snapshot(snap)
        pending = snap.pending_pods
        perm = activeq_order(pending)
        sorted_pending = [pending[i] for i in perm]
        reps, inv, rep_keys = self._interner.group(sorted_pending)
        return self._encode_core(snap, fps, raw_snap, reps, inv, perm, rep_keys, _resource_axis(snap),
                                 [p.uid for p in sorted_pending], sorted_pending)

    def encode_pregrouped(self, nodes, bound_pods, pod_groups, uids, reps, inv):
        """The sidecar's session path (the JAX package's api/delta.py:1033):
        the wave arrives interned -- spec `reps`, each pod's spec index `inv`
        and the `uids` (runtime/convert.py wave_parts_from_proto) -- and is
        encoded without one pod object per pending pod; verdicts come back
        by uid (meta.pod_names).  `reps` should be the same objects wave
        after wave (the session's rep cache), so the rep-key memo and the
        pod-side cache hit.  -> (ClusterArrays of host arrays, EncodingMeta)."""
        inv = np.asarray(inv, dtype=np.int64)
        # activeQ order from the reps' priorities (activeq_order reads the
        # same field of every pod)
        prio = (np.array([r.priority for r in reps], dtype=np.int64)[inv] if len(reps)
                else np.zeros(len(uids), dtype=np.int64))
        perm = np.argsort(-prio, kind="stable")
        inv_sorted = inv[perm]
        uids_sorted = [uids[i] for i in perm]
        rep_keys = tuple(self._rep_key(r) for r in reps)
        shim = _WaveView(nodes=nodes, pending_pods=(), bound_pods=bound_pods, pod_groups=pod_groups)
        # the resource axis by the one first-seen rule, the reps standing in
        # for the pending pods
        resources = _resource_axis(_WaveView(nodes=nodes, pending_pods=tuple(reps), bound_pods=bound_pods,
                                             pod_groups=pod_groups))
        return self._encode_core(shim, raw_fingerprints(shim), shim, reps, inv_sorted, perm, rep_keys, resources,
                                 uids_sorted, None)

    def encode_device_pregrouped(self, nodes, bound_pods, pod_groups, uids, reps, inv):
        """encode_pregrouped() with the arrays placed on the encoder's
        device, reusing resident tensors as encode_device() does."""
        return self._to_device(*self.encode_pregrouped(nodes, bound_pods, pod_groups, uids, reps, inv))

    def _rep_key(self, rep):
        """The canonical spec key of a rep, memoized by object identity (the
        entry holds the rep, so a recycled id never aliases a live one)."""
        ent = self._rep_key_memo.get(id(rep))
        if ent is not None and ent[1] is rep:
            return ent[0]
        if len(self._rep_key_memo) > 65536:
            self._rep_key_memo.clear()
        key = _pod_spec_key(rep)
        self._rep_key_memo[id(rep)] = (key, rep)
        return key

    def _encode_core(self, snap, fps, raw_snap, reps, inv, perm, rep_keys, resources, wave_uids, wave_pods):
        """Cluster-side reuse or rebuild, bound-pod sync, the wave's
        bind-absorb bookkeeping, assembly.  `snap` is the resolved snapshot,
        `fps` the raw one's fingerprints and `raw_snap` the raw snapshot
        (a rebuild pins its objects).  `wave_pods` is None on the pregrouped
        path: the bind-absorb then checks a bound copy against its rep, and
        the meta's pod names are the uids."""
        raw_nodes_fp, storage_fp = fps
        wfp = wave_fingerprint(reps, resources)
        cs = self._cs
        if (cs is not None and cs.hpaw == self.hpaw and cs.raw_nodes_fp == raw_nodes_fp
                and cs.storage_fp == storage_fp and _wave_compatible(cs, wfp)):
            try:
                sync_bound(cs, snap.bound_pods)
                self.stats["delta"] += 1
                if self.debug_verify:
                    self._verify_against_rebuild(cs, snap)
                    self.stats["verified"] += 1
            except _Fallback:
                cs = None
        else:
            cs = None
        if cs is None:
            cs = build_cluster_side(snap.nodes, snap.bound_pods, wfp, self.hpaw)
            cs.raw_nodes_fp = raw_nodes_fp
            cs.storage_fp = storage_fp
            cs.raw_refs = raw_keepalive_refs(raw_snap)
            cs.stats["rebuilds"] += 1
            self._cs = cs
            self.stats["full"] += 1
        # remember this wave's specs so the next cycle's bind-absorb is O(1)
        # per pod; size-capped so never-scheduled uids cannot pile up
        if len(cs.wave_ix) > 4 * (len(cs.records) + len(wave_uids) + 1024):
            cs.wave_ix.clear()
            cs.wave_store.clear()
            cs.rep_bound_info.clear()
        wid = cs.wave_next
        cs.wave_next = wid + 1
        cs.wave_store[wid] = [wave_pods, reps, inv.tolist(), len(wave_uids)]
        base = wid << 32
        cs.wave_ix.update(zip(wave_uids, map(base.__or__, range(len(wave_uids)))))
        # a stable backlog re-pends the same uids each cycle: sweep the
        # waves no index entry references any more
        if len(cs.wave_store) > 8:
            live = {x >> 32 for x in cs.wave_ix.values()}
            for w in [w for w in cs.wave_store if w not in live]:
                del cs.wave_store[w]
        return _assemble(cs, snap, reps, inv, perm, rep_keys, wave_uids if wave_pods is None else None)

    @staticmethod
    def _verify_against_rebuild(cs: ClusterSide, snap) -> None:
        """debug_verify: the synced cluster side must equal a fresh rebuild
        (an in-place Node/Pod mutation defeats the identity checks)."""
        fresh = build_cluster_side(snap.nodes, snap.bound_pods, cs.wfp, cs.hpaw)
        for name in ("used_raw", "term_counts0", "anti_counts0", "pref_own0", "node_port_count"):
            a, b = getattr(cs, name), getattr(fresh, name)
            # departed bound pods' terms stay interned in cs: only equal
            # shapes are comparable
            if a.shape == b.shape and not np.array_equal(a, b):
                raise AssertionError(
                    f"delta debug_verify: {name} diverged from rebuild (in-place Node/Pod mutation "
                    "defeating the identity fingerprint?)"
                )

    # -- device side --
    def encode_device(self, snap):
        """encode() with the arrays placed on the encoder's device."""
        return self._to_device(*self.encode(snap))

    def to_device(self, arr, meta):
        """Place host arrays from encode() on the encoder's device, reusing
        the resident tensor of every field whose host array is the same
        object as, or equal in value to, the last one placed."""
        return self._to_device(arr, meta)

    def drop_device_buffers(self) -> None:
        """Forget every resident tensor (the next placement copies all)."""
        self._dev.clear()

    def set_mesh(self, mesh) -> None:
        """Place every later encode on the node mesh `mesh` (None, or a
        one-shard mesh: one device).  Changing the mesh drops the resident
        tensors (the JAX package's delta.py:884)."""
        if mesh is not None and mesh.size <= 1:
            mesh = None
        if mesh is not None and any(d.type != self.device.type for d in mesh.devices):
            raise ValueError(f"{mesh} does not sit on the encoder's device type {self.device.type}")
        if mesh != self._mesh:
            self._mesh = mesh
            self._dev.clear()
            self._pad_memo.clear()

    @property
    def mesh(self):
        return self._mesh

    def _pad_for_mesh(self, name: str, a: np.ndarray, pad: int, d_sentinel: int, n: int,
                      pod_pad: int = 0) -> np.ndarray:
        """A field's pod and node axes padded for the mesh (parallel/mesh.py
        -- pad_pod_field, pad_field), memoized by the input array's
        identity: an unchanged field keeps one padded object across cycles,
        which the resident-reuse check keys on (the JAX package's
        delta.py:902)."""
        from ..parallel.mesh import pad_field, pad_pod_field

        memo = self._pad_memo.get(name)
        if memo is not None and memo[0] is a:
            return memo[1]
        p = pad_field(name, pad_pod_field(name, a, pod_pad), pad, d_sentinel, n)
        if p is not a:
            self._pad_memo[name] = (a, p)
        return p

    def _h2d(self, a: np.ndarray, device: Optional[torch.device] = None) -> torch.Tensor:
        """One host array into a NEW tensor on `device` (the encoder's when
        None): a CPU copy on the CPU; on the card through pinned staging on
        that card's copy stream (the caller makes the compute stream wait)."""
        device = self.device if device is None else device
        a = np.ascontiguousarray(a)
        if a.dtype in _BITS_OF:
            carrier, dt = _BITS_OF[a.dtype]
            a = a.view(carrier)
        else:
            dt = _TORCH_OF[a.dtype]
        if device.type == "cpu":
            return torch.from_numpy(a.copy()).view(dt)
        stream = self._copy_streams.get(device)
        if stream is None:
            stream = self._copy_streams[device] = torch.cuda.Stream(device)
        ent = self._staging.take(a.nbytes)
        host = ent[0][: a.nbytes]
        host.numpy()[:] = a.reshape(-1).view(np.uint8)
        with torch.cuda.stream(stream):
            d = torch.empty(a.shape, dtype=dt, device=device)
            d.view(torch.uint8).view(-1).copy_(host, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(stream)
        ent[1] = ev
        # d was allocated on the copy stream and is read on the compute
        # stream: its memory is reused only after the compute stream is done
        d.record_stream(torch.cuda.current_stream(device))
        return d

    def _packed_put(self, a: np.ndarray, device: Optional[torch.device] = None) -> torch.Tensor:
        """A wide bool matrix as packed words, unpacked on the device (the
        JAX package's delta.py:922): host-to-device bytes drop 8x, the
        resident tensor is the dense bool plane the kernels read.  On the
        card kernel K9 unpack_planes, on the CPU its plain version."""
        from ..ops import bitplane

        device = self.device if device is None else device
        words = self._h2d(bitplane.np_pack_lastaxis(a), device)
        if device.type != "cpu":
            self._fence()
        return bitplane.unpack_planes(words, a.shape[-1])

    def _fence(self) -> None:
        """The compute stream of each card waits for every copy issued so far
        to it."""
        for device, stream in self._copy_streams.items():
            torch.cuda.current_stream(device).wait_stream(stream)

    def _put(self, key, a: np.ndarray, blk: np.ndarray, device) -> Tuple[torch.Tensor, bool]:
        """The resident tensor of `blk` (the whole field, or a shard's rows of
        it) under `key`: reused when its field `a` is the same object as
        last time or the block is equal in value, else copied -> (tensor,
        copied)."""
        ent = self._dev.get(key)
        if ent is not None and (
            ent[0] is a
            # value dedup: waves from one template family give bit-identical
            # pod-side arrays; a host compare is far cheaper than a copy, and
            # keeps the tensor's identity
            or (ent[1].shape == blk.shape and ent[1].dtype == blk.dtype and np.array_equal(ent[1], blk))
        ):
            return ent[2], False
        d = self._packed_put(blk, device) if _packable(blk) else self._h2d(blk, device)
        self._dev[key] = (a, blk, d)
        return d, True

    def _to_mesh(self, arr, meta):
        """Place host arrays on the node mesh (or the grid): each node-axis
        field padded and cut into the node columns' rows, on a grid each
        pod-axis field padded and cut into the pod rows' blocks, each block
        resident on its position's device; every other field resident once
        per device.  Resident keys: a node block (field, shard) on a 1-D
        mesh, (field, shard, device) on a grid; a pod block (field, "pods",
        row[, shard], device); a whole field (field, device)."""
        from ..parallel.mesh import GridArrays, GridMesh, ShardedArrays, mesh_axis_shards
        from ..parallel.partition_rules import node_axis_of, pod_axis_of

        mesh = self._mesh
        grid = isinstance(mesh, GridMesh)
        rows = mesh.rows if grid else (mesh,)
        pod_shards, node_shards = mesh_axis_shards(mesh)
        n, p = arr.N, arr.P
        pad, pod_pad = (-n) % node_shards, (-p) % pod_shards
        nl, pl = (n + pad) // node_shards, (p + pod_pad) // pod_shards
        d_sentinel = arr.term_counts0.shape[1] - 1
        cells = [[{} for _ in row.devices] for row in rows]
        copied = False
        for name in ClusterArrays.FIELDS:
            a = getattr(arr, name)
            naxis = node_axis_of(name, np.shape(a), n)
            paxis = pod_axis_of(name) if grid else None
            if naxis is not None or paxis is not None:
                a = self._pad_for_mesh(name, a, pad, d_sentinel, n, pod_pad if grid else 0)
            for i, (r, row) in enumerate(zip(mesh.row_ids if grid else (0,), rows)):
                for j, (s, dev) in enumerate(zip(row.ids, row.devices)):
                    blk, key = a, (name,)
                    if paxis is not None:
                        blk = blk[(slice(None),) * paxis + (slice(r * pl, (r + 1) * pl),)]
                        key += ("pods", r)
                    if naxis is not None:
                        blk = blk[(slice(None),) * naxis + (slice(s * nl, (s + 1) * nl),)]
                        key += (s,)
                    if grid or naxis is None:
                        key += (dev,)
                    cells[i][j][name], c = self._put(key, a, blk, dev)
                    copied |= c
        if copied and self.device.type != "cpu":
            self._fence()
        image_sharded = np.shape(arr.image_score)[1] == n
        cells = tuple(tuple(ClusterArrays(**f) for f in row) for row in cells)
        if grid:
            return GridArrays(mesh, cells, image_sharded), meta
        return ShardedArrays(mesh, cells[0], image_sharded), meta

    def _to_device(self, arr, meta):
        if self._mesh is not None:
            return self._to_mesh(arr, meta)
        out = {}
        copied = False
        for name in ClusterArrays.FIELDS:
            a = getattr(arr, name)
            out[name], c = self._put(name, a, a, self.device)
            copied |= c
        if copied and self.device.type != "cpu":
            self._fence()
        return ClusterArrays(**out), meta


def _cached(cs: ClusterSide, name: str, key, builder):
    """Padded-array cache: rebuild only when `key` changes, else return the
    SAME object (identity drives DeltaEncoder.to_device's reuse).  Cached
    arrays are never mutated in place."""
    ent = cs.pad_cache.get(name)
    if ent is not None and ent[0] == key:
        return ent[1]
    a = builder()
    cs.pad_cache[name] = (key, a)
    return a


def _pod_side(cs: ClusterSide, reps, inv, p: int, P: int, N: int, T: int, L: int, req_s, pod_groups):
    """Every wave-derived (pod-side) array, built per unique spec and
    scattered through inv; cached as a unit by _assemble (the JAX package's
    api/delta.py:1228)."""
    U = len(reps)
    R = len(cs.wfp.resources)
    Uq = max(1, U)
    pod_req = np.zeros((P, R), dtype=np.int32)
    pod_req[:p] = req_s
    taint_objs = cs.taint_objs
    taint_is_pref = np.array([tn.effect == t.PREFER_NO_SCHEDULE for tn in taint_objs], dtype=bool)
    table = v.TermTable()
    term_lists: List[List[int]] = []
    pref_lists: List[List[Tuple[int, float]]] = []
    u_valid = np.zeros(Uq, dtype=bool)
    u_prio = np.zeros(Uq, dtype=np.int32)
    u_tol = np.ones((Uq, T), dtype=bool)
    u_tol_pref = np.ones((Uq, T), dtype=bool)
    u_pin = np.full(Uq, -1, dtype=np.int32)
    for ui, pod in enumerate(reps):
        u_valid[ui] = not pod.scheduling_gates
        u_prio[ui] = pod.priority
        if pod.tolerations:
            for tid, taint in enumerate(taint_objs):
                tol = any(x.tolerates(taint) for x in pod.tolerations)
                if taint_is_pref[tid]:
                    u_tol_pref[ui, tid] = tol
                else:
                    u_tol[ui, tid] = tol
        elif taint_objs:
            u_tol[ui] = taint_is_pref
            u_tol_pref[ui] = ~taint_is_pref
        if pod.node_name:
            u_pin[ui] = cs.node_index.get(pod.node_name, -2)
        terms = v.pod_required_node_terms(pod, cs.lab)
        term_lists.append([] if terms is None else [table.intern(tm) for tm in terms])
        prefs: List[Tuple[int, float]] = []
        if pod.affinity:
            for pt in pod.affinity.preferred_node_terms:
                if pt.preference.match_expressions:
                    prefs.append((table.intern(v.lower_node_term(pt.preference.match_expressions, cs.lab)),
                                  float(pt.weight)))
        pref_lists.append(prefs)
    TT = max(1, max((len(x) for x in term_lists), default=1))
    u_terms = np.full((Uq, TT), -1, dtype=np.int32)
    u_has_sel = np.zeros(Uq, dtype=bool)
    for ui, ids in enumerate(term_lists):
        if ids:
            u_has_sel[ui] = True
            u_terms[ui, : len(ids)] = ids
    PW = max(1, max((len(x) for x in pref_lists), default=1))
    u_pref_terms = np.full((Uq, PW), -1, dtype=np.int32)
    u_pref_weights = np.zeros((Uq, PW), dtype=np.float32)
    for ui, prefs in enumerate(pref_lists):
        for a, (tid, w) in enumerate(prefs):
            u_pref_terms[ui, a] = tid
            u_pref_weights[ui, a] = w
    sel_mask, sel_kind = table.encode(L)

    # --- gangs (the JAX package's api/delta.py:1333-1348): group ids in
    # first-occurrence order over the unique specs; a group the snapshot
    # does not describe needs all its pods ---
    group_ids = v.Interner()
    u_group = np.full(Uq, -1, dtype=np.int32)
    for ui, pod in enumerate(reps):
        if pod.pod_group:
            u_group[ui] = group_ids.intern(pod.pod_group)
    pod_group = np.full(P, -1, dtype=np.int32)
    if p:
        pod_group[:p] = u_group[inv]
    G = max(1, len(group_ids))
    group_min = np.ones(G, dtype=np.int32)
    if len(group_ids):
        counts = np.bincount(pod_group[pod_group >= 0], minlength=G)
        for gi, gname in enumerate(group_ids.items):
            pg = pod_groups.get(gname)
            group_min[gi] = pg.min_member if pg else int(counts[gi])

    # --- pairwise wave side against the resident vocabulary ---
    T2 = max(1, len(cs.voc.terms))
    get = cs.voc.terms.get
    pod_aff, pod_anti, pod_prefp, pod_spread = [], [], [], []
    for pod in reps:
        aff, anti, pref, spread = _pod_pairwise_terms(pod)
        pod_aff.append([get(tk) for tk in aff])
        pod_anti.append([get(tk) for tk in anti])
        pod_prefp.append([(get(tk), w) for tk, w in pref])
        pod_spread.append([(get(tk), skew, mode) for tk, skew, mode in spread])
    m_pend = np.zeros((T2, P), dtype=np.float32)
    m_uniq = None
    if p and cs.terms_list:
        m_uniq = _match_matrix(cs.terms_list, list(reps))  # [T2, U]
        m_pend[:, :p] = m_uniq[:, inv]
    A1 = max(1, max((len(x) for x in pod_aff), default=1))
    A2 = max(1, max((len(x) for x in pod_anti), default=1))
    B = max(1, max((len(x) for x in pod_prefp), default=1))
    C = max(1, max((len(x) for x in pod_spread), default=1))
    u_aff = np.full((Uq, A1), -1, dtype=np.int32)
    u_anti = np.full((Uq, A2), -1, dtype=np.int32)
    u_pref_t = np.full((Uq, B), -1, dtype=np.int32)
    u_pref_w = np.zeros((Uq, B), dtype=np.float32)
    u_spread_t = np.full((Uq, C), -1, dtype=np.int32)
    u_spread_skew = np.zeros((Uq, C), dtype=np.int32)
    u_spread_hard = np.zeros((Uq, C), dtype=bool)
    for ui in range(U):
        for a, ti in enumerate(pod_aff[ui]):
            u_aff[ui, a] = ti
        for a, ti in enumerate(pod_anti[ui]):
            u_anti[ui, a] = ti
        for a, (ti, w) in enumerate(pod_prefp[ui]):
            u_pref_t[ui, a] = ti
            u_pref_w[ui, a] = np.float32(w)
        for c, (ti, skew, mode) in enumerate(pod_spread[ui]):
            u_spread_t[ui, c] = ti
            u_spread_skew[ui, c] = skew
            u_spread_hard[ui, c] = mode == HARD
    # matched-term slots: per unique spec, the nonzero entries of its m_pend
    # column (M rounded up to a power of two); and the self-match bit of each
    # own required-affinity slot (the waiver's input)
    MM = 1
    u_mt = np.full((Uq, 1), -1, dtype=np.int32)
    u_mv = np.zeros((Uq, 1), dtype=np.float32)
    u_aself = np.zeros((Uq, A1), dtype=bool)
    if m_uniq is not None:
        nz = [np.flatnonzero(m_uniq[:, ui]) for ui in range(U)]
        MM = _round_up_pow2(max((len(z) for z in nz), default=1), minimum=1)
        u_mt = np.full((Uq, MM), -1, dtype=np.int32)
        u_mv = np.zeros((Uq, MM), dtype=np.float32)
        for ui, z in enumerate(nz):
            u_mt[ui, : len(z)] = z
            u_mv[ui, : len(z)] = m_uniq[z, ui]
        rows, cols = np.nonzero(u_aff[:U] >= 0)
        if len(rows):
            u_aself[rows, cols] = m_uniq[u_aff[rows, cols], rows] > 0

    # --- host ports ---
    PT = cs.node_port_count.shape[1]
    u_ports = np.zeros((Uq, PT), dtype=bool)
    for ui, pod in enumerate(reps):
        for pp in pod.host_ports:
            u_ports[ui, cs.voc.ports.get(pp)] = True

    def rows(u_arr, fill, dtype):
        out = np.full((P,) + u_arr.shape[1:], fill, dtype=dtype)
        if p:
            out[:p] = u_arr[inv]
        return out

    return dict(
        pod_valid=rows(u_valid, False, bool), pod_req=pod_req, pod_prio=rows(u_prio, 0, np.int32),
        pod_tol_ns=rows(u_tol, True, bool), pod_tol_pref=rows(u_tol_pref, True, bool),
        pod_nodename=rows(u_pin, -1, np.int32), pod_terms=rows(u_terms, -1, np.int32),
        pod_has_sel=rows(u_has_sel, False, bool), sel_mask=sel_mask, sel_kind=sel_kind,
        pod_pref_terms=rows(u_pref_terms, -1, np.int32), pod_pref_weights=rows(u_pref_weights, 0, np.float32),
        m_pend=m_pend, pod_match_terms=rows(u_mt, -1, np.int32), pod_match_vals=rows(u_mv, 0, np.float32),
        pod_aff_self=rows(u_aself, False, bool), pod_aff_terms=rows(u_aff, -1, np.int32),
        pod_anti_terms=rows(u_anti, -1, np.int32), pod_pref_aff_terms=rows(u_pref_t, -1, np.int32),
        pod_pref_aff_w=rows(u_pref_w, 0, np.float32), pod_spread_terms=rows(u_spread_t, -1, np.int32),
        pod_spread_maxskew=rows(u_spread_skew, 0, np.int32), pod_spread_hard=rows(u_spread_hard, False, bool),
        pod_ports=rows(u_ports, False, bool),
        pod_group=pod_group, group_min=group_min,
        image_score=_image_score_matrix(cs.nodes, reps, inv, N, P),
    )


def _class_index(inv: np.ndarray, U: int, p: int, P: int):
    """(pod_class i32[P], class_first_pod i64[U1]): inv IS the class map (one
    class per unique spec, numbered by first occurrence in activeQ order);
    bucketing padding gets one more class, pointing at row p."""
    pc = np.full(P, U, dtype=np.int32)
    if p:
        pc[:p] = inv
    padded = P > p
    first = np.zeros(U + (1 if padded else 0), dtype=np.int64)
    if U:
        uu, fi = np.unique(inv, return_index=True)
        first[uu] = fi
    if padded:
        first[U] = p
    return pc, first


def _assemble(cs: ClusterSide, snap, reps, inv: np.ndarray, perm: np.ndarray, rep_keys,
              wave_names: Optional[List[str]] = None):
    """The wave's arrays against the resident cluster side -> (ClusterArrays
    of host arrays, EncodingMeta).  While the wave's spec keys, inverse
    index, padding and scale are the previous cycle's, the whole pod side
    is reused from the cache.  `wave_names`: a pregrouped wave's uids in
    activeQ order, which stand for its pods (snap has none)."""
    nodes = cs.nodes
    pending = snap.pending_pods
    n = len(nodes)
    p = len(wave_names) if wave_names is not None else len(pending)
    N = _bucket(n)
    P = _bucket(p)
    resources = list(cs.wfp.resources)
    R = len(resources)
    U = len(reps)

    # --- resources: the scale re-derived from raw values each cycle ---
    req_uniq = (
        np.array([pod_effective_requests(rp, resources) for rp in reps], dtype=np.int64)
        if U else np.zeros((1, R), dtype=np.int64)
    )
    req_raw = req_uniq[inv] if p else np.zeros((0, R), dtype=np.int64)
    stacked = np.concatenate([cs.alloc_uniq, req_uniq, cs.used_raw], axis=0)
    scale = np.array([_scale_for(stacked[:, j]) for j in range(R)], dtype=np.int64)
    skey = tuple(scale.tolist())

    def _pad2(src, dtype):
        out = np.zeros((N, src.shape[1]), dtype=dtype)
        out[:n] = src
        return out

    node_alloc = _cached(cs, "node_alloc", (N, skey), lambda: _pad2(cs.alloc_raw // scale, np.int32))
    node_used = _cached(cs, "node_used", (N, skey, cs.mut_version),
                        lambda: _pad2(-(-cs.used_raw // scale), np.int32))

    def _valid():
        a = np.zeros(N, dtype=bool)
        a[:n] = True
        return a

    def _unsched():
        a = np.zeros(N, dtype=bool)
        a[:n] = [nd.unschedulable for nd in nodes]
        return a

    node_valid = _cached(cs, "node_valid", N, _valid)
    node_unsched = _cached(cs, "node_unsched", N, _unsched)
    L = cs.node_labels.shape[1]
    T = cs.node_taint_ns.shape[1]
    node_labels = _cached(cs, "node_labels", N, lambda: _pad2(cs.node_labels, bool))
    node_taint_ns = _cached(cs, "node_taint_ns", N, lambda: _pad2(cs.node_taint_ns, bool))
    node_taint_pref = _cached(cs, "node_taint_pref", N, lambda: _pad2(cs.node_taint_pref, bool))

    # --- pod side, per unique spec ---
    groups_key = tuple(sorted((g.name, g.min_member) for g in snap.pod_groups.values()))
    pod_key = (rep_keys, inv.tobytes(), P, skey, groups_key)
    ent = cs.pad_cache.get("podside")
    if ent is not None and ent[0] == pod_key:
        ps = ent[1]
    else:
        req_s = -(-req_raw // scale)
        ps = _pod_side(cs, reps, inv, p, P, N, T, L, req_s, snap.pod_groups)
        cs.pad_cache["podside"] = (pod_key, ps)

    K = cs.node_dom.shape[0]
    D1 = cs.term_counts0.shape[1]

    def _dom():
        a = np.full((K, N), D1 - 1, dtype=np.int32)
        if n:
            a[:, :n] = cs.node_dom[:, :n]
        return a

    pod_class, class_first = _cached(cs, "class_index", (P, U, p, inv.tobytes()),
                                     lambda: _class_index(inv, U, p, P))
    arrays = ClusterArrays(
        node_valid=node_valid, node_alloc=node_alloc, node_used=node_used, node_unsched=node_unsched,
        node_labels=node_labels, node_taint_ns=node_taint_ns, node_taint_pref=node_taint_pref,
        node_dom=_cached(cs, "node_dom", N, _dom),
        term_key=_cached(cs, "term_key", 0, cs.term_key.copy),
        term_counts0=_cached(cs, "term_counts0", cs.mut_version, cs.term_counts0.copy),
        anti_counts0=_cached(cs, "anti_counts0", cs.mut_version, cs.anti_counts0.copy),
        pref_own0=_cached(cs, "pref_own0", cs.mut_version, cs.pref_own0.copy),
        node_ports0=_cached(cs, "node_ports0", (N, cs.mut_version), lambda: _pad2(cs.node_port_count > 0, bool)),
        **ps,
    )
    meta = EncodingMeta(
        node_names=[nd.name for nd in nodes],
        pod_names=list(wave_names) if wave_names is not None else [pending[i].name for i in perm],
        pod_perm=perm,
        resources=resources,
        resource_scale=scale,
        label_vocab=cs.lab,
        taint_vocab=cs.taints,
        n_nodes=n,
        n_pods=p,
        pod_class=pod_class,
        class_first_pod=class_first,
        n_classes=int(class_first.shape[0]),
        dirty_nodes=cs.last_dirty_nodes,
    )
    return arrays, meta


def class_groups(meta, rows):
    """Group device pod rows by equivalence class for the diagnosis plane
    (ops/explain.py; the JAX package's api/delta.py:1190): every pod of a
    class shares its spec, so one diagnosis per class serves all its pods.

    -> (reps i64[F]: the first seen row of each distinct class, in order of
    first appearance; {row: rep position}).  Without a class index (the
    plain encode_snapshot path) every distinct row is its own class."""
    first: dict = {}
    group_of: dict = {}
    reps: list = []
    cls_of = meta.pod_class
    for r in rows:
        r = int(r)
        c = int(cls_of[r]) if cls_of is not None else r
        g = first.get(c)
        if g is None:
            g = first[c] = len(reps)
            reps.append(r)
        group_of[r] = g
    return np.asarray(reps, dtype=np.int64), group_of
