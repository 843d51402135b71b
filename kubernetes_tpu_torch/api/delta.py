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

Not ported here (each refused where it would be needed, never dropped):
pairwise terms and counts, host ports, images, volumes and resource claims
(the cluster side keeps no storage fingerprint), pod groups, the sidecar's
``encode_pregrouped``, and mesh placement.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from . import types as t
from . import vocab as v
from .snapshot import (
    _DEFAULT_POD_LIMIT,
    ClusterArrays,
    EncodingMeta,
    SpecInterner,
    _bucket,
    _node_taints,
    _refuse,
    _resource_axis,
    _scale_for,
    activeq_order,
    pod_effective_requests,
)


# --------------------------------------------------------------------------
# wave fingerprint: what the cluster-side cache is conditioned on
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class WaveFingerprint:
    """Wave-derived inputs the cluster side depends on (the fit-only part of
    the JAX package's: its pairwise term and host-port sequences are always
    empty here, since the encoder refuses both)."""

    referenced_keys: frozenset
    resources: Tuple[str, ...]


def wave_fingerprint(reps: Sequence[t.Pod], resources: Sequence[str]) -> WaveFingerprint:
    referenced: set = set()
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
    return WaveFingerprint(referenced_keys=frozenset(referenced), resources=tuple(resources))


# --------------------------------------------------------------------------
# what the fit-only slice refuses
# --------------------------------------------------------------------------


def _check_snapshot(snap) -> None:
    if snap.pvs or snap.pvcs or (snap.resource_slices and snap.device_classes):
        _refuse("volumes / resource slices", "queue A5, api/volumes.py")
    if snap.pod_groups:
        _refuse("pod groups", "queue A9, kernel B11")


def _check_nodes(nodes) -> bool:
    """Refuse volume attach limits; -> whether any node lists images."""
    if any(nd.volume_attach_limit for nd in nodes):
        _refuse("volume attach limits", "queue A5, api/volumes.py")
    return any(nd.images for nd in nodes)


def _check_pod(pod, pending: bool, node_images: bool) -> None:
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
        return
    if pod.topology_spread:
        _refuse(f"pod {pod.name!r}: topology spread", "queue A7, kernel B9")
    if pod.pod_group:
        _refuse(f"pod {pod.name!r}: pod group", "queue A9, kernel B11")
    if pod.images and node_images:
        _refuse(f"pod {pod.name!r}: image locality", "queue A7, kernel B8")


def _check_pending(reps, pending, node_images: bool) -> None:
    """Every refused pending-pod feature but volumes and claims is part of
    the spec key, so the unique specs stand for their pods; volumes and
    claims are checked per pod."""
    for pod in reps:
        _check_pod(pod, True, node_images)
    for pod in pending:
        if pod.pvcs or pod.resource_claims:
            _check_pod(pod, True, node_images)


# --------------------------------------------------------------------------
# cluster side: resident, delta-updated state
# --------------------------------------------------------------------------


class _Fallback(Exception):
    """A delta cannot be absorbed bit-exactly — rebuild the cluster side."""


# One bound pod's contribution, for O(1) reversal on delete: (node row,
# request row, the pod OBJECT).  Holding the object keeps it alive, so
# `rec[_OBJ] is q` is a sound unchanged-check.
_BoundRec = tuple
_NI, _REQ_U, _OBJ = range(3)

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
    nodes: List[t.Node]
    nodes_fp: Tuple
    node_index: Dict[str, int]
    node_images: bool
    lab: v.LabelVocab
    node_labels: np.ndarray  # bool[n, L]
    taints: v.Interner
    taint_objs: List[t.Taint]
    node_taint_ns: np.ndarray  # bool[n, T] hard taints
    has_prefer_taints: bool
    alloc_raw: np.ndarray  # i64[n, R]
    alloc_uniq: np.ndarray  # the distinct allocatable rows (the rescale reads them)
    used_raw: np.ndarray  # i64[n, R]
    breq_uniq_ids: Dict[Tuple, int]
    breq_uniq: List[List[int]]  # raw effective-request rows of bound pods
    records: Dict[str, _BoundRec] = field(default_factory=dict)
    stats: Dict[str, int] = field(default_factory=lambda: {"rebuilds": 0, "deltas": 0})
    # padded-array cache for _assemble: name -> (key, array)
    pad_cache: Dict[str, Tuple] = field(default_factory=dict)
    # bumped whenever a sync changes used_raw; versioned cache entries copy
    # once per version, so handed-out arrays are immutable
    mut_version: int = 0
    # fast bind-absorb: uid -> (wave id << 32 | position) into wave_store
    # [wave id -> [sorted pods, reps, inv list, pods not yet bound]]
    wave_ix: Dict[str, int] = field(default_factory=dict)
    wave_store: Dict[int, list] = field(default_factory=dict)
    wave_next: int = 0
    # bound-side info per wave rep: id(rep) -> (rep, request row)
    rep_bound_info: Dict[int, Tuple] = field(default_factory=dict)
    raw_nodes_fp: Tuple = ()
    raw_refs: Tuple = ()
    # node rows whose usage changed in the last sync_bound (None after a
    # rebuild: everything)
    last_dirty_nodes: Optional[np.ndarray] = None


def _nodes_fp(nodes: Sequence[t.Node]) -> Tuple:
    return tuple((nd.name, id(nd)) for nd in nodes)


def raw_fingerprints(snap) -> Tuple:
    """(nodes fingerprint, storage fingerprint) the cache is conditioned on.
    Volumes are refused, so the storage fingerprint is empty."""
    return (_nodes_fp(snap.nodes), ())


def raw_keepalive_refs(snap) -> Tuple:
    """Containers pinning every object the fingerprints id(): built only on
    a rebuild."""
    return (list(snap.nodes),)


def build_cluster_side(nodes: Sequence[t.Node], bound: Sequence[t.Pod], wfp: WaveFingerprint) -> ClusterSide:
    node_images = _check_nodes(nodes)
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
    if n:
        uniq = np.zeros((len(tprof), T), dtype=bool)
        for u, ts in enumerate(tprof):
            for tn in ts:
                if tn.effect != t.PREFER_NO_SCHEDULE:
                    uniq[u, taints.get((tn.key, tn.value, tn.effect))] = True
        node_taint_ns[:] = uniq[tinv]

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

    # --- bound pods: one record each, requests interned ---
    used_raw = np.zeros((n, R), dtype=np.int64)
    breq_uniq_ids: Dict[Tuple, int] = {}
    breq_uniq: List[List[int]] = []
    records: Dict[str, _BoundRec] = {}
    rec_ni: List[int] = []
    rec_req: List[int] = []
    for q in bound:
        _check_pod(q, False, node_images)
        ni = node_index.get(q.node_name)
        if ni is None:
            continue
        rkey = tuple(sorted(q.requests.items()))
        ru = breq_uniq_ids.get(rkey)
        if ru is None:
            ru = breq_uniq_ids[rkey] = len(breq_uniq)
            breq_uniq.append(pod_effective_requests(q, resources))
        if q.uid in records:
            raise ValueError(f"duplicate bound pod uid {q.uid!r} in snapshot")
        records[q.uid] = (ni, ru, q)
        rec_ni.append(ni)
        rec_req.append(ru)

    cs = ClusterSide(
        wfp=wfp, nodes=list(nodes), nodes_fp=_nodes_fp(nodes), node_index=node_index,
        node_images=node_images, lab=lab, node_labels=node_labels, taints=taints, taint_objs=taint_objs,
        node_taint_ns=node_taint_ns,
        has_prefer_taints=any(tn.effect == t.PREFER_NO_SCHEDULE for tn in taint_objs),
        alloc_raw=alloc_raw, alloc_uniq=np.unique(alloc_raw, axis=0) if n else np.zeros((1, R), np.int64),
        used_raw=used_raw, breq_uniq_ids=breq_uniq_ids, breq_uniq=breq_uniq, records=records,
    )
    _apply_bound_batch(cs, np.array(rec_ni, dtype=np.int64), np.array(rec_req, dtype=np.int64), sign=1)
    return cs


def _apply_bound_batch(cs: ClusterSide, ni: np.ndarray, req_u: np.ndarray, sign: int) -> None:
    """Scatter-add (sign=+1) or -subtract (sign=-1) a batch of bound-pod
    requests.  Integer sums, so the order cannot change the result."""
    if len(ni) == 0:
        return
    np.add.at(cs.used_raw, ni, np.int64(sign) * np.array(cs.breq_uniq, dtype=np.int64)[req_u])


def sync_bound(cs: ClusterSide, bound: Sequence[t.Pod]) -> None:
    """Absorb the bound-pod diff (binds + deletes since the last cycle) into
    the resident cluster side.  Raises _Fallback when a new bound pod needs a
    resource kind the cache lacks, and NotImplementedError (through _refuse)
    when it brings a feature the slice does not port."""
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

    def _spec_info(q) -> int:
        """The request row of a bound pod (the part that sorts), once per
        unique spec."""
        _check_pod(q, False, cs.node_images)
        if any(k not in res_set for k in q.requests):
            raise _Fallback("new resource kind from bound pod")
        rkey = tuple(sorted(q.requests.items()))
        ru = cs.breq_uniq_ids.get(rkey)
        if ru is None:
            ru = cs.breq_uniq_ids[rkey] = len(cs.breq_uniq)
            cs.breq_uniq.append(pod_effective_requests(q, resources))
        return ru

    add_recs: List[_BoundRec] = []
    # a 50k-pod wave's absorb runs this loop 50k times per cycle: locals for
    # the hot attributes
    wave_pop = cs.wave_ix.pop
    wave_store = cs.wave_store
    rb = cs.rep_bound_info
    node_index = cs.node_index
    append = add_recs.append
    for q in new:
        packed = wave_pop(q.uid, None)
        ent_wave = None
        if packed is not None:
            wid = packed >> 32
            went = wave_store.get(wid)
            if went is not None:
                i = packed & 0xFFFFFFFF
                ent_wave = (went[0][i], went[1][went[2][i]])
                went[3] -= 1  # drained waves release their pod lists
                if went[3] <= 0:
                    del wave_store[wid]
        if (
            ent_wave is not None
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
            ru = ent[1]
        else:
            ru = _spec_info(q)
        append((node_index[q.node_name], ru, q))
    # every check passed: only now does the resident state move
    cs.stats["deltas"] += 1
    cs.mut_version += 1
    dirty_ni: List[int] = []
    if gone:
        recs = [cs.records.pop(uid) for uid in gone]
        dirty_ni.extend(r[_NI] for r in recs)
        _apply_bound_batch(cs, np.array([r[_NI] for r in recs], dtype=np.int64),
                           np.array([r[_REQ_U] for r in recs], dtype=np.int64), sign=-1)
    if add_recs:
        for rec in add_recs:
            cs.records[rec[_OBJ].uid] = rec
        dirty_ni.extend(r[_NI] for r in add_recs)
        _apply_bound_batch(cs, np.array([r[_NI] for r in add_recs], dtype=np.int64),
                           np.array([r[_REQ_U] for r in add_recs], dtype=np.int64), sign=1)
    cs.last_dirty_nodes = np.unique(np.array(dirty_ni, dtype=np.int64))


def _wave_compatible(cs: ClusterSide, wfp: WaveFingerprint) -> bool:
    """A cached cluster side serves a new wave EXACTLY (equal fingerprint)
    or as a SUPERSET (every referenced label key and resource kind already
    there; surplus label literals and resource columns are inert, so the
    decisions are the same)."""
    if cs.wfp == wfp:
        return True
    return wfp.referenced_keys <= cs.wfp.referenced_keys and set(wfp.resources) <= set(cs.wfp.resources)


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
_TORCH_OF = {np.dtype(np.bool_): torch.bool, np.dtype(np.int32): torch.int32, np.dtype(np.uint32): torch.int32}


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

    def __init__(self, device=None, *, debug_verify: bool = False):
        self.device = resolve_device(device)
        self._cs: Optional[ClusterSide] = None
        self._dev: Dict[str, Tuple] = {}  # field -> (host array, device tensor)
        self.stats = {"full": 0, "delta": 0, "verified": 0}
        # Cache validity rests on OBJECT IDENTITY (node fingerprint, record
        # `is` checks) under copy-on-write Node/Pod objects; debug_verify
        # cross-checks every delta cycle against a fresh rebuild to catch an
        # in-place mutation.
        self.debug_verify = debug_verify
        self._interner = SpecInterner()
        self._copy_stream = None
        self._staging = _Staging()

    # -- host side --
    def encode(self, snap):
        """-> (ClusterArrays of host numpy arrays, EncodingMeta)."""
        _check_snapshot(snap)
        pending = snap.pending_pods
        perm = activeq_order(pending)
        sorted_pending = [pending[i] for i in perm]
        reps, inv, rep_keys = self._interner.group(sorted_pending)
        return self._encode_core(snap, reps, inv, perm, rep_keys, _resource_axis(snap), sorted_pending)

    def _encode_core(self, snap, reps, inv, perm, rep_keys, resources, wave_pods):
        """Cluster-side reuse or rebuild, bound-pod sync, the wave's
        bind-absorb bookkeeping, assembly."""
        raw_nodes_fp, _ = raw_fingerprints(snap)
        wfp = wave_fingerprint(reps, resources)
        cs = self._cs
        if cs is not None and cs.raw_nodes_fp == raw_nodes_fp and _wave_compatible(cs, wfp):
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
            cs = build_cluster_side(snap.nodes, snap.bound_pods, wfp)
            cs.raw_nodes_fp = raw_nodes_fp
            cs.raw_refs = raw_keepalive_refs(snap)
            cs.stats["rebuilds"] += 1
            self._cs = cs
            self.stats["full"] += 1
        _check_pending(reps, wave_pods, cs.node_images)
        # remember this wave's specs so the next cycle's bind-absorb is O(1)
        # per pod; size-capped so never-scheduled uids cannot pile up
        if len(cs.wave_ix) > 4 * (len(cs.records) + len(wave_pods) + 1024):
            cs.wave_ix.clear()
            cs.wave_store.clear()
            cs.rep_bound_info.clear()
        wid = cs.wave_next
        cs.wave_next = wid + 1
        cs.wave_store[wid] = [wave_pods, reps, inv.tolist(), len(wave_pods)]
        base = wid << 32
        cs.wave_ix.update(zip((p.uid for p in wave_pods), map(base.__or__, range(len(wave_pods)))))
        # a stable backlog re-pends the same uids each cycle: sweep the
        # waves no index entry references any more
        if len(cs.wave_store) > 8:
            live = {x >> 32 for x in cs.wave_ix.values()}
            for w in [w for w in cs.wave_store if w not in live]:
                del cs.wave_store[w]
        return _assemble(cs, snap, reps, inv, perm, rep_keys)

    @staticmethod
    def _verify_against_rebuild(cs: ClusterSide, snap) -> None:
        """debug_verify: the synced cluster side must equal a fresh rebuild
        (an in-place Node/Pod mutation defeats the identity checks)."""
        fresh = build_cluster_side(snap.nodes, snap.bound_pods, cs.wfp)
        if cs.used_raw.shape == fresh.used_raw.shape and not np.array_equal(cs.used_raw, fresh.used_raw):
            raise AssertionError(
                "delta debug_verify: used_raw diverged from rebuild (in-place Node/Pod mutation "
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

    def _h2d(self, a: np.ndarray) -> torch.Tensor:
        """One host array into a NEW device tensor: a CPU copy on the CPU; on
        the card through pinned staging on the copy stream (the caller
        makes the compute stream wait)."""
        a = np.ascontiguousarray(a)
        dt = _TORCH_OF[a.dtype]
        if self.device.type == "cpu":
            return torch.from_numpy(a.copy()).view(dt)
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        ent = self._staging.take(a.nbytes)
        host = ent[0][: a.nbytes]
        host.numpy()[:] = a.reshape(-1).view(np.uint8)
        with torch.cuda.stream(self._copy_stream):
            d = torch.empty(a.shape, dtype=dt, device=self.device)
            d.view(torch.uint8).view(-1).copy_(host, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._copy_stream)
        ent[1] = ev
        # d was allocated on the copy stream and is read on the compute
        # stream: its memory is reused only after the compute stream is done
        d.record_stream(torch.cuda.current_stream(self.device))
        return d

    def _packed_put(self, a: np.ndarray) -> torch.Tensor:
        """A wide bool matrix as packed words, unpacked on the device (the
        JAX package's delta.py:922): host-to-device bytes drop 8x, the
        resident tensor is the dense bool plane the kernels read.  On the
        card kernel K9 unpack_planes, on the CPU its plain version."""
        from ..ops import bitplane

        words = self._h2d(bitplane.np_pack_lastaxis(a))
        if self.device.type != "cpu":
            self._fence()
        return bitplane.unpack_planes(words, a.shape[-1])

    def _fence(self) -> None:
        """The compute stream waits for every copy issued so far."""
        if self._copy_stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self._copy_stream)

    def _to_device(self, arr, meta):
        out = {}
        copied = False
        for name in ClusterArrays.FIELDS:
            a = getattr(arr, name)
            ent = self._dev.get(name)
            if ent is not None and (
                ent[0] is a
                # value dedup: waves from one template family give
                # bit-identical pod-side arrays; a host compare is far
                # cheaper than a copy, and keeps the tensor's identity
                or (ent[0].shape == a.shape and ent[0].dtype == a.dtype and np.array_equal(ent[0], a))
            ):
                out[name] = ent[1]
                continue
            d = self._packed_put(a) if _packable(a) else self._h2d(a)
            copied = True
            self._dev[name] = (a, d)
            out[name] = d
        if copied and self.device.type != "cpu":
            self._fence()
        return ClusterArrays(**out, has_prefer_taints=arr.has_prefer_taints, has_node_pref=arr.has_node_pref), meta


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


def _pod_side(cs: ClusterSide, reps, inv, p: int, P: int, T: int, L: int, req_s):
    """Every wave-derived (pod-side) array, built per unique spec and
    scattered through inv; cached as a unit by _assemble.  -> (dict of
    arrays, whether a pod carries a preferred node-affinity term)."""
    U = len(reps)
    R = len(cs.wfp.resources)
    Uq = max(1, U)
    pod_req = np.zeros((P, R), dtype=np.int32)
    pod_req[:p] = req_s
    taint_objs = cs.taint_objs
    taint_is_pref = np.array([tn.effect == t.PREFER_NO_SCHEDULE for tn in taint_objs], dtype=bool)
    table = v.TermTable()
    term_lists: List[List[int]] = []
    has_node_pref = False
    u_valid = np.zeros(Uq, dtype=bool)
    u_prio = np.zeros(Uq, dtype=np.int32)
    u_tol = np.ones((Uq, T), dtype=bool)
    u_pin = np.full(Uq, -1, dtype=np.int32)
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
            u_pin[ui] = cs.node_index.get(pod.node_name, -2)
        terms = v.pod_required_node_terms(pod, cs.lab)
        term_lists.append([] if terms is None else [table.intern(tm) for tm in terms])
        if pod.affinity:
            # preferred terms share the term table, as in the JAX encoder;
            # their score stage is refused by ops.schedule_batch
            for pt in pod.affinity.preferred_node_terms:
                if pt.preference.match_expressions:
                    table.intern(v.lower_node_term(pt.preference.match_expressions, cs.lab))
                    has_node_pref = True
    TT = max(1, max((len(x) for x in term_lists), default=1))
    u_terms = np.full((Uq, TT), -1, dtype=np.int32)
    u_has_sel = np.zeros(Uq, dtype=bool)
    for ui, ids in enumerate(term_lists):
        if ids:
            u_has_sel[ui] = True
            u_terms[ui, : len(ids)] = ids
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
    return dict(
        pod_valid=pod_valid, pod_req=pod_req, pod_prio=pod_prio, pod_tol_ns=pod_tol_ns,
        pod_nodename=pod_nodename, pod_terms=pod_terms, pod_has_sel=pod_has_sel,
        sel_mask=sel_mask, sel_kind=sel_kind,
    ), has_node_pref


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


def _assemble(cs: ClusterSide, snap, reps, inv: np.ndarray, perm: np.ndarray, rep_keys):
    """The wave's arrays against the resident cluster side -> (ClusterArrays
    of host arrays, EncodingMeta).  While the wave's spec keys, inverse
    index, padding and scale are the previous cycle's, the whole pod side
    is reused from the cache."""
    nodes = cs.nodes
    pending = snap.pending_pods
    n = len(nodes)
    p = len(pending)
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

    # --- pod side, per unique spec ---
    pod_key = (rep_keys, inv.tobytes(), P, skey)
    ent = cs.pad_cache.get("podside")
    if ent is not None and ent[0] == pod_key:
        ps, has_node_pref = ent[1]
    else:
        req_s = -(-req_raw // scale)
        ps, has_node_pref = _pod_side(cs, reps, inv, p, P, T, L, req_s)
        cs.pad_cache["podside"] = (pod_key, (ps, has_node_pref))

    pod_class, class_first = _cached(cs, "class_index", (P, U, p, inv.tobytes()),
                                     lambda: _class_index(inv, U, p, P))
    arrays = ClusterArrays(
        node_valid=node_valid, node_alloc=node_alloc, node_used=node_used, node_unsched=node_unsched,
        node_labels=node_labels, node_taint_ns=node_taint_ns, **ps,
        has_prefer_taints=cs.has_prefer_taints, has_node_pref=has_node_pref,
    )
    meta = EncodingMeta(
        node_names=[nd.name for nd in nodes],
        pod_names=[pending[i].name for i in perm],
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
    )
    return arrays, meta
