"""Volume + DRA resolution — the port's copy of the JAX package's
``api/volumes.py``: storage and device-claim constraints are lowered onto
the core scheduling model (node-affinity terms and extra resources) before
encoding, so the card's kernels serve them unchanged.  ``api/delta.py``
resolves every snapshot it encodes; ``runtime/client.py`` resolves before
anything reaches the sidecar's wire, which carries no storage schema.

reference semantics covered (SURVEY.md §2.2 volume rows + DRA):
  - VolumeZone / bound-PVC topology (volumezone/volume_zone.go,
    volumebinding's feasibility for statically-bound claims): a pod claiming a
    PVC bound to a PV with allowedTopology {zone=a} can only run on nodes
    labeled zone=a -> folded into the pod's required node-affinity terms.
  - VolumeBinding for unbound claims (volumebinding/binder.go): immediate-mode
    unbound claims must have SOME compatible PV (class + capacity); if none
    exists the pod is unschedulable everywhere.  If candidate PVs exist, node
    feasibility is restricted to the union of their topologies.
    WaitForFirstConsumer claims place no scheduling constraint (delayed
    binding happens at Reserve/PreBind in the reference).
  - NodeVolumeLimits (nodevolumelimits/csi.go): per-node attachable-volume
    cap -> a synthetic "attachable-volumes-csi" resource: nodes with a limit
    allocate it, each PVC consumes 1, and NodeResourcesFit enforces the cap.
  - DynamicResources-lite (dynamicresources/): ResourceClaims for counted
    device classes -> extended resources named "claim/<deviceClass>".

resolve_snapshot returns a NEW snapshot with these constraints folded in;
the original objects are not mutated.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Tuple

from . import types as t
from .snapshot import Snapshot

ATTACH_RESOURCE = "attachable-volumes-csi"
CLAIM_PREFIX = "claim/"


def _topology_term(allowed_topology) -> Optional[t.NodeSelectorTerm]:
    """Allowed-topology pairs (from a PV or a StorageClass) → one conjunction
    term.  Pairs sharing a key merge into one In-expression (values OR
    together — the reference's TopologySelectorTerm.matchLabelExpressions
    carries values[] per key); DISTINCT keys AND together."""
    if not allowed_topology:
        return None
    by_key: dict = {}
    for k, v in allowed_topology:
        by_key.setdefault(k, []).append(v)
    return t.NodeSelectorTerm(
        match_expressions=tuple(
            t.NodeSelectorRequirement(key=k, operator=t.OP_IN, values=tuple(vs))
            for k, vs in by_key.items()
        )
    )


def _pv_topology_term(pv: t.PersistentVolume) -> Optional[t.NodeSelectorTerm]:
    return _topology_term(pv.allowed_topology)


def _unsatisfiable_term() -> t.NodeSelectorTerm:
    return t.NodeSelectorTerm(
        match_expressions=(
            t.NodeSelectorRequirement(
                key="volume.kubernetes.io/unsatisfiable", operator=t.OP_IN, values=("true",)
            ),
        )
    )


def resolve_pod(
    pod: t.Pod,
    pvcs: Dict[str, t.PersistentVolumeClaim],
    pvs: Dict[str, t.PersistentVolume],
    classes: Optional[Dict[str, object]] = None,
    rwop_blocked: Optional[set] = None,
) -> t.Pod:
    """Fold the pod's storage/claim constraints into requests + node affinity.
    `rwop_blocked`: claim names this pod may NOT use right now (another pod
    holds the ReadWriteOncePod claim) — folds an unsatisfiable term."""
    classes = classes or {}
    extra_terms: List[t.NodeSelectorTerm] = []
    attach_count = 0
    req_extra: Dict[str, int] = {}
    for claim_name in pod.pvcs:
        if rwop_blocked and claim_name in rwop_blocked:
            extra_terms.append(_unsatisfiable_term())
            continue
        pvc = pvcs.get(f"{pod.namespace}/{claim_name}")
        if pvc is None:
            extra_terms.append(_unsatisfiable_term())  # missing claim: pending
            continue
        attach_count += 1
        if pvc.volume_name:
            pv = pvs.get(pvc.volume_name)
            term = _pv_topology_term(pv) if pv else _unsatisfiable_term()
            if pv is None:
                extra_terms.append(_unsatisfiable_term())
            elif term is not None:
                extra_terms.append(term)
        else:
            # Unbound claim (binder.go — FindPodVolumes): the node must admit
            # SOME binding option — a compatible static PV, or dynamic
            # provisioning through the claim's StorageClass.
            sc = classes.get(pvc.storage_class)
            wffc = pvc.wait_for_first_consumer or (
                sc is not None and sc.volume_binding_mode == "WaitForFirstConsumer"
            )
            candidates = [
                pv
                for pv in pvs.values()
                if not pv.claim_ref
                and pv.storage_class == pvc.storage_class
                and pv.capacity >= pvc.request
            ]
            provisionable = sc is not None and bool(sc.provisioner)
            # any option with no topology restriction => no constraint at all
            unconstrained = any(not c.allowed_topology for c in candidates) or (
                provisionable and not sc.allowed_topology
            )
            if unconstrained:
                continue
            options = [
                term
                for term in (_pv_topology_term(c) for c in candidates)
                if term is not None
            ]
            if provisionable:
                ct = _topology_term(sc.allowed_topology)
                if ct is not None:
                    options.append(ct)
            if options:
                extra_terms.append(options[0] if len(options) == 1 else _or_marker(tuple(options)))
            elif wffc and sc is None:
                # delayed binding through an unknown class: no constraint can
                # be derived at filter time (the pre-StorageClass behavior)
                continue
            else:
                extra_terms.append(_unsatisfiable_term())
    if attach_count:
        req_extra[ATTACH_RESOURCE] = attach_count
    for rc in pod.resource_claims:
        key = CLAIM_PREFIX + rc.device_class
        req_extra[key] = req_extra.get(key, 0) + rc.count
    if not extra_terms and not req_extra:
        return pod
    q = copy.copy(pod)
    if req_extra:
        q.requests = {**pod.requests}
        for k, v in req_extra.items():
            q.requests[k] = q.requests.get(k, 0) + v
    if extra_terms:
        q.affinity = _and_affinity(pod.affinity, extra_terms)
    return q


class _OrTerms(tuple):
    """Marker: a disjunction of terms that must AND with the pod's own terms."""


def _or_marker(terms: Tuple[t.NodeSelectorTerm, ...]) -> "_OrTerms":
    return _OrTerms(terms)


def _and_affinity(aff: Optional[t.Affinity], extra) -> t.Affinity:
    """AND extra conjunction terms (or OR-groups) into required node affinity.

    required_node_terms is an OR of conjunctions; to AND a new constraint we
    distribute it into every existing term (the same trick the encoder uses
    for spec.nodeSelector — api/vocab.pod_required_node_terms).
    """
    base_terms: List[t.NodeSelectorTerm] = (
        list(aff.required_node_terms) if aff and aff.required_node_terms else [t.NodeSelectorTerm()]
    )
    for item in extra:
        groups = list(item) if isinstance(item, _OrTerms) else [item]
        new_terms = []
        for bt in base_terms:
            for g in groups:
                new_terms.append(
                    t.NodeSelectorTerm(
                        match_expressions=tuple(bt.match_expressions) + tuple(g.match_expressions)
                    )
                )
        base_terms = new_terms
    if aff is None:
        return t.Affinity(required_node_terms=tuple(base_terms))
    return t.Affinity(
        required_node_terms=tuple(base_terms),
        preferred_node_terms=aff.preferred_node_terms,
        required_pod_affinity=aff.required_pod_affinity,
        required_pod_anti_affinity=aff.required_pod_anti_affinity,
        preferred_pod_affinity=aff.preferred_pod_affinity,
        preferred_pod_anti_affinity=aff.preferred_pod_anti_affinity,
    )


def _device_counts(snap: Snapshot) -> Dict[str, Dict[str, int]]:
    """node -> {claim/<class>: count} from published ResourceSlices resolved
    through DeviceClass selectors — the structured-parameter allocator
    (resource.k8s.io) reduced to per-node per-class counting, which is what
    the vectorized Fit kernel consumes."""
    out: Dict[str, Dict[str, int]] = {}
    # devices are allocated exclusively in the reference; a device matching
    # several class selectors counts toward only ONE class here — the first
    # in name order (deterministic reduction of exclusive allocation)
    classes = sorted(snap.device_classes.values(), key=lambda dc: dc.name)
    for sl in snap.resource_slices:
        if not sl.node_name:
            continue
        per = out.setdefault(sl.node_name, {})
        for dev in sl.devices:
            for dc in classes:
                if dc.selector.matches(dev):
                    key = CLAIM_PREFIX + dc.name
                    per[key] = per.get(key, 0) + 1
                    break
    return out


def resolve_snapshot(snap: Snapshot) -> Snapshot:
    """Returns a snapshot with volume/claim constraints folded in (no-op when
    the snapshot has no PVs/PVCs/claims/attach limits/device slices)."""
    has_storage = bool(snap.pvs or snap.pvcs)
    has_claims = False
    if not has_storage:
        # one fused pass: at 50k-pod scale two separate any() generators are
        # measurable host time on the steady-state encode path
        for p in snap.pending_pods:
            if p.pvcs:
                has_storage = True
                break
            if p.resource_claims:
                has_claims = True
        if not has_storage:
            for p in snap.bound_pods:
                if p.pvcs:
                    has_storage = True
                    break
                if p.resource_claims:
                    has_claims = True
    if has_storage and not has_claims:
        has_claims = any(
            p.resource_claims for p in [*snap.pending_pods, *snap.bound_pods]
        )
    has_limits = any(nd.volume_attach_limit for nd in snap.nodes)
    has_devices = bool(snap.resource_slices and snap.device_classes)
    if not (has_storage or has_claims or has_limits or has_devices):
        return snap
    pvs = {pv.name: pv for pv in snap.pvs}
    pvcs = dict(snap.pvcs)
    classes = dict(snap.storage_classes)
    nodes = snap.nodes
    devices = _device_counts(snap) if has_devices else {}
    if has_limits or has_storage or devices:
        nodes = []
        for nd in snap.nodes:
            nd2 = copy.copy(nd)
            # every node advertises the synthetic attach resource: its declared
            # limit, or effectively-unlimited when none (csi.go treats a
            # missing limit as no cap)
            nd2.allocatable = {
                **nd.allocatable,
                ATTACH_RESOURCE: nd.volume_attach_limit or 1_000_000,
                # device inventory from slices overrides any hand-set counts
                **devices.get(nd.name, {}),
            }
            nodes.append(nd2)
    # ReadWriteOncePod (volumerestrictions/volume_restrictions.go): at most
    # one pod cluster-wide may use such a claim.  A live bound user blocks
    # every pending user; otherwise pending users serialize in snapshot
    # (arrival) order — the first keeps the claim, the rest fold an
    # unsatisfiable term, matching the reference's one-at-a-time outcome
    # (documented deviation: arrival order stands in for cycle order).
    rwop_blocked: Dict[str, set] = {}
    rwop_keys = {k for k, c in pvcs.items() if c.read_write_once_pod}
    if rwop_keys:
        held = set()
        for q in snap.bound_pods:
            if q.phase in (t.PHASE_SUCCEEDED, t.PHASE_FAILED):
                continue
            for cn in q.pvcs:
                ck = f"{q.namespace}/{cn}"
                if ck in rwop_keys:
                    held.add(ck)
        claimed = set(held)
        for q in snap.pending_pods:
            for cn in q.pvcs:
                ck = f"{q.namespace}/{cn}"
                if ck in rwop_keys:
                    if ck in claimed:
                        rwop_blocked.setdefault(q.uid, set()).add(cn)
                    else:
                        claimed.add(ck)
    return Snapshot(
        nodes=nodes,
        pending_pods=[
            resolve_pod(p, pvcs, pvs, classes, rwop_blocked.get(p.uid))
            for p in snap.pending_pods
        ],
        bound_pods=[resolve_pod(p, pvcs, pvs, classes) for p in snap.bound_pods],
        pod_groups=snap.pod_groups,
        pvs=snap.pvs,
        pvcs=snap.pvcs,
        storage_classes=snap.storage_classes,
        resource_slices=snap.resource_slices,
        device_classes=snap.device_classes,
    )
