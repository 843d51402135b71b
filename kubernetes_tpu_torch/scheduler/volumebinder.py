"""Volume binder — PreBind-time PVC→PV binding + dynamic provisioning.

reference: pkg/scheduler/framework/plugins/volumebinding/binder.go —
SchedulerVolumeBinder: FindPodVolumes picks static matches / provisionable
classes during filtering (in this framework that feasibility half lives in
api/volumes.resolve_pod, shared by all execution paths), and BindPodVolumes
commits them at PreBind: bind matched static PVs (claimRef ↔ volumeName) and
create PVs for claims whose StorageClass has a provisioner (the external
provisioner collapsed in-process, like every other external component here).

Provisioned-PV topology: the class's allowedTopology when set; otherwise the
selected node's zone label when present (the common zonal-provisioner shape),
else pinned to the node's hostname (local-volume shape).

The port's copy of the JAX package's ``scheduler/volumebinder.py``: the
PreBind that commits a placed pod's claims to the store.
"""

from __future__ import annotations

import hashlib
from dataclasses import replace
from typing import Dict, Optional

from ..api import types as t
from .store import ClusterStore


def _node_topology(node: t.Node) -> tuple:
    zone = node.labels.get(t.LABEL_ZONE)
    if zone is not None:
        return ((t.LABEL_ZONE, zone),)
    return ((t.LABEL_HOSTNAME, node.name),)


def _matches_node(topology: tuple, node: t.Node) -> bool:
    """Same semantics as volumes._topology_term's lowering: pairs sharing a
    key OR their values (TopologySelectorTerm.matchLabelExpressions carries
    values[] per key), distinct keys AND — a class allowing zone-0 OR
    zone-1 must provision in either, not in the empty zone-0∧zone-1."""
    by_key: dict = {}
    for k, v in topology:
        by_key.setdefault(k, set()).add(v)
    return all(node.labels.get(k) in vs for k, vs in by_key.items())


def bind_pod_volumes(store: ClusterStore, pod: t.Pod, node_name: str) -> Optional[str]:
    """Bind every unbound claim of `pod` for placement on `node_name`.
    Returns an error string (PreBind failure → pod requeues) or None.

    Runs under the store's transaction lock: concurrent binding workers
    (binding_workers > 0) must not both match the same unbound PV — the
    find-then-write sequence here is check-and-commit, and the in-process
    store has no resourceVersion conflict to catch the race."""
    with store.transaction():
        return _bind_pod_volumes_locked(store, pod, node_name)


def _bind_pod_volumes_locked(
    store: ClusterStore, pod: t.Pod, node_name: str
) -> Optional[str]:
    node = store.nodes.get(node_name)
    if node is None:
        return f"node {node_name!r} vanished before volume binding"
    classes: Dict[str, object] = store.objects.get("StorageClass", {})
    for claim_name in pod.pvcs:
        pvc = store.pvcs.get(f"{pod.namespace}/{claim_name}")
        if pvc is None:
            continue  # missing claims were filtered upstream
        if pvc.volume_name:
            # already bound — possibly by a same-batch sibling AFTER this
            # pod's verdict was computed: re-check the volume reaches us
            pv = store.pvs.get(pvc.volume_name)
            if pv is None or not _matches_node(pv.allowed_topology, node):
                return (
                    f"claim {pvc.key!r} bound to volume {pvc.volume_name!r} "
                    f"which is not reachable from {node_name}"
                )
            continue
        # static match first (binder.go prefers pre-provisioned PVs)
        static = sorted(
            (
                pv
                for pv in store.pvs.values()
                if not pv.claim_ref
                and pv.storage_class == pvc.storage_class
                and pv.capacity >= pvc.request
                and _matches_node(pv.allowed_topology, node)
            ),
            # smallest satisfying volume (pv_controller's findBestMatch), name tie-break
            key=lambda pv: (pv.capacity, pv.name),
        )
        if static:
            pv = replace(static[0], claim_ref=pvc.key)
            store.update_pv(pv)
        else:
            sc = classes.get(pvc.storage_class)
            if sc is None or not sc.provisioner:
                return (
                    f"claim {pvc.key!r}: no matching PersistentVolume on "
                    f"{node_name} and storage class {pvc.storage_class!r} "
                    "does not provision"
                )
            if sc.allowed_topology and not _matches_node(
                tuple(sc.allowed_topology), node
            ):
                # the class cannot provision where the pod landed (e.g. a
                # same-batch sibling consumed the static PV this verdict
                # relied on): fail PreBind, pod retries
                return (
                    f"claim {pvc.key!r}: class {sc.name!r} cannot provision "
                    f"a volume reachable from {node_name}"
                )
            # the hash disambiguates ns/name pairs whose dash-joined forms
            # collide (the reference names provisioned PVs by claim UID)
            tag = hashlib.sha1(pvc.key.encode()).hexdigest()[:8]
            pv = t.PersistentVolume(
                name=f"pvc-{pvc.namespace}-{pvc.name}-{tag}",
                capacity=pvc.request,
                storage_class=pvc.storage_class,
                allowed_topology=tuple(sc.allowed_topology) or _node_topology(node),
                claim_ref=pvc.key,
            )
            store.add_pv(pv)
        store.update_pvc(replace(pvc, volume_name=pv.name))
    return None
