"""Carry the JAX package's encoded arrays across to the port.

``from_jax_arrays`` takes the JAX ``ClusterArrays`` fields as numpy arrays
(``{f.name: np.asarray(getattr(arr, f.name)) for f in dataclasses.fields(arr)}``)
and builds the port's ``ClusterArrays`` on `device`, every field carried (the
bf16 image scores as their bit patterns; the gang fields pod_group and
group_min too).  Tests feed the JAX encoder's own output to the port's
filters and kernels this way, so kernel parity does not rest on encoder
parity.

``from_jax_meta`` carries the JAX encoder's metadata across, with its class
index (``pod_class`` / ``class_first_pod``), so the port's HoistCache and
class-wave route can be fed exactly the JAX encoder's inputs.

``from_jax_objects`` carries cluster state across: the JAX package's
objects (nodes and pods with every field, their owner references and
probes; PDBs, PVs, PVCs, StorageClasses, ResourceSlices, DeviceClasses,
pod groups, snapshots; the workload kinds ReplicaSet, Deployment, Job,
StatefulSet, DaemonSet, CronJob and HPA; Services, EndpointSlices,
Namespaces, PriorityClasses, quotas, limit ranges, RBAC and flow-control
objects, ResourceClaims, CSRs; CRDs and custom resources; and what they
hold) rebuilt as the port's types of the same class names, field by
field.  It reads only the
objects themselves (dataclass fields and class names), so it needs nothing
of the JAX package: the tests load one seeded cluster into both packages'
stores this way.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from .api import cluster as _cluster
from .api import snapshot as _snapshot
from .api import types as _types
from .api.snapshot import ClusterArrays, EncodingMeta
from .scheduler import crd as _crd

_MODULES = (_types, _cluster, _snapshot, _crd)


def _port_class(name: str):
    for mod in _MODULES:
        cls = getattr(mod, name, None)
        if dataclasses.is_dataclass(cls):
            return cls
    raise TypeError(f"the port has no object type {name!r}")


def from_jax_objects(obj):
    """`obj` (an object of the JAX package's api types, or a list / tuple /
    dict of them, nested) as the port's types: the port's fields, the same
    values, every field carried."""
    if isinstance(obj, (list, tuple)):
        return type(obj)(from_jax_objects(x) for x in obj)
    if isinstance(obj, dict):
        return {k: from_jax_objects(x) for k, x in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = _port_class(type(obj).__name__)
        return cls(**{f.name: from_jax_objects(getattr(obj, f.name))
                      for f in dataclasses.fields(obj) if f.init})
    return obj


def from_jax_arrays(fields: Dict[str, np.ndarray], device) -> ClusterArrays:
    return ClusterArrays.from_numpy({k: np.asarray(x) for k, x in fields.items()}, device)


def from_jax_meta(meta) -> EncodingMeta:
    """The port's EncodingMeta from the JAX package's, class index included
    (the vocabularies stay behind: nothing on the port's path reads them)."""
    pc = getattr(meta, "pod_class", None)
    first = getattr(meta, "class_first_pod", None)
    return EncodingMeta(
        node_names=list(meta.node_names),
        pod_names=list(meta.pod_names),
        pod_perm=np.asarray(meta.pod_perm),
        resources=list(meta.resources),
        resource_scale=np.asarray(meta.resource_scale),
        label_vocab=None,
        taint_vocab=None,
        n_nodes=int(meta.n_nodes),
        n_pods=int(meta.n_pods),
        pod_class=None if pc is None else np.asarray(pc, dtype=np.int32),
        class_first_pod=None if first is None else np.asarray(first, dtype=np.int64),
        n_classes=int(getattr(meta, "n_classes", 0) or (0 if first is None else len(first))),
    )
