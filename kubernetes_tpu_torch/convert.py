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
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .api.snapshot import ClusterArrays, EncodingMeta


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
