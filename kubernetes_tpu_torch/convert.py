"""Carry the JAX package's encoded arrays across to the port.

``from_jax_arrays`` takes the JAX ``ClusterArrays`` fields as numpy arrays
(``{f.name: np.asarray(getattr(arr, f.name)) for f in dataclasses.fields(arr)}``)
and builds the port's ``ClusterArrays`` on `device`.  Tests feed the JAX
encoder's own output to the port's filters and kernels this way, so kernel
parity does not rest on encoder parity.

The fields this slice drops must hold nothing: pairwise terms and counts,
host ports and an image-score matrix would each enable a stage the port does
not have, so their presence raises instead of being lost.  PreferNoSchedule
taints and preferred node-affinity terms become the arrays' evidence flags
(ops/scores.py — infer_score_config).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .api.snapshot import ClusterArrays


def from_jax_arrays(fields: Dict[str, np.ndarray], device) -> ClusterArrays:
    f = {k: np.asarray(x) for k, x in fields.items()}
    dropped = {
        "pairwise terms": (
            np.any(f["pod_aff_terms"] >= 0) or np.any(f["pod_anti_terms"] >= 0)
            or np.any(f["pod_spread_terms"] >= 0) or np.any(f["pod_pref_aff_terms"] >= 0)
        ),
        "pairwise counts of bound pods": np.any(f["anti_counts0"] > 0) or np.any(f["pref_own0"] != 0),
        "host ports": np.any(f["pod_ports"]) or np.any(f["node_ports0"]),
        "image scores": f["image_score"].shape[1] != 1 or np.any(f["image_score"]),
    }
    present = [name for name, hit in dropped.items() if hit]
    if present:
        raise ValueError(
            "arrays carry state this slice of the port does not have: " + ", ".join(present)
        )
    return ClusterArrays.from_numpy(
        f,
        device,
        has_prefer_taints=bool(np.any(f["node_taint_pref"])),
        has_node_pref=bool(np.any(f["pod_pref_terms"] >= 0)),
    )
