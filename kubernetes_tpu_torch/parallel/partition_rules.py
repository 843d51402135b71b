"""Which arrays carry the node axis and the pod axis, and where -- the
port's copy of the JAX package's ``parallel/partition_rules.py`` reduced to
data.

The JAX package resolves every placement through a regex -> PartitionSpec
table.  The port's meshes (``parallel/mesh.py`` -- ``NodeMesh`` and the pods
x nodes ``GridMesh``) need only the facts that table encodes for the two
axes:

- ``NODE_AXIS_FIELDS``: each ``ClusterArrays`` field that carries the node
  axis, its position and the fill its padding rows take (``None``: the
  per-array "key absent" domain sentinel D).  The JAX package derives the
  same dict from its table (``node_axis_fields``, :361); image_score is left
  out there too, because only its real [P, N] form carries the node axis
  (``parallel/mesh.py`` -- ``pad_field`` takes that case).
- ``POD_AXIS_FIELDS``: each ``ClusterArrays`` field that carries the pod
  axis, its position and fill 0 (the table's pod rows, :107-141: the pod
  vectors and the pod-leading matrices on axis 0, ``m_pend`` [T2, P] on
  axis 1; the JAX package's ``pod_axis_fields``, :382).  A padded pod has
  ``pod_valid`` False, which gates it out of every stage.  image_score is
  left out here too: both its [P, N] and its [P, 1] forms carry the pod
  axis on axis 0 (``parallel/mesh.py`` -- ``pad_pod_field``), the [P, N]
  form the node axis too.  Of the class state only ``inc.cls`` [P] is
  pod-aligned (one block per pod row on a grid); the [U1, *] class planes
  are class-aligned and never cut by pods.
- ``INC_NODE_AXIS``: the ``IncState`` class planes that ``HoistCache(mesh=)``
  builds per shard and the axis each shards on (the table's ``inc.*_u``
  rows): per shard, ``stat_u`` / ``fit_u`` / ``elig_u`` are ``[U1,
  words(nl)]`` packed words and ``base_u`` / ``traw_u`` / ``naraw_u`` /
  ``img_u`` are ``[U1, nl]`` (parallel/sharded.py -- inc_applicable reads
  the table to gate a state's shapes).

The outputs of the sharded routed step come back whole, on the padded
node axis: the chunked route commits once on stitched values, the rounds
route carries the usage replicated, and the per-pod scan's per-shard
usage is gathered (the JAX table's ``out.*`` rows).

There are no PartitionSpecs: the port's shards are a list of per-shard
tensors, and the node-axis rows above say how a field is cut.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

# field -> (node axis, pad fill); fill None: the domain sentinel D
NODE_AXIS_FIELDS: Dict[str, Tuple[int, Optional[int]]] = {
    "node_valid": (0, 0),
    "node_alloc": (0, 0),
    "node_used": (0, 0),
    "node_unsched": (0, 0),
    "node_labels": (0, 0),
    "node_taint_ns": (0, 0),
    "node_taint_pref": (0, 0),
    "node_dom": (1, None),
    "node_ports0": (0, 0),
}

# field -> (pod axis, pad fill 0)
POD_AXIS_FIELDS: Dict[str, Tuple[int, int]] = {
    name: (1 if name == "m_pend" else 0, 0) for name in (
        "pod_valid", "pod_req", "pod_prio", "pod_tol_ns", "pod_tol_pref", "pod_nodename", "pod_terms",
        "pod_has_sel", "pod_pref_terms", "pod_pref_weights", "m_pend", "pod_match_terms", "pod_match_vals",
        "pod_aff_self", "pod_aff_terms", "pod_anti_terms", "pod_pref_aff_terms", "pod_pref_aff_w",
        "pod_spread_terms", "pod_spread_maxskew", "pod_spread_hard", "pod_ports", "pod_group")
}

# IncState class plane -> the axis its node dimension lies on (packed
# planes: the word axis, in per-shard blocks of words(nl))
INC_NODE_AXIS: Dict[str, int] = {"stat_u": 1, "base_u": 1, "fit_u": 1, "elig_u": 1, "traw_u": 1, "naraw_u": 1,
                                 "img_u": 1}


def node_axis_of(name: str, shape: Tuple[int, ...], n: int) -> Optional[int]:
    """The node axis of field `name` with `shape` in arrays of `n` nodes, or
    None: the table's rows, plus image_score when it is a real [P, N]
    matrix (its [P, 1] broadcast form carries no node axis)."""
    ent = NODE_AXIS_FIELDS.get(name)
    if ent is not None:
        return ent[0]
    if name == "image_score" and len(shape) == 2 and shape[1] == n:
        return 1
    return None


def pod_axis_of(name: str) -> Optional[int]:
    """The pod axis of field `name`, or None: the table's pod rows, plus
    image_score, whose [P, N] and [P, 1] forms both lead with P."""
    if name == "image_score":
        return 0
    ent = POD_AXIS_FIELDS.get(name)
    return None if ent is None else ent[0]
