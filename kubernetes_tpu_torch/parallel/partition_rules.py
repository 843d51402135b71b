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

The size model (the JAX package's :60, :174-186, :190-239, :361-458):
``FIELD_DIMS`` (qualname -> dims symbols, bits per element), ``field_bytes``,
``sharded_on_nodes`` / ``sharded_on_pods``, ``node_axis_fields`` /
``pod_axis_fields`` and ``resident_input_bytes``, which the memory ledger
(scheduler/memwatch.py) and a benchmark's budget read.  Departures: the port
keeps ``node_labels`` and ``sel_mask`` as bool (8 bits; the JAX package's
are f32 matmul operands, 32), always packs its mask planes (the JAX
``KTPU_PACK_MASKS`` escape hatch is not read, so ``_plane_bits`` keys on
``KTPU_SCORE_DTYPE`` alone), and the HoistCache's memoized class-row index
``hoist.r_u`` (int64 [U1]) is resident in the port alone.  Which axes a
field shards on comes from the rows above, not from a spec table: the
PartitionSpec half (``spec_for``, ``sharding_for``, ...) is not ported.
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


# --------------------------------------------------------------------------
# the analytic size model
# --------------------------------------------------------------------------

NODE_AXIS = "nodes"
PODS_AXIS = "pods"

# scale-dimension symbols (grow with the cluster) and their target sizes,
# the canonical vocabulary sizes filling every other symbol (the JAX
# package's :60-76)
SCALE_SYMBOLS = ("P", "N", "U")
SCALE_DIMS: Dict[str, int] = {"P": 500_000, "N": 100_000, "U": 1_024}
CANONICAL_DIMS: Dict[str, int] = {
    "R": 4, "T": 8, "L": 16, "TT": 2, "PW": 2, "T2": 8, "MM": 2,
    "A1": 1, "A2": 1, "B": 2, "C": 2, "PT": 4, "S": 32, "E": 4,
    "D1": 64, "K": 4, "G": 64,
}


def _plane_bits() -> Tuple[int, int]:
    """(bits of a mask element, bits of a score element): masks are always
    bit-packed (1); scores bf16 (16) or f32 under KTPU_SCORE_DTYPE=f32."""
    from ..ops import bitplane

    return 1, (16 if bitplane.SCORE_DTYPE == "bf16" else 32)


_MASK_BITS, _SCORE_BITS = _plane_bits()

# qualname -> (dims symbols, bits per element): every ClusterArrays field,
# every IncState field, and the HoistCache's resident index
FIELD_DIMS: Dict[str, Tuple[Tuple[str, ...], int]] = {
    "arr.node_valid": (("N",), 8),
    "arr.node_alloc": (("N", "R"), 32),
    "arr.node_used": (("N", "R"), 32),
    "arr.node_unsched": (("N",), 8),
    "arr.node_labels": (("N", "L"), 8),
    "arr.node_taint_ns": (("N", "T"), 8),
    "arr.node_taint_pref": (("N", "T"), 8),
    "arr.node_dom": (("K", "N"), 32),
    "arr.node_ports0": (("N", "PT"), 8),
    "arr.pod_valid": (("P",), 8),
    "arr.pod_req": (("P", "R"), 32),
    "arr.pod_prio": (("P",), 32),
    "arr.pod_tol_ns": (("P", "T"), 8),
    "arr.pod_tol_pref": (("P", "T"), 8),
    "arr.pod_nodename": (("P",), 32),
    "arr.pod_terms": (("P", "TT"), 32),
    "arr.pod_has_sel": (("P",), 8),
    "arr.sel_mask": (("S", "E", "L"), 8),
    "arr.sel_kind": (("S", "E"), 32),
    "arr.pod_pref_terms": (("P", "PW"), 32),
    "arr.pod_pref_weights": (("P", "PW"), 32),
    "arr.term_key": (("T2",), 32),
    "arr.m_pend": (("T2", "P"), 32),
    "arr.pod_match_terms": (("P", "MM"), 32),
    "arr.pod_match_vals": (("P", "MM"), 32),
    "arr.pod_aff_self": (("P", "A1"), 8),
    "arr.term_counts0": (("T2", "D1"), 32),
    "arr.anti_counts0": (("T2", "D1"), 32),
    "arr.pod_aff_terms": (("P", "A1"), 32),
    "arr.pod_anti_terms": (("P", "A2"), 32),
    "arr.pod_pref_aff_terms": (("P", "B"), 32),
    "arr.pod_pref_aff_w": (("P", "B"), 32),
    "arr.pref_own0": (("T2", "D1"), 32),
    "arr.pod_spread_terms": (("P", "C"), 32),
    "arr.pod_spread_maxskew": (("P", "C"), 32),
    "arr.pod_spread_hard": (("P", "C"), 8),
    "arr.pod_ports": (("P", "PT"), 8),
    "arr.pod_group": (("P",), 32),
    "arr.group_min": (("G",), 32),
    "arr.image_score": (("P", "N"), _SCORE_BITS),
    "inc.cls": (("P",), 32),
    "inc.req_u": (("U", "R"), 32),
    "inc.stat_u": (("U", "N"), _MASK_BITS),
    "inc.base_u": (("U", "N"), 32),
    "inc.fit_u": (("U", "N"), _MASK_BITS),
    "inc.elig_u": (("U", "N"), _MASK_BITS),
    "inc.traw_u": (("U", "N"), _SCORE_BITS),
    "inc.naraw_u": (("U", "N"), _SCORE_BITS),
    "inc.img_u": (("U", "N"), _SCORE_BITS),
    "hoist.r_u": (("U",), 64),
}


def _axes(qualname: str) -> Dict[str, int]:
    """mesh axis -> the dim index of `qualname` it shards (the JAX table's
    spec for the row, from the rows above)."""
    kind, _, name = qualname.partition(".")
    if qualname == "arr.image_score":
        return {PODS_AXIS: 0, NODE_AXIS: 1}
    out: Dict[str, int] = {}
    if kind == "arr":
        if name in NODE_AXIS_FIELDS:
            out[NODE_AXIS] = NODE_AXIS_FIELDS[name][0]
        if name in POD_AXIS_FIELDS:
            out[PODS_AXIS] = POD_AXIS_FIELDS[name][0]
    elif kind == "inc":
        if name == "cls":
            out[PODS_AXIS] = 0
        elif name in INC_NODE_AXIS:
            out[NODE_AXIS] = INC_NODE_AXIS[name]
    return out


def sharded_on_nodes(qualname: str) -> bool:
    FIELD_DIMS[qualname]  # fail closed on a qualname outside the model
    return NODE_AXIS in _axes(qualname)


def sharded_on_pods(qualname: str) -> bool:
    FIELD_DIMS[qualname]
    return PODS_AXIS in _axes(qualname)


def node_axis_fields() -> Dict[str, Tuple[int, Optional[int]]]:
    """field name -> (node axis, pad fill): NODE_AXIS_FIELDS (image_score
    excluded, as in the JAX package's :361)."""
    return dict(NODE_AXIS_FIELDS)


def pod_axis_fields() -> Dict[str, Tuple[int, int]]:
    """field name -> (pod axis, pad fill 0): POD_AXIS_FIELDS (image_score
    excluded, the JAX package's :382)."""
    return dict(POD_AXIS_FIELDS)


def field_bytes(qualname: str, dims_env: Optional[Dict[str, int]] = None, n_shards: int = 1,
                pod_shards: int = 1) -> int:
    """Analytic PER-SHARD bytes of one resident field under `dims_env`
    (symbol -> size; CANONICAL_DIMS and SCALE_DIMS fill the gaps): a dim on
    a sharded axis divides by that axis's shard count (``n_shards`` the
    node axis, ``pod_shards`` the pod axis), every dim is at least 1; a
    bit-packed row (bits 1) prices its last axis as ceil(size / 32) 32-bit
    words (the JAX package's :407)."""
    dims, bits = FIELD_DIMS[qualname]
    env = dict(CANONICAL_DIMS)
    env.update(SCALE_DIMS)
    if dims_env:
        env.update(dims_env)
    div = {NODE_AXIS: max(1, n_shards), PODS_AXIS: max(1, pod_shards)}
    axis_of = {i: ax for ax, i in _axes(qualname).items()}
    sizes = []
    for i, sym in enumerate(dims):
        size = env[sym]
        if i in axis_of:
            size = -(-size // div[axis_of[i]])
        sizes.append(max(1, size))
    if bits < 8:
        total = 4 * (-(-sizes[-1] // 32))
        for size in sizes[:-1]:
            total *= size
        return total
    total = bits // 8
    for size in sizes:
        total *= size
    return total


def resident_input_bytes(n_pods: int, n_nodes: int, n_shards: int, n_res: int = 4, n_terms: int = 1,
                         u_classes: Optional[int] = None, image_sharded: bool = False, pod_shards: int = 1) -> int:
    """Per-shard bytes of the resident input set (every ``arr.*`` field,
    plus ``inc.*`` when class state rides; the JAX package's :430)."""
    env = {"P": n_pods, "N": n_nodes, "R": n_res, "T2": max(1, n_terms), "U": u_classes or 1}
    total = 0
    for q in FIELD_DIMS:
        if q.startswith("hoist."):
            continue
        if q.startswith("inc.") and not u_classes:
            continue
        if q == "arr.image_score" and not image_sharded:
            p_local = -(-max(1, n_pods) // max(1, pod_shards))
            total += (FIELD_DIMS[q][1] // 8) * p_local
            continue
        total += field_bytes(q, env, n_shards, pod_shards)
    return total
