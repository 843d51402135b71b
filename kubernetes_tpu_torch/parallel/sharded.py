"""The routed scheduling step on the node mesh -- the port of the JAX
package's ``parallel/sharded.py`` (``sharded_schedule_batch_routed``, :188)
for its chunked route, in both modes.

The node axis of every [*, N] array is cut into S shard blocks
(parallel/mesh.py); the expensive node-axis work runs per shard over its
own block, and the commit runs once on stitched values, so decisions are
the single-device route's by construction (the JAX package's contract,
ops/assign.py:936-1010):

- dense mode (no class state): kernel K7 ``packed_static_rows`` launches
  once per shard over its rows, with the shard's first global node id
  ``base`` (a nodeName pin is a global id), and writes the shard's packed
  static rows [P, words(nl)]; the tiled all_gather of the blocks
  (parallel/collectives.py) and kernel K17 ``stitch_planes`` make the flat
  plane [P, words(N)], and kernel K8 ``chunk_rounds_dense`` runs on it with
  the usage and capacity gathered whole (the JAX package gathers them once
  and carries them replicated);
- class state (``inc`` from ``HoistCache(mesh=)``, ops/incremental.py):
  the class planes were hoisted per shard (K3, K4) and stitched once per
  cycle (K17 for the packed planes, the all_gather for the f32 base); K5
  ``wave_commit`` and K6 ``chunk_rounds`` run on them.

ORDER OF THE STITCH.  The JAX package hoists each chunk's scores [C, Nl]
shard-locally and all_gathers the masked [C, N] total0 per chunk.  On one
card the port stitches the static plane first and lets K8 hoist each chunk
over all N.  Both are the same elementwise arithmetic per (pod, node), so
the scores are the same bits.  A form across cards would gather per chunk,
as JAX does, to keep the hoist where the node rows live.

The usage comes back on the padded node axis; its pad rows are zero (the
JAX package's sharded.py:188 docstring).  ``TRACE_COUNTS`` counts
``sharded_chunked`` and ``sharded_chunked_inc``.

Only the chunked route is ported to the mesh.  A batch it does not take
(the rounds route, the per-pod route, ``chunked=False``) raises
NotImplementedError naming ROADMAP.md queue A12; it never runs quietly on
one shard.
"""

from __future__ import annotations

import torch

from ..ops import assign, bitplane
from ..ops.assign import Step, TRACE_COUNTS
from .collectives import all_gather_nodes
from .mesh import NodeMesh, ShardedArrays, shard_arrays

_A12 = "ROADMAP.md queue A12"


def static_rows(sa: ShardedArrays) -> torch.Tensor:
    """The flat packed static plane [P, words(N)] of arrays on the mesh: K7
    per shard over its rows (with its base), the tiled all_gather, K17 (on
    the CPU their plain versions)."""
    blocks = [assign.packed_static_rows(sh, base=sa.mesh.base(s, sa.N)) for s, sh in enumerate(sa.shards)]
    return bitplane.stitch_planes(all_gather_nodes(blocks, 1, sa.device), sa.nl)


def sharded_dispatch(arr, cfg, mesh: NodeMesh, device, inc=None, chunked=None, **knobs) -> Step:
    """Route and launch one step on `mesh` (ops/assign.py -- dispatch with
    mesh=): `arr` is a ShardedArrays on the mesh, or a ClusterArrays, which
    is padded and placed first (shard_arrays).  With applicable class state
    the class-wave route, else the dense chunked route; anything else
    raises."""
    sa = arr if isinstance(arr, ShardedArrays) else shard_arrays(arr, mesh)
    if sa.mesh != mesh:
        raise ValueError(f"arrays placed on {sa.mesh}, step asked on {mesh}")
    if sa.device.type != device.type:
        raise ValueError(f"arrays on the mesh's {sa.device}, step asked on {device}")
    if chunked is False or not assign._chunkable(sa.shards[0], cfg):
        raise NotImplementedError(
            "on a node mesh kubernetes_tpu_torch runs the chunked route only (a fit-only batch of a multiple of "
            f"{assign.CHUNK} pods); the sharded rounds and per-pod routes are not ported ({_A12})")
    cv = sa.commit_view()
    inc = assign.inc_applicable(cv, cfg, inc)
    if inc is not None:
        TRACE_COUNTS["sharded_chunked_inc"] += 1
        return Step(*assign.chunked_inc(cv, cfg, inc, **knobs))
    TRACE_COUNTS["sharded_chunked"] += 1
    sfs = static_rows(sa)
    if cv.device.type != "cpu":
        from ..ops import kernels

        return Step(*kernels.chunk_rounds_dense(cv, cfg, sfs))
    return Step(*assign.schedule_scan_chunked_dense_plain(cv, cfg, sfs))


def sharded_schedule_batch_routed(arr, cfg, mesh: NodeMesh, device=None, with_ordinals: bool = False, inc=None,
                                  **knobs):
    """The JAX package's sharded_schedule_batch_routed: -> (choices, used)
    or, with `with_ordinals`, (choices, used, ordinals, sweeps), used on the
    padded node axis; the step's status is read (ops/assign.py -- finish)."""
    step = assign.finish(assign.dispatch(arr, cfg, device, inc, mesh=mesh, **knobs))
    return tuple(step) if with_ordinals else tuple(step[:2])


__all__ = ["sharded_dispatch", "sharded_schedule_batch_routed", "static_rows"]
