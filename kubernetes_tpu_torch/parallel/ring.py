"""Ring-blockwise selector x label matching and the all-to-all reshard --
the port of the JAX package's ``parallel/ring.py``.

``ring_match`` computes bool[S, P], selector terms x entity label rows,
blockwise on the node mesh, ring-attention style: each shard keeps its S/d
selector rows resident and holds one P/d block of label rows; in each of d
hops it evaluates its rows against the block it holds (kernel K16
``ring_match``, csrc/ring_match.cu; on the CPU its plain version) and
writes that tile at the block's origin, then the blocks rotate one shard
back (``collectives.ppermute``, shard j to j - 1, as JAX's perm).  After d
hops every shard has seen every block.  The last hop's rotation, which JAX
also makes, would hand every block back to where it started, so the port
leaves it out.

``all_to_all_pods_to_nodes`` is the reshard of a pods-sharded [P, N] plane
to a node-sharded one: one ``collectives.all_to_all``, data movement only.

Inputs are f32 0/1 masks, as in JAX; the counts are exact integers (L <
2^24 labels, JAX's Precision.HIGHEST einsum).  Both functions take whole
tensors, place their blocks on the shards (the input sharding), and return
the per-shard blocks of the result: ring_match the S-sharded tiles
[S/d, P], all_to_all_pods_to_nodes the node-sharded blocks [P, N/d].
"""

from __future__ import annotations

from typing import List

import torch

from ..api import vocab as v
from .collectives import all_to_all, ppermute
from .mesh import NodeMesh


def match_block_plain(sel: torch.Tensor, kind: torch.Tensor, lab: torch.Tensor) -> torch.Tensor:
    """[Sl, E, L] selector masks with kinds [Sl, E] against label rows
    [B, L] -> bool[Sl, B]: the JAX package's ring.py:35 _eval_block with the
    count in int32 sums -- the plain version of kernel K16.  Label rows go
    in blocks, so the [Sl, E, rows, L] transient stays near 16 M entries."""
    Sl, E, L = sel.shape
    B = lab.shape[0]
    out = torch.empty((Sl, B), dtype=torch.bool, device=sel.device)
    k = kind[:, :, None]
    step = max(1, 2**24 // max(1, Sl * E * L))
    for b0 in range(0, B, step):
        both = (sel != 0)[:, :, None, :] & (lab[b0:b0 + step] != 0)[None, None, :, :]  # [Sl, E, rows, L]
        counts = both.sum(dim=3, dtype=torch.int32)
        ok = torch.where(k == v.KIND_ANY, counts > 0, torch.where(k == v.KIND_NONE, counts == 0, k == v.KIND_PAD))
        out[:, b0:b0 + step] = ok.all(dim=1)
    return out


def _match_into(out: torch.Tensor, col0: int, sel, kind, lab) -> None:
    """Write one hop's tile into columns [col0, col0 + B) of out[Sl, P]."""
    from ..ops.scopes import subphase

    with subphase("score"):
        if out.device.type == "cpu":
            out[:, col0:col0 + lab.shape[0]] = match_block_plain(sel, kind, lab)
            return
        from ..ops import kernels

        kernels.ring_match(sel, kind, lab, out=out, col0=col0)


def _blocks(x: torch.Tensor, mesh: NodeMesh) -> List[torch.Tensor]:
    if not isinstance(mesh, NodeMesh) or mesh.span is not None:
        raise NotImplementedError(f"the ring runs on a node mesh held by one process, not on {mesh} "
                                  "(ROADMAP.md queue A12)")
    d = mesh.size
    w = x.shape[0] // d
    return [x[j * w:(j + 1) * w].contiguous().to(mesh.devices[j]) for j in range(d)]


def ring_match(sel_mask: torch.Tensor, sel_kind: torch.Tensor, labels: torch.Tensor,
               mesh: NodeMesh) -> List[torch.Tensor]:
    """bool[S, P] = selectors x entity labels, blockwise on the mesh ->
    the S-sharded tiles [S/d, P], shard j's on its device.  sel_mask
    [S, E, L] and sel_kind [S, E] shard on S, labels [P, L] on P; S and P
    must be multiples of d (the JAX package's ValueError, same message)."""
    d = mesh.size
    S, P_total = sel_mask.shape[0], labels.shape[0]
    if S % d or P_total % d:
        raise ValueError(f"S={S} and P={P_total} must divide mesh size {d}")
    p_local = P_total // d
    sel_b = _blocks(sel_mask.to(torch.float32), mesh)
    kind_b = _blocks(sel_kind.to(torch.int32), mesh)
    lab_b = _blocks(labels.to(torch.float32), mesh)
    out = [torch.empty((S // d, P_total), dtype=torch.bool, device=dev) for dev in mesh.devices]
    perm = [(j, (j - 1) % d) for j in range(d)]
    for i in range(d):
        for j in range(d):
            src = (j + i) % d  # the origin shard of the block shard j holds
            _match_into(out[j], src * p_local, sel_b[j], kind_b[j], lab_b[j])
        if i < d - 1:
            lab_b = ppermute(lab_b, perm, mesh.devices)
    return out


def all_to_all_pods_to_nodes(x: torch.Tensor, mesh: NodeMesh) -> List[torch.Tensor]:
    """[P, N] sharded on the pods axis -> the same values sharded on the
    node axis: shard j's block [P, N/d] on its device, by one all_to_all
    (the JAX package's ring.py:98)."""
    d = mesh.size
    if x.shape[0] % d or x.shape[1] % d:
        raise ValueError(f"both axes of {tuple(x.shape)} must divide mesh size {d}")
    return all_to_all(_blocks(x, mesh), split_dim=1, concat_dim=0, devices=mesh.devices)


__all__ = ["all_to_all_pods_to_nodes", "match_block_plain", "ring_match"]
