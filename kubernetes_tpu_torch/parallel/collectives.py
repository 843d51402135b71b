"""The collectives of the node mesh -- the port's counterparts of the JAX
package's ``lax.all_gather`` (tiled), ``lax.ppermute`` and ``lax.all_to_all``
inside its ``shard_map`` programs.

The port runs one process that holds every shard (``parallel/mesh.py`` --
``NodeMesh``), as JAX's single controller does, so a sharded array is a
list of per-shard tensors, shard ``s`` on ``mesh.devices[s]``.  Each
collective below is one function over such lists.  Each is data movement
only, as NCCL's collectives are: a copy of every shard's block into its
destination -- on one card a device-to-device copy, across cards a peer
copy -- queued on the destination's current stream.  Nothing else in the
port moves data between shards.

``pmax``, ``pmin`` and ``psum`` are the reductions of ``lax.pmax``,
``lax.pmin`` and ``lax.psum``: the per-shard partials combined in shard
order, the result left on every shard's device (JAX replicates it).  They
are the plain versions of what the shard modes of kernels K2, K11 and K12
(csrc/fit_scan.cu, full_scan.cu, rounds.cu) do through their exchange
buffer, and run on the CPU path and in the tests.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch


def all_gather_nodes(blocks: Sequence[torch.Tensor], dim: int, device) -> torch.Tensor:
    """The tiled all_gather: the per-shard blocks laid end to end along
    `dim` in shard order, in one new tensor on `device` (the JAX package's
    ``lax.all_gather(x, axis, axis=dim, tiled=True)``; every shard holds the
    same result there, here the caller names the device that keeps it)."""
    dev = torch.device(device)
    shape = list(blocks[0].shape)
    shape[dim] = sum(b.shape[dim] for b in blocks)
    out = torch.empty(shape, dtype=blocks[0].dtype, device=dev)
    o = 0
    for b in blocks:
        w = b.shape[dim]
        out.narrow(dim, o, w).copy_(b, non_blocking=True)
        o += w
    return out


def ppermute(blocks: Sequence[torch.Tensor], perm: Sequence[Tuple[int, int]],
             devices: Sequence) -> List[torch.Tensor]:
    """``lax.ppermute``: for each (src, dst) of `perm`, shard dst receives a
    copy of shard src's block, on its own device.  A shard no pair sends to
    receives zeros, as in JAX."""
    out: List = [None] * len(blocks)
    for src, dst in perm:
        b = blocks[src]
        out[dst] = torch.empty(b.shape, dtype=b.dtype, device=torch.device(devices[dst]))
        out[dst].copy_(b, non_blocking=True)
    for j, b in enumerate(out):
        if b is None:
            out[j] = torch.zeros(blocks[j].shape, dtype=blocks[j].dtype, device=torch.device(devices[j]))
    return out


def all_to_all(blocks: Sequence[torch.Tensor], split_dim: int, concat_dim: int,
               devices: Sequence) -> List[torch.Tensor]:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    every shard's block is cut into d equal parts along `split_dim`; shard j
    receives part j of every shard, laid end to end along `concat_dim` in
    shard order, on its own device."""
    d = len(blocks)
    if blocks[0].shape[split_dim] % d:
        raise ValueError(f"all_to_all: axis {split_dim} of {tuple(blocks[0].shape)} does not divide into {d}")
    w = blocks[0].shape[split_dim] // d
    return [all_gather_nodes([b.narrow(split_dim, j * w, w) for b in blocks], concat_dim, devices[j])
            for j in range(d)]


def _reduce(parts: Sequence[torch.Tensor], op: Callable) -> List[torch.Tensor]:
    """The partials combined in shard order with `op`, one copy of the
    result on each shard's device."""
    acc = parts[0]
    for x in parts[1:]:
        acc = op(acc, x.to(acc.device, non_blocking=True))
    return [acc if x.device == acc.device else acc.to(x.device, non_blocking=True) for x in parts]


def pmax(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``lax.pmax``: the elementwise max of the per-shard tensors."""
    return _reduce(parts, torch.maximum)


def pmin(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``lax.pmin``: the elementwise min of the per-shard tensors."""
    return _reduce(parts, torch.minimum)


def psum(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """``lax.psum``: the elementwise sum of the per-shard tensors, added in
    shard order."""
    return _reduce(parts, torch.add)
