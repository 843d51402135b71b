"""The collectives of the node mesh and the pods x nodes grid -- the port's
counterparts of the JAX package's ``lax.all_gather`` (tiled),
``lax.ppermute``, ``lax.all_to_all``, ``lax.pmax``, ``lax.pmin`` and
``lax.psum`` inside its ``shard_map`` programs.

A sharded array is a list of per-shard tensors, shard ``s`` on
``mesh.devices[s]`` (``parallel/mesh.py``).  In one process, which holds
every shard as JAX's single controller does, each collective is data
movement only, as NCCL's collectives are: a copy of every shard's block
into its destination -- on one card a device-to-device copy, across cards
a peer copy -- queued on the destination's current stream.  Nothing else in
the port moves data between shards or grid positions.

ACROSS RANKS (``span``, a ``RankSpan``: the mesh was built by
``mesh.init_distributed``).  Each process then holds only its own shards,
rank r the r-th run of them in global shard order, every rank the same
number; the lists handed in are the local ones.  Each collective first
exchanges through the process group with the list form of
``torch.distributed.all_gather`` (every rank's block in rank order, which
is global shard order), then proceeds as in one process over the global
list.  The reductions never call ``all_reduce``: the order in which a
backend adds is its own, and f32 sums would drift from the one-process
result.  The exchange carries raw bytes, so every dtype goes through any
backend.  With ``gloo`` a CUDA tensor is staged through host memory
explicitly (a copy to the host, the exchange, a copy back); ``nccl``
exchanges on the card.  ``RankSpan.stats`` counts the exchanges, their
bytes, the staged bytes and their host seconds (the wait for the other
ranks included).

``pmax``, ``pmin`` and ``psum`` combine the per-shard partials in shard
order and leave the result on every local shard's device (JAX replicates
it).  They are the plain versions of what the shard modes of kernels K2,
K11 and K12 (csrc/fit_scan.cu, full_scan.cu, rounds.cu) do across one
card's thread-block clusters, and run on the CPU path, in the tests and
across ranks.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class RankSpan:
    """The ranks a mesh is spread over: this process is `rank` of `world`,
    exchanging through the default process group of `backend`.  ``stats``
    is this process's count of exchanges (calls, bytes, staged_bytes,
    seconds)."""

    rank: int
    world: int
    backend: str
    stats: dict = dataclasses.field(default_factory=lambda: dict(calls=0, bytes=0, staged_bytes=0, seconds=0.0),
                                    compare=False, hash=False, repr=False)

    def ids(self, k: int) -> range:
        """The global ids of this rank's k shards (every rank holds k)."""
        return range(self.rank * k, (self.rank + 1) * k)


def shard_ids(k: int, span: Optional[RankSpan] = None) -> range:
    """The global ids of a local list of k shards: range(k) in one process."""
    return range(k) if span is None else span.ids(k)


def from_ranks(x: torch.Tensor, span: RankSpan) -> List[torch.Tensor]:
    """Every rank's `x` (the same shape and dtype on each), in rank order,
    on x's device: ``dist.all_gather`` of its bytes.  gloo with a CUDA
    tensor: staged through host memory."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    raw = x.contiguous().reshape(-1).view(torch.uint8)
    staged = span.backend == "gloo" and raw.device.type == "cuda"
    src = raw.cpu() if staged else raw
    parts = [torch.empty_like(src) for _ in range(span.world)]
    dist.all_gather(parts, src)
    out = [p.to(x.device).view(x.dtype).reshape(x.shape) for p in parts]
    st = span.stats
    st["calls"] += 1
    st["bytes"] += raw.numel() * span.world
    st["staged_bytes"] += (raw.numel() * (span.world + 1)) if staged else 0
    st["seconds"] += time.perf_counter() - t0
    return out


def all_gather_nodes(blocks: Sequence[torch.Tensor], dim: int, device,
                     span: Optional[RankSpan] = None) -> torch.Tensor:
    """The tiled all_gather: the per-shard blocks laid end to end along
    `dim` in shard order, in one new tensor on `device` (the JAX package's
    ``lax.all_gather(x, axis, axis=dim, tiled=True)``; every shard holds the
    same result there, here the caller names the device that keeps it).
    `dim` is the node axis of the blocks, or on a pods x nodes grid their
    pod axis (ops/assign.py -- pod_unshard).  Across ranks, every rank's
    local blocks are exchanged laid end to end, then laid in rank order."""
    dev = torch.device(device)
    if span is not None:
        local = all_gather_nodes(blocks, dim, dev)
        return torch.cat(from_ranks(local, span), dim=dim)
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
    receives zeros, as in JAX.  One process only (the ring layer's)."""
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
    shard order, on its own device.  One process only (the ring layer's)."""
    d = len(blocks)
    if blocks[0].shape[split_dim] % d:
        raise ValueError(f"all_to_all: axis {split_dim} of {tuple(blocks[0].shape)} does not divide into {d}")
    w = blocks[0].shape[split_dim] // d
    return [all_gather_nodes([b.narrow(split_dim, j * w, w) for b in blocks], concat_dim, devices[j])
            for j in range(d)]


def _reduce(parts: Sequence[torch.Tensor], op: Callable, span: Optional[RankSpan]) -> List[torch.Tensor]:
    """The partials combined in global shard order with `op`, one copy of
    the result on each local shard's device."""
    every = parts
    if span is not None:
        dev = parts[0].device
        local = torch.stack([x.to(dev) for x in parts])
        every = [x for block in from_ranks(local, span) for x in block.unbind(0)]
    acc = every[0]
    for x in every[1:]:
        acc = op(acc, x.to(acc.device, non_blocking=True))
    return [acc if x.device == acc.device else acc.to(x.device, non_blocking=True) for x in parts]


def pmax(parts: Sequence[torch.Tensor], span: Optional[RankSpan] = None) -> List[torch.Tensor]:
    """``lax.pmax``: the elementwise max of the per-shard tensors."""
    return _reduce(parts, torch.maximum, span)


def pmin(parts: Sequence[torch.Tensor], span: Optional[RankSpan] = None) -> List[torch.Tensor]:
    """``lax.pmin``: the elementwise min of the per-shard tensors."""
    return _reduce(parts, torch.minimum, span)


def psum(parts: Sequence[torch.Tensor], span: Optional[RankSpan] = None) -> List[torch.Tensor]:
    """``lax.psum``: the elementwise sum of the per-shard tensors, added in
    shard order."""
    return _reduce(parts, torch.add, span)
