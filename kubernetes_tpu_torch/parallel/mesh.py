"""The 1-D node mesh -- the port of the JAX package's ``parallel/mesh.py``.

The scale axis is the node count: every [*, N] array is cut into S equal
row blocks of ``nl = N / S`` nodes, one per shard, and shard ``s`` owns the
global node ids ``[s * nl, (s + 1) * nl)``.  A node count S does not divide
is first padded with permanently invalid nodes (``pad_nodes``: zero
capacity, ``node_valid`` False, the "key absent" domain), as the JAX
package pads, so decisions do not move.

The port keeps JAX's single-controller model: one process holds the mesh
and every shard's tensors, shard ``s`` on ``mesh.devices[s]``.  On the
card's machine, which has one H100, every shard sits on ``cuda:0`` (the
mesh's ``repr`` says "4 shards on 1 card"); a machine with more cards
takes them in turn.  A mesh on the CPU is built only when the caller says
so (``devices="cpu"``), as the tests do.  Data moves between shards only
through ``parallel/collectives.py``.

``ShardedArrays`` is a ``ClusterArrays`` placed on a mesh: one
``ClusterArrays`` per shard whose node-axis fields are that shard's rows
and whose pod-axis and vocabulary fields are the whole (replicated) arrays.
``api/delta.py`` -- ``DeltaEncoder(mesh=)`` builds it with each node-axis
field resident per shard; ``shard_arrays`` builds it from arrays on one
device.

Only the 1-D node axis is ported: a 2-D pods x nodes request parses
(``meshreq.py``) and is refused here (ROADMAP.md queue A12).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..api.snapshot import ClusterArrays
from ..meshreq import parse_mesh_request
from .collectives import all_gather_nodes
from .partition_rules import NODE_AXIS_FIELDS, node_axis_of

_A12 = "ROADMAP.md queue A12"


@dataclasses.dataclass(frozen=True)
class NodeMesh:
    """S node shards, shard s on ``devices[s]`` (several shards may share a
    device)."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    def nl(self, n: int) -> int:
        """Nodes per shard of an axis of `n` nodes (after padding)."""
        return -(-int(n) // self.size)

    def base(self, s: int, n: int) -> int:
        """The first global node id shard `s` owns on an axis of `n` nodes."""
        return s * self.nl(n)

    def __repr__(self) -> str:
        kinds = {d.type for d in self.devices}
        k = len(set(self.devices))
        unit = "card" if kinds == {"cuda"} else "device"
        return f"NodeMesh({self.size} shards on {k} {unit}{'s' if k != 1 else ''})"


def _cards() -> List[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _device_list(devices) -> List[torch.device]:
    if devices is None:
        cards = _cards()
        if not cards:
            raise RuntimeError("no CUDA device: a node mesh sits on the cards unless the caller passes "
                               "devices='cpu'")
        return cards
    if isinstance(devices, (str, torch.device)):
        return [torch.device(devices)]
    return [torch.device(d) for d in devices]


def make_mesh(n_devices: Optional[int] = None, devices=None,
              shape: Optional[Tuple[int, int]] = None) -> NodeMesh:
    """A mesh of `n_devices` node shards, placed on `devices` in turn (the
    visible cards when None; ``"cpu"`` for a CPU mesh).  Without
    `n_devices`, one shard per device.  ``shape=(pods, nodes)`` with pods > 1
    is the 2-D grid, which is not ported."""
    if shape is not None:
        p, n = int(shape[0]), int(shape[1])
        if p > 1:
            raise NotImplementedError(
                f"a 2-D pods x nodes mesh ({p}x{n}) is not ported to kubernetes_tpu_torch ({_A12}); "
                "the port builds the 1-D node mesh")
        n_devices = n
    devs = _device_list(devices)
    n = len(devs) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a node mesh needs at least one shard, got {n}")
    return NodeMesh(tuple(devs[i % len(devs)] for i in range(n)))


def mesh_from_env(raw: Optional[str] = None, source: str = "KTPU_MESH", devices=None) -> Optional[NodeMesh]:
    """``KTPU_MESH=<n>``: the node mesh of n shards on `devices` (the visible
    cards when None).  Unset / 1 / 0 -> None (the single-device path).  An
    invalid value raises ValueError, as in the JAX package.  The JAX package
    clamps a request to its device count, one shard per device; the port's
    shards share devices in turn, so it builds the n shards asked for.  A 2-D
    request parses and is refused."""
    req = parse_mesh_request(raw, source=source)
    if req is None:
        return None
    if isinstance(req, tuple):
        return make_mesh(shape=req, devices=devices)
    if req <= 1:
        return None
    return make_mesh(req, devices=devices)


def mesh_axis_shards(mesh) -> Tuple[int, int]:
    """(pod_shards, node_shards) of a mesh; (1, 1) for None."""
    if mesh is None:
        return (1, 1)
    return (1, int(mesh.size))


def pad_field(name: str, a, pad: int, d_sentinel: int, n: int):
    """Pad one ClusterArrays field's node axis by `pad` entries (numpy or
    torch), or return it untouched when it carries no node axis: the fills
    of partition_rules.NODE_AXIS_FIELDS (None: the domain sentinel), and a
    real [P, N] image_score with zeros."""
    axis = node_axis_of(name, tuple(a.shape), n)
    if axis is None or not pad:
        return a
    fill = NODE_AXIS_FIELDS[name][1] if name in NODE_AXIS_FIELDS else 0
    if fill is None:
        fill = d_sentinel
    if isinstance(a, torch.Tensor):
        shape = list(a.shape)
        shape[axis] = pad
        return torch.cat([a, torch.full(shape, fill, dtype=a.dtype, device=a.device)], dim=axis)
    a = np.asarray(a)
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, pad)
    return np.pad(a, widths, constant_values=fill)


def pad_nodes(arr, n_shards: int):
    """Pad the node axis of a ClusterArrays to a multiple of `n_shards` with
    permanently invalid nodes -> (arr, original N); the input comes back
    untouched when already divisible (the JAX package's pad_nodes, :173)."""
    n = arr.N
    pad = (-n) % n_shards
    if pad == 0:
        return arr, n
    d_sentinel = arr.term_counts0.shape[1] - 1
    repl = {name: pad_field(name, getattr(arr, name), pad, d_sentinel, n)
            for name in (*NODE_AXIS_FIELDS, "image_score")}
    return dataclasses.replace(arr, **repl), n


@dataclasses.dataclass
class ShardedArrays:
    """A ClusterArrays on a node mesh: ``shards[s]`` holds shard s's rows of
    every node-axis field and the whole pod-axis and vocabulary fields, all
    on ``mesh.devices[s]``.  The node axis is padded: N = S * nl.
    ``image_sharded``: whether image_score is a real [P, N] plane (cut per
    shard) or the [P, 1] broadcast form, decided at global shape (a
    shard's width may equal 1; the JAX package's image_sharded)."""

    mesh: NodeMesh
    shards: Tuple[ClusterArrays, ...]
    image_sharded: bool = False

    @property
    def P(self) -> int:
        return self.shards[0].P

    @property
    def nl(self) -> int:
        return self.shards[0].N

    @property
    def N(self) -> int:
        return self.nl * self.mesh.size

    @property
    def device(self) -> torch.device:
        return self.mesh.devices[0]

    def gather(self, name: str) -> torch.Tensor:
        """The whole of node-axis field `name` on ``mesh.devices[0]``: the
        tiled all_gather of its shard blocks."""
        axis = node_axis_of(name, tuple(getattr(self.shards[0], name).shape), self.nl)
        return all_gather_nodes([getattr(sh, name) for sh in self.shards], axis, self.device)

    def pod_prefix(self, k: int) -> "ShardedArrays":
        """The first k pods on every shard (ClusterArrays.pod_prefix)."""
        return dataclasses.replace(self, shards=tuple(sh.pod_prefix(k) for sh in self.shards))

    def replace_pods(self, **fields) -> "ShardedArrays":
        """The arrays with replicated (pod-axis) fields replaced on every
        shard, one copy per device (the gang fixpoint's pod_valid)."""
        for name in fields:
            if node_axis_of(name, tuple(getattr(self.shards[0], name).shape), self.nl) is not None:
                raise ValueError(f"{name} carries the node axis: replace it per shard")
        placed: Dict[torch.device, Dict[str, torch.Tensor]] = {}
        shards = []
        for sh, dev in zip(self.shards, self.mesh.devices):
            if dev not in placed:
                placed[dev] = {k: v.to(dev) for k, v in fields.items()}
            shards.append(dataclasses.replace(sh, **placed[dev]))
        return dataclasses.replace(self, shards=tuple(shards))

    def commit_view(self) -> ClusterArrays:
        """The arrays the chunked route's commit kernels read, on
        ``mesh.devices[0]``: the pod rows and the usage and capacity
        gathered whole (the JAX package gathers node_alloc and node_used
        once and carries them replicated, ops/assign.py:946-956).  Those
        kernels read no other node-axis field, so every other one is cut to
        zero nodes: a reader of one fails on its shape instead of reading
        shard 0's rows as the whole."""
        sh = self.shards[0]
        cut = {}
        for name in sh.FIELDS:
            a = getattr(sh, name)
            axis = node_axis_of(name, tuple(a.shape), self.nl)
            if axis is not None:
                cut[name] = a.narrow(axis, 0, 0)
        cut.update(node_alloc=self.gather("node_alloc"), node_used=self.gather("node_used"))
        return dataclasses.replace(sh, **cut)


def shard_arrays(arr: ClusterArrays, mesh: NodeMesh) -> ShardedArrays:
    """Place arrays held on one device on `mesh`: pad the node axis
    (pad_nodes), give shard s its rows of every node-axis field and a copy
    of every other field on its device (one copy per device)."""
    image_sharded = arr.image_score.shape[1] == arr.N
    arr, _ = pad_nodes(arr, mesh.size)
    nl = mesh.nl(arr.N)
    rep: Dict[torch.device, Dict[str, torch.Tensor]] = {}
    shards = []
    for s, dev in enumerate(mesh.devices):
        if dev not in rep:
            rep[dev] = {f: getattr(arr, f).to(dev) for f in arr.FIELDS
                        if node_axis_of(f, tuple(getattr(arr, f).shape), arr.N) is None}
        fields = dict(rep[dev])
        for f in arr.FIELDS:
            if f in fields:
                continue
            a = getattr(arr, f)
            axis = node_axis_of(f, tuple(a.shape), arr.N)
            fields[f] = a.narrow(axis, s * nl, nl).contiguous().to(dev)
        shards.append(ClusterArrays(**fields))
    return ShardedArrays(mesh, tuple(shards), image_sharded)


def shard_hbm_estimate(n_pods: int, n_nodes: int, n_shards: int, n_res: int = 4,
                       u_classes: Optional[int] = None) -> Dict[str, int]:
    """Per-shard device bytes of the node-axis terms of the chunked route
    on the mesh (the JAX package's shard_hbm_estimate, :238, node axis
    only): the shard's packed static rows [P, words(nl)] (dense mode), its
    node-axis usage and capacity rows, and with class state its class
    planes (packed stat and fit [U1, words(nl)], f32 base [U1, nl]).  The
    stitched planes and the gathered usage live once, on the device that
    keeps the commit (``stitched``)."""
    nl = -(-n_nodes // n_shards)
    n = nl * n_shards
    wl = -(-nl // 32)
    w = -(-n // 32)
    b = {
        "static_rows": 4 * n_pods * wl,
        "node_rows": 2 * 4 * nl * n_res + 2 * nl,
    }
    stitched = 4 * n_pods * w + 2 * 4 * n * n_res
    if u_classes:
        b["class_planes"] = u_classes * (2 * 4 * wl + 4 * nl)
        stitched += u_classes * (2 * 4 * w + 4 * n)
    b["stitched"] = stitched
    b["total"] = sum(b.values())
    return b


__all__ = [
    "NodeMesh", "ShardedArrays", "make_mesh", "mesh_axis_shards", "mesh_from_env",
    "pad_field", "pad_nodes", "shard_arrays", "shard_hbm_estimate",
]
