"""The node mesh and the pods x nodes grid -- the port of the JAX
package's ``parallel/mesh.py``.

The scale axis is the node count: every [*, N] array is cut into S equal
row blocks of ``nl = N / S`` nodes, one per shard, and shard ``s`` owns the
global node ids ``[s * nl, (s + 1) * nl)``.  A node count S does not divide
is first padded with permanently invalid nodes (``pad_nodes``: zero
capacity, ``node_valid`` False, the "key absent" domain), as the JAX
package pads, so decisions do not move.

THE GRID (``make_mesh(shape=(p, n))``, ``GridMesh``; the JAX package's
2-D mesh, :59-77).  Position (r, s) holds node column s's block of every
node-axis field, as on the 1-D mesh, and pod row r's block of every
pod-axis field (partition_rules.POD_AXIS_FIELDS): pods ``[r * pl, (r + 1)
* pl)``, the pod axis first padded to a multiple of p with invalid pods
(``pad_pods``).  ``GridArrays`` is a ClusterArrays placed so.  The
node-axis routes run after one gather of the pod-axis fields at entry
(ops/assign.py -- pod_unshard), on one pod row, with the node-axis kernels
as they are; every row would compute the same program.

The port keeps JAX's single-controller model: one process holds the mesh
and every shard's tensors, shard ``s`` on ``mesh.devices[s]`` and grid
position (r, s) on ``devices[(r * n + s) % len(devices)]``.  On the card's
machine, which has one H100, every shard sits on ``cuda:0`` (the mesh's
``repr`` says "4 shards on 1 card"); a machine with more cards takes them
in turn.  A mesh on the CPU is built only when the caller says so
(``devices="cpu"``), as the tests do.  Data moves between shards and grid
positions only through ``parallel/collectives.py``.

ACROSS PROCESSES (``init_distributed``; the JAX package's :399-436): the
ranks of a ``torch.distributed`` process group share one mesh, each holding
only its own positions' tensors -- on a 1-D mesh a run of node shards, on
a grid whole pod rows -- and the collectives exchange through the group
(``RankSpan``).  ``global_arrays`` places each rank's blocks from the whole
host snapshot, which every rank has.

``ShardedArrays`` is a ``ClusterArrays`` placed on a node mesh: one
``ClusterArrays`` per local shard whose node-axis fields are that shard's
rows and whose pod-axis and vocabulary fields are the whole (replicated)
arrays.  ``api/delta.py`` -- ``DeltaEncoder(mesh=)`` builds it (or the
grid's ``GridArrays``) with each block resident on its device;
``shard_arrays`` / ``grid_arrays`` build them from arrays on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..api.snapshot import ClusterArrays
from ..meshreq import parse_mesh_request
from .collectives import RankSpan, all_gather_nodes, shard_ids
from .partition_rules import NODE_AXIS_FIELDS, POD_AXIS_FIELDS, node_axis_of, pod_axis_of

_A12 = "ROADMAP.md queue A12"


@dataclasses.dataclass(frozen=True)
class NodeMesh:
    """S node shards, shard s on ``devices[s]`` (several shards may share a
    device).  Across ranks (`span`), ``devices`` are this process's shards,
    global ids ``ids``, and S counts every rank's."""

    devices: Tuple[torch.device, ...]
    span: Optional[RankSpan] = None

    @property
    def size(self) -> int:
        return len(self.devices) * (1 if self.span is None else self.span.world)

    @property
    def ids(self) -> range:
        """The global ids of the shards this process holds."""
        return shard_ids(len(self.devices), self.span)

    def nl(self, n: int) -> int:
        """Nodes per shard of an axis of `n` nodes (after padding)."""
        return -(-int(n) // self.size)

    def base(self, s: int, n: int) -> int:
        """The first global node id shard `s` owns on an axis of `n` nodes."""
        return s * self.nl(n)

    def __repr__(self) -> str:
        if self.span is not None:
            return f"NodeMesh({self.size} shards over {self.span.world} ranks, {len(self.devices)} on rank " \
                   f"{self.span.rank})"
        return f"NodeMesh({self.size} shards on {_devices_text(self.devices)})"


@dataclasses.dataclass(frozen=True)
class GridMesh:
    """A pods x nodes grid: ``rows[i]`` is the NodeMesh of pod row
    ``first_row + i`` (its n node shards); one process holds every row,
    or across ranks (`span`) its own whole rows."""

    rows: Tuple[NodeMesh, ...]
    pods: int
    first_row: int = 0
    span: Optional[RankSpan] = None

    @property
    def nodes(self) -> int:
        return self.rows[0].size

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.pods, self.nodes)

    @property
    def size(self) -> int:
        return self.pods * self.nodes

    @property
    def row_ids(self) -> range:
        return range(self.first_row, self.first_row + len(self.rows))

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """This process's positions' devices, row by row."""
        return tuple(d for row in self.rows for d in row.devices)

    def nl(self, n: int) -> int:
        return self.rows[0].nl(n)

    def pl(self, p: int) -> int:
        """Pods per row of an axis of `p` pods (after padding)."""
        return -(-int(p) // self.pods)

    def __repr__(self) -> str:
        where = _devices_text(self.devices)
        if self.span is not None:
            where = f"{self.span.world} ranks, rows {self.row_ids.start}..{self.row_ids.stop - 1} on rank " \
                    f"{self.span.rank}"
        return f"GridMesh({self.pods}x{self.nodes} on {where})"


def _devices_text(devices) -> str:
    kinds = {d.type for d in devices}
    k = len(set(devices))
    unit = "card" if kinds == {"cuda"} else "device"
    return f"{k} {unit}{'s' if k != 1 else ''}"


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


def make_mesh(n_devices: Optional[int] = None, devices=None, shape: Optional[Tuple[int, int]] = None):
    """A mesh of `n_devices` node shards, placed on `devices` in turn (the
    visible cards when None; ``"cpu"`` for a CPU mesh).  Without
    `n_devices`, one shard per device.  ``shape=(pods, nodes)`` with pods >
    1 is the pods x nodes grid, position (r, s) on ``devices[(r * nodes +
    s) % len(devices)]``; pods <= 1 is the 1-D mesh of `nodes` shards (the
    JAX package's :66-68)."""
    devs = _device_list(devices)
    if shape is not None:
        p, n = int(shape[0]), int(shape[1])
        if n < 1:
            raise ValueError(f"a mesh needs at least one node shard, got shape {p}x{n}")
        if p > 1:
            return GridMesh(tuple(NodeMesh(tuple(devs[(r * n + s) % len(devs)] for s in range(n)))
                                  for r in range(p)), p)
        n_devices = n
    n = len(devs) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a node mesh needs at least one shard, got {n}")
    return NodeMesh(tuple(devs[i % len(devs)] for i in range(n)))


def mesh_from_env(raw: Optional[str] = None, source: str = "KTPU_MESH", devices=None):
    """``KTPU_MESH=<n>``: the node mesh of n shards on `devices` (the visible
    cards when None); ``KTPU_MESH=<p>x<n>`` or the ``KTPU_MESH_PODS`` /
    ``KTPU_MESH_NODES`` pair: the p x n grid.  Unset / 1 / 0 -> None (the
    single-device path).  An invalid value raises ValueError, as in the JAX
    package.  The JAX package clamps a 1-D request to its device count, one
    shard per device; the port's shards and positions share devices in
    turn, so it builds what was asked.  The JAX package also folds a tuned
    KTPU_MESH_PODS winner into a 1-D request (its :105-117, ops/tuning.py);
    that waits for the port's tuning module (ROADMAP.md A14)."""
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
    if isinstance(mesh, GridMesh):
        return mesh.shape
    return (1, int(mesh.size))


def _pad_axis(a, axis: int, pad: int, fill):
    """`a` (numpy or torch) with `pad` entries of `fill` appended on `axis`."""
    if isinstance(a, torch.Tensor):
        shape = list(a.shape)
        shape[axis] = pad
        return torch.cat([a, torch.full(shape, fill, dtype=a.dtype, device=a.device)], dim=axis)
    a = np.asarray(a)
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, pad)
    return np.pad(a, widths, constant_values=fill)


def pad_field(name: str, a, pad: int, d_sentinel: int, n: int):
    """Pad one ClusterArrays field's node axis by `pad` entries (numpy or
    torch), or return it untouched when it carries no node axis: the fills
    of partition_rules.NODE_AXIS_FIELDS (None: the domain sentinel), and a
    real [P, N] image_score with zeros."""
    axis = node_axis_of(name, tuple(a.shape), n)
    if axis is None or not pad:
        return a
    fill = NODE_AXIS_FIELDS[name][1] if name in NODE_AXIS_FIELDS else 0
    return _pad_axis(a, axis, pad, d_sentinel if fill is None else fill)


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


def pad_pod_field(name: str, a, pad: int):
    """Pad one ClusterArrays field's pod axis by `pad` zero entries (numpy or
    torch), or return it untouched when it carries no pod axis: the rows of
    partition_rules.POD_AXIS_FIELDS, and image_score's leading axis in both
    its [P, N] and [P, 1] forms (the JAX package's pad_pod_field, :195)."""
    axis = pod_axis_of(name)
    if axis is None or not pad:
        return a
    return _pad_axis(a, axis, pad, 0)


def pad_pods(arr, pod_shards: int):
    """Pad the pod axis of a ClusterArrays to a multiple of `pod_shards` with
    permanently invalid pods (``pod_valid`` False: unplaced, committing
    nothing) -> (arr, original P); the input comes back untouched when
    already divisible (the JAX package's pad_pods, :217)."""
    p = arr.P
    pad = (-p) % pod_shards
    if pad == 0:
        return arr, p
    repl = {name: pad_pod_field(name, getattr(arr, name), pad) for name in (*POD_AXIS_FIELDS, "image_score")}
    return dataclasses.replace(arr, **repl), p


@dataclasses.dataclass
class ShardedArrays:
    """A ClusterArrays on a node mesh: ``shards[i]`` holds local shard i's
    (global id ``mesh.ids[i]``) rows of every node-axis field and the whole
    pod-axis and vocabulary fields, all on ``mesh.devices[i]``.  The node
    axis is padded: N = S * nl.  ``image_sharded``: whether image_score is
    a real [P, N] plane (cut per shard) or the [P, 1] broadcast form,
    decided at global shape (a shard's width may equal 1; the JAX package's
    image_sharded)."""

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
        tiled all_gather of its shard blocks (across ranks too)."""
        axis = node_axis_of(name, tuple(getattr(self.shards[0], name).shape), self.nl)
        return all_gather_nodes([getattr(sh, name) for sh in self.shards], axis, self.device, self.mesh.span)

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


@dataclasses.dataclass
class GridArrays:
    """A ClusterArrays on a pods x nodes grid: ``cells[i][j]`` is position
    (``mesh.row_ids[i]``, j): pod row r's block of every pod-axis field
    (pods ``[r * pl, (r + 1) * pl)``), node column j's block of every
    node-axis field (a real [P, N] image_score: both blocks), every other
    field whole, on that position's device.  Both axes are padded: P =
    pods * pl, N = nodes * nl.  ops/assign.py -- pod_unshard gathers the
    pod rows back into the ShardedArrays of one row."""

    mesh: GridMesh
    cells: Tuple[Tuple[ClusterArrays, ...], ...]
    image_sharded: bool = False

    @property
    def pl(self) -> int:
        return self.cells[0][0].P

    @property
    def P(self) -> int:
        return self.pl * self.mesh.pods

    @property
    def nl(self) -> int:
        return self.cells[0][0].N

    @property
    def N(self) -> int:
        return self.nl * self.mesh.nodes

    @property
    def device(self) -> torch.device:
        return self.mesh.rows[0].devices[0]


def _block(a, axis: int, i: int, w: int):
    """Block i of width w along `axis` (numpy or torch)."""
    if isinstance(a, torch.Tensor):
        return a.narrow(axis, i * w, w).contiguous()
    return np.ascontiguousarray(a[(slice(None),) * axis + (slice(i * w, (i + 1) * w),)])


def shard_arrays(arr: ClusterArrays, mesh: NodeMesh) -> ShardedArrays:
    """Place arrays held on one device on `mesh`: pad the node axis
    (pad_nodes), give each local shard its rows of every node-axis field
    and a copy of every other field on its device (one copy per device)."""
    image_sharded = arr.image_score.shape[1] == arr.N
    arr, _ = pad_nodes(arr, mesh.size)
    nl = mesh.nl(arr.N)
    rep: Dict[torch.device, Dict[str, torch.Tensor]] = {}
    shards = []
    for s, dev in zip(mesh.ids, mesh.devices):
        if dev not in rep:
            rep[dev] = {f: getattr(arr, f).to(dev) for f in arr.FIELDS
                        if node_axis_of(f, tuple(getattr(arr, f).shape), arr.N) is None}
        fields = dict(rep[dev])
        for f in arr.FIELDS:
            if f not in fields:
                a = getattr(arr, f)
                fields[f] = _block(a, node_axis_of(f, tuple(a.shape), arr.N), s, nl).to(dev)
        shards.append(ClusterArrays(**fields))
    return ShardedArrays(mesh, tuple(shards), image_sharded)


def grid_arrays(arr: ClusterArrays, mesh: GridMesh) -> GridArrays:
    """Place arrays held on one device on the grid `mesh`: pad both axes
    (pad_nodes, pad_pods), give each local position its pod row's and node
    column's blocks and a copy of every other field on its device (each
    block once per device)."""
    image_sharded = arr.image_score.shape[1] == arr.N
    arr, _ = pad_nodes(arr, mesh.nodes)
    arr, _ = pad_pods(arr, mesh.pods)
    nl, pl = mesh.nl(arr.N), mesh.pl(arr.P)
    placed: Dict[tuple, torch.Tensor] = {}
    cells = []
    for r, row in zip(mesh.row_ids, mesh.rows):
        cells.append([])
        for s, dev in enumerate(row.devices):
            fields = {}
            for f in arr.FIELDS:
                a = getattr(arr, f)
                naxis = node_axis_of(f, tuple(a.shape), arr.N)
                paxis = pod_axis_of(f)
                key = (f, dev, None if paxis is None else r, None if naxis is None else s)
                if key not in placed:
                    blk = a if paxis is None else _block(a, paxis, r, pl)
                    placed[key] = (blk if naxis is None else _block(blk, naxis, s, nl)).to(dev)
                fields[f] = placed[key]
            cells[-1].append(ClusterArrays(**fields))
    return GridArrays(mesh, tuple(tuple(c) for c in cells), image_sharded)


def global_arrays(mesh, arr: ClusterArrays):
    """This process's blocks of `arr` (the whole snapshot, which every rank
    holds) on a mesh of init_distributed (the JAX package's :424): only the
    local shards or grid positions are placed."""
    return grid_arrays(arr, mesh) if isinstance(mesh, GridMesh) else shard_arrays(arr, mesh)


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     mesh_shape: Optional[Tuple[int, int]] = None, backend: Optional[str] = None, devices=None):
    """Join a ``torch.distributed`` process group at ``tcp://<coordinator>``
    as rank `process_id` of `num_processes`, then build the mesh over every
    rank's positions (the JAX package's :399): this rank holds `devices`
    (default: its own card, ``cuda:<process_id % cards>``), every rank as
    many, rank r the r-th run of them.  ``mesh_shape=None`` or (1, n): the
    1-D node mesh over all of them (the node axis across ranks); ``(p, n)``
    with p > 1: the p x n grid, each rank holding whole pod rows (the pod
    axis across ranks).  A grid row split across ranks is not ported.

    `backend` is the caller's; by default ``nccl`` when each rank has a card
    of its own and ``gloo`` for CPU devices.  Ranks sharing one card must
    ask for ``gloo`` (NCCL refuses two ranks on one card); there is no
    quiet switch."""
    import torch.distributed as dist

    local = _device_list(devices if devices is not None
                         else [torch.device("cuda", process_id % max(1, torch.cuda.device_count()))])
    if backend is None:
        if all(d.type == "cpu" for d in local):
            backend = "gloo"
        elif torch.cuda.device_count() >= num_processes:
            backend = "nccl"
        else:
            raise ValueError(f"{num_processes} ranks on {torch.cuda.device_count()} card(s): NCCL takes one card a "
                             "rank; pass backend='gloo' to share a card")
    k = len(local)
    total = k * num_processes
    p, n = (1, total) if mesh_shape is None else (int(mesh_shape[0]), int(mesh_shape[1]))
    if p * n != total:
        raise ValueError(f"mesh shape {p}x{n} needs {p * n} positions; {num_processes} ranks x {k} = {total}")
    if p > 1 and k % n:
        raise NotImplementedError(f"a {p}x{n} grid over ranks of {k} positions splits a pod row across ranks; "
                                  f"each rank holds whole rows ({_A12})")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
                            rank=process_id)
    span = RankSpan(process_id, num_processes, backend)
    if p <= 1:
        return NodeMesh(tuple(local), span)
    per = k // n
    return GridMesh(tuple(NodeMesh(tuple(local[i * n:(i + 1) * n])) for i in range(per)), p,
                    first_row=process_id * per, span=span)


def shard_hbm_estimate(n_pods: int, n_nodes: int, n_shards: int, n_res: int = 4,
                       u_classes: Optional[int] = None, pod_shards: int = 1,
                       pod_row_bytes: Optional[int] = None) -> Dict[str, int]:
    """Per-shard device bytes of the node-axis terms of the chunked route
    on the mesh (the JAX package's shard_hbm_estimate, :238): the shard's
    packed static rows [P, words(nl)] (dense mode), its node-axis usage and
    capacity rows, and with class state its class planes (packed stat and
    fit [U1, words(nl)], f32 base [U1, nl]).  The stitched planes and the
    gathered usage live once, on the device that keeps the commit
    (``stitched``).  On a grid (``pod_shards`` > 1) a position also holds
    its pod row's block of the pod-axis fields (``pod_rows``, `pod_row_bytes`
    a pod; default the fit-only set: valid, R requests, priority, pin,
    has-selector, group, an image score of the score storage dtype) and the entry gather makes one
    whole copy of them (``pod_gather``, a transient: the JAX package's
    pod_gather term)."""
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
    if pod_shards > 1:
        from ..ops.bitplane import np_score_dtype

        row = 4 * n_res + 16 + np_score_dtype().itemsize if pod_row_bytes is None else int(pod_row_bytes)
        pl = -(-n_pods // pod_shards)
        b["pod_rows"] = row * pl
        b["pod_gather"] = row * pl * pod_shards
    b["total"] = sum(b.values())
    return b


__all__ = [
    "GridArrays", "GridMesh", "NodeMesh", "ShardedArrays", "global_arrays", "grid_arrays", "init_distributed",
    "make_mesh", "mesh_axis_shards", "mesh_from_env", "pad_field", "pad_nodes", "pad_pod_field", "pad_pods",
    "shard_arrays", "shard_hbm_estimate",
]
