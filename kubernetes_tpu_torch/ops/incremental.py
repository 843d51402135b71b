"""Incremental warm-cycle hoisting — equivalence classes and dirty-node
rescoring; the port of the JAX package's ``ops/incremental.py`` on one
device.

Pods with equal spec keys get identical rows (api/snapshot.py — the class
index), so the [P, N] hoists collapse to [U1, N] class matrices (U1 =
classes + one padding class): the static plane ``stat_u`` (node validity,
taints, selectors, nodeName; packed words, WITHOUT pod_valid, which the
kernels fold per pod, so the state survives the gang fixpoint's
revocations), the fit plane ``fit_u`` (packed) and the f32 base scores
``base_u`` (fit + BalancedAllocation) against cycle-start usage; for the
rounds route also the eligibility plane ``elig_u`` (packed nodesel &
node_valid, pairwise configs), the bf16 PreferNoSchedule counts ``traw_u``
and preferred node-affinity weights ``naraw_u``, and the class rows of the
image scores ``img_u``, each only where the config reads it.
``HoistCache.ensure`` keeps them resident across cycles: the static side
is rebuilt only when one of the tensors it reads is replaced (identity
fingerprint), the usage side is patched at the node columns whose usage
changed (a row diff on the tensors' device), or fully rebuilt when half the
nodes or more are dirty.  A patched cache is bit-identical to a fresh hoist
(same per-(class, node) formulas), so decisions do not move.

Each hoist has a plain PyTorch version here (``_static_hoist_plain``,
``_usage_hoist_plain``, ``_patch_hoist_plain``), op for op after the JAX
function; for CUDA tensors the hoists launch the kernels
``class_static_hoist`` (csrc/class_hoist.cu, K3, with the eligibility
words when asked), ``score_planes`` (K10, over the class view's rows) and
``class_usage_hoist`` (class_hoist.cu, K4, full or column-list mode) or
raise.

DONATION-ALIASING RULE (the JAX package's incremental.py:49-53): the
kernels never write into a resident buffer.  A patch writes into a copy of
the previous generation, so an IncState handed out earlier stays valid, and
the commit kernels (ops/assign.py) allocate their own t0u / usage buffers.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..api.snapshot import POD_FIELDS
from ..device import h2d
from . import bitplane, filters
from .scopes import subphase
from .scores import ScoreConfig, balanced_allocation, check_config, fit_score


class IncState(NamedTuple):
    """Device-side class state handed to the commit kernels.  Mask planes
    are packed int32 words [U1, ceil(N/32)] (ops/bitplane.py); the optional
    planes are None where the config does not read them."""

    cls: Any      # i32[P] class of each pod row (U1-1 = the padding class)
    req_u: Any    # i32[U1, R] per-class requests
    stat_u: Any   # i32 words [U1, W] static feasibility per class
    base_u: Any   # f32[U1, N] fit + balanced base scores vs cycle-start usage
    fit_u: Any    # i32 words [U1, W] fit mask vs cycle-start usage
    elig_u: Any = None   # i32 words [U1, W] nodesel & node_valid (pairwise)
    # the score planes' dtype is ops/bitplane.py score_store_dtype(): bf16,
    # or f32 under KTPU_SCORE_DTYPE=f32
    traw_u: Any = None   # bf16[U1, N] PreferNoSchedule counts (taint score)
    naraw_u: Any = None  # bf16[U1, N] preferred node-affinity weights
    img_u: Any = None    # bf16[U1, N] image scores (ImageLocality on a real plane)
    shards: Any = None   # on a node mesh: one IncState per shard with its own planes


def class_view(arr, r_u: torch.Tensor):
    """ClusterArrays whose pod axis is the CLASS axis: row u = the first pod
    of class u (rows within a class are identical, so which one is
    immaterial) — every pod-axis field, m_pend's columns and the image
    score rows (the JAX package's incremental.py:110-131)."""
    repl = {f: getattr(arr, f)[r_u].contiguous() for f in POD_FIELDS}
    repl["m_pend"] = arr.m_pend[:, r_u].contiguous()
    return dataclasses.replace(arr, **repl)


def score_flat(requested: torch.Tensor, alloc: torch.Tensor, cfg: ScoreConfig) -> torch.Tensor:
    """fit_weight * fit_score + balanced_weight * balanced over flattened
    [*, R] rows — the formulas of the per-pod scan, elementwise per row."""
    return cfg.fit_weight * fit_score(requested, alloc, cfg) + cfg.balanced_weight * balanced_allocation(
        requested, alloc, cfg.score_resources
    )


def fit_rows(req: torch.Tensor, used: torch.Tensor, alloc: torch.Tensor) -> torch.Tensor:
    """bool[U, D]: filters.fit_ok of each request row req[U, R] against each
    (used, alloc) row [D, R] — the subtraction form, which cannot overflow."""
    r = req[:, None, :]
    return ((r == 0) | (r <= (alloc - used)[None])).all(dim=2)


def _scores(req: torch.Tensor, used: torch.Tensor, alloc: torch.Tensor, cfg: ScoreConfig) -> torch.Tensor:
    """f32[U, D]: score_flat of used[d] + req[u] against alloc[d]."""
    reqd = used[None, :, :] + req[:, None, :]  # [U, D, R]
    U, D, R = reqd.shape
    return score_flat(reqd.reshape(-1, R), alloc[None].expand(U, D, R).reshape(-1, R), cfg).reshape(U, D)


def _static_hoist_plain(cv, want_elig: bool = False, want_traw: bool = False, want_naraw: bool = False,
                        base: int = 0):
    """The usage-independent class planes of a class view (the JAX package's
    incremental.py:146 _static_hoist) -> (stat, elig, traw, naraw): stat the
    packed [U1, W] node_valid & taints_ok & nodesel & nodename_ok, without
    pod_valid; elig the packed nodesel & node_valid; traw / naraw the bf16
    [U1, N] PreferNoSchedule counts and preferred node-affinity weights;
    each of the last three None unless wanted.  On a node shard's arrays
    `base` is its first global node id (the nodeName pin's)."""
    from .assign import preferred_node_affinity_raw_plain
    from .scores import taint_prefer_counts_plain

    tm = filters.term_match(cv.sel_mask, cv.sel_kind, cv.node_labels)
    nodesel = filters.node_selection_ok_from(tm, cv)
    stat = cv.node_valid[None, :] & filters.taints_ok(cv) & nodesel & filters.nodename_ok(cv, base)
    elig = bitplane.pack(nodesel & cv.node_valid[None, :]) if want_elig else None
    traw = taint_prefer_counts_plain(cv.pod_tol_pref, cv.node_taint_pref) if want_traw else None
    naraw = preferred_node_affinity_raw_plain(cv.pod_pref_terms, cv.pod_pref_weights, tm) if want_naraw else None
    return bitplane.pack(stat), elig, traw, naraw


def _usage_hoist_plain(req_u, node_used, node_alloc, cfg: ScoreConfig):
    """Full [U1, N] hoist against `node_used` -> (base f32[U1, N], packed
    fit [U1, W]) (the JAX package's incremental.py:188 _usage_hoist)."""
    base = _scores(req_u, node_used, node_alloc, cfg)
    fit = fit_rows(req_u, node_used, node_alloc)
    return base, bitplane.pack(fit)


def _patch_hoist_plain(base_u, fit_u, req_u, node_used, node_alloc, cols, cfg: ScoreConfig):
    """Recompute the node COLUMNS `cols` (i32, padded with the sentinel N,
    which is dropped) of the usage side against `node_used`; returns new
    (base_u, fit_u) and leaves the inputs untouched (the JAX package's
    incremental.py:214 _patch_hoist)."""
    n = base_u.shape[1]
    safe = torch.clamp_max(cols.to(torch.int64), n - 1)
    cu = node_used[safe]
    ca = node_alloc[safe]
    fit_c = fit_rows(req_u, cu, ca)  # [U1, D]
    base_c = _scores(req_u, cu, ca, cfg)
    real = cols < n
    base_u = base_u.clone()
    base_u[:, cols[real].to(torch.int64)] = base_c[:, real]
    fit_u = bitplane.assign_cols(fit_u, cols, fit_c, n)
    return base_u, fit_u


def static_hoist(arr, r_u: torch.Tensor, want_elig: bool = False, want_traw: bool = False,
                 want_naraw: bool = False, base: int = 0):
    """The class planes (stat, elig, traw, naraw) on arr's device: the plain
    version for CPU tensors; for CUDA tensors kernel K3 (stat, and elig when
    wanted) and kernel K10 over the class view's rows (traw, naraw).  `base`:
    a node shard's first global node id."""
    with subphase("hoist"):
        if arr.device.type == "cpu":
            return _static_hoist_plain(class_view(arr, r_u), want_elig, want_traw, want_naraw, base)
        from . import kernels

        stat, elig = kernels.class_static_hoist(arr, r_u, with_elig=True, base=base) if want_elig else (
            kernels.class_static_hoist(arr, r_u, base=base), None)
        traw = naraw = None
        if want_traw or want_naraw:
            traw, naraw = kernels.score_planes(class_view(arr, r_u))
        return stat, elig, (traw if want_traw else None), (naraw if want_naraw else None)


def usage_hoist(req_u, node_used, node_alloc, cfg: ScoreConfig):
    with subphase("hoist"):
        if node_used.device.type == "cpu":
            return _usage_hoist_plain(req_u, node_used, node_alloc, cfg)
        from . import kernels

        return kernels.class_usage_hoist(req_u, node_used, node_alloc, cfg)


def patch_hoist(base_u, fit_u, req_u, node_used, node_alloc, cols, cfg: ScoreConfig):
    with subphase("hoist"):
        if node_used.device.type == "cpu":
            return _patch_hoist_plain(base_u, fit_u, req_u, node_used, node_alloc, cols, cfg)
        from . import kernels

        return kernels.class_usage_hoist(req_u, node_used, node_alloc, cfg, cols=cols, base_u=base_u,
                                         fit_u=fit_u)


def _round_up_pow2(x: int, minimum: int = 16) -> int:
    v = minimum
    while v < x:
        v *= 2
    return v


# the arrays the static class planes read (the JAX package's static key,
# incremental.py:469-479), besides the class index itself
_STATIC_FIELDS = (
    "pod_tol_ns", "pod_tol_pref", "pod_nodename", "pod_terms", "pod_has_sel", "sel_mask", "sel_kind",
    "pod_pref_terms", "pod_pref_weights", "node_valid", "node_labels", "node_taint_ns", "node_taint_pref",
    "image_score",
)


def _fields(arr, names):
    """The tensors of `names` in arr, for identity keys: a node mesh's
    ShardedArrays gives every shard's, a grid's GridArrays every
    position's (parallel/mesh.py)."""
    cells = getattr(arr, "cells", None)
    if cells is not None:
        return tuple(getattr(c, f) for f in names for row in cells for c in row)
    shards = getattr(arr, "shards", None)
    if shards is None:
        return tuple(getattr(arr, f) for f in names)
    return tuple(getattr(sh, f) for f in names for sh in shards)


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """Zero rows appended up to n (the node mesh's pad nodes: no usage)."""
    return a if a.shape[0] >= n else np.pad(a, ((0, n - a.shape[0]), (0, 0)))


def incremental_enabled() -> bool:
    """KTPU_INCREMENTAL=0 disables the class state (read per cycle, so a
    test or an operator flips it without a fresh process), as in the JAX
    package."""
    return os.environ.get("KTPU_INCREMENTAL", "") != "0"


class HoistCache:
    """Host-side manager of the resident class matrices.

    ``ensure(arr, meta, cfg)`` returns this cycle's IncState, or None when
    the class route does not apply (no class index, or the degenerate
    all-pods-unique wave, U1 >= P).  Two fingerprints drive residency:

      static side — the identity of every tensor the class planes read
        (the JAX package's whole static key, incremental.py:469-479: the
        PreferNoSchedule taints and tolerations, the preferred terms and
        the image scores too), plus (U1, N, cfg, the wanted planes).
        Mismatch: full static re-hoist (K3, K10).
      usage side — node_alloc identity, equal per-class requests, (U1, N,
        cfg).  Mismatch: full usage re-hoist (K4).  Match: the rows of
        node_used that differ from the previous cycle's are patched (K4 on
        a pow2 column list padded with the sentinel N), or fully re-hoisted
        when at least half the nodes are dirty.

    The requests and the usage rows are compared on the HOST (as the JAX
    package compares its host arrays): ``ensure(..., host=)`` takes the
    encoder's host arrays (api/delta.py — DeltaEncoder.encode), so a cycle
    needs no device-to-host read and never waits for a step in flight.
    Without them the two fields are read back from `arr` (a
    synchronisation on the card).  The column list goes to the device by an
    explicit copy from pinned memory.

    ON A NODE MESH (``mesh``, parallel/mesh.py; the JAX package's
    HoistCache(mesh=), incremental.py:309-361): N is the padded node count
    and the planes are per shard -- stat_u, fit_u and elig_u packed [U1,
    words(nl)], base_u [U1, nl], traw_u / naraw_u / img_u [U1, nl] -- K3
    (with the shard's first global node id, and the eligibility words
    where wanted), K10 over the class view and K4 launching once per shard
    over its node block.  A dirty column is patched by the shard that owns
    it only, with its local column id (``shard_cols`` lists them for the
    latest cycle).  The IncState handed out carries the per-shard planes as
    one IncState per shard in ``shards`` (what the sharded rounds route
    reads); for a batch the class-wave route takes (fit-only, a multiple of
    128 pods) also the stitched stat_u / base_u / fit_u, stitched once per
    cycle where a side changed (the tiled all_gather, then K17 for the
    packed planes).  The mesh takes `arr` as the encoder places it
    (ShardedArrays) or arrays on one device, which it pads and cuts itself.
    Across ranks (the mesh's span) each rank hoists its own shards and the
    stitch gathers across the ranks.

    ON A PODS x NODES GRID (parallel/mesh.py -- GridMesh; the JAX package's
    incremental.py:455-457, :562-568): the planes are those of the node
    mesh of one pod row, hoisted after the entry gather of the pod rows
    (ops/assign.py -- pod_unshard; the fingerprints read the placed,
    ungathered tensors); the class index is padded to a multiple of the
    pod rows with class 0 (padded pods are invalid) and kept one block per
    pod row, ``cls`` a tuple that pod_unshard gathers at the step's entry.

    ``stats`` counts actions, ``last`` describes the latest, ``history``
    keeps up to 512 of them, ``summary()`` is the bench triple.
    """

    def __init__(self, mesh=None, tracer=None):
        from ..parallel.mesh import GridMesh

        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self._grid = self.mesh if isinstance(self.mesh, GridMesh) else None
        # the node mesh whose shards hold the planes (a grid: its first held row)
        self._nodes = self._grid.rows[0] if self._grid is not None else self.mesh
        self._static_key = None
        self._statics = None  # (stat, elig, traw, naraw, img); on a mesh the stitched stat (or None)
        self._usage_key = None
        self._usage = None  # (base_u, fit_u); on a mesh stitched (or None)
        # a mesh's per-shard planes: {"stitch": bool, "static": [(stat, elig, traw, naraw, img), ...],
        # "usage": [(base, fit), ...]}
        self._blocks = None
        self._req_u_host = None
        self._prev_used = None
        self._memo = {}  # key -> (host array, device tensor): the class index and class rows
        self.shard_cols = []  # a mesh's latest patch: each shard's local column ids
        self.stats = {
            "hits": 0, "patched": 0, "full": 0, "static_rebuilds": 0,
            "disabled": 0, "skipped": 0, "patched_cols": 0,
        }
        self.last = {"unique_classes": 0, "dirty_node_fraction": 0.0, "patched_cols": 0, "action": "none"}
        self.history = []
        # a scheduler/tracing.py Tracer: each ensure() records a hoist.update
        # span (the JAX package's incremental.py:385-397)
        self.tracer = tracer

    def _note(self, action, u1, frac, ncols, t0, n_nodes=0) -> None:
        self.last = {
            "unique_classes": int(u1), "dirty_node_fraction": float(frac),
            "patched_cols": int(ncols), "action": action,
        }
        if len(self.history) < 512:
            self.history.append(dict(self.last))
        tr = self.tracer
        if tr is not None and getattr(tr, "enabled", False):
            tr.record_span(
                "hoist.update", start=t0, end=time.perf_counter(),
                action=action, unique_classes=int(u1), n_cols=int(ncols),
                n_nodes=int(n_nodes), dirty_node_fraction=float(frac),
            )

    def invalidate(self) -> None:
        """Forget every fingerprint and resident buffer: the next ensure()
        re-hoists in full."""
        self._static_key = None
        self._statics = None
        self._usage_key = None
        self._usage = None
        self._blocks = None
        self._req_u_host = None
        self._prev_used = None
        self._memo = {}

    def summary(self) -> dict:
        fr = sorted(
            h["dirty_node_fraction"] for h in self.history if h["action"] in ("patch", "hit", "full")
        )
        return {
            "unique_classes": self.last["unique_classes"],
            "dirty_node_fraction": (fr[len(fr) // 2] if fr else None),
            "hoist_cache_hits": self.stats["hits"],
            "hoist_cache_full": self.stats["full"] + self.stats["static_rebuilds"],
        }

    def _on_device(self, key, host: np.ndarray, dtype, device) -> torch.Tensor:
        """Device copy memoized by host identity or equal value."""
        ent = self._memo.get(key)
        if ent is not None and ent[1].device == device and (
            ent[0] is host or (ent[0].shape == host.shape and np.array_equal(ent[0], host))
        ):
            return ent[1]
        d = h2d(host, device, dtype)
        self._memo[key] = (host, d)
        return d

    # -- the node mesh's per-shard planes --
    def _shards(self, arr):
        from ..parallel.mesh import shard_arrays

        return arr.shards if hasattr(arr, "shards") else shard_arrays(arr, self._nodes).shards

    def _stitch(self, plane: str, blocks, nl: int) -> torch.Tensor:
        """A class plane's shard blocks stitched on the mesh's first device:
        the tiled all_gather along its node axis, then K17 for a packed one."""
        from ..parallel.collectives import all_gather_nodes
        from ..parallel.partition_rules import INC_NODE_AXIS

        full = all_gather_nodes(blocks, INC_NODE_AXIS[plane], self._nodes.devices[0], self._nodes.span)
        return full if plane == "base_u" else bitplane.stitch_planes(full, nl)

    def _mesh_static(self, arr, r_u: torch.Tensor, n: int, wants, want_img: bool, stitch: bool):
        """Each shard's static class planes (stat, elig, traw, naraw, img)
        -> the stitched stat_u, or None unless `stitch`."""
        shards = self._shards(arr)
        blocks = []
        for s, sh in zip(self._nodes.ids, shards):
            ru = r_u.to(sh.device)
            img = sh.image_score[ru].contiguous() if want_img else None
            blocks.append(static_hoist(sh, ru, *wants, base=self._nodes.base(s, n)) + (img,))
        self._blocks["static"] = blocks
        return self._stitch("stat_u", [b[0] for b in blocks], shards[0].N) if stitch else None

    def _mesh_usage(self, arr, req_u: torch.Tensor, cfg: ScoreConfig, dirty=None):
        """Per-shard usage planes (full, or with the global `dirty` ids
        patched by their owners) -> the stitched (base_u, fit_u)."""
        shards = self._shards(arr)
        nl = shards[0].N
        self.shard_cols = []
        if dirty is None:
            self._blocks["usage"] = [usage_hoist(req_u.to(sh.device), sh.node_used, sh.node_alloc, cfg)
                                     for sh in shards]
        else:
            out = []
            for j, (s, sh) in enumerate(zip(self._nodes.ids, shards)):
                own = dirty[(dirty >= s * nl) & (dirty < (s + 1) * nl)] - s * nl
                self.shard_cols.append(own)
                if not len(own):
                    out.append(self._blocks["usage"][j])
                    continue
                cols_h = np.full(_round_up_pow2(len(own)), nl, dtype=np.int32)
                cols_h[:len(own)] = own
                base_s, fit_s = self._blocks["usage"][j]
                out.append(patch_hoist(base_s, fit_s, req_u.to(sh.device), sh.node_used, sh.node_alloc,
                                       h2d(cols_h, sh.device), cfg))
            self._blocks["usage"] = out
        blocks = self._blocks["usage"]
        if not self._blocks["stitch"]:
            return None, None
        return self._stitch("base_u", [b for b, _ in blocks], nl), self._stitch("fit_u", [f for _, f in blocks], nl)

    def ensure(self, arr, meta, cfg: ScoreConfig, host=None) -> Optional[IncState]:
        """This cycle's IncState for the arrays `arr` (on their device, or
        on the node mesh); `host` are the same arrays on the host (numpy),
        when the caller has them.  None under KTPU_INCREMENTAL=0 (counted
        as `disabled`): the caller routes without class state."""
        t0 = time.perf_counter()
        if not incremental_enabled():
            self.stats["disabled"] += 1
            return None
        check_config(cfg)
        pc = getattr(meta, "pod_class", None)
        r_u_h = getattr(meta, "class_first_pod", None)
        if pc is None or r_u_h is None:
            self.stats["skipped"] += 1
            return None
        grid, mesh = self._grid, self._nodes
        keyed = placed = arr  # the fingerprints read the caller's tensors, never the gathered ones
        if grid is not None:
            from ..parallel.mesh import GridArrays, grid_arrays
            from .assign import pod_unshard

            placed = arr if isinstance(arr, GridArrays) else grid_arrays(arr, grid)
        u1 = int(r_u_h.shape[0])
        if u1 >= placed.P:
            # the all-pods-unique wave: the class route would be a no-op
            self.stats["skipped"] += 1
            self._note("skipped_degenerate", u1, 1.0, 0, t0, n_nodes=arr.N)
            return None
        if grid is not None:
            arr = pod_unshard(placed)[0]  # the first held pod row, all pods gathered
        dev = arr.device
        # on a mesh the node axis is padded to a multiple of its shards (the
        # JAX package's np_nodes)
        N = arr.N + ((-arr.N) % mesh.size if mesh is not None else 0)
        pods = arr.shards[0] if hasattr(arr, "shards") else arr
        r_u = self._on_device("r_u", r_u_h, torch.int64, dev)

        # ---- static side (usage-independent; pod_valid excluded) ----
        # the class planes the config reads (the JAX package's incremental.py:462-465)
        want_elig, want_traw, want_naraw = cfg.enable_pairwise, cfg.enable_taint_score, cfg.enable_node_pref
        img_real = getattr(arr, "image_sharded", None)
        if img_real is None:
            img_real = pods.image_score.shape[1] == pods.N
        want_img = cfg.enable_image and img_real
        # on a mesh the class-wave route reads the planes stitched
        stitch = mesh is not None and not (want_elig or want_traw or want_naraw or want_img or cfg.enable_ports) \
            and arr.P >= 128 and arr.P % 128 == 0
        skey_arrays = (pc, r_u_h) + _fields(keyed, _STATIC_FIELDS)
        skey_meta = (u1, N, cfg, want_elig, want_traw, want_naraw, want_img, stitch, str(dev))
        action = None
        if not (
            self._static_key is not None
            and self._static_key[1] == skey_meta
            and len(self._static_key[0]) == len(skey_arrays)
            and all(a is b for a, b in zip(self._static_key[0], skey_arrays))
        ):
            if mesh is not None:
                self._blocks = {"stitch": stitch}
                self._statics = (self._mesh_static(arr, r_u, N, (want_elig, want_traw, want_naraw), want_img, stitch),
                                 None, None, None, None)
            else:
                planes = static_hoist(arr, r_u, want_elig, want_traw, want_naraw)
                img = arr.image_score[r_u].contiguous() if want_img else None
                self._statics = planes + (img,)
            self._static_key = (skey_arrays, skey_meta)
            self.stats["static_rebuilds"] += 1
            self._usage_key = None  # classes / N / cfg moved: rebuild below
            action = "static_rebuild"

        # ---- usage side ----
        req_u = pods.pod_req[r_u].contiguous()
        pod_req_h = host.pod_req if host is not None else pods.pod_req.cpu().numpy()
        if host is not None:
            used_h = host.node_used
        elif hasattr(arr, "shards"):
            used_h = arr.gather("node_used").cpu().numpy()
        else:
            used_h = arr.node_used.cpu().numpy()
        if mesh is not None:
            used_h = _pad_rows(used_h, N)
        req_u_h = np.ascontiguousarray(pod_req_h[r_u_h])
        ukey_meta = (u1, N, cfg, str(dev))
        alloc_key = _fields(keyed, ("node_alloc",))
        usage_ok = (
            self._usage_key is not None
            and self._usage_key[1] == ukey_meta
            and len(self._usage_key[0]) == len(alloc_key)
            and all(a is b for a, b in zip(self._usage_key[0], alloc_key))
            and np.array_equal(self._req_u_host, req_u_h)
        )
        n_dirty, dirty = 0, None
        if usage_ok and used_h is not self._prev_used:
            dirty = np.flatnonzero((used_h != self._prev_used).any(axis=1))
            n_dirty = len(dirty)
        if not usage_ok or 2 * n_dirty >= N:
            if mesh is not None:
                self._usage = self._mesh_usage(arr, req_u, cfg)
            else:
                self._usage = usage_hoist(req_u, arr.node_used, arr.node_alloc, cfg)
            self.stats["full"] += 1
            frac, ncols = 1.0, N
            action = action or "full"
        elif n_dirty == 0:
            self.stats["hits"] += 1
            frac, ncols = 0.0, 0
            action = action or "hit"
        else:
            if mesh is not None:
                self._usage = self._mesh_usage(arr, req_u, cfg, dirty)
            else:
                cols_h = np.full(_round_up_pow2(n_dirty), N, dtype=np.int32)
                cols_h[:n_dirty] = dirty
                cols = h2d(cols_h, dev)
                self._usage = patch_hoist(self._usage[0], self._usage[1], req_u, arr.node_used, arr.node_alloc,
                                          cols, cfg)
            self.stats["hits"] += 1
            self.stats["patched"] += 1
            self.stats["patched_cols"] += n_dirty
            n_real = getattr(meta, "n_nodes", 0) or N
            frac, ncols = n_dirty / max(1, n_real), n_dirty
            action = action or "patch"
        self._usage_key = (alloc_key, ukey_meta)
        self._req_u_host = req_u_h
        self._prev_used = used_h

        if grid is None:
            cls = self._on_device("cls", pc, torch.int32, dev)
        else:
            # one block per held pod row, padded with class 0 to the rows
            pl = grid.pl(pc.shape[0])
            cls_h = np.pad(pc, (0, pl * grid.pods - pc.shape[0]))
            cls = tuple(self._on_device(("cls", r), cls_h[r * pl:(r + 1) * pl], torch.int32, row.devices[0])
                        for r, row in zip(grid.row_ids, grid.rows))
        self._note(action, u1, frac, ncols, t0, n_nodes=getattr(meta, "n_nodes", 0) or arr.N)
        stat, elig, traw, naraw, img = self._statics
        per_shard = None
        if mesh is not None:
            per_shard = tuple(
                IncState(cls=None if grid is not None else cls.to(st[0].device), req_u=req_u.to(st[0].device),
                         stat_u=st[0], base_u=us[0], fit_u=us[1], elig_u=st[1], traw_u=st[2], naraw_u=st[3],
                         img_u=st[4])
                for st, us in zip(self._blocks["static"], self._blocks["usage"]))
        return IncState(cls=cls, req_u=req_u, stat_u=stat, base_u=self._usage[0], fit_u=self._usage[1],
                        elig_u=elig, traw_u=traw, naraw_u=naraw, img_u=img, shards=per_shard)


__all__ = [
    "HoistCache", "IncState", "class_view", "static_hoist", "usage_hoist", "patch_hoist",
    "_static_hoist_plain", "_usage_hoist_plain", "_patch_hoist_plain", "_round_up_pow2",
]
