"""Incremental warm-cycle hoisting — equivalence classes and dirty-node
rescoring; the port of the JAX package's ``ops/incremental.py`` for the
fit-only stage set on one device.

Pods with equal spec keys get identical rows (api/snapshot.py — the class
index), so the [P, N] hoists collapse to [U1, N] class matrices (U1 =
classes + one padding class): the static plane ``stat_u`` (node validity,
taints, selectors, nodeName; packed words, WITHOUT pod_valid, which the
kernels fold per pod), the fit plane ``fit_u`` (packed) and the f32 base
scores ``base_u`` (fit + BalancedAllocation) against cycle-start usage.
``HoistCache.ensure`` keeps them resident across cycles: the static side
is rebuilt only when one of the tensors it reads is replaced (identity
fingerprint), the usage side is patched at the node columns whose usage
changed (a row diff on the tensors' device), or fully rebuilt when half the
nodes or more are dirty.  A patched cache is bit-identical to a fresh hoist
(same per-(class, node) formulas), so decisions do not move.

Each hoist has a plain PyTorch version here (``_static_hoist_plain``,
``_usage_hoist_plain``, ``_patch_hoist_plain``), op for op after the JAX
function; for CUDA tensors the hoists launch the kernels
``class_static_hoist`` (csrc/class_hoist.cu, K3) and ``class_usage_hoist``
(the same file, K4, full or column-list mode) or raise.

DONATION-ALIASING RULE (the JAX package's incremental.py:49-53): the
kernels never write into a resident buffer.  A patch writes into a copy of
the previous generation, so an IncState handed out earlier stays valid, and
the commit kernels (ops/assign.py) allocate their own t0u / usage buffers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..device import h2d
from . import bitplane, filters
from .scores import ScoreConfig, balanced_allocation, check_config, fit_score


class IncState(NamedTuple):
    """Device-side class state handed to the commit kernels.  Mask planes
    are packed int32 words [U1, ceil(N/32)] (ops/bitplane.py).  The fit-only
    slice leaves the rounds route's optional planes None."""

    cls: Any      # i32[P] class of each pod row (U1-1 = the padding class)
    req_u: Any    # i32[U1, R] per-class requests
    stat_u: Any   # i32 words [U1, W] static feasibility per class
    base_u: Any   # f32[U1, N] fit + balanced base scores vs cycle-start usage
    fit_u: Any    # i32 words [U1, W] fit mask vs cycle-start usage
    elig_u: Any = None
    traw_u: Any = None
    naraw_u: Any = None
    img_u: Any = None


# the port's pod-axis ClusterArrays fields (api/snapshot.py — POD_FIELDS)
_POD_AXIS_FIELDS = (
    "pod_valid", "pod_req", "pod_prio", "pod_tol_ns", "pod_nodename",
    "pod_terms", "pod_has_sel",
)


def class_view(arr, r_u: torch.Tensor):
    """ClusterArrays whose pod axis is the CLASS axis: row u = the first pod
    of class u (rows within a class are identical, so which one is
    immaterial)."""
    return dataclasses.replace(arr, **{f: getattr(arr, f)[r_u].contiguous() for f in _POD_AXIS_FIELDS})


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


def _static_hoist_plain(cv) -> torch.Tensor:
    """Packed [U1, W] static plane of a class view: node_valid & taints_ok &
    nodesel & nodename_ok, without pod_valid (the JAX package's
    incremental.py:146 _static_hoist, fit-only stage set)."""
    tm = filters.term_match(cv.sel_mask, cv.sel_kind, cv.node_labels)
    nodesel = filters.node_selection_ok_from(tm, cv)
    stat = cv.node_valid[None, :] & filters.taints_ok(cv) & nodesel & filters.nodename_ok(cv)
    return bitplane.pack(stat)


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


def static_hoist(arr, r_u: torch.Tensor) -> torch.Tensor:
    """The class static plane on arr's device: the plain version for CPU
    tensors, kernel K3 for CUDA tensors."""
    if arr.device.type == "cpu":
        return _static_hoist_plain(class_view(arr, r_u))
    from . import kernels

    return kernels.class_static_hoist(arr, r_u)


def usage_hoist(req_u, node_used, node_alloc, cfg: ScoreConfig):
    if node_used.device.type == "cpu":
        return _usage_hoist_plain(req_u, node_used, node_alloc, cfg)
    from . import kernels

    return kernels.class_usage_hoist(req_u, node_used, node_alloc, cfg)


def patch_hoist(base_u, fit_u, req_u, node_used, node_alloc, cols, cfg: ScoreConfig):
    if node_used.device.type == "cpu":
        return _patch_hoist_plain(base_u, fit_u, req_u, node_used, node_alloc, cols, cfg)
    from . import kernels

    return kernels.class_usage_hoist(req_u, node_used, node_alloc, cfg, cols=cols, base_u=base_u, fit_u=fit_u)


def _round_up_pow2(x: int, minimum: int = 16) -> int:
    v = minimum
    while v < x:
        v *= 2
    return v


class HoistCache:
    """Host-side manager of the resident class matrices.

    ``ensure(arr, meta, cfg)`` returns this cycle's IncState, or None when
    the class route does not apply (no class index, or the degenerate
    all-pods-unique wave, U1 >= P).  Two fingerprints drive residency:

      static side — the identity of every tensor the static plane reads,
        plus (U1, N, cfg).  Mismatch: full static re-hoist (K3).
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

    ``stats`` counts actions, ``last`` describes the latest, ``history``
    keeps up to 512 of them, ``summary()`` is the bench triple.
    """

    def __init__(self):
        self._static_key = None
        self._stat = None
        self._usage_key = None
        self._usage = None  # (base_u, fit_u)
        self._req_u_host = None
        self._prev_used = None
        self._cls_ent = None  # (host array, device tensor)
        self._ru_ent = None
        self.stats = {
            "hits": 0, "patched": 0, "full": 0, "static_rebuilds": 0,
            "disabled": 0, "skipped": 0, "patched_cols": 0,
        }
        self.last = {"unique_classes": 0, "dirty_node_fraction": 0.0, "patched_cols": 0, "action": "none"}
        self.history = []

    def _note(self, action, u1, frac, ncols) -> None:
        self.last = {
            "unique_classes": int(u1), "dirty_node_fraction": float(frac),
            "patched_cols": int(ncols), "action": action,
        }
        if len(self.history) < 512:
            self.history.append(dict(self.last))

    def invalidate(self) -> None:
        """Forget every fingerprint and resident buffer: the next ensure()
        re-hoists in full."""
        self._static_key = None
        self._stat = None
        self._usage_key = None
        self._usage = None
        self._req_u_host = None
        self._prev_used = None
        self._cls_ent = None
        self._ru_ent = None

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

    def _on_device(self, name: str, host: np.ndarray, dtype, device) -> torch.Tensor:
        """Device copy memoized by host identity or equal value."""
        ent = getattr(self, name)
        if ent is not None and ent[1].device == device and (
            ent[0] is host or (ent[0].shape == host.shape and np.array_equal(ent[0], host))
        ):
            return ent[1]
        d = h2d(host, device, dtype)
        setattr(self, name, (host, d))
        return d

    def ensure(self, arr, meta, cfg: ScoreConfig, host=None) -> Optional[IncState]:
        """This cycle's IncState for the arrays `arr` (on their device);
        `host` are the same arrays on the host (numpy), when the caller has
        them."""
        check_config(cfg)
        pc = getattr(meta, "pod_class", None)
        r_u_h = getattr(meta, "class_first_pod", None)
        if pc is None or r_u_h is None:
            self.stats["skipped"] += 1
            return None
        u1 = int(r_u_h.shape[0])
        if u1 >= arr.P:
            # the all-pods-unique wave: the class route would be a no-op
            self.stats["skipped"] += 1
            self._note("skipped_degenerate", u1, 1.0, 0)
            return None
        dev = arr.device
        N = arr.N
        r_u = self._on_device("_ru_ent", r_u_h, torch.int64, dev)

        # ---- static side (usage-independent; pod_valid excluded) ----
        skey_arrays = (
            pc, r_u_h, arr.pod_tol_ns, arr.pod_nodename, arr.pod_terms,
            arr.pod_has_sel, arr.sel_mask, arr.sel_kind, arr.node_valid,
            arr.node_labels, arr.node_taint_ns,
        )
        skey_meta = (u1, N, cfg, str(dev))
        action = None
        if not (
            self._static_key is not None
            and self._static_key[1] == skey_meta
            and all(a is b for a, b in zip(self._static_key[0], skey_arrays))
        ):
            self._stat = static_hoist(arr, r_u)
            self._static_key = (skey_arrays, skey_meta)
            self.stats["static_rebuilds"] += 1
            self._usage_key = None  # classes / N / cfg moved: rebuild below
            action = "static_rebuild"

        # ---- usage side ----
        req_u = arr.pod_req[r_u].contiguous()
        pod_req_h = host.pod_req if host is not None else arr.pod_req.cpu().numpy()
        used_h = host.node_used if host is not None else arr.node_used.cpu().numpy()
        req_u_h = np.ascontiguousarray(pod_req_h[r_u_h])
        ukey_meta = (u1, N, cfg, str(dev))
        usage_ok = (
            self._usage_key is not None
            and self._usage_key[1] == ukey_meta
            and self._usage_key[0] is arr.node_alloc
            and np.array_equal(self._req_u_host, req_u_h)
        )
        used = arr.node_used
        n_dirty, dirty = 0, None
        if usage_ok and used_h is not self._prev_used:
            dirty = np.flatnonzero((used_h != self._prev_used).any(axis=1))
            n_dirty = len(dirty)
        if not usage_ok or 2 * n_dirty >= N:
            self._usage = usage_hoist(req_u, used, arr.node_alloc, cfg)
            self.stats["full"] += 1
            frac, ncols = 1.0, N
            action = action or "full"
        elif n_dirty == 0:
            self.stats["hits"] += 1
            frac, ncols = 0.0, 0
            action = action or "hit"
        else:
            cols_h = np.full(_round_up_pow2(n_dirty), N, dtype=np.int32)
            cols_h[:n_dirty] = dirty
            cols = h2d(cols_h, dev)
            self._usage = patch_hoist(self._usage[0], self._usage[1], req_u, used, arr.node_alloc, cols, cfg)
            self.stats["hits"] += 1
            self.stats["patched"] += 1
            self.stats["patched_cols"] += n_dirty
            n_real = getattr(meta, "n_nodes", 0) or N
            frac, ncols = n_dirty / max(1, n_real), n_dirty
            action = action or "patch"
        self._usage_key = (arr.node_alloc, ukey_meta)
        self._req_u_host = req_u_h
        self._prev_used = used_h

        cls = self._on_device("_cls_ent", pc, torch.int32, dev)
        self._note(action, u1, frac, ncols)
        return IncState(cls=cls, req_u=req_u, stat_u=self._stat, base_u=self._usage[0], fit_u=self._usage[1])


__all__ = [
    "HoistCache", "IncState", "class_view", "static_hoist", "usage_hoist", "patch_hoist",
    "_static_hoist_plain", "_usage_hoist_plain", "_patch_hoist_plain", "_round_up_pow2",
]
