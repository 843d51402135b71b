"""Batched assignment with sequential-commit semantics — the port of the JAX
package's ``ops/assign.py`` ``schedule_scan`` for the fit-only stage set.

Static feasibility is evaluated for the whole batch up front ([P, N]); then
pods commit one at a time in activeQ order (== tensor order).  Each step
re-evaluates NodeResourcesFit.Filter against the running node usage, scores
the feasible nodes (fit strategy + BalancedAllocation), takes the highest
score with ties to the LOWEST node index, and adds the pod's request to the
chosen node's usage.

``schedule_scan_plain`` is the plain PyTorch version (one Python step per
pod).  ``schedule_batch`` is the entry point: on the card it runs the
static-feasibility kernel and the fit-scan kernel (csrc/), on the CPU the
plain versions.  Stages this slice does not port raise NotImplementedError
(ops/scores.py — check_config).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..device import resolve_device
from . import filters
from .scores import ScoreConfig, balanced_allocation, check_config, fit_score

_INT_MAX = 2**31 - 1


def schedule_scan_plain(arr, cfg: ScoreConfig, sf: torch.Tensor = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (choices i32[P] node index or -1, node_used i32[N, R]), the plain
    per-pod scan.  `sf` is the static-feasibility mask (computed with the
    plain version when not given)."""
    if sf is None:
        sf = filters.static_feasible_plain(arr)
    dev = arr.device
    alloc = arr.node_alloc
    used = arr.node_used.clone()
    nodes = torch.arange(arr.N, dtype=torch.int32, device=dev)
    int_max = torch.tensor(_INT_MAX, dtype=torch.int32, device=dev)
    neg_inf = torch.tensor(float("-inf"), dtype=torch.float32, device=dev)
    choices = torch.full((arr.P,), -1, dtype=torch.int32, device=dev)
    valid = arr.pod_valid.cpu().tolist()
    for p in range(arr.P):
        if not valid[p]:
            continue  # a padding or gated pod: its sf row is all False
        req = arr.pod_req[p]
        feasible = sf[p] & filters.fit_ok(req, used, alloc)
        requested = used + req[None, :]
        total = cfg.fit_weight * fit_score(requested, alloc, cfg) + cfg.balanced_weight * balanced_allocation(
            requested, alloc, cfg.score_resources
        )
        total = torch.where(feasible, total, neg_inf)
        best = total.max()
        cand = torch.where((total == best) & feasible, nodes, int_max)
        choice = torch.where(best > neg_inf, cand.min(), torch.tensor(-1, dtype=torch.int32, device=dev))
        choices[p] = choice
        placed = (nodes == choice)[:, None]
        used = used + placed.to(torch.int32) * req[None, :]
    return choices, used


def schedule_batch(arr, cfg: ScoreConfig, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scheduling step: -> (choices i32[P], node_used i32[N, R]) on
    `device` (the card unless the caller passes device="cpu")."""
    dev = resolve_device(device)
    check_config(cfg)
    if arr.device.type != dev.type:
        arr = arr.to(dev)
    sf = filters.static_feasible(arr)
    if dev.type == "cpu":
        return schedule_scan_plain(arr, cfg, sf=sf)
    from . import kernels

    return kernels.fit_scan(sf, arr, cfg)[:2]
