"""Score (Score extension point) functions — the port of the JAX package's
``ops/scores.py``: the fit strategies, BalancedAllocation, the
PreferNoSchedule count plane and the reversed normalisation.

Score arithmetic is float32 in ONE explicit op order, the JAX package's, so
the plain versions here are bitwise equal to it on the CPU
(tests/test_torch_scores.py) and the fit-scan kernel (csrc/fit_scan.cu),
which inlines the same formulas compiled with -fmad=false, is bitwise equal
to them on the card.  Small sums over the scored resources run in sequence
(x0 + x1 ...), never as a tree: the order is part of the result.  The mean
over K scored resources is that sum times f32(1/K), as XLA lowers it.
MaxNodeScore = 100.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch

MAX_NODE_SCORE = 100.0


@dataclass(frozen=True)
class ScoreConfig:
    """Default-profile plugin weights and the scored resource axis indices
    (cpu, memory), the same fields as the JAX package's ScoreConfig."""

    fit_weight: float = 1.0  # NodeResourcesFit score weight
    # LeastAllocated (default) | MostAllocated | RequestedToCapacityRatio
    fit_strategy: str = "LeastAllocated"
    # RequestedToCapacityRatio shape as (utilization%, score 0..10) points,
    # sorted by utilization
    rtcr_shape: Tuple[Tuple[float, float], ...] = ((0.0, 0.0), (100.0, 10.0))
    balanced_weight: float = 1.0  # NodeResourcesBalancedAllocation
    taint_weight: float = 3.0
    node_affinity_weight: float = 2.0
    spread_weight: float = 2.0
    interpod_weight: float = 2.0
    hard_pod_affinity_weight: float = 1.0
    image_weight: float = 1.0
    score_resources: Tuple[int, ...] = (0, 1)  # indices into the R axis
    enable_pairwise: bool = True
    enable_ports: bool = True
    enable_taint_score: bool = True
    enable_node_pref: bool = True
    enable_image: bool = True
    enable_interpod_score: bool = True


DEFAULT_SCORE_CONFIG = ScoreConfig()

FIT_STRATEGIES = ("LeastAllocated", "MostAllocated", "RequestedToCapacityRatio")

def _any(x) -> bool:
    """Host truth of `x.any()` for a numpy array or a tensor."""
    return bool(x.any())


def infer_score_config(arr, cfg: ScoreConfig = DEFAULT_SCORE_CONFIG) -> ScoreConfig:
    """Specialize cfg to the snapshot: disable the stages the encoded arrays
    prove unused, reading the same evidence as the JAX package's
    ops/scores.py:75 (host arrays or tensors; one host read per field on
    the card)."""
    has_terms = (
        _any(arr.pod_aff_terms >= 0) or _any(arr.pod_anti_terms >= 0)
        or _any(arr.pod_spread_terms >= 0) or _any(arr.anti_counts0 > 0)
    )
    has_ports = _any(arr.pod_ports) or _any(arr.node_ports0)
    has_prefer_taints = _any(arr.node_taint_pref)
    has_node_pref = _any(arr.pod_pref_terms >= 0)
    has_image = arr.image_score.shape[1] == arr.N and _any(arr.image_score != 0)
    has_interpod_pref = (
        _any(arr.pod_pref_aff_terms >= 0) or _any(arr.pref_own0 != 0)
        # committed pods' REQUIRED affinity terms score toward later pods
        # at hardPodAffinityWeight, so required terms alone need the stage
        or (cfg.hard_pod_affinity_weight > 0 and _any(arr.pod_aff_terms >= 0))
    )
    return dataclasses.replace(
        cfg,
        enable_pairwise=has_terms or has_interpod_pref,
        enable_ports=has_ports,
        enable_taint_score=has_prefer_taints,
        enable_node_pref=has_node_pref,
        enable_image=has_image,
        enable_interpod_score=has_interpod_pref,
    )


def check_config(cfg: ScoreConfig) -> None:
    """Raise on a config the port cannot run: an unknown fit strategy."""
    if cfg.fit_strategy not in FIT_STRATEGIES:
        raise ValueError(f"unknown fit scoringStrategy {cfg.fit_strategy!r}")


def _cols(requested: torch.Tensor, alloc: torch.Tensor, res_idx):
    """(a, r) per scored resource, each f32[N]."""
    return [(alloc[:, i].to(torch.float32), requested[:, i].to(torch.float32)) for i in res_idx]


def _mean(per_res) -> torch.Tensor:
    """Sequential sum times f32(1/K): XLA lowers the JAX package's mean over
    K resources to that multiply, not to a division."""
    acc = per_res[0]
    for x in per_res[1:]:
        acc = acc + x
    return acc * torch.tensor(1.0 / len(per_res), dtype=torch.float32, device=acc.device)


def least_allocated(requested: torch.Tensor, alloc: torch.Tensor, res_idx) -> torch.Tensor:
    """f32[N]: max(0, (a - r) * 100 / a) per resource (0 when a == 0), meaned."""
    per = []
    for a, r in _cols(requested, alloc, res_idx):
        x = torch.clamp_min((a - r) * MAX_NODE_SCORE / a, 0.0)
        per.append(torch.where(a > 0, x, torch.zeros_like(x)))
    return _mean(per)


def most_allocated(requested: torch.Tensor, alloc: torch.Tensor, res_idx) -> torch.Tensor:
    """f32[N]: r * 100 / a per resource; 0 when a == 0 or r > a; meaned."""
    per = []
    for a, r in _cols(requested, alloc, res_idx):
        x = r * MAX_NODE_SCORE / torch.where(a > 0, a, torch.ones_like(a))
        per.append(torch.where((a > 0) & (r <= a), x, torch.zeros_like(x)))
    return _mean(per)


def interp_shape_f32(util: torch.Tensor, shape) -> torch.Tensor:
    """Piecewise-linear interpolation through the shape points in one f32
    op order: y0 + t*(y1-y0), t = (u-x0)/(x1-x0); clamps outside the shape.
    The points live on util's device: on CUDA, torch divides by a CPU scalar
    as a multiply by its reciprocal, which is not IEEE division."""
    pts = torch.tensor(shape, dtype=torch.float32, device=util.device)
    xs, ys = pts[:, 0], pts[:, 1]
    out = torch.full_like(util, float(ys[-1]))
    for i in range(len(shape) - 1, 0, -1):
        tt = (util - xs[i - 1]) / (xs[i] - xs[i - 1])
        seg = ys[i - 1] + tt * (ys[i] - ys[i - 1])
        out = torch.where(util <= xs[i], seg, out)
    return torch.where(util <= xs[0], ys[0], out)


def requested_to_capacity_ratio(requested: torch.Tensor, alloc: torch.Tensor, res_idx, shape) -> torch.Tensor:
    """f32[N]: utilization r*100/a (100 when a == 0) through the shape
    (scores 0..10), rescaled to 100, meaned."""
    per = []
    for a, r in _cols(requested, alloc, res_idx):
        util = r * 100.0 / torch.where(a > 0, a, torch.ones_like(a))
        util = torch.where(a > 0, util, torch.full_like(util, 100.0))
        per.append(interp_shape_f32(util, shape) * (MAX_NODE_SCORE / 10.0))
    return _mean(per)


def fit_score(requested: torch.Tensor, alloc: torch.Tensor, cfg: ScoreConfig) -> torch.Tensor:
    """NodeResourcesFit's Score, dispatched on the scoringStrategy."""
    if cfg.fit_strategy == "MostAllocated":
        return most_allocated(requested, alloc, cfg.score_resources)
    if cfg.fit_strategy == "RequestedToCapacityRatio":
        return requested_to_capacity_ratio(requested, alloc, cfg.score_resources, cfg.rtcr_shape)
    if cfg.fit_strategy != "LeastAllocated":
        raise ValueError(f"unknown fit scoringStrategy {cfg.fit_strategy!r}")
    return least_allocated(requested, alloc, cfg.score_resources)


def balanced_allocation(requested: torch.Tensor, alloc: torch.Tensor, res_idx) -> torch.Tensor:
    """f32[N]: (1 - popstd(min(1, r/a) over resources with a > 0)) * 100."""
    cols = _cols(requested, alloc, res_idx)
    pres = [a > 0 for a, _ in cols]
    fs = [
        torch.where(p, torch.clamp_max(r / torch.where(p, a, torch.ones_like(a)), 1.0), torch.zeros_like(a))
        for (a, r), p in zip(cols, pres)
    ]
    cnt = pres[0].to(torch.int32)
    for p in pres[1:]:
        cnt = cnt + p.to(torch.int32)
    cnt = torch.clamp_min(cnt, 1).to(torch.float32)
    fsum = fs[0]
    for f in fs[1:]:
        fsum = fsum + f
    mean = fsum / cnt
    var = None
    for f, p in zip(fs, pres):
        d = f - mean
        sq = torch.where(p, d * d, torch.zeros_like(d))
        var = sq if var is None else var + sq
    var = var / cnt
    # sqrt taken in f64 and rounded once to f32 is the correctly rounded f32
    # sqrt (what XLA and CUDA's sqrtf give); torch's f32 sqrt on the CPU is
    # not correctly rounded
    std = torch.sqrt(var.to(torch.float64)).to(torch.float32)
    return (1.0 - std) * MAX_NODE_SCORE


def taint_prefer_counts_plain(pod_tol_pref: torch.Tensor, node_taint_pref: torch.Tensor) -> torch.Tensor:
    """bf16[P, N] count of intolerable PreferNoSchedule taints, the raw
    TaintToleration score (tainttoleration/taint_toleration.go —
    CountIntolerableTaintsPreferNoSchedule): a counting product in f32
    (integer-valued, exact below 2^24 in any order), stored on the bf16
    lattice (f32 under KTPU_SCORE_DTYPE=f32; the JAX package's
    ops/scores.py:229 taint_prefer_counts).  The plain version of kernel
    K10 score_planes' first plane."""
    from . import bitplane

    counts = (~pod_tol_pref).to(torch.float32) @ node_taint_pref.to(torch.float32).t()
    return bitplane.quantize_scores(counts)


def normalize_reverse(counts: torch.Tensor, feasible: torch.Tensor) -> torch.Tensor:
    """f32[N]: DefaultNormalizeScore with reverse=true over the feasible set
    (helper/normalize_score.go): 100 - 100 * c / maxCount; all 100 when
    maxCount == 0.  A bf16 plane is upcast to f32 first (the JAX package's
    ops/scores.py:253 and the scan's norm_reverse, assign.py:241)."""
    counts = counts.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=counts.device)
    mx = torch.where(feasible, counts, zero).max(dim=-1, keepdim=True).values
    return torch.where(mx > 0, MAX_NODE_SCORE - MAX_NODE_SCORE * counts / mx,
                       torch.full_like(counts, MAX_NODE_SCORE))
