"""The port's score functions against the JAX package's, bit for bit.

Inputs are random int32 (requested, allocatable) pairs from numpy, with
zero allocatable, exact fits, over-capacity requests and values up to
int32 max.  Tolerance: none — every f32 result must have the same bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import scores as js
from kubernetes_tpu_torch.ops import scores as ts
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SHAPE_DEFAULT = ((0.0, 0.0), (100.0, 10.0))
SHAPE_3 = ((0.0, 10.0), (50.0, 2.0), (100.0, 0.0))
SEEDS = (0, 1, 2)


def _inputs(seed: int, n: int = 4096, r: int = 5):
    """(requested, alloc) int32[n, r]: a mix of magnitudes, alloc == 0,
    requested == alloc, requested > alloc and requested == 0."""
    rng = np.random.default_rng(seed)
    hi = rng.choice([100, 10_000, 2**20, 2**31 - 1], size=(n, r))
    alloc = rng.integers(0, hi, size=(n, r), dtype=np.int64)
    alloc[rng.random((n, r)) < 0.1] = 0
    frac = rng.random((n, r)) * 1.5  # up to 50% over capacity
    req = np.minimum(alloc * frac, 2**31 - 1).astype(np.int64)
    req[rng.random((n, r)) < 0.1] = 0
    exact = rng.random((n, r)) < 0.1
    req[exact] = alloc[exact]
    over = rng.random((n, r)) < 0.05
    req[over] = rng.integers(1, 2**31 - 1, size=int(over.sum()))
    return req.astype(np.int32), alloc.astype(np.int32)


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def _same_bits(j, t) -> None:
    np.testing.assert_array_equal(_bits(j), _bits(t.numpy()))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("res_idx", [(0, 1), (0, 1, 4)])
def test_least_allocated_bitwise(seed, res_idx):
    req, alloc = _inputs(seed)
    _same_bits(
        js.least_allocated(jnp.asarray(req), jnp.asarray(alloc), res_idx),
        ts.least_allocated(torch.from_numpy(req), torch.from_numpy(alloc), res_idx),
    )


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("res_idx", [(0, 1), (0, 1, 4)])
def test_most_allocated_bitwise(seed, res_idx):
    req, alloc = _inputs(seed)
    _same_bits(
        js.most_allocated(jnp.asarray(req), jnp.asarray(alloc), res_idx),
        ts.most_allocated(torch.from_numpy(req), torch.from_numpy(alloc), res_idx),
    )


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [SHAPE_DEFAULT, SHAPE_3], ids=["default", "3pt"])
def test_requested_to_capacity_ratio_bitwise(seed, shape):
    req, alloc = _inputs(seed)
    _same_bits(
        js.requested_to_capacity_ratio(jnp.asarray(req), jnp.asarray(alloc), (0, 1), shape),
        ts.requested_to_capacity_ratio(torch.from_numpy(req), torch.from_numpy(alloc), (0, 1), shape),
    )


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [SHAPE_DEFAULT, SHAPE_3, ((0.0, 0.1), (100.0, 0.3))],
                         ids=["default", "3pt", "non-round-trip"])
def test_interp_shape_bitwise(seed, shape):
    util = np.random.default_rng(seed).uniform(-20.0, 140.0, size=4096).astype(np.float32)
    util[:4] = [0.0, 50.0, 100.0, -0.0]
    _same_bits(js.interp_shape_f32(jnp.asarray(util), shape), ts.interp_shape_f32(torch.from_numpy(util), shape))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("res_idx", [(0, 1), (0, 1, 4)])
def test_balanced_allocation_bitwise(seed, res_idx):
    req, alloc = _inputs(seed)
    _same_bits(
        js.balanced_allocation(jnp.asarray(req), jnp.asarray(alloc), res_idx),
        ts.balanced_allocation(torch.from_numpy(req), torch.from_numpy(alloc), res_idx),
    )


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("strategy,shape", [
    ("LeastAllocated", SHAPE_DEFAULT),
    ("MostAllocated", SHAPE_DEFAULT),
    ("RequestedToCapacityRatio", SHAPE_3),
])
def test_fit_score_bitwise(seed, strategy, shape):
    req, alloc = _inputs(seed)
    jcfg = js.ScoreConfig(fit_strategy=strategy, rtcr_shape=shape)
    tcfg = ts.ScoreConfig(fit_strategy=strategy, rtcr_shape=shape)
    _same_bits(
        js.fit_score(jnp.asarray(req), jnp.asarray(alloc), jcfg),
        ts.fit_score(torch.from_numpy(req), torch.from_numpy(alloc), tcfg),
    )


def test_weighted_total_bitwise():
    """The scan's total, fit_weight*fit + balanced_weight*balanced, with
    non-unit weights (no fused multiply-add on either side)."""
    req, alloc = _inputs(7)
    jr, ja = jnp.asarray(req), jnp.asarray(alloc)
    jcfg = js.ScoreConfig(fit_weight=1.7, balanced_weight=0.3)
    tcfg = ts.ScoreConfig(fit_weight=1.7, balanced_weight=0.3)
    j = jcfg.fit_weight * js.fit_score(jr, ja, jcfg) + jcfg.balanced_weight * js.balanced_allocation(
        jr, ja, jcfg.score_resources)
    rt, at = torch.from_numpy(req), torch.from_numpy(alloc)
    t = tcfg.fit_weight * ts.fit_score(rt, at, tcfg) + tcfg.balanced_weight * ts.balanced_allocation(
        rt, at, tcfg.score_resources)
    _same_bits(j, t)


def test_unknown_strategy_raises():
    req, alloc = _inputs(0, n=8)
    with pytest.raises(ValueError, match="scoringStrategy"):
        ts.fit_score(torch.from_numpy(req), torch.from_numpy(alloc), ts.ScoreConfig(fit_strategy="Sideways"))
