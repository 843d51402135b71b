"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device; whether a
card is present is decided in a fixture, never at import.  The file imports
no JAX, so it runs on the card's machine without the JAX package's test
setup:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

Tolerance: none.  The static-feasibility kernel must equal the plain mask
(torch.equal); the fit-scan kernel's choices and final usage must equal the
plain scan's, which needs every score bitwise equal wherever a tie or a
near-tie decides.
"""

import dataclasses

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.api.snapshot import ClusterArrays, encode_snapshot
from kubernetes_tpu_torch.bench.workloads import heterogeneous, mixed
from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, filters, infer_score_config, kernels
from kubernetes_tpu_torch.ops.assign import schedule_scan_plain

pytestmark = pytest.mark.cuda

STRATEGIES = {
    "least": ("LeastAllocated", ((0.0, 0.0), (100.0, 10.0))),
    "most": ("MostAllocated", ((0.0, 0.0), (100.0, 10.0))),
    "rtcr": ("RequestedToCapacityRatio", ((0.0, 10.0), (50.0, 2.0), (100.0, 0.0))),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card: python -m pytest --noconftest "
                    "-m cuda tests/test_torch_kernels.py")
    kernels.build()
    return torch.device("cuda")


def _random_arrays(seed: int, P: int, N: int, R: int = 5, T: int = 40, TT: int = 3,
                   S: int = 12, E: int = 3, L: int = 70) -> ClusterArrays:
    """Arrays no encoder would make but every kernel must take: wide taint
    and label vocabularies, several terms per pod, zero capacities, usage
    near int32 max, invalid pods and nodes, odd N."""
    rng = np.random.default_rng(seed)
    big = rng.random((N, R)) < 0.1
    alloc = np.where(big, rng.integers(2**30, 2**31 - 1, (N, R)), rng.integers(0, 5000, (N, R)))
    alloc[rng.random((N, R)) < 0.05] = 0
    used = (alloc * rng.random((N, R)) * 0.5).astype(np.int64)
    req = rng.integers(0, 400, (P, R))
    req[rng.random((P, R)) < 0.2] = 0
    terms = rng.integers(-1, S, (P, TT))
    kind = rng.integers(0, 4, (S, E))
    return ClusterArrays.from_numpy(dict(
        node_valid=rng.random(N) < 0.95, node_alloc=alloc.astype(np.int32),
        node_used=used.astype(np.int32), node_unsched=np.zeros(N, bool),
        node_labels=rng.random((N, L)) < 0.2, node_taint_ns=rng.random((N, T)) < 0.03,
        pod_valid=rng.random(P) < 0.97, pod_req=req.astype(np.int32),
        pod_prio=np.zeros(P, np.int32), pod_tol_ns=rng.random((P, T)) < 0.5,
        pod_nodename=np.where(rng.random(P) < 0.1, rng.integers(-2, N, P), -1).astype(np.int32),
        pod_terms=terms.astype(np.int32), pod_has_sel=rng.random(P) < 0.5,
        sel_mask=rng.random((S, E, L)) < 0.1, sel_kind=kind.astype(np.int32),
    ), "cuda")


def _check_static_feasible(arr):
    sf = kernels.static_feasible(arr)
    assert torch.equal(sf, filters.static_feasible_plain(arr))
    return sf


def _check_fit_scan(arr, sf, cfg):
    ck, uk, n_scored = kernels.fit_scan(sf, arr, cfg)
    cp, up = schedule_scan_plain(arr, cfg, sf=sf)
    assert torch.equal(ck, cp)
    assert torch.equal(uk, up)
    assert int(n_scored.item()) > 0


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_mixed_snapshot(card, strategy):
    name, shape = STRATEGIES[strategy]
    arr, _ = encode_snapshot(mixed(), device=card)
    cfg = infer_score_config(arr, dataclasses.replace(DEFAULT_SCORE_CONFIG, fit_strategy=name, rtcr_shape=shape))
    _check_fit_scan(arr, _check_static_feasible(arr), cfg)


@pytest.mark.parametrize("seed,N,score_resources", [
    (0, 997, (0, 1, 3)), (1, 2048, (0, 1, 3)), (2, 3001, (0, 1, 3)),
    # fit_scan is a template on the number of scored resources (1..8)
    (3, 1024, (2,)), (4, 1024, (4, 0, 1, 3, 2)), (5, 1024, (0, 1, 2, 3, 4, 0, 1, 2)),
])
def test_random_arrays(card, seed, N, score_resources):
    arr = _random_arrays(seed, P=300, N=N)
    sf = _check_static_feasible(arr)
    for name, shape in STRATEGIES.values():
        _check_fit_scan(arr, sf, dataclasses.replace(
            DEFAULT_SCORE_CONFIG, fit_strategy=name, rtcr_shape=shape, enable_pairwise=False,
            enable_ports=False, enable_taint_score=False, enable_node_pref=False, enable_image=False,
            score_resources=score_resources, fit_weight=1.3, balanced_weight=0.7))


def test_heterogeneous_counts_launches(card):
    arr, _ = encode_snapshot(heterogeneous(500, 1500), device=card)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    kernels.reset_launches()
    from kubernetes_tpu_torch.ops import schedule_batch

    choices, used = schedule_batch(arr, cfg)
    assert kernels.LAUNCHES == {"static_feasible": 1, "fit_scan": 1}
    cp, up = schedule_scan_plain(arr, cfg)
    assert torch.equal(choices, cp) and torch.equal(used, up)


def test_wrappers_refuse_bad_inputs(card):
    arr, _ = encode_snapshot(mixed(), device=card)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    sf = kernels.static_feasible(arr)
    with pytest.raises(ValueError, match="contiguous"):
        kernels.fit_scan(sf.t().contiguous().t(), arr, cfg)
    with pytest.raises(ValueError, match="dtype"):
        kernels.fit_scan(sf.to(torch.uint8), arr, cfg)
    with pytest.raises(ValueError, match="score_resources"):
        kernels.fit_scan(sf, arr, dataclasses.replace(cfg, score_resources=(0, 9)))
