"""The per-pod route at small batches, on the CPU.

A scheduling cycle of 1 to 8 pending pods (the encoder buckets P to 8: no
chunked or rounds route takes it) goes through ops.assign.dispatch to the
per-pod route, fit-only and with the full stage set, and is held exactly
(choices and final usage) against the JAX package's schedule_scan on the
same snapshot.  Then the one-device kernels' cluster layout, replayed in
Python (tests/torch_perpod_cases.py), against a plain argmax with ties for
every cluster width up to 16 and every node count up to 70.  Tolerance:
none.
"""

import jax
import numpy as np
import pytest

import torch_perpod_cases as pc
from kubernetes_tpu.api.snapshot import encode_snapshot as jax_encode
from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG as JAX_DEFAULT
from kubernetes_tpu.ops import infer_score_config as jax_infer
from kubernetes_tpu.ops.assign import schedule_scan as jax_schedule_scan
from kubernetes_tpu_torch.api.snapshot import encode_snapshot
from kubernetes_tpu_torch.bench import workloads as tw
from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, infer_score_config
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SNAPSHOTS = {
    "fit-only": (lambda k: tw.heterogeneous(40, k, seed=k), True),
    "spread-affinity": (lambda k: tw.spread_affinity(30, k, seed=k), False),
    "all-stages": (lambda k: tw.all_stages(24, k, seed=k), False),
}


@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("name", sorted(SNAPSHOTS))
def test_small_batch_takes_the_per_pod_route_and_matches_jax(name, k):
    make, fit_only = SNAPSHOTS[name]
    snap = make(k)
    arr, meta = encode_snapshot(snap, device="cpu")
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    assert arr.P == 8 and meta.n_pods == k
    assert assign.fit_only(cfg, arr) == fit_only
    assert not assign._chunkable(arr, cfg) and not assign._rounds_capable(arr, cfg)
    assign.reset_trace_counts()
    step = assign.dispatch(arr, cfg, device="cpu")
    assert assign.TRACE_COUNTS["plain"] == 1
    assert step.sweeps == arr.P and step.ordinals.tolist() == list(range(arr.P))
    ja, _ = jax_encode(snap)
    jc, ju = jax.jit(jax_schedule_scan, static_argnames=("cfg",))(ja, jax_infer(ja, JAX_DEFAULT))
    np.testing.assert_array_equal(step.choices.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(step.used.numpy(), np.asarray(ju))
    assert (step.choices[k:] == -1).all()


def _totals(rng, N: int):
    """Scores with many ties (a few levels) and infeasible nodes (-inf)."""
    levels = rng.integers(0, 4, N).astype(float)
    levels[rng.random(N) < 0.3] = -np.inf
    return levels.tolist()


@pytest.mark.parametrize("cap", range(1, pc.MAX_KC + 1))
@pytest.mark.parametrize("kernel", ["fit_scan", "full_scan"])
def test_cluster_replay_matches_plain_argmax(kernel, cap):
    rng = np.random.default_rng(cap)
    for n_real in range(1, 71):
        if kernel == "fit_scan":  # the wrapper pads N to the unit with nodes that never pass
            N = -(-n_real // pc.UNIT) * pc.UNIT
            kc, run_lo = pc.fit_width(cap, N), pc.fit_run_lo
        else:
            N = n_real
            kc, run_lo = pc.full_width(cap, N), pc.full_run_lo
        assert 1 <= kc <= cap
        bounds = [run_lo(q, kc, N) for q in range(kc + 1)]
        assert bounds[0] == 0 and bounds[-1] == N and all(a < b for a, b in zip(bounds, bounds[1:]))
        if kernel == "fit_scan":
            assert all(b % pc.UNIT == 0 for b in bounds)
        for trial in range(3):
            total = _totals(rng, n_real) + [-np.inf] * (N - n_real)
            if trial == 1:  # equal top scores on both sides of each run boundary
                for b in bounds[1:-1]:
                    total[b - 1] = total[b] = 9.0
            want = pc.plain_argmax(total)
            for nt in (pc.NT, 3):  # one node a thread, and several
                assert pc.cluster_choice(total, kc, run_lo, nt) == want, (kc, N, trial, nt)
