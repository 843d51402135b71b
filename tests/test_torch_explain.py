"""The unschedulable diagnosis (ops/explain.py) in the port against the JAX
package's ops/explain.py.

On the CPU, with the JAX encoder's arrays carried across
(convert.from_jax_arrays / from_jax_meta), so both sides read the same
inputs:

- on random clusters with taints and selectors (seeds 3, 11, 29; every
  pod row's class), the port's explain_classes equals the JAX
  explain_classes, which equals the JAX explain_oracle; every row sums to
  the valid-node count; the port's own explain_oracle agrees;
- a supplied usage moves a node's claim to "Insufficient cpu";
- class_groups dedupes classes and falls back to one class per row;
- render_unschedulable and dominant_reason give the JAX strings;
- F = 1, 4 and 5 reps (padded to 4, 4 and 8);
- a cluster with 70 distinct taints (T >= 64);
- diagnose_failed's messages, dominant reasons and records on the JAX
  test's mixed nodes and failing pods.

The ``cuda`` legs import no JAX and skip without a card: kernel K14
explain_counts == the plain version on the port's own encodings (mixed,
wide taints through the DeltaEncoder's packed transfer and K9) at random
usage, and == the plain version and the numpy replay of its decomposition
(tests/torch_score_explain_cases.py) at the edge shapes and past each of
its staging limits, one launch a call:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_explain.py

Tolerance: none (integer counts).
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.api.delta import DeltaEncoder, class_groups
from kubernetes_tpu_torch.api.snapshot import encode_snapshot
from kubernetes_tpu_torch.bench import workloads as tw
from kubernetes_tpu_torch.convert import from_jax_arrays, from_jax_meta
from kubernetes_tpu_torch.ops import explain as tex
from kubernetes_tpu_torch.ops import kernels
import torch_score_explain_cases as cases
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side (imported here, not at module level, so the
    cuda legs run where JAX is not installed)."""
    pytest.importorskip("jax")
    import helpers
    from kubernetes_tpu.api import types as jt
    from kubernetes_tpu.api.delta import DeltaEncoder as JDeltaEncoder
    from kubernetes_tpu.api.delta import class_groups as jclass_groups
    from kubernetes_tpu.api.snapshot import Snapshot as JSnapshot
    from kubernetes_tpu.ops import explain as jex

    return dict(t=jt, enc=JDeltaEncoder, class_groups=jclass_groups, ex=jex, Snapshot=JSnapshot, h=helpers)


def carry(ja):
    return from_jax_arrays({f.name: np.asarray(getattr(ja, f.name)) for f in dataclasses.fields(ja)}, "cpu")


def _mixed_nodes(jx):
    t, h = jx["t"], jx["h"]
    return [
        h.mk_node("n0", cpu=1000, labels={"zone": "a"}),
        h.mk_node("n1", cpu=1000, labels={"zone": "b"}, taints=(t.Taint(key="gpu", effect=t.NO_SCHEDULE),)),
        h.mk_node("n2", cpu=120, labels={"zone": "a"}),
        h.mk_node("n3", cpu=1000, unschedulable=True),
    ]


def _failing_pods(jx):
    h = jx["h"]
    return [
        h.mk_pod("fit0", cpu=100),
        h.mk_pod("big0", cpu=5000),
        h.mk_pod("zoned0", cpu=50, node_selector={"zone": "nowhere"}),
        h.mk_pod("zoned1", cpu=50, node_selector={"zone": "nowhere"}),
        h.mk_pod("pinned", cpu=50, node_name="n2"),
        h.mk_pod("lost", cpu=50, node_name="gone"),
    ]


def _random(jx, seed, n_nodes=16, n_pods=48):
    snap = jx["h"].random_cluster(random.Random(seed), n_nodes=n_nodes, n_pods=n_pods, with_taints=True,
                                  with_selectors=True)
    return jx["enc"]().encode(snap)


def _both(jx, ja, reps, used=None):
    """(port, JAX, JAX oracle) counts."""
    got = tex.explain_classes(carry(ja), reps, used)
    want = jx["ex"].explain_classes(ja, reps, used)
    oracle = jx["ex"].explain_oracle(ja, reps, used)
    return got, want, oracle


@pytest.mark.parametrize("seed", [3, 11, 29])
def test_counts_equal_jax_and_oracle(jx, seed):
    ja, jm = _random(jx, seed)
    reps, _ = jx["class_groups"](jm, list(range(jm.n_pods)))
    got, want, oracle = _both(jx, ja, reps)
    assert got.dtype == np.int64 and got.shape == (reps.size, tex.n_reasons(ja.pod_req.shape[1]))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, oracle)
    np.testing.assert_array_equal(tex.explain_oracle(carry(ja), reps), oracle)
    assert (got.sum(axis=1) == int(np.asarray(ja.node_valid).sum())).all()


def test_counts_respect_supplied_usage(jx):
    snap = jx["Snapshot"](nodes=_mixed_nodes(jx), pending_pods=[jx["h"].mk_pod("p", cpu=500)])
    ja, jm = jx["enc"]().encode(snap)
    used = np.array(ja.node_used, copy=True)
    used[0, jm.resources.index("cpu")] += 900  # n0 nearly full now
    got, want, oracle = _both(jx, ja, np.array([0]), used)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle)
    labels = tex.reason_labels(jm.resources)
    assert labels == jx["ex"].reason_labels(jm.resources)
    assert {labels[j]: int(got[0, j]) for j in range(len(labels))}["Insufficient cpu"] >= 1


def test_class_groups_dedupes_and_falls_back(jx):
    snap = jx["Snapshot"](nodes=_mixed_nodes(jx), pending_pods=_failing_pods(jx))
    _, jm = jx["enc"]().encode(snap)
    meta = from_jax_meta(jm)
    rows = list(range(jm.n_pods))
    reps, group_of = class_groups(meta, rows)
    jreps, jgroup_of = jx["class_groups"](jm, rows)
    np.testing.assert_array_equal(reps, jreps)
    assert group_of == jgroup_of
    assert len(reps) < len(rows)  # zoned0 and zoned1 share a spec
    meta.pod_class = None  # no class index: one class per row
    reps2, group_of2 = class_groups(meta, rows)
    assert list(reps2) == rows and all(group_of2[r] == i for i, r in enumerate(rows))


@pytest.mark.parametrize("counts", [
    {"Insufficient cpu": 2, "node(s) were unschedulable": 3},
    {},
    {"b reason": 1, "a reason": 1, "z": 0},
    {"first": 2, "second": 2, "third": 1},
    {"a": 1, "b": 3},
])
def test_render_and_dominant_reason_match_jax(jx, counts):
    assert tex.render_unschedulable(7, counts) == jx["ex"].render_unschedulable(7, counts)
    assert tex.dominant_reason(counts) == jx["ex"].dominant_reason(counts)


@pytest.mark.parametrize("F,padded", [(1, 4), (4, 4), (5, 8)])
def test_rep_padding(jx, F, padded):
    assert tex._pad_pow2(F) == padded
    ja, jm = _random(jx, 7, n_pods=64)
    rng = np.random.default_rng(F)
    reps = rng.choice(jm.n_pods, size=F, replace=False).astype(np.int64)
    used = np.asarray(ja.node_used) + rng.integers(0, 3, size=np.asarray(ja.node_used).shape).astype(np.int32)
    got, want, oracle = _both(jx, ja, reps, used)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle)


def test_wide_taints(jx):
    """70 distinct NoSchedule taints (T >= 64): the taint test over every
    vocab entry, pods tolerating none, one or two of them."""
    t, h = jx["t"], jx["h"]
    rng = random.Random(5)
    nodes = [h.mk_node(f"n{i}", cpu=rng.choice([1000, 4000]),
                       taints=(t.Taint(key=f"team-{i % 70}", value="x", effect=t.NO_SCHEDULE),) if i < 140 else (),
                       unschedulable=i % 17 == 0)
             for i in range(160)]
    pods = [h.mk_pod(f"p{i}", cpu=rng.choice([100, 2000, 3000]),
                     tolerations=tuple(t.Toleration(key=f"team-{k}", value="x", effect=t.NO_SCHEDULE)
                                       for k in rng.sample(range(70), i % 3)))
            for i in range(40)]
    ja, jm = jx["enc"]().encode(jx["Snapshot"](nodes=nodes, pending_pods=pods))
    assert np.asarray(ja.node_taint_ns).shape[1] >= 64
    reps, _ = jx["class_groups"](jm, list(range(jm.n_pods)))
    got, want, oracle = _both(jx, ja, reps)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, oracle)
    assert got[:, tex.R_TAINT].sum() > 0 and got[:, tex.R_UNSCHED].sum() > 0


def test_diagnose_failed_matches_jax(jx):
    snap = jx["Snapshot"](nodes=_mixed_nodes(jx), pending_pods=_failing_pods(jx))
    ja, jm = jx["enc"]().encode(snap)
    rows = list(range(jm.n_pods))
    used = np.array(ja.node_used, copy=True)
    used[2, jm.resources.index("cpu")] += 60
    got = tex.diagnose_failed(carry(ja), from_jax_meta(jm), rows, used)
    want = jx["ex"].diagnose_failed(ja, jm, rows, used)
    assert got == want
    assert len(got[2]) < len(rows) and all(m.startswith("0/4 nodes are available") for m in got[0].values())
    assert tex.diagnose_failed(carry(ja), from_jax_meta(jm), []) == ({}, {}, [])


def test_explain_enabled_gate(monkeypatch):
    monkeypatch.setenv("KTPU_EXPLAIN", "1")
    assert tex.explain_enabled()
    monkeypatch.setenv("KTPU_EXPLAIN", "0")
    assert not tex.explain_enabled()


# ---------------------------------------------------------------------------
# on the card: K14 explain_counts == plain
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card: python -m pytest --noconftest "
                    "-m cuda tests/test_torch_explain.py")
    kernels.build(["explain_counts", "unpack_planes"])
    return torch.device("cuda")


def _check_kernel(arr, seed):
    rng = np.random.default_rng(seed)
    used = arr.node_used + torch.from_numpy(rng.integers(0, 4, size=tuple(arr.node_used.shape))).to(
        arr.device, torch.int32) * arr.node_alloc // 4
    for F in (1, 5, min(arr.P, 64)):
        reps = torch.from_numpy(rng.choice(arr.P, size=F, replace=False).astype(np.int64)).to(arr.device)
        valid = torch.ones(F, dtype=torch.bool, device=arr.device)
        valid[0] = F == 1
        before = kernels.LAUNCHES["explain_counts"]
        got = kernels.explain_counts(arr, used, reps, valid)
        assert kernels.LAUNCHES["explain_counts"] == before + 1
        want = tex.explain_counts_plain(arr, used, reps, valid)
        assert torch.equal(got, want)
        np.testing.assert_array_equal(got.cpu().numpy(), tex.explain_counts_plain(
            arr.to("cpu"), used.cpu(), reps.cpu(), valid.cpu()).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(3))
def test_kernel_matches_plain_mixed(card, seed):
    arr, _ = encode_snapshot(tw.mixed(40, 160, seed=seed), device=card)
    _check_kernel(arr, seed)


@pytest.mark.cuda
def test_kernel_matches_plain_wide_taints(card):
    enc = DeltaEncoder(card)
    kernels.reset_launches()
    arr, meta = enc.encode_device(tw.wide_taints(300, 600))
    assert kernels.LAUNCHES["unpack_planes"] > 0  # the 80-wide planes came packed
    _check_kernel(arr, 7)
    reps, _ = class_groups(meta, range(meta.n_pods))
    got = tex.explain_classes(arr, reps, arr.node_used)
    np.testing.assert_array_equal(got, tex.explain_oracle(arr, reps, arr.node_used))


# the card's own staging limits (csrc/explain.cu): 256 taints, 256 named
# terms, a bitmap of 8192 terms; past each the kernel's per-pair fallback
CARD_EXPLAIN_CASES = {
    **{name: (kw, F) for name, (kw, F, knobs) in cases.EXPLAIN_CASES.items() if not knobs},
    "direct-taint": (dict(seed=41, N=300, P=60, T=300), 9),
    "direct-terms": (dict(seed=42, N=300, P=400, S=600, TT=8, E=1), 300),
    "wide-S": (dict(seed=43, N=200, P=60, S=9000, E=1, L=6), 12),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_EXPLAIN_CASES))
def test_kernel_matches_plain_edges(card, name):
    """K14 == plain == the numpy replay of its decomposition at the edge
    shapes, one launch a call; a second call (the accumulator the first
    left) gives the same counts."""
    kw, F = CARD_EXPLAIN_CASES[name]
    h = cases.cluster(**kw)
    reps, valid = cases.reps_of(kw["seed"], kw["P"], F)
    arr = cases.arrays(h, card)
    r, v = torch.from_numpy(reps).to(card), torch.from_numpy(valid).to(card)
    before = kernels.LAUNCHES["explain_counts"]
    got = kernels.explain_counts(arr, arr.node_used, r, v)
    assert kernels.LAUNCHES["explain_counts"] == before + 1
    assert torch.equal(got, tex.explain_counts_plain(arr, arr.node_used, r, v))
    np.testing.assert_array_equal(got.cpu().numpy(), cases.replay_explain(h, h["node_used"], reps, valid)[0])
    assert torch.equal(kernels.explain_counts(arr, arr.node_used, r, v), got)
    assert kernels.LAUNCHES["explain_counts"] == before + 2


@pytest.mark.cuda
def test_kernel_refuses_bad_inputs(card):
    arr, _ = encode_snapshot(tw.mixed(40, 160, seed=0), device=card)
    reps = torch.zeros(4, dtype=torch.int64, device=card)
    valid = torch.ones(4, dtype=torch.bool, device=card)
    with pytest.raises(ValueError):
        kernels.explain_counts(arr, arr.node_used.cpu(), reps, valid)
    with pytest.raises(ValueError):
        kernels.explain_counts(arr, arr.node_used, reps.to(torch.int32), valid)
