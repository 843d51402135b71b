"""The port's pairwise row functions and score-plane functions on the CPU
against the JAX package's, and kernel K10 (and K7's eligibility plane)
against their plain versions on the card.

On the CPU, on arrays made with numpy from a seed (integer-valued count
planes, -1 padded slots, keyless nodes, repeated terms):

- api/pairwise.py ``_match_matrix`` equals ``_matches`` pair by pair and
  the JAX package's ``_match_matrix``;
- ops/pairwise.py ``spread_step``, ``interpod_required_ok``,
  ``interpod_pref_raw``, ``ports_ok``, ``commit_counts`` equal the JAX
  package's ops/pairwise.py (its kernel row B9);
- ops/scores.py ``taint_prefer_counts_plain`` and ``normalize_reverse``, and
  ops/assign.py ``preferred_node_affinity_raw_plain`` equal the JAX
  package's ``taint_prefer_counts``, ``normalize_reverse`` and
  ``_preferred_node_affinity_raw`` (B0c), the bf16 planes as bit patterns;
- ops/bitplane.py's bf16 storage and api/snapshot.py ``image_score_value``
  equal the JAX package's (ml_dtypes) rounding.

The ``cuda`` legs import no JAX and skip without a card: K10 == plain on
random arrays (config 3's padded size among them) and at the edge shapes
of tests/torch_score_explain_cases.py and past each staging limit, one
launch a call:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_pairwise.py

Tolerance: none (f32 compared as bit patterns).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.api.snapshot import encode_snapshot, image_score_value
from kubernetes_tpu_torch.bench import workloads as tw
from kubernetes_tpu_torch.bench.score_explain import random_score_arrays
from kubernetes_tpu_torch.ops import assign, bitplane, filters, kernels, pairwise, scores
import torch_score_explain_cases as cases
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SEEDS = range(6)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's functions (imported here, not at module level, so
    the cuda legs run where JAX is not installed)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from kubernetes_tpu.api import snapshot as jsnap
    from kubernetes_tpu.ops import assign as jassign
    from kubernetes_tpu.ops import bitplane as jbit
    from kubernetes_tpu.ops import pairwise as jpw
    from kubernetes_tpu.ops import scores as jscores

    return SimpleNamespace(jnp=jnp, pw=jpw, scores=jscores, assign=jassign, bit=jbit, snap=jsnap)


def same(a, b) -> bool:
    """Bitwise equality of a torch result and a JAX one (f32 as bits)."""
    a = a.detach().cpu()
    b = np.asarray(b)
    if a.dtype == torch.bfloat16:
        return np.array_equal(a.view(torch.int16).numpy().view(np.uint16), b.view(np.uint16))
    a = a.numpy()
    if a.dtype == np.float32:
        return a.shape == b.shape and np.array_equal(a.view(np.int32), b.astype(np.float32).view(np.int32))
    return a.shape == b.shape and np.array_equal(a, b)


def state(seed: int, T: int = 12, N: int = 97, D: int = 7):
    """A per-node pairwise state: dom_by_term with keyless nodes (D),
    integer-valued count planes, preferred sums of both signs."""
    rng = np.random.default_rng(seed)
    dbt = rng.integers(0, D + 1, (T, N)).astype(np.int32)
    cnt = rng.integers(0, 4, (T, N)).astype(np.float32) * (rng.random((T, N)) < 0.6)
    anti = rng.integers(0, 2, (T, N)).astype(np.float32) * (rng.random((T, N)) < 0.2)
    pref = rng.integers(-60, 60, (T, N)).astype(np.float32) * (rng.random((T, N)) < 0.4)
    total = rng.integers(0, 3, T).astype(np.float32) * (rng.random(T) < 0.5)
    return rng, dbt, cnt, anti, pref, total, D


def slots(rng, T: int, k: int):
    """k slots of term ids, -1 padded, repeats allowed."""
    ids = rng.integers(-1, T, k).astype(np.int32)
    return ids


@pytest.mark.parametrize("seed", SEEDS)
def test_spread_step_matches_jax(jx, seed):
    rng, dbt, cnt, _, _, _, D = state(seed)
    has_key = dbt < D
    for _ in range(4):
        st = slots(rng, cnt.shape[0], 3)
        skew = rng.integers(1, 3, 3).astype(np.int32)
        hard = rng.random(3) < 0.6
        elig = rng.random(cnt.shape[1]) < (0.0 if rng.random() < 0.2 else 0.8)  # sometimes no eligible node
        ok, raw = pairwise.spread_step(*(torch.from_numpy(x) for x in (cnt, has_key, st, skew, hard, elig)))
        jok, jraw = jx.pw.spread_step(*(jx.jnp.asarray(x) for x in (cnt, has_key, st, skew, hard, elig)))
        assert same(ok, jok) and same(raw, jraw)


@pytest.mark.parametrize("seed", SEEDS)
def test_interpod_required_ok_matches_jax(jx, seed):
    rng, dbt, cnt, anti, _, total, D = state(seed)
    has_key = dbt < D
    T = cnt.shape[0]
    for _ in range(4):
        aff, an, mt = slots(rng, T, 2), slots(rng, T, 2), slots(rng, T, 4)
        mv = (mt >= 0).astype(np.float32)
        aself = rng.random(2) < 0.7
        args = (cnt, anti, total, has_key, aff, an, mt, mv, aself)
        got = pairwise.interpod_required_ok(*(torch.from_numpy(x) for x in args))
        want = jx.pw.interpod_required_ok(*(jx.jnp.asarray(x) for x in args))
        assert same(got, want)


def test_interpod_required_ok_waiver(jx):
    """No matching pod anywhere and the pod matches its own term: the
    required-affinity waiver lets every keyed and keyless node pass."""
    _, dbt, cnt, anti, _, total, D = state(11)
    total = np.zeros_like(total)
    cnt[3] = 0.0
    args = (cnt, np.zeros_like(anti), total, dbt < D, np.array([3, -1], np.int32), np.array([-1], np.int32),
            np.array([-1], np.int32), np.zeros(1, np.float32), np.array([True, False]))
    got = pairwise.interpod_required_ok(*(torch.from_numpy(x) for x in args))
    assert bool(got.all())
    assert same(got, jx.pw.interpod_required_ok(*(jx.jnp.asarray(x) for x in args)))


@pytest.mark.parametrize("seed", SEEDS)
def test_interpod_pref_raw_matches_jax(jx, seed):
    rng, dbt, cnt, _, pref, _, D = state(seed)
    T = cnt.shape[0]
    for _ in range(4):
        pt, mt = slots(rng, T, 3), slots(rng, T, 4)
        pw_ = rng.choice([-20.0, 10.0, 50.0, 1.0], 3).astype(np.float32)
        mv = (mt >= 0).astype(np.float32)
        args = (cnt, pref, dbt < D, pt, pw_, mt, mv)
        got = pairwise.interpod_pref_raw(*(torch.from_numpy(x) for x in args))
        assert same(got, jx.pw.interpod_pref_raw(*(jx.jnp.asarray(x) for x in args)))


@pytest.mark.parametrize("seed", SEEDS)
def test_ports_ok_matches_jax(jx, seed):
    rng = np.random.default_rng(seed)
    used = rng.random((53, 5)) < 0.2
    row = rng.random(5) < 0.3
    got = pairwise.ports_ok(torch.from_numpy(used), torch.from_numpy(row))
    assert same(got, jx.pw.ports_ok(jx.jnp.asarray(used), jx.jnp.asarray(row)))


@pytest.mark.parametrize("seed", SEEDS)
def test_commit_counts_matches_jax(jx, seed):
    rng, dbt, cnt, anti, _, total, D = state(seed)
    T, N = cnt.shape
    for choice in (int(rng.integers(0, N)), -1, N - 1):
        mt, an = slots(rng, T, 4), slots(rng, T, 2)
        mv = (mt >= 0).astype(np.float32)
        dom_col = dbt[:, max(choice, 0)] if choice >= 0 else np.zeros(T, np.int32)
        args = (cnt, anti, total, dbt)
        got = pairwise.commit_counts(*(torch.from_numpy(x) for x in args), D, choice, torch.from_numpy(dom_col),
                                     *(torch.from_numpy(x) for x in (mt, mv, an)))
        want = jx.pw.commit_counts(*(jx.jnp.asarray(x) for x in args), D, jx.jnp.int32(choice),
                                   jx.jnp.asarray(dom_col), *(jx.jnp.asarray(x) for x in (mt, mv, an)))
        assert all(same(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("seed", SEEDS)
def test_match_matrix_is_matches_and_jax(jx, seed):
    """api/pairwise.py: the vectorised selector + namespace match equals the
    per-pair _matches and the JAX package's _match_matrix (every operator,
    namespaces, a missing selector, an empty one)."""
    import random

    from kubernetes_tpu.api import pairwise as jpair
    from kubernetes_tpu_torch.api import pairwise as tpair
    from kubernetes_tpu_torch.api import types as tt

    rng = random.Random(seed)
    vals = ["a", "b", "c"]

    def req():
        op = rng.choice([tt.OP_IN, tt.OP_NOT_IN, tt.OP_EXISTS, tt.OP_DOES_NOT_EXIST])
        return tt.LabelSelectorRequirement(rng.choice(["app", "tier"]), op,
                                           tuple(rng.sample(vals, 2)) if op in (tt.OP_IN, tt.OP_NOT_IN) else ())

    terms = [tpair.TermKey("zone", tuple(sorted(rng.sample(["default", "prod", "dev"], rng.randint(1, 2)))),
                           None if k == 0 else tt.LabelSelector() if k == 1 else tt.LabelSelector(
                               match_labels=((("app", rng.choice(vals)),) if rng.random() < 0.5 else ()),
                               match_expressions=tuple(req() for _ in range(rng.randint(0, 2)))))
             for k in range(14)]
    pods = [tt.Pod(name=f"p{i}", namespace=rng.choice(["default", "prod", "dev"]),
                   labels={k: rng.choice(vals) for k in ("app", "tier") if rng.random() < 0.7}) for i in range(40)]
    got = tpair._match_matrix(terms, pods)
    want = np.array([[tpair._matches(tk, pod) for pod in pods] for tk in terms], dtype=np.float32)
    assert np.array_equal(got, want)
    assert np.array_equal(got, jpair._match_matrix(terms, pods))


@pytest.mark.parametrize("seed", SEEDS)
def test_taint_prefer_counts_matches_jax(jx, seed):
    rng = np.random.default_rng(seed)
    P, N, T = 37, 61, 70  # more than one 32-bit word of taints
    tol = rng.random((P, T)) < 0.6
    taint = rng.random((N, T)) < 0.1
    got = scores.taint_prefer_counts_plain(torch.from_numpy(tol), torch.from_numpy(taint))
    want = jx.scores.taint_prefer_counts(SimpleNamespace(pod_tol_pref=jx.jnp.asarray(tol),
                                                         node_taint_pref=jx.jnp.asarray(taint)))
    assert got.dtype == torch.bfloat16 and same(got, want)


@pytest.mark.parametrize("seed", SEEDS)
def test_normalize_reverse_matches_jax(jx, seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 9, 83).astype(np.float32)
    feasible = rng.random(83) < (0.0 if seed == 0 else 0.7)  # no feasible node: all max
    got = scores.normalize_reverse(torch.from_numpy(counts), torch.from_numpy(feasible))
    assert same(got, jx.scores.normalize_reverse(jx.jnp.asarray(counts), jx.jnp.asarray(feasible)))
    bf = bitplane.quantize_scores(torch.from_numpy(counts))
    assert same(scores.normalize_reverse(bf, torch.from_numpy(feasible)),
                jx.scores.normalize_reverse(jx.jnp.asarray(counts), jx.jnp.asarray(feasible)))


@pytest.mark.parametrize("seed", SEEDS)
def test_preferred_node_affinity_raw_matches_jax(jx, seed):
    rng = np.random.default_rng(seed)
    P, S, N, PW = 29, 9, 71, 4
    terms = rng.integers(-1, S, (P, PW)).astype(np.int32)
    terms[0] = [2, 2, -1, 5]  # a term listed twice adds twice
    weights = rng.integers(1, 101, (P, PW)).astype(np.float32)
    tm = rng.random((S, N)) < 0.4
    got = assign.preferred_node_affinity_raw_plain(torch.from_numpy(terms), torch.from_numpy(weights),
                                                   torch.from_numpy(tm))
    want = jx.assign._preferred_node_affinity_raw(
        SimpleNamespace(pod_pref_terms=jx.jnp.asarray(terms), pod_pref_weights=jx.jnp.asarray(weights)),
        jx.jnp.asarray(tm))
    assert same(got, want)


def test_bf16_storage_matches_jax(jx):
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.standard_normal(4096).astype(np.float32) * 300,
                        np.array([0.0, -0.0, np.inf, -np.inf, 1.00390625, 255.5, 977.0], np.float32)])
    want = np.asarray(jx.bit.quantize_scores_np(x)).view(np.uint16)
    assert np.array_equal(bitplane.quantize_scores_np(x), want)
    assert same(bitplane.quantize_scores(torch.from_numpy(x)), jx.bit.quantize_scores(jx.jnp.asarray(x)))
    assert np.array_equal(bitplane.bf16_round_np(x).view(np.int32), jx.bit.bf16_round_np(x).view(np.int32))


@pytest.mark.parametrize("mb", [0, 22.5, 23, 24, 500, 999, 1000, 4000])
def test_image_score_value_matches_jax(jx, mb):
    assert np.float32(image_score_value(mb)).view(np.int32) == np.float32(jx.snap.image_score_value(mb)).view(
        np.int32)


# ---------------------------------------------------------------------------
# on the card: K10 score_planes and K7's eligibility plane == plain
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card: python -m pytest --noconftest "
                    "-m cuda tests/test_torch_pairwise.py")
    kernels.build(["packed_static_rows", "score_planes"])
    return torch.device("cuda")


def _random_score_arrays(seed: int, P: int, N: int, T: int, PW: int, S: int = 11, E: int = 3, L: int = 40):
    return random_score_arrays(seed, P, N, T, PW, S, E, L, device="cuda")


def _bits16(x):
    return x.view(torch.int16)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,P,N,T,PW", [(0, 300, 997, 5, 3), (1, 64, 2048, 70, 1), (2, 513, 4099, 33, 6),
                                          (3, 10240, 6144, 5, 3)])  # the last: config 3's padded size
def test_score_planes_kernel_matches_plain(card, seed, P, N, T, PW):
    arr = _random_score_arrays(seed, P, N, T, PW)
    before = kernels.LAUNCHES["score_planes"]
    traw, naraw = kernels.score_planes(arr)
    assert kernels.LAUNCHES["score_planes"] == before + 1
    traw_p, naraw_p = assign.score_planes_plain(arr)
    assert torch.equal(_bits16(traw), _bits16(traw_p)) and torch.equal(_bits16(naraw), _bits16(naraw_p))


# the card's own staging limits (csrc/score_planes.cu): 512 taints, 512
# named terms a block, a bitmap of 8192 terms, pod rows of 2 KB; past each
# the kernel's fallback
CARD_SCORE_CASES = {
    **{name: kw for name, (kw, knobs) in cases.SCORE_CASES.items() if not knobs},
    "direct-taint": dict(seed=51, N=300, P=60, T=600),
    "direct-terms": dict(seed=52, N=6144, P=2000, S=2000, E=1, PW=8),
    "wide-S": dict(seed=53, N=200, P=60, S=9000, E=1, L=6),
    "unstaged-rows": dict(seed=54, N=300, P=40, S=20, PW=2100),  # 16.8 KB a row
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_SCORE_CASES))
def test_score_planes_kernel_matches_plain_edges(card, name):
    """K10 == plain on both bf16 planes at the edge shapes and past each
    staging limit, one launch a call; == the numpy replay of its
    decomposition where that is quick."""
    h = cases.cluster(**CARD_SCORE_CASES[name])
    arr = cases.arrays(h, card)
    before = kernels.LAUNCHES["score_planes"]
    traw, naraw = kernels.score_planes(arr)
    assert kernels.LAUNCHES["score_planes"] == before + 1
    assert traw.data_ptr() + 2 * traw.numel() == naraw.data_ptr()  # one [2, P, N] buffer
    traw_p, naraw_p = assign.score_planes_plain(arr)
    assert torch.equal(_bits16(traw), _bits16(traw_p)) and torch.equal(_bits16(naraw), _bits16(naraw_p))
    if name != "direct-terms":
        rt, rn = cases.replay_score_planes(h)
        np.testing.assert_array_equal(_bits16(traw).cpu().numpy(), rt)
        np.testing.assert_array_equal(_bits16(naraw).cpu().numpy(), rn)


@pytest.mark.cuda
@pytest.mark.parametrize("snapshot", ["all-stages", "config3-small", "mixed"])
def test_score_planes_and_eligibility_on_snapshots(card, snapshot):
    snap = {"all-stages": tw.all_stages, "config3-small": lambda: tw.spread_affinity(300, 1000, seed=1),
            "mixed": tw.mixed}[snapshot]()
    arr, _ = encode_snapshot(snap, device=card)
    traw, naraw = kernels.score_planes(arr)
    traw_p, naraw_p = assign.score_planes_plain(arr)
    assert torch.equal(_bits16(traw), _bits16(traw_p)) and torch.equal(_bits16(naraw), _bits16(naraw_p))
    sfs, eligs = kernels.packed_static_rows(arr, with_elig=True)
    sfs_p, eligs_p = assign.packed_static_rows_plain(arr, with_elig=True)
    assert torch.equal(sfs, sfs_p) and torch.equal(eligs, eligs_p)
    tm = filters.term_match(arr.sel_mask, arr.sel_kind, arr.node_labels)
    nodesel = filters.node_selection_ok_from(tm, arr) & arr.node_valid[None, :]
    assert torch.equal(bitplane.unpack(eligs, arr.N), nodesel)
