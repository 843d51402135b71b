"""Kernels K14 explain_counts and K10 score_planes, one launch each, on the
CPU: a numpy replay of each kernel's decomposition
(tests/torch_score_explain_cases.py: node tiles, words packed in the
kernel, the staged named-term match, K14's per-thread counters, their
accumulation and the last block's move that leaves the accumulator zero)
against the port's plain versions (ops/explain.py explain_counts_plain,
ops/assign.py score_planes_plain) and, through them, the JAX package's
functions (ops/explain.py _explain_kernel, ops/scores.py
taint_prefer_counts, ops/assign.py _preferred_node_affinity_raw), on
inputs made with numpy from a seed at the edge shapes: T = 0, 1, 32, 33,
70; S = 0 with -1 and repeated preference slots; R = 0, 1, 5, 32; N and P
off the tiles; F = 1 and F past a slice of 128 reps; invalid reps and
pins to a missing node (-2); alloc - used that wraps; the kernels'
fallbacks (taints past the staged words, terms past the staged list or
the bitmap) with their staging limits cut small.

The JAX _explain_kernel refuses R = 0 (an argmax over no resources), so
at R = 0 the counts are held to the port's explain_oracle (itself held to
the JAX oracle in tests/test_torch_explain.py) instead.  The oracles take
alloc - used in int64, so where it wraps as int32 (as in the JAX kernel)
only the JAX kernel is the reference.

The card's legs are in tests/test_torch_explain.py and
tests/test_torch_pairwise.py (marked ``cuda``).

Tolerance: none (integer counts; bf16 planes as bit patterns).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_score_explain_cases as cases
from kubernetes_tpu_torch.ops import assign, kernels
from kubernetes_tpu_torch.ops import explain as tex
from kubernetes_tpu_torch.ops.filters import term_match
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's functions (imported here, not at module level)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from kubernetes_tpu.ops import assign as jassign
    from kubernetes_tpu.ops import explain as jex
    from kubernetes_tpu.ops import filters as jfilters
    from kubernetes_tpu.ops import scores as jscores

    return SimpleNamespace(jnp=jnp, ex=jex, assign=jassign, scores=jscores, filters=jfilters)


def explain_case(name: str):
    kw, F, knobs = cases.EXPLAIN_CASES[name]
    h = cases.cluster(**kw)
    reps, valid = cases.reps_of(kw["seed"], kw["P"], F)
    return h, reps, valid, knobs


def jax_counts(jx, h: dict, reps, valid) -> np.ndarray:
    j = jx.jnp.asarray
    return np.asarray(jx.ex._explain_kernel(
        j(h["node_valid"]), j(h["node_alloc"]), j(h["node_used"]), j(h["node_unsched"]), j(h["node_labels"]),
        j(h["node_taint_ns"]), j(h["sel_mask"]), j(h["sel_kind"]), j(valid), j(h["pod_req"][reps]),
        j(h["pod_tol_ns"][reps]), j(h["pod_nodename"][reps]), j(h["pod_terms"][reps]), j(h["pod_has_sel"][reps])))


@pytest.mark.parametrize("name", list(cases.EXPLAIN_CASES))
def test_explain_replay_matches_plain_and_jax(jx, name):
    h, reps, valid, knobs = explain_case(name)
    out, acc = cases.replay_explain(h, h["node_used"], reps, valid, order_seed=len(name), **knobs)
    assert not acc.any()  # the launch leaves the accumulator zero for the next call
    arr = cases.arrays(h)
    plain = tex.explain_counts_plain(arr, arr.node_used, torch.from_numpy(reps), torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(out, plain)
    assert not out[~valid].any()
    R = h["node_alloc"].shape[1]
    if R:
        np.testing.assert_array_equal(plain, jax_counts(jx, h, reps, valid))
    free = h["node_alloc"].astype(np.int64) - h["node_used"].astype(np.int64)
    if (np.abs(free) <= np.iinfo(np.int32).max).all():  # the host oracle does not wrap
        oracle = tex.explain_oracle(arr, reps, arr.node_used)
        np.testing.assert_array_equal(out[valid], oracle[valid])
    assert (out[valid].sum(axis=1) == h["node_valid"].sum()).all()


def test_explain_replay_columns_and_order():
    """Every column is reached on one case (pins, the unschedulable and
    taint split, affinity, each fit column, feasible), and the counts do
    not depend on the order the blocks finish in."""
    h, reps, valid, _ = explain_case("N300-F130")
    a, _ = cases.replay_explain(h, h["node_used"], reps, valid, order_seed=1)
    b, _ = cases.replay_explain(h, h["node_used"], reps, valid, order_seed=2)
    np.testing.assert_array_equal(a, b)
    assert (a.sum(axis=0) > 0).all()


def test_explain_replay_on_a_dirty_accumulator_is_not_zero_based():
    """The accumulator must be zero before a launch: the replay adds to
    what it holds (the wrapper makes it zero once; every launch leaves it
    so), and a second call on the one it left gives the same counts."""
    h, reps, valid, _ = explain_case("wrap")
    first, acc = cases.replay_explain(h, h["node_used"], reps, valid)
    again, acc2 = cases.replay_explain(h, h["node_used"], reps, valid, acc=acc)
    np.testing.assert_array_equal(first, again)
    assert not acc2.any()
    dirty = acc.copy()
    dirty[1 + cases.EX_COPIES] = 5  # the first count of copy 0, after the tickets
    off, _ = cases.replay_explain(h, h["node_used"], reps, valid, acc=dirty)
    assert off[0, 0] == first[0, 0] + 5


def test_explain_wrap_reaches_both_signs():
    h, _, _, _ = explain_case("wrap")
    free = (h["node_alloc"].astype(np.int64) - h["node_used"].astype(np.int64))
    wrapped = (h["node_alloc"].astype(np.uint32) - h["node_used"].astype(np.uint32)).astype(np.int32)
    assert (free > np.iinfo(np.int32).max).any() and (free < np.iinfo(np.int32).min).any()
    assert ((wrapped > 0) & (free < 0)).any() and ((wrapped < 0) & (free > 0)).any()


def score_case(name: str):
    kw, knobs = cases.SCORE_CASES[name]
    return cases.cluster(**kw), knobs


def bits(x: torch.Tensor) -> np.ndarray:
    return x.view(torch.int16).numpy()


@pytest.mark.parametrize("name", list(cases.SCORE_CASES))
def test_score_planes_replay_matches_plain_and_jax(jx, name):
    h, knobs = score_case(name)
    traw, naraw = cases.replay_score_planes(h, **knobs)
    arr = cases.arrays(h)
    traw_p, naraw_p = assign.score_planes_plain(arr)
    np.testing.assert_array_equal(traw, bits(traw_p))
    np.testing.assert_array_equal(naraw, bits(naraw_p))
    j = jx.jnp.asarray
    want_t = jx.scores.taint_prefer_counts(SimpleNamespace(pod_tol_pref=j(h["pod_tol_pref"]),
                                                           node_taint_pref=j(h["node_taint_pref"])))
    tm = jx.filters.term_match(j(h["sel_mask"]), j(h["sel_kind"]), j(h["node_labels"]))
    np.testing.assert_array_equal(np.asarray(tm), term_match(arr.sel_mask, arr.sel_kind, arr.node_labels).numpy())
    want_n = jx.assign._preferred_node_affinity_raw(
        SimpleNamespace(pod_pref_terms=j(h["pod_pref_terms"]), pod_pref_weights=j(h["pod_pref_weights"])), tm)
    np.testing.assert_array_equal(traw, np.asarray(want_t).view(np.int16))
    np.testing.assert_array_equal(naraw, np.asarray(want_n).view(np.int16))


def test_score_planes_replay_grid():
    """The C entry's grid: node tiles of 128, pod slabs sized for ~528
    blocks, at most ceil(P / 8) slabs; every pod row in one slab."""
    assert cases.grid_of(512, 256) == (2, 64, 8, 8)
    assert cases.grid_of(240, 256) == (2, 30, 8, 8)
    assert cases.grid_of(10240, 6144, 3, 5) == (48, 11, 931, 584)
    assert cases.grid_of(10240, 6144, 2100, 5)[3] == 0  # a row of 16.8 KB is not staged
    for P, N in ((1, 1), (17, 1), (1030, 255), (9, 257), (65536, 2048)):
        nbx, nby, PB, CH = cases.grid_of(P, N)
        assert nbx * cases.SP_TN >= N > (nbx - 1) * cases.SP_TN
        assert nby * PB >= P > (nby - 1) * PB and nby <= 65535
        assert CH % 8 == 0 and PB <= CH * -(-PB // CH)


def test_score_planes_edge_values():
    """S = 0: every slot -1, naraw all zero; a repeated slot adds twice;
    T = 0: traw all zero."""
    h, _ = score_case("S0")
    _, naraw = cases.replay_score_planes(h)
    assert not naraw.any()
    h, _ = score_case("T0")
    traw, naraw = cases.replay_score_planes(h)
    assert not traw.any() and naraw.any()
    h, _ = score_case("N255-P1030")
    s = int(h["pod_pref_terms"][0, 0])
    assert s >= 0 and h["pod_pref_terms"][0, 1] == s
    _, naraw = cases.replay_score_planes(h)
    arr = cases.arrays(h)
    tm = term_match(arr.sel_mask, arr.sel_kind, arr.node_labels).numpy()
    want = sum(float(h["pod_pref_weights"][0, k]) * tm[h["pod_pref_terms"][0, k]]
               for k in range(h["pod_pref_terms"].shape[1]) if h["pod_pref_terms"][0, k] >= 0)
    np.testing.assert_array_equal(naraw[0], cases.bf16_bits(np.asarray(want, np.float32)))


def _c_entries() -> dict:
    """ktt_* entry -> its parameters' ctypes, read from the sources' plain
    C interfaces (a pointer is c_void_p)."""
    import ctypes
    import re

    kinds = {"int": ctypes.c_int, "unsigned": ctypes.c_uint, "float": ctypes.c_float,
             "long long": ctypes.c_longlong, "int64_t": ctypes.c_longlong}
    out = {}
    for src in sorted(kernels.CSRC.glob("*.cu")):
        for name, params in re.findall(r'extern "C" int (ktt_\w+)\(([^)]*)\)', src.read_text()):
            types = []
            for p in params.split(","):
                p = " ".join(p.split())
                types.append(ctypes.c_void_p if "*" in p else kinds[p.rsplit(" ", 1)[0].replace("const ", "")])
            out[name] = types
    return out


@pytest.mark.parametrize("kernel", sorted(kernels._ARGTYPES))
def test_argtypes_match_the_c_entries(kernel):
    """Each kernel's ctypes signature (ops/kernels.py _ARGTYPES) is its C
    entry's, parameter by parameter: a wrong count or kind is only caught
    when the card calls it."""
    sym, argtypes = kernels._ARGTYPES[kernel]
    assert _c_entries()[sym] == argtypes


def test_explain_constants_match_the_source():
    """The wrapper sizes K14's accumulator by csrc/explain.cu's COPIES, and
    the replay follows its tile, block, slice and staging constants."""
    import re

    src = (kernels.CSRC / "explain.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert kernels.EXPLAIN_COPIES == const("COPIES") == cases.EX_COPIES
    assert kernels.EXPLAIN_MAX_R == const("MAX_R")
    assert (cases.EX_NT, cases.EX_TILE, cases.EX_FR_MAX, cases.EX_TW_STAGE, cases.EX_NS_MAX, cases.ALL_S) == (
        const("NT"), const("TILE"), const("FR_MAX"), const("TW_STAGE"), const("NS_MAX"), const("ALL_S"))
    src = (kernels.CSRC / "score_planes.cu").read_text()
    assert (cases.SP_NT, cases.SP_TN, cases.SP_TW_STAGE, cases.SP_NS_MAX, cases.SP_TARGET, cases.SP_ROWBUF,
            cases.ALL_S) == (const("NT"), const("TN"), const("TW_STAGE"), const("NS_MAX"), const("TARGET_BLOCKS"),
                             const("ROWBUF"), const("ALL_S"))
    assert cases.NAMED_S_MAX == int(re.search(r"NAMED_S_MAX = (\d+);", (kernels.CSRC / "terms.cuh").read_text())
                                    .group(1))

