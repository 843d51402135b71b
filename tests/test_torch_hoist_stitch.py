"""Kernels K4 class_usage_hoist and K17 stitch_planes on the CPU: numpy
replays of each kernel's grid and index work (tests/torch_hoist_stitch_cases.py)
against the port's plain versions (ops/bitplane.py stitch_planes_plain,
which tests/test_torch_mesh.py holds to the JAX package's tiled layout;
ops/incremental.py _patch_hoist_plain, which tests/test_torch_incremental.py
holds to the JAX _patch_hoist).

- K17's word map, for every S in 1..8 and nl in 1..70 plus 5120 and 6827,
  on packed blocks and on blocks whose tail bits are set, over 1, 7 and 37
  rows, with the card's grid and with one SM's (several rows a block):
  every (row, word) written once, == stitch_planes_plain;
- K4's grid: full mode writes every (class, node) and every fit word
  once, at the edge shapes and with class slices past one staged chunk;
- K4's column mode (each block marks its tile's columns from the whole
  list, compacts them and merges (old & ~touched) | fresh) == the plain
  patch on lists of one column, one word, the first and last words, N/2 -
  1 columns, the sentinel tail, and on unordered lists with repeats (the
  kernel relies on no order); and on every list HoistCache.ensure and its
  node mesh's _mesh_usage build over churn;
- the kernels' constants == the replays'.

The card's legs are in tests/test_torch_kernels.py and
tests/test_torch_mesh.py (marked ``cuda``).

Tolerance: none (words exact, base_u as int32 bit patterns).
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

import torch_hoist_stitch_cases as cases
from kubernetes_tpu_torch.api.snapshot import encode_snapshot
from kubernetes_tpu_torch.bench import workloads
from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, bitplane, incremental, infer_score_config, kernels
from kubernetes_tpu_torch.ops.incremental import HoistCache
from kubernetes_tpu_torch.parallel import mesh as tm
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SMALL_NL = list(range(1, 71))
STRATEGIES = {
    "least": ("LeastAllocated", ((0.0, 0.0), (100.0, 10.0))),
    "most": ("MostAllocated", ((0.0, 0.0), (100.0, 10.0))),
    "rtcr": ("RequestedToCapacityRatio", ((0.0, 10.0), (50.0, 2.0), (100.0, 0.0))),
}


def _stitch_cases(S, nls, rows_list, seed):
    rng = np.random.default_rng(seed)
    for nl in nls:
        for rows in rows_list:
            for tails in (False, True):
                words = cases.tiled_words(rng, rows, S, nl, garbage_tails=tails)
                want = bitplane.stitch_planes_plain(torch.from_numpy(words), nl).numpy()
                yield nl, rows, tails, words, want


@pytest.mark.parametrize("S", range(1, 9))
def test_stitch_replay_matches_plain_small_nl(S):
    for nl, rows, tails, words, want in _stitch_cases(S, SMALL_NL, (1, 7), S):
        got = cases.stitch_replay(words, nl)
        np.testing.assert_array_equal(got, want, err_msg=f"S={S} nl={nl} rows={rows} tails={tails}")
    # several rows a block, and rows past one block's group
    for nl, rows, tails, words, want in _stitch_cases(S, (1, 5, 31, 33, 37, 64, 70), (37,), 100 + S):
        got = cases.stitch_replay(words, nl, nsm=1)
        np.testing.assert_array_equal(got, want, err_msg=f"S={S} nl={nl} rows={rows} tails={tails} one SM")


@pytest.mark.parametrize("nl", [5120, 6827])
@pytest.mark.parametrize("S", range(1, 9))
def test_stitch_replay_matches_plain_wide(S, nl):
    for nl_, rows, tails, words, want in _stitch_cases(S, (nl,), (3,), 7 * S + nl):
        np.testing.assert_array_equal(cases.stitch_replay(words, nl_), want, err_msg=f"tails={tails}")


def test_stitch_three_pieces_where_the_block_ends_in_a_second_word():
    """At the mesh north star's nl = 6827 on 3 shards, output word 426 takes
    11 bits from word 212 of block 1, 11 from its word 213 and 10 from block
    2's first word: three source words, not two; inside a block a word is
    one funnel shift of two neighbouring source words."""
    nl, S = 6827, 3
    Wl = -(-nl // 32)
    xm = (1 << cases.X_BITS) - 1
    a, b, m01, c, m2 = cases.word_map(426, S, nl, Wl, S * nl)
    assert (a & xm, b, c & xm) == (Wl + 212, Wl + 213, 2 * Wl)
    assert (bin(m01).count("1"), bin(m2).count("1"), c >> cases.X_BITS) == (22, 10, 22)
    a, b, m01, c, m2 = cases.word_map(300, S, nl, Wl, S * nl)
    assert (b, m01, m2) == ((a & xm) + 1, cases.M32, 0)


def test_stitch_grid_shapes():
    """The card's grid at the main path's shapes: for the dense rows one
    tile of 641 words, 3 a thread over 224 threads, one wave of row groups
    (6 blocks an SM); for the class planes a word a thread and a block a
    row."""
    assert cases.stitch_grid(51200, 641, 6827) == (3, 224, 641, 1, 788, 65)
    assert cases.stitch_grid(101, 641, 6827, per_sm=9) == (1, 224, 214, 3, 101, 1)
    assert cases.stitch_grid(7, 2500, 37) == (1, 256, 250, 10, 7, 1)
    assert cases.stitch_grid(51200, 1707, 6827, per_sm=4) == (4, 224, 854, 2, 264, 194)
    assert cases.stitch_grid(51200, 5, 5, per_sm=9) == (1, 32, 5, 1, 1164, 44)


def test_hoist_stitch_constants_match_the_source():
    def const(src, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    st = (kernels.CSRC / "stitch_planes.cu").read_text()
    assert (cases.ST_NT, cases.MAX_WPT, cases.STITCH_PER_SM, cases.X_BITS) == (
        const(st, "NT"), const(st, "MAX_WPT"), const(st, "STITCH_PER_SM"), const(st, "X_BITS"))
    assert "int64_t span = tile + (32 * tile + nl - 1) / nl + 2;" in st
    assert "constexpr int TILE_WORDS = NT * MAX_WPT;" in st
    ch = (kernels.CSRC / "class_hoist.cu").read_text()
    assert (cases.UT, cases.UCB, cases.PCB, cases.SCAN_BATCH) == (
        const(ch, "UT"), const(ch, "UCB"), const(ch, "PCB"), const(ch, "SCAN_BATCH"))


@pytest.mark.parametrize("U1,N,nsm", [(1, 1, 132), (2, 31, 132), (2, 33, 132), (102, 77, 132), (33, 997, 132),
                                      (101, 20480, 132), (300, 77, 1), (2423, 6144, 132)])
def test_usage_grid_writes_every_pair_once(U1, N, nsm):
    base, fit = cases.full_coverage(U1, N, nsm)
    assert (base == 1).all() and (fit == 1).all()
    base, fit = cases.full_coverage(U1, N, nsm, per_sm=1)
    assert (base == 1).all() and (fit == 1).all()


def test_usage_grid_shapes():
    """One wave of 6 blocks an SM at both main-path shapes; at config 3's
    class state a slice spans several staged chunks, and in column mode,
    past PCB classes, several fetched chunks."""
    assert cases.usage_grid(101, 20480) == (80, 9, 12)
    tiles, slices, cs = cases.usage_grid(2423, 6144)
    assert (tiles, slices, cs) == (24, 33, 74) and cs > cases.UCB


def _cfg(strategy, R):
    name, shape = STRATEGIES[strategy]
    return dataclasses.replace(DEFAULT_SCORE_CONFIG, fit_strategy=name, rtcr_shape=shape,
                               score_resources=tuple(range(min(R, 3))), fit_weight=1.3, balanced_weight=0.7)


@pytest.mark.parametrize("U1,N,R,strategy,nsm", [
    (1, 31, 1, "least", 132), (2, 77, 5, "most", 132), (40, 600, 5, "rtcr", 132), (60, 600, 8, "least", 1),
    (3, 33, 8, "most", 132), (17, 1, 5, "least", 132)])
def test_patch_replay_matches_plain(U1, N, R, strategy, nsm):
    req, used, alloc = cases.usage_inputs(U1 * 7 + N, U1, N, R)
    cfg = _cfg(strategy, R)
    base, fit = incremental._usage_hoist_plain(req, used, alloc, cfg)
    rng = np.random.default_rng(N)
    used2 = used.clone()
    used2[torch.from_numpy(rng.choice(N, max(1, N // 2), replace=False))] += 13
    for name, cols in cases.col_lists(N, rng).items():
        cols_t = torch.from_numpy(cols)
        want = incremental._patch_hoist_plain(base, fit, req, used2, alloc, cols_t, cfg)
        got = cases.patch_replay(base, fit, req, used2, alloc, cols_t, cfg, nsm)
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)), name
        assert torch.equal(got[1], want[1]), name


@pytest.mark.parametrize("shards", [1, 3])
def test_patch_replay_on_hoist_cache_lists(monkeypatch, shards):
    """Every column list HoistCache.ensure builds (one device) or its
    _mesh_usage builds per shard (a CPU mesh of 3) over churn goes through
    the column-mode replay, == the plain patch; the cache's planes == a
    fresh full hoist every cycle."""
    arr, meta = encode_snapshot(workloads.heterogeneous(120, 300), device="cpu")
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    seen = []

    def replayed(base_u, fit_u, req_u, node_used, node_alloc, cols, c):
        want = incremental._patch_hoist_plain(base_u, fit_u, req_u, node_used, node_alloc, cols, c)
        got = cases.patch_replay(base_u, fit_u, req_u, node_used, node_alloc, cols, c)
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)) and torch.equal(got[1], want[1])
        seen.append(cols.numpy().copy())
        return got

    monkeypatch.setattr(incremental, "patch_hoist", replayed)
    cache = HoistCache(mesh=tm.make_mesh(shards, devices="cpu")) if shards > 1 else HoistCache()
    used = arr.node_used.clone()
    req = arr.pod_req[0]
    N = arr.N
    cache.ensure(arr, meta, cfg)
    for rows in ([0, 1, 2, 40, 77], [N - 1], list(range(0, N, 5)), [3, N - 2]):
        used = used.clone()
        used[rows] += req
        a = dataclasses.replace(arr, node_used=used)
        inc = cache.ensure(a, meta, cfg)
        assert cache.last["action"] == "patch"
        base, fit = incremental._usage_hoist_plain(inc.req_u, used, a.node_alloc, cfg)
        assert torch.equal(inc.base_u[:, :N].view(torch.int32), base.view(torch.int32))
        assert torch.equal(bitplane.unpack(inc.fit_u, inc.base_u.shape[1])[:, :N], bitplane.unpack(fit, N))
    assert len(seen) >= 4
