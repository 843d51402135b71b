"""Numpy replays of kernels K4 class_usage_hoist and K17 stitch_planes:
their grids, index work and word assembly as the CUDA sources do them, so
the index logic is held to the plain versions where there is no card.

K17 (csrc/stitch_planes.cu): the row-independent word map (word_map: one
32-bit division a word; for nl >= 32 a funnel shift of block s's one or two
source words and, where block s ends inside the word, block s + 1's first
word; for nl < 32 the first block, bit and block count), the grid of word
tiles and row groups, each thread's words of its tile over the block's
rows, and the per-word assembly from the map (each tile's source words within its row
buffer's span); nl % 32 == 0 is the copy.

K4 (csrc/class_hoist.cu): the grid of node tiles and class slices;
full mode's class chunks (every (class, node) and every fit word written
once); column mode's per-block marking of the whole column list (any
order, repeats, the sentinel N and anything outside [0, N) skipped), its
compaction into the tile's listed columns, the (class, column) pairs over
the block's threads in chunks of PCB classes, and the merge (old &
~touched) | fresh of each fit word and base_u's listed entries, the
scores themselves taken from the port's plain functions.
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_tpu_torch.ops import bitplane
from kubernetes_tpu_torch.ops.incremental import _scores, fit_rows

H100_SMS = 132

# csrc/stitch_planes.cu
ST_NT, MAX_WPT, STITCH_PER_SM, X_BITS = 256, 4, 8, 24
TILE_WORDS = ST_NT * MAX_WPT
# csrc/class_hoist.cu (K4)
UT, UCB, PCB, SCAN_BATCH = 256, 32, 16, 8
# blocks an SM the card holds of the main path's K4 kernels (40 registers,
# 20-35 KB of shared memory at R = 4, 5), which the launch reads from
# cudaOccupancyMaxActiveBlocksPerMultiprocessor
K4_PER_SM = 6

M32 = 0xFFFFFFFF


def low_mask(bits: int) -> int:
    return M32 if bits >= 32 else (1 << bits) - 1


def word_map(w: int, S: int, nl: int, Wl: int, total: int):
    """Output word w's map entry (a, b, m01, c, m2): for nl >= 32 the word is
    funnel(in[a & XM], in[b]) >> (a >> X_BITS) & m01 | (in[c & XM] << (c >>
    X_BITS)) & m2; for nl < 32, (first block | first bit << X_BITS, the
    number of blocks, 0, 0, 0)."""
    g0 = 32 * w
    g1 = min(g0 + 32, total)
    s = g0 // nl  # both operands non-negative and < 2^31: the kernel's int division
    l = g0 - s * nl
    if nl < 32:
        blocks, c = 0, g0
        while c < g1:
            c += nl - l if blocks == 0 else nl
            blocks += 1
        return (s | (l << X_BITS), blocks, 0, 0, 0)
    off = l & 31
    x0 = s * Wl + (l >> 5)
    own = min(nl - l, g1 - g0)
    a, b, m01, c, m2 = x0 | (off << X_BITS), x0 + 1 if off + own > 32 else x0, low_mask(own), x0, 0
    if own < g1 - g0:
        c = (s + 1) * Wl | (own << X_BITS)
        m2 = (low_mask(g1 - g0 - own) << own) & M32
    return (a, b, m01, c, m2)


def assemble(src: np.ndarray, e, nl: int) -> np.ndarray:
    """One output word of every row of `src` (uint32 [rows, S * Wl]) from
    its map entry, as the kernel's loop body does it."""
    xm = (1 << X_BITS) - 1
    a, b, m01, c, m2 = e
    if nl < 32:
        s, l, pos = a & xm, a >> X_BITS, 0
        word = np.zeros(src.shape[0], np.uint64)
        for _ in range(b):
            run = min(nl - l, 32 - pos)
            word |= (((src[:, s].astype(np.uint64) >> l) & low_mask(run)) << pos) & M32
            pos += run
            s, l = s + 1, 0
        return word.astype(np.uint32)
    v = src.astype(np.uint64)
    funnel = (v[:, b] << 32) | v[:, a & xm]  # __funnelshift_r(lo, hi, off): (hi:lo) >> off
    word = ((funnel >> (a >> X_BITS)) & M32) & m01
    if m2:
        word |= ((v[:, c & xm] << (c >> X_BITS)) & M32) & m2
    return word.astype(np.uint32)


def stitch_grid(rows: int, W: int, nl: int = 32, nsm: int = H100_SMS, per_sm: int = 6):
    """(words a thread, threads a block, tile words, tiles, groups, rows a
    group) of the stitch launch: one wave of `per_sm` blocks an SM (the
    launch reads it from cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    wide = nl >= 32 and rows * -(-W // TILE_WORDS) >= STITCH_PER_SM * nsm
    tiles = -(-W // TILE_WORDS) if wide else -(-W // ST_NT)
    tile = -(-W // tiles)
    wpt = -(-tile // ST_NT) if wide else 1
    threads = -(-(-(-tile // wpt)) // 32) * 32
    groups = min(max(1, per_sm * nsm // tiles), rows)
    rpb = -(-rows // groups)
    return wpt, threads, tile, tiles, -(-rows // rpb), rpb


def stitch_replay(words: np.ndarray, nl: int, nsm: int = H100_SMS, per_sm: int = 6) -> np.ndarray:
    """K17 on int32 words [rows, S * ceil(nl / 32)] -> [rows, ceil(S * nl /
    32)], every (row, word) written exactly once (asserted)."""
    src = words.view(np.uint32)
    rows, win = src.shape
    Wl = -(-nl // 32)
    S = win // Wl
    total = S * nl
    W = -(-total // 32)
    if nl % 32 == 0:
        assert W == win
        return src.copy().view(np.int32)
    out = np.zeros((rows, W), np.uint32)
    hits = np.zeros((rows, W), np.int64)
    wpt, threads, tile, tiles, groups, rpb = stitch_grid(rows, W, nl, nsm, per_sm)
    span = min(tile + -(-32 * tile // nl) + 2, win)  # the row buffer's words
    xm = (1 << X_BITS) - 1
    for bx in range(tiles):
        wend = min(W, bx * tile + tile)
        if nl >= 32:  # the tile's source words fit its row buffer, and every map index is in them
            lo = word_map(bx * tile, S, nl, Wl, total)[0] & xm
            last = word_map(wend - 1, S, nl, Wl, total)
            need = max(last[1], last[3] & xm) + 1 - lo
            assert need <= span, (need, span)
            for w in range(bx * tile, wend):
                a, b, _, c, m2 = word_map(w, S, nl, Wl, total)
                assert lo <= a & xm <= b < lo + need and (not m2 or lo <= c & xm < lo + need)
        for t in range(threads):
            w0 = bx * tile + t
            mine = [w0 + j * threads for j in range(wpt) if w0 + j * threads < wend]
            words_of = {w: assemble(src, word_map(w, S, nl, Wl, total), nl) for w in mine}  # every row's word
            for by in range(groups):
                for r in range(by * rpb, min(rows, by * rpb + rpb)):
                    for w in mine:
                        out[r, w] = words_of[w][r]
                        hits[r, w] += 1
    assert (hits == 1).all(), "every (row, word) once"
    return out.view(np.int32)


def usage_grid(U1: int, N: int, nsm: int = H100_SMS, per_sm: int = K4_PER_SM):
    """(tiles, slices, classes a slice) of K4's launch, both modes: one wave
    of `per_sm` blocks an SM."""
    tiles = -(-N // UT)
    slices = max(1, min(U1, per_sm * nsm // tiles))
    cs = -(-U1 // slices)
    return tiles, -(-U1 // cs), cs


def full_coverage(U1: int, N: int, nsm: int = H100_SMS, per_sm: int = K4_PER_SM):
    """(base writes [U1, N], fit word writes [U1, W]) of full mode's blocks,
    class chunks and live warps."""
    tiles, slices, cs = usage_grid(U1, N, nsm, per_sm)
    W = -(-N // 32)
    base = np.zeros((U1, N), np.int64)
    fit = np.zeros((U1, W), np.int64)
    for bx in range(tiles):
        n0 = bx * UT
        for by in range(slices):
            ua, ub = by * cs, min(U1, by * cs + cs)
            for uc in range(ua, ub, UCB):
                for c in range(min(UCB, ub - uc)):
                    for warp in range(UT // 32):
                        if n0 + 32 * warp >= N:
                            continue  # the warp's word is past W
                        lo = n0 + 32 * warp
                        base[uc + c, lo:min(lo + 32, N)] += 1
                        fit[uc + c, lo // 32] += 1
    return base, fit


def patch_replay(base_in, fit_in, req_u, used, alloc, cols, cfg, nsm: int = H100_SMS):
    """K4's column mode on CPU tensors -> the new (base_u, fit_u): each
    block marks its tile's listed columns from the whole list, compacts
    them, scores the (class, column) pairs with the plain functions and
    merges them into the resident generation word by word."""
    U1, N = base_in.shape
    W = fit_in.shape[1]
    tiles, slices, cs = usage_grid(U1, N, nsm)
    lst = cols.numpy().astype(np.int64)
    base_u = torch.empty_like(base_in)
    fit_u = np.zeros((U1, W), np.uint32)
    fin = fit_in.numpy().view(np.uint32)
    for bx in range(tiles):
        n0 = bx * UT
        end = min(n0 + UT, N)
        listed = np.zeros(UT, bool)
        for c in lst:  # the threads' strided pass over the list, in any order
            if n0 <= c < end:
                listed[c - n0] = True
        dcol = np.flatnonzero(listed)  # the compaction: warps in order, lanes by popc
        slot = np.full(UT, -1)
        slot[dcol] = np.arange(dcol.size)
        touched = [int(np.packbits(listed[32 * k:32 * k + 32], bitorder="little").view("<u4")[0])
                   for k in range(UT // 32)]
        for by in range(slices):
            ua, ub = by * cs, min(U1, by * cs + cs)
            for uc in range(ua, ub, PCB):
                cb = min(PCB, ub - uc)
                colsel = torch.as_tensor(n0 + dcol, dtype=torch.int64)
                rq = req_u[uc:uc + cb]
                res_base = _scores(rq, used[colsel], alloc[colsel], cfg)  # [cb, listed]
                res_fit = fit_rows(rq, used[colsel], alloc[colsel])
                for c in range(cb):
                    u = uc + c
                    for warp in range(UT // 32):
                        lo = n0 + 32 * warp
                        if lo >= N:
                            continue
                        fresh = 0
                        for lane in range(32):
                            n, my = lo + lane, slot[32 * warp + lane]
                            if n < N:
                                base_u[u, n] = res_base[c, my] if my >= 0 else base_in[u, n]
                            if my >= 0 and bool(res_fit[c, my]):
                                fresh |= 1 << lane
                        fit_u[u, lo // 32] = (int(fin[u, lo // 32]) & ~touched[warp] & M32) | fresh
    return base_u, torch.from_numpy(fit_u.view(np.int32))


def tiled_words(rng, rows: int, S: int, nl: int, garbage_tails: bool = False) -> np.ndarray:
    """Per-shard packed blocks [rows, S * ceil(nl / 32)]: the packed form of
    random bits, or (garbage_tails) random words whose bits past each
    block's nl are set too (the plain stitch reads only the nl bits)."""
    if garbage_tails:
        return rng.integers(-2**31, 2**31, (rows, S * -(-nl // 32)), dtype=np.int64).astype(np.int32)
    x = torch.from_numpy(rng.random((rows, S * nl)) < 0.45)
    return bitplane.pack_blocks(x, S).numpy()


def usage_inputs(seed: int, U1: int, N: int, R: int, device="cpu"):
    """Request rows [U1, R] and node rows [N, R] (used, alloc) for K4 alone,
    made with numpy from a seed: zero capacities, requests of zero, usage
    near int32 max, alloc - used that wraps."""
    rng = np.random.default_rng(seed)
    big = rng.random((N, R)) < 0.1
    alloc = np.where(big, rng.integers(2**30, 2**31 - 1, (N, R)), rng.integers(0, 5000, (N, R)))
    alloc[rng.random((N, R)) < 0.05] = 0
    used = (alloc * rng.random((N, R)) * 0.5).astype(np.int64)
    used[rng.random((N, R)) < 0.02] = 2**31 - 1
    req = rng.integers(0, 400, (U1, R))
    req[rng.random((U1, R)) < 0.2] = 0
    return tuple(torch.from_numpy(x.astype(np.int32)).to(device) for x in (req, used, alloc))


def col_lists(N: int, rng) -> dict:
    """Column lists as the route builds them (ascending, padded with the
    sentinel N to a power of two of at least 16): one column, every column
    of one word, the first and last words, N/2 - 1 columns; and one it does
    not build (unordered, repeated, the sentinel inside)."""
    def padded(c):
        out = np.full(max(16, 1 << max(0, len(c) - 1).bit_length()), N, np.int32)
        out[: len(c)] = c
        return out

    W = -(-N // 32)
    c = rng.choice(N, max(1, N // 3), replace=False)
    return {"one": padded([int(rng.integers(N))]),
            "one word": padded(np.arange(32 * (W // 2), min(N, 32 * (W // 2) + 32))),
            "first and last words": padded(np.unique(np.r_[np.arange(min(32, N)), np.arange(32 * (W - 1), N)])),
            "N/2 - 1": padded(np.sort(rng.choice(N, max(1, N // 2 - 1), replace=False))),
            "unordered, repeated": rng.permutation(np.r_[c, c[: len(c) // 2], [N] * 3]).astype(np.int32)}
