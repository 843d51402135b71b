"""Kernels K14 explain_counts (csrc/explain.cu) and K10 score_planes
(csrc/score_planes.cu): their edge-shape inputs, made with numpy from a
seed, and a numpy replay of each kernel's decomposition step by step, for
tests/test_torch_score_explain.py (the CPU: replay == the port's plain
versions == the JAX functions) and the ``cuda`` legs of
tests/test_torch_explain.py and tests/test_torch_pairwise.py (kernel ==
plain).  Imports no JAX.

The replays follow the kernels' own steps and constants: the node tiles,
the words packed from the bool bytes (a warp ballot is a word of 32
lanes' bits), the term stage (up to ALL_S terms: every term, slot s =
term s; more: terms.cuh's named terms, a bitmap over S, the ascending
list, a term's slot = the named terms below it), each thread's
share of the pairs, and for K14 the per-thread 6-bit counters, the
block's sums per (rep, column) added into the block's copy of the
accumulator, and the two tickets whose last block sums the copies into
`out` and leaves the accumulator zero; the blocks run in a shuffled
order, as on the card.  The fallbacks (taints
past the staged words, terms past the bitmap or the staged list) take the
kernels' per-pair paths; the staging limits are arguments so small cases
reach them.
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_tpu_torch.api.snapshot import ClusterArrays

KIND_PAD, KIND_ANY, KIND_NONE = 0, 1, 2
NAMED_S_MAX = 8192  # csrc/terms.cuh
# csrc/explain.cu
EX_NT, EX_TILE, EX_COPIES, EX_FR_MAX, EX_TW_STAGE, EX_NS_MAX = 128, 32, 8, 128, 8, 256
ALL_S = 32  # both kernels: up to this many terms every term gets its bits, term s is slot s
# csrc/score_planes.cu
SP_NT, SP_TN, SP_TW_STAGE, SP_NS_MAX, SP_TARGET, SP_ROWBUF = 256, 128, 16, 512, 528, 16384


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def cluster(seed: int, N: int, P: int, R: int = 4, T: int = 3, TT: int = 2, S: int = 6, E: int = 2, L: int = 12,
            PW: int = 3, wrap: bool = False) -> dict:
    """Host arrays of a random cluster with every field K14 and K10 read:
    invalid and unschedulable nodes, hard and PreferNoSchedule taints, label
    rows and selector terms of every kind (3: no kind, never satisfied),
    pins to a node, to none (-1) and to a missing one (-2), -1 and repeated
    preference slots.  `wrap`: alloc - used wraps as int32 on some nodes."""
    rng = np.random.default_rng(seed)
    alloc = rng.integers(0, 4000, (N, R)).astype(np.int32)
    used = (alloc * rng.random((N, R))).astype(np.int32)
    if wrap and N and R:
        k = max(1, N // 4)
        alloc[:k, 0] = np.iinfo(np.int32).min + rng.integers(0, 50, k)
        used[:k, 0] = rng.integers(1, 4000, k)  # alloc - used wraps to a large positive free
        alloc[k:2 * k, R - 1] = np.iinfo(np.int32).max - rng.integers(0, 50, len(alloc[k:2 * k]))
        used[k:2 * k, R - 1] = -rng.integers(100, 4000, len(used[k:2 * k]))  # wraps to a negative free
    pin = np.full(P, -1, np.int32)
    r = rng.random(P)
    pin[r < 0.15] = rng.integers(0, max(N, 1), int((r < 0.15).sum()))
    pin[(r >= 0.15) & (r < 0.22)] = -2
    terms = rng.integers(-1, max(S, 1), (P, TT)).astype(np.int32) if S else np.full((P, TT), -1, np.int32)
    pref = rng.integers(-1, max(S, 1), (P, PW)).astype(np.int32) if S else np.full((P, PW), -1, np.int32)
    if S and P and PW >= 2:
        pref[0, :2] = pref[0, 0] if pref[0, 0] >= 0 else 0  # a term listed twice adds twice
    return dict(
        node_valid=rng.random(N) < 0.9, node_alloc=alloc, node_used=used, node_unsched=rng.random(N) < 0.1,
        node_labels=rng.random((N, L)) < 0.3, node_taint_ns=rng.random((N, T)) < 0.1,
        node_taint_pref=rng.random((N, T)) < 0.2,
        pod_valid=np.ones(P, bool),
        pod_req=(rng.integers(0, 3000, (P, R)) * (rng.random((P, R)) < 0.8)).astype(np.int32),
        pod_prio=np.zeros(P, np.int32), pod_tol_ns=rng.random((P, T)) < 0.6, pod_tol_pref=rng.random((P, T)) < 0.5,
        pod_nodename=pin, pod_terms=terms, pod_has_sel=rng.random(P) < 0.5,
        sel_mask=rng.random((S, E, L)) < 0.25, sel_kind=rng.integers(0, 4, (S, E)).astype(np.int32),
        pod_pref_terms=pref, pod_pref_weights=rng.integers(1, 101, (P, PW)).astype(np.float32),
    )


def reps_of(seed: int, P: int, F: int) -> tuple:
    """(reps i64[F], rep_valid bool[F]): random rows, a few invalid."""
    rng = np.random.default_rng(seed + 1000)
    reps = rng.integers(0, P, F).astype(np.int64)
    valid = rng.random(F) < 0.85
    if F:
        valid[0] = True
    return reps, valid


def arrays(host: dict, device="cpu") -> ClusterArrays:
    return ClusterArrays.from_numpy(host, device)


# the CPU cases: name -> (cluster kwargs, F, replay knobs)
EXPLAIN_CASES = {
    "T0": (dict(seed=1, N=150, P=40, T=0), 5, {}),
    "T1": (dict(seed=2, N=150, P=40, T=1), 5, {}),
    "T32": (dict(seed=3, N=150, P=40, T=32), 5, {}),
    "T33": (dict(seed=4, N=150, P=40, T=33), 5, {}),
    "T70": (dict(seed=5, N=150, P=40, T=70), 8, {}),
    "R0": (dict(seed=6, N=140, P=30, R=0), 4, {}),
    "R1": (dict(seed=7, N=140, P=30, R=1), 4, {}),
    "R5": (dict(seed=8, N=140, P=30, R=5), 4, {}),
    "R32": (dict(seed=9, N=140, P=30, R=32), 4, {}),
    "N1-F1": (dict(seed=10, N=1, P=7), 1, {}),
    "N129": (dict(seed=11, N=129, P=20), 3, {}),
    "N300-F130": (dict(seed=12, N=300, P=200), 130, {}),  # two slices of 128 reps
    "F257": (dict(seed=13, N=40, P=300), 257, {}),
    "wrap": (dict(seed=14, N=160, P=30, R=3, wrap=True), 6, {}),
    "direct-taint": (dict(seed=15, N=140, P=30, T=70), 6, dict(tw_stage=1)),
    "named-terms": (dict(seed=18, N=140, P=60, S=70, TT=3), 40, {}),
    "direct-terms": (dict(seed=16, N=140, P=30, S=40), 6, dict(ns_max=2)),
    "wide-S": (dict(seed=17, N=140, P=30, S=40), 6, dict(s_max=36)),
}

SCORE_CASES = {
    "T0": (dict(seed=21, N=150, P=40, T=0), {}),
    "T1": (dict(seed=22, N=150, P=40, T=1), {}),
    "T32": (dict(seed=23, N=150, P=40, T=32), {}),
    "T33": (dict(seed=24, N=150, P=40, T=33), {}),
    "T70": (dict(seed=25, N=150, P=40, T=70), {}),
    "S0": (dict(seed=26, N=130, P=33, S=0, PW=3), {}),
    "PW1": (dict(seed=27, N=257, P=9, PW=1), {}),
    "N1": (dict(seed=28, N=1, P=17), {}),
    "N255-P1030": (dict(seed=29, N=255, P=1030, T=5, S=11, E=3, L=40), {}),
    "direct-taint": (dict(seed=30, N=140, P=30, T=70), dict(tw_stage=1)),
    "named-terms": (dict(seed=34, N=140, P=300, S=70, PW=4), {}),
    "direct-terms": (dict(seed=31, N=140, P=30, S=40), dict(ns_max=2)),
    "wide-S": (dict(seed=32, N=140, P=30, S=40), dict(s_max=36)),
    "unstaged-rows": (dict(seed=33, N=140, P=30, PW=40), dict(rowbuf=256)),
}


# ---------------------------------------------------------------------------
# shared steps
# ---------------------------------------------------------------------------

def tw_of(T: int) -> int:
    return (T + 31) // 32 if T > 32 else 1  # T == 0 packs to one zero word


def pack_words(rows: np.ndarray, TW: int) -> np.ndarray:
    """uint64 [M, TW]: word w of each bool row holds its bits 32 w .. 32 w +
    31 (bit b of the word is byte 32 w + b), as pack_word and a warp
    ballot give them."""
    M, T = rows.shape
    out = np.zeros((M, TW), dtype=np.uint64)
    for w in range(TW):
        for b in range(min(32, T - 32 * w)):
            out[:, w] |= rows[:, 32 * w + b].astype(np.uint64) << np.uint64(b)
    return out


def popc(x: np.ndarray) -> np.ndarray:
    x = np.ascontiguousarray(x, dtype="<u8")
    return np.unpackbits(x.view(np.uint8).reshape(*x.shape, 8), axis=-1).sum(axis=-1).astype(np.int64)


def term_ok(h: dict, s: int, nodes: np.ndarray) -> np.ndarray:
    """terms.cuh term_ok of term s for each node of `nodes`."""
    ok = np.ones(len(nodes), dtype=bool)
    lab = h["node_labels"][nodes].astype(np.int64)
    for e in range(h["sel_kind"].shape[1]):
        kind = int(h["sel_kind"][s, e])
        if kind == KIND_PAD:
            continue
        if kind not in (KIND_ANY, KIND_NONE):
            return np.zeros(len(nodes), dtype=bool)
        cnt = lab @ h["sel_mask"][s, e].astype(np.int64)
        ok &= (cnt > 0) if kind == KIND_ANY else (cnt == 0)
    return ok


def named_terms(entries, S: int, list_max: int) -> dict:
    """terms.cuh's stage: the bitmap over S of the named terms, `below`
    per 32-term word, the ascending list (its first list_max entries) and
    the count."""
    sw = (S + 31) // 32
    bits = np.zeros(sw, dtype=np.uint64)
    for s in entries:
        if 0 <= s < S:
            bits[s >> 5] |= np.uint64(1) << np.uint64(s & 31)
    counts = popc(bits)
    below = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64) if sw else np.zeros(0, np.int64)
    listed = [w * 32 + b for w in range(sw) for b in range(32) if (int(bits[w]) >> b) & 1]
    return dict(bits=bits, below=below, list=listed[:list_max], count=len(listed))


def named_slot(nt: dict, s: int) -> int:
    word = int(nt["bits"][s >> 5])
    return int(nt["below"][s >> 5]) + bin(word & ((1 << (s & 31)) - 1)).count("1")


# ---------------------------------------------------------------------------
# K14
# ---------------------------------------------------------------------------

def replay_explain(h: dict, used: np.ndarray, reps: np.ndarray, rep_valid: np.ndarray, order_seed: int = 0,
                   acc: np.ndarray = None, tw_stage: int = EX_TW_STAGE, ns_max: int = EX_NS_MAX,
                   s_max: int = NAMED_S_MAX) -> tuple:
    """csrc/explain.cu step by step -> (out i32[F, 4+R+1], the accumulator
    after the launch).  `acc`: the wrapper's accumulator before it (zero)."""
    N, R = h["node_alloc"].shape
    T, TT = h["node_taint_ns"].shape[1], h["pod_terms"].shape[1]
    S = h["sel_mask"].shape[0]
    F = len(reps)
    K = 4 + R + 1
    NT, TILE = EX_NT, EX_TILE
    TW = tw_of(T)
    FR = 1
    while FR < F and FR < EX_FR_MAX:
        FR <<= 1
    G = NT // FR
    nblocks = max(1, -(-N // TILE))
    M = EX_COPIES
    tickets = 1 + M
    acc = np.zeros(tickets + M * F * K, dtype=np.int64) if acc is None else acc.astype(np.int64).copy()
    out = np.full((F, K), -7, dtype=np.int64)  # torch.empty: whatever was there
    direct_taint = TW > tw_stage
    free_all = (h["node_alloc"].astype(np.uint32) - used.astype(np.uint32)).astype(np.int32)  # the uint32 wrap
    taint_words = pack_words(h["node_taint_ns"], TW)

    def block_sums(base: int) -> list:
        """One block: its [rep, column] sums, a [FR, K] array per slice."""
        sums = []
        # 1. the terms: all of them (S <= ALL_S, slot s = term s), else those the
        # valid reps with a selector name, else (too many) term_ok per pair
        direct_terms = S > ALL_S and S > s_max
        if S <= ALL_S:
            nt = dict(list=list(range(S)), count=S)
        elif not direct_terms:
            entries = [int(h["pod_terms"][reps[f], jj]) for f in range(F) for jj in range(TT)
                       if rep_valid[f] and h["pod_has_sel"][reps[f]]]
            nt = named_terms(entries, S, ns_max)
            direct_terms = nt["count"] > ns_max
        ns = 0 if direct_terms else nt["count"]
        nsw = -(-ns // 32)
        # 2. the node tile, each node once
        gn = base + np.arange(TILE)
        inside = gn < N
        gi = np.where(inside, gn, 0)
        nflags = np.where(inside, h["node_valid"][gi] * 1 + h["node_unsched"][gi] * 2, 0)
        freev = free_all[gi]  # [TILE, R]
        taintw = taint_words[gi] if not direct_taint else None
        tmn = np.zeros((nsw, TILE), dtype=np.uint64)
        for k in range(ns):
            tmn[k >> 5] |= (term_ok(h, nt["list"][k], gi) & inside).astype(np.uint64) << np.uint64(k & 31)
        # 3. the reps, FR at a time; thread t = (g, j) takes rep j, nodes g, g + G, ...
        for f0 in range(0, F, FR):
            j = np.arange(FR)
            f = f0 + j
            rv = (f < F) & rep_valid[np.minimum(f, F - 1)]
            p = np.where(rv, reps[np.minimum(f, F - 1)], 0)
            pin = h["pod_nodename"][p]
            has_sel = h["pod_has_sel"][p]
            req = h["pod_req"][p]  # [FR, R]
            if not direct_taint:
                tolw = pack_words(h["pod_tol_ns"][p], TW)  # [FR, TW]
                intol = np.zeros((FR, TILE), dtype=bool)
                for w in range(TW):
                    intol |= (taintw[None, :, w] & ~tolw[:, None, w]) != 0
            else:
                intol = (h["node_taint_ns"][gi][None, :, :] & ~h["pod_tol_ns"][p][:, None, :]).any(axis=2)
            if not direct_terms:
                selm = np.zeros((FR, max(nsw, 1)), dtype=np.uint64)
                for jj in range(FR):
                    if rv[jj] and has_sel[jj]:
                        for s in h["pod_terms"][p[jj]]:
                            if 0 <= s < S:
                                k = int(s) if S <= ALL_S else named_slot(nt, int(s))
                                selm[jj, k >> 5] |= np.uint64(1) << np.uint64(k & 31)
                sel_ok = np.zeros((FR, TILE), dtype=bool)
                for w in range(nsw):
                    sel_ok |= (tmn[w][None, :] & selm[:, w][:, None]) != 0
            else:
                sel_ok = np.zeros((FR, TILE), dtype=bool)
                for jj in range(FR):
                    for s in h["pod_terms"][p[jj]]:
                        if s >= 0:
                            sel_ok[jj] |= term_ok(h, int(s), gi)
            sel_ok = np.where(has_sel[:, None], sel_ok, True)
            short = (req[:, None, :] != 0) & (req[:, None, :] > freev[None, :, :])  # [FR, TILE, R]
            first = np.where(short.any(axis=2), short.argmax(axis=2) if R else 0, -1)
            col = np.where(first >= 0, 4 + first, 4 + R)
            col = np.where(sel_ok, col, 3)
            col = np.where(intol, np.where(nflags[None, :] & 2, 1, 2), col)
            col = np.where((pin[:, None] != -1) & (pin[:, None] != gn[None, :]), 0, col)
            live = rv[:, None] & ((nflags[None, :] & 1) != 0)
            # thread t: its counts per column in 6-bit register fields
            mine = np.zeros((NT, K), dtype=np.int64)
            t = np.arange(NT)[:, None]
            jt, nn = t % FR, t // FR + G * np.arange(-(-TILE // G))[None, :]  # thread t's rep and nodes
            mine_n = nn < TILE
            nn = np.where(mine_n, nn, 0)
            np.add.at(mine, (np.broadcast_to(t, nn.shape), col[jt, nn]), live[jt, nn] & mine_n)
            assert mine.max(initial=0) < 64
            # the block's [rep, column] sums (shared atomics)
            cnt = np.zeros((FR, K), dtype=np.int64)
            np.add.at(cnt, np.arange(NT) % FR, mine)
            sums.append(cnt)
        return sums

    # blocks finish in any order; per slice each adds its nonzero sums into its
    # copy of the accumulator, then takes its copy's ticket; a copy's last block
    # takes the top ticket, and the last of those sums the copies into out and
    # leaves the accumulator zero
    copies = min(nblocks, M)
    for b in np.random.default_rng(order_seed).permutation(nblocks):
        c = int(b) % M
        mine = tickets + c * F * K
        per_slice = block_sums(int(b) * TILE)
        for si, f0 in enumerate(range(0, F, FR)):
            sums = per_slice[si].ravel()
            for i in np.flatnonzero(sums):
                acc[mine + f0 * K + i] += sums[i]
        old = acc[1 + c]
        acc[1 + c] += 1
        if old == -(-(nblocks - c) // M) - 1:
            top = acc[0]
            acc[0] += 1
            if top == copies - 1:
                body = acc[tickets:].reshape(M, F * K)
                out[:] = body[:copies].sum(axis=0).reshape(F, K)
                body[:copies] = 0
                acc[:tickets] = 0
    return out.astype(np.int32), acc


# ---------------------------------------------------------------------------
# K10
# ---------------------------------------------------------------------------

def grid_of(P: int, N: int, PW: int = 1, T: int = 1, rowbuf: int = SP_ROWBUF) -> tuple:
    """score_planes.cu's C entry: (node tiles, pod slabs, pods a slab, pod
    rows a staged chunk: 0 where a row does not fit the stage)."""
    nbx = -(-N // SP_TN)
    rows = SP_NT // 32
    nby = -(-SP_TARGET // nbx)
    nby = max(1, min(nby, min(-(-P // rows), 65535)))
    PB = -(-P // nby)
    CH = min((rowbuf // (8 * PW + 4 * tw_of(T))) // rows * rows, -(-PB // rows) * rows)
    return nbx, -(-P // PB), PB, CH if CH >= rows else 0


def bf16_bits(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(torch.bfloat16).view(torch.int16).numpy()


def replay_score_planes(h: dict, tw_stage: int = SP_TW_STAGE, ns_max: int = SP_NS_MAX,
                        s_max: int = NAMED_S_MAX, rowbuf: int = SP_ROWBUF) -> tuple:
    """csrc/score_planes.cu step by step -> (traw, naraw) as int16 bf16 bit
    patterns [P, N]."""
    P, T = h["pod_tol_pref"].shape
    N = h["node_taint_pref"].shape[0]
    PW = h["pod_pref_terms"].shape[1]
    S = h["sel_mask"].shape[0]
    TW = tw_of(T)
    traw = np.full((P, N), -1, dtype=np.int16)  # torch.empty
    naraw = np.full((P, N), -1, dtype=np.int16)
    if P == 0 or N == 0:
        return traw, naraw
    nbx, nby, PB, CH = grid_of(P, N, PW, T, rowbuf)
    direct_taint = TW > tw_stage
    node_words = pack_words(h["node_taint_pref"], TW)
    tol_words = pack_words(h["pod_tol_pref"], TW)  # a ballot per (pod row, word)
    for bx in range(nbx):
        base = bx * SP_TN
        gn = base + np.arange(SP_TN)
        inside = gn < N
        gi = np.where(inside, gn, 0)
        # the tile's words (ballots of 32 lanes over the bytes; 0 past N)
        taintw = np.where(inside[:, None], node_words[gi], 0).astype(np.uint64)  # [TN, TW]
        for by in range(nby):
            p0, p1 = by * PB, min(P, (by + 1) * PB)
            direct_terms = S > ALL_S and S > s_max
            if S <= ALL_S:
                nt = dict(list=list(range(S)), count=S)
            elif not direct_terms:
                nt = named_terms([int(s) for s in h["pod_pref_terms"][p0:p1].ravel()], S, ns_max)
                direct_terms = nt["count"] > ns_max
            ns = 0 if direct_terms else nt["count"]
            raw = S <= ALL_S or direct_terms  # a slot is its term
            tm = np.zeros((ns, SP_TN), dtype=bool)  # bit (k, node) of the [named term][32-node word] words
            for k in range(ns):
                tm[k] = term_ok(h, nt["list"][k], gi) & inside
            # chunks of CH rows staged (slot = the named slot, or the term where
            # terms are not staged; -1 none), or, CH = 0, every row from memory;
            # a warp a row (warp w: rows + w, + 8, ...); lane l: nodes base + 4 l .. + 3
            for c0 in range(p0, p1, CH or (p1 - p0)):
                rows = range(c0, min(p1, c0 + CH) if CH else p1)
                terms = h["pod_pref_terms"][rows.start:rows.stop]
                slots = np.array([[-1 if s < 0 else (int(s) if raw else named_slot(nt, int(s)))
                                   for s in row] for row in terms], dtype=np.int64).reshape(len(rows), PW)
                for r, p in enumerate(rows):
                    c = np.zeros(SP_TN, dtype=np.int64)
                    for w in range(TW):
                        tw = taintw[:, w] if not direct_taint else node_words[gi, w] * inside
                        c += popc(tw & ~tol_words[p, w])
                    na = np.zeros(SP_TN, dtype=np.float32)
                    for k in range(PW):
                        s = int(slots[r, k])
                        if s < 0:
                            continue
                        wt = np.float32(h["pod_pref_weights"][p, k])
                        m = tm[s] if not direct_terms else term_ok(h, s, gi) & inside
                        na = np.where(m, na + wt, na).astype(np.float32)
                    keep = gn[inside]
                    traw[p, keep] = bf16_bits(c[inside].astype(np.float32))
                    naraw[p, keep] = bf16_bits(na[inside])
    return traw, naraw
