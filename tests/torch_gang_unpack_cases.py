"""Numpy replays of kernels K13 gang_quorum and K9 unpack_planes: their
grids, index work and stores as the CUDA sources do them, so the index
logic is held to the plain versions and the JAX package where there is no
card.

K13 (csrc/gang.cu): the cluster choice (the fewest blocks >= one unit of 4
pods a thread whose shared memory holds ceil(G / kc) groups' 8-byte
counters, else the counters in the global scratch), block q's pod slice
(chunk a multiple of 4) and group range (owner g // gs), each thread's unit
of 4 pods folded into runs of one group (a run ending inside the unit sent
straight to its owner), the unit's last run combined across the warp (the
lanes of one key, the placed sum from three ballots, the lowest lane
sending), the owners' judgement (present where a lowest pod was recorded,
first = the least lowest pod over the bad groups, pushed into every
block's slot) and each block's revocation of the failed group's valid
pods in its own slice.

K9 (csrc/unpack_planes.cu): a thread a half word in row-major order (the
y axis a batch of rows, the row one 32-bit division of the index inside
the batch), the half's column range clipped at n, and its stores: one
16-byte store where the first byte is 16-aligned and the half whole, else
single bytes to 4-byte alignment, whole 4-byte words, single bytes.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

# csrc/gang.cu
Q_NT, Q_UNIT, Q_MAX_KC, Q_SMEM_CAP = 1024, 4, 16, 232448 - 1024
IMAX = 0x7FFFFFFF
# csrc/unpack_planes.cu
U_NT, U_BATCH_HALVES = 256, 1 << 30

CSRC = Path(__file__).resolve().parent.parent / "kubernetes_tpu_torch" / "csrc"


def source_constants() -> dict:
    """The constants above as the CUDA sources define them."""
    gang = (CSRC / "gang.cu").read_text()
    unpack = (CSRC / "unpack_planes.cu").read_text()

    def const(src, name):
        return re.search(rf"constexpr \w+ {name} = ([^;]+);", src).group(1)

    return dict(Q_NT=int(const(gang, "NT")), Q_UNIT=int(const(gang, "UNIT")), Q_MAX_KC=int(const(gang, "MAX_KC")),
                Q_SMEM_CAP=eval(const(gang, "SMEM_CAP")), U_NT=int(const(unpack, "NT")),
                U_BATCH_HALVES=eval(const(unpack, "BATCH_HALVES").replace("(int64_t)", "")))


# ---------------------------------------------------------------------------
# K13
# ---------------------------------------------------------------------------

def quorum_cluster(P: int, G: int, max_kc: int = Q_MAX_KC, fits=lambda k: True) -> tuple:
    """csrc/gang.cu choose -> (kc, global counters, gs, chunk): the fewest
    blocks from one unit a thread up whose shared memory holds the counters,
    else the widest below; else the counters in the global scratch, the
    widest cluster up to one unit a thread.  `fits(k)`: whether the card
    schedules a cluster of k blocks."""
    want = min(max_kc, max(1, -(-P // (Q_NT * Q_UNIT))))
    kc, gm = 0, False
    for k in [*range(want, max_kc + 1), *range(want - 1, 0, -1)]:
        if 8 * -(-G // k) <= Q_SMEM_CAP and fits(k):
            kc = k
            break
    if kc == 0:
        kc = next(k for k in range(want, 0, -1) if fits(k))
        gm = True
    per = -(-P // kc)
    return kc, gm, -(-G // kc), -(-per // Q_UNIT) * Q_UNIT


def _unit(choices, pod_group, pv, p0, hi, G):
    g, placed = [], []
    for p in range(p0, p0 + Q_UNIT):
        gk = int(pod_group[p]) if p < hi else -1
        ok = p < hi and 0 <= gk < G and bool(pv[p])
        g.append(gk if ok else -1)
        placed.append(ok and int(choices[p]) >= 0)
    return g, placed


def replay_quorum(choices, pod_group, pv, group_min, kc: int, gm: bool = False, nt: int = Q_NT) -> dict:
    """K13 on numpy arrays with a cluster of kc blocks (gm: the counters in
    the global scratch) -> sched, present, bad, first, pv (next), done, and
    the number of counter updates (flushes) the count sent."""
    P, G = pod_group.shape[0], group_min.shape[0]
    gs = -(-G // kc)
    chunk = -(-(-(-P // kc)) // Q_UNIT) * Q_UNIT
    if gm:
        placed_c, low_c = np.zeros(G, np.int64), np.full(G, IMAX, np.int64)
    else:
        placed_c, low_c = np.zeros((kc, gs), np.int64), np.full((kc, gs), IMAX, np.int64)
    flushes = [0]

    def flush(g, n, low):
        flushes[0] += 1
        if gm:
            placed_c[g] += n
            low_c[g] = min(low_c[g], low)
        else:
            r = g // gs
            assert r < kc, (g, gs, kc)
            placed_c[r, g - r * gs] += n
            low_c[r, g - r * gs] = min(low_c[r, g - r * gs], low)

    slices = []
    valid_g = np.where((pod_group >= 0) & (pod_group < G) & pv, pod_group, -1)  # load_unit's groups
    for q in range(kc):
        lo = min(P, q * chunk)
        hi = min(P, lo + chunk)
        u0, u1 = -(-lo // Q_UNIT), -(-hi // Q_UNIT)
        slices.append((lo, hi, u0, u1))
        for base in range(u0, u1, nt):
            for w in range(0, min(nt, u1 - base), 32):
                keys, ns, lows = [], [], []
                for lane in range(32):
                    u = base + w + lane
                    g, placed = _unit(choices, pod_group, pv, u * Q_UNIT, hi, G) if u < u1 else ([-1] * 4, [0] * 4)
                    key, n, low = -1, 0, 0
                    for k in range(Q_UNIT):
                        if g[k] < 0:
                            continue
                        if g[k] != key:
                            if key >= 0:
                                flush(key, n, low)
                            key, low, n = g[k], u * Q_UNIT + k, 0
                        n += int(placed[k])
                    keys.append(key)
                    ns.append(n)
                    lows.append(low)
                ballots = [sum(1 << lane for lane in range(32) if ns[lane] & (1 << b)) for b in range(3)]
                peers = {}
                for lane in range(32):
                    peers[keys[lane]] = peers.get(keys[lane], 0) | 1 << lane
                for key, mask in peers.items():
                    leader = (mask & -mask).bit_length() - 1  # __ffs(peers) - 1
                    if key >= 0:
                        total = sum(bin(ballots[b] & mask).count("1") << b for b in range(3))
                        flush(key, total, lows[leader])
    sched = np.zeros(G, np.int32)
    present = np.zeros(G, bool)
    bad = np.zeros(G, bool)
    slot, slot_g = IMAX, -1
    for q in range(kc):
        g0 = q * gs
        block_min, block_g = IMAX, -1
        for i in range(max(0, min(G, g0 + gs) - g0)):
            g = g0 + i
            pl, lw = (placed_c[g], low_c[g]) if gm else (placed_c[q, i], low_c[q, i])
            sched[g] = pl
            present[g] = lw != IMAX
            bad[g] = present[g] and pl < group_min[g]
            if bad[g] and int(lw) < block_min:
                block_min, block_g = int(lw), g
        if block_min < slot:
            slot, slot_g = block_min, block_g
    pv_next = pv.copy()
    if slot != IMAX:
        assert pod_group[slot] == slot_g
        for lo, hi, _, _ in slices:  # the failed group's valid pods
            pv_next[lo:hi] &= valid_g[lo:hi] != slot_g
    return dict(sched=sched, present=present, bad=bad, first=slot if slot != IMAX else -1, pv=pv_next,
                done=slot == IMAX, flushes=flushes[0], slices=slices, gs=gs)


def _gangs(rng, P, G, lo=1, hi=80):
    """pod_group of consecutive gangs of random sizes over P pods, G groups
    (-1 past the last gang), and each group's quorum somewhere in its size."""
    pod_group = np.full(P, -1, np.int32)
    group_min = np.ones(G, np.int32)
    p = 0
    for g in range(G):
        size = int(rng.integers(lo, hi + 1))
        pod_group[p:p + size] = g
        group_min[g] = int(rng.integers(1, size + 1))
        p += size
        if p >= P:
            break
    return pod_group, group_min


def quorum_case(name: str):
    """(choices i32[P], pod_group i32[P], pv bool[P], group_min i32[G]) of
    a named K13 case, made from a seed with numpy."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "groups-5000":  # more groups than one block's share, consecutive gangs
        P, G = 12000, 5000
        pod_group, group_min = _gangs(rng, P, G, 1, 4)
    elif name == "G=P":  # a group a pod, some with quorum 2
        P = G = 3000
        pod_group = rng.permutation(P).astype(np.int32)
        group_min = rng.integers(1, 3, G).astype(np.int32)
    elif name in ("ragged-4999", "ragged-7"):
        P = 4999 if name == "ragged-4999" else 7
        G = 300 if P > 7 else 3
        pod_group = rng.integers(-1, G, P).astype(np.int32)
        group_min = rng.integers(1, 20 if P > 7 else 3, G).astype(np.int32)
    elif name in ("straddle", "last-slice", "config5-like", "config5-revoke"):
        P, G = (65536, 1000) if name.startswith("config5") else (10000, 150)
        pod_group = np.full(P, -1, np.int32)  # G gangs of P // G pods, the rest padding
        pod_group[: G * (P // G)] = np.repeat(np.arange(G, dtype=np.int32), P // G)
        group_min = np.full(G, 10, np.int32)
    elif name in ("wide-G", "global-counters"):  # most groups without a pod; more groups than P
        P, G = (4000, 40000) if name == "wide-G" else (9000, 470000)
        pod_group = rng.integers(-1, G, P).astype(np.int32)
        pod_group[: P // 2] = np.repeat(rng.integers(0, G, -(-P // 16)), 8)[: P // 2]  # runs of 8
        group_min = rng.integers(1, 4, G).astype(np.int32)
    elif name == "mixed-invalid":
        P, G = 6000, 400
        pod_group, group_min = _gangs(rng, P, G, 4, 30)
        pod_group[rng.random(P) < 0.1] = -1
    else:
        raise KeyError(name)
    choices = np.where(rng.random(P) < 0.9, rng.integers(0, 50, P), -1).astype(np.int32)
    pv = rng.random(P) < 0.95 if name in ("ragged-4999", "mixed-invalid", "G=P") else np.ones(P, bool)
    if name in ("straddle", "last-slice", "config5-like", "config5-revoke"):
        choices[:] = 1  # every group meets its quorum ...
        kc, _, _, chunk = quorum_cluster(P, G)
        if name == "straddle":  # ... but the one across the first slice boundary
            g = int(pod_group[chunk])
            assert pod_group[chunk - 1] == g
            choices[pod_group == g] = -1
        elif name == "last-slice":  # ... but two that start in the last block's slice
            for g in (int(pod_group[(kc - 1) * chunk]) + 1, G - 1):
                choices[pod_group == g] = -1
        elif name == "config5-revoke":  # ... but groups G/2 and G-1 (chip_smoke.py's revocation input)
            choices[(pod_group == G // 2) | (pod_group == G - 1)] = -1
    return choices, pod_group, pv, group_min


QUORUM_CASES = ["groups-5000", "G=P", "ragged-4999", "ragged-7", "straddle", "last-slice", "mixed-invalid",
                "config5-like", "config5-revoke", "wide-G", "global-counters"]


def jax_rule(choices, pod_group, pv, group_min, failed_groups):
    """The JAX package's host fixpoint step on numpy arrays: its
    failed_groups (gang.py:33) and its revocation (gang.py:103-107, np.argmax
    over in_bad) -> (bad, first or -1, pv next, done)."""
    bad = failed_groups(choices, pod_group, group_min, active=pv)
    if not bad.any():
        return bad, -1, pv.copy(), True
    in_bad = bad[np.maximum(pod_group, 0)] & (pod_group >= 0) & pv
    first = int(np.argmax(in_bad))
    first_g = pod_group[first]
    newly = (pod_group == first_g) & pv
    return bad, first, pv & ~newly, False


# ---------------------------------------------------------------------------
# K9
# ---------------------------------------------------------------------------

def replay_unpack(words: np.ndarray, n: int, base: int = 0, batch_halves: int = U_BATCH_HALVES) -> dict:
    """K9 on int32 words [rows, W] with the output at byte address `base`
    (mod 16) -> out bool[rows, n], writes (how often each byte was
    written), the stores by width, and the launch's grid; `batch_halves`:
    the halves a y-batch may hold (the source's BATCH_HALVES; smaller to
    replay many batches)."""
    rows, W = words.shape
    per_row = 2 * W
    out = np.zeros(rows * n, np.uint8)
    writes = np.zeros(rows * n, np.int64)
    stores = {16: 0, 4: 0, 1: 0}
    if rows == 0 or n == 0:
        return dict(out=out.reshape(rows, n).astype(bool), writes=writes, stores=stores, grid=None)
    batch = min(batch_halves // per_row, rows)
    ny = -(-rows // batch)
    gx = -(-(batch * per_row) // U_NT)
    assert batch * per_row <= 1 << 32 and ny <= 65535
    x32 = words.view(np.uint32).astype(np.int64)
    for y in range(ny):
        i = np.arange(gx * U_NT, dtype=np.int64)
        rl = i // per_row
        r = y * batch + rl
        h = i - rl * per_row
        j0 = 16 * h
        ln = np.minimum(16, n - j0)
        live = (rl < batch) & (r < rows) & (ln > 0)
        r, h, j0, ln = r[live], h[live], j0[live], ln[live]
        x = x32[r, h >> 1] >> (16 * (h & 1))
        at = r * n + j0
        addr = base + at
        fast = (ln == 16) & (addr % 16 == 0)
        stores[16] += int(fast.sum())
        head = np.where(fast, 0, np.minimum(ln, (4 - addr % 4) % 4))
        m = np.where(fast, 0, (ln - head) // 4)
        assert (((addr + head) % 4 == 0) | (m == 0)).all()
        stores[4] += int(m.sum())
        stores[1] += int(np.where(fast, 0, ln - 4 * m).sum())
        for k in range(16):
            wk = k < ln
            out[at[wk] + k] = (x[wk] >> k) & 1
            np.add.at(writes, at[wk] + k, 1)
    return dict(out=out.reshape(rows, n).astype(bool), writes=writes, stores=stores, grid=(gx, ny))
