"""Pure-Python replays of the one-device per-pod scans' cluster layout:
kernel K2 fit_scan (csrc/fit_scan.cu) and K11 full_scan (csrc/full_scan.cu)
each run one thread-block cluster of kc blocks, block q on its run of the
node axis.  The replay follows the sources: the cluster width the launch
takes (at most the cap, whole UNIT-node units a block for K2, MIN_RUN nodes
a block for K11), each block's run, each thread's walk of its nodes (nodes
lo + t, lo + t + NT, ...) keeping its first best, the block's reduction of
the threads' (score, node id) keys, and the combine of the kc blocks'
keys read in rank order.  The tests hold the result to a plain argmax
with ties (the highest score, the lowest index; -1 where no node is
feasible).

The shard modes run the same cluster over the shard-major sequence of
every shard's nodes (shard_axis): K2 over each shard's nl nodes padded to
whole units (a padding column never passes), K11 over the S * nl global
ids; the keys carry the axis position, written out as the global id
s * nl + j (shard_cluster_choice).
"""

from __future__ import annotations

import math

# csrc/fit_scan.cu and csrc/full_scan.cu
NT, UNIT, MIN_RUN, MAX_KC = 1024, 16, 32, 16
IMAX = 2**31 - 1


def fit_run_lo(q: int, kc: int, N: int) -> int:
    """fit_scan.cu run_lo: whole UNIT-node units (N a multiple of UNIT)."""
    return UNIT * (q * (N // UNIT) // kc)


def full_run_lo(q: int, kc: int, N: int) -> int:
    """full_scan.cu run_lo: near-equal runs of nodes."""
    return q * N // kc


def fit_width(cap: int, N: int) -> int:
    """The widest K2 cluster the launch tries first (ktt_fit_scan's launch)."""
    return min(cap, N // UNIT)


def full_width(cap: int, N: int) -> int:
    """The widest K11 cluster the launch tries first (ktt_full_scan)."""
    return max(1, min(cap, N // MIN_RUN))


def better(a, b) -> bool:
    """(score desc, node id asc): the kernels' `better` / `pw_better`."""
    return a[0] > b[0] or (a[0] == b[0] and a[1] < b[1])


def block_key(total, lo: int, hi: int, nt: int = NT):
    """A block's best over [lo, hi): each thread's first best over its nodes
    (a strict > keeps the lowest index, its nodes ascend), then the
    reduction over the threads (any order: the keys are totally ordered)."""
    key = (-math.inf, IMAX)
    for t in range(nt):
        best = (-math.inf, IMAX)
        for n in range(lo + t, hi, nt):
            if total[n] > best[0]:
                best = (total[n], n)
        if better(best, key):
            key = best
    return key


def cluster_choice(total, kc: int, run_lo, nt: int = NT) -> int:
    """The choice the cluster makes: each block's key over its run, the kc
    keys folded in rank order; -1 where the best is -inf."""
    N = len(total)
    key = (-math.inf, IMAX)
    for q in range(kc):
        k = block_key(total, run_lo(q, kc, N), run_lo(q + 1, kc, N), nt)
        if better(k, key):
            key = k
    return key[1] if key[0] > -math.inf else -1


def plain_argmax(total) -> int:
    best = max(total, default=-math.inf)
    return total.index(best) if best > -math.inf else -1


def shard_width(kernel: str, nl: int) -> int:
    """A shard's columns on the kernel's node axis: K2 pads nl to the unit."""
    return -(-nl // UNIT) * UNIT if kernel == "fit_scan" else nl


def shard_axis(kernel: str, total, S: int, nl: int):
    """The global row `total` (S * nl values) laid on the kernel's node axis:
    shard by shard, each padded to shard_width with -inf."""
    w = shard_width(kernel, nl)
    return [x for s in range(S) for x in list(total[s * nl:(s + 1) * nl]) + [-math.inf] * (w - nl)]


def shard_cluster_choice(kernel: str, total, S: int, nl: int, cap: int, nt: int = NT) -> int:
    """The shard mode's choice: the cluster over shard_axis (the width the
    launch tries first), its axis position written out as the global id."""
    axis = shard_axis(kernel, total, S, nl)
    N = len(axis)
    kc, run_lo = (fit_width(cap, N), fit_run_lo) if kernel == "fit_scan" else (full_width(cap, N), full_run_lo)
    g = cluster_choice(axis, kc, run_lo, nt)
    if g < 0:
        return -1
    w = shard_width(kernel, nl)
    return (g // w) * nl + g % w
