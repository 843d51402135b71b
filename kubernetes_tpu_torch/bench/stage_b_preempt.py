"""Kernels K6 chunk_rounds (stage B of the class-wave route) and K15
preempt_eval on one card, at the shapes the main path gives them.

    python3 -m kubernetes_tpu_torch.bench.stage_b_preempt [--parent DIR]

K6, on arrays encoded with DeltaEncoder.encode_device and class state from
HoistCache.ensure, as chip_smoke.py makes them: stage B after K5's wave (the
class-wave step's stage B) at the north star (heterogeneous(20000, 50000,
seed=0)), on gang(48, 64, 40) and on BASELINE config 5 (gang(1000, 64,
2000, seed=0)), each beside its byte bound (stage_b_bytes) and held to the
plain version; then the round loop with the waves off at the north star,
over all 1600 chunks and over the first 64 (held to the plain version).
K15 on the inputs of every wave of failure_cycle(build(20000, 1000)) (the
preemption bench cluster; bench/preempt_bench.py WaveProbe keeps them),
each held to the plain version, the first wave's (K = 64, N = 20480, V =
2, R = 4) and the last timed.  Times are CUDA events over back-to-back
calls after a warm-up and, where the host's wrapper call rather than the
card paces such calls (stage B, K15), the card time of calls queued
behind a sleeping kernel that outlasts their enqueue (static_rows.card_ms).
With --parent DIR (a directory holding an earlier csrc/, e.g. a `git
archive` of the parent commit under the git-ignored _parent/) the earlier
chunk_rounds.cu and preempt.cu are built too, and every timing runs in
turns (old, new, new, old), each call's outputs bit-equal to the current
build's.  Ends with one JSON line and the card's name and power limit as
nvidia-smi gives them.  Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

from .static_rows import bound_ms, card_ms, events_ms, in_turns
from .wave_phases import build_variant, card_name

# the C entry of K6 before the chunk list (its parent design): no clist
PARENT_K6_ARGTYPES = [ctypes.c_void_p] * 23 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
K6_CLIST_ARG = 21  # the position of the clist scratch in ktt_chunk_rounds


def stage_b_bytes(P: int, N: int, R: int, U1: int, listed_pods: int) -> int:
    """Bytes stage B must move after a wave (each input read once, each
    output written once): the committed flags, decisions and ordinals in,
    the usage copied, choices and ordinals out, the two scalar pairs; and
    where chunks need rounds (`listed_pods` of their pods), those pods'
    rows, the node and class tables the round loop reads and the class
    rows t0u in and out."""
    W = -(-N // 32)
    nbytes = 17 * P + 8 * N * R + 16
    if listed_pods:
        nbytes += 4 * listed_pods * R + 5 * listed_pods + 4 * N * R + 4 * U1 * (R + W) + 8 * U1 * N
    return nbytes


def open_pods(wcom, C: int) -> int:
    """Pods in chunks of C that hold a pod the wave did not commit."""
    return int((~wcom.view(-1, C)).any(dim=1).sum()) * C


def parent_k6(fn):
    """The parent's K6 C entry behind the current wrapper's arguments."""
    fn.argtypes = PARENT_K6_ARGTYPES

    def entry(*a):
        return fn(*a[:K6_CLIST_ARG], *a[K6_CLIST_ARG + 1:])

    return entry


def same(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a, b))


def k6_cells(turns, card: str) -> dict:
    import torch

    from ..api.delta import DeltaEncoder
    from ..ops import DEFAULT_SCORE_CONFIG, assign, infer_score_config, kernels
    from ..ops.incremental import HoistCache, IncState
    from . import workloads

    C = assign.INC_CHUNK
    res = {}
    cells = {"north-star": lambda: workloads.heterogeneous(**workloads.NORTH_STAR),
             "gang-small": lambda: workloads.gang(**workloads.GANG_SMALL),
             "config5": lambda: workloads.gang(**workloads.CONFIG5)}
    for cell, make in cells.items():
        arr, meta = DeltaEncoder().encode_device(make())
        cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
        inc = HoistCache().ensure(arr, meta, cfg)
        U1 = inc.req_u.shape[0]
        wk = kernels.wave_commit(arr, inc, cfg)
        wave = (wk[0], wk[1], wk[2], wk[5])
        runs = {"stage B": (lambda: kernels.chunk_rounds(arr, inc, cfg, wk[3], wk[4], wave), 20)}
        if cell == "north-star":
            n = 64 * C
            pre = arr.pod_prefix(n)
            inc_pre = IncState(cls=inc.cls[:n].contiguous(), req_u=inc.req_u, stat_u=inc.stat_u,
                               base_u=inc.base_u, fit_u=inc.fit_u)
            runs["waves off, all chunks"] = (lambda: kernels.chunk_rounds(arr, inc, cfg, arr.node_used, None, None),
                                             2)
            runs["waves off, first 64 chunks"] = (
                lambda: kernels.chunk_rounds(pre, inc_pre, cfg, arr.node_used, None, None), 5)
        listed = open_pods(wk[0], C)
        nbytes = stage_b_bytes(arr.P, arr.N, arr.R, U1, listed)
        b_ms, b_by = bound_ms(nbytes, 0)
        cres = dict(P=arr.P, N=arr.N, U1=U1, n_blocks=int(wk[5]), listed_chunks=listed // C,
                    stage_b_bytes=nbytes, stage_b_bound_ms=b_ms, runs={})
        for what, (run, reps) in runs.items():
            ref = run()
            sweeps = kernels.read_sweeps(ref[3])
            if what == "stage B":
                cp = assign.schedule_scan_chunked_plain(arr, cfg, inc, wk[3], wk[4], (*wave[:3], int(wk[5])))
            elif what == "waves off, first 64 chunks":
                cp = assign.schedule_scan_chunked_plain(pre, cfg, inc_pre, arr.node_used,
                                                        assign.t0u_prologue(inc, arr.N), None)
            else:
                cp = None
            if cp is not None and not (same(ref[:3], cp[:3]) and sweeps == cp[3]):
                raise RuntimeError(f"k6 {cell} {what}: chunk_rounds != plain")
            got = {}

            def call():
                got["k"] = run()

            def check(who):
                if not same(got["k"], ref):
                    raise RuntimeError(f"k6 {cell} {what}: the {who} build's outputs differ")

            ms = in_turns(f"k6 {cell}", f"{what} ({sweeps} sweeps), back to back",
                          lambda: events_ms(call, reps=reps, warmup=1), turns, check, "chunk_rounds")
            cres["runs"][what] = dict(sweeps=sweeps, ms=ms)
            if what == "stage B":  # launch-bound: the host's wrapper call paces back-to-back calls
                cres["runs"][what]["card_ms"] = in_turns(
                    f"k6 {cell}", f"{what}, card time (queued behind a sleep)",
                    lambda: card_ms(call, reps=reps), turns, check, "chunk_rounds")
        print(f"[k6 {cell}] {card} | P={arr.P} N={arr.N} U1={U1}: wave blocks {int(wk[5])}, chunks that need "
              f"rounds after it {listed // C} of {arr.P // C}; stage B == plain, byte bound {b_ms:.6f} ms "
              f"({b_by}: {nbytes} B)", flush=True)
        res[cell] = cres
        del arr, meta, inc, wk, wave, runs
        torch.cuda.empty_cache()
    return res


def k15_cell(turns, card: str) -> dict:
    import numpy as np
    import torch

    from ..ops import kernels
    from ..ops import preempt as tpre
    from . import preempt_bench as pb
    from . import workloads

    snap = pb.build(**workloads.PREEMPT)
    with pb.WaveProbe(keep=True) as probe:
        pb.failure_cycle(snap)
        torch.cuda.synchronize()
    waves = []
    for c in probe.calls:
        arr, idxs, *ins = c["inputs"]
        idx = torch.from_numpy(idxs).to(arr.device)
        dins = [torch.from_numpy(np.ascontiguousarray(x)).to(arr.device) for x in ins]
        waves.append((arr, idx, kernels.class_static_hoist(arr, idx.long()), dins))
    del probe
    for i, (arr, idx, stat_w, dins) in enumerate(waves):
        want = tpre.preempt_eval_plain(arr, idx, tpre.static_rows_plain(arr, idx), *dins)
        if not same(kernels.preempt_eval(stat_w, arr.pod_req, idx, arr.node_alloc, *dins), want):
            raise RuntimeError(f"k15 wave {i}: preempt_eval != plain")
    res = dict(waves=len(waves))
    for i in (0, len(waves) - 1):
        arr, idx, stat_w, dins = waves[i]
        ref = kernels.preempt_eval(stat_w, arr.pod_req, idx, arr.node_alloc, *dins)
        got = {}

        def call():
            got["k"] = kernels.preempt_eval(stat_w, arr.pod_req, idx, arr.node_alloc, *dins)

        def check(who):
            if not same(got["k"], ref):
                raise RuntimeError(f"k15 wave {i}: the {who} build's outputs differ")

        K, N, V, R = idx.shape[0], arr.N, dins[3].shape[1], arr.R
        what = f"wave {i} of {len(waves)} (K={K}, N={N}, V={V}, R={R})"
        res[f"wave {i}"] = dict(
            K=K, N=N, V=V, R=R,
            ms=in_turns("k15", what + ", back to back",
                        lambda: events_ms(call, reps=50, warmup=3), turns, check, "preempt_eval"),
            card_ms=in_turns("k15", what + ", card time (queued behind a sleep)",
                             lambda: card_ms(call, reps=50), turns, check, "preempt_eval"))
    print(f"[k15] {card} | preempt_eval == plain on all {len(waves)} waves of failure_cycle(build(20000, 1000))",
          flush=True)
    return res


def main(argv=None) -> int:
    import torch

    from ..ops import kernels

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default="", help="a directory holding an earlier csrc/ to time in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stage_b_preempt: no CUDA device", file=sys.stderr)
        return 2
    card = card_name()
    new6, new15 = kernels._fn("chunk_rounds"), kernels._fn("preempt_eval")
    turns6, turns15 = [("new", new6)], [("new", new15)]
    if args.parent:
        csrc = Path(args.parent) / "csrc"
        _, old6 = build_variant("chunk_rounds", csrc / "chunk_rounds.cu", tag="parent")
        _, old15 = build_variant("preempt_eval", csrc / "preempt.cu", tag="parent")
        old6 = parent_k6(old6)
        turns6 = [("old", old6), ("new", new6), ("new", new6), ("old", old6)]
        turns15 = [("old", old15), ("new", new15), ("new", new15), ("old", old15)]
    result = dict(card=card, k6=k6_cells(turns6, card), k15=k15_cell(turns15, card))
    print(json.dumps(result), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
