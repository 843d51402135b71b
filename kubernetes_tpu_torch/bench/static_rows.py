"""Kernel K7 packed_static_rows on one card, at the shapes the main path
gives it, and its gated call's card time.

    python3 -m kubernetes_tpu_torch.bench.static_rows [--parent DIR]

Encodes three cells with DeltaEncoder.encode_device, as chip_smoke.py does:
the north star's dense step (heterogeneous(20000, 50000, seed=0): the
static plane alone, [51200, 640] words), BASELINE config 3 (spread_affinity(
5000, 10000, seed=0): the static and the eligibility planes) and config 5
(gang(1000, 64, 2000, seed=0): the static plane, once per gang-fixpoint
iteration).  Per cell it times K7 by CUDA events (back to back, after a
warm-up) and checks the planes equal the plain version's
(ops/assign.py packed_static_rows_plain) word for word; at config 5 it also
times a gated call (`done` set: the gang fixpoint's iterations past its
end) by its card time, queued behind a sleeping kernel that outlasts the
enqueue, and checks that it writes nothing.  With --parent DIR (a
directory holding an earlier csrc/) the earlier class_hoist.cu is built
too and every timing runs in turns (old, new, new, old), each call's planes
bit-equal to the current build's.  Ends with one JSON line and the card's
name and power limit as nvidia-smi gives them.  Needs one card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from .wave_phases import build_variant, card_name

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_OPS_PER_S = 67e12  # 32-bit operations outside the tensor cores, H100 SXM data sheet


def k7_work(arr, with_elig: bool) -> tuple:
    """(bytes, operations) the function must move and do on these inputs:
    every input read once, each plane's [P, W] words written once; per
    output word the pod-row tests (valid, pin), one OR per selector term
    and one AND-NOT per toleration word, and per (node, label) literal of
    the term match."""
    P, N = arr.P, arr.N
    W = -(-N // 32)
    T, TT = arr.node_taint_ns.shape[1], arr.pod_terms.shape[1]
    S, E, L = arr.sel_mask.shape
    TW = max(1, -(-T // 32))
    planes = 2 if with_elig else 1
    nbytes = N * (1 + T + L) + P * (1 + T + 4 + 4 * TT + 1) + S * E * L + 4 * S * E + 4 * planes * P * W
    ops = P * W * (4 + TT + TW) * planes + S * N * E * L
    return nbytes, ops


def bound_ms(nbytes: int, ops: int) -> tuple:
    """The least time for that work on an H100: (ms, "bytes" or "operations")."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def events_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of fn() over `reps` back-to-back runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_ms(fn, reps: int) -> float:
    """Mean card milliseconds of fn() where the host would set the pace of
    back-to-back calls (a gated launch returns at once): the calls are
    queued behind a sleeping kernel that outlasts their enqueue, and CUDA
    events time them on the card alone (chip_smoke.py's method)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    torch.cuda.synchronize()
    cycles_per_ms = 10_000_000 / start.elapsed_time(end)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda._sleep(int(cycles_per_ms * (2 * host_ms + 20)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def first_design_scratch(fn):
    """K7's C entry of the first design (one thread per (row, node)) with
    the scratch it takes -- the term match [S, N] bytes, the node and row
    taint words [N, TW] and [P, TW] -- in place of the current wrapper's."""
    import torch

    held = {}

    def entry(*a):
        P, N, T, S, dev = a[16], a[17], a[18], a[20], torch.device("cuda", torch.cuda.current_device())
        TW = max(1, -(-T // 32))
        key = (P, N, TW, S)
        if key not in held:
            held.clear()
            held[key] = (torch.empty((S * N,), dtype=torch.uint8, device=dev),
                         torch.empty((N * TW,), dtype=torch.int32, device=dev),
                         torch.empty((P * TW,), dtype=torch.int32, device=dev))
        tm, taint_w, tol_w = held[key]
        return fn(*a[:10], tm.data_ptr(), taint_w.data_ptr(), tol_w.data_ptr(), *a[13:])

    return entry


def in_turns(tag: str, what: str, timer, entries, check, kernel: str = "packed_static_rows") -> dict:
    """`timer()` with each entry of `entries` ((who, C entry) in turn order)
    installed as `kernel`'s C entry; `check(who)` after each turn.  -> {who:
    [ms, ...]}."""
    from ..ops import kernels

    normal = kernels._fn(kernel)
    out = {}
    try:
        for who, fn in entries:
            kernels._FNS[kernel] = fn
            ms = timer()
            check(who)
            out.setdefault(who, []).append(ms)
    finally:
        kernels._FNS[kernel] = normal
    print(f"[{tag}] {what}: " + "; ".join(f"{who} " + " / ".join(f"{x:.4f}" for x in v) + " ms"
                                         for who, v in out.items()), flush=True)
    return out


def main(argv=None) -> int:
    import torch

    from ..api.delta import DeltaEncoder
    from ..ops import assign, kernels
    from . import workloads

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default="", help="a directory holding an earlier csrc/ to time in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("static_rows: no CUDA device", file=sys.stderr)
        return 2
    card = card_name()
    new = kernels._fn("packed_static_rows")
    turns = [("new", new)]
    if args.parent:
        psrc = Path(args.parent) / "csrc" / "class_hoist.cu"
        if not psrc.exists():
            psrc = Path(args.parent) / "class_hoist.cu"
        _, old = build_variant("packed_static_rows", psrc, tag="parent")
        old = first_design_scratch(old)
        turns = [("old", old), ("new", new), ("new", new), ("old", old)]
    cells = {"north-star": (lambda: workloads.heterogeneous(**workloads.NORTH_STAR), False),
             "config3": (lambda: workloads.spread_affinity(**workloads.CONFIG3), True),
             "config5": (lambda: workloads.gang(**workloads.CONFIG5), False)}
    result = dict(card=card, cells={})
    for cell, (make, elig) in cells.items():
        arr, meta = DeltaEncoder().encode_device(make())
        tag = f"static-rows {cell}"
        ref = kernels.packed_static_rows(arr, with_elig=elig)
        ref = ref if elig else (ref,)
        plain = assign.packed_static_rows_plain(arr, with_elig=elig)
        plain = plain if elig else (plain,)
        bad = sum(int((a != b).sum()) for a, b in zip(ref, plain))
        if bad:
            raise RuntimeError(f"{tag}: K7 != plain in {bad} words")
        ref = [x.clone() for x in ref]
        got = {}

        def call():
            got["k"] = kernels.packed_static_rows(arr, with_elig=elig)

        def same(who):
            k = got["k"] if elig else (got["k"],)
            if not all(torch.equal(a, b) for a, b in zip(k, ref)):
                raise RuntimeError(f"{tag}: the {who} build's planes differ")

        nbytes, ops = k7_work(arr, elig)
        b_ms, b_by = bound_ms(nbytes, ops)
        W = -(-arr.N // 32)
        print(f"[{tag}] {card} | P={arr.P} N={arr.N} W={W} T={arr.node_taint_ns.shape[1]} "
              f"TT={arr.pod_terms.shape[1]} S/E/L={tuple(arr.sel_mask.shape)}, eligibility plane {elig}: == plain; "
              f"bound {b_ms:.4f} ms ({b_by}: {nbytes} B, {ops} ops)", flush=True)
        res = dict(P=arr.P, N=arr.N, W=W, elig=elig, bound_ms=b_ms, bound_by=b_by,
                   ms=in_turns(tag, "back to back", lambda: events_ms(call, reps=20, warmup=2), turns, same))
        if cell == "config5":
            done = torch.ones((1,), dtype=torch.int32, device=arr.device)
            sfs = torch.zeros_like(ref[0])

            def gated():
                kernels.packed_static_rows(arr, done=done, out=sfs)

            def untouched(who):
                if bool(sfs.any()):
                    raise RuntimeError(f"{tag}: the {who} build's gated call wrote its plane")

            res["gated_card_ms"] = in_turns(tag, "a gated call (done set), card time", lambda: card_ms(gated, 200),
                                            turns, untouched)
        result["cells"][cell] = res
        del arr, meta, ref, plain
        got.clear()
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
