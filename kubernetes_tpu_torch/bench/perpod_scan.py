"""Kernels K2 fit_scan and K11 full_scan, the per-pod scans, on one card:
back-to-back time, card time and host time a call at the shapes the
per-pod route gives them, beside the bounds and the dependency floor.

    python3 -m kubernetes_tpu_torch.bench.perpod_scan [--parent DIR]

K2 at the north star (heterogeneous(20000, 50000, seed=0) through
encode_snapshot: P = 51200, N = 20480, R = 5, after K1's static
feasibility) and at P = 8 on the north star's nodes (its first 8 pods);
K11 at config 3 (spread_affinity(5000, 10000, seed=0): P = 10240, N = 6144,
after K7's packed planes) and at P = 8 on config 3's nodes; both gated
modes at P = 8 with `done` clear (== the ungated call) and set (nothing
written).  Per shape: the dependency floor, the same launch with no node
feasible (every static bit clear), in us a pod; the bound (bytes at 3.35
TB/s, f32 operations at 67 TFLOP/s); each call's outputs bit-equal to the
other build's (K2: choices, usage, n_scored; K11: choices, usage and the
count planes, total_t, ports as bits) and, at P = 8, to the plain
version's.  The cluster width launched (kernels.LAST_CLUSTER) is reported,
and the new build is timed again at cluster caps of 16 and 8 beside its
default (kernels.SCAN_CLUSTER).  K11's pod is taken apart at config 3 (a
build with -DKTT_FULL_PHASES: block 0's cycles between the pod loop's
phase boundaries), for the current source and, where its source has the
counters, the parent's.

With --parent DIR (an earlier kubernetes_tpu_torch holding csrc/, e.g. a
`git archive` of the parent commit under the git-ignored _parent/) the
earlier fit_scan.cu and full_scan.cu are built too and called through
copies of their earlier wrappers' C calls, and every timing runs in turns
(old, new, new, old).  Ends with one JSON line and the card's name and
power limit as nvidia-smi gives them.  Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np

from .score_explain import in_turns
from .static_rows import bound_ms
from .wave_phases import build_variant, card_name, read_phases, report

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# the C entries of the one-block designs: no cluster cap, K11 a global row scratch
PARENT_K2_ARGTYPES = [_P] * 6 + [_I, _U, _P, _I, _I, _F, _F, _I, _I, _I, _P, _P, _P, _I, _P, _P]
PARENT_K11_ARGTYPES = [_P] * 9
# K11's pod, csrc/full_scan.cu's PH_* order
K11_PHASES = [
    ("pod", "the pod's slots loaded, the loop's top barrier"),
    ("spread", "the waiver and the spread minMatch over the nodes"),
    ("feas", "feasibility, raws and the five maxima"),
    ("total", "the masked totals and the argmax"),
    ("commit", "usage, ports, commit entries, total_t"),
    ("apply", "the entries applied to the count planes"),
    ("cluster", "waits at the cluster barriers"),
]


def f32_ops_a_pair(cfg) -> int:
    """chip_smoke.py's f32_ops_per_scored_node: one (pod, node) pair that
    passes fit, scored."""
    k = len(cfg.score_resources)
    per_res = {"LeastAllocated": 4, "MostAllocated": 3,
               "RequestedToCapacityRatio": 3 + 6 * (len(cfg.rtcr_shape) - 1)}[cfg.fit_strategy]
    return k * per_res + (k - 1) + 1 + (2 * k + (k - 1) + 1 + 2 * k + (k - 1) + 1 + 3) + 3


def k2_work(arr, n_scored: int, cfg) -> tuple:
    """(bytes, operations): the sf rows and the pod and node arrays read
    once, the choices and the usage written once; the scored pairs."""
    P, N, R = arr.P, arr.N, arr.R
    return P * N + 4 * P * R + P + 3 * 4 * N * R + 4 * P, n_scored * f32_ops_a_pair(cfg)


def k11_work(arr, cfg, sfs, eligs, choices) -> tuple:
    """(bytes, operations) as chip_smoke.py counts them for K11 (its
    full_bytes and full_ops, this run's data)."""
    import chip_smoke

    ops, _ = chip_smoke.full_ops(arr, cfg, sfs, eligs, choices)
    return chip_smoke.full_bytes(arr), ops


# ---------------------------------------------------------------------------
# the earlier builds' C calls
# ---------------------------------------------------------------------------

def parent_fit_scan(fn, sf, arr, cfg, done=None, out=None):
    """The one-block K2's C call, with the current wrapper's buffers."""
    import torch

    from ..ops import kernels

    dev = arr.device
    P, N, R = arr.P, arr.N, arr.R
    Np = kernels._fit_checks(arr, cfg)
    out = kernels.fit_scan_out(arr, cfg) if out is None else out
    if Np != N:
        padded = torch.zeros((P, Np), dtype=torch.bool, device=dev)
        padded[:, :N] = sf
        sf = padded
    err = fn(sf.data_ptr(), arr.pod_req.data_ptr(), arr.pod_valid.data_ptr(), out.alloc_t.data_ptr(),
             out.used_t.data_ptr(), out.score_idx.data_ptr(), len(cfg.score_resources),
             sum(1 << i for i in set(cfg.score_resources)), out.shape_xy.data_ptr(), len(cfg.rtcr_shape),
             kernels.STRATEGY_CODES[cfg.fit_strategy], float(cfg.fit_weight), float(cfg.balanced_weight), P, Np, R,
             out.choices.data_ptr(), out.n_scored.data_ptr(), arr.node_used.data_ptr(), N, kernels._ptr(done),
             kernels._stream(dev))
    kernels._raise_on(err, "fit_scan (parent)")
    return out.choices, out.used_t[:, :N].t(), out.n_scored


def parent_full_scan(fn, arr, cfg, sfs, eligs, planes, done=None, out=None):
    """The one-block K11's C call (its [4 N f32 + N] global row scratch)."""
    import torch

    from ..ops import kernels

    dev = arr.device
    out = kernels.scan_out(arr) if out is None else out
    ptrs, dims, sw, wp, ip, fp = kernels._full_args(arr, cfg, sfs, eligs, planes, out, done=done)
    scratch = torch.empty((4 * 4 * arr.N + arr.N,), dtype=torch.uint8, device=dev)
    h = kernels._host
    err = fn(h(ptrs), h(dims), h(sw), h(wp), h(ip), h(fp), out.choices.data_ptr(), scratch.data_ptr(),
             kernels._stream(dev))
    kernels._raise_on(err, "full_scan (parent)")
    st = dict(out.state)
    used = st.pop("used")
    return out.choices, used, st


def _bits(x):
    import torch

    return x.view(torch.int32) if x.dtype == torch.float32 else x


def flat(out) -> list:
    """A scan's outputs as a list of tensors (K11's state dict in key order)."""
    res = []
    for x in out:
        res += [x[k] for k in sorted(x)] if isinstance(x, dict) else [x]
    return res


def same(a, b) -> bool:
    import torch

    return len(a) == len(b) and all(torch.equal(_bits(x.contiguous()), _bits(y.contiguous())) for x, y in zip(a, b))


def checker(kernel: str, cell: str, want):
    def check(who, got):
        if not same(flat(got), want):
            raise RuntimeError(f"{kernel} {cell}: the {who} build's outputs differ")
    return check


def cell_calls(new, old, kcs):
    """The turns: old, new, new, old (new alone without a parent) at the
    default cluster cap (kcs[0], None); then the new build at each further
    cap."""
    calls = [("new", lambda: new(kcs[0]))]
    if old is not None:
        calls = [("old", old), calls[0], calls[0], ("old", old)]
    return calls + [(f"new kc<={k}", lambda k=k: new(k)) for k in kcs[1:]]


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------

def k2_cells(old_fn, card: str, kcs) -> dict:
    import torch

    from ..api.snapshot import encode_snapshot
    from ..ops import DEFAULT_SCORE_CONFIG, infer_score_config, kernels
    from ..ops.assign import schedule_scan_plain
    from . import workloads

    arr, _ = encode_snapshot(workloads.heterogeneous(**workloads.NORTH_STAR))
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    sf = kernels.static_feasible(arr)
    small, sf8 = arr.pod_prefix(8), sf[:8].contiguous()
    res = {}
    for cell, a, s, reps in (("north-star", arr, sf, 2), ("P=8 north-star nodes", small, sf8, 50)):
        widths = {}
        fo = kernels.fit_scan_out(a, cfg)  # one set of buffers: the launches alone are timed

        def new(k, a=a, s=s, fo=fo):
            out = kernels.fit_scan(s, a, cfg, out=fo, cluster=k)
            widths[k] = kernels.LAST_CLUSTER["fit_scan"]
            return out

        old = None if old_fn is None else (lambda a=a, s=s, fo=fo: parent_fit_scan(old_fn, s, a, cfg, out=fo))
        want = [x.clone() for x in flat(new(kcs[0]))]
        if a.P <= 8:
            cp, up = schedule_scan_plain(a, cfg, sf=s)
            if not same(want[:2], [cp, up]):
                raise RuntimeError(f"fit_scan {cell}: != plain")
        turns = in_turns(f"k2 {cell}", f"P={a.P} N={a.N}", cell_calls(new, old, kcs), checker("fit_scan", cell, want),
                         reps)
        n_scored = int(want[2].item())
        empty = torch.zeros_like(s)
        floor = in_turns(f"k2 {cell} floor", "no node feasible", cell_calls(
            lambda k, a=a, fo=fo: kernels.fit_scan(empty, a, cfg, out=fo, cluster=k),
            None if old_fn is None else (lambda a=a, fo=fo: parent_fit_scan(old_fn, empty, a, cfg, out=fo)), kcs),
            lambda who, got: None, reps)
        nbytes, nops = k2_work(a, n_scored, cfg)
        b_ms, b_by = bound_ms(nbytes, nops)
        res[cell] = dict(P=a.P, N=a.N, kc=widths, turns=turns, floor=floor, n_scored=n_scored, bound_ms=b_ms,
                         bound_by=b_by, bytes=nbytes, ops=nops)
        print(f"[k2 {cell}] {card} | == in every turn{' and == plain' if a.P <= 8 else ''}; cluster width by cap "
              f"{widths}; bound {b_ms:.6f} ms ({b_by}: {nbytes} B, {n_scored} scored pairs)", flush=True)
        del empty
    res["gated"] = gated_k2(old_fn, small, sf8, cfg, card)
    return res


def gated_k2(old_fn, arr, sf, cfg, card: str) -> dict:
    import torch

    from ..ops import kernels

    zero = torch.zeros((1,), dtype=torch.int32, device=arr.device)
    one = torch.ones((1,), dtype=torch.int32, device=arr.device)
    res = {}
    for flag, done in (("done clear", zero), ("done set", one)):
        fo = kernels.fit_scan_out(arr, cfg)
        kernels.fit_scan(sf, arr, cfg, done=zero, out=fo)  # the buffers a gated launch must keep
        torch.cuda.synchronize()
        kept = [x.clone() for x in (fo.choices, fo.used_t, fo.n_scored)]
        want = kept if flag == "done set" else flat(kernels.fit_scan(sf, arr, cfg))

        def new(k=None):
            kernels.fit_scan(sf, arr, cfg, done=done, out=fo, cluster=k)
            return [fo.choices, fo.used_t[:, :arr.N].t() if flag == "done clear" else fo.used_t, fo.n_scored]

        def old():
            parent_fit_scan(old_fn, sf, arr, cfg, done=done, out=fo)
            return [fo.choices, fo.used_t[:, :arr.N].t() if flag == "done clear" else fo.used_t, fo.n_scored]

        res[flag] = in_turns(f"k2 gated {flag}", f"P={arr.P} N={arr.N}",
                             cell_calls(new, None if old_fn is None else old, [None]),
                             checker("fit_scan", f"gated {flag}", want), 50)
    print(f"[k2 gated] {card} | done clear == the ungated call, done set writes nothing, in every turn", flush=True)
    return res


def k11_cells(old_fn, card: str, kcs) -> dict:
    import torch

    from ..api.snapshot import encode_snapshot
    from ..ops import DEFAULT_SCORE_CONFIG, assign, bitplane, infer_score_config, kernels
    from . import workloads

    arr, _ = encode_snapshot(workloads.spread_affinity(**workloads.CONFIG3))
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    sfs, eligs = kernels.packed_static_rows(arr, with_elig=True)
    planes = assign.score_planes(arr, cfg)
    small = arr.pod_prefix(8)
    sfs8, eligs8 = sfs[:8].contiguous(), eligs[:8].contiguous()
    planes8 = tuple(None if x is None else x[:8].contiguous() for x in planes)
    res = {}
    for cell, a, s, e, pl, reps in (("config-3", arr, sfs, eligs, planes, 2),
                                    ("P=8 config-3 nodes", small, sfs8, eligs8, planes8, 50)):
        widths = {}
        so = kernels.scan_out(a)  # one set of buffers: the launches alone are timed

        def new(k, a=a, s=s, e=e, pl=pl, so=so):
            out = kernels.full_scan(a, cfg, s, e, pl, with_state=True, out=so, cluster=k)
            widths[k] = kernels.LAST_CLUSTER["full_scan"]
            return out

        old = None if old_fn is None else (
            lambda a=a, s=s, e=e, pl=pl, so=so: parent_full_scan(old_fn, a, cfg, s, e, pl, out=so))
        first = new(kcs[0])
        want = [x.clone() for x in flat(first)]
        if a.P <= 8:
            pp = assign.schedule_scan_plain(a, cfg, sf=bitplane.unpack(s, a.N), planes=pl, with_state=True)
            if not same(want, flat(pp)):
                raise RuntimeError(f"full_scan {cell}: != plain")
        turns = in_turns(f"k11 {cell}", f"P={a.P} N={a.N}", cell_calls(new, old, kcs),
                         checker("full_scan", cell, want), reps)
        empty = torch.zeros_like(s)
        floor = in_turns(f"k11 {cell} floor", "no node feasible", cell_calls(
            lambda k, a=a, e=e, pl=pl, so=so: kernels.full_scan(a, cfg, empty, e, pl, out=so, cluster=k),
            None if old_fn is None else (
                lambda a=a, e=e, pl=pl, so=so: parent_full_scan(old_fn, a, cfg, empty, e, pl, out=so)),
            kcs), lambda who, got: None, reps)
        nbytes, nops = k11_work(a, cfg, s, e, first[0])
        b_ms, b_by = bound_ms(nbytes, nops)
        res[cell] = dict(P=a.P, N=a.N, kc=widths, turns=turns, floor=floor, bound_ms=b_ms, bound_by=b_by,
                         bytes=nbytes, ops=nops)
        print(f"[k11 {cell}] {card} | == in every turn{' and == plain' if a.P <= 8 else ''}; cluster width by cap "
              f"{widths}; bound {b_ms:.6f} ms ({b_by}: {nbytes} B, {nops} f32 ops)", flush=True)
        del empty
    res["gated"] = gated_k11(old_fn, small, sfs8, eligs8, planes8, cfg, card)
    return res, (arr, cfg, sfs, eligs, planes)


def gated_k11(old_fn, arr, sfs, eligs, planes, cfg, card: str) -> dict:
    import torch

    from ..ops import kernels

    zero = torch.zeros((1,), dtype=torch.int32, device=arr.device)
    one = torch.ones((1,), dtype=torch.int32, device=arr.device)
    res = {}
    for flag, done in (("done clear", zero), ("done set", one)):
        so = kernels.scan_out(arr)
        kernels.full_scan(arr, cfg, sfs, eligs, planes, done=zero, out=so)
        torch.cuda.synchronize()
        kept = [so.choices.clone()] + [so.state[k].clone() for k in sorted(so.state)]
        if flag == "done set":
            want = kept
        else:
            c, u, st = kernels.full_scan(arr, cfg, sfs, eligs, planes, with_state=True)
            want = [c.clone()] + [x.clone() for x in flat([{**st, "used": u}])]

        def state():
            return [so.choices] + [so.state[k] for k in sorted(so.state)]

        def new(k=None):
            kernels.full_scan(arr, cfg, sfs, eligs, planes, done=done, out=so, cluster=k)
            return state()

        def old():
            parent_full_scan(old_fn, arr, cfg, sfs, eligs, planes, done=done, out=so)
            return state()

        res[flag] = in_turns(f"k11 gated {flag}", f"P={arr.P} N={arr.N}",
                             cell_calls(new, None if old_fn is None else old, [None]),
                             checker("full_scan", f"gated {flag}", want), 50)
    print(f"[k11 gated] {card} | done clear == the ungated call, done set writes nothing, in every turn", flush=True)
    return res


def k11_split(tag: str, read, fn, parent: bool, c3, reps: int = 2) -> dict:
    """K11's pod taken apart at config 3 with a phase-counting build (fn,
    its C entry; read, its counter reader): the instrumented launches' mean
    time and each phase's share of block 0's cycles."""
    import torch

    from ..ops import kernels

    arr, cfg, sfs, eligs, planes = c3
    if parent:
        def run():
            return parent_full_scan(fn, arr, cfg, sfs, eligs, planes)
    else:
        def run():
            return kernels.full_scan(arr, cfg, sfs, eligs, planes)
    normal = kernels._fn("full_scan")
    if not parent:
        kernels._FNS["full_scan"] = fn
    try:
        run()
        torch.cuda.synchronize()
        read_phases(read, len(K11_PHASES))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            run()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
    finally:
        kernels._FNS["full_scan"] = normal
    cycles, hits = read_phases(read, len(K11_PHASES))
    print(f"[{tag}] instrumented {ms:.3f} ms a launch over P={arr.P}; block 0's cycles a launch "
          f"{float(cycles.sum()) / reps:.0f}", flush=True)
    rows = report(tag, K11_PHASES, cycles, hits, ms, reps)
    return dict(ms_instrumented=ms, phases=rows, us_per_pod={k: v["ms"] * 1e3 / arr.P for k, v in rows.items()})


def main(argv=None) -> int:
    import torch

    from ..ops import kernels

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default="", help="an earlier kubernetes_tpu_torch (its csrc/) to time in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("perpod_scan: no CUDA device", file=sys.stderr)
        return 2
    card = card_name()
    kcs = [None, 16, 8]  # None: the kernel's default cap
    old2 = old11 = None
    parent_src = Path(args.parent) / "csrc" if args.parent else None
    if parent_src is not None:
        _, old2 = build_variant("fit_scan", parent_src / "fit_scan.cu", tag="parent")
        _, old11 = build_variant("full_scan", parent_src / "full_scan.cu", tag="parent")
        old2.argtypes, old11.argtypes = PARENT_K2_ARGTYPES, PARENT_K11_ARGTYPES
    kernels.build(["static_feasible", "packed_static_rows", "score_planes", "fit_scan", "full_scan"])
    result = dict(card=card, k2=k2_cells(old2, card, kcs))
    torch.cuda.empty_cache()
    result["k11"], c3 = k11_cells(old11, card, kcs)
    read, fn = build_variant("full_scan", kernels.CSRC / "full_scan.cu", "KTT_FULL_PHASES", "ktt_full_scan_phases",
                             "phases")
    split = {"new": k11_split("k11 phases", read, fn, False, c3)}
    if parent_src is not None and "ktt_full_scan_phases" in (parent_src / "full_scan.cu").read_text():
        read, fn = build_variant("full_scan", parent_src / "full_scan.cu", "KTT_FULL_PHASES", "ktt_full_scan_phases",
                                 "parent-phases")
        fn.argtypes = PARENT_K11_ARGTYPES
        split["old"] = k11_split("k11 phases (parent)", read, fn, True, c3)
    result["k11_phases"] = split
    print(json.dumps(result, default=lambda x: float(x) if isinstance(x, np.floating) else str(x)), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
