"""Kernels K2 fit_scan and K11 full_scan, the per-pod scans, on one card:
back-to-back time, card time and host time a call at the shapes the
per-pod route gives them, beside the bounds and the dependency floor.

    python3 -m kubernetes_tpu_torch.bench.perpod_scan [--mesh S [S ...]] [--parent DIR]

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

With --mesh S (one or more shard counts) the shard modes instead, on
make_mesh(S) on the one card: K2 (fit_scan_shard, after K1 per shard with
its base) at the north star and at P = 8 on its nodes, K11
(full_scan_shard, after K7 and K10 per shard) at config 3 and at P = 8 on
its nodes; per shape the same numbers, the cluster width launched at each
cap (LAST_CLUSTER["fit_scan_shard"] / ["full_scan_shard"]), the run cut
(kernels.scan_runs: runs spanning shards), and the same call's one-device
kernel on the unsharded arrays in the turns, with the shard mode's ratio
to it; every turn's outputs are bit-equal to the new build's (K11 with its
final pairwise state), the one device's on its nodes.

With --parent DIR (an earlier kubernetes_tpu_torch holding csrc/, e.g. a
`git archive` of the parent commit under the git-ignored _parent/) the
earlier fit_scan.cu and full_scan.cu are built too and every timing runs
in turns (old, new, new, old): on one device through the current
wrappers with the earlier library swapped in (its C entries take the
current ones' arguments: one-cluster builds), in shard mode through
copies of the cooperative-grid shard modes' C calls (one block a shard,
an exchange buffer).  Ends with one JSON line and the card's name and
power limit as nvidia-smi gives them.  Needs one card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import sys
from pathlib import Path

import numpy as np

from .score_explain import in_turns
from .static_rows import bound_ms
from .wave_phases import build_variant, card_name, read_phases, report

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# the C entries of the cooperative-grid shard modes: one block a shard, an exchange buffer
PARENT_K2_SHARD_ARGTYPES = [_P, _I, _I, _P, _P, _P, _I, _U, _P, _I, _I, _F, _F, _I, _I, _I] + [_P] * 5
PARENT_K11_SHARD_ARGTYPES = [_P] * 7 + [_I] + [_P] * 4
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

@contextlib.contextmanager
def swapped(name: str, fn):
    """kernels' C entry of `name` replaced by `fn` (an earlier build's, or a
    phase-counting one, with the same arguments) for the block's calls."""
    from ..ops import kernels

    normal = kernels._fn(name)
    kernels._FNS[name] = fn
    try:
        yield
    finally:
        kernels._FNS[name] = normal


def as_parent(name: str, fn, call):
    """call() with kernels' C entry of `name` swapped for `fn`."""
    with swapped(name, fn):
        return call()


def parent_fit_scan_shard(fn, sfs, sa, cfg):
    """The cooperative-grid K2 shard mode's C call (per shard its padded sf
    rows, allocatable and usage [R, Np]; its [2, S] exchange)."""
    import torch

    from ..ops import kernels

    S, nl, P = sa.mesh.size, sa.nl, sa.P
    dev = sa.device
    sh0 = sa.shards[0]
    R, Np = sh0.R, -(-nl // 16) * 16
    rows, keep = [], []
    for s, sh in enumerate(sa.shards):
        sf = torch.zeros((P, Np), dtype=torch.bool, device=dev)
        sf[:, :nl] = sfs[s]
        alloc_t = torch.zeros((R, Np), dtype=torch.int32, device=dev)
        alloc_t[:, :nl] = sh.node_alloc.t()
        used_t = torch.empty((R, Np), dtype=torch.int32, device=dev)
        rows.append((sf.data_ptr(), alloc_t.data_ptr(), used_t.data_ptr(), sh.node_used.data_ptr()))
        keep.append((sf, alloc_t, used_t))
    shape = cfg.rtcr_shape
    score_idx = torch.tensor(cfg.score_resources, dtype=torch.int32, device=dev)
    shape_xy = torch.tensor([x for x, _ in shape] + [y for _, y in shape], dtype=torch.float32, device=dev)
    choices = torch.full((P,), -1, dtype=torch.int32, device=dev)
    n_scored = torch.zeros((1,), dtype=torch.int64, device=dev)
    xv = torch.empty((2 * S,), dtype=torch.float32, device=dev)
    xi = torch.empty((2 * S,), dtype=torch.int32, device=dev)
    err = fn(kernels._host(kernels._table(rows)), S, nl, sh0.pod_req.data_ptr(), sh0.pod_valid.data_ptr(),
             score_idx.data_ptr(), len(cfg.score_resources), sum(1 << i for i in set(cfg.score_resources)),
             shape_xy.data_ptr(), len(shape), kernels.STRATEGY_CODES[cfg.fit_strategy], float(cfg.fit_weight),
             float(cfg.balanced_weight), P, Np, R, choices.data_ptr(), n_scored.data_ptr(), xv.data_ptr(),
             xi.data_ptr(), kernels._stream(dev))
    kernels._raise_on(err, "fit_scan_shard (parent)")
    return choices, torch.cat([u[:, :nl].t() for _, _, u in keep])


def parent_full_scan_shard(fn, sa, cfg, sfs, eligs, planes):
    """The cooperative-grid K11 shard mode's C call (its [S, nl] row scratch
    and its exchange, one slot per shard per quantity)."""
    import torch

    from ..ops import kernels

    S, nl, P = sa.mesh.size, sa.nl, sa.P
    dev = sa.device
    outs, (ptrs, dims, sw, wp, ip, fp), table = kernels._shard_args(sa, cfg, sfs, eligs, planes, None)
    n_ent = kernels.MAX_MATCH + 3 * kernels.MAX_SLOTS
    feas = torch.empty((S * nl,), dtype=torch.uint8, device=dev)
    rowf = torch.empty((4, S * nl), dtype=torch.float32, device=dev)
    xf = torch.empty((S * (kernels.MAX_SLOTS + 5 + 1),), dtype=torch.float32, device=dev)
    xi = torch.empty((S * (4 * n_ent + 2),), dtype=torch.int32, device=dev)  # ents first: int4-aligned
    rows = np.array([feas.data_ptr()] + [rowf[k].data_ptr() for k in range(4)], dtype=np.uint64)
    fo, io = xf.data_ptr(), xi.data_ptr()
    ie = io + 4 * S * 4 * n_ent
    xs = np.array([fo, fo + 4 * S * kernels.MAX_SLOTS, fo + 4 * S * (kernels.MAX_SLOTS + 5), ie, io, ie + 4 * S],
                  dtype=np.uint64)
    choices = torch.full((P,), -1, dtype=torch.int32, device=dev)
    h = kernels._host
    err = fn(h(ptrs), h(dims), h(sw), h(wp), h(ip), h(fp), h(table), S, choices.data_ptr(), h(rows), h(xs),
             kernels._stream(dev))
    kernels._raise_on(err, "full_scan_shard (parent)")
    return choices, torch.cat([o.state["used"] for o in outs]), kernels._gathered_state(sa, outs)


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

        old = None if old_fn is None else (lambda a=a, s=s, fo=fo: as_parent(
            "fit_scan", old_fn, lambda: kernels.fit_scan(s, a, cfg, out=fo)))
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
            None if old_fn is None else (lambda a=a, fo=fo: as_parent(
                "fit_scan", old_fn, lambda: kernels.fit_scan(empty, a, cfg, out=fo))), kcs),
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
            as_parent("fit_scan", old_fn, lambda: kernels.fit_scan(sf, arr, cfg, done=done, out=fo))
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
            lambda a=a, s=s, e=e, pl=pl, so=so: as_parent(
                "full_scan", old_fn, lambda: kernels.full_scan(a, cfg, s, e, pl, with_state=True, out=so)))
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
                lambda a=a, e=e, pl=pl, so=so: as_parent(
                    "full_scan", old_fn, lambda: kernels.full_scan(a, cfg, empty, e, pl, out=so))),
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
            as_parent("full_scan", old_fn, lambda: kernels.full_scan(arr, cfg, sfs, eligs, planes, done=done, out=so))
            return state()

        res[flag] = in_turns(f"k11 gated {flag}", f"P={arr.P} N={arr.N}",
                             cell_calls(new, None if old_fn is None else old, [None]),
                             checker("full_scan", f"gated {flag}", want), 50)
    print(f"[k11 gated] {card} | done clear == the ungated call, done set writes nothing, in every turn", flush=True)
    return res


def k11_split(tag: str, read, fn, c3, reps: int = 2) -> dict:
    """K11's pod taken apart at config 3 with a phase-counting build (fn,
    its C entry; read, its counter reader): the instrumented launches' mean
    time and each phase's share of block 0's cycles."""
    import torch

    from ..ops import kernels

    arr, cfg, sfs, eligs, planes = c3
    with swapped("full_scan", fn):
        kernels.full_scan(arr, cfg, sfs, eligs, planes)
        torch.cuda.synchronize()
        read_phases(read, len(K11_PHASES))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            kernels.full_scan(arr, cfg, sfs, eligs, planes)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
    cycles, hits = read_phases(read, len(K11_PHASES))
    print(f"[{tag}] instrumented {ms:.3f} ms a launch over P={arr.P}; block 0's cycles a launch "
          f"{float(cycles.sum()) / reps:.0f}", flush=True)
    rows = report(tag, K11_PHASES, cycles, hits, ms, reps)
    return dict(ms_instrumented=ms, phases=rows, us_per_pod={k: v["ms"] * 1e3 / arr.P for k, v in rows.items()})


# ---------------------------------------------------------------------------
# the shard modes (--mesh S)
# ---------------------------------------------------------------------------

def clone(out) -> list:
    return [{k: v.clone() for k, v in x.items()} if isinstance(x, dict) else x.clone() for x in out]


def cut_nodes(out, n: int) -> list:
    """A per-pod scan's outputs (choices, used, and K11's state dict) with
    the node axis cut to the first n nodes, as a flat list."""
    res = [out[0], out[1][:n]]
    if len(out) > 2:
        st = out[2]
        res += [st[k][:, :n] if k in ("cnt", "anti", "pref") else st[k][:n] if k == "ports" else st[k]
                for k in sorted(st)]
    return res


def kernel_ms(fn, match: str, reps: int) -> float:
    """Mean device milliseconds a call of fn() spends in kernels whose name
    holds `match`, by torch.profiler (the wrapper's own device work -- its
    allocations and copies -- left out); nan where the profiler sees none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if str(getattr(e, "device_type", "")).endswith("CUDA") and match in e.name]
    return sum(us) / reps / 1e3 if us else float("nan")


def mean_ms(turns: dict, who: str) -> float:
    v = turns.get(who, [])
    return sum(r["ms"] for r in v) / len(v) if v else float("nan")


def mesh_turns(tag: str, key: str, S: int, new, old, one, want, n: int, reps: int, kcs) -> dict:
    """The turns of one shard-mode shape: old, new, the one device, new,
    old (new alone without a parent), then new at each further cap; each
    turn's outputs == want (the one device's on its n nodes; want None:
    unchecked) -> dict(turns, the cluster width launched by cap, the ratios
    of new to the one device and to old, and each one's kernel time alone
    by the profiler: `kernel` in ms, the cooperative-grid shard modes'
    kernels named *_shard_kernel)."""
    from ..ops import kernels

    widths = {}

    def new_at(k):
        out = new(k)
        widths[k] = kernels.LAST_CLUSTER[key]
        return out

    calls = [("new", lambda: new_at(kcs[0])), ("one device", one), ("new", lambda: new_at(kcs[0]))]
    if old is not None:
        calls = [("old", old)] + calls + [("old", old)]
    calls += [(f"new kc<={k}", lambda k=k: new_at(k)) for k in kcs[1:]]

    def check(who, got):
        m = n if who == "one device" else len(want[1]) if want is not None else 0
        if want is not None and not same(cut_nodes(got, m), cut_nodes(want, m)):
            raise RuntimeError(f"{tag}: the {who} outputs differ")

    turns = in_turns(tag, f"S={S}", calls, check, reps)
    name = key.replace("_shard", "")
    preps = 3 if reps == 1 else 20
    kern = {"new": kernel_ms(lambda: new(kcs[0]), f"{name}_kernel", preps),
            "one device": kernel_ms(one, f"{name}_kernel", preps)}
    if old is not None:
        kern["old"] = kernel_ms(old, f"{name}_shard_kernel", preps)
    print(f"[{tag}] the kernel alone (torch.profiler, {preps} calls): " +
          ", ".join(f"{who} {ms:.4f} ms" for who, ms in kern.items()), flush=True)
    return dict(turns=turns, kc=widths, ratio_to_one_device=mean_ms(turns, "new") / mean_ms(turns, "one device"),
                new_over_old=mean_ms(turns, "new") / mean_ms(turns, "old") if old is not None else None,
                kernel=kern)


def mesh_report(tag: str, kernel: str, S: int, row: dict, sa, kcs, plain: bool, card: str) -> None:
    from ..ops import kernels

    runs = kernels.scan_runs(kernel, S, sa.nl, row["kc"][kcs[0]])
    row.update(P=sa.P, N=sa.N, nl=sa.nl, runs=len(runs), runs_spanning_shards=sum(len(r) > 1 for r in runs))
    old = "" if row["new_over_old"] is None else f", new / old {row['new_over_old']:.3f}x"
    print(f"[{tag}] {card} | == the one device and the other build in every turn{' and == plain' if plain else ''}; "
          f"cluster width by cap {row['kc']}, {row['runs_spanning_shards']} of {row['runs']} runs span shards; "
          f"new / one device {row['ratio_to_one_device']:.3f}x{old}; floor new "
          f"{mean_ms(row['floor'], 'new'):.4f} ms, one device {mean_ms(row['floor'], 'one device'):.4f} ms; bound "
          f"{row['bound_ms']:.6f} ms ({row['bound_by']})", flush=True)


def mesh_k2(S: int, old_fn, card: str, kcs) -> dict:
    import torch

    from ..api.snapshot import encode_snapshot
    from ..ops import DEFAULT_SCORE_CONFIG, infer_score_config, kernels
    from ..parallel import mesh as tm
    from ..parallel import sharded
    from . import workloads

    arr, _ = encode_snapshot(workloads.heterogeneous(**workloads.NORTH_STAR))
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    m = tm.make_mesh(S)
    res = {}
    for cell, k, reps in (("north-star", arr.P, 1), ("P=8 north-star nodes", 8, 50)):
        a = arr if k == arr.P else arr.pod_prefix(k)
        sa = tm.shard_arrays(a, m)
        sfs = [kernels.static_feasible(sh, base=m.base(j, sa.N)) for j, sh in enumerate(sa.shards)]
        sf1 = kernels.static_feasible(a)
        want = clone(kernels.fit_scan_shard(sfs, sa, cfg))
        if k <= 8 and not same(want, list(sharded.sharded_schedule_scan_plain(sa, cfg, sfs=sfs,
                                                                               planes=[(None, None)] * S))):
            raise RuntimeError(f"fit_scan_shard {cell}: != plain")
        empty, empty1 = [torch.zeros_like(x) for x in sfs], torch.zeros_like(sf1)
        tag = f"k2 mesh{S} {cell}"
        row = mesh_turns(tag, "fit_scan_shard", S, lambda kk: kernels.fit_scan_shard(sfs, sa, cfg, cluster=kk),
                         None if old_fn is None else (lambda: parent_fit_scan_shard(old_fn, sfs, sa, cfg)),
                         lambda: kernels.fit_scan(sf1, a, cfg)[:2], want, a.N, reps, kcs)
        row["floor"] = mesh_turns(
            tag + " floor", "fit_scan_shard", S, lambda kk: kernels.fit_scan_shard(empty, sa, cfg, cluster=kk),
            None if old_fn is None else (lambda: parent_fit_scan_shard(old_fn, empty, sa, cfg)),
            lambda: kernels.fit_scan(empty1, a, cfg)[:2], None, a.N, reps, kcs)["turns"]
        n_scored = int(kernels.fit_scan(sf1, a, cfg)[2].item())
        nbytes, nops = k2_work(a, n_scored, cfg)
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, nops)
        row["n_scored"] = n_scored
        mesh_report(tag, "fit_scan", S, row, sa, kcs, k <= 8, card)
        res[cell] = row
        del empty, sfs
    return res


def mesh_k11(S: int, old_fn, card: str, kcs) -> dict:
    import torch

    from ..api.snapshot import encode_snapshot
    from ..ops import DEFAULT_SCORE_CONFIG, assign, bitplane, infer_score_config, kernels
    from ..parallel import mesh as tm
    from ..parallel import sharded
    from . import workloads

    arr, _ = encode_snapshot(workloads.spread_affinity(**workloads.CONFIG3))
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    m = tm.make_mesh(S)
    res = {}
    for cell, k, reps in (("config-3", arr.P, 1), ("P=8 config-3 nodes", 8, 50)):
        a = arr if k == arr.P else arr.pod_prefix(k)
        sa = tm.shard_arrays(a, m)
        packed = [assign.packed_static_rows(sh, with_elig=True, base=m.base(j, sa.N)) for j, sh in enumerate(sa.shards)]
        sfs, eligs = [x[0] for x in packed], [x[1] for x in packed]
        planes = [assign.score_planes(sh, cfg) for sh in sa.shards]
        s1, e1 = assign.packed_static_rows(a, with_elig=True)
        pl1 = assign.score_planes(a, cfg)
        want = clone(kernels.full_scan_shard(sa, cfg, sfs, eligs, planes, with_state=True))
        if k <= 8:
            pp = sharded.sharded_schedule_scan_plain(sa, cfg, sfs=[bitplane.unpack(x, sa.nl) for x in sfs],
                                                     planes=planes, with_state=True)
            if not same(cut_nodes(want, sa.N), cut_nodes(pp, sa.N)):
                raise RuntimeError(f"full_scan_shard {cell}: != plain")
        empty, empty1 = [torch.zeros_like(x) for x in sfs], torch.zeros_like(s1)
        tag = f"k11 mesh{S} {cell}"
        row = mesh_turns(
            tag, "full_scan_shard", S,
            lambda kk: kernels.full_scan_shard(sa, cfg, sfs, eligs, planes, with_state=True, cluster=kk),
            None if old_fn is None else (lambda: parent_full_scan_shard(old_fn, sa, cfg, sfs, eligs, planes)),
            lambda: kernels.full_scan(a, cfg, s1, e1, pl1, with_state=True), want, a.N, reps, kcs)
        row["floor"] = mesh_turns(
            tag + " floor", "full_scan_shard", S,
            lambda kk: kernels.full_scan_shard(sa, cfg, empty, eligs, planes, cluster=kk),
            None if old_fn is None else (lambda: parent_full_scan_shard(old_fn, sa, cfg, empty, eligs, planes)),
            lambda: kernels.full_scan(a, cfg, empty1, e1, pl1), None, a.N, reps, kcs)["turns"]
        nbytes, nops = k11_work(a, cfg, s1, e1, want[0])
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, nops)
        mesh_report(tag, "full_scan", S, row, sa, kcs, k <= 8, card)
        res[cell] = row
        del empty, sfs, eligs
    return res


def main(argv=None) -> int:
    import torch

    from ..ops import kernels

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default="", help="an earlier kubernetes_tpu_torch (its csrc/) to time in turns")
    ap.add_argument("--mesh", type=int, nargs="*", default=[],
                    help="shard counts: the shard modes on make_mesh(S) (on the one card) instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("perpod_scan: no CUDA device", file=sys.stderr)
        return 2
    card = card_name()
    kcs = [None, 16, 8]  # None: the kernel's default cap
    old2 = old11 = None
    parent_src = Path(args.parent) / "csrc" if args.parent else None
    shard = bool(args.mesh)
    if parent_src is not None:
        _, old2 = build_variant("fit_scan_shard" if shard else "fit_scan", parent_src / "fit_scan.cu", tag="parent")
        _, old11 = build_variant("full_scan_shard" if shard else "full_scan", parent_src / "full_scan.cu",
                                 tag="parent")
        if shard:
            old2.argtypes, old11.argtypes = PARENT_K2_SHARD_ARGTYPES, PARENT_K11_SHARD_ARGTYPES
    kernels.build(["static_feasible", "packed_static_rows", "score_planes", "fit_scan", "full_scan"])
    if shard:
        result = dict(card=card, mesh={})
        for S in args.mesh:
            result["mesh"][S] = dict(k2=mesh_k2(S, old2, card, kcs))
            torch.cuda.empty_cache()
            result["mesh"][S]["k11"] = mesh_k11(S, old11, card, kcs)
            torch.cuda.empty_cache()
    else:
        result = dict(card=card, k2=k2_cells(old2, card, kcs))
        torch.cuda.empty_cache()
        result["k11"], c3 = k11_cells(old11, card, kcs)
        read, fn = build_variant("full_scan", kernels.CSRC / "full_scan.cu", "KTT_FULL_PHASES",
                                 "ktt_full_scan_phases", "phases")
        split = {"new": k11_split("k11 phases", read, fn, c3)}
        if parent_src is not None and "ktt_full_scan_phases" in (parent_src / "full_scan.cu").read_text():
            read, fn = build_variant("full_scan", parent_src / "full_scan.cu", "KTT_FULL_PHASES",
                                     "ktt_full_scan_phases", "parent-phases")
            split["old"] = k11_split("k11 phases (parent)", read, fn, c3)
        result["k11_phases"] = split
    print(json.dumps(result, default=lambda x: float(x) if isinstance(x, np.floating) else str(x)), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
