"""Kernels K14 explain_counts and K10 score_planes on one card, at the
shapes the main path gives them: back-to-back time, card time and host
time a call, beside the library calls and the bounds.

    python3 -m kubernetes_tpu_torch.bench.score_explain [--parent DIR]

K14 on the north star's diagnosis: heterogeneous(20000, 50000, seed=0)
encoded by DeltaEncoder, the dense step, then every class's representative
at the post-step usage (F = 128 padded, N = 20480, R = 5), as
chip_smoke.py's [explain-north-star] calls it; and at F = 4 (one valid
row) on the preemption cluster, failure_cycle(build(20000, 1000))'s
arrays.  K10 on all_stages() ([512, 256], the pod rows), on its class view
([240, 256]) and on random arrays at config 3's padded size (P = 10240, N
= 6144; T = 5, PW = 3, S = 11: random_score_arrays), where the 252 MB of
output make it bandwidth-bound.

Per kernel and shape: back-to-back ms (CUDA events over calls in a row),
card ms (calls queued behind a sleeping kernel that outlasts their
enqueue, timed by CUDA events: static_rows.card_ms), host us a call
(perf_counter over that enqueue, so no call waits on the card), every
call's outputs bit-equal to the plain version's; the library calls' card
ms (K14: the taint count's torch.matmul alone; K10: the node-affinity
product's torch.matmul alone, and the whole function in the fewest torch
calls, both f32 products each cast to bf16), with their operands made
before the timing; the bound (k14_work, k10_work: bytes at 3.35 TB/s,
operations at 67 TFLOP/s); the device operations one call runs, by
torch.profiler; and the wrapper's host time taken apart (checks,
allocations, the device context, the stream lookup, the pointers, the
ctypes call with the launch).

With --parent DIR (a directory holding an earlier csrc/, e.g. a `git
archive` of the parent commit under the git-ignored _parent/) the earlier
explain.cu and score_planes.cu are built too, called through a copy of
their earlier wrappers (scratch allocated per call), and every timing runs
in turns (old, new, new, old), each call's outputs bit-equal to the
current build's.  Ends with one JSON line and the card's name and power
limit as nvidia-smi gives them.  Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time
from pathlib import Path

from .static_rows import bound_ms, events_ms
from .wave_phases import build_variant, card_name

_P, _I = ctypes.c_void_p, ctypes.c_int
# the C entries before this design: the scratch pointers (tm, taint_w, tol_w)
PARENT_ARGTYPES = {"score_planes": [_P] * 12 + [_I] * 7 + [_P], "explain_counts": [_P] * 19 + [_I] * 9 + [_P]}


def random_score_arrays(seed: int, P: int, N: int, T: int, PW: int, S: int = 11, E: int = 3, L: int = 40,
                        device="cuda"):
    """ClusterArrays with random score-plane inputs (integer weights, -1
    padded and repeated slots, terms of every kind), made with numpy from a
    seed; tests/test_torch_pairwise.py draws its K10 cases so."""
    import numpy as np

    from ..api.snapshot import ClusterArrays

    rng = np.random.default_rng(seed)
    terms = rng.integers(-1, S, (P, PW)).astype(np.int32)
    return ClusterArrays.from_numpy(dict(
        node_valid=rng.random(N) < 0.95, node_alloc=rng.integers(1, 5000, (N, 4)).astype(np.int32),
        node_used=np.zeros((N, 4), np.int32), node_unsched=np.zeros(N, bool), node_labels=rng.random((N, L)) < 0.2,
        node_taint_ns=rng.random((N, T)) < 0.02, node_taint_pref=rng.random((N, T)) < 0.1,
        pod_valid=rng.random(P) < 0.97, pod_req=rng.integers(0, 300, (P, 4)).astype(np.int32),
        pod_prio=np.zeros(P, np.int32), pod_tol_ns=rng.random((P, T)) < 0.5, pod_tol_pref=rng.random((P, T)) < 0.5,
        pod_nodename=np.full(P, -1, np.int32), pod_terms=rng.integers(-1, S, (P, 2)).astype(np.int32),
        pod_has_sel=rng.random(P) < 0.5, sel_mask=rng.random((S, E, L)) < 0.1,
        sel_kind=rng.integers(0, 4, (S, E)).astype(np.int32), pod_pref_terms=terms,
        pod_pref_weights=rng.integers(1, 101, (P, PW)).astype(np.float32),
    ), device)


def k14_work(arr, F: int) -> tuple:
    """(bytes, operations) K14's function needs: every input read once (the
    node planes, the term tables, F pod rows), the counts written once;
    per (rep, node) the taint, term, pin and fit tests."""
    N, R = arr.N, arr.R
    T, TT = arr.node_taint_ns.shape[1], arr.pod_terms.shape[1]
    S, E, L = arr.sel_mask.shape
    nbytes = (N * (2 + L + T + 8 * R) + S * E * L + 4 * S * E
              + F * (4 * R + T + 4 + 4 * TT + 1 + 8 + 1) + 4 * F * (4 + R + 1))
    return nbytes, F * N * (T + TT + 2 * R + 4)


def k10_work(arr) -> tuple:
    """(bytes, operations) K10's function needs: the inputs read once, the
    two [P, N] planes written once (bf16, or f32 under
    KTPU_SCORE_DTYPE=f32); per (pod, node) a test per taint and per
    preference slot."""
    from ..ops import bitplane

    P, N = arr.P, arr.N
    sb = 2 if bitplane.SCORE_DTYPE == "bf16" else 4
    T, PW = arr.node_taint_pref.shape[1], arr.pod_pref_terms.shape[1]
    S, E, L = arr.sel_mask.shape
    nbytes = N * T + P * T + P * PW * 8 + S * E * L + 4 * S * E + N * L + 2 * sb * P * N
    return nbytes, P * N * (T + PW)


# ---------------------------------------------------------------------------
# the earlier wrappers (ops/kernels.py before the one-launch designs), around an earlier C entry
# ---------------------------------------------------------------------------

def parent_score_planes(fn, arr):
    import torch

    from ..ops import kernels

    dev = arr.device
    P, N = arr.P, arr.N
    T = arr.node_taint_pref.shape[1]
    PW = arr.pod_pref_terms.shape[1]
    S, E, L = arr.sel_mask.shape
    for name, dt, shape in (
        ("node_taint_pref", torch.bool, (N, T)), ("pod_tol_pref", torch.bool, (P, T)),
        ("pod_pref_terms", torch.int32, (P, PW)), ("pod_pref_weights", torch.float32, (P, PW)),
        ("sel_mask", torch.bool, (S, E, L)), ("sel_kind", torch.int32, (S, E)),
        ("node_labels", torch.bool, (N, L)),
    ):
        kernels._check(getattr(arr, name), name, dt, shape, dev)
    TW = max(1, -(-T // 32))
    tm = torch.empty((S, N), dtype=torch.uint8, device=dev)
    taint_w = torch.empty((N, TW), dtype=torch.int32, device=dev)
    tol_w = torch.empty((P, TW), dtype=torch.int32, device=dev)
    traw = torch.empty((P, N), dtype=torch.bfloat16, device=dev)
    naraw = torch.empty((P, N), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        err = fn(
            arr.node_taint_pref.data_ptr(), arr.pod_tol_pref.data_ptr(), arr.pod_pref_terms.data_ptr(),
            arr.pod_pref_weights.data_ptr(), arr.sel_mask.data_ptr(), arr.sel_kind.data_ptr(),
            arr.node_labels.data_ptr(), tm.data_ptr(), taint_w.data_ptr(), tol_w.data_ptr(), traw.data_ptr(),
            naraw.data_ptr(), P, N, T, PW, S, E, L, kernels._stream(dev),
        )
    kernels._raise_on(err, "score_planes")
    return traw, naraw


def parent_explain_counts(fn, arr, node_used, reps, rep_valid):
    import torch

    from ..ops import kernels

    dev = arr.device
    P, N, R = arr.P, arr.N, arr.R
    T = arr.node_taint_ns.shape[1]
    TT = arr.pod_terms.shape[1]
    S, E, L = arr.sel_mask.shape
    F = reps.shape[0]
    for name, t, dt, shape in (
        ("node_valid", arr.node_valid, torch.bool, (N,)), ("node_alloc", arr.node_alloc, torch.int32, (N, R)),
        ("node_used", node_used, torch.int32, (N, R)), ("node_unsched", arr.node_unsched, torch.bool, (N,)),
        ("node_labels", arr.node_labels, torch.bool, (N, L)), ("node_taint_ns", arr.node_taint_ns, torch.bool, (N, T)),
        ("sel_mask", arr.sel_mask, torch.bool, (S, E, L)), ("sel_kind", arr.sel_kind, torch.int32, (S, E)),
        ("pod_req", arr.pod_req, torch.int32, (P, R)), ("pod_tol_ns", arr.pod_tol_ns, torch.bool, (P, T)),
        ("pod_nodename", arr.pod_nodename, torch.int32, (P,)), ("pod_terms", arr.pod_terms, torch.int32, (P, TT)),
        ("pod_has_sel", arr.pod_has_sel, torch.bool, (P,)), ("reps", reps, torch.int64, (F,)),
        ("rep_valid", rep_valid, torch.bool, (F,)),
    ):
        kernels._check(t, name, dt, shape, dev)
    TW = max(1, -(-T // 32))
    tm = torch.empty((S, N), dtype=torch.uint8, device=dev)
    taint_w = torch.empty((N, TW), dtype=torch.int32, device=dev)
    tol_w = torch.empty((P, TW), dtype=torch.int32, device=dev)
    out = torch.empty((F, 4 + R + 1), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fn(
            arr.node_valid.data_ptr(), arr.node_alloc.data_ptr(), node_used.data_ptr(), arr.node_unsched.data_ptr(),
            arr.node_labels.data_ptr(), arr.node_taint_ns.data_ptr(), arr.sel_mask.data_ptr(),
            arr.sel_kind.data_ptr(), arr.pod_req.data_ptr(), arr.pod_tol_ns.data_ptr(), arr.pod_nodename.data_ptr(),
            arr.pod_terms.data_ptr(), arr.pod_has_sel.data_ptr(), reps.data_ptr(), rep_valid.data_ptr(),
            tm.data_ptr(), taint_w.data_ptr(), tol_w.data_ptr(), out.data_ptr(), F, P, N, R, T, TT, S, E, L,
            kernels._stream(dev),
        )
    kernels._raise_on(err, "explain_counts")
    return out


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def _sleep_cycles_per_ms() -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    torch.cuda.synchronize()
    return 10_000_000 / start.elapsed_time(end)


def card_host(fn, reps: int) -> tuple:
    """(card ms, host us) a call of fn(): `reps` calls queued behind a
    sleeping kernel that outlasts their enqueue; CUDA events time them on
    the card, perf_counter the enqueue (no call waits on the card)."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles_per_ms = _sleep_cycles_per_ms()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(cycles_per_ms * (2 * first_ms + 20)))
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host_s / reps * 1e6


def card_ms(fn, reps: int) -> float:
    return card_host(fn, reps)[0]


def timed(fn, reps: int) -> dict:
    ms = events_ms(fn, reps=reps, warmup=2)
    cms, hus = card_host(fn, reps)
    return dict(ms=ms, card_ms=cms, host_us=hus)


def device_ops(fn) -> list:
    """Names of the device operations (kernels, memsets, copies) one call
    runs, by torch.profiler; empty where the profiler sees no device
    activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = []
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            names.append(e.name)
    return names


def in_turns(tag: str, what: str, calls, check, reps: int) -> dict:
    """timed(call) for each (who, call) in turn order, check(who, output)
    after each turn -> {who: [timed, ...]}."""
    out = {}
    for who, call in calls:
        got = {}

        def run():
            got["x"] = call()

        res = timed(run, reps)
        check(who, got["x"])
        out.setdefault(who, []).append(res)
    print(f"[{tag}] {what}: " + "; ".join(
        f"{who} " + " / ".join(f"{r['ms']:.4f} ms b2b, {r['card_ms']:.4f} card, {r['host_us']:.1f} us host"
                               for r in v) for who, v in out.items()), flush=True)
    return out


def host_split(checks, alloc, ptrs, entry, dev, reps: int = 200) -> dict:
    """The wrapper's host time a call (us), taken apart: the argument
    checks, the allocations, torch.cuda.device's enter and exit, the
    current-stream lookup, the pointers, and the ctypes call with its
    launch (queued behind a sleep, so it never waits on the card)."""
    import torch

    from ..ops import kernels

    def us(f, n=reps):
        f()
        t0 = time.perf_counter()
        for _ in range(n):
            f()
        return (time.perf_counter() - t0) / n * 1e6

    def ctx():
        with torch.cuda.device(dev):
            pass

    res = dict(checks=us(checks), allocations=us(alloc), device_context=us(ctx),
               current_device=us(torch.cuda.current_device), stream=us(lambda: kernels._stream(dev)),
               pointers=us(ptrs))
    args = ptrs()
    stream = kernels._stream(dev)
    entry(*args, stream)
    torch.cuda.synchronize()
    torch.cuda._sleep(int(_sleep_cycles_per_ms() * 50))
    res["ctypes_call_and_launch"] = us(lambda: entry(*args, stream), n=50)
    torch.cuda.synchronize()
    return res


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------

def k14_cells(old_fn, card: str) -> dict:
    import torch

    from ..api.delta import DeltaEncoder, class_groups
    from ..ops import DEFAULT_SCORE_CONFIG, assign, explain, infer_score_config, kernels
    from . import preempt_bench as pb
    from . import workloads

    cells = {}
    arr, meta = DeltaEncoder().encode_device(workloads.heterogeneous(**workloads.NORTH_STAR))
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    _, used = assign.schedule_batch(arr, cfg)
    reps_np, _ = class_groups(meta, range(meta.n_pods))
    F = explain._pad_pow2(reps_np.size)
    pr = torch.zeros(F, dtype=torch.int64, device=arr.device)
    pr[: reps_np.size] = torch.from_numpy(reps_np).to(arr.device)
    rv = torch.arange(F, device=arr.device) < reps_np.size
    cells["north-star F=128"] = (arr, used, pr, rv, 50)
    snap = pb.build(**workloads.PREEMPT)
    with pb.WaveProbe(keep=True) as probe:
        pb.failure_cycle(snap)
        torch.cuda.synchronize()
    parr = probe.calls[0]["inputs"][0]
    del probe
    cells["preempt F=4"] = (parr, parr.node_used, torch.zeros(4, dtype=torch.int64, device=parr.device),
                            torch.arange(4, device=parr.device) < 1, 50)
    res = {}
    for cell, (a, u, r, v, reps) in cells.items():
        want = explain.explain_counts_plain(a, u, r, v)

        def check(who, got):
            if not torch.equal(got, want):
                raise RuntimeError(f"k14 {cell}: the {who} build's counts differ from plain")

        calls = [("new", lambda: kernels.explain_counts(a, u, r, v))]
        if old_fn is not None:
            old = ("old", lambda: parent_explain_counts(old_fn, a, u, r, v))
            calls = [old, calls[0], calls[0], old]
        turns = in_turns(f"k14 {cell}", f"F={r.shape[0]} N={a.N} R={a.R}", calls, check, reps)
        tol = (~a.pod_tol_ns[r]).to(torch.float32)
        taint = a.node_taint_ns.to(torch.float32)
        lib = timed(lambda: tol @ taint.T, reps)
        b_ms, b_by = bound_ms(*k14_work(a, r.shape[0]))
        ops = dict(new=device_ops(lambda: kernels.explain_counts(a, u, r, v)))
        if old_fn is not None:
            ops["old"] = device_ops(lambda: parent_explain_counts(old_fn, a, u, r, v))
        res[cell] = dict(F=r.shape[0], N=a.N, R=a.R, turns=turns, library_partial=lib, bound_ms=b_ms,
                         bound_by=b_by, device_ops=ops)
        print(f"[k14 {cell}] {card} | == plain in every turn; torch.matmul of the taint count {lib['card_ms']:.4f} "
              f"ms of card time ({lib['ms']:.4f} back to back); bound {b_ms:.6f} ms ({b_by}); device ops a call "
              f"{ops}", flush=True)
    # the wrapper's host time taken apart, north star
    a, u, r, v, _ = cells["north-star F=128"]
    T, TT = a.node_taint_ns.shape[1], a.pod_terms.shape[1]
    S, E, L = a.sel_mask.shape
    P, N, R = a.P, a.N, a.R
    F = r.shape[0]
    dev = a.device
    K = 4 + R + 1
    out = torch.empty((F, K), dtype=torch.int32, device=dev)
    acc = kernels._explain_acc(dev, kernels._stream(dev), F, R)
    fields = (("node_valid", a.node_valid, torch.bool, (N,)), ("node_alloc", a.node_alloc, torch.int32, (N, R)),
              ("node_used", u, torch.int32, (N, R)), ("node_unsched", a.node_unsched, torch.bool, (N,)),
              ("node_labels", a.node_labels, torch.bool, (N, L)),
              ("node_taint_ns", a.node_taint_ns, torch.bool, (N, T)),
              ("sel_mask", a.sel_mask, torch.bool, (S, E, L)), ("sel_kind", a.sel_kind, torch.int32, (S, E)),
              ("pod_req", a.pod_req, torch.int32, (P, R)), ("pod_tol_ns", a.pod_tol_ns, torch.bool, (P, T)),
              ("pod_nodename", a.pod_nodename, torch.int32, (P,)), ("pod_terms", a.pod_terms, torch.int32, (P, TT)),
              ("pod_has_sel", a.pod_has_sel, torch.bool, (P,)), ("reps", r, torch.int64, (F,)),
              ("rep_valid", v, torch.bool, (F,)))

    def checks():
        for name, t, dt, shape in fields:
            kernels._check(t, name, dt, shape, dev)

    def ptrs():
        return (a.node_valid.data_ptr(), a.node_alloc.data_ptr(), u.data_ptr(), a.node_unsched.data_ptr(),
                a.node_labels.data_ptr(), a.node_taint_ns.data_ptr(), a.sel_mask.data_ptr(),
                a.sel_kind.data_ptr(), a.pod_req.data_ptr(), a.pod_tol_ns.data_ptr(), a.pod_nodename.data_ptr(),
                a.pod_terms.data_ptr(), a.pod_has_sel.data_ptr(), r.data_ptr(), v.data_ptr(), acc.data_ptr(),
                out.data_ptr(), F, P, N, R, T, TT, S, E, L)

    split = host_split(checks, lambda: torch.empty((F, K), dtype=torch.int32, device=dev), ptrs,
                       kernels._fn("explain_counts"), dev)
    if not torch.equal(out, explain.explain_counts_plain(a, u, r, v)):
        raise RuntimeError("k14: the split's own launches differ from plain")
    res["host_split_us"] = split
    print(f"[k14] the wrapper's host time a call, taken apart (us): {split}", flush=True)
    return res


def k10_cells(old_fn, card: str) -> dict:
    import torch

    from ..api.snapshot import encode_snapshot
    from ..ops import assign, filters, kernels
    from ..ops.incremental import class_view
    from . import workloads

    arr, meta = encode_snapshot(workloads.all_stages(), device="cuda")
    cv = class_view(arr, torch.as_tensor(meta.class_first_pod, device=arr.device))
    cells = {"all-stages [512, 256]": (arr, 50), "class view [240, 256]": (cv, 50),
             "config 3 size [10240, 6144]": (random_score_arrays(0, 10240, 6144, 5, 3), 10)}
    res = {}
    for cell, (a, reps) in cells.items():
        want = assign.score_planes_plain(a)
        wbits = [x.view(torch.int16) for x in want]

        def check(who, got):
            if not all(torch.equal(x.view(torch.int16), y) for x, y in zip(got, wbits)):
                raise RuntimeError(f"k10 {cell}: the {who} build's planes differ from plain")

        calls = [("new", lambda: kernels.score_planes(a))]
        if old_fn is not None:
            old = ("old", lambda: parent_score_planes(old_fn, a))
            calls = [old, calls[0], calls[0], old]
        turns = in_turns(f"k10 {cell}", f"P={a.P} N={a.N}", calls, check, reps)
        P, N = a.P, a.N
        tm = filters.term_match(a.sel_mask, a.sel_kind, a.node_labels).to(torch.float32)
        S = tm.shape[0]
        W_na = torch.zeros((P, S), dtype=torch.float32, device=a.device)
        ids = torch.clamp_min(a.pod_pref_terms, 0).to(torch.int64)
        W_na.index_put_((torch.arange(P, device=a.device)[:, None].expand_as(ids), ids),
                        torch.where(a.pod_pref_terms >= 0, a.pod_pref_weights, torch.zeros_like(a.pod_pref_weights)),
                        accumulate=True)
        tolf = (~a.pod_tol_pref).to(torch.float32)
        taintT = a.node_taint_pref.to(torch.float32).T.contiguous()
        partial = timed(lambda: torch.matmul(W_na, tm), reps)
        whole = timed(lambda: (torch.matmul(tolf, taintT).to(torch.bfloat16),
                               torch.matmul(W_na, tm).to(torch.bfloat16)), reps)
        nbytes, nops = k10_work(a)
        b_ms, b_by = bound_ms(nbytes, nops)
        ops = dict(new=device_ops(lambda: kernels.score_planes(a)))
        if old_fn is not None:
            ops["old"] = device_ops(lambda: parent_score_planes(old_fn, a))
        res[cell] = dict(P=P, N=N, turns=turns, library_partial=partial, library_whole=whole, bound_ms=b_ms,
                         bound_by=b_by, bytes=nbytes, device_ops=ops)
        print(f"[k10 {cell}] {card} | both planes == plain in every turn; torch.matmul of the NA product "
              f"{partial['card_ms']:.4f} ms of card time ({partial['ms']:.4f} b2b), the whole function in torch "
              f"(two products cast to bf16) {whole['card_ms']:.4f} ({whole['ms']:.4f}); bound {b_ms:.6f} ms "
              f"({b_by}: {nbytes} B); device ops a call {ops}", flush=True)
        del want, wbits, W_na, tm, tolf, taintT
        torch.cuda.empty_cache()
    a = arr
    P, N = a.P, a.N
    T = a.node_taint_pref.shape[1]
    PW = a.pod_pref_terms.shape[1]
    S, E, L = a.sel_mask.shape
    dev = a.device
    planes = torch.empty((2, P, N), dtype=torch.bfloat16, device=dev)
    fields = (("node_taint_pref", torch.bool, (N, T)), ("pod_tol_pref", torch.bool, (P, T)),
              ("pod_pref_terms", torch.int32, (P, PW)), ("pod_pref_weights", torch.float32, (P, PW)),
              ("sel_mask", torch.bool, (S, E, L)), ("sel_kind", torch.int32, (S, E)),
              ("node_labels", torch.bool, (N, L)))

    def checks():
        for name, dt, shape in fields:
            kernels._check(getattr(a, name), name, dt, shape, dev)

    def ptrs():
        return (a.node_taint_pref.data_ptr(), a.pod_tol_pref.data_ptr(), a.pod_pref_terms.data_ptr(),
                a.pod_pref_weights.data_ptr(), a.sel_mask.data_ptr(), a.sel_kind.data_ptr(), a.node_labels.data_ptr(),
                planes[0].data_ptr(), planes[1].data_ptr(), P, N, T, PW, S, E, L)

    split = host_split(checks, lambda: torch.empty((2, P, N), dtype=torch.bfloat16, device=dev).unbind(0), ptrs,
                       kernels._fn("score_planes"), dev)
    res["host_split_us"] = split
    print(f"[k10] the wrapper's host time a call at [512, 256], taken apart (us): {split}", flush=True)
    return res


def main(argv=None) -> int:
    import torch

    from ..ops import kernels

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default="", help="a directory holding an earlier csrc/ to time in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("score_explain: no CUDA device", file=sys.stderr)
        return 2
    card = card_name()
    old14 = old10 = None
    if args.parent:
        csrc = Path(args.parent) / "csrc"
        _, old14 = build_variant("explain_counts", csrc / "explain.cu", tag="parent")
        _, old10 = build_variant("score_planes", csrc / "score_planes.cu", tag="parent")
        old14.argtypes = PARENT_ARGTYPES["explain_counts"]
        old10.argtypes = PARENT_ARGTYPES["score_planes"]
    kernels.build(["explain_counts", "score_planes"])
    result = dict(card=card, k10=k10_cells(old10, card), k14=k14_cells(old14, card))
    print(json.dumps(result), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
