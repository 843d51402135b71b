#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kubernetes_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds every kernel from csrc/ with nvcc (one process per source, all at
once), then drives the port's three routes and bench.py's warm loop at the
north-star shape, heterogeneous(20000, 50000, seed=0) (P=51200, N=20480,
R=5, U1=101):

  [mixed]            static_feasible and fit_scan == their plain versions on
                     a small mixed snapshot, three fit strategies;
  [north-star]       the per-pod route, encode_snapshot -> schedule_batch
                     (chunked=False):
                     50000/50000 scheduled, the JAX package's choices digest,
                     static_feasible == plain over [P, N], fit_scan == plain
                     on the first 8192 pods;
  [waves-mixed]      the class-wave kernels (class_static_hoist,
                     class_usage_hoist full and column-list, wave_commit,
                     chunk_rounds) == their plain versions on the card, bit
                     for bit, on small snapshots (mixed x 3 strategies, an
                     interference wave that forces fallbacks and epoch
                     refreshes, two-entry lists whose block budget runs out
                     and leaves work to stage B),
                     and the route's choices == the per-pod route's;
  [north-star-waves] HoistCache.ensure -> schedule_batch(inc=...): the same
                     choices digest, the JAX route's sweep count and ordinal
                     digest, every kernel == plain at full size (chunk_rounds
                     on the first 64 chunks), then the route with
                     class_waves=False (chunk_rounds carries all 1600 chunks)
                     and a warm cycle that patches the dirty columns;
  [north-star-dense] a cold DeltaEncoder encode, then the dense chunked
                     route (no class state: the card's default),
                     packed_static_rows + chunk_rounds_dense: 50000/50000,
                     the choices digest, the JAX dense route's sweep count
                     and ordinal digest; packed_static_rows == plain over
                     [P, W], chunk_rounds_dense == plain on the first chunks;
  [warm-loop]        bench.py's warm waves 2..7 through PipelinedBatchLoop at
                     depth 1, then again at depth 0: per-wave choice digests
                     equal across the depths and to the JAX loop's, its
                     HoistCache actions, enc.stats["delta"] >= 3, delta_s,
                     end_to_end_s (median of the steady walls) and
                     overlap_fraction as bench.py computes them;
  [wide-planes]      a snapshot with 80 distinct NoSchedule taints through
                     DeltaEncoder: its two 80-wide bool fields travel packed
                     and unpack_planes (== plain) unpacks them; decisions ==
                     the JAX package's.

Each route is counted on its own: every launch count is set to 0 just
before the route runs and read just after, and a kernel of the route that
was not launched fails the run.  Kernel times come from CUDA events after
a warm-up; step and loop times from the host clock around work that ends
in torch.cuda.synchronize().

Prints one line per phase, then a JSON line of per-kernel numbers, the
card's name and power limit as nvidia-smi gives them, and last
{"ok": true, "device": {...}}.  Exits non-zero, with no result, when there
is no CUDA device, when the port is not beside this script, or when any
phase fails.  Needs one card and no network.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_PER_S = 67e12  # f32 outside the tensor cores, H100 SXM data sheet
PREFIX = 2048  # pods of the north-star scan held against the plain scan
PLAIN_PODS = 8192  # pods of the north-star scan the plain scan re-runs in full
WAVE_PREFIX_CHUNKS = 64  # stage-B chunks held against the plain round loop
PER_POD_KERNELS = ("static_feasible", "fit_scan")
WAVE_KERNELS = ("class_static_hoist", "class_usage_hoist", "wave_commit", "chunk_rounds")
DENSE_KERNELS = ("packed_static_rows", "chunk_rounds_dense")
DENSE_PREFIX_CHUNKS = 8  # dense chunks held against the plain round loop
STRATEGIES = (
    ("LeastAllocated", ((0.0, 0.0), (100.0, 10.0))),
    ("MostAllocated", ((0.0, 0.0), (100.0, 10.0))),
    ("RequestedToCapacityRatio", ((0.0, 10.0), (50.0, 2.0), (100.0, 0.0))),
)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of fn() over `reps` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def f32_ops_per_scored_node(cfg) -> int:
    """f32 operations csrc/fit_scan.cu does for one (pod, node) pair that
    passes fit: the fit strategy and BalancedAllocation over K scored
    resources, then the weighted sum (int->f32 conversions not counted)."""
    k = len(cfg.score_resources)
    per_res = {
        "LeastAllocated": 4,  # sub, mul, div, max
        "MostAllocated": 3,  # compare, mul, div
        "RequestedToCapacityRatio": 3 + 6 * (len(cfg.rtcr_shape) - 1),
    }[cfg.fit_strategy]
    fit = k * per_res + (k - 1) + 1  # sum, divide by K
    balanced = 2 * k + (k - 1) + 1 + 2 * k + (k - 1) + 1 + 3  # f, mean, var, sqrt/sub/mul
    return fit + balanced + 3


def bound(bytes_moved: float, ops: float) -> tuple:
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_card() -> tuple:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"[card] {name} | count {torch.cuda.device_count()} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | nvidia-smi: {card}", flush=True)
    return card, name


def phase_build() -> None:
    from kubernetes_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    kernels.build()
    dt = time.perf_counter() - t0
    for name, log in kernels.BUILD_LOG.items():
        info = [ln.strip() for ln in log.splitlines() if re.search(r"registers|Used|spill", ln)]
        print(f"[build] {name}: " + " | ".join(info), flush=True)
    print(f"[build] {len(set(kernels.SOURCES.values()))} kernel libraries ({len(kernels.SOURCES)} kernels) "
          f"in {dt:.2f} s", flush=True)


def phase_mixed() -> None:
    import torch

    from kubernetes_tpu_torch.api.snapshot import encode_snapshot
    from kubernetes_tpu_torch.bench.workloads import mixed
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, infer_score_config, schedule_batch
    from kubernetes_tpu_torch.ops import filters, kernels
    from kubernetes_tpu_torch.ops.assign import schedule_scan_plain

    snap = mixed()
    arr, meta = encode_snapshot(snap, device="cuda")
    arr_cpu, _ = encode_snapshot(snap, device="cpu")
    sf_k = kernels.static_feasible(arr)
    sf_p = filters.static_feasible_plain(arr)
    torch.cuda.synchronize()
    check(torch.equal(sf_k, sf_p), "mixed: static_feasible kernel != plain")
    for strategy, shape in STRATEGIES:
        cfg = infer_score_config(arr, dataclasses.replace(
            DEFAULT_SCORE_CONFIG, fit_strategy=strategy, rtcr_shape=shape))
        ck, uk, _ = kernels.fit_scan(sf_k, arr, cfg)
        cp, up = schedule_scan_plain(arr, cfg, sf=sf_p)
        cc, uc = schedule_batch(arr_cpu, cfg, device="cpu")
        torch.cuda.synchronize()
        check(torch.equal(ck, cp) and torch.equal(uk, up), f"mixed {strategy}: fit_scan kernel != plain")
        check(torch.equal(ck.cpu(), cc) and torch.equal(uk.cpu(), uc), f"mixed {strategy}: card != CPU")
        print(f"[mixed] {strategy}: P={arr.P} N={arr.N} R={arr.R} scheduled "
              f"{int((ck[:meta.n_pods] >= 0).sum())}/{meta.n_pods}; kernels == plain == CPU", flush=True)


def phase_north_star() -> list:
    import torch

    from kubernetes_tpu_torch.api.snapshot import encode_snapshot
    from kubernetes_tpu_torch.bench import workloads
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, infer_score_config, schedule_batch
    from kubernetes_tpu_torch.ops import filters, kernels
    from kubernetes_tpu_torch.ops.assign import schedule_scan_plain

    snap = workloads.heterogeneous(**workloads.NORTH_STAR)
    t0 = time.perf_counter()
    arr, meta = encode_snapshot(snap)  # the card, as a user calls it
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    P, N, R = arr.P, arr.N, arr.R
    print(f"[north-star] encode_s {encode_s:.3f}: P={P} N={N} R={R} resources {meta.resources} "
          f"scale {meta.resource_scale.tolist()}", flush=True)

    # --- the per-pod route, counted (chunked=False: on the card the default
    # without class state is the dense chunked route, [north-star-dense]) ---
    kernels.reset_launches()
    t0 = time.perf_counter()
    choices, used = schedule_batch(arr, cfg, chunked=False)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.LAUNCHES.items() if k in PER_POD_KERNELS}
    check(all(n > 0 for n in launches.values()), f"a kernel of the path was not launched: {launches}")
    c = choices[: meta.n_pods].cpu().numpy().astype("<i4")
    scheduled = int((c >= 0).sum())
    digest = hashlib.sha256(c.tobytes()).hexdigest()
    print(f"[north-star] schedule_batch step_s {step_s:.3f}: scheduled {scheduled}/{meta.n_pods}, "
          f"sha256 {digest}, launches {launches}", flush=True)
    check(scheduled == workloads.NORTH_STAR_SCHEDULED, f"scheduled {scheduled} != {workloads.NORTH_STAR_SCHEDULED}")
    check(digest == workloads.NORTH_STAR_CHOICES_SHA256, "choices differ from the JAX package's")

    # --- kernel 1 against its plain version over the whole [P, N] ---
    sf = kernels.static_feasible(arr)
    sf_p = filters.static_feasible_plain(arr)
    k1_err = int((sf != sf_p).any())  # |kernel - plain| over 0/1 entries
    check(k1_err == 0, "north-star: static_feasible kernel != plain")
    del sf_p
    k1_ms = cuda_ms(lambda: kernels.static_feasible(arr), reps=10, warmup=2)
    k1_plain_ms = cuda_ms(lambda: filters.static_feasible_plain(arr), reps=3)
    T, TT = arr.node_taint_ns.shape[1], arr.pod_terms.shape[1]
    S, E, L = arr.sel_mask.shape
    k1_bytes = (N * (2 + T + L) + P * (2 + T) + 4 * P * (1 + TT) + S * E * L + 4 * S * E) + P * N
    k1_ops = P * N * (3 + T + TT)  # integer tests, priced at the f32 rate
    k1_bound, k1_by = bound(k1_bytes, k1_ops)
    print(f"[north-star] static_feasible: kernel == plain over [{P}, {N}]; kernel {k1_ms:.4f} ms, "
          f"plain {k1_plain_ms:.4f} ms, bound {k1_bound:.4f} ms ({k1_by}: {k1_bytes} B)", flush=True)

    # --- kernel 2 against its plain version: the first PREFIX pods, then all ---
    pre = arr.pod_prefix(PREFIX)
    ck, uk, _ = kernels.fit_scan(sf[:PREFIX].contiguous(), pre, cfg)
    cp, up = schedule_scan_plain(pre, cfg, sf=sf[:PREFIX])
    torch.cuda.synchronize()
    check(torch.equal(ck, cp) and torch.equal(uk, up), "north-star prefix: fit_scan kernel != plain")
    check(torch.equal(ck, choices[:PREFIX]), "north-star prefix: prefix scan != full scan")
    print(f"[north-star] fit_scan: kernel == plain on the first {PREFIX} pods", flush=True)

    out = {}

    def run_kernel():
        out["k"] = kernels.fit_scan(sf, arr, cfg)

    k2_ms = cuda_ms(run_kernel, reps=3)
    ck, uk, n_scored = out["k"]
    check(torch.equal(ck, choices), "north-star: timed fit_scan != the main path's")
    # the plain scan over all pods takes ~70 s; a prefix of the scan is a
    # scan, so the plain version re-runs the first PLAIN_PODS pods
    pre = arr.pod_prefix(PLAIN_PODS)
    ckp, ukp, _ = kernels.fit_scan(sf[:PLAIN_PODS].contiguous(), pre, cfg)
    t0 = time.perf_counter()
    cp, up = schedule_scan_plain(pre, cfg, sf=sf[:PLAIN_PODS])
    torch.cuda.synchronize()
    k2_plain_ms = (time.perf_counter() - t0) * 1e3
    k2_err = max(int((ckp.long() - cp.long()).abs().max()), int((ukp.long() - up.long()).abs().max()))
    check(k2_err == 0, f"north-star: fit_scan kernel != plain on the first {PLAIN_PODS} pods")
    check(torch.equal(ckp, choices[:PLAIN_PODS]), "north-star: prefix scan != full scan")
    n_scored = int(n_scored.item())
    # the scan's floor: the same launch with every sf bit clear, so each pod
    # still streams its row and pays the block reduction and the barriers,
    # but nothing passes to fit or scoring
    empty = torch.zeros_like(sf)
    floor_ms = cuda_ms(lambda: kernels.fit_scan(empty, arr, cfg), reps=3)
    del empty
    k2_bytes = P * N + 4 * P * R + P + 3 * 4 * N * R + 4 * P
    k2_ops = n_scored * f32_ops_per_scored_node(cfg)
    k2_bound, k2_by = bound(k2_bytes, k2_ops)
    print(f"[north-star] fit_scan: kernel == plain on the first {PLAIN_PODS} pods; kernel {k2_ms:.3f} ms "
          f"over all {P} ({k2_ms / P * 1e3:.3f} us per pod; with no feasible node {floor_ms:.3f} ms, "
          f"{floor_ms / P * 1e3:.3f} us per pod: the {P} block reductions and barriers), "
          f"plain {k2_plain_ms:.1f} ms on {PLAIN_PODS} pods (host clock), bound {k2_bound:.4f} ms "
          f"({k2_by}: {k2_bytes} B, {n_scored} scored pairs x {f32_ops_per_scored_node(cfg)} f32 ops)",
          flush=True)
    return step_s, [
        dict(name="static_feasible", route="cuda", source="kubernetes_tpu_torch/csrc/static_feasible.cu",
             replaces="kubernetes_tpu/ops/filters.py:81", launches=launches["static_feasible"],
             max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain_ms, bound_ms=k1_bound, bound_by=k1_by,
             library_ms=None),
        dict(name="fit_scan", route="cuda", source="kubernetes_tpu_torch/csrc/fit_scan.cu",
             replaces="kubernetes_tpu/ops/assign.py:181", launches=launches["fit_scan"],
             max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain_ms, bound_ms=k2_bound, bound_by=k2_by,
             library_ms=None, plain_scope=f"first {PLAIN_PODS} pods"),
    ]


def f32_bits(x):
    import torch

    return x.contiguous().view(torch.int32)


def same(a, b) -> bool:
    """Bitwise equality of two tensors (f32 compared as bits)."""
    import torch

    if a.dtype == torch.float32:
        a, b = f32_bits(a), f32_bits(b)
    return a.shape == b.shape and torch.equal(a, b)


def mismatch(a, b) -> int:
    """Entries that differ (f32 as bits)."""
    if a.dtype.is_floating_point:
        a, b = f32_bits(a), f32_bits(b)
    return int((a != b).sum())


def hold_class_kernels(arr, meta, cfg, tag: str, **knobs) -> dict:
    """Hold K3, K4 (full and column list), K5 and K6 to their plain versions
    on these arrays (the plain versions run on the card's tensors) and the
    route's choices to the per-pod route's; `knobs` are the route's wave_k /
    wave_block.  -> the wave's counters."""
    import torch

    from kubernetes_tpu_torch.ops import assign, incremental, kernels
    from kubernetes_tpu_torch.ops.incremental import HoistCache, class_view

    inc = HoistCache().ensure(arr, meta, cfg)
    check(inc is not None, f"{tag}: no class state")
    r_u = torch.as_tensor(meta.class_first_pod, device=arr.device)
    stat_p = incremental._static_hoist_plain(class_view(arr, r_u))
    check(same(inc.stat_u, stat_p), f"{tag}: class_static_hoist != plain")
    base_p, fit_p = incremental._usage_hoist_plain(inc.req_u, arr.node_used, arr.node_alloc, cfg)
    check(same(inc.base_u, base_p) and same(inc.fit_u, fit_p), f"{tag}: class_usage_hoist != plain")
    # column list: dirty a third of the nodes, several sharing a word
    N = arr.N
    g = torch.Generator().manual_seed(7)
    dirty = torch.randperm(N, generator=g)[: max(1, N // 3)].sort().values.to(arr.device)
    used2 = arr.node_used.clone()
    used2[dirty] += arr.pod_req[0]
    cols = torch.full((incremental._round_up_pow2(len(dirty)),), N, dtype=torch.int32, device=arr.device)
    cols[: len(dirty)] = dirty.to(torch.int32)
    bk, fk = kernels.class_usage_hoist(inc.req_u, used2, arr.node_alloc, cfg, cols=cols,
                                       base_u=inc.base_u, fit_u=inc.fit_u)
    bp, fp = incremental._patch_hoist_plain(inc.base_u, inc.fit_u, inc.req_u, used2, arr.node_alloc, cols, cfg)
    bf, ff = kernels.class_usage_hoist(inc.req_u, used2, arr.node_alloc, cfg)
    check(same(bk, bp) and same(fk, fp), f"{tag}: class_usage_hoist column list != plain")
    check(same(bk, bf) and same(fk, ff), f"{tag}: patched columns != a full hoist")
    check(same(inc.base_u, base_p), f"{tag}: the column list wrote into the resident base_u")
    # K5
    wk = kernels.wave_commit(arr, inc, cfg, **knobs)
    t0u = assign.t0u_prologue(inc, N)
    wp = assign.wave_commit_plain(inc.cls, arr.pod_valid, arr.pod_req, arr.node_used, t0u, inc.stat_u,
                                  arr.node_alloc, inc.req_u, cfg, **knobs)
    names = ("committed", "out", "ordinal", "used", "t0u")
    for name, a, b in zip(names, wk[:5], wp[:5]):
        check(same(a, b), f"{tag}: wave_commit {name} != plain ({mismatch(a, b)} entries)")
    check(int(wk[5]) == wp[5] and int(wk[6]) == wp[6],
          f"{tag}: wave_commit blocks/epochs {int(wk[5])}/{int(wk[6])} != plain {wp[5]}/{wp[6]}")
    # K6 after the plain wave (so each kernel is held alone), and with no wave
    wave_p = (wp[0], wp[1], wp[2], torch.tensor(wp[5], dtype=torch.int32, device=arr.device))
    for leg, wave, used0, t0 in (("waves", wave_p, wp[3], wp[4]), ("no waves", None, arr.node_used, None)):
        ck = kernels.chunk_rounds(arr, inc, cfg, used0, t0, wave)
        cp = assign.schedule_scan_chunked_plain(
            arr, cfg, inc, used0, t0u if t0 is None else t0,
            None if wave is None else (wp[0], wp[1], wp[2], wp[5]))
        for name, a, b in zip(("choices", "used", "ordinals"), ck[:3], cp[:3]):
            check(same(a, b), f"{tag} {leg}: chunk_rounds {name} != plain ({mismatch(a, b)} entries)")
        sweeps = kernels.read_sweeps(ck[3])
        check(sweeps == cp[3], f"{tag} {leg}: chunk_rounds sweeps {sweeps} != plain {cp[3]}")
    # the route against the per-pod route
    c1, u1 = assign.schedule_batch(arr, cfg)
    for waves in (True, False):
        c2, u2, o2, s2 = assign.schedule_batch_ordinals(arr, cfg, inc=inc, class_waves=waves, **knobs)
        check(torch.equal(c1, c2) and torch.equal(u1, u2), f"{tag} waves={waves}: route != per-pod route")
    return dict(blocks=wp[5], epochs=wp[6], stage_b=int((~wp[0][: meta.n_pods]).sum()), U1=inc.req_u.shape[0])


def phase_waves_mixed() -> None:
    from kubernetes_tpu_torch.api.snapshot import encode_snapshot
    from kubernetes_tpu_torch.bench import workloads
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, infer_score_config

    cases = [(f"mixed {name}", workloads.mixed(), name, shape, {}) for name, shape in STRATEGIES]
    cases += [
        ("interference", workloads.interference(), "LeastAllocated", STRATEGIES[0][1], {}),
        ("heterogeneous(64, 300)", workloads.heterogeneous(64, 300), "LeastAllocated", STRATEGIES[0][1], {}),
        ("mixed, wave_block=4 wave_k=8", workloads.mixed(), "MostAllocated", STRATEGIES[1][1],
         dict(wave_block=4, wave_k=8)),
        # two-entry lists in 64-pod blocks: the block budget runs out and
        # chunk_rounds continues after a partial wave
        ("basic(48, 1500), wave_block=64 wave_k=2", workloads.basic(48, 1500), "LeastAllocated",
         STRATEGIES[0][1], dict(wave_block=64, wave_k=2)),
    ]
    for tag, snap, strategy, shape, knobs in cases:
        arr, meta = encode_snapshot(snap, device="cuda")
        cfg = infer_score_config(arr, dataclasses.replace(
            DEFAULT_SCORE_CONFIG, fit_strategy=strategy, rtcr_shape=shape))
        info = hold_class_kernels(arr, meta, cfg, tag, **knobs)
        if tag == "interference":
            check(info["epochs"] > 0, "interference: the wave never refreshed an epoch")
        if tag.startswith("basic"):
            check(info["stage_b"] > 0, f"{tag}: the wave left nothing to stage B")
        print(f"[waves-mixed] {tag}: P={arr.P} N={arr.N} U1={info['U1']} wave blocks {info['blocks']} "
              f"epochs {info['epochs']} left to stage B {info['stage_b']}; class_static_hoist, "
              f"class_usage_hoist (full, columns), wave_commit, chunk_rounds == plain; route == per-pod",
              flush=True)


def phase_north_star_waves(per_pod_step_s: float) -> list:
    import torch

    from kubernetes_tpu_torch.api.snapshot import encode_snapshot
    from kubernetes_tpu_torch.bench import workloads
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, incremental, infer_score_config, kernels
    from kubernetes_tpu_torch.ops.incremental import HoistCache, IncState, class_view

    snap = workloads.heterogeneous(**workloads.NORTH_STAR)
    arr, meta = encode_snapshot(snap)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    P, N, R = arr.P, arr.N, arr.R
    n = meta.n_pods

    def digest(x):
        return hashlib.sha256(x[:n].cpu().numpy().astype("<i4").tobytes()).hexdigest()

    # --- the class-wave route, counted ---
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = HoistCache()
    inc = cache.ensure(arr, meta, cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    choices, used, ords, sweeps = assign.schedule_batch_ordinals(arr, cfg, inc=inc)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if k in WAVE_KERNELS}
    check(all(v > 0 for v in launches.values()), f"a kernel of the class-wave route was not launched: {launches}")
    U1 = inc.req_u.shape[0]
    scheduled = int((choices[:n] >= 0).sum())
    print(f"[north-star-waves] HoistCache.ensure {t1 - t0:.3f} s ({cache.last['action']}), "
          f"schedule_batch(inc) {t2 - t1:.3f} s (first call): U1={U1} scheduled {scheduled}/{n}, "
          f"sweeps {sweeps}, choices sha256 {digest(choices)}, ordinals sha256 {digest(ords)}, "
          f"launches {launches}", flush=True)
    check(U1 == workloads.NORTH_STAR_CLASSES, f"U1 {U1} != {workloads.NORTH_STAR_CLASSES}")
    check(scheduled == workloads.NORTH_STAR_SCHEDULED, "north-star waves: scheduled count")
    check(digest(choices) == workloads.NORTH_STAR_CHOICES_SHA256, "north-star waves: choices differ from JAX")
    check(sweeps == workloads.NORTH_STAR_WAVE_SWEEPS, f"north-star waves: sweeps {sweeps}")
    check(digest(ords) == workloads.NORTH_STAR_WAVE_ORDINALS_SHA256, "north-star waves: ordinals differ from JAX")
    # step_s after a warm-up, both routes on the same snapshot
    def route():
        return assign.schedule_batch(arr, cfg, inc=cache.ensure(arr, meta, cfg))

    route()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    route()
    torch.cuda.synchronize()
    wave_step_s = time.perf_counter() - t0
    print(f"[north-star-waves] step_s: class-wave route {wave_step_s:.4f} s (ensure hit + schedule_batch), "
          f"per-pod route {per_pod_step_s:.4f} s ([north-star], first call)", flush=True)

    # --- K3 and K4 against plain over all [U1, N] ---
    r_u = torch.as_tensor(meta.class_first_pod, device=arr.device)
    stat_p = incremental._static_hoist_plain(class_view(arr, r_u))
    k3_err = mismatch(inc.stat_u, stat_p)
    check(k3_err == 0, "north-star: class_static_hoist != plain")
    base_p, fit_p = incremental._usage_hoist_plain(inc.req_u, arr.node_used, arr.node_alloc, cfg)
    k4_err = mismatch(inc.base_u, base_p) + mismatch(inc.fit_u, fit_p)
    check(k4_err == 0, "north-star: class_usage_hoist != plain")
    k3_ms = cuda_ms(lambda: kernels.class_static_hoist(arr, r_u), reps=20, warmup=2)
    k3_plain = cuda_ms(lambda: incremental._static_hoist_plain(class_view(arr, r_u)), reps=5)
    k4_ms = cuda_ms(lambda: kernels.class_usage_hoist(inc.req_u, arr.node_used, arr.node_alloc, cfg), reps=20,
                    warmup=2)
    k4_plain = cuda_ms(lambda: incremental._usage_hoist_plain(inc.req_u, arr.node_used, arr.node_alloc, cfg),
                       reps=5)
    T, TT = arr.node_taint_ns.shape[1], arr.pod_terms.shape[1]
    S, E_, L = arr.sel_mask.shape
    W = -(-N // 32)
    k3_bytes = N * (1 + T + L) + U1 * (T + 1 + 4 + 4 * TT + 8) + S * E_ * L + 4 * S * E_ + 4 * U1 * W
    k3_bound, k3_by = bound(k3_bytes, U1 * N * (3 + T + TT))
    per_score = f32_ops_per_scored_node(cfg)
    k4_bytes = 4 * U1 * R + 2 * 4 * N * R + 4 * U1 * N + 4 * U1 * W
    k4_bound, k4_by = bound(k4_bytes, U1 * N * per_score)
    print(f"[north-star-waves] class_static_hoist == plain over [{U1}, {N}]: {k3_ms:.4f} ms, plain "
          f"{k3_plain:.4f} ms, bound {k3_bound:.5f} ms ({k3_by}); class_usage_hoist == plain: {k4_ms:.4f} ms, "
          f"plain {k4_plain:.4f} ms, bound {k4_bound:.5f} ms ({k4_by}: {k4_bytes} B, {U1 * N} scores)", flush=True)

    # --- K5 against plain over the whole wave ---
    out = {}

    def run_k5():
        out["w"] = kernels.wave_commit(arr, inc, cfg)

    k5_ms = cuda_ms(run_k5, reps=5, warmup=1)
    wk = out["w"]
    t0u = assign.t0u_prologue(inc, N)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wp = assign.wave_commit_plain(inc.cls, arr.pod_valid, arr.pod_req, arr.node_used, t0u, inc.stat_u,
                                  arr.node_alloc, inc.req_u, cfg)
    torch.cuda.synchronize()
    k5_plain = (time.perf_counter() - t0) * 1e3
    k5_err = sum(mismatch(a, b) for a, b in zip(wk[:5], wp[:5]))
    check(k5_err == 0 and int(wk[5]) == wp[5] and int(wk[6]) == wp[6], "north-star: wave_commit != plain")
    placed = int((wp[1] >= 0).sum())
    n_blocks, epochs = wp[5], wp[6]
    k5_bytes = (4 * P + P + 4 * P * R + 4 * N * R + 2 * 4 * U1 * W + 4 * U1 * N + 4 * N * R + 4 * U1 * R
                + P + 4 * P + 4 * P + 4 * N * R + 4 * U1 * N)
    # each placed pod's post-placement column is scored for every class; each
    # refresh reads every class row once
    k5_ops = U1 * placed * per_score + (epochs + 1) * U1 * N
    k5_bound, k5_by = bound(k5_bytes, k5_ops)
    print(f"[north-star-waves] wave_commit == plain over the whole wave ({n_blocks} blocks, {epochs} epochs, "
          f"{placed} placed): {k5_ms:.3f} ms, plain {k5_plain:.1f} ms (host clock), bound {k5_bound:.5f} ms "
          f"({k5_by}: {k5_bytes} B, {k5_ops} ops)", flush=True)

    # --- the route with class_waves=False: chunk_rounds carries every chunk ---
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c_off, u_off, o_off, s_off = assign.schedule_batch_ordinals(arr, cfg, inc=inc, class_waves=False)
    torch.cuda.synchronize()
    off_s = time.perf_counter() - t0
    check(kernels.LAUNCHES["chunk_rounds"] == 1 and kernels.LAUNCHES["wave_commit"] == 0,
          f"waves off: launches {kernels.LAUNCHES}")
    print(f"[north-star-waves] class_waves=False {off_s:.3f} s: sweeps {s_off}, choices sha256 "
          f"{digest(c_off)}, ordinals sha256 {digest(o_off)}", flush=True)
    check(digest(c_off) == workloads.NORTH_STAR_CHOICES_SHA256, "waves off: choices differ from JAX")
    check(s_off == workloads.NORTH_STAR_NOWAVE_SWEEPS, f"waves off: sweeps {s_off}")
    check(digest(o_off) == workloads.NORTH_STAR_NOWAVE_ORDINALS_SHA256, "waves off: ordinals differ from JAX")
    k6_full_ms = cuda_ms(lambda: kernels.chunk_rounds(arr, inc, cfg, arr.node_used, None, None), reps=3)
    # K6 against plain on the first chunks: a prefix of the chunk scan is a scan
    npre = WAVE_PREFIX_CHUNKS * assign.INC_CHUNK
    pre = arr.pod_prefix(npre)
    inc_pre = IncState(cls=inc.cls[:npre].contiguous(), req_u=inc.req_u, stat_u=inc.stat_u, base_u=inc.base_u,
                       fit_u=inc.fit_u)
    ck = kernels.chunk_rounds(pre, inc_pre, cfg, arr.node_used, None, None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cp = assign.schedule_scan_chunked_plain(pre, cfg, inc_pre, arr.node_used, t0u, None)
    torch.cuda.synchronize()
    k6_plain = (time.perf_counter() - t0) * 1e3
    k6_err = sum(mismatch(a, b) for a, b in zip(ck[:3], cp[:3])) + abs(kernels.read_sweeps(ck[3]) - cp[3])
    check(k6_err == 0, f"north-star: chunk_rounds != plain on the first {WAVE_PREFIX_CHUNKS} chunks")
    check(torch.equal(ck[0], c_off[:npre]) and torch.equal(ck[2], o_off[:npre]), "chunk prefix != full run")
    k6_ms = cuda_ms(lambda: kernels.chunk_rounds(pre, inc_pre, cfg, arr.node_used, None, None), reps=5)
    k6_bytes = (4 * npre * R + npre + 4 * npre + 4 * N * R + 4 * U1 * R + 2 * 4 * U1 * W + 4 * U1 * N
                + 4 * N * R + 4 * npre + 4 * N * R + 4 * U1 * N + 4 * npre)
    # each pod's list is one selection over its class row; each stage-B
    # placement re-scores its column for every class
    k6_ops = npre * N + U1 * int((cp[0] >= 0).sum()) * per_score
    k6_bound, k6_by = bound(k6_bytes, k6_ops)
    print(f"[north-star-waves] chunk_rounds == plain on the first {WAVE_PREFIX_CHUNKS} chunks ({cp[3]} rounds): "
          f"{k6_ms:.3f} ms, plain {k6_plain:.1f} ms (host clock), bound {k6_bound:.5f} ms ({k6_by}); "
          f"all {P // assign.INC_CHUNK} chunks ({s_off} rounds): {k6_full_ms:.3f} ms", flush=True)

    # --- a warm cycle: the first 2048 pods' usage, patched columns ---
    arr2 = dataclasses.replace(arr, node_used=choices_used(arr, choices, 2048))
    kernels.reset_launches()
    inc2 = cache.ensure(arr2, meta, cfg)
    check(cache.last["action"] == "patch" and kernels.LAUNCHES["class_usage_hoist"] == 1,
          f"warm cycle: action {cache.last['action']}, launches {kernels.LAUNCHES}")
    bf, ff = kernels.class_usage_hoist(inc2.req_u, arr2.node_used, arr2.node_alloc, cfg)
    check(same(inc2.base_u, bf) and same(inc2.fit_u, ff), "warm cycle: patched != a full hoist")
    dirty = cache.last["patched_cols"]
    cols = torch.full((incremental._round_up_pow2(dirty),), N, dtype=torch.int32, device=arr.device)
    cols[:dirty] = torch.nonzero((arr2.node_used != arr.node_used).any(dim=1)).flatten().to(torch.int32)
    bp, fp = incremental._patch_hoist_plain(inc.base_u, inc.fit_u, inc.req_u, arr2.node_used, arr.node_alloc,
                                            cols, cfg)
    check(same(inc2.base_u, bp) and same(inc2.fit_u, fp), "warm cycle: patched != plain patch")
    kp_ms = cuda_ms(lambda: kernels.class_usage_hoist(inc.req_u, arr2.node_used, arr.node_alloc, cfg, cols=cols,
                                                      base_u=inc.base_u, fit_u=inc.fit_u), reps=20, warmup=2)
    c2, u2 = assign.schedule_batch(arr2, cfg, inc=inc2)
    c3, u3 = assign.schedule_batch(arr2, cfg)
    check(torch.equal(c2, c3) and torch.equal(u2, u3), "warm cycle: class-wave route != per-pod route")
    print(f"[north-star-waves] warm cycle: {dirty} dirty columns patched ({len(cols)} in the list) == a full "
          f"hoist == plain, {kp_ms:.4f} ms with the copy of the resident pair; route == per-pod route "
          f"({int((c2[:n] >= 0).sum())} scheduled)", flush=True)
    common = dict(route="cuda", library_ms=None)
    return [
        dict(name="class_static_hoist", source="kubernetes_tpu_torch/csrc/class_hoist.cu",
             replaces="kubernetes_tpu/ops/incremental.py:146", launches=launches["class_static_hoist"],
             max_abs_err=k3_err, ms=k3_ms, plain_ms=k3_plain, bound_ms=k3_bound, bound_by=k3_by, **common),
        dict(name="class_usage_hoist", source="kubernetes_tpu_torch/csrc/class_hoist.cu",
             replaces="kubernetes_tpu/ops/incremental.py:188", launches=launches["class_usage_hoist"],
             max_abs_err=k4_err, ms=k4_ms, plain_ms=k4_plain, bound_ms=k4_bound, bound_by=k4_by,
             patch_ms=kp_ms, **common),
        dict(name="wave_commit", source="kubernetes_tpu_torch/csrc/wave_commit.cu",
             replaces="kubernetes_tpu/ops/assign.py:530", launches=launches["wave_commit"],
             max_abs_err=k5_err, ms=k5_ms, plain_ms=k5_plain, bound_ms=k5_bound, bound_by=k5_by, **common),
        dict(name="chunk_rounds", source="kubernetes_tpu_torch/csrc/chunk_rounds.cu",
             replaces="kubernetes_tpu/ops/assign.py:1093", launches=launches["chunk_rounds"],
             max_abs_err=k6_err, ms=k6_ms, plain_ms=k6_plain, bound_ms=k6_bound, bound_by=k6_by,
             plain_scope=f"first {WAVE_PREFIX_CHUNKS} chunks", all_chunks_ms=k6_full_ms, **common),
    ]


def dense_scored_pairs(arr, sfs, choices) -> int:
    """(pod, node) pairs the dense hoist scores: static bit set and fit
    against the usage at the pod's chunk start (rebuilt from the choices)."""
    import torch

    from kubernetes_tpu_torch.ops import assign, bitplane

    C = assign.CHUNK
    used = arr.node_used.clone()
    total = 0
    for c0 in range(0, arr.P, C):
        req = arr.pod_req[c0:c0 + C]
        sf = bitplane.unpack(sfs[c0:c0 + C], arr.N)
        fit = ((req[:, None, :] == 0) | (req[:, None, :] <= (arr.node_alloc - used)[None])).all(dim=2)
        total += int((sf & fit).sum())
        ch = choices[c0:c0 + C].to(torch.int64)
        m = ch >= 0
        used.index_add_(0, ch[m], req[m])
    return total


def phase_north_star_dense() -> list:
    import torch

    from kubernetes_tpu_torch.api.delta import DeltaEncoder
    from kubernetes_tpu_torch.bench import workloads
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, infer_score_config, kernels

    snap = workloads.heterogeneous(**workloads.NORTH_STAR)
    enc = DeltaEncoder()
    t0 = time.perf_counter()
    host, meta = enc.encode(snap)
    t1 = time.perf_counter()
    arr, meta = enc.to_device(host, meta)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    print(f"[north-star-dense] cold DeltaEncoder encode_s {encode_s:.3f}: host encode {t1 - t0:.3f} s, "
          f"to_device {encode_s - (t1 - t0):.3f} s", flush=True)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    P, N, R = arr.P, arr.N, arr.R
    W = -(-N // 32)
    n = meta.n_pods

    def digest(x):
        return hashlib.sha256(x[:n].cpu().numpy().astype("<i4").tobytes()).hexdigest()

    # --- the dense route, counted ---
    kernels.reset_launches()
    t0 = time.perf_counter()
    choices, used, ords, sweeps = assign.schedule_batch_ordinals(arr, cfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.LAUNCHES.items() if k in DENSE_KERNELS}
    check(all(v > 0 for v in launches.values()), f"a kernel of the dense route was not launched: {launches}")
    check(sum(kernels.LAUNCHES.values()) == sum(launches.values()), f"dense route launches {kernels.LAUNCHES}")
    scheduled = int((choices[:n] >= 0).sum())
    print(f"[north-star-dense] schedule_batch_ordinals (dense) "
          f"{first_s:.3f} s (first call): scheduled {scheduled}/{n}, sweeps {sweeps}, choices sha256 "
          f"{digest(choices)}, ordinals sha256 {digest(ords)}, launches {launches}", flush=True)
    check(scheduled == workloads.NORTH_STAR_SCHEDULED, "dense: scheduled count")
    check(digest(choices) == workloads.NORTH_STAR_CHOICES_SHA256, "dense: choices differ from JAX")
    check(sweeps == workloads.NORTH_STAR_DENSE_SWEEPS, f"dense: sweeps {sweeps}")
    check(digest(ords) == workloads.NORTH_STAR_DENSE_ORDINALS_SHA256, "dense: ordinals differ from JAX")
    step_dense_s = float("inf")
    for _ in range(3):  # bench.py's step_dense_s: the best of three
        t0 = time.perf_counter()
        c2, _ = assign.schedule_batch(arr, cfg)
        torch.cuda.synchronize()
        step_dense_s = min(step_dense_s, time.perf_counter() - t0)
    check(torch.equal(c2, choices), "dense: a repeated step differs")

    # --- K7 against plain over all [P, W] ---
    sfs = kernels.packed_static_rows(arr)
    sfs_p = assign.packed_static_rows_plain(arr)
    k7_err = mismatch(sfs, sfs_p)
    check(k7_err == 0, f"north-star: packed_static_rows != plain ({k7_err} words)")
    k7_ms = cuda_ms(lambda: kernels.packed_static_rows(arr), reps=10, warmup=2)
    k7_plain = cuda_ms(lambda: assign.packed_static_rows_plain(arr), reps=2)
    T, TT = arr.node_taint_ns.shape[1], arr.pod_terms.shape[1]
    S, E_, L = arr.sel_mask.shape
    k7_bytes = N * (1 + T + L) + P * (1 + T + 4 + 4 * TT + 1) + S * E_ * L + 4 * S * E_ + 4 * P * W
    k7_bound, k7_by = bound(k7_bytes, P * N * (3 + T + TT))
    print(f"[north-star-dense] packed_static_rows == plain over [{P}, {W}]: {k7_ms:.4f} ms, plain "
          f"{k7_plain:.3f} ms, bound {k7_bound:.4f} ms ({k7_by}: {k7_bytes} B)", flush=True)

    # --- K8 over all chunks, then against plain on the first chunks ---
    out = {}

    def run_k8():
        out["k"] = kernels.chunk_rounds_dense(arr, cfg, sfs)

    k8_ms = cuda_ms(run_k8, reps=3)
    ck = out["k"]
    check(torch.equal(ck[0], choices) and torch.equal(ck[2], ords), "dense: timed chunk_rounds_dense != route")
    npre = DENSE_PREFIX_CHUNKS * assign.CHUNK
    pre = arr.pod_prefix(npre)
    kp = kernels.chunk_rounds_dense(pre, cfg, sfs[:npre].contiguous())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pp = assign.schedule_scan_chunked_dense_plain(pre, cfg, sfs_p[:npre])
    torch.cuda.synchronize()
    k8_plain = (time.perf_counter() - t0) * 1e3
    k8_err = sum(mismatch(a, b) for a, b in zip(kp[:3], pp[:3])) + abs(kernels.read_sweeps(kp[3]) - pp[3])
    check(k8_err == 0, f"north-star: chunk_rounds_dense != plain on the first {DENSE_PREFIX_CHUNKS} chunks")
    check(torch.equal(kp[0], choices[:npre]) and torch.equal(kp[2], ords[:npre]), "dense prefix != full run")
    k8_pre_ms = cuda_ms(lambda: kernels.chunk_rounds_dense(pre, cfg, sfs[:npre].contiguous()), reps=5)
    scored = dense_scored_pairs(arr, sfs, choices)
    per_score = f32_ops_per_scored_node(cfg)
    k8_bytes = 4 * P * W + 4 * P * R + P + 3 * 4 * N * R + 2 * 4 * P
    # the hoist's fit test over every (pod, node), each scored pair's score,
    # and one list selection per pod over its row
    k8_ops = P * N * R + scored * per_score + P * N
    k8_bound, k8_by = bound(k8_bytes, k8_ops)
    print(f"[north-star-dense] chunk_rounds_dense == plain on the first {DENSE_PREFIX_CHUNKS} chunks "
          f"({pp[3]} rounds): {k8_pre_ms:.3f} ms, plain {k8_plain:.1f} ms (host clock); all {P // assign.CHUNK} "
          f"chunks ({sweeps} rounds): {k8_ms:.3f} ms ({k8_ms / (P // assign.CHUNK) * 1e3:.1f} us per chunk), "
          f"bound {k8_bound:.4f} ms ({k8_by}: {k8_bytes} B, {scored} scored pairs x {per_score} + "
          f"{P * N * (R + 1)} ops); step_dense_s {step_dense_s:.4f} (best of 3)", flush=True)
    common = dict(route="cuda", library_ms=None)
    return step_dense_s, (choices, meta), [
        dict(name="packed_static_rows", source="kubernetes_tpu_torch/csrc/class_hoist.cu",
             replaces="kubernetes_tpu/ops/filters.py:92", launches=launches["packed_static_rows"],
             max_abs_err=k7_err, ms=k7_ms, plain_ms=k7_plain, bound_ms=k7_bound, bound_by=k7_by, **common),
        dict(name="chunk_rounds_dense", source="kubernetes_tpu_torch/csrc/chunk_rounds_dense.cu",
             replaces="kubernetes_tpu/ops/assign.py:1418", launches=launches["chunk_rounds_dense"],
             max_abs_err=k8_err, ms=k8_ms, plain_ms=k8_plain, bound_ms=k8_bound, bound_by=k8_by,
             plain_scope=f"first {DENSE_PREFIX_CHUNKS} chunks", prefix_ms=k8_pre_ms, **common),
    ]


def phase_warm_loop(cold) -> dict:
    """bench.py:283-327 at both depths; `cold` is the dense step's (choices,
    meta) of wave 1, whose decisions are the class-wave step's."""
    import torch

    from kubernetes_tpu_torch.api.delta import DeltaEncoder
    from kubernetes_tpu_torch.api.snapshot import Snapshot
    from kubernetes_tpu_torch.bench import workloads
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.parallel.pipeline import PipelinedBatchLoop

    snap = workloads.heterogeneous(**workloads.NORTH_STAR)
    choices, meta = cold
    first = workloads.verdicts_of(choices.cpu().numpy(), meta)
    names = [nd.name for nd in snap.nodes]
    res = {}
    for depth in (1, 0):
        enc = DeltaEncoder()
        enc.encode_device(snap)  # the cold encode the loop's encoder carries on from, as in bench.py
        torch.cuda.synchronize()
        loop = PipelinedBatchLoop(encoder=enc, depth=depth)
        kernels.reset_launches()
        waves, fetched, walls, submits = workloads.warm_waves(snap, first, loop.submit, loop.drain, Snapshot)
        torch.cuda.synchronize()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        digests = {w: workloads.wave_digest(waves[w], fetched[w], names) for w in sorted(fetched) if w >= 2}
        actions = [h["action"] for h in loop.hoist.history]
        steady = sorted(walls[2:])
        end_to_end_s = steady[len(steady) // 2]  # bench.py:377-379
        delta_s = loop.host_seconds["encode"][0] / max(1, len(walls))
        overlap = loop.overlap_fraction()
        sched = [sum(1 for v in fetched[w].values() if v) for w in sorted(digests)]
        print(f"[warm-loop] depth {depth}: walls {[round(x, 4) for x in walls]}, end_to_end_s {end_to_end_s:.4f} "
              f"(median of the steady walls), delta_s {delta_s:.4f} (encode + dispatch per cycle), "
              f"overlap_fraction {overlap:.3f}, host seconds {loop.host_seconds}, encoder {enc.stats}, "
              f"scheduled {sched}, launches {launches}", flush=True)
        cycles = len(walls)
        split = {k: round(v / cycles, 4) for k, v in loop.phase_seconds.items()}
        caller = sum(a - b for a, b in zip(walls, submits)) / cycles
        print(f"[warm-loop] depth {depth}: per cycle, host seconds: caller feedback (mk_wave + place) "
              f"{caller:.4f}, in submit {sum(submits) / cycles:.4f} = {split}", flush=True)
        for w in sorted(digests):
            print(f"[warm-loop] depth {depth} wave {w}: HoistCache {actions[w - 2]} "
                  f"(patched columns {loop.hoist.history[w - 2]['patched_cols']}), choices {digests[w]}", flush=True)
        check(digests == workloads.NORTH_STAR_WARM_DIGESTS, f"warm loop depth {depth}: choices differ from JAX")
        check(actions == workloads.NORTH_STAR_WARM_ACTIONS, f"warm loop depth {depth}: HoistCache actions {actions}")
        check(enc.stats["delta"] >= 3, f"delta path did not engage: {enc.stats}")
        check(all(x == workloads.NORTH_STAR_SCHEDULED for x in sched), f"warm loop: scheduled {sched}")
        for k in WAVE_KERNELS:
            check(launches.get(k, 0) > 0, f"warm loop depth {depth}: {k} was not launched: {launches}")
        res[depth] = dict(digests=digests, end_to_end_s=end_to_end_s, delta_s=delta_s, overlap=overlap,
                          walls=walls)
    check(res[0]["digests"] == res[1]["digests"], "warm loop: depth 0 != depth 1")
    check(res[0]["overlap"] == 0.0, f"warm loop: overlap_fraction {res[0]['overlap']} at depth 0")
    check(res[1]["overlap"] > 0.0, "warm loop: nothing overlapped at depth 1")
    return res


def phase_wide_planes() -> list:
    import torch

    from kubernetes_tpu_torch.api.delta import DeltaEncoder
    from kubernetes_tpu_torch.bench import workloads
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, bitplane, infer_score_config, kernels, schedule_batch

    snap = workloads.wide_taints(**workloads.WIDE_TAINTS)
    enc = DeltaEncoder()
    host, meta = enc.encode(snap)
    kernels.reset_launches()
    arr, meta = enc.to_device(host, meta)
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES["unpack_planes"]
    check(launches == 2, f"wide planes: unpack_planes launched {launches} times (node_taint_ns, pod_tol_ns)")
    for name in ("node_taint_ns", "pod_tol_ns"):
        check(torch.equal(getattr(arr, name).cpu(), torch.from_numpy(getattr(host, name))),
              f"wide planes: {name} unpacked != host")
    words = torch.from_numpy(bitplane.np_pack_lastaxis(host.pod_tol_ns).view("int32")).cuda()
    n_w = host.pod_tol_ns.shape[1]
    k9_err = mismatch(kernels.unpack_planes(words, n_w), bitplane.unpack(words, n_w))
    check(k9_err == 0, "wide planes: unpack_planes != plain")
    k9_ms = cuda_ms(lambda: kernels.unpack_planes(words, n_w), reps=50, warmup=3)
    k9_plain = cuda_ms(lambda: bitplane.unpack(words, n_w), reps=10)
    rows = words.shape[0]
    k9_bytes = rows * (4 * words.shape[1] + n_w)
    k9_bound, k9_by = bound(k9_bytes, rows * n_w)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    choices, _ = schedule_batch(arr, cfg)
    c = choices[: meta.n_pods].cpu().numpy().astype("<i4")
    scheduled = int((c >= 0).sum())
    check(scheduled == workloads.WIDE_TAINTS_SCHEDULED, f"wide planes: scheduled {scheduled}")
    check(hashlib.sha256(c.tobytes()).hexdigest() == workloads.WIDE_TAINTS_CHOICES_SHA256,
          "wide planes: choices differ from JAX")
    print(f"[wide-planes] {len(snap.nodes)} nodes, {meta.n_pods} pods, {n_w} hard taints: node_taint_ns "
          f"{tuple(arr.node_taint_ns.shape)} and pod_tol_ns {tuple(arr.pod_tol_ns.shape)} sent packed, "
          f"unpack_planes x{launches} == host == plain; scheduled {scheduled}/{meta.n_pods}, choices == JAX; "
          f"unpack_planes [{rows}, {n_w}]: {k9_ms:.4f} ms, plain {k9_plain:.4f} ms, bound {k9_bound:.6f} ms "
          f"({k9_by}: {k9_bytes} B)", flush=True)
    return [dict(name="unpack_planes", route="cuda", source="kubernetes_tpu_torch/csrc/unpack_planes.cu",
                 replaces="kubernetes_tpu/api/delta.py:922", launches=launches, max_abs_err=k9_err, ms=k9_ms,
                 plain_ms=k9_plain, bound_ms=k9_bound, bound_by=k9_by, library_ms=None)]


def choices_used(arr, choices, k: int):
    """node_used after the first k pods' placements."""
    import torch

    used = arr.node_used.clone()
    c = choices[:k].to(torch.int64)
    m = c >= 0
    used.index_add_(0, c[m], arr.pod_req[:k][m])
    return used


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "kubernetes_tpu_torch")):
        print("chip_smoke: kubernetes_tpu_torch is not beside this script", file=sys.stderr)
        return 2
    card, name = phase_card()
    phase_build()
    phase_mixed()
    step_s, rows = phase_north_star()
    phase_waves_mixed()
    rows += phase_north_star_waves(step_s)
    step_dense_s, cold, dense_rows = phase_north_star_dense()
    rows += dense_rows
    phase_warm_loop(cold)
    rows += phase_wide_planes()
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
