#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kubernetes_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds every kernel from csrc/ with nvcc, holds each against its plain
PyTorch version on a small mixed snapshot under all three fit strategies,
then runs the port's main path at the north-star shape,
heterogeneous(20000, 50000, seed=0) -> encode_snapshot -> schedule_batch
(P=51200, N=20480, R=5), and checks it: 50000 pods scheduled, the choices'
sha256 equal to the JAX package's recorded digest, kernel 1 equal to its
plain version over the whole [P, N], kernel 2 equal to its plain version on
the first 2048 pods and over all pods, and every kernel of the path launched
during the main path's run.  Times come from CUDA events after a warm-up.

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
    print(f"[build] {len(kernels.SOURCES)} kernel libraries in {dt:.2f} s", flush=True)


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

    # --- the main path, counted ---
    kernels.reset_launches()
    t0 = time.perf_counter()
    choices, used = schedule_batch(arr, cfg)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
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
    t0 = time.perf_counter()
    cp, up = schedule_scan_plain(arr, cfg, sf=sf)
    torch.cuda.synchronize()
    k2_plain_ms = (time.perf_counter() - t0) * 1e3
    k2_err = max(int((ck.long() - cp.long()).abs().max()), int((uk.long() - up.long()).abs().max()))
    check(k2_err == 0, "north-star: fit_scan kernel != plain over all pods")
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
    print(f"[north-star] fit_scan: kernel == plain over all {P} pods; kernel {k2_ms:.3f} ms "
          f"({k2_ms / P * 1e3:.3f} us per pod; with no feasible node {floor_ms:.3f} ms, "
          f"{floor_ms / P * 1e3:.3f} us per pod: the {P} block reductions and barriers), "
          f"plain {k2_plain_ms:.1f} ms (host clock), bound {k2_bound:.4f} ms ({k2_by}: {k2_bytes} B, "
          f"{n_scored} scored pairs x {f32_ops_per_scored_node(cfg)} f32 ops)", flush=True)
    return [
        dict(name="static_feasible", route="cuda", source="kubernetes_tpu_torch/csrc/static_feasible.cu",
             replaces="kubernetes_tpu/ops/filters.py:81", launches=launches["static_feasible"],
             max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain_ms, bound_ms=k1_bound, bound_by=k1_by,
             library_ms=None),
        dict(name="fit_scan", route="cuda", source="kubernetes_tpu_torch/csrc/fit_scan.cu",
             replaces="kubernetes_tpu/ops/assign.py:181", launches=launches["fit_scan"],
             max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain_ms, bound_ms=k2_bound, bound_by=k2_by,
             library_ms=None),
    ]


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
    rows = phase_north_star()
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
