"""Where wave_commit's time goes, phase by phase, on one card.

    python3 -m kubernetes_tpu_torch.bench.wave_phases

Builds csrc/wave_commit.cu a second time with -DKTT_WAVE_PHASES: thread 0
of block 0 then adds the SM cycles (clock64) between the loop's phase
boundaries into device counters.  Runs that build on the north-star wave
(heterogeneous(20000, 50000, seed=0), HoistCache.ensure, the default knobs)
through the usual wrapper, checks its outputs equal the normal build's bit
for bit, and prints per phase: block 0's cycles per launch, their share of
its total, that share of the instrumented launch's time (CUDA events), and
how often the phase ran.  The normal build is timed in the same run, before
and after, so the counters' cost shows.  Ends with one JSON line and the
card's name and power limit as nvidia-smi gives them.  Needs one card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np

PHASES = (  # the order of the PH_* enum in csrc/wave_commit.cu
    ("prologue", "state init, t0u from the class planes"),
    ("refresh", "(A) per-class top-KW lists, grid-wide, and its barrier"),
    ("walk", "(B) block load, (C) pointer walk and settlement checks"),
    ("s2", "(D) the [U1, E] post-placement columns"),
    ("certify", "(E) exclusive scan, (F) certification, commit"),
    ("fallback", "(G) the N-wide rescore of the first uncertified pod"),
    ("absorb", "(H) claims, register fold, t0u patch, loop control"),
    ("barrier", "the grid barrier that ends each block"),
)
REPS = 3


def build_phase_lib(kernel: str, define: str, reader: str):
    """Compile `kernel`'s source again with -D`define` (its phase counters)
    into the build directory, in parallel with the normal build; -> (the
    loaded library's `reader` entry, the C entry bound as the wrapper binds
    it)."""
    from ..ops import kernels

    src = kernels.CSRC / kernels.SOURCES[kernel]
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = kernels.BUILD_DIR / f"lib{src.stem}-phases.so"
    proc = subprocess.Popen([kernels._nvcc(), *kernels.NVCC_FLAGS, f"-D{define}", "-o", str(out), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    kernels.build()  # in parallel with the nvcc above
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src.name} -D{define}:\n{log}")
    lib = ctypes.CDLL(str(out))
    sym, argtypes = kernels._ARGTYPES[kernel]
    fn = getattr(lib, sym)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    read = getattr(lib, reader)
    read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    read.restype = ctypes.c_int
    return read, fn


def read_phases(read, n: int):
    """(cycles, hits) uint64[n] of the phase counters, which the read zeroes."""
    cycles = np.zeros(n, dtype=np.uint64)
    hits = np.zeros(n, dtype=np.uint64)
    err = read(cycles.ctypes.data, hits.ctypes.data)
    if err != 0:
        raise RuntimeError(f"reading the phase counters failed: cudaError {err}")
    return cycles, hits


def timed(kernel: str, fn, run, read=None, n_phases: int = 0, reps: int = REPS):
    """(outputs of the last call, mean ms over `reps`) of run() with `fn` as
    the wrapper's C entry for `kernel`, after one warm-up call (whose
    `n_phases` phase counts, with `read`, are dropped)."""
    import torch

    from ..ops import kernels

    normal = kernels._fn(kernel)
    kernels._FNS[kernel] = fn
    try:
        out = run()
        torch.cuda.synchronize()
        if read is not None:
            read_phases(read, n_phases)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = run()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end) / reps
    finally:
        kernels._FNS[kernel] = normal


def report(tag: str, phases, cycles, hits, ms_phases: float, reps: int = REPS) -> dict:
    """Print and return each phase's share of block 0's cycles and of the
    instrumented launch's time."""
    per_launch = cycles.astype(np.float64) / reps
    total = float(per_launch.sum())
    rows = {}
    for i, (name, what) in enumerate(phases):
        share = per_launch[i] / total
        n = int(hits[i]) // reps
        rows[name] = dict(cycles=per_launch[i], share=share, ms=share * ms_phases, runs=n,
                          us_per_run=share * ms_phases * 1e3 / n if n else None)
        print(f"[{tag}] {name:9s} {share * 100:6.2f}%  {share * ms_phases:9.3f} ms  runs {n:5d}  "
              f"{(share * ms_phases * 1e3 / n) if n else 0.0:8.2f} us per run  -- {what}", flush=True)
    return rows


def card_name() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"


def main() -> int:
    import torch

    from ..api.snapshot import encode_snapshot
    from ..ops import DEFAULT_SCORE_CONFIG, infer_score_config, kernels
    from ..ops.incremental import HoistCache
    from . import workloads

    if not torch.cuda.is_available():
        print("wave_phases: no CUDA device", file=sys.stderr)
        return 2
    card = card_name()
    read, phase_fn = build_phase_lib("wave_commit", "KTT_WAVE_PHASES", "ktt_wave_phases")
    normal_fn = kernels._fn("wave_commit")

    arr, meta = encode_snapshot(workloads.heterogeneous(**workloads.NORTH_STAR))
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    inc = HoistCache().ensure(arr, meta, cfg)

    def run():
        return kernels.wave_commit(arr, inc, cfg)

    ref, ms_normal_a = timed("wave_commit", normal_fn, run)
    got, ms_phases = timed("wave_commit", phase_fn, run, read, len(PHASES))
    cycles, hits = read_phases(read, len(PHASES))
    _, ms_normal_b = timed("wave_commit", normal_fn, run)
    for name, a, b in zip(("committed", "out", "ordinal", "used", "t0u", "n_blocks", "epochs"), ref, got):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            raise RuntimeError(f"the instrumented wave_commit's {name} differs from the normal build's")
    n_blocks, epochs = int(ref[5]), int(ref[6])
    print(f"[wave-phases] {card} | north star P={arr.P} N={arr.N} U1={inc.req_u.shape[0]}: {n_blocks} blocks, "
          f"{epochs} epochs; instrumented {ms_phases:.3f} ms, normal {ms_normal_a:.3f} / {ms_normal_b:.3f} ms "
          f"(before / after), block 0's cycles per launch {float(cycles.sum()) / REPS:.0f}", flush=True)
    rows = report("wave-phases", PHASES, cycles, hits, ms_phases)
    print(json.dumps(dict(card=card, n_blocks=n_blocks, epochs=epochs, ms_instrumented=ms_phases,
                          ms_normal=[ms_normal_a, ms_normal_b], phases=rows)), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
