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


def _build_phase_lib():
    """Compile the instrumented library into the build directory; -> the
    loaded library with ktt_wave_commit bound as the wrapper binds it."""
    from ..ops import kernels

    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = kernels.BUILD_DIR / "libwave_commit-phases.so"
    proc = subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-DKTT_WAVE_PHASES", "-o", str(out),
         str(kernels.CSRC / "wave_commit.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    kernels.build(["wave_commit", "class_static_hoist"])  # in parallel with the nvcc above
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for wave_commit.cu -DKTT_WAVE_PHASES:\n{log}")
    lib = ctypes.CDLL(str(out))
    sym, argtypes = kernels._ARGTYPES["wave_commit"]
    fn = getattr(lib, sym)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    lib.ktt_wave_phases.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.ktt_wave_phases.restype = ctypes.c_int
    return lib, fn


def _read_phases(lib):
    cycles = np.zeros(len(PHASES), dtype=np.uint64)
    hits = np.zeros(len(PHASES), dtype=np.uint64)
    err = lib.ktt_wave_phases(cycles.ctypes.data, hits.ctypes.data)
    if err != 0:
        raise RuntimeError(f"ktt_wave_phases failed: cudaError {err}")
    return cycles, hits


def main() -> int:
    import torch

    from ..api.snapshot import encode_snapshot
    from ..ops import DEFAULT_SCORE_CONFIG, infer_score_config, kernels
    from ..ops.incremental import HoistCache
    from . import workloads

    if not torch.cuda.is_available():
        print("wave_phases: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    lib, phase_fn = _build_phase_lib()
    normal_fn = kernels._fn("wave_commit")

    arr, meta = encode_snapshot(workloads.heterogeneous(**workloads.NORTH_STAR))
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    inc = HoistCache().ensure(arr, meta, cfg)

    def timed(fn):
        """(outputs of the last launch, mean ms over REPS) of the wrapper
        with `fn` as its C entry, after one warm-up launch."""
        kernels._FNS["wave_commit"] = fn
        try:
            out = kernels.wave_commit(arr, inc, cfg)
            torch.cuda.synchronize()
            if fn is phase_fn:
                _read_phases(lib)  # drop the warm-up's counts
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                out = kernels.wave_commit(arr, inc, cfg)
            end.record()
            torch.cuda.synchronize()
            return out, start.elapsed_time(end) / REPS
        finally:
            kernels._FNS["wave_commit"] = normal_fn

    ref, ms_normal_a = timed(normal_fn)
    got, ms_phases = timed(phase_fn)
    cycles, hits = _read_phases(lib)
    _, ms_normal_b = timed(normal_fn)
    for name, a, b in zip(("committed", "out", "ordinal", "used", "t0u", "n_blocks", "epochs"), ref, got):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            raise RuntimeError(f"the instrumented wave_commit's {name} differs from the normal build's")
    n_blocks, epochs = int(ref[5]), int(ref[6])
    per_launch = cycles.astype(np.float64) / REPS
    total = float(per_launch.sum())
    rows = {}
    print(f"[wave-phases] {card} | north star P={arr.P} N={arr.N} U1={inc.req_u.shape[0]}: {n_blocks} blocks, "
          f"{epochs} epochs; instrumented {ms_phases:.3f} ms, normal {ms_normal_a:.3f} / {ms_normal_b:.3f} ms "
          f"(before / after), block 0's cycles per launch {total:.0f}", flush=True)
    for i, (name, what) in enumerate(PHASES):
        share = per_launch[i] / total
        n = int(hits[i]) // REPS
        rows[name] = dict(cycles=per_launch[i], share=share, ms=share * ms_phases, runs=n,
                          us_per_run=share * ms_phases * 1e3 / n if n else None)
        print(f"[wave-phases] {name:9s} {share * 100:6.2f}%  {share * ms_phases:9.3f} ms  runs {n:5d}  "
              f"{(share * ms_phases * 1e3 / n) if n else 0.0:8.2f} us per run  -- {what}", flush=True)
    print(json.dumps(dict(card=card, n_blocks=n_blocks, epochs=epochs, ms_instrumented=ms_phases,
                          ms_normal=[ms_normal_a, ms_normal_b], phases=rows)), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
