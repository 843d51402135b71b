"""Where wave_commit's time goes, phase by phase, on one card.

    python3 -m kubernetes_tpu_torch.bench.wave_phases [--parent DIR]

Builds csrc/wave_commit.cu a second time with -DKTT_WAVE_PHASES: thread 0
of block 0 then adds the SM cycles (clock64) between the loop's phase
boundaries into device counters.  Runs that build through the usual
wrapper on the north-star wave (heterogeneous(20000, 50000, seed=0),
HoistCache.ensure, the default knobs) and on BASELINE config 5's
(gang(1000, 64, 2000, seed=0), U1=2001: the host fixpoint's one
iteration), checks its outputs equal the normal build's bit for bit, and
prints per phase: block 0's cycles per launch, their share of its total,
that share of the instrumented launch's time (CUDA events), and how often
the phase ran.  The normal build is timed in the same run, before and
after, so the counters' cost shows.  With --parent DIR (a directory
holding an earlier csrc/, e.g. `git archive` of a parent commit) the
earlier wave_commit.cu is built too, checked bit-equal, split by its own
phase enum, and timed against the current one in turns (old, new, new,
old).  Ends with one JSON line and the card's name and power limit as
nvidia-smi gives them.  Needs one card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

PHASES = (  # the order of the PH_* enum in csrc/wave_commit.cu
    ("prologue", "state init, t0u from the class planes"),
    ("refresh", "(A) per-class top-KW lists, grid-wide, and its barrier"),
    ("walk", "(B) block load, (C) pointer walk and settlement checks, the picked nodes' rows"),
    ("s2", "(D) the [E, E] s2 columns of the block's own classes"),
    ("certify", "(E) exclusive scan, (F) certification, commit"),
    ("fallback", "(G) the first uncertified pod's lexmax over its class row"),
    ("absorb", "(H) claims, loop control; block 0's share of the grid's s2 columns, fold and t0u patch"),
    ("barrier", "the two grid barriers that close each block"),
)
REPS = 3


def phase_names(src: Path):
    """The PH_* names of `src`'s phase enum, in order, lower-cased."""
    m = re.search(r"enum\s*\{([^}]*)\}", src.read_text())
    names = [t.strip() for t in m.group(1).split(",")] if m else []
    return tuple(n[3:].lower() for n in names if n.startswith("PH_") and n != "PH_N")


def build_variant(kernel: str, src: Path, define: str = "", reader: str = "", tag: str = "variant"):
    """Compile `src` (a source of `kernel`, the current one or an earlier
    copy) with -D`define` when given into the build directory, in parallel
    with the normal build; -> (the loaded library's `reader` entry or None,
    the C entry bound as the wrapper binds it)."""
    from ..ops import kernels

    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = kernels.BUILD_DIR / f"lib{src.stem}-{tag}.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, *([f"-D{define}"] if define else []), "-o", str(out), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    kernels.build()  # in parallel with the nvcc above
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src} -D{define}:\n{log}")
    lib = ctypes.CDLL(str(out))
    sym, argtypes = kernels._ARGTYPES[kernel]
    fn = getattr(lib, sym)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    read = None
    if reader:
        read = getattr(lib, reader)
        read.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        read.restype = ctypes.c_int
    return read, fn


def build_phase_lib(kernel: str, define: str, reader: str):
    """The current source of `kernel` built with its phase counters ->
    (reader, C entry)."""
    from ..ops import kernels

    return build_variant(kernel, kernels.CSRC / kernels.SOURCES[kernel], define, reader, "phases")


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


def same_outputs(ref, got, names, what: str) -> None:
    """Raise unless every output of `got` equals `ref`'s bit for bit."""
    import torch

    for name, a, b in zip(names, ref, got):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            raise RuntimeError(f"{what}'s {name} differs from the normal build's")


def split_cell(tag: str, kernel: str, run, outputs, phase, parent, extra: dict):
    """One cell: the normal build timed before and after the instrumented
    one, bit-equal outputs, the split; with `parent` = (phase reader, phase
    entry, entry, phase names) of an earlier source also its split and the
    two normal builds timed in turns (old, new, new, old)."""
    read, phase_fn, normal_fn, phases = phase
    ref, ms_a = timed(kernel, normal_fn, run)
    got, ms_phases = timed(kernel, phase_fn, run, read, len(phases))
    cycles, hits = read_phases(read, len(phases))
    _, ms_b = timed(kernel, normal_fn, run)
    same_outputs(ref, got, outputs, f"the instrumented {kernel}")
    print(f"[{tag}] instrumented {ms_phases:.3f} ms, normal {ms_a:.3f} / {ms_b:.3f} ms (before / after), "
          f"block 0's cycles per launch {float(cycles.sum()) / REPS:.0f}", flush=True)
    res = dict(extra, ms_instrumented=ms_phases, ms_normal=[ms_a, ms_b],
               phases=report(tag, phases, cycles, hits, ms_phases))
    if parent is not None:
        pread, pphase_fn, pfn, pnames = parent
        res["parent"] = {}
        if pread is not None:
            old, ms_pp = timed(kernel, pphase_fn, run, pread, len(pnames))
            pcycles, phits = read_phases(pread, len(pnames))
            same_outputs(ref, old, outputs, f"the earlier instrumented {kernel}")
            res["parent"] = dict(ms_instrumented=ms_pp,
                                 phases=report(tag + " old", [(n, "") for n in pnames], pcycles, phits, ms_pp))
        turns = []
        for who, fn in (("old", pfn), ("new", normal_fn), ("new", normal_fn), ("old", pfn)):
            out, ms = timed(kernel, fn, run)
            same_outputs(ref, out, outputs, f"the {who} {kernel}")
            turns.append((who, ms))
        old_ms = [ms for who, ms in turns if who == "old"]
        new_ms = [ms for who, ms in turns if who == "new"]
        print(f"[{tag}] in turns (old, new, new, old): "
              + ", ".join(f"{who} {ms:.3f} ms" for who, ms in turns)
              + f"; old mean {sum(old_ms) / 2:.3f}, new mean {sum(new_ms) / 2:.3f} ms", flush=True)
        res["parent"]["turns"] = turns
    return res


def variants(kernel: str, define: str, reader: str, parent_dir, phases):
    """(phase, parent) for split_cell: the current source's phase build,
    normal entry and `phases` (its tool's PHASES), and the earlier source's
    under `parent_dir`/csrc when given, with the names of its own enum."""
    from ..ops import kernels

    read, phase_fn = build_phase_lib(kernel, define, reader)
    phase = (read, phase_fn, kernels._fn(kernel), phases)
    parent = None
    if parent_dir:
        psrc = Path(parent_dir) / "csrc" / kernels.SOURCES[kernel]
        if not psrc.exists():
            psrc = Path(parent_dir) / kernels.SOURCES[kernel]
        pread = pphase_fn = None
        if define in psrc.read_text():  # an earlier source without the counters is only timed
            pread, pphase_fn = build_variant(kernel, psrc, define, reader, "parent-phases")
        _, pfn = build_variant(kernel, psrc, tag="parent")
        parent = (pread, pphase_fn, pfn, phase_names(psrc))
    return phase, parent


def main(argv=None) -> int:
    import torch

    from ..api.delta import DeltaEncoder
    from ..api.snapshot import encode_snapshot
    from ..ops import DEFAULT_SCORE_CONFIG, infer_score_config, kernels
    from ..ops.incremental import HoistCache
    from . import workloads

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default="", help="a directory holding an earlier csrc/ to time in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wave_phases: no CUDA device", file=sys.stderr)
        return 2
    card = card_name()
    phase, parent = variants("wave_commit", "KTT_WAVE_PHASES", "ktt_wave_phases", args.parent, PHASES)
    names = ("committed", "out", "ordinal", "used", "t0u", "n_blocks", "epochs")
    cells = {  # as chip_smoke.py's [north-star-waves] and [config5] encode them
        "north-star": lambda: encode_snapshot(workloads.heterogeneous(**workloads.NORTH_STAR)),
        "config5": lambda: DeltaEncoder().encode_device(workloads.gang(**workloads.CONFIG5))}
    result = dict(card=card, cells={})
    for cell, make in cells.items():
        arr, meta = make()
        cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
        inc = HoistCache().ensure(arr, meta, cfg)

        def run():
            return kernels.wave_commit(arr, inc, cfg)

        ref = run()
        n_blocks, epochs = int(ref[5]), int(ref[6])
        U1 = inc.req_u.shape[0]
        print(f"[wave-phases {cell}] {card} | P={arr.P} N={arr.N} R={arr.R} U1={U1}: {n_blocks} blocks, "
              f"{epochs} epochs", flush=True)
        result["cells"][cell] = split_cell(f"wave-phases {cell}", "wave_commit", run, names, phase, parent,
                                           dict(P=arr.P, N=arr.N, U1=U1, n_blocks=n_blocks, epochs=epochs))
        del arr, inc, ref
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
