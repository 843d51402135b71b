"""Build, load and launch the port's hand-written CUDA kernels.

Each source under csrc/ is compiled by nvcc for sm_90a (-fmad=false: no FMA
contraction, so f32 results match the plain versions bit for bit) into its
own shared library with a plain C interface, at first use, into _build/
(git-ignored); a library's name carries a digest of its source and of
every header under csrc/.  All nvcc processes start together.  The
libraries are loaded with ctypes; pointers and the stream go in as
c_void_p, score parameters as small host arrays.

Kernels (LAUNCHES keys) and their libraries: static_feasible and fit_scan
(the per-pod route, fit-only); class_static_hoist and class_usage_hoist
(K3, K4: class_hoist.cu), wave_commit (K5) and chunk_rounds (K6) (the
class-wave route); packed_static_rows (K7, class_hoist.cu) and
chunk_rounds_dense (K8) (the dense chunked route); unpack_planes (K9, the
encoder's packed transfers); score_planes (K10), full_scan (K11, the
per-pod route over the full stage set) and rounds (K12, the rounds route,
dense or class-row mode); K11 and K12 inline csrc/pairwise.cuh; K2 and
K11 on one device are one thread-block cluster each (SCAN_CLUSTER);
gang_quorum (K13, gang.cu: the gang fixpoint's quorum check and
revocation, one thread-block cluster, QUORUM_CLUSTER); explain_counts
(K14, explain.cu: the unschedulable diagnosis's reason counts) and
preempt_eval (K15, preempt.cu: the batched preemption evaluation, phases
A-C over a wave of preemptors); ring_match (K16, ring_match.cu: one hop of the ring matcher, parallel/ring.py) and
stitch_planes (K17, stitch_planes.cu: per-shard packed blocks -> the flat
packed layout, the node mesh's stitch, parallel/sharded.py).

The shard modes (the node mesh's per-pod and rounds routes,
parallel/sharded.py): fit_scan_shard (K2, fit_scan.cu), full_scan_shard
(K11, full_scan.cu) and rounds_shard (K12, rounds.cu) each take a table of
every shard's node-side pointers and run the one-device launch over every
shard's nodes on the card that holds every shard, each node read through
its shard's pointers: K2 and K11 one thread-block cluster (the run cut of
scan_runs, up to SCAN_CLUSTER blocks; LAST_CLUSTER holds the width), K12 a
cooperative launch of C clusters with the one-device scratch.  Each counts
under its own LAUNCHES key.  They refuse the gated mode, more than
MAX_SHARDS shards, more blocks than the card's SMs, and shards on more than
one card or rank (shard_grid_check, _shard_checks), naming ROADMAP.md queue
A12; a card that schedules no cluster fails the launch.

The gated mode.  The kernels of every route the gang fixpoint's device loop
takes (ops/gang.py) -- K1 static_feasible and K2 fit_scan, K7, K8, K11
full_scan, K12 rounds, K13 -- take an optional device ``done`` word that
makes a launch return at entry, so the loop queues its iterations without
reading anything back.  Torch operations between launches are not gated,
so K2, K8, K11, K12 and K13 also take ``out``: persistent output and
running-state buffers that only a launch which passed the gate writes, so
the last real iteration's result survives every gated one (and a queued
K13 call allocates nothing).  K2, K11 and K12 always write
such buffers (``fit_scan_out``, ``scan_out``; a fresh set when the caller
passes none) and always copy their start state (node_used, the pairwise
counts, the ports) into them themselves.

No wrapper reads anything back: the chunk-scan kernels leave their sweep
count and round-cap status in an int32[2] device pair, which read_sweeps
reads (and raises on) where the caller fetches the step.

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take, raises when the C entry returns a CUDA error, and
adds one to ``LAUNCHES[name]`` where it launches its kernel.  There is no
fallback: the plain versions run only for CPU tensors, and that dispatch
lives with the callers (ops/filters.py, ops/assign.py, ops/explain.py,
ops/preempt.py).
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from . import bitplane
from .assign import CHUNK, INC_CHUNK, SPEC_ITERS, WAVE_BLOCK, WAVE_ITERS, WAVE_K

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# kernel -> source (one library per source; class_hoist.cu holds two kernels)
SOURCES = {
    "static_feasible": "static_feasible.cu", "fit_scan": "fit_scan.cu",
    "class_static_hoist": "class_hoist.cu", "class_usage_hoist": "class_hoist.cu",
    "wave_commit": "wave_commit.cu", "chunk_rounds": "chunk_rounds.cu",
    "packed_static_rows": "class_hoist.cu", "chunk_rounds_dense": "chunk_rounds_dense.cu",
    "unpack_planes": "unpack_planes.cu", "score_planes": "score_planes.cu", "score_planes_f32": "score_planes.cu",
    "full_scan": "full_scan.cu", "rounds": "rounds.cu", "gang_quorum": "gang.cu",
    "explain_counts": "explain.cu", "preempt_eval": "preempt.cu",
    "ring_match": "ring_match.cu", "stitch_planes": "stitch_planes.cu",
    "fit_scan_shard": "fit_scan.cu", "full_scan_shard": "full_scan.cu", "rounds_shard": "rounds.cu",
}

# kernel -> the __global__ functions its launches run (the names a profiler
# trace shows, bench/profiling.py wrapper_of); K3 and K7 share theirs
GLOBAL_NAMES = {
    "static_feasible": ("setup_kernel", "rows_kernel"), "fit_scan": ("fit_scan_kernel",),
    "class_static_hoist": ("static_setup_kernel", "static_rows_kernel"),
    "class_usage_hoist": ("usage_full_kernel", "usage_patch_kernel"), "wave_commit": ("wave_commit_kernel",),
    "chunk_rounds": ("chunk_rounds_kernel",), "chunk_rounds_dense": ("chunk_rounds_dense_kernel",),
    "unpack_planes": ("unpack_planes_kernel",), "score_planes": ("score_planes_kernel",),
    "full_scan": ("full_scan_kernel",), "rounds": ("rounds_kernel",), "gang_quorum": ("gang_quorum_kernel",),
    "explain_counts": ("explain_kernel",), "preempt_eval": ("preempt_kernel",), "ring_match": ("ring_match_kernel",),
    "stitch_planes": ("stitch_kernel", "copy_kernel"),
}
GLOBAL_NAMES.update({"packed_static_rows": GLOBAL_NAMES["class_static_hoist"],
                     "score_planes_f32": GLOBAL_NAMES["score_planes"], "fit_scan_shard": GLOBAL_NAMES["fit_scan"],
                     "full_scan_shard": GLOBAL_NAMES["full_scan"], "rounds_shard": GLOBAL_NAMES["rounds"]})

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
# kernel -> (C entry, argtypes)
_ARGTYPES = {
    "static_feasible": ("ktt_static_feasible", [_P] * 13 + [_I] * 8 + [_P]),
    "fit_scan": ("ktt_fit_scan", [_P] * 6 + [_I, _U, _P, _I, _I, _F, _F, _I, _I, _I, _P, _P, _P, _I, _P, _I, _P, _P]),
    "class_static_hoist": ("ktt_class_static_hoist", [_P] * 15 + [_I] * 8 + [_P]),
    "class_usage_hoist": ("ktt_class_usage_hoist", [_P] * 4 + [_I] + [_P] * 6 + [_I] * 3 + [_P]),
    "wave_commit": ("ktt_wave_commit", [_P] * 24 + [_I] * 8 + [_P]),
    "chunk_rounds": ("ktt_chunk_rounds", [_P] * 24 + [_I] * 6 + [_P]),
    "packed_static_rows": ("ktt_packed_static_rows", [_P] * 16 + [_I] * 8 + [_P]),
    "chunk_rounds_dense": ("ktt_chunk_rounds_dense", [_P] * 17 + [_I] * 5 + [_P]),
    "unpack_planes": ("ktt_unpack_planes", [_P, _P, ctypes.c_longlong, _I, _I, _P]),
    "score_planes": ("ktt_score_planes", [_P] * 9 + [_I] * 7 + [_P]),
    "score_planes_f32": ("ktt_score_planes_f32", [_P] * 9 + [_I] * 7 + [_P]),
    "full_scan": ("ktt_full_scan", [_P] * 7 + [_I, _P, _P]),
    "rounds": ("ktt_rounds", [_P] * 10 + [_I, _I, _P]),
    "gang_quorum": ("ktt_gang_quorum", [_P] * 10 + [_I, _I, _I, _P, _P]),
    "explain_counts": ("ktt_explain_counts", [_P] * 17 + [_I] * 9 + [_P]),
    "preempt_eval": ("ktt_preempt_eval", [_P] * 18 + [_I] * 4 + [_P]),
    "ring_match": ("ktt_ring_match", [_P] * 4 + [_I] * 4 + [ctypes.c_longlong] * 2 + [_P]),
    "stitch_planes": ("ktt_stitch_planes", [_P, _P, ctypes.c_longlong, _I, _I, _P]),
    "fit_scan_shard": ("ktt_fit_scan_shard", [_P, _I, _I] + [_P] * 5 + [_I, _U, _P, _I, _I, _F, _F, _I, _I, _I]
                       + [_P, _P, _I, _P, _P]),
    "full_scan_shard": ("ktt_full_scan_shard", [_P] * 7 + [_I, _P, _I, _P, _P]),
    "rounds_shard": ("ktt_rounds_shard", [_P] * 7 + [_I, _I] + [_P] * 4 + [_I, _I, _P]),
}
STRATEGY_CODES = {"LeastAllocated": 0, "MostAllocated": 1, "RequestedToCapacityRatio": 2}
MAX_R, MAX_K, MAX_SHAPE = 32, 8, 16  # csrc/fit_scan.cu limits
# fit_scan double-buffers its run of two sf rows in shared memory: at a
# cluster of one block 2 * N bytes of the 227 KB a block may have, less what
# its static buffers take
MAX_SCAN_NODES = (232448 - 2048) // 2
# the per-pod scans K2 and K11 (csrc/fit_scan.cu, full_scan.cu), on one
# device and in shard mode, run as one thread-block cluster: the widest the
# card schedules up to the kernel's cap, 16 blocks for K2 (a non-portable
# size on an H100), 8 for K11 (three cluster barriers a pod: measured faster
# at 8 than at 16 on an H100, PERF.md); the C entries refuse more than
# MAX_CLUSTER.  LAST_CLUSTER holds the width of each launch's last call.
MAX_CLUSTER = 16
SCAN_CLUSTER: Dict[str, int] = {"fit_scan": 16, "full_scan": 8}
LAST_CLUSTER: Dict[str, int] = {"fit_scan": 0, "full_scan": 0, "fit_scan_shard": 0, "full_scan_shard": 0,
                                "gang_quorum": 0}
SCAN_UNIT = 16  # csrc/fit_scan.cu UNIT: a K2 run is whole units of 16 columns

# limits of the class-wave kernels (csrc/wave_commit.cu, topk.cuh): wave
# block <= 64 pods, candidate lists <= 256 entries.  wave_commit's shared
# memory (an N-int pod map, the packed claimed words, the block's lists)
# must fit a block's 227 KB: for a larger N its C entry returns the CUDA
# error of cudaFuncSetAttribute.
MAX_WAVE_BLOCK, MAX_WAVE_K = 64, 256

# launches per kernel since the last reset_launches()
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}
# nvcc's output per source built by this process (ptxas -v lines)
BUILD_LOG: Dict[str, str] = {}
_FNS: Dict[str, object] = {}
_LIBS: Dict[str, object] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (home and os.path.join(home, "bin", "nvcc"), shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA kernels cannot be built")


def build(names: Optional[Iterable[str]] = None) -> None:
    """Compile (if needed) and load the libraries of the named kernels (all
    when None), one per source; all nvcc processes run at once.  Raises with
    nvcc's output on a failed build."""
    names = list(SOURCES if names is None else names)
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    with _LOCK:
        todo = sorted({SOURCES[n] for n in names} - set(_LIBS))
        if not todo:
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        outs, procs = {}, {}
        for src_name in todo:
            src = CSRC / src_name
            digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
            out = BUILD_DIR / f"lib{src.stem}-{digest}.so"
            outs[src_name] = out
            if out.exists():
                continue
            tmp = BUILD_DIR / f".{out.name}.{os.getpid()}.tmp"
            procs[src_name] = (
                subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                ),
                tmp,
            )
        failed = []
        for src_name, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            BUILD_LOG[src_name] = log
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {src_name} (exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, outs[src_name])
        if failed:
            raise RuntimeError("\n".join(failed))
        for src_name in todo:
            _LIBS[src_name] = ctypes.CDLL(str(outs[src_name]))


def _fn(name: str):
    if name not in _FNS:
        build([name])
        sym, argtypes = _ARGTYPES[name]
        fn = getattr(_LIBS[SOURCES[name]], sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: Tuple[int, ...], device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _check_done(done: Optional[torch.Tensor], dev) -> None:
    if done is not None:
        _check(done, "done", torch.int32, (1,), dev)


def static_feasible(arr, done: Optional[torch.Tensor] = None, out: Optional[torch.Tensor] = None,
                    base: int = 0) -> torch.Tensor:
    """bool[P, N] static feasibility on the card (csrc/static_feasible.cu:
    a set-up launch over the node axis, then the row pass).  `done` (i32[1]
    on the card): both launches return at entry once it is set; `out`: the
    bool[P, N] buffer to write (a fresh one when None); `base`: the first
    global node id of arr's nodes (a node shard's; the nodeName pin is a
    global id).  The set-up's words live in a buffer kept per card and
    stream (_kept)."""
    dev = arr.device
    _need_cuda(dev, "static_feasible")
    P, N = arr.P, arr.N
    T = arr.node_taint_ns.shape[1]
    TT = arr.pod_terms.shape[1]
    S, E, L = arr.sel_mask.shape
    for name, dt, shape in (
        ("node_valid", torch.bool, (N,)), ("node_taint_ns", torch.bool, (N, T)),
        ("node_labels", torch.bool, (N, L)), ("pod_valid", torch.bool, (P,)),
        ("pod_tol_ns", torch.bool, (P, T)), ("pod_nodename", torch.int32, (P,)),
        ("pod_terms", torch.int32, (P, TT)), ("pod_has_sel", torch.bool, (P,)),
        ("sel_mask", torch.bool, (S, E, L)), ("sel_kind", torch.int32, (S, E)),
    ):
        _check(getattr(arr, name), name, dt, shape, dev)
    fn = _fn("static_feasible")
    if out is not None:
        _check(out, "out", torch.bool, (P, N), dev)
    _check_done(done, dev)
    sf = torch.empty((P, N), dtype=torch.bool, device=dev) if out is None else out
    with _on(dev):
        stream = _stream(dev)
        # csrc/static_feasible.cu's words: tmw [S, W], nw [W], orw [W, TW], ttw [32 TW, W]
        scratch = _kept("static_feasible", dev, stream, -(-N // 32) * (S + 1 + 33 * max(1, -(-T // 32))))
        err = fn(
            arr.node_valid.data_ptr(), arr.node_taint_ns.data_ptr(), arr.node_labels.data_ptr(),
            arr.pod_valid.data_ptr(), arr.pod_tol_ns.data_ptr(), arr.pod_nodename.data_ptr(),
            arr.pod_terms.data_ptr(), arr.pod_has_sel.data_ptr(), arr.sel_mask.data_ptr(),
            arr.sel_kind.data_ptr(), scratch.data_ptr(), sf.data_ptr(), _ptr(done), P, N, T, TT, S, E, L, base,
            stream,
        )
    _raise_on(err, "static_feasible")
    LAUNCHES["static_feasible"] += 1
    return sf


# buffers kept across calls, one per (kernel, card, stream): K1's set-up
# words, K14's accumulator; a launch on one stream never overlaps the next
_KEPT: Dict[Tuple[str, int, int], torch.Tensor] = {}


def _kept(name: str, dev, stream: int, n: int, zero: bool = False) -> torch.Tensor:
    """int32[>= n] on `dev` for `name`'s launches on `stream`: made once
    (zero-filled when `zero`) and kept, grown when a call needs more."""
    key = (name, dev.index, stream)
    buf = _KEPT.get(key)
    if buf is None or buf.numel() < n:
        buf = _KEPT[key] = (torch.zeros if zero else torch.empty)((max(1, n),), dtype=torch.int32, device=dev)
    return buf


@dataclasses.dataclass
class FitOut:
    """fit_scan's buffers: the choices, the running usage [R, Np] (Np: N
    padded to 16, for the kernel's int4 loads), the scored-pair count, and
    the inputs made once (allocatable [R, Np], score resource ids, the
    RequestedToCapacityRatio shape), so a queued launch of the gated mode
    needs no torch operation or host copy before it."""

    choices: torch.Tensor
    used_t: torch.Tensor
    n_scored: torch.Tensor
    alloc_t: torch.Tensor
    score_idx: torch.Tensor
    shape_xy: torch.Tensor


def _fit_checks(arr, cfg) -> int:
    """Check fit_scan's limits -> Np."""
    P, N, R = arr.P, arr.N, arr.R
    for name, dt, shape in (
        ("pod_req", torch.int32, (P, R)), ("pod_valid", torch.bool, (P,)),
        ("node_alloc", torch.int32, (N, R)), ("node_used", torch.int32, (N, R)),
    ):
        _check(getattr(arr, name), name, dt, shape, arr.device)
    if cfg.fit_strategy not in STRATEGY_CODES:
        raise ValueError(f"unknown fit scoringStrategy {cfg.fit_strategy!r}")
    K = len(cfg.score_resources)
    shape = cfg.rtcr_shape
    if R > MAX_R or not 1 <= K <= MAX_K or not 1 <= len(shape) <= MAX_SHAPE:
        raise ValueError(f"fit_scan kernel takes R <= {MAX_R}, 1 <= K <= {MAX_K}, "
                         f"1 <= shape points <= {MAX_SHAPE}; got R={R}, K={K}, {len(shape)}")
    if any(not 0 <= i < R for i in cfg.score_resources):
        raise ValueError(f"score_resources {cfg.score_resources} out of range for R={R}")
    Np = -(-N // 16) * 16  # the kernel moves sf rows in 16-byte pieces
    if Np > MAX_SCAN_NODES:
        raise ValueError(f"fit_scan kernel takes at most {MAX_SCAN_NODES} nodes, got {N}")
    return Np


def fit_scan_out(arr, cfg) -> FitOut:
    """fit_scan's buffers over `arr`."""
    dev = arr.device
    _need_cuda(dev, "fit_scan")
    Np = _fit_checks(arr, cfg)
    P, N, R = arr.P, arr.N, arr.R
    alloc_t = torch.zeros((R, Np), dtype=torch.int32, device=dev)
    alloc_t[:, :N] = arr.node_alloc.t()
    shape = cfg.rtcr_shape
    return FitOut(torch.full((P,), -1, dtype=torch.int32, device=dev),
                  torch.zeros((R, Np), dtype=torch.int32, device=dev),
                  torch.zeros((1,), dtype=torch.int64, device=dev), alloc_t,
                  torch.tensor(cfg.score_resources, dtype=torch.int32, device=dev),
                  torch.tensor([x for x, _ in shape] + [y for _, y in shape], dtype=torch.float32, device=dev))


def _cluster_arg(name: str, cluster: Optional[int]) -> int:
    kc = SCAN_CLUSTER[name] if cluster is None else int(cluster)
    if not 1 <= kc <= MAX_CLUSTER:
        raise ValueError(f"the per-pod scans take a cluster of 1..{MAX_CLUSTER} blocks, got {cluster}")
    return kc


def fit_scan(sf: torch.Tensor, arr, cfg, done: Optional[torch.Tensor] = None, out: Optional[FitOut] = None,
             cluster: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fit-only commit scan on the card (csrc/fit_scan.cu): one
    thread-block cluster, the widest the card schedules up to `cluster`
    blocks (SCAN_CLUSTER["fit_scan"] when None; LAST_CLUSTER["fit_scan"]
    the width launched).

    -> (choices i32[P], node_used i32[N, R] (a view of out.used_t), n_scored
    i64[1]: the number of (pod, node) pairs that passed fit and were
    scored).  The kernel copies arr.node_used into out.used_t itself.
    `done` (i32[1] on the card): the launch returns at entry once it is
    set; `out` (fit_scan_out): the buffers to write, a fresh set when None
    -- the gang fixpoint's gated mode passes the same set to every
    iteration, so a gated launch leaves the last real one's result."""
    dev = arr.device
    if dev.type != "cuda":
        raise ValueError(f"fit_scan kernel needs CUDA tensors, got {dev}")
    P, N, R = arr.P, arr.N, arr.R
    _check(sf, "sf", torch.bool, (P, N), dev)
    Np = _fit_checks(arr, cfg)
    _check_done(done, dev)
    max_kc = _cluster_arg("fit_scan", cluster)
    fn = _fn("fit_scan")
    K = len(cfg.score_resources)
    shape = cfg.rtcr_shape
    if out is None:
        out = fit_scan_out(arr, cfg)
    for name, t, dt, shp in (("choices", out.choices, torch.int32, (P,)),
                             ("used_t", out.used_t, torch.int32, (R, Np)),
                             ("n_scored", out.n_scored, torch.int64, (1,)),
                             ("alloc_t", out.alloc_t, torch.int32, (R, Np))):
        _check(t, name, dt, shp, dev)
    if Np != N:  # padding nodes have no sf bit set, so they are never chosen
        padded = torch.zeros((P, Np), dtype=torch.bool, device=dev)
        padded[:, :N] = sf
        sf = padded
    kc = ctypes.c_int(0)
    with _on(dev):
        err = fn(
            sf.data_ptr(), arr.pod_req.data_ptr(), arr.pod_valid.data_ptr(),
            out.alloc_t.data_ptr(), out.used_t.data_ptr(), out.score_idx.data_ptr(), K,
            sum(1 << i for i in set(cfg.score_resources)), out.shape_xy.data_ptr(), len(shape),
            STRATEGY_CODES[cfg.fit_strategy], float(cfg.fit_weight), float(cfg.balanced_weight), P, Np, R,
            out.choices.data_ptr(), out.n_scored.data_ptr(), arr.node_used.data_ptr(), N, _ptr(done), max_kc,
            ctypes.byref(kc), _stream(dev),
        )
    _raise_on(err, "fit_scan")
    LAUNCHES["fit_scan"] += 1
    LAST_CLUSTER["fit_scan"] = kc.value
    return out.choices, out.used_t[:, :N].t(), out.n_scored


# ---------------------------------------------------------------------------
# the class-wave route: K3 class_static_hoist, K4 class_usage_hoist,
# K5 wave_commit, K6 chunk_rounds
# ---------------------------------------------------------------------------

def _score_params(cfg, R: int):
    """(int32[11], float32[34]) host arrays for csrc/score.cuh
    make_score_params; raise on what the kernels do not take."""
    if cfg.fit_strategy not in STRATEGY_CODES:
        raise ValueError(f"unknown fit scoringStrategy {cfg.fit_strategy!r}")
    K = len(cfg.score_resources)
    shape = cfg.rtcr_shape
    if R > MAX_R or not 1 <= K <= MAX_K or not 1 <= len(shape) <= MAX_SHAPE:
        raise ValueError(f"the class-wave kernels take R <= {MAX_R}, 1 <= K <= {MAX_K}, "
                         f"1 <= shape points <= {MAX_SHAPE}; got R={R}, K={K}, {len(shape)}")
    if any(not 0 <= i < R for i in cfg.score_resources):
        raise ValueError(f"score_resources {cfg.score_resources} out of range for R={R}")
    ip = np.zeros(3 + MAX_K, dtype=np.int32)
    ip[:3] = (K, STRATEGY_CODES[cfg.fit_strategy], len(shape))
    ip[3:3 + K] = cfg.score_resources
    fp = np.zeros(2 + 2 * MAX_SHAPE, dtype=np.float32)
    fp[:2] = (cfg.fit_weight, cfg.balanced_weight)
    fp[2:2 + len(shape)] = [x for x, _ in shape]
    fp[2 + len(shape):2 + 2 * len(shape)] = [y for _, y in shape]
    return ip, fp


def _host(a: np.ndarray) -> int:
    return a.ctypes.data


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _need_cuda(dev, name: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, got {dev}")


def _on(dev):
    """torch.cuda.device(dev) where `dev` is not the current card, else no
    context at all (entering one costs host time on every call)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _static_scratch(S: int, N: int, T: int, rows: int, dev) -> tuple:
    """K3's and K7's scratch (csrc/class_hoist.cu static_plane): the term
    match words [S, W], the node words (node-valid [W], the OR of each node
    word's taints [W, TW], the transposed taint words [32 TW, W]) and the
    rows' toleration words [rows, TW]."""
    W, TW = -(-N // 32), max(1, -(-T // 32))
    return (torch.empty((S, W), dtype=torch.int32, device=dev),
            torch.empty((W * (1 + 33 * TW),), dtype=torch.int32, device=dev),
            torch.empty((rows, TW), dtype=torch.int32, device=dev))


def class_static_hoist(arr, r_u: torch.Tensor, with_elig: bool = False, base: int = 0):
    """K3 (csrc/class_hoist.cu): the packed class static plane int32 words
    [U1, ceil(N/32)] for the classes whose first pod rows are r_u (i64);
    with `with_elig` also the packed eligibility plane nodesel & node_valid
    -> (stat_u, elig_u).  `base`: the first global node id of arr's nodes (a
    node shard's; the nodeName pin is a global id)."""
    dev = arr.device
    _need_cuda(dev, "class_static_hoist")
    P, N = arr.P, arr.N
    T = arr.node_taint_ns.shape[1]
    TT = arr.pod_terms.shape[1]
    S, E, L = arr.sel_mask.shape
    U1 = r_u.shape[0]
    _check(r_u, "r_u", torch.int64, (U1,), dev)
    for name, dt, shape in (
        ("node_valid", torch.bool, (N,)), ("node_taint_ns", torch.bool, (N, T)),
        ("node_labels", torch.bool, (N, L)), ("pod_tol_ns", torch.bool, (P, T)),
        ("pod_nodename", torch.int32, (P,)), ("pod_terms", torch.int32, (P, TT)),
        ("pod_has_sel", torch.bool, (P,)), ("sel_mask", torch.bool, (S, E, L)),
        ("sel_kind", torch.int32, (S, E)),
    ):
        _check(getattr(arr, name), name, dt, shape, dev)
    fn = _fn("class_static_hoist")
    tm, taint_w, tol_w = _static_scratch(S, N, T, U1, dev)
    stat_u = torch.empty((U1, -(-N // 32)), dtype=torch.int32, device=dev)
    elig_u = torch.empty_like(stat_u) if with_elig else None
    with torch.cuda.device(dev):
        err = fn(
            arr.node_valid.data_ptr(), arr.node_taint_ns.data_ptr(), arr.node_labels.data_ptr(),
            arr.pod_tol_ns.data_ptr(), arr.pod_nodename.data_ptr(), arr.pod_terms.data_ptr(),
            arr.pod_has_sel.data_ptr(), arr.sel_mask.data_ptr(), arr.sel_kind.data_ptr(),
            r_u.data_ptr(), tm.data_ptr(), taint_w.data_ptr(), tol_w.data_ptr(), stat_u.data_ptr(),
            None if elig_u is None else elig_u.data_ptr(), U1, N, T, TT, S, E, L, base, _stream(dev),
        )
    _raise_on(err, "class_static_hoist")
    LAUNCHES["class_static_hoist"] += 1
    return (stat_u, elig_u) if with_elig else stat_u


def class_usage_hoist(req_u, node_used, node_alloc, cfg, cols=None, base_u=None, fit_u=None):
    """K4 (csrc/class_hoist.cu), one launch: -> (base_u f32[U1, N], fit_u
    int32 words [U1, W]).  With `cols` (i32, padded with the sentinel N; any
    order) only those columns are recomputed: the launch writes a NEW
    generation, the resident base_u / fit_u with those columns replaced,
    and never writes the resident buffers."""
    dev = node_used.device
    _need_cuda(dev, "class_usage_hoist")
    U1, R = req_u.shape
    N = node_used.shape[0]
    W = -(-N // 32)
    _check(req_u, "req_u", torch.int32, (U1, R), dev)
    _check(node_used, "node_used", torch.int32, (N, R), dev)
    _check(node_alloc, "node_alloc", torch.int32, (N, R), dev)
    ip, fp = _score_params(cfg, R)
    fn = _fn("class_usage_hoist")
    if cols is None:
        D, cols_ptr, base_in, fit_in = 0, None, None, None
    else:
        _check(cols, "cols", torch.int32, (cols.shape[0],), dev)
        _check(base_u, "base_u", torch.float32, (U1, N), dev)
        _check(fit_u, "fit_u", torch.int32, (U1, W), dev)
        D, cols_ptr, base_in, fit_in = cols.shape[0], cols.data_ptr(), base_u.data_ptr(), fit_u.data_ptr()
    base = torch.empty((U1, N), dtype=torch.float32, device=dev)
    fit = torch.empty((U1, W), dtype=torch.int32, device=dev)
    with _on(dev):
        err = fn(
            req_u.data_ptr(), node_used.data_ptr(), node_alloc.data_ptr(), cols_ptr, D, _host(ip), _host(fp),
            base_in, fit_in, base.data_ptr(), fit.data_ptr(), U1, N, R, _stream(dev),
        )
    _raise_on(err, "class_usage_hoist")
    LAUNCHES["class_usage_hoist"] += 1
    return base, fit


def _check_inc(arr, inc, dev) -> Tuple[int, int]:
    P, N, R = arr.P, arr.N, arr.R
    U1 = inc.req_u.shape[0]
    W = -(-N // 32)
    for name, t, dt, shape in (
        ("inc.cls", inc.cls, torch.int32, (P,)), ("inc.req_u", inc.req_u, torch.int32, (U1, R)),
        ("inc.stat_u", inc.stat_u, torch.int32, (U1, W)), ("inc.fit_u", inc.fit_u, torch.int32, (U1, W)),
        ("inc.base_u", inc.base_u, torch.float32, (U1, N)),
        ("pod_valid", arr.pod_valid, torch.bool, (P,)), ("pod_req", arr.pod_req, torch.int32, (P, R)),
        ("node_used", arr.node_used, torch.int32, (N, R)), ("node_alloc", arr.node_alloc, torch.int32, (N, R)),
    ):
        _check(t, name, dt, shape, dev)
    return U1, W


def wave_commit(arr, inc, cfg, wave_k: int = WAVE_K, wave_block: int = WAVE_BLOCK):
    """K5 (csrc/wave_commit.cu): the t0u prologue and the class-batched
    commit waves in one launch -> (committed bool[P], out i32[P], ordinal
    i32[P], used i32[N, R], t0u f32[U1, N], n_blocks, epochs), the last two
    0-d int32 device tensors (views of one [2] buffer)."""
    dev = arr.device
    _need_cuda(dev, "wave_commit")
    P, N, R = arr.P, arr.N, arr.R
    U1, _ = _check_inc(arr, inc, dev)
    E = min(wave_block, P)
    KW = min(wave_k, N)
    if not 1 <= E <= MAX_WAVE_BLOCK or not 1 <= KW <= MAX_WAVE_K:
        raise ValueError(f"wave_commit kernel takes 1 <= wave_block <= {MAX_WAVE_BLOCK}, "
                         f"1 <= wave_k <= {MAX_WAVE_K}; got {E}, {KW}")
    ip, fp = _score_params(cfg, R)
    fn = _fn("wave_commit")
    committed = torch.empty((P,), dtype=torch.bool, device=dev)
    out = torch.empty((P,), dtype=torch.int32, device=dev)
    ordn = torch.empty((P,), dtype=torch.int32, device=dev)
    used = torch.empty((N, R), dtype=torch.int32, device=dev)
    t0u = torch.empty((U1, N), dtype=torch.float32, device=dev)
    tv = torch.empty((U1, KW), dtype=torch.float32, device=dev)
    ti = torch.empty((U1, KW), dtype=torch.int32, device=dev)
    nf = torch.empty((U1,), dtype=torch.int32, device=dev)
    # the block record K5's block 0 leaves for the grid (csrc/wave_commit.cu
    # Rec); at least U1 * E words, the earlier design's s2 columns, which
    # bench/wave_phases.py --parent runs through this wrapper
    rec = torch.empty((max(U1 * E, 2 + 3 * E + E * R + R),), dtype=torch.int32, device=dev)
    bmax = torch.empty((U1,), dtype=torch.float32, device=dev)
    bnode = torch.empty((U1,), dtype=torch.int32, device=dev)
    ctrl = torch.zeros((2, 4), dtype=torch.int32, device=dev)  # by loop-step parity
    scal = torch.zeros((2,), dtype=torch.int32, device=dev)
    max_blocks = (P // E + 1) * 8 + 32
    with torch.cuda.device(dev):
        err = fn(
            inc.cls.data_ptr(), arr.pod_valid.data_ptr(), arr.pod_req.data_ptr(), arr.node_used.data_ptr(),
            inc.stat_u.data_ptr(), inc.fit_u.data_ptr(), inc.base_u.data_ptr(), arr.node_alloc.data_ptr(),
            inc.req_u.data_ptr(), committed.data_ptr(), out.data_ptr(), ordn.data_ptr(), used.data_ptr(),
            t0u.data_ptr(), tv.data_ptr(), ti.data_ptr(), nf.data_ptr(), rec.data_ptr(), bmax.data_ptr(),
            bnode.data_ptr(), ctrl.data_ptr(), scal.data_ptr(), _host(ip), _host(fp),
            P, N, R, U1, E, KW, WAVE_ITERS, max_blocks, _stream(dev),
        )
    _raise_on(err, "wave_commit")
    LAUNCHES["wave_commit"] += 1
    return committed, out, ordn, used, t0u, scal[0], scal[1]


def chunk_rounds(arr, inc, cfg, used_w, t0u_w, wave):
    """K6 (csrc/chunk_rounds.cu): stage B in one launch, chunks of
    INC_CHUNK pods, from the wave's usage and class rows (`wave` =
    (committed, out, ordinal, n_blocks) of wave_commit) or, with wave None,
    from the cycle start (used_w = arr.node_used, t0u_w None: the kernel
    builds t0u) -> (choices i32[P], used i32[N, R], ordinals i32[P], the
    int32[2] device pair (sweeps, status): read_sweeps).  Only the chunks
    the wave did not commit whole run rounds; when it committed every pod
    the launch is the JAX skip (the wave's decisions and usage).  Every
    round commits a pod, so a chunk takes at most INC_CHUNK rounds; the
    kernel stops a chunk past that cap and reports it in the status."""
    dev = arr.device
    _need_cuda(dev, "chunk_rounds")
    P, N, R = arr.P, arr.N, arr.R
    U1, _ = _check_inc(arr, inc, dev)
    C = INC_CHUNK
    if P % C:
        raise ValueError(f"chunk_rounds kernel takes chunks of {C} pods dividing P; got P={P}")
    _check(used_w, "used", torch.int32, (N, R), dev)
    if t0u_w is not None:
        _check(t0u_w, "t0u", torch.float32, (U1, N), dev)
    wptrs = [None, None, None, None]
    if wave is not None:
        wcom, wout, wordn, n_blocks = wave
        for name, t, dt in (("committed", wcom, torch.bool), ("out", wout, torch.int32),
                            ("ordinal", wordn, torch.int32)):
            _check(t, name, dt, (P,), dev)
        if n_blocks.dtype != torch.int32 or n_blocks.device != dev:
            raise ValueError("n_blocks: expected wave_commit's int32 device scalar")
        wptrs = [wcom.data_ptr(), wout.data_ptr(), wordn.data_ptr(), n_blocks.data_ptr()]
    ip, fp = _score_params(cfg, R)
    fn = _fn("chunk_rounds")
    K = min(C + 1, N)
    choices = torch.empty((P,), dtype=torch.int32, device=dev)
    used = torch.empty((N, R), dtype=torch.int32, device=dev)
    t0u = torch.empty((U1, N), dtype=torch.float32, device=dev)
    ords = torch.empty((P,), dtype=torch.int32, device=dev)
    scal = torch.empty((2,), dtype=torch.int32, device=dev)  # the kernel writes both on every path
    topv = torch.empty((C, K), dtype=torch.float32, device=dev)
    topi = torch.empty((C, K), dtype=torch.int32, device=dev)
    clist = torch.empty((P // C + 1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fn(
            arr.pod_req.data_ptr(), arr.pod_valid.data_ptr(), inc.cls.data_ptr(), arr.node_alloc.data_ptr(),
            inc.req_u.data_ptr(), inc.stat_u.data_ptr(), inc.fit_u.data_ptr(), inc.base_u.data_ptr(),
            used_w.data_ptr(), None if t0u_w is None else t0u_w.data_ptr(), *wptrs,
            choices.data_ptr(), used.data_ptr(), t0u.data_ptr(), ords.data_ptr(), scal.data_ptr(),
            topv.data_ptr(), topi.data_ptr(), clist.data_ptr(), _host(ip), _host(fp), P, N, R, U1, C, SPEC_ITERS,
            _stream(dev),
        )
    _raise_on(err, "chunk_rounds")
    LAUNCHES["chunk_rounds"] += 1
    return choices, used, ords, scal


def read_sweeps(scal: torch.Tensor) -> int:
    """The sweep count of a chunk-scan kernel's (sweeps, status) pair (one
    host synchronisation when it lies on the card).  Raises when a chunk
    exceeded its round cap: every round commits a pod, so that never
    happens on state the algorithm admits, and it never passes as
    unscheduled pods."""
    sweeps, capped = scal.tolist()
    if capped:
        raise RuntimeError("chunk scan: a chunk exceeded its round cap (every round commits a pod)")
    return sweeps


# ---------------------------------------------------------------------------
# the dense chunked route (K7 packed_static_rows, K8 chunk_rounds_dense) and
# the encoder's packed transfers (K9 unpack_planes)
# ---------------------------------------------------------------------------

def packed_static_rows(arr, with_elig: bool = False, done: Optional[torch.Tensor] = None,
                       out: Optional[torch.Tensor] = None, base: int = 0):
    """K7 (csrc/class_hoist.cu): static feasibility of every pod row,
    pod_valid included, as int32 words [P, ceil(N/32)] assembled word by
    word (no dense bool plane); with `with_elig` also the eligibility
    plane nodesel & node_valid -> (sfs, eligs).  `done` (i32[1] on the
    card): the launch returns at entry once it is set; `out`: the sfs
    buffer to write (a fresh one when None); `base`: the first global node
    id of arr's nodes (a node shard's)."""
    dev = arr.device
    _need_cuda(dev, "packed_static_rows")
    P, N = arr.P, arr.N
    T = arr.node_taint_ns.shape[1]
    TT = arr.pod_terms.shape[1]
    S, E, L = arr.sel_mask.shape
    for name, dt, shape in (
        ("node_valid", torch.bool, (N,)), ("node_taint_ns", torch.bool, (N, T)),
        ("node_labels", torch.bool, (N, L)), ("pod_valid", torch.bool, (P,)),
        ("pod_tol_ns", torch.bool, (P, T)), ("pod_nodename", torch.int32, (P,)),
        ("pod_terms", torch.int32, (P, TT)), ("pod_has_sel", torch.bool, (P,)),
        ("sel_mask", torch.bool, (S, E, L)), ("sel_kind", torch.int32, (S, E)),
    ):
        _check(getattr(arr, name), name, dt, shape, dev)
    fn = _fn("packed_static_rows")
    tm, taint_w, tol_w = _static_scratch(S, N, T, P, dev)
    W = -(-N // 32)
    if out is not None:
        _check(out, "out", torch.int32, (P, W), dev)
    if done is not None:
        _check(done, "done", torch.int32, (1,), dev)
    sfs = torch.empty((P, W), dtype=torch.int32, device=dev) if out is None else out
    eligs = torch.empty_like(sfs) if with_elig else None
    with torch.cuda.device(dev):
        err = fn(
            arr.node_valid.data_ptr(), arr.node_taint_ns.data_ptr(), arr.node_labels.data_ptr(),
            arr.pod_valid.data_ptr(), arr.pod_tol_ns.data_ptr(), arr.pod_nodename.data_ptr(),
            arr.pod_terms.data_ptr(), arr.pod_has_sel.data_ptr(), arr.sel_mask.data_ptr(),
            arr.sel_kind.data_ptr(), tm.data_ptr(), taint_w.data_ptr(), tol_w.data_ptr(), sfs.data_ptr(),
            None if eligs is None else eligs.data_ptr(), None if done is None else done.data_ptr(),
            P, N, T, TT, S, E, L, base, _stream(dev),
        )
    _raise_on(err, "packed_static_rows")
    LAUNCHES["packed_static_rows"] += 1
    return (sfs, eligs) if with_elig else sfs


def chunk_rounds_dense(arr, cfg, sfs: torch.Tensor, done: Optional[torch.Tensor] = None, out=None):
    """K8 (csrc/chunk_rounds_dense.cu): the dense chunked scan in one
    launch, chunks of CHUNK pods, from the cycle start's usage and K7's
    packed static plane -> (choices i32[P], used i32[N, R], ordinals i32[P],
    the int32[2] device pair (sweeps, status): read_sweeps).  `done` (i32[1]
    on the card): the launch returns at entry once it is set; `out`: the
    four output buffers to write (fresh ones when None; the kernel ORs its
    status into the pair's second word, so a round-cap hit in any launch
    over one pair survives until read_sweeps)."""
    dev = arr.device
    _need_cuda(dev, "chunk_rounds_dense")
    P, N, R = arr.P, arr.N, arr.R
    C = CHUNK
    if P % C:
        raise ValueError(f"chunk_rounds_dense kernel takes chunks of {C} pods dividing P; got P={P}")
    W = -(-N // 32)
    _check(sfs, "sfs", torch.int32, (P, W), dev)
    for name, dt, shape in (
        ("pod_req", torch.int32, (P, R)), ("pod_valid", torch.bool, (P,)),
        ("node_alloc", torch.int32, (N, R)), ("node_used", torch.int32, (N, R)),
    ):
        _check(getattr(arr, name), name, dt, shape, dev)
    ip, fp = _score_params(cfg, R)
    fn = _fn("chunk_rounds_dense")
    K = min(C + 1, N)
    if out is None:
        out = (torch.empty((P,), dtype=torch.int32, device=dev), torch.empty((N, R), dtype=torch.int32, device=dev),
               torch.empty((P,), dtype=torch.int32, device=dev), torch.zeros((2,), dtype=torch.int32, device=dev))
    choices, used, ords, scal = out
    for name, t, dt, shape in (("choices", choices, torch.int32, (P,)), ("used", used, torch.int32, (N, R)),
                               ("ordinals", ords, torch.int32, (P,)), ("scal", scal, torch.int32, (2,))):
        _check(t, name, dt, shape, dev)
    if done is not None:
        _check(done, "done", torch.int32, (1,), dev)
    # scratch (csrc/chunk_rounds_dense.cu): the masked scores of a chunk and
    # of the next; the lists, then the next chunk's stale top-(K + C) lists;
    # a chunk's dirty slots (count, nodes, usage; at least 2 W words, the
    # earlier design's node bitmaps, which bench/dense_phases.py --parent
    # runs through this wrapper)
    KL = min(K + C, N)
    total0 = torch.empty((2, C, N), dtype=torch.float32, device=dev)
    topv = torch.empty((C, K + KL), dtype=torch.float32, device=dev)
    topi = torch.empty((C, K + KL), dtype=torch.int32, device=dev)
    nf = torch.empty((C,), dtype=torch.int32, device=dev)
    dirty = torch.empty((max(2 * W, 1 + C + C * R),), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fn(
            arr.pod_req.data_ptr(), arr.pod_valid.data_ptr(), arr.node_alloc.data_ptr(), arr.node_used.data_ptr(),
            sfs.data_ptr(), choices.data_ptr(), used.data_ptr(), ords.data_ptr(), scal.data_ptr(),
            total0.data_ptr(), topv.data_ptr(), topi.data_ptr(), nf.data_ptr(), dirty.data_ptr(),
            None if done is None else done.data_ptr(), _host(ip), _host(fp), P, N, R, C, SPEC_ITERS, _stream(dev),
        )
    _raise_on(err, "chunk_rounds_dense")
    LAUNCHES["chunk_rounds_dense"] += 1
    return choices, used, ords, scal


def unpack_planes(words: torch.Tensor, n: int) -> torch.Tensor:
    """K9 (csrc/unpack_planes.cu): int32 words [..., ceil(n/32)] -> bool
    [..., n], the packed layout of ops/bitplane.py (a thread a half word,
    16-byte stores where a row's bytes are 16-aligned)."""
    dev = words.device
    _need_cuda(dev, "unpack_planes")
    W = -(-n // 32)
    if words.dtype != torch.int32 or words.shape[-1] != W or not words.is_contiguous():
        raise ValueError(f"unpack_planes: expected contiguous int32 words [..., {W}], got "
                         f"{words.dtype} {tuple(words.shape)}")
    fn = _fn("unpack_planes")
    out = torch.empty(tuple(words.shape[:-1]) + (n,), dtype=torch.bool, device=dev)
    rows = words.numel() // W if W else 0
    with _on(dev):
        err = fn(words.data_ptr(), out.data_ptr(), rows, W, n, _stream(dev))
    _raise_on(err, "unpack_planes")
    LAUNCHES["unpack_planes"] += 1
    return out


# ---------------------------------------------------------------------------
# the full stage set: K10 score_planes, K11 full_scan, K12 rounds
# ---------------------------------------------------------------------------

# csrc/pairwise.cuh limits: slots per pod, matched-term slots, host ports,
# and csrc/rounds.cu's chunk
MAX_SLOTS, MAX_MATCH, MAX_PORTS, MAX_RCHUNK, ZR_MAX = 16, 32, 64, 32, 32


def score_planes(arr) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10 (csrc/score_planes.cu): (traw, naraw) bf16[P, N], the
    PreferNoSchedule count plane and the preferred node-affinity weight
    plane: the two halves of one [2, P, N] buffer, written by one launch.
    Under KTPU_SCORE_DTYPE=f32 the planes are f32: the f32 build
    (ktt_score_planes_f32), counted as score_planes_f32."""
    dev = arr.device
    _need_cuda(dev, "score_planes")
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
        _check(getattr(arr, name), name, dt, shape, dev)
    sdt = bitplane.score_store_dtype()
    name = "score_planes" if sdt == torch.bfloat16 else "score_planes_f32"
    fn = _fn(name)
    traw, naraw = torch.empty((2, P, N), dtype=sdt, device=dev).unbind(0)
    if P == 0 or N == 0:
        return traw, naraw
    with _on(dev):
        err = fn(
            arr.node_taint_pref.data_ptr(), arr.pod_tol_pref.data_ptr(), arr.pod_pref_terms.data_ptr(),
            arr.pod_pref_weights.data_ptr(), arr.sel_mask.data_ptr(), arr.sel_kind.data_ptr(),
            arr.node_labels.data_ptr(), traw.data_ptr(), naraw.data_ptr(), P, N, T, PW, S, E, L, _stream(dev),
        )
    _raise_on(err, name)
    LAUNCHES[name] += 1
    return traw, naraw


@dataclasses.dataclass
class ScanOut:
    """K11 / K12's buffers (scan_out): the outputs and the running state
    {used, cnt, anti, pref, total, ports}, which only a launch that passed
    the gate writes; the start state the launch copies into it itself
    (node_used, the pairwise counts gathered once, node_ports0); the domain
    map; K12's scratch (None for K11).  The gang fixpoint's gated mode
    passes one set to every iteration, so the last real launch's result
    survives every gated one."""

    choices: torch.Tensor
    ordinals: torch.Tensor
    scal: torch.Tensor
    state: dict
    start: tuple
    dbt: torch.Tensor
    scratch: Optional[list]


def _rounds_scratch(C: int, N: int, dev) -> list:
    """K12's scratch pointers (csrc/rounds.cu ktt_rounds): the [C, N] row
    scratch, the [C, 32] top lists, the [C] argmaxes, the exchange; the four
    [C], the [2] and the [1] word arrays are the first design's, which the
    phase tools' --parent builds still read."""
    n_ent = MAX_MATCH + 3 * MAX_SLOTS
    return [
        torch.empty((C, N), dtype=torch.uint8, device=dev),
        *(torch.empty((C, N), dtype=torch.float32, device=dev) for _ in range(4)),
        torch.empty((C, ZR_MAX), dtype=torch.float32, device=dev),
        torch.empty((C, ZR_MAX), dtype=torch.int32, device=dev),
        *(torch.empty((C,), dtype=torch.int32, device=dev) for _ in range(5)),
        torch.zeros((2,), dtype=torch.int32, device=dev),
        torch.empty((C * n_ent, 4), dtype=torch.int32, device=dev),
        torch.zeros((1,), dtype=torch.int32, device=dev),
    ]


def scan_out(arr, rchunk: Optional[int] = None) -> ScanOut:
    """The buffers of K11 (rchunk None) or K12 (chunks of `rchunk` pods)
    over `arr`."""
    from .assign import dom_by_term, pairwise_state0

    dev = arr.device
    _need_cuda(dev, "full_scan / rounds")
    dbt, D = dom_by_term(arr)
    dbt = dbt.contiguous()
    cnt0, anti0, pref0, total0 = (x.contiguous() for x in pairwise_state0(arr, dbt, D))
    state = dict(used=torch.empty_like(arr.node_used), cnt=torch.empty_like(cnt0), anti=torch.empty_like(anti0),
                 pref=torch.empty_like(pref0), total=torch.empty_like(total0),
                 ports=torch.empty_like(arr.node_ports0))
    P = arr.P
    return ScanOut(torch.full((P,), -1, dtype=torch.int32, device=dev), torch.zeros((P,), dtype=torch.int32, device=dev),
                   torch.zeros((2,), dtype=torch.int32, device=dev), state,
                   (arr.node_used, cnt0, anti0, pref0, total0, arr.node_ports0), dbt,
                   None if rchunk is None else _rounds_scratch(rchunk, arr.N, dev))


def _full_args(arr, cfg, sfs, eligs, planes, out: ScanOut, inc=None, done: Optional[torch.Tensor] = None,
               img_on: Optional[bool] = None):
    """The inputs K11 and K12 share and out's buffers, checked -> (pointer
    array, dims, switches, weights, score params).  The kernel fills out's
    running state from out.start itself (the inputs are never written).
    With class state `inc` (K12's class-row mode) the planes are inc's class
    planes [U1, *] (stat, elig, traw, naraw, img) and pointer 26 is the
    class index inc.cls (NULL otherwise); pointer 27 is `done` (NULL outside
    the gated mode), pointers 28..33 out's start state."""
    from .assign import _image_on

    dev = arr.device
    P, N, R = arr.P, arr.N, arr.R
    W = -(-N // 32)
    traw, naraw = planes
    if inc is None:
        rows, img = P, (arr.image_score if (_image_on(arr, cfg) if img_on is None else img_on) else None)
    else:
        rows, img = inc.req_u.shape[0], inc.img_u
        sfs, eligs, traw, naraw = inc.stat_u, inc.elig_u, inc.traw_u, inc.naraw_u
        _check(inc.cls, "inc.cls", torch.int32, (P,), dev)
    img_on = img is not None
    pw = bool(cfg.enable_pairwise)
    T, D1 = arr.term_counts0.shape
    D = D1 - 1
    PT = arr.node_ports0.shape[1]
    CS, A1, A2 = arr.pod_spread_terms.shape[1], arr.pod_aff_terms.shape[1], arr.pod_anti_terms.shape[1]
    B, M = arr.pod_pref_aff_terms.shape[1], arr.pod_match_terms.shape[1]
    if max(CS, A1, A2, B) > MAX_SLOTS or M > MAX_MATCH or PT > MAX_PORTS:
        raise ValueError(f"the full-stage kernels take <= {MAX_SLOTS} slots, <= {MAX_MATCH} matched terms and "
                         f"<= {MAX_PORTS} host ports; got spread {CS}, affinity {A1}, anti {A2}, preferred {B}, "
                         f"matched {M}, ports {PT}")
    _check(sfs, "sfs", torch.int32, (rows, W), dev)
    if pw:
        _check(eligs, "eligs", torch.int32, (rows, W), dev)
    sdt = bitplane.score_store_dtype()  # the planes' storage: bf16, or f32 (KTPU_SCORE_DTYPE)
    if cfg.enable_taint_score:
        _check(traw, "traw", sdt, (rows, N), dev)
    if cfg.enable_node_pref:
        _check(naraw, "naraw", sdt, (rows, N), dev)
    K = arr.node_dom.shape[0]
    for name, dt, shape in (
        ("pod_req", torch.int32, (P, R)), ("pod_valid", torch.bool, (P,)),
        ("node_alloc", torch.int32, (N, R)), ("node_used", torch.int32, (N, R)),
        ("pod_spread_terms", torch.int32, (P, CS)), ("pod_spread_maxskew", torch.int32, (P, CS)),
        ("pod_spread_hard", torch.bool, (P, CS)), ("pod_aff_terms", torch.int32, (P, A1)),
        ("pod_aff_self", torch.bool, (P, A1)), ("pod_anti_terms", torch.int32, (P, A2)),
        ("pod_match_terms", torch.int32, (P, M)), ("pod_match_vals", torch.float32, (P, M)),
        ("pod_pref_aff_terms", torch.int32, (P, B)), ("pod_pref_aff_w", torch.float32, (P, B)),
        ("pod_ports", torch.bool, (P, PT)), ("node_ports0", torch.bool, (N, PT)),
        ("node_dom", torch.int32, (K, N)), ("term_key", torch.int32, (T,)),
        ("term_counts0", torch.float32, (T, D1)), ("anti_counts0", torch.float32, (T, D1)),
        ("pref_own0", torch.float32, (T, D1)),
    ):
        _check(getattr(arr, name), name, dt, shape, dev)
    if img_on:
        _check(img, "image_score", sdt, (rows, N), dev)
    _check_done(done, dev)
    ip, fp = _score_params(cfg, R)
    dbt, st, start = out.dbt, out.state, out.start
    for name, t, dt, shape in (("out.choices", out.choices, torch.int32, (P,)),
                               ("out.ordinals", out.ordinals, torch.int32, (P,)),
                               ("out.scal", out.scal, torch.int32, (2,)), ("dbt", dbt, torch.int32, (T, N)),
                               ("used", st["used"], torch.int32, (N, R)), ("cnt", st["cnt"], torch.float32, (T, N)),
                               ("anti", st["anti"], torch.float32, (T, N)),
                               ("pref", st["pref"], torch.float32, (T, N)),
                               ("total", st["total"], torch.float32, (T,)),
                               ("ports", st["ports"], torch.bool, (N, PT))):
        _check(t, name, dt, shape, dev)

    ptrs = np.array([0 if x is None else x.data_ptr() for x in (
        arr.pod_req, arr.pod_valid, sfs, eligs if pw else None, traw if cfg.enable_taint_score else None,
        naraw if cfg.enable_node_pref else None, img, arr.pod_spread_terms,
        arr.pod_spread_maxskew, arr.pod_spread_hard, arr.pod_aff_terms, arr.pod_aff_self, arr.pod_anti_terms,
        arr.pod_match_terms, arr.pod_match_vals, arr.pod_pref_aff_terms, arr.pod_pref_aff_w, arr.pod_ports,
        arr.node_alloc, st["used"], dbt, st["cnt"], st["anti"], st["pref"], st["total"], st["ports"],
        None if inc is None else inc.cls, done, *start,
    )], dtype=np.uint64)
    dims = np.array([P, N, R, T, D, PT, CS, A1, A2, B, M], dtype=np.int32)
    ips = pw and bool(cfg.enable_interpod_score)
    sw = np.array([pw, ips, bool(cfg.enable_ports), bool(cfg.enable_taint_score),
                   bool(cfg.enable_node_pref), img_on, sdt == torch.float32], dtype=np.int32)
    wp = np.array([cfg.taint_weight, cfg.node_affinity_weight, cfg.spread_weight, cfg.interpod_weight,
                   cfg.image_weight, cfg.hard_pod_affinity_weight], dtype=np.float32)
    return ptrs, dims, sw, wp, ip, fp


def full_scan(arr, cfg, sfs: torch.Tensor, eligs: Optional[torch.Tensor], planes, with_state: bool = False,
              done: Optional[torch.Tensor] = None, out: Optional[ScanOut] = None, cluster: Optional[int] = None):
    """K11 (csrc/full_scan.cu): the per-pod scan over the full stage set in
    one launch of one thread-block cluster (the widest the card schedules
    up to `cluster` blocks: SCAN_CLUSTER["full_scan"] when None;
    LAST_CLUSTER["full_scan"] the width launched), from K7's packed static
    (and eligibility) planes and score_planes' (traw, naraw) -> (choices
    i32[P], used i32[N, R]), and with `with_state` the final pairwise state
    (cnt, anti, pref, total, ports), views of out's buffers.  `done` (i32[1] on the card): the
    launch returns at entry once it is set; `out` (scan_out(arr)): the
    buffers to write, a fresh set when None."""
    dev = arr.device
    _need_cuda(dev, "full_scan")
    max_kc = _cluster_arg("full_scan", cluster)
    if out is None:
        out = scan_out(arr)
    ptrs, dims, sw, wp, ip, fp = _full_args(arr, cfg, sfs, eligs, planes, out, done=done)
    fn = _fn("full_scan")
    kc = ctypes.c_int(0)
    with _on(dev):
        err = fn(_host(ptrs), _host(dims), _host(sw), _host(wp), _host(ip), _host(fp), out.choices.data_ptr(),
                 max_kc, ctypes.byref(kc), _stream(dev))
    _raise_on(err, "full_scan")
    LAUNCHES["full_scan"] += 1
    LAST_CLUSTER["full_scan"] = kc.value
    st = dict(out.state)
    used = st.pop("used")
    return (out.choices, used, st) if with_state else (out.choices, used)


def rounds(arr, cfg, sfs: Optional[torch.Tensor] = None, eligs: Optional[torch.Tensor] = None, planes=(None, None),
           rchunk: Optional[int] = None, repair_iters: Optional[int] = None, with_state: bool = False, inc=None,
           done: Optional[torch.Tensor] = None, out: Optional[ScanOut] = None):
    """K12 (csrc/rounds.cu): the rounds scan over the full stage set in one
    cooperative launch, chunks of `rchunk` pods -> (choices i32[P], used
    i32[N, R], ordinals i32[P], the int32[2] device pair (sweeps, status):
    read_sweeps), and with `with_state` the final pairwise state.  Every
    round commits a pod, so a chunk takes at most `rchunk` rounds; the
    kernel stops a chunk past that cap and ORs it into the status.  With
    class state `inc` it runs in class-row mode over inc's class planes
    (sfs, eligs and planes are not given), read through inc.cls, with
    pod_valid folded in per pod.  `done` (i32[1] on the card): the whole
    grid returns at entry, before its first barrier, once it is set;
    `out` (scan_out(arr, rchunk)): the buffers to write, a fresh set when
    None (the status word of out.scal gathers every launch's)."""
    from .assign import REPAIR_ITERS, RCHUNK

    dev = arr.device
    _need_cuda(dev, "rounds")
    C = RCHUNK if rchunk is None else rchunk
    iters = REPAIR_ITERS if repair_iters is None else repair_iters
    P, N = arr.P, arr.N
    if not 1 <= C <= MAX_RCHUNK or P % C or iters < 1:
        raise ValueError(f"rounds kernel takes chunks of 1..{MAX_RCHUNK} pods dividing P and repair_iters >= 1; "
                         f"got rchunk={C}, P={P}, repair_iters={iters}")
    if out is None:
        out = scan_out(arr, C)
    elif out.scratch is None or out.scratch[0].shape != (C, N):
        raise ValueError(f"rounds: out was not made by scan_out(arr, rchunk={C})")
    ptrs, dims, sw, wp, ip, fp = _full_args(arr, cfg, sfs, eligs, planes, out, inc, done=done)
    fn = _fn("rounds")
    sp = np.array([x.data_ptr() for x in out.scratch], dtype=np.uint64)
    with torch.cuda.device(dev):
        err = fn(_host(ptrs), _host(dims), _host(sw), _host(wp), _host(ip), _host(fp), out.choices.data_ptr(),
                 out.ordinals.data_ptr(), out.scal.data_ptr(), _host(sp), C, iters, _stream(dev))
    _raise_on(err, "rounds")
    LAUNCHES["rounds"] += 1
    st = dict(out.state)
    used = st.pop("used")
    res = (out.choices, used, out.ordinals, out.scal)
    return res + (st,) if with_state else res


# ---------------------------------------------------------------------------
# the gang fixpoint: K13 gang_quorum
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QuorumOut:
    """gang_quorum's outputs, made once (gang_quorum_out) and passed as
    `out` to every call, so a queued call allocates
    nothing: sched i32[G], present and bad bool[G], first i32[1], and the
    counters' scratch int32[2, G] (used only where the cluster's shared
    memory cannot hold G groups' counters).  `bound` holds the last call's
    tensors and C arguments: a call with the very same tensors (the gang
    fixpoint's queued iterations) reuses them, unchecked."""

    sched: torch.Tensor
    present: torch.Tensor
    bad: torch.Tensor
    first: torch.Tensor
    scratch: torch.Tensor
    bound: Optional[tuple] = dataclasses.field(default=None, repr=False)


def gang_quorum_out(G: int, dev) -> QuorumOut:
    return QuorumOut(torch.empty((G,), dtype=torch.int32, device=dev), torch.empty((G,), dtype=torch.bool, device=dev),
                     torch.empty((G,), dtype=torch.bool, device=dev), torch.empty((1,), dtype=torch.int32, device=dev),
                     torch.empty((2, G), dtype=torch.int32, device=dev))


# K13's cluster: at most this many blocks (csrc/gang.cu MAX_KC; a
# non-portable size above 8; faster than 8 at config 5, PERF.md);
# LAST_CLUSTER["gang_quorum"] the width launched
QUORUM_CLUSTER = 16
_QUORUM_KC = ctypes.c_int(0)
_QUORUM_KC_REF = ctypes.byref(_QUORUM_KC)


def gang_quorum(choices: torch.Tensor, pod_group: torch.Tensor, pv: torch.Tensor, group_min: torch.Tensor,
                done: Optional[torch.Tensor] = None, out: Optional[QuorumOut] = None, cluster: Optional[int] = None):
    """K13 (csrc/gang.cu): one iteration's quorum check and revocation of
    the gang fixpoint, one thread-block cluster of up to `cluster` blocks
    (QUORUM_CLUSTER when None).  `pv` (bool[P], the iteration's pod_valid)
    becomes pv_next IN PLACE; `done` (i32[1] on the card, a fresh zero word
    when None) gates the launch and is set when no group failed; `out`
    (gang_quorum_out): the buffers to write, a fresh set when None.  ->
    (sched i32[G], present bool[G], bad bool[G], first i32[1]: the earliest
    pod of a failed group or -1, done)."""
    bound = None if out is None else out.bound
    if (bound is not None and bound[0] is choices and bound[1] is pod_group and bound[2] is pv
            and bound[3] is group_min and bound[4] is done and bound[5] == cluster):
        dev, args = bound[6], bound[7]
    else:
        dev = choices.device
        _need_cuda(dev, "gang_quorum")
        P = choices.shape[0]
        G = group_min.shape[0]
        for name, t, dt, shape in (("choices", choices, torch.int32, (P,)), ("pod_group", pod_group, torch.int32, (P,)),
                                   ("pv", pv, torch.bool, (P,)), ("group_min", group_min, torch.int32, (G,))):
            _check(t, name, dt, shape, dev)
        if done is not None:
            _check(done, "done", torch.int32, (1,), dev)
        kc = QUORUM_CLUSTER if cluster is None else int(cluster)
        if not 1 <= kc <= QUORUM_CLUSTER:
            raise ValueError(f"gang_quorum takes a cluster of 1..{QUORUM_CLUSTER} blocks, got {cluster}")
        if out is None:
            out = gang_quorum_out(G, dev)
        else:
            for name, t, dt, shape in (("sched", out.sched, torch.int32, (G,)),
                                       ("present", out.present, torch.bool, (G,)), ("bad", out.bad, torch.bool, (G,)),
                                       ("first", out.first, torch.int32, (1,)),
                                       ("scratch", out.scratch, torch.int32, (2, G))):
                _check(t, name, dt, shape, dev)
        d = torch.zeros((1,), dtype=torch.int32, device=dev) if done is None else done
        args = (choices.data_ptr(), pod_group.data_ptr(), pv.data_ptr(), group_min.data_ptr(), out.sched.data_ptr(),
                out.present.data_ptr(), out.bad.data_ptr(), out.first.data_ptr(), d.data_ptr(),
                out.scratch.data_ptr(), P, G, kc, _QUORUM_KC_REF)
        if done is None:
            done = d
        else:  # the next call with these tensors skips the checks
            out.bound = (choices, pod_group, pv, group_min, done, cluster, dev, args)
    fn = _fn("gang_quorum")
    with _on(dev):
        err = fn(*args, _stream(dev))
    _raise_on(err, "gang_quorum")
    LAUNCHES["gang_quorum"] += 1
    LAST_CLUSTER["gang_quorum"] = _QUORUM_KC.value
    return out.sched, out.present, out.bad, out.first, done


EXPLAIN_MAX_R = 32  # csrc/explain.cu
EXPLAIN_COPIES = 8  # csrc/explain.cu COPIES: the accumulator's copies of the counts
PREEMPT_MAX_R = 16  # csrc/preempt.cu: the running usage is a register array


def explain_counts(arr, node_used: torch.Tensor, reps: torch.Tensor, rep_valid: torch.Tensor) -> torch.Tensor:
    """K14 (csrc/explain.cu): i32[F, 4+R+1] one-reason-per-node counts for
    the pod rows `reps` (i64[F]) at usage `node_used` (i32[N, R]); rows
    with `rep_valid` (bool[F]) false are zero."""
    dev = arr.device
    _need_cuda(dev, "explain_counts")
    P, N, R = arr.P, arr.N, arr.R
    T = arr.node_taint_ns.shape[1]
    TT = arr.pod_terms.shape[1]
    S, E, L = arr.sel_mask.shape
    F = reps.shape[0]
    if R > EXPLAIN_MAX_R:
        raise ValueError(f"explain_counts takes at most {EXPLAIN_MAX_R} resources, got {R}")
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
        _check(t, name, dt, shape, dev)
    fn = _fn("explain_counts")
    K = 4 + R + 1
    out = torch.empty((F, K), dtype=torch.int32, device=dev)
    if F == 0:
        return out
    with _on(dev):
        stream = _stream(dev)
        acc = _explain_acc(dev, stream, F, R)
        err = fn(
            arr.node_valid.data_ptr(), arr.node_alloc.data_ptr(), node_used.data_ptr(), arr.node_unsched.data_ptr(),
            arr.node_labels.data_ptr(), arr.node_taint_ns.data_ptr(), arr.sel_mask.data_ptr(),
            arr.sel_kind.data_ptr(), arr.pod_req.data_ptr(), arr.pod_tol_ns.data_ptr(), arr.pod_nodename.data_ptr(),
            arr.pod_terms.data_ptr(), arr.pod_has_sel.data_ptr(), reps.data_ptr(), rep_valid.data_ptr(),
            acc.data_ptr(), out.data_ptr(), F, P, N, R, T, TT, S, E, L, stream,
        )
    _raise_on(err, "explain_counts")
    LAUNCHES["explain_counts"] += 1
    return out


def _explain_acc(dev, stream: int, F: int, R: int) -> torch.Tensor:
    """K14's accumulator on `dev` for launches on `stream` with F reps and
    R resources (its tickets and copies of the counts, csrc/explain.cu):
    made zero once and kept across calls (each launch leaves it zero: its
    last block moves the counts out), grown when a call needs more."""
    return _kept("explain_counts", dev, stream, 1 + EXPLAIN_COPIES + EXPLAIN_COPIES * F * (4 + R + 1), zero=True)


def preempt_eval(stat_w: torch.Tensor, pod_req: torch.Tensor, pod_idxs: torch.Tensor, node_alloc: torch.Tensor,
                 used_now: torch.Tensor, nom_extra: torch.Tensor, has_nom: torch.Tensor, vict_req: torch.Tensor,
                 vict_prio: torch.Tensor, vict_viol: torch.Tensor, vict_valid: torch.Tensor):
    """K15 (csrc/preempt.cu): phases A-C for the K preemptor rows
    `pod_idxs` (i32[K]) whose packed static rows are `stat_w` (i32[K,
    ceil(N/32)], K3's words) -> (cand bool[K, N], nvio, vmax, vsum, vcnt
    i32[K, N], is_victim bool[K, N, V], static_ok bool[K, N]), all views of
    one byte buffer (``out[0]._base``), so the caller reads a wave back with
    one copy."""
    dev = pod_req.device
    _need_cuda(dev, "preempt_eval")
    P, R = pod_req.shape
    N, V = vict_prio.shape
    K = pod_idxs.shape[0]
    W = -(-N // 32)
    if R > PREEMPT_MAX_R:
        raise ValueError(f"preempt_eval takes at most {PREEMPT_MAX_R} resources, got {R}")
    for name, t, dt, shape in (
        ("stat_w", stat_w, torch.int32, (K, W)), ("pod_req", pod_req, torch.int32, (P, R)),
        ("pod_idxs", pod_idxs, torch.int32, (K,)), ("node_alloc", node_alloc, torch.int32, (N, R)),
        ("used_now", used_now, torch.int32, (N, R)), ("nom_extra", nom_extra, torch.int32, (N, R)),
        ("has_nom", has_nom, torch.bool, (N,)), ("vict_req", vict_req, torch.int32, (N, V, R)),
        ("vict_prio", vict_prio, torch.int32, (N, V)), ("vict_viol", vict_viol, torch.bool, (N, V)),
        ("vict_valid", vict_valid, torch.bool, (N, V)),
    ):
        _check(t, name, dt, shape, dev)
    fn = _fn("preempt_eval")
    kn = K * N
    buf = torch.empty((16 * kn + 2 * kn + kn * V,), dtype=torch.uint8, device=dev)
    i32 = [buf[4 * i * kn:4 * (i + 1) * kn].view(torch.int32).view(K, N) for i in range(4)]
    cand = buf[16 * kn:17 * kn].view(torch.bool).view(K, N)
    static_ok = buf[17 * kn:18 * kn].view(torch.bool).view(K, N)
    is_victim = buf[18 * kn:].view(torch.bool).view(K, N, V)
    with torch.cuda.device(dev):
        err = fn(
            stat_w.data_ptr(), pod_req.data_ptr(), pod_idxs.data_ptr(), node_alloc.data_ptr(), used_now.data_ptr(),
            nom_extra.data_ptr(), has_nom.data_ptr(), vict_req.data_ptr(), vict_prio.data_ptr(),
            vict_viol.data_ptr(), vict_valid.data_ptr(), cand.data_ptr(), i32[0].data_ptr(), i32[1].data_ptr(),
            i32[2].data_ptr(), i32[3].data_ptr(), is_victim.data_ptr(), static_ok.data_ptr(), K, N, V, R, _stream(dev),
        )
    _raise_on(err, "preempt_eval")
    LAUNCHES["preempt_eval"] += 1
    return (cand, *i32, is_victim, static_ok)


# ---------------------------------------------------------------------------
# the node mesh: K16 ring_match, K17 stitch_planes
# ---------------------------------------------------------------------------

def ring_match(sel: torch.Tensor, kind: torch.Tensor, lab: torch.Tensor, out: Optional[torch.Tensor] = None,
               col0: int = 0) -> torch.Tensor:
    """K16 (csrc/ring_match.cu): selector terms sel f32[Sl, E, L] (0/1) with
    kinds kind i32[Sl, E] against label rows lab f32[B, L] (0/1) -> the
    match tile bool[Sl, B], written into columns [col0, col0 + B) of `out`
    bool[Sl, M] (a fresh [Sl, B] when None); returns `out`."""
    dev = sel.device
    _need_cuda(dev, "ring_match")
    Sl, E, L = sel.shape
    B = lab.shape[0]
    _check(sel, "sel", torch.float32, (Sl, E, L), dev)
    _check(kind, "kind", torch.int32, (Sl, E), dev)
    _check(lab, "lab", torch.float32, (B, L), dev)
    if out is None:
        out = torch.empty((Sl, B), dtype=torch.bool, device=dev)
    _check(out, "out", torch.bool, (Sl, out.shape[1]), dev)
    if not 0 <= col0 <= out.shape[1] - B:
        raise ValueError(f"ring_match: columns [{col0}, {col0 + B}) outside out's {out.shape[1]}")
    fn = _fn("ring_match")
    with _on(dev):
        err = fn(sel.data_ptr(), kind.data_ptr(), lab.data_ptr(), out.data_ptr(), Sl, E, L, B, out.shape[1], col0,
                 _stream(dev))
    _raise_on(err, "ring_match")
    LAUNCHES["ring_match"] += 1
    return out


def stitch_planes(words: torch.Tensor, nl: int) -> torch.Tensor:
    """K17 (csrc/stitch_planes.cu): int32 words [rows, S * ceil(nl/32)] in
    per-shard blocks of `nl` bits (the tiled layout) -> the flat layout
    [rows, ceil(S * nl / 32)] of ops/bitplane.py."""
    dev = words.device
    _need_cuda(dev, "stitch_planes")
    wl = -(-nl // 32)
    if words.dim() != 2 or words.dtype != torch.int32 or not words.is_contiguous() or words.shape[1] % wl:
        raise ValueError(f"stitch_planes: expected contiguous int32 words [rows, S * {wl}], got "
                         f"{words.dtype} {tuple(words.shape)}")
    rows, S = words.shape[0], words.shape[1] // wl
    out = torch.empty((rows, -(-(S * nl) // 32)), dtype=torch.int32, device=dev)
    fn = _fn("stitch_planes")
    with torch.cuda.device(dev):
        err = fn(words.data_ptr(), out.data_ptr(), rows, S, nl, _stream(dev))
    _raise_on(err, "stitch_planes")
    LAUNCHES["stitch_planes"] += 1
    return out


# ---------------------------------------------------------------------------
# the shard modes of K2, K11 and K12 (the node mesh's per-step collectives)
# ---------------------------------------------------------------------------

MAX_SHARDS = 8  # csrc/pairwise.cuh PW_MAX_SHARDS, fit_scan.cu MAX_SHARDS
_A12 = "ROADMAP.md queue A12"
# ShardPtrs' order (csrc/pairwise.cuh): the node-side entries of _full_args' pointer array
_SHARD_PTRS = (2, 3, 4, 5, 6, 18, 19, 20, 21, 22, 23, 24, 25, 28, 29, 30, 31, 33)


def shard_grid_check(S: int, blocks: int, n_sm: int) -> None:
    """Refuse a shard-mode launch of `S` shards that needs `blocks` resident
    blocks of 1024 threads (one per SM; K12: its C clusters, at least C
    blocks; K2 / K11: their cluster's cap) on a card of `n_sm` SMs: never
    cut quietly to fewer shards."""
    if not 1 <= S <= MAX_SHARDS:
        raise NotImplementedError(f"a shard-mode launch takes 1..{MAX_SHARDS} node shards, got {S}; more shards "
                                  f"on one card are not ported to kubernetes_tpu_torch ({_A12})")
    if blocks > n_sm:
        raise NotImplementedError(f"a shard-mode launch of {S} shards needs {blocks} resident blocks of 1024 threads; "
                                  f"this card has {n_sm} SMs ({_A12})")


def _shard_checks(sa, name: str, done, blocks: int) -> torch.device:
    if done is not None:
        raise NotImplementedError(f"{name}: the gated mode is not taken in shard mode (the device gang fixpoint "
                                  f"runs on one device, as in the JAX package; {_A12})")
    if sa.mesh.span is not None:
        raise NotImplementedError(f"{name}: a shard-mode launch holds every shard in one process; {sa.mesh} spans "
                                  f"several ranks (an exchange across processes is not ported, {_A12})")
    dev = sa.device
    _need_cuda(dev, name)
    if any(d != dev for d in sa.mesh.devices):
        raise NotImplementedError(f"{name}: a shard-mode launch holds every shard on one card; {sa.mesh} spans "
                                  f"several (the multi-card form is not ported, {_A12})")
    shard_grid_check(sa.mesh.size, blocks, torch.cuda.get_device_properties(dev).multi_processor_count)
    return dev


def _table(rows) -> np.ndarray:
    return np.array([0 if x is None else x for r in rows for x in r], dtype=np.uint64)


def scan_runs(name: str, S: int, nl: int, kc: int) -> list:
    """The cut of a per-pod scan's node axis over a cluster of kc blocks,
    as its kernel makes it, one device (S = 1) or shard mode: for each block
    q in rank order, its run as segments (shard, first local column, end
    local column) in axis order.  K2 ("fit_scan", csrc/fit_scan.cu run_lo)
    cuts the S shards' columns, each shard's nl nodes padded to 16, in whole
    16-column units; K11 ("full_scan", csrc/full_scan.cu run_lo) cuts the
    S * nl global ids.  A run may span shards, and a shard hold several
    runs."""
    if name == "fit_scan":
        width = -(-nl // SCAN_UNIT) * SCAN_UNIT
        units = S * width // SCAN_UNIT
        los = [SCAN_UNIT * (q * units // kc) for q in range(kc + 1)]
    elif name == "full_scan":
        width = nl
        los = [q * S * nl // kc for q in range(kc + 1)]
    else:
        raise ValueError(f"scan_runs: fit_scan or full_scan, got {name!r}")
    runs = []
    for lo, hi in zip(los, los[1:]):
        runs.append([(s, max(lo, s * width) - s * width, min(hi, (s + 1) * width) - s * width)
                     for s in range(lo // width, -(-hi // width)) if max(lo, s * width) < min(hi, (s + 1) * width)])
    return runs


def fit_scan_shard(sfs, sa, cfg, done: Optional[torch.Tensor] = None, cluster: Optional[int] = None):
    """K2 in shard mode (csrc/fit_scan.cu, ktt_fit_scan_shard): the fit-only
    per-pod scan over arrays on a node mesh (parallel/mesh.py ShardedArrays)
    from each shard's static rows sfs[s] bool[P, nl] (K1 with its base), in
    one thread-block cluster over every shard's columns (the widest the card
    schedules up to `cluster` blocks, SCAN_CLUSTER["fit_scan"] when None;
    LAST_CLUSTER["fit_scan_shard"] the width launched) -> (choices i32[P]
    global node ids, used i32[N, R] gathered on the padded axis)."""
    S, nl, P = sa.mesh.size, sa.nl, sa.P
    max_kc = _cluster_arg("fit_scan", cluster)
    dev = _shard_checks(sa, "fit_scan_shard", done, max_kc)
    sh0 = sa.shards[0]
    R = sh0.R
    rows, keep = [], []
    for s, sh in enumerate(sa.shards):
        Np = _fit_checks(sh, cfg)
        _check(sfs[s], f"sfs[{s}]", torch.bool, (P, nl), dev)
        sf = sfs[s]
        if Np != nl or sf.data_ptr() % 16:  # padding columns have no sf bit set, so they are never chosen
            sf = torch.zeros((P, Np), dtype=torch.bool, device=dev)
            sf[:, :nl] = sfs[s]
        rows.append((sf.data_ptr(), sh.node_used.data_ptr()))
        keep.append(sf)
    # the allocatable and the usage on the axis: shard s's columns [s * Np, (s + 1) * Np)
    alloc_t = torch.zeros((R, S, Np), dtype=torch.int32, device=dev)
    alloc_t[:, :, :nl] = torch.stack([sh.node_alloc.t() for sh in sa.shards], dim=1)
    used_t = torch.empty((R, S, Np), dtype=torch.int32, device=dev)
    fn = _fn("fit_scan_shard")
    K = len(cfg.score_resources)
    shape = cfg.rtcr_shape
    score_idx = torch.tensor(cfg.score_resources, dtype=torch.int32, device=dev)
    shape_xy = torch.tensor([x for x, _ in shape] + [y for _, y in shape], dtype=torch.float32, device=dev)
    choices = torch.full((P,), -1, dtype=torch.int32, device=dev)
    n_scored = torch.zeros((1,), dtype=torch.int64, device=dev)
    table = _table(rows)
    kc = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = fn(_host(table), S, nl, sh0.pod_req.data_ptr(), sh0.pod_valid.data_ptr(), alloc_t.data_ptr(),
                 used_t.data_ptr(), score_idx.data_ptr(), K, sum(1 << i for i in set(cfg.score_resources)),
                 shape_xy.data_ptr(), len(shape), STRATEGY_CODES[cfg.fit_strategy], float(cfg.fit_weight),
                 float(cfg.balanced_weight), P, Np, R, choices.data_ptr(), n_scored.data_ptr(), max_kc,
                 ctypes.byref(kc), _stream(dev))
    _raise_on(err, "fit_scan_shard")
    LAUNCHES["fit_scan_shard"] += 1
    LAST_CLUSTER["fit_scan_shard"] = kc.value
    return choices, used_t[:, :, :nl].reshape(R, S * nl).t()


def _shard_args(sa, cfg, sfs, eligs, planes, inc, used_rep=None):
    """Each shard's buffers (scan_out) and checked arguments (_full_args) ->
    (outs, shard 0's argument arrays, the ShardPtrs table).  With
    `used_rep` = (used, used0) [N, R] (K12) each shard's usage and start
    usage are its slices of the replicated pair."""
    from .assign import _image_on

    img_on = _image_on(sa, cfg)
    nl = sa.nl
    outs, rows, args0 = [], [], None
    for s, sh in enumerate(sa.shards):
        out = scan_out(sh)
        if used_rep is not None:
            sl = slice(s * nl, (s + 1) * nl)
            out.state["used"] = used_rep[0][sl]
            out = dataclasses.replace(out, start=(used_rep[1][sl],) + tuple(out.start[1:]))
        ishard = None if inc is None else inc.shards[s]
        pl = (None, None) if planes is None else planes[s]
        args = _full_args(sh, cfg, None if sfs is None else sfs[s], None if eligs is None else eligs[s], pl, out,
                          ishard, img_on=img_on)
        if s == 0:
            args0 = args
        rows.append([int(args[0][i]) for i in _SHARD_PTRS])
        outs.append(out)
    return outs, args0, _table(rows)


def _gathered_state(sa, outs) -> dict:
    st = {k: torch.cat([o.state[k] for o in outs], dim=1) for k in ("cnt", "anti", "pref")}
    st["total"] = outs[0].state["total"]
    st["ports"] = torch.cat([o.state["ports"] for o in outs])
    return st


def full_scan_shard(sa, cfg, sfs, eligs, planes, with_state: bool = False, done: Optional[torch.Tensor] = None,
                    cluster: Optional[int] = None):
    """K11 in shard mode (csrc/full_scan.cu full_scan_kernel<true>): the
    per-pod scan over the full stage set on a node mesh, from each shard's
    K7 planes (sfs[s], eligs[s]: [P, words(nl)], with its base) and K10
    planes (planes[s]), in one thread-block cluster over every shard's
    nodes (the widest the card schedules up to `cluster` blocks,
    SCAN_CLUSTER["full_scan"] when None; LAST_CLUSTER["full_scan_shard"]
    the width launched) -> (choices i32[P] global ids, used i32[N, R]
    gathered), and with `with_state` the final pairwise state gathered."""
    S = sa.mesh.size
    max_kc = _cluster_arg("full_scan", cluster)
    dev = _shard_checks(sa, "full_scan_shard", done, max_kc)
    outs, (ptrs, dims, sw, wp, ip, fp), table = _shard_args(sa, cfg, sfs, eligs, planes, None)
    fn = _fn("full_scan_shard")
    choices = torch.full((sa.P,), -1, dtype=torch.int32, device=dev)
    kc = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = fn(_host(ptrs), _host(dims), _host(sw), _host(wp), _host(ip), _host(fp), _host(table), S,
                 choices.data_ptr(), max_kc, ctypes.byref(kc), _stream(dev))
    _raise_on(err, "full_scan_shard")
    LAUNCHES["full_scan_shard"] += 1
    LAST_CLUSTER["full_scan_shard"] = kc.value
    used = torch.cat([o.state["used"] for o in outs])
    return (choices, used, _gathered_state(sa, outs)) if with_state else (choices, used)


def rounds_shard(sa, cfg, sfs=None, eligs=None, planes=None, inc=None, rchunk: Optional[int] = None,
                 repair_iters: Optional[int] = None, with_state: bool = False, done: Optional[torch.Tensor] = None):
    """K12 in shard mode (csrc/rounds.cu rounds_kernel<true>): the rounds
    scan on a node mesh in the one-device launch (C clusters of kc blocks
    over the shard-major sequence of every shard's 32-node words; each node
    read through its shard's pointers), dense (each shard's K7 planes
    sfs[s] / eligs[s] and K10 planes planes[s]) or in class-row mode
    (`inc`: HoistCache(mesh=)'s state, each shard's class planes in
    inc.shards[s]) -> (choices i32[P], used i32[N, R] (the replicated
    usage), ordinals i32[P], the int32[2] device pair (sweeps, status):
    read_sweeps), and with `with_state` the final pairwise state
    gathered."""
    from .assign import REPAIR_ITERS, RCHUNK

    C = RCHUNK if rchunk is None else rchunk
    iters = REPAIR_ITERS if repair_iters is None else repair_iters
    S, N, P = sa.mesh.size, sa.N, sa.P
    if not 1 <= C <= MAX_RCHUNK or P % C or iters < 1:
        raise ValueError(f"rounds kernel takes chunks of 1..{MAX_RCHUNK} pods dividing P and repair_iters >= 1; "
                         f"got rchunk={C}, P={P}, repair_iters={iters}")
    dev = _shard_checks(sa, "rounds_shard", done, C)  # its grid is C clusters, whatever S: at least C blocks
    R = sa.shards[0].R
    used = torch.empty((N, R), dtype=torch.int32, device=dev)
    outs, (ptrs, dims, sw, wp, ip, fp), table = _shard_args(sa, cfg, sfs, eligs, planes, inc,
                                                            used_rep=(used, sa.gather("node_used")))
    fn = _fn("rounds_shard")
    scratch = _rounds_scratch(C, N, dev)  # held past the launch
    sp = np.array([x.data_ptr() for x in scratch], dtype=np.uint64)
    choices = torch.full((P,), -1, dtype=torch.int32, device=dev)
    ordinals = torch.zeros((P,), dtype=torch.int32, device=dev)
    scal = torch.zeros((2,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fn(_host(ptrs), _host(dims), _host(sw), _host(wp), _host(ip), _host(fp), _host(table), S, N,
                 choices.data_ptr(), ordinals.data_ptr(), scal.data_ptr(), _host(sp), C, iters, _stream(dev))
    _raise_on(err, "rounds_shard")
    LAUNCHES["rounds_shard"] += 1
    res = (choices, used, ordinals, scal)
    return res + (_gathered_state(sa, outs),) if with_state else res
