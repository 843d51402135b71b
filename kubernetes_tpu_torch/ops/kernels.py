"""Build, load and launch the port's hand-written CUDA kernels.

Each source under csrc/ is compiled by nvcc for sm_90a (-fmad=false: no FMA
contraction, so f32 results match the plain versions bit for bit) into its
own shared library with a plain C interface, at first use, into _build/
(git-ignored); a library's name carries a digest of its source and of
every header under csrc/.  All nvcc processes start together.  The
libraries are loaded with ctypes; pointers and the stream go in as
c_void_p, score parameters as small host arrays.

Kernels (LAUNCHES keys) and their libraries: static_feasible and fit_scan
(the per-pod route); class_static_hoist and class_usage_hoist (K3, K4:
class_hoist.cu), wave_commit (K5) and chunk_rounds (K6) (the class-wave
route); packed_static_rows (K7, class_hoist.cu) and chunk_rounds_dense (K8)
(the dense chunked route); unpack_planes (K9, the encoder's packed
transfers).

No wrapper reads anything back: the chunk-scan kernels leave their sweep
count and round-cap status in an int32[2] device pair, which read_sweeps
reads (and raises on) where the caller fetches the step.

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take, raises when the C entry returns a CUDA error, and
adds one to ``LAUNCHES[name]`` where it launches its kernel.  There is no
fallback: the plain versions run only for CPU tensors, and that dispatch
lives with the callers (ops/filters.py, ops/assign.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

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
    "unpack_planes": "unpack_planes.cu",
}

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
# kernel -> (C entry, argtypes)
_ARGTYPES = {
    "static_feasible": ("ktt_static_feasible", [_P] * 14 + [_I] * 7 + [_P]),
    "fit_scan": ("ktt_fit_scan", [_P] * 6 + [_I, _U, _P, _I, _I, _F, _F, _I, _I, _I, _P, _P, _P]),
    "class_static_hoist": ("ktt_class_static_hoist", [_P] * 14 + [_I] * 7 + [_P]),
    "class_usage_hoist": ("ktt_class_usage_hoist", [_P] * 4 + [_I, _P, _P, _P, _P] + [_I] * 3 + [_P]),
    "wave_commit": ("ktt_wave_commit", [_P] * 24 + [_I] * 8 + [_P]),
    "chunk_rounds": ("ktt_chunk_rounds", [_P] * 23 + [_I] * 6 + [_P]),
    "packed_static_rows": ("ktt_packed_static_rows", [_P] * 14 + [_I] * 7 + [_P]),
    "chunk_rounds_dense": ("ktt_chunk_rounds_dense", [_P] * 16 + [_I] * 5 + [_P]),
    "unpack_planes": ("ktt_unpack_planes", [_P, _P, ctypes.c_longlong, _I, _I, _P]),
}
STRATEGY_CODES = {"LeastAllocated": 0, "MostAllocated": 1, "RequestedToCapacityRatio": 2}
MAX_R, MAX_K, MAX_SHAPE = 32, 8, 16  # csrc/fit_scan.cu limits
# fit_scan double-buffers two sf rows in shared memory: 2 * N bytes of the
# 227 KB a block may have, less what its static buffers take
MAX_SCAN_NODES = (232448 - 1024) // 2

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


def static_feasible(arr) -> torch.Tensor:
    """bool[P, N] static feasibility on the card (csrc/static_feasible.cu)."""
    dev = arr.device
    if dev.type != "cuda":
        raise ValueError(f"static_feasible kernel needs CUDA tensors, got {dev}")
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
    TW = max(1, -(-T // 32))  # taints and tolerations as 32-bit words
    tm = torch.empty((S, N), dtype=torch.uint8, device=dev)
    taint_w = torch.empty((N, TW), dtype=torch.int32, device=dev)
    tol_w = torch.empty((P, TW), dtype=torch.int32, device=dev)
    sf = torch.empty((P, N), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            arr.node_valid.data_ptr(), arr.node_taint_ns.data_ptr(), arr.node_labels.data_ptr(),
            arr.pod_valid.data_ptr(), arr.pod_tol_ns.data_ptr(), arr.pod_nodename.data_ptr(),
            arr.pod_terms.data_ptr(), arr.pod_has_sel.data_ptr(), arr.sel_mask.data_ptr(),
            arr.sel_kind.data_ptr(), tm.data_ptr(), taint_w.data_ptr(), tol_w.data_ptr(), sf.data_ptr(),
            P, N, T, TT, S, E, L, stream,
        )
    _raise_on(err, "static_feasible")
    LAUNCHES["static_feasible"] += 1
    return sf


def fit_scan(sf: torch.Tensor, arr, cfg) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The fit-only commit scan on the card (csrc/fit_scan.cu).

    -> (choices i32[P], node_used i32[N, R], n_scored i64[1]: the number of
    (pod, node) pairs that passed fit and were scored)."""
    dev = arr.device
    if dev.type != "cuda":
        raise ValueError(f"fit_scan kernel needs CUDA tensors, got {dev}")
    P, N, R = arr.P, arr.N, arr.R
    _check(sf, "sf", torch.bool, (P, N), dev)
    for name, dt, shape in (
        ("pod_req", torch.int32, (P, R)), ("pod_valid", torch.bool, (P,)),
        ("node_alloc", torch.int32, (N, R)), ("node_used", torch.int32, (N, R)),
    ):
        _check(getattr(arr, name), name, dt, shape, dev)
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
    fn = _fn("fit_scan")
    # [R, N] for the kernel's int4 loads; padding nodes have no sf bit set,
    # so they are never chosen
    alloc_t = torch.zeros((R, Np), dtype=torch.int32, device=dev)
    alloc_t[:, :N] = arr.node_alloc.t()
    used_t = torch.zeros((R, Np), dtype=torch.int32, device=dev)  # the scan's running state
    used_t[:, :N] = arr.node_used.t()
    if Np != N:
        padded = torch.zeros((P, Np), dtype=torch.bool, device=dev)
        padded[:, :N] = sf
        sf = padded
    score_idx = torch.tensor(cfg.score_resources, dtype=torch.int32, device=dev)
    shape_xy = torch.tensor([x for x, _ in shape] + [y for _, y in shape], dtype=torch.float32, device=dev)
    choices = torch.empty((P,), dtype=torch.int32, device=dev)
    n_scored = torch.zeros((1,), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            sf.data_ptr(), arr.pod_req.data_ptr(), arr.pod_valid.data_ptr(),
            alloc_t.data_ptr(), used_t.data_ptr(), score_idx.data_ptr(), K,
            sum(1 << i for i in set(cfg.score_resources)), shape_xy.data_ptr(), len(shape), STRATEGY_CODES[cfg.fit_strategy],
            float(cfg.fit_weight), float(cfg.balanced_weight), P, Np, R,
            choices.data_ptr(), n_scored.data_ptr(), stream,
        )
    _raise_on(err, "fit_scan")
    LAUNCHES["fit_scan"] += 1
    return choices, used_t[:, :N].t().contiguous(), n_scored


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


def class_static_hoist(arr, r_u: torch.Tensor) -> torch.Tensor:
    """K3 (csrc/class_hoist.cu): the packed class static plane int32 words
    [U1, ceil(N/32)] for the classes whose first pod rows are r_u (i64)."""
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
    TW = max(1, -(-T // 32))
    tm = torch.empty((S, N), dtype=torch.uint8, device=dev)
    taint_w = torch.empty((N, TW), dtype=torch.int32, device=dev)
    tol_w = torch.empty((U1, TW), dtype=torch.int32, device=dev)
    stat_u = torch.empty((U1, -(-N // 32)), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fn(
            arr.node_valid.data_ptr(), arr.node_taint_ns.data_ptr(), arr.node_labels.data_ptr(),
            arr.pod_tol_ns.data_ptr(), arr.pod_nodename.data_ptr(), arr.pod_terms.data_ptr(),
            arr.pod_has_sel.data_ptr(), arr.sel_mask.data_ptr(), arr.sel_kind.data_ptr(),
            r_u.data_ptr(), tm.data_ptr(), taint_w.data_ptr(), tol_w.data_ptr(), stat_u.data_ptr(),
            U1, N, T, TT, S, E, L, _stream(dev),
        )
    _raise_on(err, "class_static_hoist")
    LAUNCHES["class_static_hoist"] += 1
    return stat_u


def class_usage_hoist(req_u, node_used, node_alloc, cfg, cols=None, base_u=None, fit_u=None):
    """K4 (csrc/class_hoist.cu): -> (base_u f32[U1, N], fit_u int32 words
    [U1, W]).  With `cols` (i32, padded with the sentinel N) only those
    columns are recomputed, into COPIES of base_u / fit_u: the resident
    buffers are never written."""
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
        base = torch.empty((U1, N), dtype=torch.float32, device=dev)
        fit = torch.empty((U1, W), dtype=torch.int32, device=dev)
        D, cols_ptr = 0, None
    else:
        _check(cols, "cols", torch.int32, (cols.shape[0],), dev)
        _check(base_u, "base_u", torch.float32, (U1, N), dev)
        _check(fit_u, "fit_u", torch.int32, (U1, W), dev)
        base, fit = base_u.clone(), fit_u.clone()  # the donation-aliasing rule
        D, cols_ptr = cols.shape[0], cols.data_ptr()
    with torch.cuda.device(dev):
        err = fn(
            req_u.data_ptr(), node_used.data_ptr(), node_alloc.data_ptr(), cols_ptr, D,
            _host(ip), _host(fp), base.data_ptr(), fit.data_ptr(), U1, N, R, _stream(dev),
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
    s2 = torch.empty((U1, E), dtype=torch.float32, device=dev)
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
            t0u.data_ptr(), tv.data_ptr(), ti.data_ptr(), nf.data_ptr(), s2.data_ptr(), bmax.data_ptr(),
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
    int32[2] device pair (sweeps, status): read_sweeps).  Every round
    commits a pod, so a chunk takes at most INC_CHUNK rounds; the kernel
    stops a chunk past that cap and reports it in the status."""
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
    scal = torch.zeros((2,), dtype=torch.int32, device=dev)
    topv = torch.empty((C, K), dtype=torch.float32, device=dev)
    topi = torch.empty((C, K), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fn(
            arr.pod_req.data_ptr(), arr.pod_valid.data_ptr(), inc.cls.data_ptr(), arr.node_alloc.data_ptr(),
            inc.req_u.data_ptr(), inc.stat_u.data_ptr(), inc.fit_u.data_ptr(), inc.base_u.data_ptr(),
            used_w.data_ptr(), None if t0u_w is None else t0u_w.data_ptr(), *wptrs,
            choices.data_ptr(), used.data_ptr(), t0u.data_ptr(), ords.data_ptr(), scal.data_ptr(),
            topv.data_ptr(), topi.data_ptr(), _host(ip), _host(fp), P, N, R, U1, C, SPEC_ITERS, _stream(dev),
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

def packed_static_rows(arr) -> torch.Tensor:
    """K7 (csrc/class_hoist.cu): static feasibility of every pod row,
    pod_valid included, as int32 words [P, ceil(N/32)] written by warp
    ballot (no dense bool plane)."""
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
    TW = max(1, -(-T // 32))
    tm = torch.empty((S, N), dtype=torch.uint8, device=dev)
    taint_w = torch.empty((N, TW), dtype=torch.int32, device=dev)
    tol_w = torch.empty((P, TW), dtype=torch.int32, device=dev)
    sfs = torch.empty((P, -(-N // 32)), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fn(
            arr.node_valid.data_ptr(), arr.node_taint_ns.data_ptr(), arr.node_labels.data_ptr(),
            arr.pod_valid.data_ptr(), arr.pod_tol_ns.data_ptr(), arr.pod_nodename.data_ptr(),
            arr.pod_terms.data_ptr(), arr.pod_has_sel.data_ptr(), arr.sel_mask.data_ptr(),
            arr.sel_kind.data_ptr(), tm.data_ptr(), taint_w.data_ptr(), tol_w.data_ptr(), sfs.data_ptr(),
            P, N, T, TT, S, E, L, _stream(dev),
        )
    _raise_on(err, "packed_static_rows")
    LAUNCHES["packed_static_rows"] += 1
    return sfs


def chunk_rounds_dense(arr, cfg, sfs: torch.Tensor):
    """K8 (csrc/chunk_rounds_dense.cu): the dense chunked scan in one
    launch, chunks of CHUNK pods, from the cycle start's usage and K7's
    packed static plane -> (choices i32[P], used i32[N, R], ordinals i32[P],
    the int32[2] device pair (sweeps, status): read_sweeps)."""
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
    choices = torch.empty((P,), dtype=torch.int32, device=dev)
    used = torch.empty((N, R), dtype=torch.int32, device=dev)
    ords = torch.empty((P,), dtype=torch.int32, device=dev)
    scal = torch.zeros((2,), dtype=torch.int32, device=dev)
    total0 = torch.empty((C, N), dtype=torch.float32, device=dev)
    topv = torch.empty((C, K), dtype=torch.float32, device=dev)
    topi = torch.empty((C, K), dtype=torch.int32, device=dev)
    nf = torch.empty((C,), dtype=torch.int32, device=dev)
    bits = torch.empty((2, W), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fn(
            arr.pod_req.data_ptr(), arr.pod_valid.data_ptr(), arr.node_alloc.data_ptr(), arr.node_used.data_ptr(),
            sfs.data_ptr(), choices.data_ptr(), used.data_ptr(), ords.data_ptr(), scal.data_ptr(),
            total0.data_ptr(), topv.data_ptr(), topi.data_ptr(), nf.data_ptr(), bits.data_ptr(),
            _host(ip), _host(fp), P, N, R, C, SPEC_ITERS, _stream(dev),
        )
    _raise_on(err, "chunk_rounds_dense")
    LAUNCHES["chunk_rounds_dense"] += 1
    return choices, used, ords, scal


def unpack_planes(words: torch.Tensor, n: int) -> torch.Tensor:
    """K9 (csrc/unpack_planes.cu): int32 words [..., ceil(n/32)] -> bool
    [..., n], the packed layout of ops/bitplane.py."""
    dev = words.device
    _need_cuda(dev, "unpack_planes")
    W = -(-n // 32)
    if words.dtype != torch.int32 or words.shape[-1] != W or not words.is_contiguous():
        raise ValueError(f"unpack_planes: expected contiguous int32 words [..., {W}], got "
                         f"{words.dtype} {tuple(words.shape)}")
    fn = _fn("unpack_planes")
    out = torch.empty(tuple(words.shape[:-1]) + (n,), dtype=torch.bool, device=dev)
    rows = words.numel() // W if W else 0
    with torch.cuda.device(dev):
        err = fn(words.data_ptr(), out.data_ptr(), rows, W, n, _stream(dev))
    _raise_on(err, "unpack_planes")
    LAUNCHES["unpack_planes"] += 1
    return out
