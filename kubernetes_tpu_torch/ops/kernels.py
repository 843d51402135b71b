"""Build, load and launch the port's hand-written CUDA kernels.

Each source under csrc/ is compiled by nvcc for sm_90a (-fmad=false: no FMA
contraction, so f32 results match the plain versions bit for bit) into its
own shared library with a plain C interface, at first use, into _build/
(git-ignored).  All nvcc processes start together.  The libraries are loaded
with ctypes; pointers and the stream go in as c_void_p.

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

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = {"static_feasible": "static_feasible.cu", "fit_scan": "fit_scan.cu"}

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_ARGTYPES = {
    "static_feasible": ("ktt_static_feasible", [_P] * 14 + [_I] * 7 + [_P]),
    "fit_scan": ("ktt_fit_scan", [_P] * 6 + [_I, _U, _P, _I, _I, _F, _F, _I, _I, _I, _P, _P, _P]),
}
STRATEGY_CODES = {"LeastAllocated": 0, "MostAllocated": 1, "RequestedToCapacityRatio": 2}
MAX_R, MAX_K, MAX_SHAPE = 32, 8, 16  # csrc/fit_scan.cu limits
# fit_scan double-buffers two sf rows in shared memory: 2 * N bytes of the
# 227 KB a block may have, less what its static buffers take
MAX_SCAN_NODES = (232448 - 1024) // 2

# launches per kernel since the last reset_launches()
LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}
# nvcc's output per kernel library built by this process (ptxas -v lines)
BUILD_LOG: Dict[str, str] = {}
_FNS: Dict[str, object] = {}
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
    """Compile (if needed) and load the named kernel libraries; all nvcc
    processes run at once.  Raises with nvcc's output on a failed build."""
    names = list(SOURCES if names is None else names)
    with _LOCK:
        todo = [n for n in names if n not in _FNS]
        if not todo:
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        outs, procs = {}, {}
        for name in todo:
            src = CSRC / SOURCES[name]
            digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
            out = BUILD_DIR / f"lib{name}-{digest}.so"
            outs[name] = out
            if out.exists():
                continue
            tmp = BUILD_DIR / f".{out.name}.{os.getpid()}.tmp"
            procs[name] = (
                subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                ),
                tmp,
            )
        failed = []
        for name, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            BUILD_LOG[name] = log
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {SOURCES[name]} (exit {proc.returncode}):\n{log}")
            else:
                os.replace(tmp, outs[name])
        if failed:
            raise RuntimeError("\n".join(failed))
        for name in todo:
            sym, argtypes = _ARGTYPES[name]
            fn = getattr(ctypes.CDLL(str(outs[name])), sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _FNS[name] = fn


def _fn(name: str):
    if name not in _FNS:
        build([name])
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
