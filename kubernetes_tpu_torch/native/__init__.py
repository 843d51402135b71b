"""The host-side native code: the sequential C++ commit engine behind the
Scheduler's mode="native" (scheduler.cpp) and the C spec interner under
every encode (interner.c, loaded by pyintern.py) — the JAX package's
native/, its sources copied.

Both libraries are built at first use with the host compiler (g++ / gcc)
into the package's git-ignored ``_build/`` (``build_library``: named by a
digest of the source and flags, compiled to a file of the building process
and published with an atomic rename, so concurrent processes never load a
half-written library).  A failed build raises with the compiler's output;
nothing falls back.

    schedule_batch_native(arr, cfg) -> (choices i32[P], used i32[N, R])
    schedule_with_gangs_native(arr, cfg) -> the same, honoring PodGroups

`arr` is a cycle's host arrays (DeltaEncoder.encode: numpy; or tensors on
the CPU); a tensor on the card is refused.  The f32 arithmetic is the
device kernels' op for op (-ffp-contract=off), so the choices equal the
other routes' and the oracle's.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..api.snapshot import ClusterArrays
from ..ops.bitplane import score_values_np
from ..ops.scores import ScoreConfig

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
ENGINE_SRC = _DIR / "scheduler.cpp"
ENGINE_FLAGS = ("-O2", "-shared", "-fPIC", "-ffp-contract=off")
_LOCK = threading.Lock()
_lib = None


def build_library(src: Path, compiler: str, flags: Sequence[str], key: bytes = b"") -> Path:
    """Compile `src` into BUILD_DIR unless a build of the same source,
    compiler, flags and `key` is there -> the library's path.  Raises with
    the compiler's output on a failed build."""
    digest = hashlib.sha256(src.read_bytes() + " ".join((compiler, *flags)).encode() + key).hexdigest()[:16]
    out = BUILD_DIR / f"lib{src.stem}-{digest}.so"
    if out.exists():
        return out
    exe = shutil.which(compiler)
    if exe is None:
        raise RuntimeError(f"{compiler} not found: {src.name} cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{out.name}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        proc = subprocess.run([exe, *flags, "-o", str(tmp), str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{compiler} failed for {src.name} (exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


def build() -> None:
    """Build (if needed) and load both host libraries."""
    from . import pyintern

    _load()
    pyintern.load()


class _View(ctypes.Structure):
    _fields_ = [
        ("N", ctypes.c_int32), ("P", ctypes.c_int32), ("R", ctypes.c_int32),
        ("T", ctypes.c_int32), ("K", ctypes.c_int32), ("D1", ctypes.c_int32),
        ("C", ctypes.c_int32), ("A1", ctypes.c_int32), ("A2", ctypes.c_int32),
        ("PT", ctypes.c_int32), ("B", ctypes.c_int32),
        ("alloc", ctypes.c_void_p), ("used", ctypes.c_void_p),
        ("node_dom", ctypes.c_void_p), ("ports_used", ctypes.c_void_p),
        ("req", ctypes.c_void_p), ("sf", ctypes.c_void_p),
        ("pref", ctypes.c_void_p), ("na_raw", ctypes.c_void_p),
        ("pod_valid", ctypes.c_void_p), ("nodesel", ctypes.c_void_p),
        ("pod_ports", ctypes.c_void_p),
        ("term_key", ctypes.c_void_p), ("m_pend", ctypes.c_void_p),
        ("counts", ctypes.c_void_p), ("anti_counts", ctypes.c_void_p),
        ("aff_terms", ctypes.c_void_p), ("anti_terms", ctypes.c_void_p),
        ("spread_terms", ctypes.c_void_p), ("spread_skew", ctypes.c_void_p),
        ("spread_hard", ctypes.c_void_p), ("img", ctypes.c_void_p),
        ("pref_t", ctypes.c_void_p), ("pref_w", ctypes.c_void_p),
        ("pref_own", ctypes.c_void_p),
        ("w_fit", ctypes.c_float), ("w_bal", ctypes.c_float),
        ("w_taint", ctypes.c_float), ("w_na", ctypes.c_float),
        ("w_spread", ctypes.c_float), ("w_img", ctypes.c_float),
        ("w_interpod", ctypes.c_float), ("w_hard", ctypes.c_float),
        ("r0", ctypes.c_int32), ("r1", ctypes.c_int32),
        ("enable_pairwise", ctypes.c_uint8), ("enable_ports", ctypes.c_uint8),
        ("enable_taint", ctypes.c_uint8), ("enable_na", ctypes.c_uint8),
        ("enable_img", ctypes.c_uint8), ("enable_ip", ctypes.c_uint8),
        # NodeResourcesFit scoringStrategy (0 Least, 1 Most, 2 RTCR) + shape
        ("fit_strategy", ctypes.c_int32), ("n_shape", ctypes.c_int32),
        ("shape_x", ctypes.c_float * 8), ("shape_y", ctypes.c_float * 8),
    ]


def _strategy_code(cfg) -> int:
    codes = {"LeastAllocated": 0, "MostAllocated": 1,
             "RequestedToCapacityRatio": 2}
    code = codes.get(cfg.fit_strategy)
    if code is None:
        raise ValueError(f"unknown fit scoringStrategy {cfg.fit_strategy!r}")
    if code == 2 and len(cfg.rtcr_shape) > 8:
        # the View struct carries at most 8 points; silent truncation would
        # diverge from the kernels, so refuse loudly
        raise ValueError("rtcr shape supports at most 8 points")
    return code


def _load():
    global _lib
    with _LOCK:
        if _lib is None:
            lib = ctypes.CDLL(str(build_library(ENGINE_SRC, "g++", ENGINE_FLAGS)))
            lib.schedule_native.restype = ctypes.c_int
            lib.schedule_native.argtypes = [ctypes.POINTER(_View), ctypes.c_void_p]
            _lib = lib
    return _lib


def _ptr(a: Optional[np.ndarray]):
    return a.ctypes.data_as(ctypes.c_void_p) if a is not None else None


def host_arrays(arr) -> ClusterArrays:
    """`arr` as numpy arrays on the host, image_score as the f32 values of
    its bf16 bit patterns (the JAX arrays keep bf16, which the engine reads
    as f32), or its f32 values under KTPU_SCORE_DTYPE=f32.  The bool label planes static_np takes as f32 itself.  A
    tensor on the card is refused: the engine reads host arrays, never a
    quiet copy back."""
    out = {}
    for name in ClusterArrays.FIELDS:
        a = getattr(arr, name)
        if isinstance(a, torch.Tensor):
            if a.device.type != "cpu":
                raise ValueError(f"the native engine reads host arrays: {name} is on {a.device} "
                                 "(pass DeltaEncoder.encode's arrays)")
            a = a.view(torch.int16).numpy().view(np.uint16) if a.dtype == torch.bfloat16 else a.numpy()
        out[name] = np.asarray(a)
    out["image_score"] = score_values_np(out["image_score"])
    return ClusterArrays(**out)


def schedule_batch_native(
    arr, cfg: ScoreConfig
) -> Tuple[np.ndarray, np.ndarray]:
    from .static_np import preferred_na_raw, static_feasible, taint_prefer_counts

    arr = host_arrays(arr)
    lib = _load()
    if arr.pod_spread_terms.shape[1] > 8:
        raise ValueError("native engine supports at most 8 spread constraints per pod")
    sf, nodesel, tm = static_feasible(arr)
    nodesel = (nodesel & arr.node_valid[None, :].astype(np.uint8)).astype(np.uint8)
    pref = (
        np.ascontiguousarray(taint_prefer_counts(arr)) if cfg.enable_taint_score else None
    )
    na = np.ascontiguousarray(preferred_na_raw(arr, tm)) if cfg.enable_node_pref else None
    enable_img = cfg.enable_image and arr.image_score.shape[1] == arr.N
    img = np.ascontiguousarray(arr.image_score) if enable_img else None

    used = np.ascontiguousarray(arr.node_used.astype(np.int32)).copy()
    counts = np.ascontiguousarray(arr.term_counts0.astype(np.float32)).copy()
    anti = np.ascontiguousarray(arr.anti_counts0.astype(np.float32)).copy()
    pref_own = np.ascontiguousarray(arr.pref_own0.astype(np.float32)).copy()
    ports_used = np.ascontiguousarray(arr.node_ports0.astype(np.uint8)).copy()
    choices = np.full(arr.P, -1, dtype=np.int32)

    c = lambda a, dt: np.ascontiguousarray(a.astype(dt))  # noqa: E731
    keep = dict(  # keep references alive across the C call
        alloc=c(arr.node_alloc, np.int32), req=c(arr.pod_req, np.int32),
        sf=sf, nodesel=nodesel, pod_valid=c(arr.pod_valid, np.uint8),
        node_dom=c(arr.node_dom, np.int32), term_key=c(arr.term_key, np.int32),
        m_pend=c(arr.m_pend, np.float32),
        aff=c(arr.pod_aff_terms, np.int32), anti_t=c(arr.pod_anti_terms, np.int32),
        st=c(arr.pod_spread_terms, np.int32), sk=c(arr.pod_spread_maxskew, np.int32),
        sh=c(arr.pod_spread_hard, np.uint8), pp=c(arr.pod_ports, np.uint8),
        pt=c(arr.pod_pref_aff_terms, np.int32), pw=c(arr.pod_pref_aff_w, np.float32),
    )
    view = _View(
        N=arr.N, P=arr.P, R=arr.R,
        T=arr.term_key.shape[0], K=arr.node_dom.shape[0],
        D1=arr.term_counts0.shape[1],
        C=arr.pod_spread_terms.shape[1], A1=arr.pod_aff_terms.shape[1],
        A2=arr.pod_anti_terms.shape[1], PT=arr.pod_ports.shape[1],
        B=arr.pod_pref_aff_terms.shape[1],
        alloc=_ptr(keep["alloc"]), used=_ptr(used),
        node_dom=_ptr(keep["node_dom"]), ports_used=_ptr(ports_used),
        req=_ptr(keep["req"]), sf=_ptr(keep["sf"]),
        pref=_ptr(pref), na_raw=_ptr(na),
        pod_valid=_ptr(keep["pod_valid"]), nodesel=_ptr(keep["nodesel"]),
        pod_ports=_ptr(keep["pp"]),
        term_key=_ptr(keep["term_key"]), m_pend=_ptr(keep["m_pend"]),
        counts=_ptr(counts), anti_counts=_ptr(anti),
        aff_terms=_ptr(keep["aff"]), anti_terms=_ptr(keep["anti_t"]),
        spread_terms=_ptr(keep["st"]), spread_skew=_ptr(keep["sk"]),
        spread_hard=_ptr(keep["sh"]), img=_ptr(img),
        pref_t=_ptr(keep["pt"]), pref_w=_ptr(keep["pw"]), pref_own=_ptr(pref_own),
        w_fit=cfg.fit_weight, w_bal=cfg.balanced_weight,
        w_taint=cfg.taint_weight, w_na=cfg.node_affinity_weight,
        w_spread=cfg.spread_weight, w_img=cfg.image_weight,
        w_interpod=cfg.interpod_weight,
        w_hard=cfg.hard_pod_affinity_weight,
        r0=cfg.score_resources[0], r1=cfg.score_resources[1],
        enable_pairwise=int(cfg.enable_pairwise), enable_ports=int(cfg.enable_ports),
        enable_taint=int(cfg.enable_taint_score), enable_na=int(cfg.enable_node_pref),
        enable_img=int(enable_img),
        enable_ip=int(cfg.enable_pairwise and cfg.enable_interpod_score),
        fit_strategy=_strategy_code(cfg),
        n_shape=len(cfg.rtcr_shape),
        shape_x=(ctypes.c_float * 8)(*[p[0] for p in cfg.rtcr_shape]),
        shape_y=(ctypes.c_float * 8)(*[p[1] for p in cfg.rtcr_shape]),
    )
    rc = lib.schedule_native(ctypes.byref(view), _ptr(choices))
    if rc != 0:
        raise RuntimeError(f"native scheduler failed rc={rc}")
    return choices, used


def schedule_with_gangs_native(
    arr, cfg: ScoreConfig
) -> Tuple[np.ndarray, np.ndarray]:
    """Gang fixpoint (ops/gang.py semantics) over the native engine."""
    from ..ops.gang import failed_groups

    arr = host_arrays(arr)
    pod_valid = arr.pod_valid.copy()
    pod_group = arr.pod_group
    while True:
        arr_i = dataclasses.replace(arr, pod_valid=pod_valid)
        choices, used = schedule_batch_native(arr_i, cfg)
        bad = failed_groups(choices, pod_group, arr.group_min, active=pod_valid)
        if not bad.any():
            return choices, used
        in_bad = bad[np.maximum(pod_group, 0)] & (pod_group >= 0) & pod_valid
        first_g = pod_group[int(np.argmax(in_bad))]
        pod_valid = pod_valid & ~((pod_group == first_g) & pod_valid)
