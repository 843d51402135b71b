"""NumPy mirror of the kernels' static (batch-wide) stage, feeding the native
C++ engine (the JAX package's native/static_np.py).  Every array it produces
is exact-integer-valued in f32 (counts of matches / weights), so the native
engine and the device routes see bitwise-identical inputs.

The inputs are host arrays (native.host_arrays).  The port's encoder keeps
node_labels and sel_mask as bool, where the JAX package keeps f32: an
einsum over bools is a logical OR, not a count, so the term match takes
both as f32 here, as every other einsum takes its bool operands.
"""

from __future__ import annotations

import numpy as np

from ..api import vocab as v
from ..ops.bitplane import bf16_round_np


def _f32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def term_match(sel_mask: np.ndarray, sel_kind: np.ndarray, node_labels: np.ndarray) -> np.ndarray:
    counts = np.einsum("sel,nl->sen", _f32(sel_mask), _f32(node_labels))
    kind = sel_kind[:, :, None]
    ok = np.where(
        kind == v.KIND_ANY,
        counts > 0,
        np.where(kind == v.KIND_NONE, counts == 0, kind == v.KIND_PAD),
    )
    return ok.all(axis=1)  # [S, N]


def static_feasible(arr):
    """(sf [P,N] u8, nodesel [P,N] u8, tm [S,N]) — mirror of ops/filters."""
    tm = term_match(arr.sel_mask, arr.sel_kind, arr.node_labels)
    ids = np.maximum(arr.pod_terms, 0)
    per_term = tm[ids] & (arr.pod_terms >= 0)[:, :, None]
    nodesel = np.where(arr.pod_has_sel[:, None], per_term.any(axis=1), True)
    intolerable = np.einsum(
        "pt,nt->pn",
        (~arr.pod_tol_ns).astype(np.float32),
        arr.node_taint_ns.astype(np.float32),
    )
    pin = arr.pod_nodename[:, None]
    n_idx = np.arange(arr.N, dtype=np.int32)[None, :]
    nodename_ok = np.where(pin == -1, True, pin == n_idx)
    sf = (
        arr.node_valid[None, :]
        & arr.pod_valid[:, None]
        & (intolerable == 0)
        & nodesel
        & nodename_ok
    )
    return sf.astype(np.uint8), nodesel.astype(np.uint8), tm


def taint_prefer_counts(arr) -> np.ndarray:
    # storage-lattice mirror (bf16, or f32 under KTPU_SCORE_DTYPE=f32) of the device producer (ops/scores.py)
    return bf16_round_np(np.einsum(
        "pt,nt->pn",
        (~arr.pod_tol_pref).astype(np.float32),
        arr.node_taint_pref.astype(np.float32),
    ))


def preferred_na_raw(arr, tm: np.ndarray) -> np.ndarray:
    P, PW = arr.pod_pref_terms.shape
    S = tm.shape[0]
    ids = np.maximum(arr.pod_pref_terms, 0)
    w = np.where(arr.pod_pref_terms >= 0, arr.pod_pref_weights, 0.0).astype(np.float32)
    W = np.zeros((P, S), dtype=np.float32)
    np.add.at(W, (np.arange(P)[:, None], ids), w)
    # storage-lattice mirror (bf16, or f32 under KTPU_SCORE_DTYPE=f32) of the device producer (ops/assign.py)
    return bf16_round_np(W @ tm.astype(np.float32))
