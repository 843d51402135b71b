"""Unschedulable diagnosis — the port of the JAX package's ``ops/explain.py``.

The batch step fuses every filter into one eligibility mask, so a verdict of
-1 carries no reason.  This module re-derives the reasons on demand, for the
FAILED equivalence classes only, off the step: one evaluation over the class
representatives gives i32[F, 4+R+1] per-class {reason -> node count} vectors,
decoded through the class index to per-pod upstream-shaped messages
("0/5000 nodes are available: 2000 Insufficient cpu, 1500 node(s) had
untolerated taint.").

Every VALID node is claimed by exactly one reason, the first failing filter
in the reference's plugin order

  NodeName > NodeUnschedulable > TaintToleration > NodeAffinity >
  NodeResourcesFit (first insufficient resource in meta.resources order) >
  residual ("otherwise feasible": blocked in-scan by commit-state terms)

so each class's counts sum to the valid-node count.  Counts are taken at the
CALLER-SUPPLIED node usage (the scheduler passes post-cycle usage).

``explain_classes`` dispatches on the arrays' device: the plain version
``explain_counts_plain`` for CPU tensors, kernel K14 ``explain_counts``
(csrc/explain.cu) for CUDA tensors.  ``explain_oracle`` is the independent
per-node host recount both are held to.  KTPU_EXPLAIN=1 is the scheduler's
gate for the whole plane (``explain_enabled``).
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..api import vocab as v
from .filters import term_match

# fixed reason codes (column order; the fit columns follow at
# FIT_BASE..FIT_BASE+R-1, the residual "otherwise feasible" column is last)
R_NODENAME = 0
R_UNSCHED = 1
R_TAINT = 2
R_AFFINITY = 3
FIT_BASE = 4

LBL_NODENAME = "node(s) didn't match the requested node name"
LBL_UNSCHED = "node(s) were unschedulable"
LBL_TAINT = "node(s) had untolerated taint"
LBL_AFFINITY = "node(s) didn't match Pod's node affinity/selector"
LBL_FEASIBLE = "node(s) were otherwise feasible (blocked in-scan: capacity race, pod affinity/spread/ports, or gang quorum)"


def explain_enabled() -> bool:
    """KTPU_EXPLAIN=1 arms the diagnosis plane (default off): the
    Scheduler's batch cycle then diagnoses its failed pods
    (scheduler/scheduler.py — _diagnose_failed)."""
    return os.environ.get("KTPU_EXPLAIN", "") == "1"


def n_reasons(n_resources: int) -> int:
    return FIT_BASE + n_resources + 1


def reason_labels(resources: Sequence[str]) -> List[str]:
    """Column index -> upstream-shaped reason label (fitError vocabulary)."""
    return [LBL_NODENAME, LBL_UNSCHED, LBL_TAINT, LBL_AFFINITY] + [f"Insufficient {r}" for r in resources] + [LBL_FEASIBLE]


def explain_counts_plain(arr, node_used: torch.Tensor, reps: torch.Tensor, rep_valid: torch.Tensor) -> torch.Tensor:
    """i32[F, 4+R+1] one-reason-per-node counts for the pod rows `reps`
    (i64[F]) at usage `node_used`; rows with `rep_valid` false are zero.
    The plain version of kernel K14 (the JAX package's explain.py:86
    _explain_kernel): the same per-filter masks, claimed in plugin order."""
    N = arr.N
    R = arr.R
    dev = arr.device
    valid = arr.node_valid[None, :]
    rep_req = arr.pod_req[reps]
    rep_tol = arr.pod_tol_ns[reps]
    rep_terms = arr.pod_terms[reps]

    n_idx = torch.arange(N, dtype=torch.int32, device=dev)[None, :]
    pin = arr.pod_nodename[reps][:, None]
    name_bad = (pin != -1) & (pin != n_idx)
    # a counting product over the taint vocab, exact in f32 (< 2^24 taints)
    intolerable = ((~rep_tol).to(torch.float32) @ arr.node_taint_ns.to(torch.float32).T) > 0
    unsched_bad = intolerable & arr.node_unsched[None, :]
    taint_bad = intolerable & ~arr.node_unsched[None, :]
    tm = term_match(arr.sel_mask, arr.sel_kind, arr.node_labels)
    per_term = tm[torch.clamp_min(rep_terms, 0).long()] & (rep_terms >= 0)[:, :, None]
    aff_bad = arr.pod_has_sel[reps][:, None] & ~per_term.any(dim=1)
    free = arr.node_alloc - node_used  # [N, R]
    req = rep_req[:, None, :]
    short = (req != 0) & (req > free[None, :, :])  # [F, N, R]
    fit_bad = short.any(dim=2)

    claimed = torch.zeros_like(name_bad)
    cols = []
    for mask in (name_bad, unsched_bad, taint_bad, aff_bad):
        claim = mask & ~claimed & valid
        cols.append(claim.sum(dim=1))
        claimed = claimed | claim
    fit_claim = fit_bad & ~claimed & valid
    if R:
        first_r = short.to(torch.uint8).argmax(dim=2)  # the first insufficient resource
        onehot = (torch.arange(R, device=dev)[None, None, :] == first_r[:, :, None]) & fit_claim[:, :, None]
        fit_counts = onehot.sum(dim=1)
    else:  # no resources: no fit column (an argmax over none is refused)
        fit_counts = torch.zeros((reps.shape[0], 0), dtype=torch.int64, device=dev)
    claimed = claimed | fit_claim
    feasible = (valid & ~claimed).sum(dim=1)
    out = torch.cat([torch.stack(cols, dim=1), fit_counts, feasible[:, None]], dim=1).to(torch.int32)
    return torch.where(rep_valid[:, None], out, torch.zeros((), dtype=torch.int32, device=dev))


def _pad_pow2(n: int, minimum: int = 4) -> int:
    p = minimum
    while p < n:
        p *= 2
    return p


def explain_classes(arr, reps: np.ndarray, node_used=None) -> np.ndarray:
    """Per-class reason counts: i64[F, 4+R+1] for the class representatives
    `reps` (pod row indices).  `node_used` (numpy or a tensor, [N, R])
    defaults to the encoded usage; the scheduler passes post-cycle usage.
    F is padded to the next power of two (at least 4), the padded rows
    invalid, as the JAX package pads its jit signature.  On a CUDA `arr`
    kernel K14 counts, on a CPU `arr` the plain version."""
    reps = np.asarray(reps, dtype=np.int64)
    k = n_reasons(arr.R)
    if reps.size == 0:
        return np.zeros((0, k), dtype=np.int64)
    dev = arr.device
    used = arr.node_used if node_used is None else torch.as_tensor(node_used).to(dev, torch.int32).contiguous()
    f_pad = _pad_pow2(int(reps.size))
    pad_reps = np.zeros(f_pad, dtype=np.int64)
    pad_reps[: reps.size] = reps
    rep_valid = np.zeros(f_pad, dtype=bool)
    rep_valid[: reps.size] = True
    pr = torch.from_numpy(pad_reps).to(dev)
    rv = torch.from_numpy(rep_valid).to(dev)
    if dev.type == "cpu":
        counts = explain_counts_plain(arr, used, pr, rv)
    else:
        from . import kernels

        counts = kernels.explain_counts(arr, used, pr, rv)
    return counts.cpu().numpy()[: reps.size].astype(np.int64)


def explain_oracle(arr, reps: Sequence[int], node_used=None) -> np.ndarray:
    """Independent host recount of explain_classes: a per-node Python/numpy
    walk of the same attribution rule (the JAX package's explain.py:199)."""

    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    used = host(arr.node_used if node_used is None else node_used).astype(np.int64)
    alloc = host(arr.node_alloc).astype(np.int64)
    R = alloc.shape[1]
    k = n_reasons(R)
    out = np.zeros((len(reps), k), dtype=np.int64)
    node_valid = host(arr.node_valid)
    node_unsched = host(arr.node_unsched)
    node_taint = host(arr.node_taint_ns)
    sel_mask = host(arr.sel_mask)  # [S, E, L]
    sel_kind = host(arr.sel_kind)  # [S, E]
    node_labels = host(arr.node_labels)  # [N, L]
    pod_req, pod_tol = host(arr.pod_req), host(arr.pod_tol_ns)
    pod_nodename, pod_terms, pod_has_sel = host(arr.pod_nodename), host(arr.pod_terms), host(arr.pod_has_sel)
    cnt = np.einsum("sel,nl->sen", sel_mask.astype(np.int64), node_labels.astype(np.int64))
    kind = sel_kind[:, :, None]
    ok_e = np.where(kind == v.KIND_ANY, cnt > 0, np.where(kind == v.KIND_NONE, cnt == 0, kind == v.KIND_PAD))
    tm = ok_e.all(axis=1)  # [S, N]
    for f, p in enumerate(reps):
        p = int(p)
        req = pod_req[p].astype(np.int64)
        tol = pod_tol[p]
        pin = int(pod_nodename[p])
        terms = [int(s) for s in pod_terms[p] if s >= 0]
        has_sel = bool(pod_has_sel[p])
        for n in range(alloc.shape[0]):
            if not node_valid[n]:
                continue
            if pin != -1 and pin != n:
                out[f, R_NODENAME] += 1
                continue
            intol = bool(np.any(node_taint[n] & ~tol))
            if intol and bool(node_unsched[n]):
                out[f, R_UNSCHED] += 1
                continue
            if intol:
                out[f, R_TAINT] += 1
                continue
            if has_sel and not any(tm[s, n] for s in terms):
                out[f, R_AFFINITY] += 1
                continue
            short = [j for j in range(R) if req[j] != 0 and req[j] > alloc[n, j] - used[n, j]]
            if short:
                out[f, FIT_BASE + short[0]] += 1
                continue
            out[f, k - 1] += 1
    return out


def render_unschedulable(n_nodes: int, counts: Mapping[str, int]) -> str:
    """fitError.Error()'s shape: "0/N nodes are available: c1 reason1, c2
    reason2." with the reasons by descending count, then label."""
    present = sorted(((int(c), lbl) for lbl, c in counts.items() if c > 0), key=lambda cl: (-cl[0], cl[1]))
    head = f"0/{n_nodes} nodes are available"
    if not present:
        return head + "."
    return head + ": " + ", ".join(f"{c} {lbl}" for c, lbl in present) + "."


def dominant_reason(counts: Mapping[str, int]) -> str:
    """The reason label claiming the most nodes; ties go to the EARLIER entry
    of the mapping's insertion order."""
    best, best_c = "", -1
    for lbl, c in counts.items():
        if int(c) > best_c:
            best, best_c = lbl, int(c)
    return best


def diagnose_failed(arr, meta, failed_rows: Sequence[int],
                    node_used=None) -> Tuple[Dict[int, str], Dict[int, str], List[dict]]:
    """Group the failed device rows by class (api/delta.class_groups), run
    ONE evaluation over the class reps and map the per-class vectors back to
    the rows -> ({row: message}, {row: dominant reason label}, per-class
    records [{rep_row, pods, counts}])."""
    from ..api.delta import class_groups

    reps, group_of = class_groups(meta, failed_rows)
    if reps.size == 0:
        return {}, {}, []
    counts = explain_classes(arr, reps, node_used)
    labels = reason_labels(meta.resources)
    per_class_counts: List[Dict[str, int]] = []
    class_msgs: List[str] = []
    class_dom: List[str] = []
    for g in range(reps.size):
        cc = {labels[j]: int(counts[g, j]) for j in range(len(labels)) if counts[g, j] > 0}
        per_class_counts.append(cc)
        class_msgs.append(render_unschedulable(meta.n_nodes, cc))
        class_dom.append(dominant_reason(cc))
    messages = {int(r): class_msgs[g] for r, g in group_of.items()}
    dominant = {int(r): class_dom[g] for r, g in group_of.items()}
    pods_per_class = [0] * reps.size
    for g in group_of.values():
        pods_per_class[g] += 1
    records = [{"rep_row": int(reps[g]), "pods": pods_per_class[g], "counts": per_class_counts[g]}
               for g in range(reps.size)]
    return messages, dominant, records


__all__ = [
    "explain_enabled", "n_reasons", "reason_labels", "explain_counts_plain", "explain_classes",
    "explain_oracle", "render_unschedulable", "dominant_reason", "diagnose_failed",
]
