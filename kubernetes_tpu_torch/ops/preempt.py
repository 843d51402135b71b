"""Batched preemption: victim search as masked rescoring over the node axis —
the port of the JAX package's ``ops/preempt.py``.

For each preemptor, in one evaluation over every node (the semantics of the
CPU evaluator's SelectVictimsOnNode):

  phase A  remove ALL lower-priority pods per node; feasibility = the static
           row (taints / selector / nodeName) AND fit against (used -
           victims + nominated reservations)
  phase B  the reprieve scan over the victim slots, in the order the host
           supplies (PDB-violating first, then non-violating, each by
           (-priority, uid)): re-add slot j on every node at once, keep it
           iff the preemptor still fits
  phase C  the candidate stats of pickOneNodeForPreemption's lexicographic
           key (violations, max victim priority, priority sum, victim count)
           — the host does the final argmin and the eviction
           (scheduler/preemption.py)

``preempt_eval_wave`` evaluates K same-priority preemptors against one
shared state snapshot; ``preempt_eval`` is one preemptor.  On CUDA tensors
the static rows come from kernel K3 (class_static_hoist over the wave's pod
rows) and phases A-C from kernel K15 ``preempt_eval`` (csrc/preempt.cu);
on CPU tensors the plain versions below run.  Inputs may be numpy arrays:
they are placed on the arrays' device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..device import h2d
from . import filters

INT32_MIN = -(2**31)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor as int32 with two's-complement wrap (XLA's int32 sums)."""
    return ((x + 2**31) % 2**32 - 2**31).to(torch.int32)


def static_rows_plain(arr, pod_idxs: torch.Tensor) -> torch.Tensor:
    """bool[K, N]: each preemptor's capacity-independent feasibility row,
    the terms of the scan's static plane without pod_valid (the JAX
    package's preempt.py:40 _static_row, for K rows)."""
    idx = pod_idxs.long()
    tm = filters.term_match(arr.sel_mask, arr.sel_kind, arr.node_labels)
    every = torch.ones(idx.shape[0], dtype=torch.bool, device=arr.device)
    return filters.static_feasible_rows(
        tm, arr.node_valid, arr.node_taint_ns, torch.arange(arr.N, dtype=torch.int32, device=arr.device),
        arr.pod_terms[idx], arr.pod_has_sel[idx], arr.pod_tol_ns[idx], arr.pod_nodename[idx], every)[0]


def preempt_eval_plain(arr, pod_idxs: torch.Tensor, static_ok: torch.Tensor, used_now, nom_extra, has_nom,
                       vict_req, vict_prio, vict_viol, vict_valid) -> Tuple[torch.Tensor, ...]:
    """Phases A-C for the K rows `pod_idxs` with static rows `static_ok`
    [K, N] -> (cand bool[K, N], nvio, vmax, vsum, vcnt i32[K, N], is_victim
    bool[K, N, V], static_ok bool[K, N]).  The plain version of kernel K15
    (the JAX package's preempt.py:52 _eval_body, vmapped)."""
    req = arr.pod_req[pod_idxs.long()][:, None, :]  # [K, 1, R]
    alloc = arr.node_alloc[None]  # [1, N, R]

    def fit(u):
        return ((req == 0) | (req <= alloc - u)).all(dim=2)

    removed = _wrap32((vict_req.long() * vict_valid[:, :, None]).sum(dim=1))  # [N, R]
    base = used_now + nom_extra - removed
    okA = static_ok & fit(base[None])
    K, N = static_ok.shape
    cur = base[None].expand(K, N, base.shape[1])
    victims = []
    for v in range(vict_req.shape[1]):
        valid = vict_valid[None, :, v]
        trial = cur + vict_req[None, :, v, :]
        fits = fit(trial)
        keep = fits & valid & okA
        cur = torch.where(keep[:, :, None], trial, cur)
        victims.append(valid & okA & ~fits)
    is_victim = torch.stack(victims, dim=2)
    vcnt = is_victim.sum(dim=2).to(torch.int32)
    true = torch.ones((), dtype=torch.bool, device=okA.device)
    ok2 = torch.where(has_nom[None, :] & (vcnt > 0), fit(cur - nom_extra[None]), true)
    nvio = (is_victim & vict_viol[None]).sum(dim=2).to(torch.int32)
    prio = vict_prio[None].expand_as(is_victim)
    vmax = torch.where(is_victim, prio, torch.full((), INT32_MIN, dtype=torch.int32, device=okA.device)).amax(dim=2)
    vsum = _wrap32(torch.where(is_victim, prio, 0).long().sum(dim=2))
    cand = okA & ok2 & (vcnt > 0)
    return cand, nvio, vmax, vsum, vcnt, is_victim, static_ok


def _place(x, dev, dtype) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dev, dtype).contiguous()
    return h2d(np.asarray(x), dev, dtype)


def preempt_eval_wave(arr, pod_idxs, used_now, nom_extra, has_nom, vict_req, vict_prio, vict_viol,
                      vict_valid) -> Tuple[torch.Tensor, ...]:
    """Phases A-C for K same-priority preemptors (rows `pod_idxs`, i32[K])
    against one shared state snapshot: usage `used_now` and nominated
    reservations `nom_extra` (i32[N, R]), `has_nom` (bool[N]), the victim
    tables `vict_req` (i32[N, V, R]), `vict_prio` (i32[N, V]), `vict_viol`
    and `vict_valid` (bool[N, V]) -> (cand, nvio, vmax, vsum, vcnt,
    is_victim, static_ok), each [K, ...] (the JAX package's
    preempt.py:117).  On the card: K3 for the static rows, then K15."""
    dev = arr.device
    idx = _place(pod_idxs, dev, torch.int32)
    ins = (
        _place(used_now, dev, torch.int32), _place(nom_extra, dev, torch.int32), _place(has_nom, dev, torch.bool),
        _place(vict_req, dev, torch.int32), _place(vict_prio, dev, torch.int32), _place(vict_viol, dev, torch.bool),
        _place(vict_valid, dev, torch.bool),
    )
    if dev.type == "cpu":
        return preempt_eval_plain(arr, idx, static_rows_plain(arr, idx), *ins)
    from . import kernels

    stat_w = kernels.class_static_hoist(arr, idx.long())
    return kernels.preempt_eval(stat_w, arr.pod_req, idx, arr.node_alloc, *ins)


def preempt_eval(arr, pod_idx: int, used_now, nom_extra, has_nom, vict_req, vict_prio, vict_viol,
                 vict_valid) -> Tuple[torch.Tensor, ...]:
    """One preemptor (the JAX package's preempt.py:110): -> (cand, nvio,
    vmax, vsum, vcnt, is_victim), each [N, ...]; the wave with K = 1."""
    out = preempt_eval_wave(arr, np.array([pod_idx], dtype=np.int32), used_now, nom_extra, has_nom, vict_req,
                            vict_prio, vict_viol, vict_valid)
    return tuple(x[0] for x in out[:6])


def to_host(out) -> Tuple[np.ndarray, ...]:
    """numpy copies of a wave's outputs.  On the card the outputs are views
    of one byte buffer (kernels.preempt_eval) and come back in ONE copy."""
    base: Optional[torch.Tensor] = out[0]._base
    if out[0].device.type == "cpu" or base is None or any(x._base is not base for x in out):
        return tuple(x.cpu().numpy() for x in out)
    host = base.cpu().numpy()
    res = []
    for x in out:
        np_dtype = np.bool_ if x.dtype == torch.bool else np.int32
        off = x.storage_offset() * x.element_size() - base.storage_offset()
        res.append(np.frombuffer(host, dtype=np_dtype, count=x.numel(), offset=off).reshape(tuple(x.shape)))
    return tuple(res)


__all__ = ["static_rows_plain", "preempt_eval_plain", "preempt_eval_wave", "preempt_eval", "to_host"]
