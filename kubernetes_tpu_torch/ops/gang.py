"""Gang scheduling: all-or-nothing PodGroups (BASELINE config 5) — the port
of the JAX package's ``ops/gang.py``.

A group binds only if at least minMember of its pods are placed in the
cycle.  The batch formulation runs the commit scan optimistically; while a
group misses its quorum, the failed group that appears earliest in activeQ
order is revoked (its pods leave ``pod_valid``) and the batch runs again,
because the freed capacity may let later gangs succeed.  Revoked groups stay
revoked; at most G + 1 batch runs.

Two fixpoints, decision-identical:

``schedule_with_gangs`` — the host fixpoint: each iteration is one routed
  step (``dispatch`` + ``finish``) and a host quorum check
  (``failed_groups``).  Class state ``inc`` is reused across the
  iterations: the class planes leave pod_valid out and ``pod_group`` is in
  the spec key, so a revocation masks whole classes.  With ordinals the
  iterations' sweeps are summed and each iteration's ordinals are offset by
  the sweeps before it (``sweeps_prior``).

``gang_fixpoint_device`` — the device fixpoint, one device program in the
  JAX package (a ``lax.while_loop``): each iteration is the batch step
  WITHOUT class state plus the quorum check and revocation, kernel K13
  ``gang_quorum`` (csrc/gang.cu).  On the card it takes design (b) of the
  port's plan: the host queues the G + 1 iterations the fixpoint is bounded
  by, K7 + K8 + K13 each, and every launch takes a device ``done`` word and
  returns at entry once K13 has set it, so nothing is read back between
  iterations and the caller reads the verdicts once.  (Design (a), a CUDA
  graph with a conditional WHILE node, was not taken: the kernels live in
  separate libraries, each with its own static cudart, and K8 is a
  cooperative launch; the queue needs neither capture nor graph support.)
  On the card the iteration is the dense chunked route, which a fit-only
  batch of a multiple of CHUNK pods takes; any other batch raises there.
  On the CPU the plain version loops with a host check.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..device import h2d, resolve_device
from .assign import _chunkable, _first, dispatch, finish
from .scores import ScoreConfig, check_config


def failed_groups(choices: np.ndarray, pod_group: np.ndarray, group_min: np.ndarray,
                  active: Optional[np.ndarray] = None) -> np.ndarray:
    """bool[G]: the groups with at least one active pod that missed their
    quorum (the JAX package's gang.py:33)."""
    G = group_min.shape[0]
    sched = np.zeros(G, dtype=np.int64)
    present = np.zeros(G, dtype=bool)
    mask = pod_group >= 0
    if active is not None:
        mask &= active
    np.add.at(sched, pod_group[mask], (choices[mask] >= 0).astype(np.int64))
    present[pod_group[mask]] = True
    return present & (sched < group_min)


def schedule_with_gangs(arr, cfg: ScoreConfig, with_ordinals: bool = False, inc=None, device=None, **knobs):
    """The host fixpoint (the JAX package's gang.py:47) -> (choices i32[P]
    with revoked gangs at -1, node_used i32[N, R]); with `with_ordinals`
    also (ordinals i32[P], sweeps int): the ordinals of the last iteration
    offset by the sweeps of the earlier ones, sweeps the total.  `inc` is
    the class state (HoistCache.ensure), reused by every iteration;
    `knobs` go to dispatch (chunked=, the route's knobs)."""
    dev = resolve_device(device)
    if arr.device.type != dev.type:
        arr = arr.to(dev)
    pod_group = arr.pod_group.cpu().numpy()
    group_min = arr.group_min.cpu().numpy()
    pv = arr.pod_valid.cpu().numpy().copy()
    pod_valid = arr.pod_valid
    sweeps_prior = 0
    while True:
        step = finish(dispatch(dataclasses.replace(arr, pod_valid=pod_valid), cfg, dev, inc, **knobs))
        choices = step.choices.cpu().numpy()
        bad = failed_groups(choices, pod_group, group_min, active=pv)
        if not bad.any():
            if with_ordinals:
                return step.choices, step.used, step.ordinals + sweeps_prior, sweeps_prior + int(step.sweeps)
            return step.choices, step.used
        sweeps_prior += int(step.sweeps)
        # revoke the failed group appearing earliest in activeQ order
        in_bad = bad[np.maximum(pod_group, 0)] & (pod_group >= 0) & pv
        first_g = pod_group[int(np.argmax(in_bad))]
        pv = pv & ~(pod_group == first_g)
        pod_valid = h2d(pv, dev)


def gang_quorum_plain(choices: torch.Tensor, pod_group: torch.Tensor, pv: torch.Tensor,
                      group_min: torch.Tensor):
    """The quorum check and revocation of one fixpoint iteration (the body
    of the JAX package's gang.py:142-161 after the batch step) -> (sched
    i32[G], present bool[G], bad bool[G], first i32[1] the earliest pod of a
    failed group or -1, pv_next bool[P], done bool: no group failed).  The
    plain version of kernel K13 gang_quorum."""
    dev = choices.device
    G = group_min.shape[0]
    mask = (pod_group >= 0) & pv
    gidx = torch.where(mask, pod_group, G).to(torch.int64)  # G: the drop slot
    sched = torch.zeros(G + 1, dtype=torch.int32, device=dev).index_add_(0, gidx, (choices >= 0).to(torch.int32))[:G]
    present = torch.zeros(G + 1, dtype=torch.bool, device=dev).index_fill_(0, gidx, True)[:G]
    bad = present & (sched < group_min)
    anybad = bool(bad.any())
    in_bad = bad[torch.clamp_min(pod_group, 0).to(torch.int64)] & (pod_group >= 0) & pv
    if not anybad:
        return sched, present, bad, torch.tensor([-1], dtype=torch.int32, device=dev), pv.clone(), True
    first = _first(in_bad)
    newly = (pod_group == pod_group[first]) & pv
    return sched, present, bad, first.reshape(1).to(torch.int32), pv & ~newly, False


def gang_fixpoint_device(arr, cfg: ScoreConfig, device=None, stats: Optional[dict] = None):
    """The device fixpoint (the JAX package's gang.py:112) -> (choices
    i32[P], node_used i32[N, R]).  Each iteration is the batch step without
    class state, then the quorum check and revocation; at most G + 1
    iterations.  On the card: K7 + K8 + K13 per iteration, all queued with
    no host read between them (module docstring); the round-cap status of
    every iteration is read once at the end and raises.  On the CPU: the
    plain route (dispatch) and gang_quorum_plain until no group fails.
    `stats`, when given, gets "iterations" (the batch steps that ran: one
    more than the groups revoked) and, on the card, "enqueue_s" (host
    seconds to queue the G + 1 iterations)."""
    dev = resolve_device(device)
    check_config(cfg)
    if arr.device.type != dev.type:
        arr = arr.to(dev)
    G = arr.group_min.shape[0]
    if G == 0:  # no groups: the plain batch step, as the JAX package's gang.py:136
        if stats is not None:
            stats["iterations"] = 1
        return finish(dispatch(arr, cfg, arr.device))[:2]
    if arr.device.type == "cpu":
        pv = arr.pod_valid
        for it in range(G + 1):
            step = finish(dispatch(dataclasses.replace(arr, pod_valid=pv), cfg, arr.device))
            *_, pv, done = gang_quorum_plain(step.choices, arr.pod_group, pv, arr.group_min)
            if done:
                break
        if stats is not None:
            stats["iterations"] = it + 1
        return step.choices, step.used
    if not _chunkable(arr, cfg):
        raise NotImplementedError(
            "gang_fixpoint_device on the card runs the dense chunked route (a fit-only batch of a multiple "
            f"of 128 pods); got P={arr.P} with the stage set {cfg}: see ROADMAP.md queue A9")
    from . import kernels

    P, N, R = arr.P, arr.N, arr.R
    pv = arr.pod_valid.clone()
    arr_i = dataclasses.replace(arr, pod_valid=pv)  # pv changes in place, launch by launch
    done = torch.zeros((1,), dtype=torch.int32, device=arr.device)
    sfs = torch.empty((P, -(-N // 32)), dtype=torch.int32, device=arr.device)
    out = (torch.full((P,), -1, dtype=torch.int32, device=arr.device),
           torch.zeros((N, R), dtype=torch.int32, device=arr.device),
           torch.zeros((P,), dtype=torch.int32, device=arr.device),
           torch.zeros((2,), dtype=torch.int32, device=arr.device))
    t0 = time.perf_counter()
    for _ in range(G + 1):
        kernels.packed_static_rows(arr_i, done=done, out=sfs)
        kernels.chunk_rounds_dense(arr_i, cfg, sfs, done=done, out=out)
        kernels.gang_quorum(out[0], arr.pod_group, pv, arr.group_min, done=done)
    t1 = time.perf_counter()
    kernels.read_sweeps(out[3])  # one host read: raises on a round-cap hit in any iteration
    if stats is not None:
        stats["enqueue_s"] = t1 - t0
        revoked = (arr.pod_valid & ~pv & (arr.pod_group >= 0)).to(torch.int64)
        gid = torch.where(revoked.bool(), arr.pod_group.to(torch.int64), G)
        stats["iterations"] = 1 + int((torch.bincount(gid, minlength=G + 1)[:G] > 0).sum())
    return out[0], out[1]


__all__ = ["failed_groups", "schedule_with_gangs", "gang_quorum_plain", "gang_fixpoint_device"]
