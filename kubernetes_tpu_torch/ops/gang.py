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
  JAX package (a ``lax.while_loop`` whose body is the routed batch step
  WITHOUT class state, then the quorum check and revocation, kernel K13
  ``gang_quorum``, csrc/gang.cu).  On the card it takes design (b) of the
  port's plan: the host queues the G + 1 iterations the fixpoint is bounded
  by, and every launch takes a device ``done`` word and returns at entry
  once K13 has set it, so nothing is read back between iterations.  The
  iteration is the route ``dispatch`` picks without class state
  (``_route``):

    dense    a chunkable batch: K7 + K8 (chunk_rounds_dense) + K13;
    rounds   any other batch whose P is a multiple of RCHUNK: K7 with the
             eligibility plane + K12 (rounds) + K13, K10 (score_planes)
             launched ONCE before the loop where a taint or node-affinity
             score is on -- its planes read neither pod_valid nor anything
             the loop changes, so it needs no gate;
    per-pod  else: K1 (static_feasible) + K2 (fit_scan) + K13 for the
             fit-only stage set; K7 with the eligibility plane + K11
             (full_scan) + K13 otherwise, K10 once before the loop as above.

  The outputs and running state of each route's scan live in persistent
  buffers that only a launch which passed the gate writes (ops/kernels.py,
  the gated mode), and the round-cap status of every iteration is ORed
  into one device pair.  ``gang_dispatch`` queues the loop and returns
  without a host read, so a caller can enqueue under a lock and read the
  verdicts outside it (the sidecar, runtime/sidecar.py); ``gang_finish``
  makes the one read.  (Design (a), a CUDA graph with a conditional WHILE
  node, was not taken: the kernels live in separate libraries, each with
  its own static cudart, and K8 and K12 are cooperative launches; the
  queue needs neither capture nor graph support.)  On the CPU the plain
  version loops with a host check over the same route choice
  (``chunked=True`` is the JAX package's KTPU_FORCE_CHUNKED=1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..device import h2d, resolve_device
from .assign import RCHUNK, _chunkable, _first, _rounds_capable, dispatch, finish, fit_only
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


def schedule_with_gangs(arr, cfg: ScoreConfig, with_ordinals: bool = False, inc=None, device=None, mesh=None,
                        **knobs):
    """The host fixpoint (the JAX package's gang.py:47) -> (choices i32[P]
    with revoked gangs at -1, node_used i32[N, R]); with `with_ordinals`
    also (ordinals i32[P], sweeps int): the ordinals of the last iteration
    offset by the sweeps of the earlier ones, sweeps the total.  `inc` is
    the class state (HoistCache.ensure), reused by every iteration;
    `knobs` go to dispatch (chunked=, the route's knobs).  On a node mesh
    (`mesh` of more than one shard, or arrays placed on one) every
    iteration is the routed step on the mesh (parallel/sharded.py), as in
    the JAX package (its gang.py:47-90); each iteration's pod_valid is
    replaced on every shard.  On a pods x nodes grid the fixpoint runs on
    the first held pod row after the entry gather (ops/assign.py --
    pod_unshard), its outputs sliced back to the caller's P."""
    dev = resolve_device(device)
    mesh = mesh if mesh is not None else getattr(arr, "mesh", None)
    from ..parallel.mesh import GridMesh

    if isinstance(mesh, GridMesh):
        from ..parallel.sharded import _unshard

        sa, inc, p = _unshard(arr, mesh, dev, inc)
        out = schedule_with_gangs(sa, cfg, with_ordinals, inc, dev, sa.mesh, **knobs)
        return (out[0][:p], out[1]) + ((out[2][:p], out[3]) if with_ordinals else ())
    if mesh is not None and (mesh.size > 1 or hasattr(arr, "shards")):
        from ..parallel.mesh import shard_arrays

        if not hasattr(arr, "shards"):
            arr = shard_arrays(arr if arr.device.type == dev.type else arr.to(dev), mesh)
        pods = arr.shards[0]

        def with_valid(pv_t):
            return arr.replace_pods(pod_valid=pv_t)
    else:
        mesh = None
        if arr.device.type != dev.type:
            arr = arr.to(dev)
        pods = arr

        def with_valid(pv_t):
            return dataclasses.replace(arr, pod_valid=pv_t)
    pod_group = pods.pod_group.cpu().numpy()
    group_min = pods.group_min.cpu().numpy()
    pv = pods.pod_valid.cpu().numpy().copy()
    pod_valid = pods.pod_valid
    sweeps_prior = 0
    while True:
        step = finish(dispatch(with_valid(pod_valid), cfg, dev, inc, mesh=mesh, **knobs))
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


def _route(arr, cfg, chunked: Optional[bool]) -> str:
    """The route dispatch takes without class state: "dense", "rounds",
    "perpod-fit" or "perpod-full"."""
    routed = arr.device.type != "cpu" if chunked is None else chunked
    if routed and _chunkable(arr, cfg):
        return "dense"
    if routed and _rounds_capable(arr, cfg):
        return "rounds"
    return "perpod-fit" if fit_only(cfg, arr) else "perpod-full"


@dataclasses.dataclass
class GangDispatch:
    """A dispatched device fixpoint.  On the card nothing has been read
    back: `status` is the int32[2] (sweeps, round-cap status) pair of the
    dense or rounds route (None on the per-pod routes) and `iterations` a
    0-d device tensor, the batch steps that ran (one more than the groups
    revoked).  On the CPU the plain loop has run and `iterations` is its
    count."""

    choices: torch.Tensor
    used: torch.Tensor
    status: Optional[torch.Tensor]
    route: str
    iterations: Union[int, torch.Tensor]


def _card_loop(arr, cfg, route: str):
    """The route's persistent buffers (K13's outputs among them) and its
    iteration on the card ->
    (iterate: queues one iteration, a gated one once `done` is set;
    (choices, used) of the last real iteration; the status pair or None;
    pv, the device pod_valid the iterations revoke in place; done)."""
    from . import kernels
    from .assign import score_planes

    P, N, R = arr.P, arr.N, arr.R
    dev = arr.device
    pv = arr.pod_valid.clone()
    arr_i = dataclasses.replace(arr, pod_valid=pv)  # pv changes in place, launch by launch
    done = torch.zeros((1,), dtype=torch.int32, device=dev)
    qo = kernels.gang_quorum_out(arr.group_min.shape[0], dev)  # K13's outputs: a queued call allocates nothing
    if route == "dense":
        sfs = torch.empty((P, -(-N // 32)), dtype=torch.int32, device=dev)
        out = (torch.full((P,), -1, dtype=torch.int32, device=dev), torch.zeros((N, R), dtype=torch.int32, device=dev),
               torch.zeros((P,), dtype=torch.int32, device=dev), torch.zeros((2,), dtype=torch.int32, device=dev))

        def iterate():
            kernels.packed_static_rows(arr_i, done=done, out=sfs)
            kernels.chunk_rounds_dense(arr_i, cfg, sfs, done=done, out=out)
            kernels.gang_quorum(out[0], arr.pod_group, pv, arr.group_min, done=done, out=qo)

        return iterate, out[:2], out[3], pv, done
    if route == "perpod-fit":
        sf = torch.empty((P, N), dtype=torch.bool, device=dev)
        fo = kernels.fit_scan_out(arr, cfg)

        def iterate():
            kernels.static_feasible(arr_i, done=done, out=sf)
            kernels.fit_scan(sf, arr_i, cfg, done=done, out=fo)
            kernels.gang_quorum(fo.choices, arr.pod_group, pv, arr.group_min, done=done, out=qo)

        return iterate, (fo.choices, fo.used_t[:, :N].t()), None, pv, done
    # the full stage set: K10 once (no pod_valid in its planes), K7 with
    # the eligibility plane, then K12 or K11, then K13
    planes = score_planes(arr, cfg)
    sfs = torch.empty((P, -(-N // 32)), dtype=torch.int32, device=dev)
    so = kernels.scan_out(arr, RCHUNK if route == "rounds" else None)

    def iterate():
        _, eligs = kernels.packed_static_rows(arr_i, with_elig=True, done=done, out=sfs)
        if route == "rounds":
            kernels.rounds(arr_i, cfg, sfs, eligs, planes, done=done, out=so)
        else:
            kernels.full_scan(arr_i, cfg, sfs, eligs, planes, done=done, out=so)
        kernels.gang_quorum(so.choices, arr.pod_group, pv, arr.group_min, done=done, out=qo)

    return iterate, (so.choices, so.state["used"]), (so.scal if route == "rounds" else None), pv, done


def _iterations(arr, pv: torch.Tensor) -> torch.Tensor:
    """1 + the groups the loop revoked (their pods left `pv`), a 0-d tensor
    on the card, queued after the loop: no host read (torch.bincount would
    read its input's maximum back)."""
    G = arr.group_min.shape[0]
    revoked = arr.pod_valid & ~pv & (arr.pod_group >= 0)
    gid = torch.where(revoked, arr.pod_group.to(torch.int64), G)
    hit = torch.zeros((G + 1,), dtype=torch.bool, device=pv.device).index_fill_(0, gid, True)
    return 1 + hit[:G].sum()


def load_kernels(arr, cfg: ScoreConfig) -> None:
    """Launch K10 once and one gated iteration of every route's kernels on
    `arr` (a small batch with groups, on the card; `done` set before the
    iteration, so nothing runs).  A process's first launch of a kernel
    loads its module, and the load waits for whatever runs on the card
    (torch's own kernels load so too, hence the count after the loop): a
    caller that queues the fixpoint under a lock (the sidecar engine) calls
    this at start, so that no dispatch waits so."""
    from . import kernels

    kernels.score_planes(arr)
    for route in ("dense", "rounds", "perpod-fit", "perpod-full"):
        iterate, _, _, pv, done = _card_loop(arr, cfg, route)
        done.fill_(1)
        iterate()
        _iterations(arr, pv)


def gang_dispatch(arr, cfg: ScoreConfig, device=None, chunked: Optional[bool] = None) -> GangDispatch:
    """Queue the device fixpoint (the JAX package's gang.py:112) without a
    host read on the card: at most G + 1 iterations of the batch step
    without class state on the route _route picks, each followed by the
    quorum check and revocation.  On the CPU: the plain route (dispatch,
    with `chunked`) and gang_quorum_plain until no group fails."""
    dev = resolve_device(device)
    check_config(cfg)
    if arr.device.type != dev.type:
        arr = arr.to(dev)
    G = arr.group_min.shape[0]
    route = _route(arr, cfg, chunked)
    if G == 0:  # no groups: the plain batch step, as the JAX package's gang.py:136
        step = dispatch(arr, cfg, arr.device, chunked=chunked)
        return GangDispatch(step.choices, step.used, None if isinstance(step.sweeps, int) else step.sweeps, route, 1)
    if arr.device.type == "cpu":
        pv = arr.pod_valid
        for it in range(G + 1):
            step = finish(dispatch(dataclasses.replace(arr, pod_valid=pv), cfg, arr.device, chunked=chunked))
            *_, pv, done = gang_quorum_plain(step.choices, arr.pod_group, pv, arr.group_min)
            if done:
                break
        return GangDispatch(step.choices, step.used, None, route, it + 1)
    iterate, (choices, used), status, pv, _done = _card_loop(arr, cfg, route)
    for _ in range(G + 1):
        iterate()
    return GangDispatch(choices, used, status, route, _iterations(arr, pv))


def gang_finish(g: GangDispatch, stats: Optional[dict] = None):
    """The dispatched fixpoint's (choices i32[P], node_used i32[N, R]) after
    its one host read: the round-cap status of every iteration (raises on a
    hit).  `stats`, when given, gets "iterations" (the batch steps that
    ran: one more than the groups revoked) and "route"."""
    if g.status is not None:
        from . import kernels

        kernels.read_sweeps(g.status)
    if stats is not None:
        stats["route"] = g.route
        stats["iterations"] = int(g.iterations)
    used = g.used if g.used.is_contiguous() else g.used.contiguous()
    return g.choices, used


def gang_fixpoint_device(arr, cfg: ScoreConfig, device=None, stats: Optional[dict] = None,
                         chunked: Optional[bool] = None):
    """The device fixpoint (the JAX package's gang.py:112) -> (choices
    i32[P], node_used i32[N, R]): gang_dispatch then gang_finish (the
    module docstring).  `chunked` routes the CPU's plain version as
    dispatch does (True: the JAX package's KTPU_FORCE_CHUNKED=1)."""
    return gang_finish(gang_dispatch(arr, cfg, device, chunked), stats)


__all__ = ["failed_groups", "schedule_with_gangs", "gang_quorum_plain", "GangDispatch", "load_kernels",
           "gang_dispatch", "gang_finish", "gang_fixpoint_device"]
