"""Batched assignment with sequential-commit semantics — the port of the JAX
package's ``ops/assign.py``: the per-pod scan ``schedule_scan`` over every
stage, ``schedule_scan_chunked`` in both its modes (dense, and the
incremental class-wave route) for the fit-only stage set, and
``schedule_scan_rounds`` in both its modes (dense, and on class state) for
the full stage set.

Static feasibility is evaluated for the whole batch up front ([P, N]); then
pods commit one at a time in activeQ order (== tensor order).  Each step
re-evaluates NodeResourcesFit.Filter, NodePorts and the pairwise filters
(PodTopologySpread, InterPodAffinity) against the running state, scores the
feasible nodes (fit strategy + BalancedAllocation + the TaintToleration,
NodeAffinity, spread, inter-pod and ImageLocality scores, each normalised
over the pod's current feasible set), takes the highest score with ties to
the LOWEST node index, and commits the pod's request, its pairwise counts
and its host ports.

THE PER-POD ROUTE.  ``schedule_scan_plain`` is the plain PyTorch version
(one Python step per pod); on the card the fit-only stage set runs the
static-feasibility kernel and ``fit_scan`` (csrc/fit_scan.cu), any other
stage set kernel K7's packed planes, K10 ``score_planes`` where the taint
or node-affinity score needs its [P, N] plane, and K11 ``full_scan``
(csrc/full_scan.cu).

THE DENSE CHUNKED ROUTE (no class state, fit-only).  ``CHUNK`` pods at a
time: the chunk's masked scores [C, N] against the usage its predecessors
left, the top-(C+1) candidates per pod, then the prefix-commit round loop
(``_round_loop``: speculate, revalidate under intra-round prefix sums,
commit the longest exact prefix).  Plain: ``packed_static_rows_plain`` and
``schedule_scan_chunked_dense_plain``; on the card kernel K7
``packed_static_rows`` (csrc/class_hoist.cu) and K8 ``chunk_rounds_dense``
(csrc/chunk_rounds_dense.cu).

THE CLASS-WAVE ROUTE.  Given the resident class state of
``ops/incremental.py — HoistCache.ensure`` (``inc``): stage A, the
class-batched commit waves (``wave_commit_plain``; kernel K5
``wave_commit``, csrc/wave_commit.cu), commits a contiguous prefix of the
batch, usually all of it, in blocks of ``wave_block`` pods certified
against per-class top-``wave_k`` lists; stage B, the chunk round loop
(``schedule_scan_chunked_plain``, the same ``_round_loop`` over the pods'
class rows; kernel K6 ``chunk_rounds``, csrc/chunk_rounds.cu), continues
the serial order over whatever the wave left, ``INC_CHUNK`` pods at a time.
The JAX package's wave knobs are keyword arguments here with the same
defaults (``class_waves=False`` is its ``KTPU_CLASS_WAVES=0``; ``wave_k``,
``wave_block``).

THE ROUNDS ROUTE (the full stage set).  ``RCHUNK`` pods at a
time, every round re-hoists the chunk's uncommitted pods against exact
round-start state (the per-pod scan's row functions, pod by pod), then
dispersal speculation over each pod's top-32, the exact repair under the
intra-round prefix, and the longest confirmed prefix commits, truncated at
term sharing and at normalisation hazards (``schedule_scan_rounds_plain``;
on the card K7, K10 and K12 ``rounds``, csrc/rounds.cu).  With class state
the pods' static, eligibility, taint, node-affinity and image rows are the
rows of the resident class planes (K12's class-row mode reads them through
``inc.cls``; the plain version also carries the class base hoist across
chunks, patched per round, as the JAX package does).  Its knobs ``rchunk``
and ``repair_iters`` are keyword arguments with the JAX package's defaults
(KTPU_RCHUNK=16, KTPU_REPAIR_ITERS=1).

ROUTING (``dispatch``, the JAX package's schedule_batch_impl): class state
that fits -> the class-wave route (a chunkable batch) or the rounds route in
class mode (any other batch with P a multiple of RCHUNK); else, on the card
(on the CPU with chunked=True, the JAX package's KTPU_FORCE_CHUNKED=1), a
chunkable batch -> the dense chunked route and any other batch with P a
multiple of RCHUNK (a fit-only batch of fewer than CHUNK pods too) -> the
rounds route; else the per-pod route.  Decisions are the same on every
route; commit ordinals and the sweep count are each route's own and
equal the JAX route's.  ``dispatch`` launches without a host
synchronisation; ``finish`` reads the sweep count and the round-cap status
back and raises on the cap (``schedule_batch`` does both).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch

from ..device import resolve_device
from . import bitplane, filters
from .incremental import _scores, fit_rows, score_flat
from .scopes import subphase
from .scores import ScoreConfig, check_config, taint_prefer_counts_plain

_INT_MAX = 2**31 - 1

# The JAX package's knobs (its assign.py:403-446).  class_waves, wave_k and
# wave_block are keyword arguments of the route with these defaults; the
# rest are constants here.
CHUNK = 128  # the dense chunk; the chunked route needs P >= CHUNK, P % CHUNK == 0
INC_CHUNK = 32  # pods per chunk of the inc-mode round loop
SPECZ = 16  # usable list entries precomputed per pod for pass-1 speculation
SPEC_ITERS = 4  # jump-to-first-unclaimed iterations in pass 1
CLASS_WAVES = True  # stage A on (the JAX package's KTPU_CLASS_WAVES)
WAVE_K = 256  # per-class candidate list length per epoch
WAVE_BLOCK = 48  # pods certified per wave block
WAVE_ITERS = 12  # pointer-dispersal iterations per block
RCHUNK = 16  # pods per chunk of the rounds scan (the JAX package's KTPU_RCHUNK)
REPAIR_ITERS = 1  # speculate -> repair iterations per round (its KTPU_REPAIR_ITERS)

# Route counters, bumped per call (the JAX package bumps its TRACE_COUNTS
# per trace; eager PyTorch has no trace, so a call is the unit here).
TRACE_COUNTS = {"plain": 0, "chunked": 0, "chunked_inc": 0, "class_waves": 0, "rounds": 0, "rounds_inc": 0,
                "sharded_chunked": 0, "sharded_chunked_inc": 0, "sharded_rounds": 0, "sharded_rounds_inc": 0,
                "sharded_plain": 0}


def reset_trace_counts() -> None:
    for k in TRACE_COUNTS:
        TRACE_COUNTS[k] = 0


def fit_only(cfg: ScoreConfig, arr) -> bool:
    """No stage beyond static feasibility, NodeResourcesFit and
    BalancedAllocation: the fit_scan kernel's stage set."""
    return not (cfg.enable_pairwise or cfg.enable_ports or cfg.enable_taint_score or cfg.enable_node_pref
                or _image_on(arr, cfg))


def _image_on(arr, cfg: ScoreConfig) -> bool:
    """Whether the ImageLocality stage has a real [P, N] matrix (the JAX
    package's assign.py:168).  Arrays on a node mesh (ShardedArrays) carry
    the verdict taken at global shape, ``image_sharded``: a shard's width
    can equal the [P, 1] broadcast form's."""
    sharded = getattr(arr, "image_sharded", None)
    if sharded is not None:
        return cfg.enable_image and sharded
    return cfg.enable_image and arr.image_score.shape[1] == arr.N


def preferred_node_affinity_raw_plain(pod_pref_terms, pod_pref_weights, tm: torch.Tensor) -> torch.Tensor:
    """bf16[P, N] summed weights of the matching preferred node-affinity
    terms (nodeaffinity/node_affinity.go — Score): the JAX package's
    assign.py:153, a [P, S] weight scatter-add (a term listed twice adds
    twice) and one [P, S] @ [S, N] product in f32 (integer-valued, exact),
    stored on the bf16 lattice (f32 under KTPU_SCORE_DTYPE=f32)."""
    P = pod_pref_terms.shape[0]
    S = tm.shape[0]
    if S == 0:  # no terms: every slot is -1 (JAX's scatter drops it, index_put_ refuses it)
        return bitplane.quantize_scores(torch.zeros((P, tm.shape[1]), dtype=torch.float32, device=tm.device))
    ids = torch.clamp_min(pod_pref_terms, 0).to(torch.int64)
    zero = torch.zeros((), dtype=torch.float32, device=tm.device)
    w = torch.where(pod_pref_terms >= 0, pod_pref_weights, zero)
    W = torch.zeros((P, S), dtype=torch.float32, device=tm.device)
    rows = torch.arange(P, device=tm.device)[:, None].expand_as(ids)
    W.index_put_((rows, ids), w, accumulate=True)
    return bitplane.quantize_scores(W @ tm.to(torch.float32))


def score_planes_plain(arr) -> Tuple[torch.Tensor, torch.Tensor]:
    """(traw, naraw) bf16[P, N]: the PreferNoSchedule count plane and the
    preferred node-affinity weight plane — the plain version of kernel K10
    score_planes."""
    tm = filters.term_match(arr.sel_mask, arr.sel_kind, arr.node_labels)
    return (taint_prefer_counts_plain(arr.pod_tol_pref, arr.node_taint_pref),
            preferred_node_affinity_raw_plain(arr.pod_pref_terms, arr.pod_pref_weights, tm))


def score_planes(arr, cfg: ScoreConfig):
    """(traw or None, naraw or None) for the stages cfg enables, on arr's
    device: the plain version for CPU tensors, kernel K10 for CUDA tensors."""
    if not (cfg.enable_taint_score or cfg.enable_node_pref):
        return None, None
    with subphase("hoist"):
        if arr.device.type == "cpu":
            traw, naraw = score_planes_plain(arr)
        else:
            from . import kernels

            traw, naraw = kernels.score_planes(arr)
    return (traw if cfg.enable_taint_score else None), (naraw if cfg.enable_node_pref else None)


def dom_by_term(arr) -> Tuple[torch.Tensor, int]:
    """(i32[T, N] the domain of every node under each term's key, D): the
    static map the pairwise state goes through (domain D: key absent)."""
    return arr.node_dom[arr.term_key.to(torch.int64)], arr.term_counts0.shape[1] - 1


def pairwise_state0(arr, dbt: torch.Tensor, D: int):
    """The per-node count state the scans start from (the JAX package's
    assign.py:374-378): cnt/anti/pref_node f32[T, N] gathered from the
    per-domain tables, total_t f32[T]."""
    idx = dbt.to(torch.int64)
    return (torch.gather(arr.term_counts0, 1, idx), torch.gather(arr.anti_counts0, 1, idx),
            torch.gather(arr.pref_own0, 1, idx), arr.term_counts0[:, :D].sum(dim=1))


def one_shard(arr):
    """Arrays on one device as a node mesh of one shard, without a copy: the
    plain scans below run parallel/sharded.py's bodies over it, whose
    cross-shard reductions are then the single-device ones."""
    from ..parallel.mesh import NodeMesh, ShardedArrays

    return ShardedArrays(NodeMesh((arr.device,)), (arr,), arr.image_score.shape[1] == arr.N)


def schedule_scan_plain(arr, cfg: ScoreConfig, sf: torch.Tensor = None, planes=None, with_state: bool = False):
    """-> (choices i32[P] node index or -1, node_used i32[N, R]), the plain
    per-pod scan over every stage cfg enables: the JAX package's
    assign.py:181 schedule_scan op for op.  `sf` is the static-feasibility
    mask, `planes` score_planes' (traw, naraw) (both computed with the plain
    versions when not given).

    Each step: feasible = sf & fit & ports & spread & inter-pod; the score
    accumulates fit, balanced, taint, node affinity, spread, inter-pod and
    image in that order, each normalisation over the feasible set in its
    own op order; the argmax takes the lowest node index; the commit adds
    the request, the pairwise counts and the host ports.  With `with_state`
    also the final pairwise state {cnt, anti, pref, total, ports} (what
    kernel K11 is held to).  The body is the node mesh's
    (parallel/sharded.py -- sharded_schedule_scan_plain) on one shard."""
    from ..parallel.sharded import sharded_schedule_scan_plain

    return sharded_schedule_scan_plain(one_shard(arr), cfg, None if sf is None else [sf],
                                       None if planes is None else [planes], with_state)


def _per_pod(arr, cfg: ScoreConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-pod route: on the card the fit_scan kernel for the fit-only
    stage set (after static_feasible), else K7's packed planes, K10's score
    planes where a stage needs them and the full_scan kernel K11."""
    TRACE_COUNTS["plain"] += 1
    if arr.device.type == "cpu":
        sf = filters.static_feasible(arr)
        with subphase("score"):
            return schedule_scan_plain(arr, cfg, sf=sf)
    from . import kernels

    if fit_only(cfg, arr):
        sf = filters.static_feasible(arr)
        with subphase("score"):
            choices, used, _ = kernels.fit_scan(sf, arr, cfg)
        return choices, used.contiguous()
    sfs, eligs = packed_static_rows(arr, with_elig=True)
    planes = score_planes(arr, cfg)
    with subphase("score"):
        return kernels.full_scan(arr, cfg, sfs, eligs, planes)


# ---------------------------------------------------------------------------
# the class-wave route (inc mode of the JAX package's schedule_scan_chunked)
# ---------------------------------------------------------------------------

def _ord_key(x: torch.Tensor) -> torch.Tensor:
    """int64 key ordering (value desc, index asc) along the last axis, all
    keys distinct: a signed 32-bit image of the value, monotone in it (for
    f32 the sign-folded bits: -inf < -0.0 < +0.0 < inf), above the
    reversed index."""
    n = x.shape[-1]
    if x.dtype == torch.float32:
        b = x.contiguous().view(torch.int32).to(torch.int64)
        v = torch.where(b >= 0, b, -(2**31) - 1 - b)
    else:
        v = x.to(torch.int64)
    idx = torch.arange(n, dtype=torch.int64, device=x.device)
    return v * 2**32 + (n - 1 - idx)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries along the last axis, equal values in ascending
    index order (lax.top_k's order), by sorting distinct (value, index)
    keys -> (values, int32 indices)."""
    idx = torch.sort(_ord_key(x), dim=-1, descending=True).indices[..., :k]
    return torch.gather(x, -1, idx), idx.to(torch.int32)


# ---------------------------------------------------------------------------
# the node-axis reductions of the sharded scans (the JAX package's
# assign.py:56-110) over per-shard lists: xs[i] is local shard i's [*, nl]
# block, g * nl the first global node id of its global id g (shard_ids:
# the list index in one process; across ranks, `span`, the rank's run);
# each result is replicated, one copy per local shard's device
# (parallel/collectives.py).  With one shard each is the single-device
# operation.
# ---------------------------------------------------------------------------

def _rmax(xs, span=None):
    """Reduce-max over the node axis (last), then across the shards."""
    from ..parallel.collectives import pmax

    return pmax([x.max(dim=-1).values for x in xs], span)


def _rmin(xs, span=None):
    from ..parallel.collectives import pmin

    return pmin([x.min(dim=-1).values for x in xs], span)


def _gather_cols(xs, cols: torch.Tensor, nl: int, span=None):
    """x[:, cols] for node-sharded blocks xs[i] [C, nl] and GLOBAL column ids
    cols [D] -> [C, D], replicated: the owner shard contributes its columns,
    the others zeros, and the psum adds them (a bool plane goes through
    int32 and > 0, as the JAX package's does)."""
    from ..parallel.collectives import psum, shard_ids

    isbool = xs[0].dtype == torch.bool
    parts = []
    for s, x in zip(shard_ids(len(xs), span), xs):
        c = cols.to(x.device)
        mine = (c >= s * nl) & (c < (s + 1) * nl)
        lc = torch.where(mine, c - s * nl, 0).to(torch.int64)
        xv = x.to(torch.int32) if isbool else x
        v = torch.gather(xv, 1, lc[None, :].expand(x.shape[0], -1))
        parts.append(torch.where(mine[None, :], v, torch.zeros((), dtype=v.dtype, device=v.device)))
    out = psum(parts, span)
    return [o > 0 for o in out] if isbool else out


def _gather_at_nodes(xs, rows: torch.Tensor, nodes: torch.Tensor, nl: int, span=None):
    """x[rows, nodes] for node-sharded blocks xs[i] [T, nl] and GLOBAL node
    ids: the owner shard's value, the psum broadcast."""
    from ..parallel.collectives import psum, shard_ids

    parts = []
    for s, x in zip(shard_ids(len(xs), span), xs):
        r, n = rows.to(x.device).to(torch.int64), nodes.to(x.device)
        mine = (n >= s * nl) & (n < (s + 1) * nl)
        v = x[r, torch.where(mine, n - s * nl, 0).to(torch.int64)]
        parts.append(torch.where(mine, v, torch.zeros((), dtype=v.dtype, device=v.device)))
    return psum(parts, span)


def _global_top_k(xs, k: int, span=None):
    """top_k over the GLOBAL node axis of node-sharded blocks xs[i] [C, nl]
    -> (values [C, k], GLOBAL ids [C, k]), replicated: each shard's local
    top-kl (kl = min(k, nl)), its ids made global, gathered in shard order,
    then a top-k of the S * kl candidates with lowest-position ties -- the
    shard order is the global index order, so the result is top_k of the
    whole row (the JAX package's assign.py:91)."""
    from ..parallel.collectives import all_gather_nodes, shard_ids

    nl = xs[0].shape[-1]
    kl = min(k, nl)
    loc = [top_k(x, kl) for x in xs]
    ids = shard_ids(len(xs), span)
    out = []
    for x in xs:
        av = all_gather_nodes([v for v, _ in loc], 1, x.device, span)
        ai = all_gather_nodes([i + g * nl for g, (_, i) in zip(ids, loc)], 1, x.device, span)
        mv, mp = top_k(av, k)
        out.append((mv, torch.gather(ai, 1, mp.to(torch.int64))))
    return [v for v, _ in out], [i for _, i in out]


def pod_unshard(ga, inc=None):
    """The entry stage of every route on a pods x nodes grid (the JAX
    package's assign.py:114): the pod-axis fields of arrays placed on the
    grid (parallel/mesh.py -- GridArrays) gathered back to the whole pod
    axis, one tiled gather per field along its own pod axis (m_pend's is
    axis 1; parallel/collectives.py -- all_gather_nodes), onto each device
    of the first pod row this process holds -> (ShardedArrays of that row
    on its NodeMesh, inc).  The node-axis routes then run on it unchanged.

    Every pod row would compute the same program on the same node shards
    (the JAX package's docstring, :118-133), so a controller runs it once,
    on its first row; across ranks (the grid's span) the gather is the
    cross-rank exchange and each rank runs its own first row.  `inc` (a
    grid HoistCache's class state) has its pod-aligned class index gathered
    too, one block per pod row in ``inc.cls``; the [U1, *] class planes are
    class-aligned and never cut by pods."""
    from ..parallel.collectives import all_gather_nodes
    from ..parallel.mesh import ShardedArrays
    from ..parallel.partition_rules import POD_AXIS_FIELDS, pod_axis_of

    mesh = ga.mesh
    row = mesh.rows[0]
    gathered = {}
    shards = []
    for s, dev in enumerate(row.devices):
        repl = {}
        for name in (*POD_AXIS_FIELDS, "image_score"):
            key = (name, dev, s if name == "image_score" and ga.image_sharded else None)
            if key not in gathered:
                gathered[key] = all_gather_nodes([getattr(c[s], name) for c in ga.cells], pod_axis_of(name), dev,
                                                 mesh.span)
            repl[name] = gathered[key]
        shards.append(dataclasses.replace(ga.cells[0][s], **repl))
    sa = ShardedArrays(row, tuple(shards), ga.image_sharded)
    if inc is not None and isinstance(inc.cls, tuple):
        cls = {dev: all_gather_nodes(list(inc.cls), 0, dev, mesh.span) for dev in set(row.devices)}
        inc = inc._replace(cls=cls[row.devices[0]],
                           shards=tuple(x._replace(cls=cls[d]) for x, d in zip(inc.shards, row.devices)))
    return sa, inc


def _first(mask: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis of a bool mask: the first True (0 when
    none), as jnp.argmax gives it."""
    return torch.argmax(mask.to(torch.int8), dim=-1)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[i, idx[i]] for a per-row index vector."""
    return torch.gather(x, 1, idx.to(torch.int64)[:, None])[:, 0]


def t0u_prologue(inc, n: int) -> torch.Tensor:
    """f32[U1, N] masked class scores vs cycle-start usage:
    where(unpack(stat_u & fit_u), base_u, -inf) (the JAX package's
    assign.py:992-997)."""
    sf = bitplane.unpack(inc.stat_u & inc.fit_u, n)
    return torch.where(sf, inc.base_u, torch.tensor(float("-inf"), device=sf.device))


def wave_commit_plain(cls, pvalid, preq, used_init, t0u_init, stat_full, n_alloc_full, req_u,
                      cfg: ScoreConfig, wave_k: int = WAVE_K, wave_block: int = WAVE_BLOCK):
    """Class-batched commit waves, the plain version of the JAX package's
    assign.py:530 _wave_commit_stage, op for op (see its docstring for why
    a certified commit is exact).  Inputs are not modified.

    -> (committed bool[P], out i32[P], ordinal i32[P] (block index),
        used i32[N, R], t0u f32[U1, N], n_blocks int, epochs int)."""
    dev = cls.device
    P = cls.shape[0]
    U1, N = t0u_init.shape
    E = min(wave_block, P)
    KW = min(wave_k, N)
    max_blocks = (P // E + 1) * 8 + 32
    ninf = torch.tensor(float("-inf"), device=dev)
    imax = torch.tensor(_INT_MAX, dtype=torch.int32, device=dev)
    idxE = torch.arange(E, dtype=torch.int32, device=dev)
    ltE = idxE[None, :] < idxE[:, None]  # [i, j]: j < i
    kw_rng = torch.arange(KW, dtype=torch.int32, device=dev)
    cls64 = cls.to(torch.int64)

    committed = torch.zeros(P, dtype=torch.bool, device=dev)
    out = torch.full((P,), -1, dtype=torch.int32, device=dev)
    ordn = torch.zeros(P, dtype=torch.int32, device=dev)
    used = used_init.clone()
    t0u = t0u_init.clone()
    claimed = torch.zeros(bitplane.words_for(N), dtype=torch.int32, device=dev)
    bmax = torch.full((U1,), float("-inf"), device=dev)
    bnode = torch.full((U1,), _INT_MAX, dtype=torch.int32, device=dev)
    tv = ti = nf = None
    need_ep, epochs, blocks, f = True, 0, 0, 0

    def claims(pos, tib):
        posc = torch.clamp_max(pos, KW - 1)
        nd = torch.where(pos < KW, _take(tib, posc), N)  # N: sentinel (no pick)
        cm = torch.full((N + 1,), _INT_MAX, dtype=torch.int32, device=dev)
        cm = cm.scatter_reduce(0, nd.to(torch.int64), idxE, reduce="amin")
        return nd, cm  # cm[n]: earliest block pod pointing at n

    while f < P and blocks < max_blocks:
        # (A) epoch refresh
        if need_ep:
            tv, ti = top_k(t0u, KW)
            nf = (tv > ninf).sum(dim=1).to(torch.int32)
            claimed = torch.zeros_like(claimed)
            bmax = torch.full_like(bmax, float("-inf"))
            bnode = torch.full_like(bnode, _INT_MAX)
        # (B) the block
        start = min(f, P - E)
        bidx = start + idxE.to(torch.int64)
        bcls = cls64[bidx]
        breq = preq[bidx]
        bval = pvalid[bidx]
        active = ~committed[bidx]
        live = active & bval
        # (C) pointer walk
        tvb = tv[bcls]
        tib = ti[bcls]
        avail = (tvb > ninf) & ~bitplane.test_cols(claimed, tib, N) & live[:, None]
        same = (bcls[:, None] == bcls[None, :]) & live[None, :]
        rank = (same & ltE).sum(dim=1).to(torch.int32)
        csum = torch.cumsum(avail.to(torch.int32), dim=1, dtype=torch.int32)
        hit = csum == (rank + 1)[:, None]
        pos = torch.where(hit.any(dim=1), _first(hit).to(torch.int32), KW)
        for _ in range(WAVE_ITERS):
            _, cm = claims(pos, tib)
            elig = avail & ~(cm[tib.to(torch.int64)] < idxE[:, None])
            pos = torch.where(elig.any(dim=1), _first(elig).to(torch.int32), KW)
        nd, cm = claims(pos, tib)
        own_ok = cm[nd.to(torch.int64)] == idxE
        earlier_cl = cm[tib.to(torch.int64)] < idxE[:, None]
        before = kw_rng[None, :] < pos[:, None]
        prefix_ok = (~(avail & before) | earlier_cl).all(dim=1)
        posc = torch.clamp_max(pos, KW - 1)
        a_val = torch.where(pos < KW, _take(tvb, posc), ninf)
        a_node = nd
        picked = live & (pos < KW)
        # (D) post-placement snapshot columns s2[U1, E]
        an = torch.clamp_max(a_node, N - 1).to(torch.int64)
        nu = used[an] + breq
        na = n_alloc_full[an]
        fit2 = fit_rows(req_u, nu, na)
        v2 = _scores(req_u, nu, na, cfg)
        s2 = torch.where(bitplane.test_cols(stat_full, an, N) & fit2 & picked[None, :], v2, ninf)
        s2n = torch.where(picked, a_node, imax)
        # (E) exclusive lexicographic scan: a running (max value, min node)
        # selection — a total order, so any association order is exact
        sv = torch.empty((U1, E), device=dev)
        sn = torch.empty((U1, E), dtype=torch.int32, device=dev)
        cur_v, cur_n = bmax, bnode
        for j in range(E):
            sv[:, j] = cur_v
            sn[:, j] = cur_n
            bv, bn = s2[:, j], s2n[j].expand(U1)
            tb = (bv > cur_v) | ((bv == cur_v) & (bn < cur_n))
            cur_v = torch.where(tb, bv, cur_v)
            cur_n = torch.where(tb, bn, cur_n)
        ex_v = sv[bcls, idxE.to(torch.int64)]
        ex_n = sn[bcls, idxE.to(torch.int64)]
        # (F) certification
        covered = (nf[bcls] < KW) if KW < N else torch.ones(E, dtype=torch.bool, device=dev)
        cert_pick = picked & own_ok & prefix_ok & ((a_val > ex_v) | ((a_val == ex_v) & (a_node < ex_n)))
        cert_neg = live & (pos >= KW) & prefix_ok & covered & (ex_v == ninf)
        cert = ~live | cert_pick | cert_neg
        ncert = active & ~cert
        q = int(_first(ncert)) if bool(ncert.any()) else E
        inpre = idxE < q
        commit_b = active & inpre
        place_b = commit_b & cert_pick
        ucol = torch.where(place_b, a_node, N)
        used2 = used.clone()
        used2.index_add_(0, a_node[place_b].to(torch.int64), breq[place_b])
        # (G) fallback: one exact dense rescore of the first uncertified pod
        do_fb = q < E
        t_fb = -1
        if do_fb:
            fcls = int(bcls[q])
            freq = breq[q]
            fstat = bitplane.unpack(stat_full[fcls], N)
            ffit = filters.fit_ok(freq, used2, n_alloc_full)
            fvals = torch.where(fstat & ffit, score_flat(used2 + freq[None], n_alloc_full, cfg), ninf)
            if bool(fvals.max() > ninf):
                t_fb = int(torch.argmax(fvals))
        fb_ok = do_fb and t_fb >= 0
        fcol = t_fb if fb_ok else N
        used3 = used2
        if fb_ok:
            used3 = used2.clone()
            used3[fcol] += freq
        # (H) absorb
        cb = bidx[commit_b]
        out[cb] = torch.where(place_b, a_node, -1)[commit_b]
        committed[cb] = True
        ordn[cb] = blocks
        if do_fb:
            out[start + q] = t_fb
            committed[start + q] = True
            ordn[start + q] = blocks
        claimed = bitplane.set_cols(claimed, ucol, place_b, N)
        fnc = min(fcol, N - 1)
        fnc_t = torch.tensor([fnc], dtype=torch.int64, device=dev)
        stacked = fb_ok and bool(bitplane.test_cols(claimed, fnc_t, N)[0])
        if fb_ok:
            claimed = bitplane.set_cols(claimed, fnc_t, torch.ones(1, dtype=torch.bool, device=dev), N)
        cv = torch.where(inpre[None], s2, ninf)
        cn = torch.where(inpre, s2n, imax)
        m = cv.max(dim=1).values
        mn = torch.where(cv == m[:, None], cn[None], imax).min(dim=1).values
        tb = (m > bmax) | ((m == bmax) & (mn < bnode))
        bmax = torch.where(tb, m, bmax)
        bnode = torch.where(tb, mn, bnode)
        t0u[:, a_node[place_b].to(torch.int64)] = s2[:, place_b]
        fnu = used3[fnc]
        fna = n_alloc_full[fnc]
        ffit_u = fit_rows(req_u, fnu[None], fna[None])[:, 0]
        fv_u = _scores(req_u, fnu[None], fna[None], cfg)[:, 0]
        fcv = torch.where(bitplane.test_cols(stat_full, fnc_t, N)[:, 0] & ffit_u, fv_u, ninf)
        if fb_ok:
            t0u[:, fcol] = fcv
            fn2 = torch.tensor(t_fb, dtype=torch.int32, device=dev)
            t2 = (fcv > bmax) | ((fcv == bmax) & (fn2 < bnode))
            bmax = torch.where(t2, fcv, bmax)
            bnode = torch.where(t2, fn2, bnode)
        f = start + E if q == E else start + q + 1
        used = used3
        need_ep = do_fb and (stacked or q < E // 8)
        epochs += int(need_ep)
        blocks += 1
    return committed, out, ordn, used, t0u, blocks, epochs


def _best_and_cand(vals, nodes, vu, iu):
    """Max score + lowest-node-index tie-break over candidate rows [C, D]
    plus the clean list head (vu, iu) per pod."""
    bd = vals.max(dim=1).values
    best = torch.maximum(bd, vu)
    imax = torch.tensor(_INT_MAX, dtype=torch.int32, device=vals.device)
    cd = torch.where(vals == best[:, None], nodes, imax).min(dim=1).values
    cand = torch.minimum(cd, torch.where(vu == best, iu, imax))
    return best, cand


def _round_loop(cfg, creq, cvalid, rows, used0, alloc, wcom0, wout0, C, K, Z):
    """The prefix-commit round loop of one chunk, shared by both modes of
    the JAX package's schedule_scan_chunked (its assign.py:1170-1347 with
    the per-mode hoist of :1093-1168): `rows` f32[C, N] are the chunk's
    masked scores against chunk-start usage (inc mode: the pods' class rows
    t0u[ccls]; dense mode: the hoist total0), which give the top-K lists and
    stat_at (a -inf entry stays infeasible: usage only grows).  Pods with
    wcom0 set enter committed with the decisions wout0.

    -> (out i32[C], nrounds int, ord_ i32[C]: the round that committed each
    pod)."""
    dev = creq.device
    R = creq.shape[1]
    N = rows.shape[1]
    ninf = torch.tensor(float("-inf"), device=dev)
    idxC = torch.arange(C, dtype=torch.int32, device=dev)
    jlt = idxC[None, :] < idxC[:, None]  # [i, j]: j < i
    committed = wcom0.clone()
    out = wout0.clone()
    ord_ = torch.zeros(C, dtype=torch.int32, device=dev)
    nrounds = 0
    if not bool(committed.all()):
        topv, topi = top_k(rows, K)
        topv = torch.where(cvalid[:, None], topv, ninf)

        def stat_at(ids):
            return rows[:, ids.to(torch.int64)] > ninf  # [C, D]

        cleank = torch.ones((C, K), dtype=torch.bool, device=dev)
        dlist = torch.full((C,), -1, dtype=torch.int32, device=dev)
        dsu = torch.zeros((C, R), dtype=used0.dtype, device=dev)
        nd = 0
        kdesc = K - torch.arange(K, dtype=torch.int32, device=dev)
        while not bool(committed.all()):
            unc = ~committed
            # ---- pass 1: speculative choices vs live usage ----
            dn = torch.clamp_min(dlist, 0)
            dvalid = dlist >= 0
            dn64 = dn.to(torch.int64)
            M2 = torch.where(
                dvalid[None] & stat_at(dn) & fit_rows(creq, dsu, alloc[dn64]),
                _scores(creq, dsu, alloc[dn64], cfg), ninf,
            )
            usablek = cleank & (topv > ninf)
            ukey = torch.where(usablek, kdesc, 0)
            _, upos = top_k(ukey, Z)  # the first Z usable positions
            uok = torch.gather(ukey, 1, upos.to(torch.int64)) > 0  # [C, Z]
            head = _take(topi, upos[:, 0])
            have0 = uok[:, 0]
            same_head = (head[:, None] == head[None, :]) & have0[None, :] & unc[None, :]
            ptr = torch.clamp_max((same_head & jlt).sum(dim=1), Z - 1)
            nodes_z = torch.gather(topi, 1, upos.to(torch.int64))  # [C, Z]
            okr = _take(uok, ptr) & unc
            for _ in range(SPEC_ITERS):
                claim = torch.where(okr, _take(nodes_z, ptr), -1)
                cb = ((nodes_z[:, :, None] == claim[None, None, :]) & jlt[:, None, :]).any(dim=2)
                free = uok & ~cb
                has = free.any(dim=1)
                ptr = torch.where(has, _first(free), Z - 1)
                okr = has & unc
            sel = _take(upos, ptr)
            vu = torch.where(okr, _take(topv, sel), ninf)
            iu = _take(topi, sel)
            best1, cand1 = _best_and_cand(M2, dn[None].expand(C, C), vu, iu)
            c = torch.where((best1 > ninf) & unc & cvalid, cand1, -1)
            # ---- pass 2: revalidate under intra-round prefix commits ----
            act = unc & (c >= 0)
            cn = torch.clamp_min(c, 0)
            cn64 = cn.to(torch.int64)
            Em = (c[:, None] == c[None, :]) & act[:, None]  # [C(k), C(j)]
            T = Em[:, :, None].to(torch.int32) * creq[:, None, :]  # [C, C, R]
            cum = torch.cumsum(T, dim=0, dtype=torch.int32) - T
            eqd = (c[:, None] == dlist[None, :]) & dvalid[None, :]
            hasslot = eqd.any(dim=1)
            sl = _first(eqd)
            cu = torch.where(hasslot[:, None], dsu[sl], used0[cn64])  # [C, R]
            ca = alloc[cn64]
            cstat = stat_at(cn)  # [C, C]
            uij = cu[None] + cum  # [C(i), C(j), R]
            cab = ca[None].expand(C, C, R)
            fitij = ((creq[:, None, :] == 0) | (creq[:, None, :] <= cab - uij)).all(dim=2)
            vij = score_flat((uij + creq[:, None, :]).reshape(-1, R), cab.reshape(-1, R), cfg).reshape(C, C)
            Mij = torch.where(act[None, :] & jlt & cstat & fitij, vij, ninf)
            # dirty slots an earlier pod picked this round are superseded:
            # slot d is excluded for pod i when its first picker j is < i
            D2 = (dlist[None, :] == c[:, None]) & act[:, None] & dvalid[None, :]  # [C(j), C(d)]
            first_d = torch.where(D2, idxC[:, None], C).min(dim=0).values
            M2x = torch.where(first_d[None, :] < idxC[:, None], ninf, M2)
            # list entries an earlier pod picked this round: the first picker
            # of each node (C: none), looked up at the list's nodes
            first_n = torch.full((N + 1,), C, dtype=torch.int32, device=dev).scatter_reduce(
                0, torch.where(act, c, N).to(torch.int64), idxC, reduce="amin")
            chosen_before = first_n[topi.to(torch.int64)] < idxC[:, None]  # [C, K]
            cleank2 = cleank & ~chosen_before
            jf2 = _first(cleank2)
            vu2 = torch.where(cleank2.any(dim=1), _take(topv, jf2), ninf)
            iu2 = _take(topi, jf2)
            vals_all = torch.cat([M2x, Mij], dim=1)
            nodes_all = torch.cat([dn[None].expand(C, C), cn[None].expand(C, C)], dim=1)
            best2, cand2 = _best_and_cand(vals_all, nodes_all, vu2, iu2)
            t = torch.where((best2 > ninf) & unc & cvalid, cand2, -1)
            # ---- commit the longest exact prefix ----
            bad = unc & (t != c)
            firstbad = int(_first(bad)) if bool(bad.any()) else C
            prefix = unc & (idxC < firstbad)
            pact = prefix & (c >= 0)
            out = torch.where(prefix, c, out)
            ord_ = torch.where(prefix, torch.tensor(nrounds, dtype=torch.int32, device=dev), ord_)
            committed = committed | prefix
            picked = torch.zeros((N + 1,), dtype=torch.bool, device=dev)
            picked[torch.where(pact, c, N).to(torch.int64)] = True
            cleank = cleank & ~picked[topi.to(torch.int64)]
            Epact = Em & pact[:, None]
            adds = (Epact[:, :, None].to(torch.int32) * creq[:, None, :]).sum(dim=0, dtype=torch.int32)
            minpos = torch.where(Epact, idxC[:, None], C).min(dim=0).values
            owner = pact & (minpos == idxC)
            is_new = owner & ~hasslot
            rank = torch.cumsum(is_new.to(torch.int32), dim=0, dtype=torch.int32) - 1
            newpos = torch.where(is_new, nd + rank, C).to(torch.int64)
            keep = newpos < C
            dlist[newpos[keep]] = c[keep]
            dsu[newpos[keep]] = (used0[cn64] + adds)[keep]
            upd = owner & hasslot
            dsu[sl[upd]] += adds[upd]
            nd += int(is_new.sum())
            nrounds += 1
    return out, nrounds, ord_


def _chunk_plain(cfg, creq, ccls, cvalid, used0, t0u, alloc, stat_full, req_u, wcom0, wout0, C, K, Z):
    """One chunk of stage B in inc mode (the JAX package's
    assign.py:1093-1387): the round loop over the pods' class rows, the
    usage update, then the class rows patched at the committed columns ->
    (out, nrounds, ord_, used_out, t0u)."""
    N = t0u.shape[1]
    ninf = torch.tensor(float("-inf"), device=creq.device)
    out, nrounds, ord_ = _round_loop(cfg, creq, cvalid, t0u[ccls], used0, alloc, wcom0, wout0, C, K, Z)
    newly = (out >= 0) & ~wcom0
    used_out = used0.clone()
    used_out.index_add_(0, out[newly].to(torch.int64), creq[newly])
    if bool(newly.any()):
        # patch the carried class rows at the committed columns vs the new usage
        cn_out = torch.clamp_min(out, 0).to(torch.int64)
        col_used = used_out[cn_out]
        col_alloc = alloc[cn_out]
        newv = torch.where(
            bitplane.test_cols(stat_full, cn_out, N) & fit_rows(req_u, col_used, col_alloc),
            _scores(req_u, col_used, col_alloc, cfg), ninf,
        )
        t0u = t0u.clone()
        t0u[:, cn_out[newly]] = newv[:, newly]
    return out, nrounds, ord_, used_out, t0u


def schedule_scan_chunked_plain(arr, cfg: ScoreConfig, inc, used0, t0u0, wave=None):
    """Stage B, the chunk round loop of the JAX package's assign.py:870
    schedule_scan_chunked in inc mode (:1093-1413), continuing from the
    usage `used0` and class rows `t0u0` (the wave's, or the cycle start's).
    `wave` = (committed, out, ordinal, n_blocks) of stage A, or None.

    -> (choices i32[P], used i32[N, R], ordinals i32[P], sweeps int): the
    ordinal is the global round (the wave's block index for wave-committed
    pods; stage-B rounds number on from n_blocks); sweeps is the total."""
    dev = arr.device
    P = arr.P
    N = t0u0.shape[1]
    C = INC_CHUNK
    K = min(C + 1, N)
    Z = min(SPECZ, K)
    if wave is not None:
        wcom, wout, wordn, n_blocks = wave
        if bool(wcom.all()):
            # the JAX lax.cond skip: nothing is left for the round loop
            return wout.clone(), used0.clone(), wordn.clone(), int(n_blocks)
    else:
        wcom = torch.zeros(P, dtype=torch.bool, device=dev)
        wout = torch.full((P,), -1, dtype=torch.int32, device=dev)
    used, t0u = used0, t0u0
    cls64 = inc.cls.to(torch.int64)
    outs, ords, rounds = [], [], []
    for ch in range(P // C):
        sl = slice(ch * C, (ch + 1) * C)
        o, nr, od, used, t0u = _chunk_plain(
            cfg, arr.pod_req[sl], cls64[sl], arr.pod_valid[sl], used, t0u, arr.node_alloc,
            inc.stat_u, inc.req_u, wcom[sl], wout[sl], C, K, Z,
        )
        outs.append(o)
        ords.append(od)
        rounds.append(nr)
    base = torch.tensor([0] + rounds[:-1], dtype=torch.int64).cumsum(0).to(torch.int32).to(dev)
    ords_g = (base[:, None] + torch.stack(ords)).reshape(P)
    sweeps = sum(rounds)
    if wave is not None:
        ords_g = torch.where(wcom, wordn, ords_g + n_blocks)
        sweeps += int(n_blocks)
    return torch.cat(outs), used, ords_g, sweeps


def packed_static_rows_plain(arr, with_elig: bool = False, base: int = 0):
    """int32 words [P, ceil(N/32)]: static feasibility of every pod row,
    pod_valid included, packed per block of CHUNK rows (the JAX package's
    lax.map of _sf_block, assign.py:1014-1053 and :1616-1640) -> the plain
    version of kernel K7 packed_static_rows.  With `with_elig` also the
    packed eligibility plane nodesel & node_valid that spread's minMatch
    reads -> (sfs, eligs).  On a node shard's arrays `base` is its first
    global node id, which a nodeName pin is compared against (the JAX
    package's my_nodes, assign.py:969)."""
    P, N = arr.P, arr.N
    tm = filters.term_match(arr.sel_mask, arr.sel_kind, arr.node_labels)
    nodes = base + torch.arange(N, dtype=torch.int32, device=arr.device)
    blocks, eblocks = [], []
    for b0 in range(0, P, CHUNK):
        sl = slice(b0, min(P, b0 + CHUNK))
        sf, nsb = filters.static_feasible_rows(
            tm, arr.node_valid, arr.node_taint_ns, nodes, arr.pod_terms[sl], arr.pod_has_sel[sl],
            arr.pod_tol_ns[sl], arr.pod_nodename[sl], arr.pod_valid[sl])
        blocks.append(bitplane.pack(sf))
        if with_elig:
            eblocks.append(bitplane.pack(nsb & arr.node_valid[None, :]))
    if with_elig:
        return torch.cat(blocks), torch.cat(eblocks)
    return torch.cat(blocks)


def packed_static_rows(arr, with_elig: bool = False, base: int = 0):
    """The packed [P, W] static plane (and with `with_elig` the eligibility
    plane) on arr's device: the plain version for CPU tensors, kernel K7 for
    CUDA tensors; `base` as in packed_static_rows_plain."""
    with subphase("hoist"):
        if arr.device.type == "cpu":
            return packed_static_rows_plain(arr, with_elig, base)
        from . import kernels

        return kernels.packed_static_rows(arr, with_elig, base=base)


def _dense_chunk_plain(cfg, creq, csf, cvalid, used0, alloc, C, K, Z):
    """One chunk of the dense mode (the JAX package's assign.py:1126-1168
    and the round loop): the masked hoist total0 [C, N] against chunk-start
    usage, the round loop over it, the usage update -> (out, nrounds, ord_,
    used_out)."""
    N = used0.shape[0]
    ninf = torch.tensor(float("-inf"), device=creq.device)
    sf = bitplane.unpack(csf, N)
    total0 = torch.where(sf & fit_rows(creq, used0, alloc), _scores(creq, used0, alloc, cfg), ninf)
    none = torch.zeros(C, dtype=torch.bool, device=creq.device)
    out, nrounds, ord_ = _round_loop(cfg, creq, cvalid, total0, used0, alloc, none,
                                     torch.full((C,), -1, dtype=torch.int32, device=creq.device), C, K, Z)
    newly = out >= 0
    used_out = used0.clone()
    used_out.index_add_(0, out[newly].to(torch.int64), creq[newly])
    return out, nrounds, ord_, used_out


def schedule_scan_chunked_dense_plain(arr, cfg: ScoreConfig, sfs: Optional[torch.Tensor] = None):
    """The dense mode of the JAX package's assign.py:870
    schedule_scan_chunked (no class state): CHUNK pods at a time, each chunk
    hoisting its [C, N] scores against the usage its predecessors left, the
    round loop, then the usage update.  `sfs` is the packed static plane
    (packed_static_rows_plain when not given).

    -> (choices i32[P], used i32[N, R], ordinals i32[P], sweeps int): the
    ordinal of a pod is the rounds of the earlier chunks plus its own round
    (:1422-1444), sweeps the total."""
    if sfs is None:
        sfs = packed_static_rows_plain(arr)
    dev = arr.device
    P, N = arr.P, arr.N
    C = CHUNK
    K = min(C + 1, N)
    Z = min(SPECZ, K)
    used = arr.node_used
    outs, ords, rounds = [], [], []
    for ch in range(P // C):
        sl = slice(ch * C, (ch + 1) * C)
        o, nr, od, used = _dense_chunk_plain(cfg, arr.pod_req[sl], sfs[sl], arr.pod_valid[sl], used,
                                             arr.node_alloc, C, K, Z)
        outs.append(o)
        ords.append(od)
        rounds.append(nr)
    base = torch.tensor([0] + rounds[:-1], dtype=torch.int64).cumsum(0).to(torch.int32).to(dev)
    ords_g = (base[:, None] + torch.stack(ords)).reshape(P)
    return torch.cat(outs), used, ords_g, sum(rounds)


def schedule_scan_chunked_dense(arr, cfg: ScoreConfig):
    """The dense chunked route: on CUDA tensors kernel K7 (the packed static
    plane) and K8 (the chunk scan, one launch); on the CPU the plain
    versions."""
    TRACE_COUNTS["chunked"] += 1
    sfs = packed_static_rows(arr)
    with subphase("round_loop"):
        if arr.device.type != "cpu":
            from . import kernels

            return kernels.chunk_rounds_dense(arr, cfg, sfs)
        return schedule_scan_chunked_dense_plain(arr, cfg, sfs)


# ---------------------------------------------------------------------------
# the rounds route: the JAX package's schedule_scan_rounds, dense mode
# ---------------------------------------------------------------------------

def _slot_indicator(ids: torch.Tensor, T: int, w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[C, slots] padded term ids -> f32[C, T] incidence: 1 where the pod
    carries the term (with `w`, a nonzero weight too); the JAX package's
    .at[].max, duplicates included."""
    on = (ids >= 0) if w is None else ((ids >= 0) & (w != 0))
    C = ids.shape[0]
    T = max(T, 1)
    flat = (torch.arange(C, device=ids.device)[:, None] * T + torch.clamp_min(ids, 0).to(torch.int64)).reshape(-1)
    M = torch.zeros(C * T, dtype=torch.float32, device=ids.device)
    return M.scatter_reduce(0, flat, on.to(torch.float32).reshape(-1), reduce="amax").reshape(C, T)


def chunk_share(cx, cfg: ScoreConfig, T: int) -> torch.Tensor:
    """bool[C, C] share(i, j): pod j's state writes touch a term pod i reads
    (or their host ports overlap) — the per-chunk incidence products of the
    JAX package's assign.py:1771-1795, 0/1 sums in f32."""
    C = cx["req"].shape[0]
    dev = cx["req"].device
    pw = cfg.enable_pairwise
    ips = pw and cfg.enable_interpod_score
    share = torch.zeros((C, C), dtype=torch.bool, device=dev)
    if pw:
        rd = (_slot_indicator(cx["spread_t"], T) + _slot_indicator(cx["aff"], T)
              + _slot_indicator(cx["anti"], T))
        wr_cnt = _slot_indicator(cx["mt"], T, cx["mv"])
        rd_anti = _slot_indicator(cx["mt"], T)
        wr_anti = _slot_indicator(cx["anti"], T)
        share = (rd @ wr_cnt.T + rd_anti @ wr_anti.T) > 0.0
        if ips:
            rd_pref = _slot_indicator(cx["pref_t"], T)
            wr_pref = rd_pref
            if cfg.hard_pod_affinity_weight:
                wr_pref = torch.maximum(wr_pref, _slot_indicator(cx["aff"], T))
            share = share | ((rd_pref @ wr_cnt.T + rd_anti @ wr_pref.T) > 0.0)
    if cfg.enable_ports:
        pf = cx["ports"].to(torch.float32)
        share = share | ((pf @ pf.T) > 0.0)
    return share


def _scatter_rows(state, dbt, ids, cn_final, w, dcol=None):
    """state[T, N] += w * (node's domain == the chosen node's domain) over
    the (pod, slot) rows -> (state, tids, dcol, wf).  On a node shard the
    chosen nodes' domains `dcol` come from their owner shards
    (_gather_at_nodes)."""
    tids = torch.clamp_min(ids, 0).to(torch.int64).reshape(-1)
    wf = w.reshape(-1)
    if dcol is None:
        nodes = cn_final.to(torch.int64)[:, None].expand(ids.shape).reshape(-1)
        dcol = dbt[tids, nodes]
    same = dbt[tids] == dcol[:, None]
    return state.index_add(0, tids, wf[:, None] * same), tids, dcol, wf


def rounds_inputs(arr, cfg: ScoreConfig, sfs: torch.Tensor, eligs: Optional[torch.Tensor], planes, inc=None,
                  img_on: Optional[bool] = None):
    """The per-pod inputs of the rounds scan: a function of a pod slice ->
    the dict of its rows (masks unpacked, bf16 raws upcast to f32).  With
    class state `inc` the static, eligibility, taint, node-affinity and
    image rows are class-row gathers through inc.cls, and pod_valid folds
    back into the static rows (the class planes leave it out: the JAX
    package's assign.py:1722-1753); sfs, eligs and planes are then unused.
    On a node shard's arrays `img_on` is the verdict of _image_on at
    global shape."""
    N = arr.N
    if inc is not None:
        sfs, eligs, planes, img = inc.stat_u, inc.elig_u, (inc.traw_u, inc.naraw_u), inc.img_u
    else:
        img = arr.image_score if (_image_on(arr, cfg) if img_on is None else img_on) else None
    traw, naraw = planes

    def rows(sl):
        valid = arr.pod_valid[sl]
        if inc is not None:
            prow = inc.cls[sl].to(torch.int64)
            cx = {"cls": prow, "sf": bitplane.unpack(sfs[prow], N) & valid[:, None]}
        else:
            prow = sl
            cx = {"sf": bitplane.unpack(sfs[sl], N)}
        cx.update(req=arr.pod_req[sl], valid=valid)
        if cfg.enable_pairwise:
            cx.update(elig=bitplane.unpack(eligs[prow], N), spread_t=arr.pod_spread_terms[sl],
                      skew=arr.pod_spread_maxskew[sl], hard=arr.pod_spread_hard[sl], aff=arr.pod_aff_terms[sl],
                      anti=arr.pod_anti_terms[sl], mt=arr.pod_match_terms[sl], mv=arr.pod_match_vals[sl],
                      aself=arr.pod_aff_self[sl])
            if cfg.enable_interpod_score:
                cx.update(pref_t=arr.pod_pref_aff_terms[sl], pref_w=arr.pod_pref_aff_w[sl])
        if cfg.enable_ports:
            cx["ports"] = arr.pod_ports[sl]
        if cfg.enable_taint_score:
            cx["traw"] = traw[prow].to(torch.float32)
        if cfg.enable_node_pref:
            cx["naraw"] = naraw[prow].to(torch.float32)
        if img is not None:
            cx["img"] = img[prow].to(torch.float32)
        return cx

    return rows


def schedule_scan_rounds_plain(arr, cfg: ScoreConfig, sfs=None, eligs=None, planes=None, rchunk: int = None,
                               repair_iters: int = None, inc=None, with_state: bool = False):
    """The JAX package's assign.py:1464 schedule_scan_rounds: chunks of
    `rchunk` pods (its KTPU_RCHUNK), each re-hoisted against exact
    round-start state every round, committed by dispersal speculation,
    exact repair (`repair_iters`, its KTPU_REPAIR_ITERS) and the share /
    normalisation-hazard truncation.  Dense mode: `sfs`, `eligs` are K7's
    packed planes and `planes` score_planes' (the plain versions when not
    given).  Class mode (`inc`, ops/incremental.py — IncState): the pods'
    usage-independent rows are class-row gathers, and the class base hoist
    [U1, N] (inc.base_u / fit_u) is carried across the chunks and patched at
    committed columns each round — bit-identical to the dense mode.

    -> (choices i32[P], used i32[N, R], ordinals i32[P], sweeps int): the
    ordinal is the rounds of the earlier chunks plus the pod's own round
    (:2225-2235), sweeps their total; with `with_state` also the final
    pairwise state {cnt, anti, pref, total, ports} (what kernel K12 is held
    to).  The body is the node mesh's (parallel/sharded.py --
    sharded_schedule_scan_rounds_plain) on one shard."""
    from ..parallel.sharded import sharded_schedule_scan_rounds_plain

    def one(x):
        return None if x is None else [x]

    return sharded_schedule_scan_rounds_plain(one_shard(arr), cfg, one(sfs), one(eligs), one(planes), rchunk,
                                              repair_iters, None if inc is None else inc._replace(shards=(inc,)),
                                              with_state)


def schedule_scan_rounds(arr, cfg: ScoreConfig, inc=None, rchunk: int = None, repair_iters: int = None):
    """The rounds route: on CUDA tensors kernel K7 (packed static and
    eligibility planes), K10 (score planes, where a stage needs them) and
    K12 (the rounds scan, one launch); with class state `inc` K12 alone, in
    class-row mode over the resident class planes; on the CPU the plain
    versions."""
    TRACE_COUNTS["rounds_inc" if inc is not None else "rounds"] += 1
    if inc is not None:
        with subphase("round_loop"):
            if arr.device.type != "cpu":
                from . import kernels

                return kernels.rounds(arr, cfg, rchunk=rchunk, repair_iters=repair_iters, inc=inc)
            return schedule_scan_rounds_plain(arr, cfg, rchunk=rchunk, repair_iters=repair_iters, inc=inc)
    sfs, eligs = packed_static_rows(arr, with_elig=True)
    planes = score_planes(arr, cfg)
    with subphase("round_loop"):
        if arr.device.type != "cpu":
            from . import kernels

            return kernels.rounds(arr, cfg, sfs, eligs, planes, rchunk=rchunk, repair_iters=repair_iters)
        return schedule_scan_rounds_plain(arr, cfg, sfs, eligs, planes, rchunk=rchunk, repair_iters=repair_iters)


def _chunkable(arr, cfg: ScoreConfig) -> bool:
    """The JAX package's assign.py:494 _chunkable: the chunked scan applies
    when node usage is the only scan-carried state (the fit-only stage set)
    and P is a multiple of the dense chunk."""
    return fit_only(cfg, arr) and arr.P >= CHUNK and arr.P % CHUNK == 0


def _rounds_capable(arr, cfg: ScoreConfig) -> bool:
    """The JAX package's assign.py:1447: the rounds scan serves every stage
    combination; P must be a multiple of its chunk."""
    return arr.P >= RCHUNK and arr.P % RCHUNK == 0


def inc_route_applies(arr, cfg: ScoreConfig) -> bool:
    """Whether (arr, cfg) routes a route that reads class state at all — the
    class-wave route or the rounds route: callers gate HoistCache.ensure()
    on it (the JAX package's assign.py:2237)."""
    return _chunkable(arr, cfg) or _rounds_capable(arr, cfg)


def inc_applicable(arr, cfg: ScoreConfig, inc):
    """None unless the class state matches these arrays and the dedup is
    non-degenerate (the JAX package's assign.py:2245)."""
    if inc is None:
        return None
    if inc.req_u.shape[0] >= arr.P or inc.cls.shape[0] != arr.P:
        return None
    if inc.base_u.shape[-1] != arr.N or inc.req_u.shape[1] != arr.R:
        return None
    if arr.P % INC_CHUNK:
        return None
    if ((cfg.enable_pairwise and inc.elig_u is None) or (cfg.enable_taint_score and inc.traw_u is None)
            or (cfg.enable_node_pref and inc.naraw_u is None) or (_image_on(arr, cfg) != (inc.img_u is not None))):
        return None  # a class plane the config reads is missing (the JAX package's :2262-2269)
    return inc


def schedule_scan_chunked(arr, cfg: ScoreConfig, inc, class_waves: bool = CLASS_WAVES,
                          wave_k: int = WAVE_K, wave_block: int = WAVE_BLOCK):
    """The class-wave route: stage A (waves) then stage B (chunk rounds) ->
    (choices i32[P], used i32[N, R], ordinals i32[P], sweeps).  On CUDA
    tensors the t0u prologue and stage A run in kernel K5, stage B in K6;
    on the CPU the plain versions."""
    TRACE_COUNTS["chunked_inc"] += 1
    return chunked_inc(arr, cfg, inc, class_waves, wave_k, wave_block)


def chunked_inc(arr, cfg: ScoreConfig, inc, class_waves: bool = CLASS_WAVES, wave_k: int = WAVE_K,
                wave_block: int = WAVE_BLOCK):
    """The class-wave route's stages, counted by the caller
    (schedule_scan_chunked on one device, parallel/sharded.py on the node
    mesh, which hands it the stitched class planes)."""
    if class_waves:
        TRACE_COUNTS["class_waves"] += 1
    if arr.device.type != "cpu":
        from . import kernels

        wave = None
        t0u = None
        if class_waves:
            with subphase("commit_batch"):
                wcom, wout, wordn, used_w, t0u, n_blocks, _ = kernels.wave_commit(
                    arr, inc, cfg, wave_k=wave_k, wave_block=wave_block)
            wave = (wcom, wout, wordn, n_blocks)
        else:
            used_w = arr.node_used
        with subphase("round_loop"):
            return kernels.chunk_rounds(arr, inc, cfg, used_w, t0u, wave)
    wave = None
    used = arr.node_used
    if class_waves:
        with subphase("commit_batch"):  # t0u is K5's prologue on the card
            t0u = t0u_prologue(inc, arr.N)
            wcom, wout, wordn, used, t0u, n_blocks, _ = wave_commit_plain(
                inc.cls, arr.pod_valid, arr.pod_req, arr.node_used, t0u, inc.stat_u, arr.node_alloc,
                inc.req_u, cfg, wave_k=wave_k, wave_block=wave_block)
        wave = (wcom, wout, wordn, n_blocks)
    with subphase("round_loop"):
        if not class_waves:
            t0u = t0u_prologue(inc, arr.N)  # K6's on the card
        return schedule_scan_chunked_plain(arr, cfg, inc, used, t0u, wave)


class Step(NamedTuple):
    """A dispatched scheduling step.  On the card nothing has been read
    back: `sweeps` is then the kernels' int32[2] device pair (sweep count,
    round-cap status), which finish() reads."""

    choices: torch.Tensor  # i32[P] node index or -1
    used: torch.Tensor  # i32[N, R]
    ordinals: torch.Tensor  # i32[P]
    sweeps: Any  # int, or the int32[2] device pair


def dispatch(arr, cfg: ScoreConfig, device=None, inc=None, chunked: Optional[bool] = None, mesh=None,
             **knobs) -> Step:
    """Route and launch one step without a host synchronisation on the card
    (the pipeline's dispatch), as the JAX package's schedule_batch_impl
    routes off the CPU: with applicable class state `inc` the class-wave
    route for a chunkable batch, the rounds route in class mode for any
    other batch whose P is a multiple of RCHUNK; else a chunkable batch (fit-only stages) takes the dense chunked
    route and any other batch whose P is a multiple of RCHUNK the rounds
    route — on the card by default, on the CPU only with chunked=True (the
    JAX package's KTPU_FORCE_CHUNKED=1); else the per-pod route.
    chunked=False keeps the per-pod route.  `knobs` are the route's keyword
    arguments (schedule_scan_chunked's, or schedule_scan_rounds' rchunk /
    repair_iters).

    `mesh` (parallel/mesh.py -- a NodeMesh of more than one shard, or a
    pods x nodes GridMesh), or arrays already placed on one (ShardedArrays,
    GridArrays): the same routes on the mesh, with the same decisions
    (parallel/sharded.py -- sharded_dispatch, the JAX package's
    schedule_batch_routed(mesh=))."""
    dev = resolve_device(device)
    check_config(cfg)
    mesh = mesh if mesh is not None else getattr(arr, "mesh", None)
    if mesh is not None and (mesh.size > 1 or hasattr(arr, "mesh")):  # placed arrays: even on one shard
        from ..parallel.sharded import sharded_dispatch

        return sharded_dispatch(arr, cfg, mesh, dev, inc=inc, chunked=chunked, **knobs)
    if arr.device.type != dev.type:
        arr = arr.to(dev)
    inc = inc_applicable(arr, cfg, inc)
    if inc is not None and _chunkable(arr, cfg):
        return Step(*schedule_scan_chunked(arr, cfg, inc, **knobs))
    if inc is not None and _rounds_capable(arr, cfg):
        return Step(*schedule_scan_rounds(arr, cfg, inc=inc, **knobs))
    routed = arr.device.type != "cpu" if chunked is None else chunked
    if routed and _chunkable(arr, cfg):
        return Step(*schedule_scan_chunked_dense(arr, cfg))
    if routed and _rounds_capable(arr, cfg):
        return Step(*schedule_scan_rounds(arr, cfg, **knobs))
    choices, used = _per_pod(arr, cfg)
    return Step(choices, used, torch.arange(arr.P, dtype=torch.int32, device=arr.device), arr.P)


def finish(step: Step) -> Step:
    """The step with its sweep count read back (one host synchronisation on
    the card).  Raises when a chunk of the round loop hit its round cap:
    that never passes as unscheduled pods."""
    if isinstance(step.sweeps, int):
        return step
    from . import kernels

    return step._replace(sweeps=kernels.read_sweeps(step.sweeps))


def schedule_batch(arr, cfg: ScoreConfig, device=None, inc=None, **knobs) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scheduling step: -> (choices i32[P], node_used i32[N, R]) on
    `device` (the card unless the caller passes device="cpu").  With `inc`
    (ops/incremental.py — HoistCache.ensure) the class-wave route runs;
    `knobs` are dispatch()'s keyword arguments.  Returns once the step's
    status is read (finish)."""
    return finish(dispatch(arr, cfg, device, inc, **knobs))[:2]


def schedule_batch_ordinals(arr, cfg: ScoreConfig, device=None, inc=None, **knobs):
    """schedule_batch + (per-pod commit ordinal i32[P], total sweeps int):
    the ordinal is the index of the device sweep that decided the pod (the
    pod's index on the per-pod route; the chunk round on the dense chunked
    route; the wave block or global round on the class-wave route), as the
    JAX package's assign.py:2375 schedule_batch_ordinals_impl gives it."""
    return tuple(finish(dispatch(arr, cfg, device, inc, **knobs)))
