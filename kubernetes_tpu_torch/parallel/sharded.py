"""The routed scheduling step on the node mesh -- the port of the JAX
package's ``parallel/sharded.py``: ``sharded_schedule_batch_routed`` (:188)
over every route, and ``sharded_schedule_batch`` (:56), the unrouted
per-pod scan.

The node axis of every [*, N] array is cut into S shard blocks
(parallel/mesh.py).  The route is chosen after the node axis is padded,
as the JAX package chooses it, and decisions are the single-device
route's on every one:

- THE CHUNKED ROUTE (a fit-only batch of a multiple of 128 pods), in both
  modes.  The node-axis work runs per shard and the commit once on
  stitched values (the JAX package's contract, ops/assign.py:936-1010):
  dense, kernel K7 ``packed_static_rows`` per shard with its first global
  node id ``base`` (a nodeName pin is a global id), the tiled all_gather
  of the blocks (parallel/collectives.py) and kernel K17 ``stitch_planes``,
  then K8 ``chunk_rounds_dense`` with the usage and capacity gathered whole;
  on class state (``HoistCache(mesh=)``) the class planes hoisted per
  shard and stitched once per cycle, then K5 ``wave_commit`` and K6
  ``chunk_rounds``.  On one card the port stitches the static plane first
  and lets K8 hoist each chunk over all N; the JAX package hoists each
  chunk shard-locally and gathers the masked total.  Both are the same
  elementwise arithmetic per (pod, node), so the scores are the same bits.
- THE ROUNDS ROUTE (any other batch of a multiple of 16 pods), dense and
  on class state, and THE PER-POD ROUTE (the rest, or ``chunked=False``),
  fit-only and over the full stage set.  These re-evaluate every round or
  every pod, so they are never stitched: every per-node quantity stays on
  its shard and the per-step collectives of the JAX package's sharded
  scans (ops/assign.py:56-110) combine per-shard partials in shard order
  -- the normalisation maxima and the spread minMatch (pmax, pmin), the
  argmax as the max of (score, lowest global id), the speculation's
  global top-k merged from the shards' local lists, the repair's candidate
  columns and the commit's domain columns from their owner shard.  The
  plain versions below (``sharded_schedule_scan_plain``,
  ``sharded_schedule_scan_rounds_plain``) do it over per-shard tensor
  lists (one device is their one-shard case: ops/assign.py's
  schedule_scan_plain and schedule_scan_rounds_plain call them through
  ``assign.one_shard``, where every collective is the single-device
  reduction); on the card the shard modes of kernels K2 ``fit_scan``, K11
  ``full_scan`` and K12 ``rounds`` do it in the one-device launch over
  every shard's nodes (ops/kernels.py), after K1 ``static_feasible`` (fit-
  only per-pod) or K7 with the eligibility plane and K10 ``score_planes``,
  each launched per shard with its base.  The rounds route carries the
  usage replicated (the JAX package gathers it once per step); the per-pod
  scan keeps it per shard.

ON THE PODS x NODES GRID (parallel/mesh.py -- GridMesh) the pod axis is
padded too, before the route is chosen, the pod-axis fields are gathered
once at entry (ops/assign.py -- pod_unshard) and one pod row's node mesh
runs the step above: no other kernel and no other collective.  ACROSS
RANKS (the mesh's span) every collective above exchanges through the
process group; a grid whose rows span the ranks exchanges at the entry
gather only.  The shard modes of K2, K11 and K12 hold every shard on one
card, so across ranks the card runs the chunked route (K7 per shard, the
stitch's gather across ranks, K17, then K8 or K5/K6) and the other routes
raise there; the CPU runs every route.

The usage comes back gathered on the padded node axis; its pad rows are
zero.  ``TRACE_COUNTS`` counts ``sharded_chunked``,
``sharded_chunked_inc``, ``sharded_rounds``, ``sharded_rounds_inc`` and
``sharded_plain``.
"""

from __future__ import annotations

import torch

from ..ops import assign, bitplane, filters, pairwise
from ..ops.scopes import subphase
from ..ops.assign import (_INT_MAX, INC_CHUNK, RCHUNK, REPAIR_ITERS, Step, TRACE_COUNTS, _gather_at_nodes,
                          _gather_cols, _global_top_k, _rmax, _rmin, _scatter_rows)
from ..ops.incremental import _scores, fit_rows, score_flat
from ..ops.scores import MAX_NODE_SCORE, balanced_allocation, fit_score
from .collectives import all_gather_nodes, pmin, psum
from .mesh import GridArrays, GridMesh, ShardedArrays, grid_arrays, shard_arrays
from .partition_rules import INC_NODE_AXIS


def static_rows(sa: ShardedArrays) -> torch.Tensor:
    """The flat packed static plane [P, words(N)] of arrays on the mesh: K7
    per shard over its rows (with its base), the tiled all_gather, K17 (on
    the CPU their plain versions)."""
    blocks = [assign.packed_static_rows(sh, base=b) for sh, b in zip(sa.shards, _bases(sa))]
    return bitplane.stitch_planes(all_gather_nodes(blocks, 1, sa.device, sa.mesh.span), sa.nl)


def _bases(sa: ShardedArrays):
    """Each local shard's first global node id."""
    return [s * sa.nl for s in sa.mesh.ids]


def _nodes(sa: ShardedArrays):
    """Each shard's global node ids i32[nl]."""
    return [b + torch.arange(sa.nl, dtype=torch.int32, device=sh.device) for b, sh in zip(_bases(sa), sa.shards)]


def _on(x: torch.Tensor, dev) -> torch.Tensor:
    return x if x.device == dev else x.to(dev)


def _pairwise0(sa: ShardedArrays):
    """Per shard {dbt, hk, cnt, anti, pref} (the [T, nl] domain map, key
    presence and count planes) and D; total_t is the same on every shard."""
    out = []
    for sh in sa.shards:
        dbt, D = assign.dom_by_term(sh)
        cnt, anti, pref, total = assign.pairwise_state0(sh, dbt, D)
        out.append({"dbt": dbt, "hk": dbt < D, "cnt": cnt, "anti": anti, "pref": pref, "total": total})
    return out, D


# ---------------------------------------------------------------------------
# the sharded per-pod scan (the JAX package's schedule_scan(axis_name=))
# ---------------------------------------------------------------------------

def sharded_schedule_scan_plain(sa: ShardedArrays, cfg, sfs=None, planes=None, with_state: bool = False):
    """The per-pod scan over every stage cfg enables, node-sharded: the JAX
    package's assign.py:181 schedule_scan under shard_map, op for op.  `sfs`
    are the shards' static-feasibility masks bool[P, nl] (each with its
    base), `planes` their score_planes (both the plain versions when not
    given).  Per shard: the feasibility, raws and scores of its nodes and
    its count planes, usage and ports; per pod, in JAX's order, the taint
    and node-affinity maxima through _rmax, the spread minMatch through the
    pmin, the inter-pod max and min through _rmax, best through _rmax and
    the choice (the lowest global id) through _rmin; the owner shard
    commits the request and ports, the committed domain column comes from
    the owner's psum and every shard adds the counts to its own columns.

    -> (choices i32[P] global node ids or -1, used i32[N, R] gathered on the
    padded node axis); with `with_state` also the final pairwise state
    (cnt, anti, pref gathered [T, N], total [T], ports gathered [N, PT])."""
    shards = sa.shards
    S, nl, span = len(sa.shards), sa.nl, sa.mesh.span
    first = sa.mesh.ids[0]
    bases, nodes = _bases(sa), _nodes(sa)
    if sfs is None:
        sfs = [filters.static_feasible_plain(sh, base=b) for sh, b in zip(shards, bases)]
    if planes is None:
        planes = [assign.score_planes(sh, cfg) for sh in shards]
    pw = cfg.enable_pairwise
    ips = pw and cfg.enable_interpod_score
    img_on = assign._image_on(sa, cfg)
    st, D = _pairwise0(sa)
    for s, sh in enumerate(shards):
        st[s].update(used=sh.node_used.clone(), ports=sh.node_ports0.clone())
        if pw:
            tm = filters.term_match(sh.sel_mask, sh.sel_kind, sh.node_labels)
            st[s]["elig"] = filters.node_selection_ok_from(tm, sh) & sh.node_valid[None, :]
    devs = [sh.device for sh in shards]
    ninf = [torch.tensor(float("-inf"), device=d) for d in devs]
    zero = [torch.zeros((), dtype=torch.float32, device=d) for d in devs]
    imax = [torch.tensor(_INT_MAX, dtype=torch.int32, device=d) for d in devs]
    choices = torch.full((sa.P,), -1, dtype=torch.int32, device=sa.device)
    valid = shards[0].pod_valid.cpu().tolist()
    MAX = MAX_NODE_SCORE
    for p in range(sa.P):
        if not valid[p]:
            continue
        feas = []
        for s, sh in enumerate(shards):
            f = sfs[s][p] & filters.fit_ok(sh.pod_req[p], st[s]["used"], sh.node_alloc)
            if cfg.enable_ports:
                f = f & pairwise.ports_ok(st[s]["ports"], sh.pod_ports[p])
            feas.append(f)
        if pw:
            mm = pmin([pairwise.spread_min(st[s]["cnt"], st[s]["hk"], sh.pod_spread_terms[p], st[s]["elig"][p])
                       for s, sh in enumerate(shards)], span)
            sraw = []
            for s, sh in enumerate(shards):
                ok, raw = pairwise.spread_step(st[s]["cnt"], st[s]["hk"], sh.pod_spread_terms[p],
                                               sh.pod_spread_maxskew[p], sh.pod_spread_hard[p], st[s]["elig"][p],
                                               min_match=mm[s])
                sraw.append(raw)
                feas[s] = feas[s] & ok & pairwise.interpod_required_ok(
                    st[s]["cnt"], st[s]["anti"], st[s]["total"], st[s]["hk"], sh.pod_aff_terms[p],
                    sh.pod_anti_terms[p], sh.pod_match_terms[p], sh.pod_match_vals[p], sh.pod_aff_self[p])
        totals = []
        for s, sh in enumerate(shards):
            requested = st[s]["used"] + sh.pod_req[p][None, :]
            totals.append(cfg.fit_weight * fit_score(requested, sh.node_alloc, cfg)
                          + cfg.balanced_weight * balanced_allocation(requested, sh.node_alloc, cfg.score_resources))

        def norm_reverse(rows):
            mx = _rmax([torch.where(f, r, z) for f, r, z in zip(feas, rows, zero)], span)
            return [torch.where(m > 0, MAX - MAX * r / m, torch.full_like(r, MAX)) for r, m in zip(rows, mx)]

        if planes[0][0] is not None:
            for s, v in enumerate(norm_reverse([pl[0][p].to(torch.float32) for pl in planes])):
                totals[s] = totals[s] + cfg.taint_weight * v
        if planes[0][1] is not None:
            na = [pl[1][p].to(torch.float32) for pl in planes]
            na_max = _rmax([torch.where(f, r, z) for f, r, z in zip(feas, na, zero)], span)
            for s in range(S):
                totals[s] = totals[s] + cfg.node_affinity_weight * torch.where(
                    na_max[s] > 0, na[s] * MAX / na_max[s], zero[s])
        if pw:
            for s, v in enumerate(norm_reverse(sraw)):
                totals[s] = totals[s] + cfg.spread_weight * v
        if ips:
            ip = [pairwise.interpod_pref_raw(st[s]["cnt"], st[s]["pref"], st[s]["hk"], sh.pod_pref_aff_terms[p],
                                             sh.pod_pref_aff_w[p], sh.pod_match_terms[p], sh.pod_match_vals[p])
                  for s, sh in enumerate(shards)]
            mx = _rmax([torch.where(f, r, n) for f, r, n in zip(feas, ip, ninf)], span)
            mn = [-x for x in _rmax([torch.where(f, -r, n) for f, r, n in zip(feas, ip, ninf)], span)]
            for s in range(S):
                totals[s] = totals[s] + cfg.interpod_weight * torch.where(
                    mx[s] > mn[s], MAX * (ip[s] - mn[s]) / (mx[s] - mn[s]), zero[s])
        if img_on:
            for s, sh in enumerate(shards):
                totals[s] = totals[s] + cfg.image_weight * sh.image_score[p].to(torch.float32)
        totals = [torch.where(f, t, n) for f, t, n in zip(feas, totals, ninf)]
        best = _rmax(totals, span)
        if not bool(best[0] > ninf[0]):
            continue
        choice = int(_rmin([torch.where((t == b) & f, nd, im)
                            for t, b, f, nd, im in zip(totals, best, feas, nodes, imax)], span)[0])
        choices[p] = choice
        own, lc = divmod(choice, nl)
        own -= first  # the owner's local index (another rank's shard: out of range)
        if 0 <= own < S:
            st[own]["used"][lc] += shards[own].pod_req[p]
            if cfg.enable_ports:
                st[own]["ports"][lc] |= shards[own].pod_ports[p]
        if pw:
            # the committed domain column: the owner shard's, the psum broadcast
            cols = psum([x["dbt"][:, lc] if s == own else torch.zeros_like(x["dbt"][:, 0])
                         for s, x in enumerate(st)], span)
            for s, sh in enumerate(shards):
                x, dcol = st[s], cols[s]
                x["cnt"], x["anti"], x["total"] = pairwise.commit_counts(
                    x["cnt"], x["anti"], x["total"], x["dbt"], D, choice, dcol, sh.pod_match_terms[p],
                    sh.pod_match_vals[p], sh.pod_anti_terms[p])
                if ips:
                    terms = [(sh.pod_pref_aff_terms[p], sh.pod_pref_aff_w[p])]
                    if cfg.hard_pod_affinity_weight:
                        aff = sh.pod_aff_terms[p]
                        terms.append((aff, torch.full(aff.shape, float(cfg.hard_pod_affinity_weight),
                                                      dtype=torch.float32, device=devs[s])))
                    for ids, w in terms:
                        bids = torch.clamp_min(ids, 0).to(torch.int64)
                        bw = torch.where(ids >= 0, w, zero[s])
                        x["pref"] = x["pref"].index_add(0, bids, bw[:, None] * (x["dbt"][bids] == dcol[bids][:, None]))
    used = all_gather_nodes([x["used"] for x in st], 0, sa.device, span)
    if not with_state:
        return choices, used
    return choices, used, _gathered_state(sa, st)


def _gathered_state(sa, st) -> dict:
    span = sa.mesh.span
    g = {k: all_gather_nodes([x[k] for x in st], 1, sa.device, span) for k in ("cnt", "anti", "pref")}
    g["total"] = _on(st[0]["total"], sa.device)
    g["ports"] = all_gather_nodes([x["ports"] for x in st], 0, sa.device, span)
    return g


# ---------------------------------------------------------------------------
# the sharded rounds scan (the JAX package's schedule_scan_rounds(axis_name=))
# ---------------------------------------------------------------------------

def _round_start(cfg, cxs, sts, tot, base0, fit0, nodes, span):
    """The exact re-hoist of a round on every shard (assign.py:1832-1919
    with its collectives) -> (feasible, total per shard, c0, r: the
    normalisation scalars (replicated, one copy on shard 0's device) and
    the raws per shard)."""
    S = len(cxs)
    C = base0[0].shape[0]
    devs = [b.device for b in base0]
    ninf = [torch.tensor(float("-inf"), device=d) for d in devs]
    zero = [torch.zeros((), dtype=torch.float32, device=d) for d in devs]
    pw = cfg.enable_pairwise
    ips = pw and cfg.enable_interpod_score
    MAX = MAX_NODE_SCORE
    r = {}
    feas = [cx["sf"] & f for cx, f in zip(cxs, fit0)]
    if cfg.enable_ports:
        feas = [f & ~(st["ports"][None, :, :] & cx["ports"][:, None, :]).any(dim=2)
                for f, st, cx in zip(feas, sts, cxs)]
    if pw:
        oks = [[] for _ in range(S)]
        raws = [[] for _ in range(S)]
        for i in range(C):
            mm = pmin([pairwise.spread_min(st["cnt"], st["hk"], cx["spread_t"][i], cx["elig"][i])
                       for st, cx in zip(sts, cxs)], span)
            for s, (st, cx) in enumerate(zip(sts, cxs)):
                ok, raw = pairwise.spread_step(st["cnt"], st["hk"], cx["spread_t"][i], cx["skew"][i], cx["hard"][i],
                                               cx["elig"][i], min_match=mm[s])
                ok = ok & pairwise.interpod_required_ok(st["cnt"], st["anti"], _on(tot["total"], devs[s]), st["hk"],
                                                        cx["aff"][i], cx["anti"][i], cx["mt"][i], cx["mv"][i],
                                                        cx["aself"][i])
                oks[s].append(ok)
                raws[s].append(raw)
        r["spread_raw"] = [torch.stack(x) for x in raws]
        feas = [f & torch.stack(o) for f, o in zip(feas, oks)]
    total = list(base0)

    def add(w, terms):
        for s in range(S):
            total[s] = total[s] + w * terms[s]

    def scal(rows, fill):
        return _rmax([torch.where(f, x, fl) for f, x, fl in zip(feas, rows, fill)], span)

    if cfg.enable_taint_score:
        mx = scal([cx["traw"] for cx in cxs], zero)
        r["t_mx"] = mx[0]
        add(cfg.taint_weight, [torch.where((m > 0)[:, None], MAX - MAX * cx["traw"] / m[:, None],
                                           torch.full_like(cx["traw"], MAX)) for m, cx in zip(mx, cxs)])
    if cfg.enable_node_pref:
        mx = scal([cx["naraw"] for cx in cxs], zero)
        r["na_mx"] = mx[0]
        add(cfg.node_affinity_weight, [torch.where((m > 0)[:, None], cx["naraw"] * MAX / m[:, None], z)
                                       for m, cx, z in zip(mx, cxs, zero)])
    if pw:
        mx = scal(r["spread_raw"], zero)
        r["s_mx"] = mx[0]
        add(cfg.spread_weight, [torch.where((m > 0)[:, None], MAX - MAX * x / m[:, None], torch.full_like(x, MAX))
                                for m, x in zip(mx, r["spread_raw"])])
    if ips:
        r["ip_raw"] = [torch.stack([pairwise.interpod_pref_raw(
            st["cnt"], st["pref"], st["hk"], cx["pref_t"][i], cx["pref_w"][i], cx["mt"][i], cx["mv"][i])
            for i in range(C)]) for st, cx in zip(sts, cxs)]
        mx = scal(r["ip_raw"], ninf)
        mn = [-x for x in scal([-x for x in r["ip_raw"]], ninf)]
        r["ip_mx"], r["ip_mn"] = mx[0], mn[0]
        add(cfg.interpod_weight, [torch.where((a > b)[:, None], MAX * (x - b[:, None]) / (a[:, None] - b[:, None]), z)
                                  for a, b, x, z in zip(mx, mn, r["ip_raw"], zero)])
    if "img" in cxs[0]:
        add(cfg.image_weight, [cx["img"] for cx in cxs])
    total = [torch.where(f, t, n) for f, t, n in zip(feas, total, ninf)]
    best = _rmax(total, span)
    imax = [torch.tensor(_INT_MAX, dtype=torch.int32, device=d) for d in devs]
    cand = _rmin([torch.where((t == b[:, None]) & f, nd[None, :], im)
                  for t, b, f, nd, im in zip(total, best, feas, nodes, imax)], span)
    c0 = torch.where((best[0] > ninf[0]) & cxs[0]["valid"], cand[0], -1)
    return feas, total, c0, r


def _repair(cfg, cxs, r, feas, total, share, c, unc, used, alloc, nodes, jlt, nl, span):
    """(t, hard) for the speculation c (assign.py:1938-2056 with its
    collectives): the candidate columns of the round-start rows through
    _gather_cols, the best unpicked node through _rmax / _rmin."""
    dev = c.device
    C = c.shape[0]
    R = used.shape[1]
    MAX = MAX_NODE_SCORE
    neg_inf = torch.tensor(float("-inf"), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    imax = torch.tensor(_INT_MAX, dtype=torch.int32, device=dev)
    creq = cxs[0]["req"]
    act = unc & (c >= 0)
    cn = torch.clamp_min(c, 0)
    cn64 = cn.to(torch.int64)
    E = (c[:, None] == c[None, :]) & act[:, None]
    T3 = E[:, :, None].to(torch.int32) * creq[:, None, :]
    cum = torch.cumsum(T3, dim=0, dtype=torch.int32) - T3
    ca = alloc[cn64]
    uij = used[cn64][None, :, :] + cum
    fitij = ((creq[:, None, :] == 0) | (creq[:, None, :] <= ca[None] - uij)).all(dim=2)
    reqij = uij + creq[:, None, :]
    baseij = score_flat(reqij.reshape(-1, R), ca[None].expand(C, C, R).reshape(-1, R), cfg).reshape(C, C)

    def cols(xs):
        return _gather_cols(xs, cn, nl, span)[0]

    feas0_at = cols(feas)
    newtot = baseij
    extreme_at = torch.zeros((C, C), dtype=torch.bool, device=dev)
    if cfg.enable_taint_score:
        r_at, mx = cols([cx["traw"] for cx in cxs]), r["t_mx"][:, None]
        newtot = newtot + cfg.taint_weight * torch.where(
            mx > 0, MAX - MAX * r_at / mx, torch.full_like(newtot, MAX))
        extreme_at = extreme_at | ((mx > 0) & (r_at == mx))
    if cfg.enable_node_pref:
        r_at, mx = cols([cx["naraw"] for cx in cxs]), r["na_mx"][:, None]
        newtot = newtot + cfg.node_affinity_weight * torch.where(mx > 0, r_at * MAX / mx, zero)
        extreme_at = extreme_at | ((mx > 0) & (r_at == mx))
    if cfg.enable_pairwise:
        r_at, mx = cols(r["spread_raw"]), r["s_mx"][:, None]
        newtot = newtot + cfg.spread_weight * torch.where(
            mx > 0, MAX - MAX * r_at / mx, torch.full_like(newtot, MAX))
        extreme_at = extreme_at | ((mx > 0) & (r_at == mx))
        if cfg.enable_interpod_score:
            r_at, mx, mn = cols(r["ip_raw"]), r["ip_mx"][:, None], r["ip_mn"][:, None]
            newtot = newtot + cfg.interpod_weight * torch.where(mx > mn, MAX * (r_at - mn) / (mx - mn), zero)
            extreme_at = extreme_at | ((mx > mn) & ((r_at == mx) | (r_at == mn)))
    if "img" in cxs[0]:
        newtot = newtot + cfg.image_weight * cols([cx["img"] for cx in cxs])
    newtot = torch.where(feas0_at & fitij, newtot, neg_inf)
    dropped = feas0_at & ~fitij
    hard = ((share | (dropped & extreme_at)) & jlt & act[None, :]).any(dim=1)
    pb = []
    for nd in nodes:
        O = ((_on(c, nd.device)[:, None] == nd[None, :]) & _on(act, nd.device)[:, None]).to(torch.float32)
        pb.append((_on(jlt, nd.device).to(torch.float32) @ O) > 0.0)
    av = _rmax([torch.where(p_, torch.tensor(float("-inf"), device=t.device), t) for p_, t in zip(pb, total)], span)
    a_n = _rmin([torch.where((t == a[:, None]) & ~p_, nd[None, :], torch.tensor(_INT_MAX, dtype=torch.int32,
                                                                                  device=t.device))
                 for t, a, p_, nd in zip(total, av, pb, nodes)], span)[0]
    av = av[0]
    Mj = torch.where(act[None, :] & jlt, newtot, neg_inf)
    vb = Mj.max(dim=1).values
    b_n = torch.where(Mj == vb[:, None], cn[None, :], imax).min(dim=1).values
    t_val = torch.maximum(av, vb)
    t_n = torch.where(vb > av, b_n, torch.where(av > vb, a_n, torch.minimum(a_n, b_n)))
    t = torch.where((t_val > neg_inf) & cxs[0]["valid"], t_n, -1).to(torch.int32)
    return t, hard


def _rounds_chunk(cfg, cxs, sts, tot, alloc, D, nodes, repair_iters, nl, bases, span, req_u=None):
    """The round loop of one chunk on the mesh (assign.py:1830-2212 under
    shard_map) -> (out, nrounds, ord_).  `sts` hold each local shard's [T,
    nl] count planes and ports (and in class mode its [U1, nl] class base
    and fit hoists), `bases` their first global node ids, `tot` the
    replicated usage [N, R] and total_t."""
    S = len(cxs)
    dev = tot["used"].device
    creq = cxs[0]["req"]
    C = creq.shape[0]
    N = alloc.shape[0]
    T = sts[0]["dbt"].shape[0]
    pw = cfg.enable_pairwise
    ips = pw and cfg.enable_interpod_score
    idxC = torch.arange(C, dtype=torch.int32, device=dev)
    jlt = idxC[None, :] < idxC[:, None]
    share = assign.chunk_share(cxs[0], cfg, T)
    if req_u is None:
        base0, fit0 = [], []
        for s, (cx, st) in enumerate(zip(cxs, sts)):
            u = _on(tot["used"][bases[s]:bases[s] + nl], st["dbt"].device)
            base0.append(_scores(cx["req"], u, st["alloc"], cfg))
            fit0.append(fit_rows(cx["req"], u, st["alloc"]))
    committed = torch.zeros(C, dtype=torch.bool, device=dev)
    out = torch.full((C,), -1, dtype=torch.int32, device=dev)
    ord_ = torch.zeros(C, dtype=torch.int32, device=dev)
    nrounds = 0
    Zr = min(32, N)
    while not bool(committed.all()):
        if nrounds >= C:
            raise RuntimeError("rounds scan: a chunk exceeded its round cap (every round commits a pod)")
        unc = ~committed
        if req_u is not None:
            base0 = [st["base_u"][cx["cls"]] for st, cx in zip(sts, cxs)]
            fit0 = [st["fit_u"][cx["cls"]] for st, cx in zip(sts, cxs)]
        feas, total, c0, r = _round_start(cfg, cxs, sts, tot, base0, fit0, nodes, span)
        same0 = (c0[:, None] == c0[None, :]) & (c0[None, :] >= 0) & unc[None, :]
        rank = (same0 & jlt).sum(dim=1).to(torch.int32)
        topv, topi = (x[0] for x in _global_top_k(total, Zr, span))
        sel = torch.clamp_max(rank, Zr - 1).to(torch.int64)[:, None]
        v_sel = torch.gather(topv, 1, sel)[:, 0]
        c_sp = torch.gather(topi, 1, sel)[:, 0]
        c = torch.where(unc & (c0 >= 0) & (rank > 0) & (rank < Zr) & (v_sel > float("-inf")), c_sp, c0)
        for _ in range(repair_iters - 1):
            t, hard = _repair(cfg, cxs, r, feas, total, share, c, unc, tot["used"], alloc, nodes, jlt, nl, span)
            c = torch.where(unc, t, c)
        t, hard = _repair(cfg, cxs, r, feas, total, share, c, unc, tot["used"], alloc, nodes, jlt, nl, span)
        bad = unc & (hard | (t != c))
        firstbad = int(assign._first(bad)) if bool(bad.any()) else C
        fb_commit = (idxC == firstbad) & unc & ~hard
        c_final = torch.where(fb_commit, t, c)
        prefix = unc & (idxC < firstbad)
        commit_set = prefix | fb_commit
        pact = commit_set & (c_final >= 0)
        cn_final = torch.clamp_min(c_final, 0)
        out = torch.where(commit_set, c_final, out)
        ord_ = torch.where(commit_set, torch.tensor(nrounds, dtype=torch.int32, device=dev), ord_)
        committed = committed | commit_set
        # ---- absorb: the replicated usage, then each shard's own columns ----
        used = tot["used"].clone()
        used.index_add_(0, c_final[pact].to(torch.int64), creq[pact])
        tot["used"] = used
        cols = cn_final.to(torch.int64)
        col_used, col_alloc = used[cols], alloc[cols]
        if req_u is None:
            col_fit, col_base = fit_rows(creq, col_used, col_alloc), _scores(creq, col_used, col_alloc, cfg)
        else:
            col_fit, col_base = fit_rows(req_u, col_used, col_alloc), _scores(req_u, col_used, col_alloc, cfg)
        for s, (st, cx) in enumerate(zip(sts, cxs)):
            d = st["dbt"].device
            own = _on(pact & (cols >= bases[s]) & (cols < bases[s] + nl), d)
            lc = _on(cols - bases[s], d)[own]
            if req_u is None:
                base0[s] = base0[s].clone()
                fit0[s] = fit0[s].clone()
                base0[s][:, lc] = _on(col_base, d)[:, own]
                fit0[s][:, lc] = _on(col_fit, d)[:, own]
            else:
                st["base_u"] = st["base_u"].clone()
                st["fit_u"] = st["fit_u"].clone()
                st["base_u"][:, lc] = _on(col_base, d)[:, own]
                st["fit_u"][:, lc] = _on(col_fit, d)[:, own]
            if cfg.enable_ports:
                st["ports"] = st["ports"].to(torch.int32).index_add(0, lc, cx["ports"][own].to(torch.int32)) > 0
        if pw:
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            cx = cxs[0]

            def scatter(key, ids, w):
                tids = torch.clamp_min(ids, 0).to(torch.int64).reshape(-1)
                nds = cn_final.to(torch.int64)[:, None].expand(ids.shape).reshape(-1)
                wf = w.reshape(-1)
                dcol = _gather_at_nodes([st["dbt"] for st in sts], tids, nds, nl, span)
                for s, st in enumerate(sts):
                    d = st["dbt"].device
                    st[key] = _scatter_rows(st[key], st["dbt"], ids.to(d), None, _on(w, d), dcol=dcol[s])[0]
                return tids, dcol[0], wf

            w_mt = torch.where((cx["mt"] >= 0) & pact[:, None], cx["mv"], zero)
            tids_mt, dcol_mt, wf_mt = scatter("cnt", cx["mt"], w_mt)
            tot["total"] = tot["total"].index_add(0, tids_mt, wf_mt * (dcol_mt < D))
            scatter("anti", cx["anti"], ((cx["anti"] >= 0) & pact[:, None]).to(torch.float32))
            if ips:
                scatter("pref", cx["pref_t"], torch.where((cx["pref_t"] >= 0) & pact[:, None], cx["pref_w"], zero))
                if cfg.hard_pod_affinity_weight:
                    hw = torch.tensor(float(cfg.hard_pod_affinity_weight), dtype=torch.float32, device=dev)
                    scatter("pref", cx["aff"], torch.where((cx["aff"] >= 0) & pact[:, None], hw, zero))
        nrounds += 1
    return out, nrounds, ord_


def sharded_schedule_scan_rounds_plain(sa: ShardedArrays, cfg, sfs=None, eligs=None, planes=None,
                                       rchunk: int = None, repair_iters: int = None, inc=None,
                                       with_state: bool = False):
    """The JAX package's assign.py:1464 schedule_scan_rounds(axis_name=,
    axis_size=) over per-shard lists, in dense mode (`sfs`, `eligs`: the
    shards' K7 planes [P, words(nl)], `planes` their score_planes; the plain
    versions when not given) or on class state (`inc`: the per-shard
    IncStates of HoistCache(mesh=), `inc.shards`).  The usage and total_t
    are replicated (the JAX package all-gathers the usage once per step);
    every per-node quantity stays per shard; per round, the collectives of
    the JAX program in its order (_rmax for the normalisation scalars and
    best, _rmin for the argmax, the spread pmin, _global_top_k with Zr =
    min(32, N) over the global N, _gather_cols for the repair's candidate
    columns, _gather_at_nodes for the commit's domain columns; the owner
    shard patches a committed column).

    -> (choices i32[P], used i32[N, R] on the padded axis, ordinals i32[P],
    sweeps int), and with `with_state` the final pairwise state gathered."""
    rchunk = RCHUNK if rchunk is None else rchunk
    repair_iters = REPAIR_ITERS if repair_iters is None else repair_iters
    P, nl, shards = sa.P, sa.nl, sa.shards
    if P % rchunk:
        raise ValueError(f"the rounds scan takes chunks of {rchunk} pods dividing P; got P={P}")
    bases = _bases(sa)
    img_on = assign._image_on(sa, cfg)
    incs = inc.shards if inc is not None else [None] * len(shards)
    if inc is None and sfs is None:
        sfs, eligs = zip(*[assign.packed_static_rows_plain(sh, with_elig=True, base=b)
                           for sh, b in zip(shards, bases)])
    if inc is None and planes is None:
        planes = [assign.score_planes(sh, cfg) for sh in shards]
    rows = [assign.rounds_inputs(sh, cfg, None if sfs is None else sfs[s], None if eligs is None else eligs[s],
                                 (None, None) if planes is None else planes[s], incs[s], img_on=img_on)
            for s, sh in enumerate(shards)]
    sts, D = _pairwise0(sa)
    for s, sh in enumerate(shards):
        sts[s].update(alloc=sh.node_alloc, ports=sh.node_ports0.clone())
        if inc is not None:
            sts[s].update(base_u=incs[s].base_u, fit_u=bitplane.unpack(incs[s].fit_u, nl))
    tot = {"used": sa.gather("node_used"), "total": sts[0]["total"]}
    alloc = sa.gather("node_alloc")
    nodes = _nodes(sa)
    req_u = None if inc is None else _on(inc.shards[0].req_u, sa.device)
    outs, ords, rounds = [], [], []
    for ch in range(P // rchunk):
        sl = slice(ch * rchunk, (ch + 1) * rchunk)
        o, nr, od = _rounds_chunk(cfg, [rw(sl) for rw in rows], sts, tot, alloc, D, nodes, repair_iters, nl, bases,
                                  sa.mesh.span, req_u)
        outs.append(o)
        ords.append(od)
        rounds.append(nr)
    dev = sa.device
    base = torch.tensor([0] + rounds[:-1], dtype=torch.int64).cumsum(0).to(torch.int32).to(dev)
    ords_g = (base[:, None] + torch.stack(ords)).reshape(-1)
    out = (torch.cat(outs), tot["used"], ords_g, sum(rounds))
    if not with_state:
        return out
    st = _gathered_state(sa, sts)
    st["total"] = tot["total"]
    return out + (st,)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def _placed(arr, mesh, device):
    """`arr` on `mesh` (a NodeMesh -> ShardedArrays, a GridMesh ->
    GridArrays): placed arrays are checked, a ClusterArrays is padded and
    placed."""
    kind, place = (GridArrays, grid_arrays) if isinstance(mesh, GridMesh) else (ShardedArrays, shard_arrays)
    sa = arr if isinstance(arr, kind) else place(arr, mesh)
    if sa.mesh != mesh:
        raise ValueError(f"arrays placed on {sa.mesh}, step asked on {mesh}")
    if sa.device.type != device.type:
        raise ValueError(f"arrays on the mesh's {sa.device}, step asked on {device}")
    return sa


def _unshard(arr, mesh: GridMesh, device, inc=None):
    """Arrays on the grid -> (the first held pod row's ShardedArrays after
    the entry gather, inc gathered too, the caller's P: the per-pod
    outputs are sliced back to it)."""
    ga = _placed(arr, mesh, device)
    sa, inc = assign.pod_unshard(ga, inc)
    return sa, inc, arr.P


def inc_applicable(sa: ShardedArrays, cfg, inc):
    """The JAX package's inc_applicable on the padded arrays, for the class
    state of HoistCache(mesh=) (its per-shard planes in inc.shards)."""
    if inc is None or getattr(inc, "shards", None) is None:
        return None
    sh = inc.shards[0]
    if inc.req_u.shape[0] >= sa.P or inc.cls.shape[0] != sa.P or sa.P % INC_CHUNK:
        return None
    if inc.req_u.shape[1] != sa.shards[0].R or len(inc.shards) != len(sa.shards):
        return None
    for plane, axis in INC_NODE_AXIS.items():  # each shard's planes span its nl nodes
        x = getattr(sh, plane)
        if x is not None and x.shape[axis] != (bitplane.words_for(sa.nl) if x.dtype == torch.int32 else sa.nl):
            return None
    if ((cfg.enable_pairwise and sh.elig_u is None) or (cfg.enable_taint_score and sh.traw_u is None)
            or (cfg.enable_node_pref and sh.naraw_u is None)
            or (assign._image_on(sa, cfg) != (sh.img_u is not None))):
        return None
    return inc


def sharded_dispatch(arr, cfg, mesh, device, inc=None, chunked=None, **knobs) -> Step:
    """Route and launch one step on `mesh` (ops/assign.py -- dispatch with
    mesh=): `arr` is a ShardedArrays on the node mesh (a GridArrays on the
    grid), or a ClusterArrays, which is padded and placed first.  The
    routes of dispatch, in its order, on the padded arrays: class state ->
    the class-wave route (a chunkable batch) or the rounds route in class
    mode; else the dense chunked route or the dense rounds route, on the
    CPU too; with chunked=False, or a batch neither takes, the per-pod
    scan.  On the grid the pod axis is padded before the route is chosen
    (a 64-pod batch on 3 pod rows runs 66 pods: not the rounds route), the
    pod-axis fields are gathered at entry (pod_unshard) and the node mesh
    of one row runs the step; choices and ordinals come back sliced to the
    caller's P (the JAX package's sharded.py:213-257)."""
    if isinstance(mesh, GridMesh):
        sa, inc, p = _unshard(arr, mesh, device, inc)
        step = sharded_dispatch(sa, cfg, sa.mesh, device, inc, chunked, **knobs)
        return step if p == sa.P else step._replace(choices=step.choices[:p], ordinals=step.ordinals[:p])
    sa = _placed(arr, mesh, device)
    inc = inc_applicable(sa, cfg, inc)
    chunkable = assign._chunkable(sa, cfg)
    if inc is not None and chunkable:
        TRACE_COUNTS["sharded_chunked_inc"] += 1
        return Step(*assign.chunked_inc(sa.commit_view(), cfg, inc, **knobs))
    if inc is not None and assign._rounds_capable(sa, cfg):
        TRACE_COUNTS["sharded_rounds_inc"] += 1
        return Step(*_rounds(sa, cfg, inc, **knobs))
    routed = chunked is not False  # on a mesh the CPU routes too (the JAX tests' KTPU_FORCE_CHUNKED=1)
    if routed and chunkable:
        TRACE_COUNTS["sharded_chunked"] += 1
        cv = sa.commit_view()
        sfs = static_rows(sa)
        with subphase("round_loop"):
            if cv.device.type != "cpu":
                from ..ops import kernels

                return Step(*kernels.chunk_rounds_dense(cv, cfg, sfs))
            return Step(*assign.schedule_scan_chunked_dense_plain(cv, cfg, sfs))
    if routed and assign._rounds_capable(sa, cfg):
        TRACE_COUNTS["sharded_rounds"] += 1
        return Step(*_rounds(sa, cfg, None, **knobs))
    TRACE_COUNTS["sharded_plain"] += 1
    choices, used = _per_pod(sa, cfg)
    return Step(choices, used, torch.arange(sa.P, dtype=torch.int32, device=sa.device), sa.P)


def _rounds(sa: ShardedArrays, cfg, inc, rchunk: int = None, repair_iters: int = None):
    """The sharded rounds route: on the card K7 (with the eligibility
    plane) and K10 per shard, then K12 in shard mode (class state: K12 in
    shard class-row mode alone); on the CPU the plain version."""
    bases = _bases(sa)
    if sa.device.type == "cpu":
        with subphase("round_loop"):
            return sharded_schedule_scan_rounds_plain(sa, cfg, rchunk=rchunk, repair_iters=repair_iters, inc=inc)
    from ..ops import kernels

    if inc is not None:
        with subphase("round_loop"):
            return kernels.rounds_shard(sa, cfg, inc=inc, rchunk=rchunk, repair_iters=repair_iters)
    sfs, eligs = zip(*[assign.packed_static_rows(sh, with_elig=True, base=b) for sh, b in zip(sa.shards, bases)])
    planes = [assign.score_planes(sh, cfg) for sh in sa.shards]
    with subphase("round_loop"):
        return kernels.rounds_shard(sa, cfg, sfs, eligs, planes, rchunk=rchunk, repair_iters=repair_iters)


def _per_pod(sa: ShardedArrays, cfg):
    """The sharded per-pod scan: on the card K1 per shard (with its base)
    and K2 in shard mode for the fit-only stage set, else K7 with the
    eligibility plane and K10 per shard and K11 in shard mode; on the CPU
    the plain version."""
    bases = _bases(sa)
    if sa.device.type == "cpu":
        with subphase("score"):
            return sharded_schedule_scan_plain(sa, cfg)
    from ..ops import kernels

    if assign.fit_only(cfg, sa):
        sfs = [filters.static_feasible(sh, base=b) for sh, b in zip(sa.shards, bases)]
        with subphase("score"):
            return kernels.fit_scan_shard(sfs, sa, cfg)
    sfs, eligs = zip(*[assign.packed_static_rows(sh, with_elig=True, base=b) for sh, b in zip(sa.shards, bases)])
    planes = [assign.score_planes(sh, cfg) for sh in sa.shards]
    with subphase("score"):
        return kernels.full_scan_shard(sa, cfg, sfs, eligs, planes)


def sharded_schedule_batch(arr, cfg, mesh, device=None):
    """The JAX package's sharded_schedule_batch (its sharded.py:56): the
    unrouted per-pod scan on the mesh or the grid -> (choices i32[P],
    used i32[N, R] on the padded node axis).  The JAX function takes node
    and pod counts the mesh divides only; the port pads the rest, as the
    routed step does."""
    from ..device import resolve_device

    dev = resolve_device(device)
    assign.check_config(cfg)
    TRACE_COUNTS["sharded_plain"] += 1
    if isinstance(mesh, GridMesh):
        sa, _, p = _unshard(arr, mesh, dev)
        choices, used = _per_pod(sa, cfg)
        return choices[:p], used
    return _per_pod(_placed(arr, mesh, dev), cfg)


def sharded_schedule_batch_routed(arr, cfg, mesh, device=None, with_ordinals: bool = False, inc=None,
                                  **knobs):
    """The JAX package's sharded_schedule_batch_routed: -> (choices, used)
    or, with `with_ordinals`, (choices, used, ordinals, sweeps), used on the
    padded node axis; the step's status is read (ops/assign.py -- finish)."""
    step = assign.finish(assign.dispatch(arr, cfg, device, inc, mesh=mesh, **knobs))
    return tuple(step) if with_ordinals else tuple(step[:2])


__all__ = ["inc_applicable", "sharded_dispatch", "sharded_schedule_batch", "sharded_schedule_batch_routed",
           "sharded_schedule_scan_plain", "sharded_schedule_scan_rounds_plain", "static_rows"]
