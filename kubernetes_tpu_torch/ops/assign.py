"""Batched assignment with sequential-commit semantics — the port of the JAX
package's ``ops/assign.py`` for the fit-only stage set: the per-pod scan
``schedule_scan``, and ``schedule_scan_chunked`` in both its modes (dense,
and the incremental class-wave route).

Static feasibility is evaluated for the whole batch up front ([P, N]); then
pods commit one at a time in activeQ order (== tensor order).  Each step
re-evaluates NodeResourcesFit.Filter against the running node usage, scores
the feasible nodes (fit strategy + BalancedAllocation), takes the highest
score with ties to the LOWEST node index, and adds the pod's request to the
chosen node's usage.

``schedule_scan_plain`` is the plain PyTorch version (one Python step per
pod); on the card the per-pod route runs the static-feasibility kernel and
the fit-scan kernel (csrc/).  Stages this slice does not port raise
NotImplementedError (ops/scores.py — check_config).

THE DENSE CHUNKED ROUTE (no class state).  ``CHUNK`` pods at a time: the
chunk's masked scores [C, N] against the usage its predecessors left, the
top-(C+1) candidates per pod, then the prefix-commit round loop
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

ROUTING (``dispatch``, the JAX package's schedule_batch_routed): class
state that fits -> the class-wave route; else a chunkable batch on the card
-> the dense chunked route (its ``_chunk_routed`` off the CPU); else the
per-pod route.  On the CPU the dense route runs only with ``chunked=True``
(the JAX package's ``KTPU_FORCE_CHUNKED=1``).  Decisions are the same on
every route; commit ordinals and the sweep count are each route's own and
equal the JAX route's.  ``dispatch`` launches without a host
synchronisation; ``finish`` reads the sweep count and the round-cap status
back and raises on the cap (``schedule_batch`` does both).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from ..device import resolve_device
from . import bitplane, filters
from .incremental import _scores, fit_rows, score_flat
from .scores import ScoreConfig, balanced_allocation, check_config, fit_score

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

# Route counters, bumped per call (the JAX package bumps its TRACE_COUNTS
# per trace; eager PyTorch has no trace, so a call is the unit here).
TRACE_COUNTS = {"plain": 0, "chunked": 0, "chunked_inc": 0, "class_waves": 0}


def reset_trace_counts() -> None:
    for k in TRACE_COUNTS:
        TRACE_COUNTS[k] = 0


def schedule_scan_plain(arr, cfg: ScoreConfig, sf: torch.Tensor = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (choices i32[P] node index or -1, node_used i32[N, R]), the plain
    per-pod scan.  `sf` is the static-feasibility mask (computed with the
    plain version when not given)."""
    if sf is None:
        sf = filters.static_feasible_plain(arr)
    dev = arr.device
    alloc = arr.node_alloc
    used = arr.node_used.clone()
    nodes = torch.arange(arr.N, dtype=torch.int32, device=dev)
    int_max = torch.tensor(_INT_MAX, dtype=torch.int32, device=dev)
    neg_inf = torch.tensor(float("-inf"), dtype=torch.float32, device=dev)
    choices = torch.full((arr.P,), -1, dtype=torch.int32, device=dev)
    valid = arr.pod_valid.cpu().tolist()
    for p in range(arr.P):
        if not valid[p]:
            continue  # a padding or gated pod: its sf row is all False
        req = arr.pod_req[p]
        feasible = sf[p] & filters.fit_ok(req, used, alloc)
        requested = used + req[None, :]
        total = cfg.fit_weight * fit_score(requested, alloc, cfg) + cfg.balanced_weight * balanced_allocation(
            requested, alloc, cfg.score_resources
        )
        total = torch.where(feasible, total, neg_inf)
        best = total.max()
        cand = torch.where((total == best) & feasible, nodes, int_max)
        choice = torch.where(best > neg_inf, cand.min(), torch.tensor(-1, dtype=torch.int32, device=dev))
        choices[p] = choice
        placed = (nodes == choice)[:, None]
        used = used + placed.to(torch.int32) * req[None, :]
    return choices, used


def _per_pod(arr, cfg: ScoreConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    TRACE_COUNTS["plain"] += 1
    sf = filters.static_feasible(arr)
    if arr.device.type == "cpu":
        return schedule_scan_plain(arr, cfg, sf=sf)
    from . import kernels

    return kernels.fit_scan(sf, arr, cfg)[:2]


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


def packed_static_rows_plain(arr) -> torch.Tensor:
    """int32 words [P, ceil(N/32)]: static feasibility of every pod row,
    pod_valid included, packed per block of CHUNK rows (the JAX package's
    lax.map of _sf_block, assign.py:1014-1053) -> the plain version of
    kernel K7 packed_static_rows."""
    P, N = arr.P, arr.N
    tm = filters.term_match(arr.sel_mask, arr.sel_kind, arr.node_labels)
    nodes = torch.arange(N, dtype=torch.int32, device=arr.device)
    blocks = []
    for b0 in range(0, P, CHUNK):
        sl = slice(b0, min(P, b0 + CHUNK))
        sf, _ = filters.static_feasible_rows(
            tm, arr.node_valid, arr.node_taint_ns, nodes, arr.pod_terms[sl], arr.pod_has_sel[sl],
            arr.pod_tol_ns[sl], arr.pod_nodename[sl], arr.pod_valid[sl])
        blocks.append(bitplane.pack(sf))
    return torch.cat(blocks)


def packed_static_rows(arr) -> torch.Tensor:
    """The packed [P, W] static plane on arr's device: the plain version for
    CPU tensors, kernel K7 for CUDA tensors."""
    if arr.device.type == "cpu":
        return packed_static_rows_plain(arr)
    from . import kernels

    return kernels.packed_static_rows(arr)


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
    if arr.device.type != "cpu":
        from . import kernels

        return kernels.chunk_rounds_dense(arr, cfg, sfs)
    return schedule_scan_chunked_dense_plain(arr, cfg, sfs)


def _chunkable(arr, cfg: ScoreConfig) -> bool:
    """The JAX package's assign.py:494 _chunkable for the fit-only stage set
    (check_config has refused every other stage): P is a multiple of the
    dense chunk."""
    return arr.P >= CHUNK and arr.P % CHUNK == 0


def inc_route_applies(arr, cfg: ScoreConfig) -> bool:
    """Whether (arr, cfg) routes the class-wave route at all: callers gate
    HoistCache.ensure() on it (the JAX package's assign.py:2237)."""
    return _chunkable(arr, cfg)


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
    return inc


def schedule_scan_chunked(arr, cfg: ScoreConfig, inc, class_waves: bool = CLASS_WAVES,
                          wave_k: int = WAVE_K, wave_block: int = WAVE_BLOCK):
    """The class-wave route: stage A (waves) then stage B (chunk rounds) ->
    (choices i32[P], used i32[N, R], ordinals i32[P], sweeps).  On CUDA
    tensors the t0u prologue and stage A run in kernel K5, stage B in K6;
    on the CPU the plain versions."""
    TRACE_COUNTS["chunked_inc"] += 1
    if class_waves:
        TRACE_COUNTS["class_waves"] += 1
    if arr.device.type != "cpu":
        from . import kernels

        wave = None
        t0u = None
        if class_waves:
            wcom, wout, wordn, used_w, t0u, n_blocks, _ = kernels.wave_commit(
                arr, inc, cfg, wave_k=wave_k, wave_block=wave_block)
            wave = (wcom, wout, wordn, n_blocks)
        else:
            used_w = arr.node_used
        return kernels.chunk_rounds(arr, inc, cfg, used_w, t0u, wave)
    t0u = t0u_prologue(inc, arr.N)
    wave = None
    used = arr.node_used
    if class_waves:
        wcom, wout, wordn, used, t0u, n_blocks, _ = wave_commit_plain(
            inc.cls, arr.pod_valid, arr.pod_req, arr.node_used, t0u, inc.stat_u, arr.node_alloc,
            inc.req_u, cfg, wave_k=wave_k, wave_block=wave_block)
        wave = (wcom, wout, wordn, n_blocks)
    return schedule_scan_chunked_plain(arr, cfg, inc, used, t0u, wave)


class Step(NamedTuple):
    """A dispatched scheduling step.  On the card nothing has been read
    back: `sweeps` is then the kernels' int32[2] device pair (sweep count,
    round-cap status), which finish() reads."""

    choices: torch.Tensor  # i32[P] node index or -1
    used: torch.Tensor  # i32[N, R]
    ordinals: torch.Tensor  # i32[P]
    sweeps: Any  # int, or the int32[2] device pair


def dispatch(arr, cfg: ScoreConfig, device=None, inc=None, chunked: Optional[bool] = None, **knobs) -> Step:
    """Route and launch one step without a host synchronisation on the card
    (the pipeline's dispatch): with applicable class state `inc` the
    class-wave route; else, where the batch is chunkable, the dense chunked
    route (the JAX package's _chunk_routed: on the card by default, on the
    CPU only with chunked=True); else the per-pod route.  chunked=False
    keeps the per-pod route.  `knobs` are schedule_scan_chunked's."""
    dev = resolve_device(device)
    check_config(cfg)
    if arr.device.type != dev.type:
        arr = arr.to(dev)
    inc = inc_applicable(arr, cfg, inc)
    if inc is not None and _chunkable(arr, cfg):
        return Step(*schedule_scan_chunked(arr, cfg, inc, **knobs))
    if _chunkable(arr, cfg) and (arr.device.type != "cpu" if chunked is None else chunked):
        return Step(*schedule_scan_chunked_dense(arr, cfg))
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
