"""Per-step functions of PodTopologySpread, InterPodAffinity and NodePorts —
the port of the JAX package's ``ops/pairwise.py`` (its kernel row B9).

Shapes: T interned terms, D domains (domain id D: the node lacks the key),
N nodes, M matched-term slots, and per-pod constraint slots padded with -1.

The scans carry PER-NODE materialisations of the pairwise counts, as the
JAX package does:

  cnt_node[T, N]  = counts[t, dom(key_t, n)]   (matching pods in n's domain)
  anti_node[T, N] = anti_counts[t, dom(key_t, n)]
  pref_node[T, N] = pref_own[t, dom(key_t, n)]
  total_t[T]      = counts[t, :D].sum()        (matches anywhere with the key)

so a step reads O(slots) rows and a commit is a masked add on O(slots)
rows through the static dom_by_term[T, N] = node_dom[term_key] map.  Every
sum is integer-valued f32, exact below 2^24 in any order.

These are the plain versions, one pod at a time; ops/assign.py applies them
per pod (the per-pod scan) and per pod row of a chunk (the rounds scan).
On the card the same arithmetic is ``__device__`` code in
csrc/pairwise.cuh, inlined by kernels K11 full_scan and K12 rounds.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _rows(state_node: torch.Tensor, has_key_all: torch.Tensor, term_ids: torch.Tensor):
    """For each term slot (id or -1): its per-node state row and key
    presence -> (rows [A, N], has_key [A, N], valid [A])."""
    valid = term_ids >= 0
    tids = torch.clamp_min(term_ids, 0).to(torch.int64)
    return state_node[tids], has_key_all[tids], valid


def spread_min(cnt_node, has_key_all, spread_terms, eligible) -> torch.Tensor:
    """f32[CS]: each spread slot's min count over the keyed nodes passing
    the pod's node-affinity filter (`eligible`), inf where there is none --
    before the inf -> 0 of spread_step, so a node shard's partial joins the
    pmin of the others first (the JAX package's pairwise.py:54-58)."""
    cnt, has_key, _ = _rows(cnt_node, has_key_all, spread_terms)
    inf = torch.tensor(float("inf"), dtype=torch.float32, device=cnt.device)
    return torch.where(eligible[None, :] & has_key, cnt, inf).min(dim=1).values


def spread_step(cnt_node, has_key_all, spread_terms, maxskew, hard, eligible,
                min_match=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (ok bool[N] hard-constraint feasibility, raw f32[N] score counts).

    A DoNotSchedule constraint keeps count(domain) + 1 - minMatch <=
    maxSkew, minMatch the min count over the keyed nodes passing the pod's
    node-affinity filter (`eligible`; inf when there is none -> 0); nodes
    without the key fail it (podtopologyspread/filtering.go).  On a node
    shard `min_match` is the pmin of every shard's spread_min (inf kept)."""
    cnt, has_key, valid = _rows(cnt_node, has_key_all, spread_terms)
    if min_match is None:
        min_match = spread_min(cnt_node, has_key_all, spread_terms, eligible)
    min_match = torch.where(torch.isinf(min_match), torch.zeros_like(min_match), min_match)
    ok_c = has_key & (cnt + 1.0 - min_match[:, None] <= maxskew[:, None].to(torch.float32))
    ok_c = torch.where((valid & hard)[:, None], ok_c, torch.ones_like(ok_c))
    raw = torch.where(valid[:, None] & has_key, cnt, torch.zeros_like(cnt)).sum(dim=0)
    return ok_c.all(dim=0), raw


def interpod_required_ok(cnt_node, anti_node, total_t, has_key_all, aff_terms, anti_terms, match_terms,
                         match_vals, aff_self) -> torch.Tensor:
    """-> ok bool[N]: required pod affinity, the pod's own anti-affinity and
    the existing pods' anti-affinity against it (the symmetric half, through
    its matched-term slots), against the current per-node counts
    (interpodaffinity/filtering.go)."""
    # required affinity: every term's domain already holds a match, unless
    # no matching pod exists anywhere and the pod matches its own terms
    cnt, has_key, valid = _rows(cnt_node, has_key_all, aff_terms)
    ok_a = torch.where(valid[:, None], has_key & (cnt > 0), torch.ones_like(has_key))
    tids = torch.clamp_min(aff_terms, 0).to(torch.int64)
    zero = torch.zeros((), dtype=torch.float32, device=cnt.device)
    total_any = torch.where(valid, total_t[tids], zero).sum()
    self_all = torch.where(valid, aff_self, torch.ones_like(aff_self)).all()
    waiver = valid.any() & (total_any == 0) & self_all
    aff_ok = ok_a.all(dim=0) | waiver
    # own required anti-affinity: the domain holds no match (an absent key
    # cannot be violated)
    cnt2, has_key2, valid2 = _rows(cnt_node, has_key_all, anti_terms)
    anti_ok = torch.where(valid2[:, None], ~(has_key2 & (cnt2 > 0)), torch.ones_like(has_key2)).all(dim=0)
    # existing pods' anti-affinity against this pod, via the matched-term
    # slots (keyless nodes dropped)
    acnt, ahas_key, avalid = _rows(anti_node, has_key_all, match_terms)
    w = torch.where(avalid, match_vals, zero)[:, None]
    blocked = (torch.where(ahas_key, acnt, zero) * w).sum(dim=0)
    return aff_ok & anti_ok & (blocked == 0)


def interpod_pref_raw(cnt_node, pref_node, has_key_all, pref_terms, pref_w, match_terms,
                      match_vals) -> torch.Tensor:
    """f32[N]: preferred inter-pod affinity raw score, both directions
    (interpodaffinity/scoring.go — processExistingPod): own half
    sum_b w_b * cnt_node[t_b, n] (anti: w < 0), symmetric half
    sum_j mv_j * pref_node[mt_j, n]; keyless nodes excluded on both."""
    zero = torch.zeros((), dtype=torch.float32, device=cnt_node.device)
    cnt, has_key, valid = _rows(cnt_node, has_key_all, pref_terms)
    w = torch.where(valid, pref_w, zero)[:, None]
    own = (torch.where(has_key, cnt, zero) * w).sum(dim=0)
    pcnt, phas_key, pvalid = _rows(pref_node, has_key_all, match_terms)
    pw = torch.where(pvalid, match_vals, zero)[:, None]
    sym = (torch.where(phas_key, pcnt, zero) * pw).sum(dim=0)
    return own + sym


def ports_ok(ports_used: torch.Tensor, pod_ports_row: torch.Tensor) -> torch.Tensor:
    """-> ok bool[N]: no hostPort conflict (nodeports/node_ports.go — Fits)."""
    return ~(ports_used & pod_ports_row[None, :]).any(dim=1)


def commit_counts(cnt_node, anti_node, total_t, dom_by_term, n_domains: int, choice: int, dom_col,
                  match_terms, match_vals, anti_terms):
    """Absorb the committed pod into the per-node pairwise state (unchanged
    when choice < 0) -> (cnt_node, anti_node, total_t), new tensors.

    `dom_col` is the chosen node's domain per term [T].  Row r gains its
    weight at every node sharing the chosen node's domain
    (dom_by_term[r] == dom_col[r]); pad slots add 0 at row 0."""
    placed = choice >= 0
    zero = torch.zeros((), dtype=cnt_node.dtype, device=cnt_node.device)
    w = torch.where((match_terms >= 0) & placed, match_vals, zero)
    tids = torch.clamp_min(match_terms, 0).to(torch.int64)
    same = dom_by_term[tids] == dom_col[tids][:, None]  # [M, N]
    cnt_node = cnt_node.index_add(0, tids, w[:, None] * same)
    keyed = dom_col[tids] < n_domains
    total_t = total_t.index_add(0, tids, w * keyed)
    valid2 = (anti_terms >= 0) & placed
    tids2 = torch.clamp_min(anti_terms, 0).to(torch.int64)
    w2 = valid2.to(anti_node.dtype)
    same2 = dom_by_term[tids2] == dom_col[tids2][:, None]  # [A2, N]
    anti_node = anti_node.index_add(0, tids2, w2[:, None] * same2)
    return cnt_node, anti_node, total_t
