"""Feasibility (Filter extension point) — the port of the JAX package's
``ops/filters.py``.

The capacity check ``fit_ok`` depends on the running node usage, so the
commit scan (ops/assign.py) evaluates it per pod; everything
capacity-independent is ``static_feasible``, evaluated once for the batch:

  TaintToleration.Filter   -> taints_ok
  NodeAffinity.Filter + spec.nodeSelector -> term_match + node_selection_ok_from
  NodeUnschedulable.Filter (the synthetic unschedulable taint, api/snapshot.py)
  NodeName.Filter          -> nodename_ok

The functions below are the plain PyTorch versions.  ``static_feasible``
dispatches on the tensors' device: on the CPU it runs the plain version, on
CUDA it launches the hand-written kernel (csrc/static_feasible.cu) or raises.
"""

from __future__ import annotations

import torch

from ..api import vocab as v


def term_match(sel_mask: torch.Tensor, sel_kind: torch.Tensor, node_labels: torch.Tensor) -> torch.Tensor:
    """[S, E, L] masks x [N, L] labels -> bool[S, N]: which nodes satisfy each
    interned selector term.  A counting product over the literals, exact in
    f32 (< 2^24 literals)."""
    counts = torch.einsum("sel,nl->sen", sel_mask.to(torch.float32), node_labels.to(torch.float32))
    kind = sel_kind[:, :, None]
    ok = torch.where(
        kind == v.KIND_ANY,
        counts > 0,
        torch.where(kind == v.KIND_NONE, counts == 0, kind == v.KIND_PAD),
    )
    return ok.all(dim=1)


def node_selection_ok_from(tm: torch.Tensor, arr) -> torch.Tensor:
    """bool[P, N] from a term_match matrix: OR over the pod's term ids."""
    ids = torch.clamp_min(arr.pod_terms, 0).long()  # [P, TT]
    per_term = tm[ids] & (arr.pod_terms >= 0)[:, :, None]  # [P, TT, N]
    ones = torch.ones((), dtype=torch.bool, device=tm.device)
    return torch.where(arr.pod_has_sel[:, None], per_term.any(dim=1), ones)


def node_selection_ok(arr) -> torch.Tensor:
    """bool[P, N]: spec.nodeSelector AND required node affinity (ORed terms)."""
    return node_selection_ok_from(term_match(arr.sel_mask, arr.sel_kind, arr.node_labels), arr)


def taints_ok(arr) -> torch.Tensor:
    """bool[P, N]: every hard (NoSchedule/NoExecute) taint on the node is
    tolerated.  Counting product over the taint vocab."""
    intolerable = (~arr.pod_tol_ns).to(torch.float32) @ arr.node_taint_ns.to(torch.float32).T
    return intolerable == 0


def nodename_ok(arr) -> torch.Tensor:
    """bool[P, N]: spec.nodeName pinning (-1 unset, -2 named node missing)."""
    n_idx = torch.arange(arr.N, dtype=torch.int32, device=arr.pod_nodename.device)[None, :]
    pin = arr.pod_nodename[:, None]
    return (pin == -1) | (pin == n_idx)


def static_feasible_plain(arr) -> torch.Tensor:
    """bool[P, N]: all capacity-independent filters, one batched evaluation."""
    return (
        arr.node_valid[None, :]
        & arr.pod_valid[:, None]
        & taints_ok(arr)
        & node_selection_ok(arr)
        & nodename_ok(arr)
    )


def static_feasible_rows(tm: torch.Tensor, node_valid: torch.Tensor, node_taint_ns: torch.Tensor,
                         my_nodes: torch.Tensor, pod_terms: torch.Tensor, pod_has_sel: torch.Tensor,
                         pod_tol_ns: torch.Tensor, pod_nodename: torch.Tensor, pod_valid: torch.Tensor):
    """(sf bool[B, Nl], nodesel bool[B, Nl]) for a pod ROW BLOCK against the
    node ids `my_nodes` (the JAX package's ops/filters.py:92, pod_valid
    included): the dense chunked route packs it per block of rows, so the
    widest dense mask is [B, Nl], never [P, N].  The same tests as
    static_feasible_plain, so the bits are the same."""
    ids = torch.clamp_min(pod_terms, 0).long()
    per_term = tm[ids] & (pod_terms >= 0)[:, :, None]
    ones = torch.ones((), dtype=torch.bool, device=tm.device)
    nodesel = torch.where(pod_has_sel[:, None], per_term.any(dim=1), ones)
    intolerable = (~pod_tol_ns).to(torch.float32) @ node_taint_ns.to(torch.float32).T
    pin = pod_nodename[:, None]
    nn_ok = (pin == -1) | (pin == my_nodes[None, :])
    sf = node_valid[None, :] & pod_valid[:, None] & (intolerable == 0) & nodesel & nn_ok
    return sf, nodesel


def static_feasible(arr) -> torch.Tensor:
    """bool[P, N] on arr's device: the plain version for CPU tensors, the
    static-feasibility kernel for CUDA tensors."""
    if arr.device.type == "cpu":
        return static_feasible_plain(arr)
    from . import kernels

    return kernels.static_feasible(arr)


def fit_ok(pod_req: torch.Tensor, node_used: torch.Tensor, node_alloc: torch.Tensor) -> torch.Tensor:
    """bool[N] for one pod: req == 0 or req <= alloc - used on every resource.
    The subtraction form cannot overflow int32 (alloc, used >= 0); used + req
    could.  Resources the pod does not request never block."""
    req = pod_req[None, :]
    return ((req == 0) | (req <= node_alloc - node_used)).all(dim=1)
