"""Named sub-phase scopes — the kernel-interior attribution vocabulary (the
port of the JAX package's ``ops/scopes.py``).

``SUBPHASES`` is the JAX tuple, the same names in the same order.
``subphase(name)`` is ``torch.profiler.record_function(name)``: a range the
profiler records on the host thread around the region (and an NVTX range
under ``torch.autograd.profiler.emit_nvtx``); no NVTX call is made
directly, so it runs on the CPU build too.  bench/profiling.py charges each
CUDA kernel of a ``device_trace`` to the innermost declared range around
its launch, and each CPU op to the innermost range around it.

The JAX package annotates regions INSIDE its jitted programs.  The port's
kernels are hand-written and fused, and a launch sits under one range only,
so the scopes sit around the calls that replace those regions, on the
plain path and the card alike:

  hoist         K1 static_feasible (filters.static_feasible), K7
                packed_static_rows, K10 score_planes (assign.score_planes
                and over the class view), K3 class_static_hoist, K4
                class_usage_hoist full and patch (incremental.static_hoist /
                usage_hoist / patch_hoist: the JAX :165, :195, :236 scopes),
                K9 unpack_planes and K17 stitch_planes (the encoder's
                unpack and the mesh's stitch, which feed the hoists; the
                JAX package runs those outside any scope)
  score         K2 fit_scan and K11 full_scan (assign._per_pod: the per-pod
                scan, whose normalize and commit per pod the kernels fuse
                into the same launch), K16 ring_match (parallel/ring.py:
                the JAX :64-72 score scope)
  round_loop    K8 chunk_rounds_dense (its hoist, score, speculate, repair
                and commit are one launch), K12 rounds (dense and class
                rows), K6 chunk_rounds (stage B)
  commit_batch  K5 wave_commit (the class-batched commit wave)
  commit        K13 gang_quorum (ops/gang.py: the JAX :140-148 commit)

``normalize``, ``speculate`` and ``repair`` name regions inside the fused
launches; no launch of the port sits under them alone.  K14
explain_counts and K15 preempt_eval run outside every scope, as the JAX
programs they replace (ops/explain.py, ops/preempt.py) do.

``KTPU_NAMED_SCOPES=0`` turns every scope into a no-op; it is read at each
call (the JAX package reads it at each trace) and changes no decision.
"""

from __future__ import annotations

import contextlib
import os

# the declared kernel-interior sub-phases, in canonical report order (the
# JAX package's ops/scopes.py:60-63)
SUBPHASES = (
    "hoist", "score", "normalize", "round_loop", "speculate", "repair",
    "commit", "commit_batch",
)


def scopes_enabled() -> bool:
    """KTPU_NAMED_SCOPES=0 disables sub-phase annotation."""
    return os.environ.get("KTPU_NAMED_SCOPES", "") != "0"


def subphase(name: str):
    """``torch.profiler.record_function(name)`` for a DECLARED sub-phase
    (or a no-op under KTPU_NAMED_SCOPES=0).  An undeclared name raises."""
    if name not in SUBPHASES:
        raise ValueError(f"undeclared kernel sub-phase {name!r} (declared: {SUBPHASES})")
    if not scopes_enabled():
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


def subphase_of(path: str) -> str:
    """The owning sub-phase of a name-stack path — the INNERMOST declared
    scope component ('' when none owns it)."""
    for comp in reversed(path.split("/")):
        if comp in SUBPHASES:
            return comp
    return ""


__all__ = ["SUBPHASES", "scopes_enabled", "subphase", "subphase_of"]
