"""kubernetes_tpu_torch — the scheduler's main path in PyTorch, with
hand-written CUDA kernels for an NVIDIA H100 (sm_90a).

The port of the JAX package that sits beside it.  This package imports
torch, numpy and the standard library, never JAX nor the JAX package.  Its
entry points run on the card unless the caller passes device="cpu":

    from kubernetes_tpu_torch.api.snapshot import encode_snapshot, decode_choices
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, infer_score_config, schedule_batch

    arr, meta = encode_snapshot(snap)                  # tensors on the card
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    choices, used = schedule_batch(arr, cfg)          # i32[P], i32[N, R]
    placements = decode_choices(choices, meta)        # {pod: node or None}

The slice ported so far is the per-pod commit scan with the fit-only stage
set (static feasibility + NodeResourcesFit + BalancedAllocation); anything
else raises NotImplementedError (see ROADMAP.md queues A and B).
"""
