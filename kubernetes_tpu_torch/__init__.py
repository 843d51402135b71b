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

    inc = HoistCache().ensure(arr, meta, cfg)         # ops/incremental.py
    choices, used = schedule_batch(arr, cfg, inc=inc)  # the class-wave route

Every stage the JAX package's ScoreConfig can enable is ported: the
fit-only stage set (static feasibility + NodeResourcesFit +
BalancedAllocation) on the per-pod, dense chunked and class-wave routes,
and the full stage set (PodTopologySpread, InterPodAffinity, NodePorts,
TaintToleration / NodeAffinity / ImageLocality scores) on the per-pod and
rounds routes (the latter in dense and class-state mode), and gangs
(all-or-nothing pod groups) through ops/gang.py's host and device
fixpoints.  The failure half of a cycle is ported too: the unschedulable
diagnosis (ops/explain.py) and batched preemption (ops/preempt.py,
scheduler/preemption.py's BatchedPreemption), driven as the scheduler's
failure loop drives them by bench/preempt_bench.py:

    from kubernetes_tpu_torch.bench.preempt_bench import build, failure_cycle
    r = failure_cycle(build(50, 12), device="cpu")   # diagnosis + nominations

The sidecar's server side is ported too (runtime/sidecar.py: the session
engine over DeltaEncoder.encode_pregrouped, gang waves through the device
fixpoint on every route, and the gRPC TPUScoreServer on the JAX package's
wire):

    python -m kubernetes_tpu_torch.runtime.sidecar --listen 127.0.0.1:50151 [--device cpu]

Volumes and resource claims raise NotImplementedError; the Scheduler
itself, the sidecar's client and the CPU PostFilter are not ported (see
ROADMAP.md queues A and B).
"""
