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

The 1-D node mesh is ported for the chunked routes (parallel/: the node
axis on S shards held by one process, decisions equal to one device's),
with the ring layer:

    from kubernetes_tpu_torch.parallel import make_mesh
    choices, used = schedule_batch(arr, cfg, mesh=make_mesh(4))  # used on the padded axis

Volumes and resource claims (PVs, PVCs, StorageClasses, attach limits,
ResourceSlices, DeviceClasses) are resolved into node-affinity terms and
extra resources before encoding (api/volumes.py), so the kernels serve
them unchanged.  The sidecar's client is ported too (runtime/client.py:
sessions, bind compression, retries and the failure budget, with chaos/'s
fault sites); it resolves before the wire:

    from kubernetes_tpu_torch.runtime.client import TPUScoreClient
    verdicts = TPUScoreClient("127.0.0.1:50151").schedule(snap)  # uid -> node or None

The Scheduler is ported (scheduler/: the store, queue and cache, the
per-pod plugin cycle with the CPU PostFilter, and the batch cycle that
drains the queue onto the kernels above, with its failure loop;
mode="native" runs that cycle on the host's C++ engine, native/, whose C
spec interner also groups the pods of every encode); users run it, and
bench/harness.py measures it, as:

    from kubernetes_tpu_torch.scheduler import ClusterStore, Scheduler, SchedulerConfiguration
    store = ClusterStore()
    sched = Scheduler(store, SchedulerConfiguration(mode="tpu"))  # device="cpu" for the plain path
    store.add_node(node); store.add_pod(pod)
    sched.run_until_idle()                                     # binds land in the store

Its crash restart is ported too: Scheduler(..., checkpoint_dir=...) (or
KTPU_CHECKPOINT_DIR) arms the checkpoint and the flight recorder, and
scheduler.run_restartable / run_ha_restartable answer a kill with a
restart or a standby's lease takeover; parallel/pipeline.py
run_stream_restartable does the same for a stream of waves.

Not ported (ROADMAP.md queue A): HTTP extenders and the other host-only
modules (A14), the device-memory ledger (A13).
"""
