"""Print the JAX package's reference numbers at the north-star shape.

At heterogeneous(20000, 50000, seed=0) on the CPU:

- the per-pod leg: the JAX package's schedule_batch (its per-pod scan) ->
  the number of scheduled pods and the sha256 of choices[:n_pods] as
  little-endian int32;
- the class-wave legs, each in a fresh process (the JAX package reads its
  routing knobs at import): KTPU_FORCE_CHUNKED=1, DeltaEncoder,
  HoistCache.ensure, schedule_batch_ordinals_routed, once with the class
  waves on and once with KTPU_CLASS_WAVES=0 -> the sweep count, the sha256
  of ordinals[:n_pods] and of choices[:n_pods] (little-endian int32);
- the dense leg, in a fresh process: KTPU_FORCE_CHUNKED=1, DeltaEncoder,
  schedule_batch_ordinals_routed with no class state (the dense chunked
  route, 400 chunks of 128 pods) -> the same three numbers;
- the warm leg, in a fresh process: KTPU_FORCE_CHUNKED=1, bench.py's warm
  waves 2..7 (kubernetes_tpu_torch/bench/workloads.py warm_waves) through
  the JAX PipelinedBatchLoop at depth 0 (run_serial's order) after the
  cold class-wave step -> each wave's wave_digest, the loop's HoistCache
  action per wave and the encoder's stats;
- the wide leg: the port's wide_taints snapshot (80 distinct NoSchedule
  taints) through the JAX package's encoder and per-pod scan -> the
  scheduled count and the choices digest;
- the config3 leg: BASELINE config 3, spread_affinity(5000, 10000, seed=0),
  through the JAX encoder and its per-pod scan -> the scheduled count and
  the choices digest; the config3-rounds leg: the same snapshot through the
  rounds route (KTPU_FORCE_CHUNKED=1) -> sweeps, the ordinals digest and
  the choices digest;
- the all-stages leg: the port's all_stages snapshot through the JAX
  per-pod scan and rounds kernel -> scheduled count, choices digest, sweeps
  and the ordinals digest;
- the config3-inc leg: config 3 with HoistCache class state through the
  rounds route (schedule_scan_rounds(inc=)) -> U1, sweeps and the digests;
  the config3-warm leg: the warm leg's waves 2..7 over config 3 (each wave
  on the rounds route with class state);
- the gang-small and config5 legs: gang(48, 64, 40) and BASELINE config 5
  gang(1000, 64, 2000) through the JAX host fixpoint on class state
  (schedule_with_gangs with ordinals) and the device fixpoint
  (gang_fixpoint_device) -> iterations, placed pods and groups, sweeps,
  the ordinals and choices digests;
- the preempt leg: the JAX package's bench/preempt_bench.py build(20000,
  1000) through the JAX encoder, batch step, diagnose_failed and
  BatchedPreemption in the port's failure_cycle sequence
  (tests/torch_preempt_reference.py) -> the failed count, the diagnosis
  message, the nominated and victim counts and the decisions digest
  (kubernetes_tpu_torch/bench/preempt_bench.py decisions_digest);
- the gang-rounds leg: BASELINE config 3 with its pending pods in
  PodGroups of 64 (kubernetes_tpu_torch/bench/workloads.py grouped)
  through the JAX gang_fixpoint_device, whose batch step is the rounds
  route (KTPU_FORCE_CHUNKED=1) -> G, placed pods and groups, the choices
  and usage digests; the gang-contended leg: the same for each of the
  port's gang_contended batches (rounds with pairwise stages, rounds
  fit-only, per-pod fit-only and per-pod full stage set); the gang-pinned
  leg: the same batches pinned to a pool of config 3's 5000 nodes (the
  port's workloads.gang_pinned);
- the sidecar-north-star and sidecar-config5 legs: the JAX sidecar engine
  (runtime/sidecar.py _Engine.run_session, no wire) on the north star
  (wave 1 the whole pending set pregrouped, then bench.py's wave 2 with
  wave 1's placements bound by clone_pod) and on config 5 (one gang wave:
  the device fixpoint), through the port's workloads.session_waves ->
  per wave the scheduled count and the verdicts digest;
- the explain leg: the north star's class reps (every class of the
  DeltaEncoder encode) through the JAX explain_classes at the dense step's
  post-step usage -> F and the sha256 of the int64 counts;
- the perpod-small leg: cycles of the first 8 pending pods of the north
  star and of config 3 on their clusters (P = 8: the per-pod scan) -> the
  sha256 of each one's choices;
- the config4s leg: BASELINE Config4S, heterogeneous_storage(20000, 20000,
  seed=0) (volumes resolved by the JAX encoder), through the dense chunked
  route and then the class-wave route (HoistCache.ensure) under
  KTPU_FORCE_CHUNKED=1 -> P, N, R, U1, the scheduled count, and each
  route's sweeps, ordinals digest and choices digest; the config4s-warm
  leg: the warm leg's waves 2..7 at depth 0 over the storage-carrying
  snapshots (kubernetes_tpu_torch/bench/workloads.py StorageWaves: one PVC
  replaced from wave 5 on) -> each wave's digest, the HoistCache actions
  and the encoder's stats;
- the dra-small leg: the port's dra_small snapshot (device claims through
  ResourceSlices and two overlapping DeviceClasses, a ReadWriteOncePod
  claim shared by three pods) through the JAX encoder and per-pod scan ->
  the resources, the scheduled count and the choices digest;
- the scheduler-config4 and scheduler-config5 legs: BASELINE Config4
  (heterogeneous(20000, 20000, seed=0)) and Config5 (gang(1000, 64, 2000,
  seed=0)) through the JAX Scheduler, its bench/harness.py _setup_cluster
  (snap, "tpu") + run_until_idle -> the Scheduled and FailedScheduling
  counts, the batch count and kubernetes_tpu_torch/bench/harness.py's
  bindings digest; the scheduler-preempt leg: the JAX preemption bench's
  build(20000, 1000) store, one Scheduler.schedule_batch() cycle under
  KTPU_EXPLAIN=1 -> harness.failure_outcome (evictions, nominations,
  FailedScheduling messages) and its digest; the scheduler-two-profiles
  leg: Config4's generator at heterogeneous(2000, 2000, seed=0), its pods
  split between two profiles (bench/workloads.py two_profile_split),
  GangScheduling off, through the JAX Scheduler's run_until_idle traced ->
  the counts, the batch count, the binds the commit overlap published
  (harness.overlapped_binds) and the bindings digest; the
  scheduler-config1, -config2 and -config3 legs: BASELINE Config1
  (basic(100, 100, seed=0)), Config2 (basic(1000, 5000, seed=0)) and
  Config3 (spread_affinity(5000, 10000, seed=0)) through the JAX
  Scheduler in mode="native" (_setup_cluster(snap, "native") +
  run_until_idle; the C++ engine, seconds on the CPU) -> the counts, the
  batch count and the bindings digest.

kubernetes_tpu_torch/bench/workloads.py keeps these numbers and
chip_smoke.py holds the port's routes on the card against them.  The
dense leg takes minutes on the CPU (one dense step is tens of seconds
there), the whole script about ten minutes and a few GB:

    JAX_PLATFORMS=cpu python tests/torch_north_star_digest.py [LEG ...]

(LEG: waves, waves-off, dense, warm, wide, config3, config3-rounds,
all-stages, config3-inc, config3-warm, gang-small, config5, gang-rounds,
gang-contended, gang-pinned, sidecar-north-star, sidecar-config5, preempt, explain,
perpod-small, config4s, config4s-warm, dra-small, scheduler-config4,
scheduler-config5, scheduler-preempt, scheduler-two-profiles,
scheduler-config1, scheduler-config2 or scheduler-config3 runs only
those legs.  The warm leg alone on a smaller heterogeneous(N_NODES, N_PODS), as
tests/test_torch_pipeline.py runs it: KTPU_FORCE_CHUNKED=1 python
tests/torch_north_star_digest.py --leg warm N_NODES N_PODS; the config-3
warm leg on spread_affinity(N_NODES, N_PODS) as tests/test_torch_rounds_inc.py
runs it: --leg config3-warm N_NODES N_PODS; any gang(G, S, N): --leg gang G
S N; any preempt build: --leg preempt N_NODES N_PRE; Config4S at any
size, as tests/test_torch_volumes.py runs it: --leg config4s N_NODES
N_PODS, --leg config4s-warm N_NODES N_PODS; the Scheduler's at any size,
as tests/test_torch_scheduler.py runs them: --leg scheduler-config4 N_NODES
N_PODS, --leg scheduler-config5 GROUPS SIZE N_NODES, --leg
scheduler-preempt N_NODES N_PRE, --leg scheduler-two-profiles N_NODES
N_PODS, --leg scheduler-config1 / -config2 / -config3 N_NODES N_PODS.)
"""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from __graft_entry__ import force_cpu_platform  # noqa: E402

force_cpu_platform(1)


def _sha(a) -> str:
    return hashlib.sha256(np.asarray(a).astype("<i4").tobytes()).hexdigest()


def per_pod_leg() -> None:
    from kubernetes_tpu.api.snapshot import encode_snapshot
    from kubernetes_tpu.bench.workloads import heterogeneous
    from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG, infer_score_config, schedule_batch

    arr, meta = encode_snapshot(heterogeneous(20000, 50000, seed=0))
    choices, _ = schedule_batch(arr, infer_score_config(arr, DEFAULT_SCORE_CONFIG))
    c = np.asarray(choices)[: meta.n_pods]
    print("per-pod: scheduled", int((c >= 0).sum()), "sha256", _sha(c), flush=True)


def perpod_small_leg() -> None:
    """A cycle of 8 pending pods (the first 8 of the north star's and of
    config 3's, each on its cluster's nodes and bound pods): the JAX
    package's schedule_batch (P = 8: its per-pod scan on every route) ->
    the sha256 of each one's choices."""
    import dataclasses

    from kubernetes_tpu.api.snapshot import encode_snapshot
    from kubernetes_tpu.bench.workloads import heterogeneous, spread_affinity
    from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG, infer_score_config, schedule_batch

    for tag, snap in (("north star", heterogeneous(20000, 50000, seed=0)),
                      ("config 3", spread_affinity(5000, 10000, seed=0))):
        arr, meta = encode_snapshot(dataclasses.replace(snap, pending_pods=snap.pending_pods[:8]))
        choices, _ = schedule_batch(arr, infer_score_config(arr, DEFAULT_SCORE_CONFIG))
        c = np.asarray(choices)[: meta.n_pods]
        print(f"perpod-small {tag}: P {arr.P} N {arr.N} choices {c.tolist()} sha256 {_sha(c)}", flush=True)


def wave_leg(name: str) -> None:
    from kubernetes_tpu.api.delta import DeltaEncoder
    from kubernetes_tpu.bench.workloads import heterogeneous
    from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG, infer_score_config
    from kubernetes_tpu.ops.assign import TRACE_COUNTS, schedule_batch_ordinals_routed
    from kubernetes_tpu.ops.incremental import HoistCache

    arr, meta = DeltaEncoder().encode(heterogeneous(20000, 50000, seed=0))
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    inc = HoistCache().ensure(arr, meta, cfg)
    choices, _, ords, sweeps = schedule_batch_ordinals_routed(arr, cfg, donate=False, inc=inc)
    n = meta.n_pods
    c = np.asarray(choices)[:n]
    print(f"{name}: classes {meta.n_classes} scheduled {int((c >= 0).sum())} sweeps {int(sweeps)} "
          f"ordinals sha256 {_sha(np.asarray(ords)[:n])} choices sha256 {_sha(c)} "
          f"route {dict((k, v) for k, v in TRACE_COUNTS.items() if v)}", flush=True)


def dense_leg() -> None:
    from kubernetes_tpu.api.delta import DeltaEncoder
    from kubernetes_tpu.bench.workloads import heterogeneous
    from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG, infer_score_config
    from kubernetes_tpu.ops.assign import TRACE_COUNTS, schedule_batch_ordinals_routed

    arr, meta = DeltaEncoder().encode(heterogeneous(20000, 50000, seed=0))
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    choices, _, ords, sweeps = schedule_batch_ordinals_routed(arr, cfg, donate=False)
    n = meta.n_pods
    c = np.asarray(choices)[:n]
    print(f"dense: scheduled {int((c >= 0).sum())} sweeps {int(sweeps)} ordinals sha256 "
          f"{_sha(np.asarray(ords)[:n])} choices sha256 {_sha(c)} "
          f"route {dict((k, v) for k, v in TRACE_COUNTS.items() if v)}", flush=True)


def warm_leg(n_nodes: int = 20000, n_pods: int = 50000, workload: str = "heterogeneous") -> None:
    """bench.py's warm waves 2..7 through the JAX PipelinedBatchLoop at depth
    0 after the cold step with class state, on `workload` (heterogeneous:
    the north star; spread_affinity: config 3, where the rounds route takes
    the class state; heterogeneous_storage: Config4S, each wave carrying the
    storage state, one PVC replaced from wave 5 on) -> each wave's digest
    and the HoistCache actions."""
    from kubernetes_tpu.api.delta import DeltaEncoder
    from kubernetes_tpu.api.snapshot import Snapshot
    from kubernetes_tpu.bench import workloads
    from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG, infer_score_config
    from kubernetes_tpu.ops.assign import TRACE_COUNTS, schedule_batch_routed
    from kubernetes_tpu.ops.incremental import HoistCache
    from kubernetes_tpu.parallel.pipeline import PipelinedBatchLoop
    from kubernetes_tpu_torch.bench.workloads import StorageWaves, verdicts_of, warm_waves, wave_digest

    name = {"heterogeneous": "warm", "spread_affinity": "config3-warm",
            "heterogeneous_storage": "config4s-warm"}[workload]
    snap = getattr(workloads, workload)(n_nodes, n_pods, seed=0)
    enc = DeltaEncoder()
    arr, meta = enc.encode(snap)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    inc = HoistCache().ensure(arr, meta, cfg)
    choices = np.asarray(schedule_batch_routed(arr, cfg, donate=False, inc=inc)[0])
    print(f"{name}: wave 1 choices sha256 {_sha(choices[: meta.n_pods])}", flush=True)
    loop = PipelinedBatchLoop(encoder=enc, donate=False, depth=0, memwatch=False)
    snapshot_cls = StorageWaves(snap, Snapshot) if workload == "heterogeneous_storage" else Snapshot
    waves, fetched, *_ = warm_waves(snap, verdicts_of(choices, meta), loop.submit, loop.drain, snapshot_cls)
    names = [nd.name for nd in snap.nodes]
    digests = {w: wave_digest(waves[w], fetched[w], names) for w in sorted(fetched) if w >= 2}
    sched = {w: sum(1 for v in fetched[w].values() if v) for w in sorted(digests)}
    print(f"{name}: digests {digests}", flush=True)
    print(f"{name}: scheduled {sched}", flush=True)
    print(f"{name}: hoist actions {[h['action'] for h in loop.hoist.history]}", flush=True)
    print(f"{name}: encoder stats {enc.stats}", flush=True)
    print(f"{name}: route {dict((k, v) for k, v in TRACE_COUNTS.items() if v)}", flush=True)
    print(f"{name}-json: " + json.dumps({"verdicts": {str(w): fetched[w] for w in sorted(digests)},
                                         "actions": [h["action"] for h in loop.hoist.history],
                                         "stats": enc.stats}), flush=True)


def wide_leg() -> None:
    """kubernetes_tpu_torch/bench/workloads.py wide_taints(2000, 5000): the
    JAX package's encoder and schedule_batch (its per-pod scan)."""
    from kubernetes_tpu.api.delta import DeltaEncoder
    from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG, infer_score_config, schedule_batch
    from kubernetes_tpu_torch.bench.workloads import WIDE_TAINTS, wide_taints

    arr, meta = DeltaEncoder().encode(wide_taints(**WIDE_TAINTS))
    choices, _ = schedule_batch(arr, infer_score_config(arr, DEFAULT_SCORE_CONFIG))
    c = np.asarray(choices)[: meta.n_pods]
    print(f"wide: taints {arr.node_taint_ns.shape[1]} scheduled {int((c >= 0).sum())} sha256 {_sha(c)}",
          flush=True)


def config3_leg() -> None:
    """BASELINE config 3, spread_affinity(5000, 10000, seed=0): the JAX
    package's encoder and its per-pod scan (schedule_batch with
    KTPU_FORCE_CHUNKED=0) -> the scheduled count and the choices digest."""
    from kubernetes_tpu.api.delta import DeltaEncoder
    from kubernetes_tpu.bench.workloads import spread_affinity
    from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG, infer_score_config, schedule_batch
    from kubernetes_tpu.ops.assign import TRACE_COUNTS

    arr, meta = DeltaEncoder().encode(spread_affinity(5000, 10000, seed=0))
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    choices, _ = schedule_batch(arr, cfg)
    c = np.asarray(choices)[: meta.n_pods]
    print(f"config3: P {arr.P} N {arr.N} T {arr.term_counts0.shape[0]} D {arr.term_counts0.shape[1] - 1} "
          f"scheduled {int((c >= 0).sum())} sha256 {_sha(c)} "
          f"route {dict((k, v) for k, v in TRACE_COUNTS.items() if v)}", flush=True)


def config3_rounds_leg() -> None:
    """Config 3 through the JAX package's rounds route (KTPU_FORCE_CHUNKED=1,
    no class state: schedule_scan_rounds, dense, chunks of 16) -> the sweep
    count and the ordinals and choices digests."""
    from kubernetes_tpu.api.delta import DeltaEncoder
    from kubernetes_tpu.bench.workloads import spread_affinity
    from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG, infer_score_config
    from kubernetes_tpu.ops.assign import TRACE_COUNTS, schedule_batch_ordinals_routed

    arr, meta = DeltaEncoder().encode(spread_affinity(5000, 10000, seed=0))
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    choices, _, ords, sweeps = schedule_batch_ordinals_routed(arr, cfg, donate=False)
    n = meta.n_pods
    c = np.asarray(choices)[:n]
    print(f"config3-rounds: scheduled {int((c >= 0).sum())} sweeps {int(sweeps)} ordinals sha256 "
          f"{_sha(np.asarray(ords)[:n])} choices sha256 {_sha(c)} "
          f"route {dict((k, v) for k, v in TRACE_COUNTS.items() if v)}", flush=True)


def all_stages_leg() -> None:
    """The port's all_stages snapshot (every optional stage on): the JAX
    package's per-pod scan and, in the same process, its rounds kernel
    (schedule_scan_rounds with ordinals) -> scheduled count, choices digest,
    sweeps and ordinals digest."""
    import jax

    from kubernetes_tpu.api.delta import DeltaEncoder
    from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG, infer_score_config
    from kubernetes_tpu.ops.assign import schedule_scan, schedule_scan_rounds
    from kubernetes_tpu_torch.bench.workloads import all_stages

    arr, meta = DeltaEncoder().encode(all_stages())
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    n = meta.n_pods
    c = np.asarray(jax.jit(schedule_scan, static_argnames=("cfg",))(arr, cfg)[0])[:n]
    rc, _, ords, sweeps = jax.jit(schedule_scan_rounds, static_argnames=("cfg", "with_ordinals"))(
        arr, cfg, with_ordinals=True)
    assert np.array_equal(np.asarray(rc)[:n], c)
    print(f"all-stages: P {arr.P} N {arr.N} cfg {cfg} scheduled {int((c >= 0).sum())} sha256 {_sha(c)} "
          f"sweeps {int(sweeps)} ordinals sha256 {_sha(np.asarray(ords)[:n])}", flush=True)


def config3_inc_leg() -> None:
    """Config 3 through the JAX package's rounds route with class state
    (KTPU_FORCE_CHUNKED=1, HoistCache.ensure: schedule_scan_rounds(inc=))
    -> the sweep count, the ordinals and choices digests and the route."""
    from kubernetes_tpu.api.delta import DeltaEncoder
    from kubernetes_tpu.bench.workloads import spread_affinity
    from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG, infer_score_config
    from kubernetes_tpu.ops.assign import TRACE_COUNTS, schedule_batch_ordinals_routed
    from kubernetes_tpu.ops.incremental import HoistCache

    arr, meta = DeltaEncoder().encode(spread_affinity(5000, 10000, seed=0))
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    inc = HoistCache().ensure(arr, meta, cfg)
    choices, _, ords, sweeps = schedule_batch_ordinals_routed(arr, cfg, donate=False, inc=inc)
    n = meta.n_pods
    c = np.asarray(choices)[:n]
    print(f"config3-inc: classes {meta.n_classes} U1 {inc.req_u.shape[0]} scheduled {int((c >= 0).sum())} "
          f"sweeps {int(sweeps)} ordinals sha256 {_sha(np.asarray(ords)[:n])} choices sha256 {_sha(c)} "
          f"route {dict((k, v) for k, v in TRACE_COUNTS.items() if v)}", flush=True)


def gang_leg(n_groups: int, group_size: int, n_nodes: int, name: str = "gang") -> None:
    """gang(n_groups, group_size, n_nodes, seed=0) (BASELINE config 5 at
    1000 x 64 on 2000 nodes) through the JAX package's host fixpoint
    (KTPU_FORCE_CHUNKED=1, DeltaEncoder, HoistCache class state,
    schedule_with_gangs with ordinals) and its device fixpoint
    (gang_fixpoint_device) -> iterations, placed pods and groups, sweeps,
    the ordinals and choices digests."""
    import kubernetes_tpu.ops.assign as jassign
    from kubernetes_tpu.api.delta import DeltaEncoder
    from kubernetes_tpu.bench.workloads import gang
    from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG, infer_score_config
    from kubernetes_tpu.ops.gang import gang_fixpoint_device, schedule_with_gangs
    from kubernetes_tpu.ops.incremental import HoistCache

    arr, meta = DeltaEncoder().encode(gang(n_groups, group_size, n_nodes, seed=0))
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    inc = HoistCache().ensure(arr, meta, cfg)
    calls = [0]
    routed = jassign.schedule_batch_ordinals_routed

    def counted(*a, **k):
        calls[0] += 1
        return routed(*a, **k)

    jassign.schedule_batch_ordinals_routed = counted
    choices, _, ords, sweeps = schedule_with_gangs(arr, cfg, with_ordinals=True, inc=inc)
    jassign.schedule_batch_ordinals_routed = routed
    n = meta.n_pods
    c = np.asarray(choices)[:n]
    pg = np.asarray(arr.pod_group)
    gm = np.asarray(arr.group_min)
    placed = np.bincount(pg[:n][c >= 0], minlength=gm.shape[0])
    dc = np.asarray(gang_fixpoint_device(arr, cfg)[0])[:n]
    print(f"{name}: P {arr.P} N {arr.N} R {arr.R} G {gm.shape[0]} U1 {inc.req_u.shape[0]} "
          f"fit-only {not (cfg.enable_pairwise or cfg.enable_taint_score or cfg.enable_node_pref)} "
          f"iterations {calls[0]} scheduled {int((c >= 0).sum())} groups {int((placed >= gm).sum())} "
          f"sweeps {int(sweeps)} ordinals sha256 {_sha(np.asarray(ords)[:n])} choices sha256 {_sha(c)} "
          f"device choices sha256 {_sha(dc)} device==host {bool(np.array_equal(dc, c))}", flush=True)


def _gang_device(name: str, snap) -> None:
    from kubernetes_tpu.api.delta import DeltaEncoder
    from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG, infer_score_config
    from kubernetes_tpu.ops.gang import gang_fixpoint_device

    arr, meta = DeltaEncoder().encode(snap)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    c, u = (np.asarray(x) for x in gang_fixpoint_device(arr, cfg))
    n = meta.n_pods
    pg = np.asarray(arr.pod_group)
    gm = np.asarray(arr.group_min)
    placed = np.bincount(pg[:n][c[:n] >= 0], minlength=gm.shape[0])
    print(f"{name}: P {arr.P} N {arr.N} G {gm.shape[0]} fit-only "
          f"{not (cfg.enable_pairwise or cfg.enable_taint_score or cfg.enable_node_pref)} scheduled "
          f"{int((c[:n] >= 0).sum())} groups {int((placed >= gm).sum())} revoked {int((placed == 0).sum())} "
          f"choices sha256 {_sha(c[:n])} used sha256 {_sha(u)}", flush=True)


def gang_rounds_leg() -> None:
    """Config 3 in PodGroups of 64 through the JAX device fixpoint (the
    rounds route each iteration)."""
    from kubernetes_tpu.api.types import PodGroup
    from kubernetes_tpu.bench.workloads import spread_affinity
    from kubernetes_tpu_torch.bench.workloads import grouped

    _gang_device("gang-rounds", grouped(spread_affinity(5000, 10000, seed=0), 64, PodGroup))


def gang_contended_leg() -> None:
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_gang_reference import CONTENDED, contended

    for name in CONTENDED:
        _gang_device(f"gang-contended {name}", contended(name))


def gang_pinned_leg() -> None:
    """The contended batches pinned to a pool of config 3's 5000 nodes (the
    port's workloads.gang_pinned)."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_gang_reference import AT_SCALE, pinned

    for name in AT_SCALE:
        _gang_device(f"gang-pinned {name}", pinned(name))


def sidecar_leg(name: str) -> None:
    """The JAX sidecar engine's session path on the north star (two waves)
    or config 5 (one gang wave)."""
    from kubernetes_tpu.api.snapshot import SpecInterner
    from kubernetes_tpu.bench import workloads
    from kubernetes_tpu.runtime.convert import clone_pod
    from kubernetes_tpu.runtime.sidecar import _Engine, _Session
    from kubernetes_tpu_torch.bench.workloads import session_waves

    if name == "sidecar-north-star":
        snap, gang, waves = workloads.heterogeneous(20000, 50000, seed=0), False, 2
    else:
        snap, gang, waves = workloads.gang(1000, 64, 2000, seed=0), True, 1
    for w, r in enumerate(session_waves(_Engine(), lambda: _Session(1.0), clone_pod, SpecInterner(), snap, gang,
                                        waves), 1):
        print(f"{name}: wave {w} scheduled {r['scheduled']} verdicts sha256 {r['sha256']}", flush=True)


def preempt_leg(n_nodes: int = 20000, n_pre: int = 1000) -> None:
    """The failure path on the JAX package's preemption bench cluster."""
    from torch_preempt_reference import jax_failure_cycle, jax_snapshot

    from kubernetes_tpu_torch.bench.preempt_bench import decisions_digest

    r = jax_failure_cycle(jax_snapshot(n_nodes, n_pre))
    msgs = sorted(set(r["messages"].values()))
    print(f"preempt: failed {len(r['failed'])} messages {json.dumps(msgs)} nominated {len(r['nominated'])} "
          f"victims {sum(len(v) for _, _, v in r['decisions'])} waves {r['wave_hits']} single {r['single_hits']} "
          f"decisions sha256 {decisions_digest(r['decisions'])}", flush=True)


def explain_leg() -> None:
    """The north star's class reps through explain_classes at the dense
    step's post-step usage (every class diagnosed: the widest call)."""
    from kubernetes_tpu.api.delta import DeltaEncoder, class_groups
    from kubernetes_tpu.bench.workloads import heterogeneous
    from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG, infer_score_config
    from kubernetes_tpu.ops.assign import schedule_batch_ordinals_routed
    from kubernetes_tpu.ops.explain import explain_classes

    arr, meta = DeltaEncoder().encode(heterogeneous(20000, 50000, seed=0))
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    _, used, _, _ = schedule_batch_ordinals_routed(arr, cfg, donate=False)
    reps, _ = class_groups(meta, range(meta.n_pods))
    counts = explain_classes(arr, reps, np.asarray(used))
    print(f"explain: F {reps.size} used sha256 {_sha(np.asarray(used))} counts sha256 "
          f"{hashlib.sha256(counts.astype('<i8').tobytes()).hexdigest()} row sums {sorted(set(counts.sum(1).tolist()))}",
          flush=True)


def config4s_leg(n_nodes: int = 20000, n_pods: int = 20000) -> None:
    """Config4S through the JAX encoder (volumes resolved), the dense chunked
    route, then the class-wave route on HoistCache class state."""
    import time

    from kubernetes_tpu.api.delta import DeltaEncoder
    from kubernetes_tpu.bench.workloads import heterogeneous_storage
    from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG, infer_score_config
    from kubernetes_tpu.ops.assign import TRACE_COUNTS, schedule_batch_ordinals_routed
    from kubernetes_tpu.ops.incremental import HoistCache

    t0 = time.perf_counter()
    arr, meta = DeltaEncoder().encode(heterogeneous_storage(n_nodes, n_pods, seed=0))
    print(f"config4s: encode {time.perf_counter() - t0:.2f} s, P {arr.P} N {arr.N} R {arr.R} "
          f"resources {list(meta.resources)} classes {meta.n_classes}", flush=True)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    n = meta.n_pods
    choices, _, ords, sweeps = schedule_batch_ordinals_routed(arr, cfg, donate=False)
    c = np.asarray(choices)[:n]
    print(f"config4s dense: scheduled {int((c >= 0).sum())} sweeps {int(sweeps)} ordinals sha256 "
          f"{_sha(np.asarray(ords)[:n])} choices sha256 {_sha(c)} "
          f"route {dict((k, v) for k, v in TRACE_COUNTS.items() if v)}", flush=True)
    inc = HoistCache().ensure(arr, meta, cfg)
    choices, _, ords, sweeps = schedule_batch_ordinals_routed(arr, cfg, donate=False, inc=inc)
    c = np.asarray(choices)[:n]
    print(f"config4s waves: U1 {inc.req_u.shape[0]} scheduled {int((c >= 0).sum())} sweeps {int(sweeps)} "
          f"ordinals sha256 {_sha(np.asarray(ords)[:n])} choices sha256 {_sha(c)} "
          f"route {dict((k, v) for k, v in TRACE_COUNTS.items() if v)}", flush=True)


def dra_small_leg() -> None:
    """The port's dra_small snapshot through the JAX encoder (the JAX
    resolution reads the port's objects as they are) and its per-pod scan."""
    from kubernetes_tpu.api.delta import DeltaEncoder
    from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG, infer_score_config, schedule_batch
    from kubernetes_tpu_torch.bench.workloads import dra_small

    arr, meta = DeltaEncoder().encode(dra_small())
    choices, _ = schedule_batch(arr, infer_score_config(arr, DEFAULT_SCORE_CONFIG))
    c = np.asarray(choices)[: meta.n_pods]
    print(f"dra-small: P {arr.P} N {arr.N} resources {list(meta.resources)} scheduled {int((c >= 0).sum())} "
          f"sha256 {_sha(c)}", flush=True)


def scheduler_leg(name: str, *size: int) -> None:
    """A BASELINE config through the JAX Scheduler's run_until_idle (the JAX
    harness's _setup_cluster), or the preemption bench's one failing
    cycle."""
    import time

    from kubernetes_tpu.bench import workloads
    from kubernetes_tpu.bench.harness import _setup_cluster
    from kubernetes_tpu_torch.bench.harness import bindings_digest, failure_outcome

    t0 = time.perf_counter()
    if name == "scheduler-preempt":
        from kubernetes_tpu.bench.preempt_bench import build
        from kubernetes_tpu.scheduler import Scheduler, SchedulerConfiguration
        from kubernetes_tpu.scheduler.tracing import TraceCollector

        store = build(*(size or (20000, 1000)))
        sched = Scheduler(store, SchedulerConfiguration(mode="tpu"), collector=TraceCollector(enabled=False))
        before = [p.name for p in store.pods.values()]
        sched.schedule_batch()
        out = failure_outcome(before, sched)
        print(f"{name}: {time.perf_counter() - t0:.1f} s, scheduled {len(sched.events.by_reason('Scheduled'))} "
              f"evicted {len(out['evicted'])} nominated {len(out['nominated'])} messages "
              f"{json.dumps(out['messages'])} outcome sha256 {out['sha256']}", flush=True)
        return
    if name == "scheduler-two-profiles":
        from kubernetes_tpu.scheduler import ClusterStore, Scheduler, SchedulerConfiguration
        from kubernetes_tpu.scheduler.config import Profile
        from kubernetes_tpu.scheduler.tracing import TraceCollector
        from kubernetes_tpu_torch.bench.harness import overlapped_binds
        from kubernetes_tpu_torch.bench.workloads import SECOND_PROFILE, two_profile_split

        snap = two_profile_split(workloads.heterogeneous(*(size or (2000, 2000)), seed=0))
        store = ClusterStore()
        for nd in snap.nodes:
            store.add_node(nd)
        col = TraceCollector(capacity=1 << 19, enabled=True)
        sched = Scheduler(store, SchedulerConfiguration(mode="tpu", feature_gates=(("GangScheduling", False),),
                                                        profiles=(Profile(), Profile(scheduler_name=SECOND_PROFILE))),
                          collector=col)
        for p in snap.pending_pods:
            store.add_pod(p)
        sched.run_until_idle()
        hist = sched.metrics.hists.get("batch_scheduling_duration_seconds")
        print(f"{name}: {time.perf_counter() - t0:.1f} s, scheduled {len(sched.events.by_reason('Scheduled'))} "
              f"failed {len(sched.events.by_reason('FailedScheduling'))} batches {hist.count if hist else 0} "
              f"overlapped {overlapped_binds(col)} bindings sha256 {bindings_digest(sched.store.pods.values())}",
              flush=True)
        return
    mode = "tpu"
    if name == "scheduler-config4":
        snap = workloads.heterogeneous(*(size or (20000, 20000)), seed=0)
    elif name == "scheduler-config5":
        snap = workloads.gang(*(size or (1000, 64, 2000)), seed=0)
    else:  # BASELINE configs 1-3 in native mode (the C++ engine, fast on the CPU)
        mode = "native"
        gen, default = {"scheduler-config1": (workloads.basic, (100, 100)),
                        "scheduler-config2": (workloads.basic, (1000, 5000)),
                        "scheduler-config3": (workloads.spread_affinity, (5000, 10000))}[name]
        snap = gen(*(size or default), seed=0)
    sched = _setup_cluster(snap, mode)
    sched.run_until_idle()
    hist = sched.metrics.hists.get("batch_scheduling_duration_seconds")
    print(f"{name}: {time.perf_counter() - t0:.1f} s, scheduled {len(sched.events.by_reason('Scheduled'))} "
          f"failed {len(sched.events.by_reason('FailedScheduling'))} batches {hist.count if hist else 0} "
          f"bindings sha256 {bindings_digest(sched.store.pods.values())}", flush=True)


LEGS = {"dense": dense_leg, "warm": warm_leg, "wide": wide_leg, "config3": config3_leg,
        "config3-rounds": config3_rounds_leg, "all-stages": all_stages_leg, "config3-inc": config3_inc_leg,
        "config3-warm": lambda: warm_leg(5000, 10000, "spread_affinity"),
        "gang-small": lambda: gang_leg(48, 64, 40, "gang-small"),
        "config5": lambda: gang_leg(1000, 64, 2000, "config5"), "preempt": preempt_leg, "explain": explain_leg,
        "gang-rounds": gang_rounds_leg, "gang-contended": gang_contended_leg, "gang-pinned": gang_pinned_leg,
        "sidecar-north-star": lambda: sidecar_leg("sidecar-north-star"),
        "sidecar-config5": lambda: sidecar_leg("sidecar-config5"), "perpod-small": perpod_small_leg,
        "config4s": config4s_leg, "config4s-warm": lambda: warm_leg(20000, 20000, "heterogeneous_storage"),
        "dra-small": dra_small_leg, "scheduler-config4": lambda: scheduler_leg("scheduler-config4"),
        "scheduler-config1": lambda: scheduler_leg("scheduler-config1"),
        "scheduler-config2": lambda: scheduler_leg("scheduler-config2"),
        "scheduler-config3": lambda: scheduler_leg("scheduler-config3"),
        "scheduler-config5": lambda: scheduler_leg("scheduler-config5"),
        "scheduler-preempt": lambda: scheduler_leg("scheduler-preempt"),
        "scheduler-two-profiles": lambda: scheduler_leg("scheduler-two-profiles")}


def main() -> None:
    if len(sys.argv) >= 3 and sys.argv[1] == "--leg":
        if sys.argv[2] == "warm" and len(sys.argv) == 5:  # a smaller warm stream (the CPU tests')
            warm_leg(int(sys.argv[3]), int(sys.argv[4]))
        elif sys.argv[2] == "config3-warm" and len(sys.argv) == 5:
            warm_leg(int(sys.argv[3]), int(sys.argv[4]), "spread_affinity")
        elif sys.argv[2] == "gang" and len(sys.argv) == 6:  # any gang(G, S, N)
            gang_leg(*(int(x) for x in sys.argv[3:6]))
        elif sys.argv[2] == "config4s" and len(sys.argv) == 5:
            config4s_leg(int(sys.argv[3]), int(sys.argv[4]))
        elif sys.argv[2] == "config4s-warm" and len(sys.argv) == 5:
            warm_leg(int(sys.argv[3]), int(sys.argv[4]), "heterogeneous_storage")
        elif sys.argv[2].startswith("scheduler-") and len(sys.argv) > 3:
            scheduler_leg(sys.argv[2], *(int(x) for x in sys.argv[3:]))
        elif sys.argv[2] == "preempt" and len(sys.argv) == 5:
            preempt_leg(int(sys.argv[3]), int(sys.argv[4]))
        else:
            LEGS.get(sys.argv[2], lambda: wave_leg(sys.argv[2]))()
        return
    only = sys.argv[1:]
    if not only:
        per_pod_leg()
    runs = [("waves", {"KTPU_CLASS_WAVES": "1"}), ("waves-off", {"KTPU_CLASS_WAVES": "0"}),
            ("dense", {}), ("warm", {"KTPU_MEMWATCH": "0"}), ("wide", {"KTPU_FORCE_CHUNKED": "0"}),
            ("config3", {"KTPU_FORCE_CHUNKED": "0"}), ("config3-rounds", {}),
            ("all-stages", {"KTPU_FORCE_CHUNKED": "0"}), ("config3-inc", {}),
            ("config3-warm", {"KTPU_MEMWATCH": "0"}), ("gang-small", {}), ("config5", {}), ("preempt", {}), ("explain", {}),
            ("gang-rounds", {}), ("gang-contended", {}), ("gang-pinned", {}), ("sidecar-north-star", {}), ("sidecar-config5", {}),
            ("perpod-small", {}), ("config4s", {}), ("config4s-warm", {"KTPU_MEMWATCH": "0"}),
            ("dra-small", {"KTPU_FORCE_CHUNKED": "0"}), ("scheduler-config4", {"KTPU_MEMWATCH": "0"}),
            ("scheduler-config5", {"KTPU_MEMWATCH": "0"}),
            ("scheduler-preempt", {"KTPU_MEMWATCH": "0", "KTPU_EXPLAIN": "1"}),
            ("scheduler-two-profiles", {"KTPU_MEMWATCH": "0"}),
            ("scheduler-config1", {"KTPU_MEMWATCH": "0"}), ("scheduler-config2", {"KTPU_MEMWATCH": "0"}),
            ("scheduler-config3", {"KTPU_MEMWATCH": "0"})]
    for name, extra in runs:
        if only and name not in only:
            continue
        env = {**os.environ, "KTPU_FORCE_CHUNKED": "1", **extra}
        subprocess.run([sys.executable, os.path.abspath(__file__), "--leg", name], env=env, check=True)


if __name__ == "__main__":
    main()
