#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kubernetes_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds every kernel from csrc/ with nvcc (one process per source, all at
once), then drives the port's fit-only routes and bench.py's warm loop at
the north-star shape, heterogeneous(20000, 50000, seed=0) (P=51200,
N=20480, R=5, U1=101), the full stage set on BASELINE config 3 (cold, with
and without class state, and its warm loop) and an all-stages snapshot,
gangs on BASELINE config 5, and the failure path (unschedulable diagnosis,
batched preemption) on the JAX package's preemption bench cluster; the
host libraries of native/ (the C spec interner under every encode, the
C++ engine of the Scheduler's mode="native") are built with them:

  [interner]         the spec interner at the north star's 50000 pending
                     pods: SpecInterner's C path (native/interner.c), cold
                     (a fresh table) and warm (bench.py's next waves,
                     clones that share the field objects), against its
                     Python loop on the same pods: equal reps, inv and
                     rep_keys, both times; the encoders of
                     [north-star-dense], the warm loops, [config3],
                     [config4s] and the Scheduler phases and
                     [config4s-sidecar]'s client are checked to be on the
                     C path;
  [mixed]            static_feasible and fit_scan == their plain versions on
                     a small mixed snapshot, three fit strategies;
  [north-star]       the per-pod route, encode_snapshot -> schedule_batch
                     (chunked=False):
                     50000/50000 scheduled, the JAX package's choices digest,
                     static_feasible == plain over [P, N], fit_scan == plain
                     on the first 8192 pods; fit_scan's time, its cluster
                     width and its floor (no node feasible);
  [mesh-north-star-perpod] the same per-pod route on make_mesh(4) (the
                     node mesh's per-step collectives, parallel/sharded.py):
                     static_feasible once per shard with its base (the
                     pinned node is a global id), then fit_scan in shard
                     mode (one cooperative launch of 4 blocks, one grid
                     barrier a pod): [north-star]'s choices and usage;
                     static_feasible (base) == plain per shard, fit_scan's
                     shard mode == the plain sharded scan on the first 1024
                     pods; both timed, the one-device launch beside;
  [waves-mixed]      the class-wave kernels (class_static_hoist,
                     class_usage_hoist full and column-list, wave_commit,
                     chunk_rounds) == their plain versions on the card, bit
                     for bit, on small snapshots (mixed x 3 strategies, an
                     interference wave that forces fallbacks and epoch
                     refreshes, two-entry lists whose block budget runs out
                     and leaves work to stage B),
                     and the route's choices == the per-pod route's;
  [north-star-waves] HoistCache.ensure -> schedule_batch(inc=...): the same
                     choices digest, the JAX route's sweep count and ordinal
                     digest, every kernel == plain at full size (chunk_rounds
                     as stage B after the wave, by card time beside stage
                     B's byte bound, and on the first 64 chunks with the
                     waves off), then the route with
                     class_waves=False (chunk_rounds carries all 1600 chunks)
                     and a warm cycle that patches the dirty columns;
  [north-star-dense] a cold DeltaEncoder encode, then the dense chunked
                     route (no class state: the card's default),
                     packed_static_rows + chunk_rounds_dense: 50000/50000,
                     the choices digest, the JAX dense route's sweep count
                     and ordinal digest; packed_static_rows == plain over
                     [P, W], chunk_rounds_dense == plain on the first chunks;
  [warm-loop]        bench.py's warm waves 2..7 through PipelinedBatchLoop at
                     depth 1, then again at depth 0: per-wave choice digests
                     equal across the depths and to the JAX loop's, its
                     HoistCache actions, enc.stats["delta"] >= 3, delta_s,
                     end_to_end_s (median of the steady walls) and
                     overlap_fraction as bench.py computes them;
  [mesh-north-star]  the node mesh (parallel/mesh.py) at the north star: a
                     DeltaEncoder on make_mesh(4) ("4 shards on 1 card": every
                     node-axis field resident per shard), the cold dense
                     step (packed_static_rows once per shard with its base,
                     the tiled all_gather, stitch_planes, chunk_rounds_dense)
                     and the class-wave step (HoistCache(mesh=):
                     class_static_hoist and class_usage_hoist once per
                     shard, stitch_planes on both packed planes, then
                     wave_commit and chunk_rounds), each counted on its own:
                     the JAX digests, sweeps and ordinals of the single-device
                     phases and their usage; then both on make_mesh(3): N
                     pads to 20481, nl = 6827, so stitch_planes shifts
                     across block boundaries at full width; stitch_planes ==
                     plain on the class planes and the dense rows (timed),
                     the per-shard K3, K4 and K7 == plain;
  [mesh-warm-loop]   bench.py's warm waves 2..7 through PipelinedBatchLoop
                     (depth 1, mesh=make_mesh(4)): the per-wave digests and
                     HoistCache actions of [warm-loop], every step on the
                     sharded class-wave route; end_to_end_s beside
                     [warm-loop]'s;
  [mesh2d-north-star] the pods x nodes grid, make_mesh(shape=(2, 4)) of
                     cuda:0, through DeltaEncoder(mesh=): pod-axis fields
                     resident per pod row, node-axis fields per node column;
                     the dense step (the entry gather of the pod rows, then
                     the 1-D mesh's launches: packed_static_rows x 4,
                     stitch_planes, chunk_rounds_dense) and the class-wave
                     step (HoistCache(mesh=): class_static_hoist x 4,
                     class_usage_hoist x 4, stitch_planes x 2; wave_commit,
                     chunk_rounds): [north-star-dense] / [north-star-waves]'s
                     choices, usage, ordinals and sweeps; step_s, the entry
                     gather's CUDA-event time and bytes, the peak device
                     memory beside shard_hbm_estimate(pod_shards=2);
  [mesh2d-warm-loop] bench.py's warm waves 2..7 through PipelinedBatchLoop
                     (depth 1, mesh=make_mesh(shape=(2, 4))): [warm-loop]'s
                     digests and HoistCache actions;
  [ring]             parallel/ring.py: ring_match of the north star's
                     sel_mask / sel_kind (terms padded to a multiple of 4)
                     against its node_labels [20480, L] on 4 shards (ring_match
                     launched 4 x 4 times) == the ring on the CPU (the plain
                     hop) == the dense term match; then of BASELINE config
                     3's 80 pairwise terms against its 10000 pod label rows
                     (api/pairwise.py match_inputs; [80, 2, 41] x [10000,
                     41]) on 4 shards == the plain ring == the host match
                     matrix; one hop of each ring == plain, timed (card
                     and host time a call) beside torch.einsum of the
                     counts (K16's row); then
                     all_to_all_pods_to_nodes of a [10240, 6144] f32 plane
                     (config 3's P x N) keeps every value;
  [wide-planes]      a snapshot with 80 distinct NoSchedule taints through
                     DeltaEncoder: its four 80-wide bool fields (the hard and
                     PreferNoSchedule taint and toleration planes) travel
                     packed and unpack_planes (== plain) unpacks them;
                     decisions == the JAX package's; unpack_planes' card
                     and host time a call;
  [config3]          BASELINE config 3, spread_affinity(5000, 10000, seed=0)
                     (P=10240, N=6144, 80 terms, 5003 domains): a cold
                     DeltaEncoder encode, then schedule_batch_ordinals on the
                     rounds route (packed_static_rows with the eligibility
                     plane, then rounds, each launched once): 10000/10000,
                     the JAX choices digest, the JAX rounds route's sweeps
                     (1691) and ordinal digest, step_rounds_s; both K7
                     planes == plain over [P, W], rounds == plain on the
                     first 8 chunks (choices, usage, ordinals, count planes);
  [config3-perpod]   the same arrays with chunked=False: packed_static_rows
                     and full_scan over all pods, the same choices digest,
                     full_scan == plain on the first 512 pods, step_perpod_s;
                     full_scan's time, its cluster width and its floor;
  [perpod-small]     a scheduling cycle of 8 pending pods (the encoder's
                     smallest bucket, so the card's default route is the
                     per-pod one) through schedule_batch on the north
                     star's nodes (fit-only: static_feasible + fit_scan)
                     and on config 3's (packed_static_rows + full_scan):
                     exact launch counts, the JAX choices digest, choices
                     and usage == the plain route on the CPU, the step's
                     wall time;
  [k1-pinned]        static_feasible at a label vocabulary as wide as the
                     cluster: gang_pinned('perpod-fit') (P = 8, N = 6144,
                     L = 5000, a hostname In over a pool of config 3's
                     nodes) as one cycle through schedule_batch (launches
                     exactly K1 + K2, == the CPU route); K1 == plain, its
                     card and host time a call, at most two device
                     operations a call, beside the term match's
                     torch.einsum of the float masks and the bound;
  [config3-inc]      the same arrays with class state: HoistCache.ensure
                     (class_static_hoist with the eligibility words,
                     class_usage_hoist), then the rounds route in class mode
                     (rounds in class-row mode, launched alone; route
                     rounds_inc): 10000/10000, the JAX digests, 1691 sweeps;
                     class_static_hoist == plain on both planes, rounds in
                     class-row mode == plain == dense on the first 8 chunks,
                     timed in turns with the dense mode; step_rounds_inc_s;
  [mesh-config3]     config 3 on make_mesh(4) (nl 1536) and make_mesh(5) (N
                     pads to 6145, nl 1229), each route counted on its own:
                     the rounds route dense (packed_static_rows x S, rounds
                     in shard mode), on class state (HoistCache(mesh=):
                     class_static_hoist x S, class_usage_hoist x S; rounds
                     in shard class-row mode) and the per-pod route
                     (packed_static_rows x S, full_scan in shard mode):
                     the [config3] / [config3-inc] / [config3-perpod]
                     digests, 1691 sweeps and usage; rounds' shard modes ==
                     the plain sharded scan on the first 4 chunks (choices,
                     usage, ordinals, count planes), full_scan's on the
                     first 128 pods; each timed over all pods, rounds'
                     dense and class-row shard modes beside the same
                     call's one-device rounds in the same mode; first, the
                     frac-weights case of
                     tests/torch_rounds_contended_reference.py on
                     make_mesh(2) (non-integer preferred weights beside
                     hardPodAffinityWeight on one term: ROADMAP C4):
                     rounds' shard modes == the plain sharded scan, every
                     count plane as bits;
  [mesh2d-config3]   config 3 on make_mesh(shape=(2, 4)): the rounds route
                     dense (packed_static_rows x 4, rounds in shard mode),
                     on class rows (HoistCache(mesh=): class_static_hoist x
                     4, class_usage_hoist x 4; rounds in shard class-row
                     mode) and the per-pod route (packed_static_rows x 4,
                     full_scan in shard mode), each after the entry gather:
                     [config3] / [config3-inc] / [config3-perpod]'s digests,
                     1691 sweeps and usage;
  [config3-warm]     bench.py's waves 2..7 over config 3 through
                     PipelinedBatchLoop at depth 1 and 0, every step on the
                     rounds route with class state: per-wave digests and
                     HoistCache actions as the JAX loop's, end_to_end_s,
                     delta_s, overlap_fraction;
  [mesh-config3-warm] the same waves through PipelinedBatchLoop(depth=1,
                     mesh=make_mesh(4)): every step the sharded rounds
                     route on class state; [config3-warm]'s digests and
                     actions, end_to_end_s beside its one;
  [all-stages]       all_stages() (every optional stage on): the rounds and
                     the per-pod routes equal the JAX digests (choices,
                     sweeps, ordinals), score_planes == plain on both bf16
                     planes (beside torch.matmul of its node-affinity
                     product), rounds and full_scan == plain; with class
                     state the same results, score_planes over the class
                     view and every class plane == plain;
  [gang-small]       gang(48, 64, 40): the host fixpoint on class state
                     (class-wave route per iteration) and the device
                     fixpoint (K7 + K8 + K13 queued G + 1 times): 13
                     iterations, 36 groups, the JAX digests, ordinals and
                     sweeps; gang_quorum == plain on the first
                     iteration's choices and on them with groups G/2 and
                     G-1 unplaced (a revocation), its card and host time a
                     call on both with the fixpoint's out buffers, and
                     gated; chunk_rounds as the first iteration's stage B
                     == plain, by card time beside its byte bound;
  [config5]          BASELINE config 5, gang(1000, 64, 2000) (P=65536,
                     N=2048, G=1000): both fixpoints as above with the JAX
                     digests, their walls and the device loop's host enqueue
                     time; gang_quorum (card time) beside its plain version,
                     torch.zeros(G + 1).index_add_ of the quorum count (card
                     time) and torch.bincount (back to back);
  [gang-rounds]      config 3 in PodGroups of 64 (workloads.grouped: P=10240,
                     N=6144, G=157) through the device fixpoint on the
                     rounds route (K7 with the eligibility plane + K12 +
                     K13 queued G + 1 times, one read at the end): the JAX
                     choices and usage digests, == the host fixpoint; the
                     wall, the host enqueue of a first and a second
                     fixpoint, a gated iteration's card time;
                     K12's gated mode == plain on the first chunks with
                     `done` clear and writing nothing with it set;
  [mesh-gangs]       schedule_with_gangs(mesh=make_mesh(4)) on [gang-rounds]'s
                     batch (each iteration the sharded rounds route) and on
                     config 5 with HoistCache(mesh=) (the sharded class-wave
                     route): the host fixpoints' digests;
  [gang-contended]   workloads.gang_contended's four batches (the rounds
                     route with pairwise stages and fit-only at P=64, the
                     per-pod route fit-only and full-stage at P=8), each
                     revoking groups, on their own 2-8 nodes and pinned to
                     a pool of config 3's 5000 nodes (workloads.gang_pinned,
                     N=6144): exact launch counts, iterations, the JAX
                     digests, a gated iteration's card time; at N=6144 K1,
                     K2, K11 and K12 in the gated mode == plain, nothing
                     written when gated, timed;
  [sidecar-north-star] runtime/sidecar.py _Engine(device="cuda") with a
                     session built directly (no wire): the north star's
                     pending set pregrouped through run_session (the dense
                     route), then bench.py's wave 2 with wave 1 bound by
                     clone_pod: the JAX engine's verdict digests; per wave
                     sidecar_encode_seconds, sidecar_dispatch_seconds (both
                     under the device lock) and sidecar_step_seconds (the
                     read back, outside it); the cold pregrouped encode
                     against encode_device on wave 1;
  [sidecar-config5]  in a fresh process (this script, --sidecar-config5):
                     one config-5 gang wave through run_session(gang=True):
                     the device fixpoint's 1001 iterations queued under
                     the lock, the JAX digest, the same three times; then
                     the wave again on a new session: the lock's time on
                     the first and on the second gang wave;
  [config4s]         BASELINE Config4S, heterogeneous_storage(20000, 20000,
                     seed=0): volumes and claims resolved by the encoder
                     (api/volumes.py; R = 6, the last resource
                     attachable-volumes-csi; P = N = 20480, U1 = 315), then
                     the dense step (packed_static_rows + chunk_rounds_dense)
                     and the class-wave step (HoistCache.ensure:
                     class_static_hoist + class_usage_hoist, then wave_commit
                     + chunk_rounds), each counted: exactly those launches,
                     20000/20000, the JAX choices digest, each route's sweeps
                     and ordinals digest; encode_s (resolution included) and
                     resolve_snapshot alone, step_s of each route;
  [config4s-warm]    bench.py's waves 2..7 over the storage-carrying snapshots
                     (workloads.StorageWaves: one PVC replaced from wave 5 on)
                     through PipelinedBatchLoop at depth 1 and 0: the JAX
                     loop's digests and HoistCache actions, the encoder's
                     full / delta counts as the JAX encoder's (one rebuild,
                     at the PVC change);
  [config4s-sidecar] the port's TPUScoreClient in session mode against the
                     port's TPUScoreServer(engine=_Engine(device="cuda")) on
                     loopback over wave 1 and the same waves 2..7: the
                     in-process verdicts, the client's full / delta calls
                     (one more full at the PVC change), the server's device
                     fixpoint a call (gang=True, G = 1: K7 + K8 + K13, one
                     real and one gated iteration); the
                     client's wall a call beside the server's
                     sidecar_*_seconds;
  [dra-small]        workloads.dra_small (device claims through
                     ResourceSlices and two overlapping DeviceClasses, a
                     ReadWriteOncePod claim shared by three pods) on the
                     default route (dense) and the per-pod route: the JAX
                     choices digest;
  [scheduler-config4] the Scheduler itself (scheduler/scheduler.py), as
                     users run it: BASELINE Config4, heterogeneous(20000,
                     20000, seed=0), loaded into a ClusterStore and driven
                     by run_until_idle (bench/harness.py
                     run_snapshot_workload(..., "tpu")), traced by a
                     TraceCollector(enabled=True): one batch cycle on the
                     class-wave route (class_static_hoist, class_usage_hoist,
                     wave_commit, chunk_rounds, each at least once), the JAX
                     Scheduler's Scheduled / FailedScheduling counts, batch
                     count and bindings digest; wall, pods/s, the span split
                     (batch.encode / batch.kernel / batch.commit, the
                     deferred binds' publication), the routes; once with
                     GangScheduling off (the routed non-gang branch, the
                     binds deferred to the drain); then the commit overlap:
                     the pods split between two profiles, the gate off, so
                     the second profile's device window publishes the
                     first one's deferred binds (bench/harness.py
                     overlapped_binds > 0): at heterogeneous(2000, 2000)
                     the JAX Scheduler's digest and overlapped binds, at
                     full size the same bindings as with pipeline_commit
                     off;
  [scheduler-config5] the same for BASELINE Config5, gang(1000, 64, 2000,
                     seed=0): the gang branch, the host fixpoint on class
                     state;
  [scheduler-native] BASELINE Config1 (basic(100, 100)), Config2 (basic(1000,
                     5000)) and Config3 (spread_affinity(5000, 10000)),
                     seed 0, not cut, through run_until_idle in
                     mode="native" (the C++ engine on the cycle's host
                     arrays: no launch, untraced and traced) and in
                     mode="tpu" (class-wave route for 1 and 2, rounds on
                     class state for 3): each run the JAX Scheduler's
                     counts, batch count and bindings digest
                     (workloads.SCHEDULER_BASELINE, from the JAX Scheduler
                     in mode="native"); wall, pods/s, the span split; then
                     [scheduler-preempt]'s failing cycle in mode="native":
                     the engine fails every preemptor on the host, the
                     diagnosis (explain_counts) and BatchedPreemption's
                     waves (class_static_hoist + preempt_eval) run on the
                     arrays placed for them: the JAX outcome digest;
  [scheduler-preempt] the preemption bench's build(20000, 1000) in a store,
                     one Scheduler.schedule_batch() under KTPU_EXPLAIN=1:
                     every preemptor fails the class-wave step, the
                     diagnosis (explain_counts) and BatchedPreemption's
                     waves (class_static_hoist + preempt_eval) evict 1000
                     fillers and nominate 1000 nodes: the JAX Scheduler's
                     evictions, nominations and FailedScheduling messages
                     (bench/harness.py failure_outcome digest); wall, the
                     span split;
  [explain-north-star] the unschedulable diagnosis at the north star:
                     explain_classes over the reps of all 100 pod classes (F
                     padded to 128, N=20480, R=5) at the dense step's
                     post-step usage, one explain_counts launch; the JAX
                     digest; explain_counts == plain, timed beside torch.matmul
                     of its taint count;
  [preempt]          the failure path on the JAX package's preemption bench
                     cluster, build(20000, 1000) (20000 full nodes, 40000
                     bound fillers, 1000 priority-100 preemptors):
                     failure_cycle on the card (DeltaEncoder, the dense step,
                     diagnose_failed with explain_counts, BatchedPreemption
                     with waves of class_static_hoist + preempt_eval at K =
                     64): 1000 failed, the JAX diagnosis message, 1000
                     nominations with the JAX decisions digest; every wave's
                     preempt_eval output == plain on the same inputs; the
                     time split (encode, step, explain, tables, each wave's
                     kernel by CUDA events and its read back, decide and
                     repair, apply_eviction); preempt_eval (card time and
                     back to back) and explain_counts at F = 4 timed; a
                     first preempt_eval launch before the cycle, timed
                     (the module's lazy load); ptxas's stack frames of
                     preempt_eval (which must be 0) and chunk_rounds;
  [dcn]              two torch.distributed ranks on the one card, this
                     script re-invoked as two workers (--dcn-worker RANK
                     PORT SHAPE) after [build], backend gloo with the CUDA
                     tensors staged through host memory (NCCL refuses two
                     ranks on one card; not NCCL, not a scale-out): the 1-D
                     mesh of 2 ranks x 2 node shards on the north star's
                     dense chunked and class-wave routes, and the 2x2 grid
                     with the pod axis across the ranks on the same two
                     routes and config 3's rounds route; each rank's choices
                     sha256, usage, ordinals and sweeps == the single
                     process's, its step_s and cross-rank gather seconds;
  [scheduler-restart] the crash restart of the Scheduler on the card: BASELINE
                     Config4 (heterogeneous(20000, 20000)) crash-only (no
                     checkpoint dir) through run_restartable under
                     kill.post_assume@10000 (mid-commit) and kill.mid_step@0:
                     one restart each, 20000 scheduled, the JAX Scheduler's
                     bindings digest; the replacement's first cycle a full
                     hoist (HoistCache static_rebuild) and class_static_hoist,
                     class_usage_hoist, wave_commit and chunk_rounds launched
                     again after the restore; the restore report, restore's
                     wall, the replacement's wall, the run's beside
                     [scheduler-config4]'s un-killed one.  Then Config1
                     (basic(100, 100)) armed with a checkpoint dir, killed
                     at each kill.* site of the bind path (@0; kill.mid_flush
                     with GangScheduling off): the JAX digest, each restore
                     report; once more under run_ha_restartable with two
                     kills: the digest and ha_fields.  Then the price of
                     arming: basic(1000, 1000) un-killed, unarmed and armed,
                     both walls, the checkpoint saves and ms a save;
  [stream-restart]   bench.py's warm waves 2..7 of the north star as
                     [warm-loop] builds them (their snapshots then fixed)
                     through run_stream_restartable at depth 1 with a
                     CheckpointManager, un-killed and under kill.submit@2,
                     kill.dispatch@2, kill.collect@2 and kill.drain@0: every
                     wave's digest the JAX loop's
                     (workloads.NORTH_STAR_WARM_DIGESTS), one restart, the
                     stream WAL holding waves 0..5, six commits, one
                     failover_duration_seconds observation; each run's wall
                     beside the un-killed one's; then pipeline.step error@2
                     and nan@2 through PipelinedBatchLoop alone: one wave
                     recovered by the serial replay on the card (the dense
                     route), the same digests.

Each route is counted on its own: every launch count is set to 0 just
before the route runs and read just after, and a kernel of the route that
was not launched fails the run.  Kernel times come from CUDA events after
a warm-up; step and loop times from the host clock around work that ends
in torch.cuda.synchronize().

An [env] line first says whether grpc and google.protobuf import here
(no phase needs them).

Prints one line per phase, then a JSON line of per-kernel numbers (with
launches_run: the kernel's launches over every counted run that takes a
default route, summed phase by phase, the child processes' included), the
card's name and power limit as nvidia-smi gives them, and last
{"ok": true, "device": {...}}.  Exits non-zero, with no result, when there
is no CUDA device, when the port is not beside this script, or when any
phase fails.  Needs one card and no network.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_PER_S = 67e12  # f32 outside the tensor cores, H100 SXM data sheet
PREFIX = 2048  # pods of the north-star scan held against the plain scan
PLAIN_PODS = 8192  # pods of the north-star scan the plain scan re-runs in full
WAVE_PREFIX_CHUNKS = 64  # stage-B chunks held against the plain round loop
PER_POD_KERNELS = ("static_feasible", "fit_scan")
WAVE_KERNELS = ("class_static_hoist", "class_usage_hoist", "wave_commit", "chunk_rounds")
NO_GANGS = (("GangScheduling", False),)  # the Scheduler's non-gang batch branch
DENSE_KERNELS = ("packed_static_rows", "chunk_rounds_dense")
DENSE_PREFIX_CHUNKS = 8  # dense chunks held against the plain round loop
ROUNDS_PREFIX_CHUNKS = 8  # config-3 rounds chunks held against the plain rounds scan
PERPOD_PREFIX = 512  # config-3 pods of the full-stage per-pod scan held against plain
MESH_DENSE_KERNELS = ("packed_static_rows", "stitch_planes", "chunk_rounds_dense")
MESH_WAVE_KERNELS = ("class_static_hoist", "class_usage_hoist", "stitch_planes", "wave_commit", "chunk_rounds")
STITCH_PLAIN_ROWS = 4096  # row block of the plain stitch (its int64 transient is ~0.7 GB)
# kernel -> launches of every counted run that takes a default route (what
# dispatch takes with chunked=None; the encoder, the class cache, the gang
# fixpoints, the sidecar, the failure path, the ring), summed phase by
# phase, the child processes' included: the kernels line's launches_run
RUN_LAUNCHES: dict = {}
STRATEGIES = (
    ("LeastAllocated", ((0.0, 0.0), (100.0, 10.0))),
    ("MostAllocated", ((0.0, 0.0), (100.0, 10.0))),
    ("RequestedToCapacityRatio", ((0.0, 10.0), (50.0, 2.0), (100.0, 0.0))),
)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def add_launches(launches: dict) -> None:
    for k, v in launches.items():
        RUN_LAUNCHES[k] = RUN_LAUNCHES.get(k, 0) + v


def counted(default: bool = True) -> dict:
    """The launches since the last kernels.reset_launches() (a phase's
    counted run), of the kernels it launched; added into RUN_LAUNCHES when
    the run took a default route."""
    from kubernetes_tpu_torch.ops import kernels

    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    if default:
        add_launches(launches)
    return launches


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of fn() over `reps` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def in_turns_ms(a, b, reps: int = 1) -> tuple:
    """(a's, b's) mean milliseconds by cuda_ms, timed in turns a, b, b, a."""
    ta, tb, tb2, ta2 = (cuda_ms(f, reps=reps) for f in (a, b, b, a))
    return (ta + ta2) / 2, (tb + tb2) / 2


def card_ms(fn, reps: int) -> float:
    """Mean card milliseconds of fn() where the host, not the card, would
    set the pace of back-to-back calls (gated launches return at once):
    the `reps` calls are queued behind a sleeping kernel that outlasts
    their enqueue, and CUDA events time them on the card alone."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    torch.cuda.synchronize()
    cycles_per_ms = 10_000_000 / start.elapsed_time(end)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda._sleep(int(cycles_per_ms * (2 * host_ms + 20)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def term_match_library(arrs, reps: int) -> tuple:
    """K1's library yardstick: torch.einsum of the float selector masks
    against the float label rows (the term match's share of its work, as
    XLA lowers it), once per arrays in `arrs`, the operands made before the
    timing -> (back-to-back ms, card ms) of the calls."""
    import torch

    from kubernetes_tpu_torch.bench import score_explain

    ops = [(a.sel_mask.float(), a.node_labels.float()) for a in arrs]

    def lib():
        return [torch.einsum("sel,nl->sen", s, lab) for s, lab in ops]

    return cuda_ms(lib, reps=reps, warmup=2), score_explain.card_host(lib, reps=reps)[0]


def k1_calls_checked(fn, tag: str) -> int:
    """The device operations one K1 call runs (torch.profiler), checked to
    be at most its two launches; 0 where the profiler sees none."""
    from kubernetes_tpu_torch.bench import score_explain

    ops = score_explain.device_ops(fn)
    check(len(ops) <= 2, f"{tag}: one static_feasible call ran {ops}")
    return len(ops)


def f32_ops_per_scored_node(cfg) -> int:
    """f32 operations csrc/fit_scan.cu does for one (pod, node) pair that
    passes fit: the fit strategy and BalancedAllocation over K scored
    resources, then the weighted sum (int->f32 conversions not counted)."""
    k = len(cfg.score_resources)
    per_res = {
        "LeastAllocated": 4,  # sub, mul, div, max
        "MostAllocated": 3,  # compare, mul, div
        "RequestedToCapacityRatio": 3 + 6 * (len(cfg.rtcr_shape) - 1),
    }[cfg.fit_strategy]
    fit = k * per_res + (k - 1) + 1  # sum, divide by K
    balanced = 2 * k + (k - 1) + 1 + 2 * k + (k - 1) + 1 + 3  # f, mean, var, sqrt/sub/mul
    return fit + balanced + 3


def bound(bytes_moved: float, ops: float) -> tuple:
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_work(arr) -> tuple:
    """(bytes, operations) of K1 on these arrays: every input read once --
    of each label row only the bytes of the literals some mask sets (the
    rest cannot change a count), the masks whole -- and the [P, N] plane
    written once; the integer tests a pair, priced at the f32 rate."""
    P, N = arr.P, arr.N
    T, TT = arr.node_taint_ns.shape[1], arr.pod_terms.shape[1]
    S, E, L = arr.sel_mask.shape
    lits = int(arr.sel_mask.reshape(-1, L).any(dim=0).sum()) if S * E else 0
    return (N * (2 + T + lits) + P * (2 + T) + 4 * P * (1 + TT) + S * E * L + 4 * S * E + P * N,
            P * N * (3 + T + TT))


def phase_card() -> tuple:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"[card] {name} | count {torch.cuda.device_count()} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | nvidia-smi: {card}", flush=True)
    return card, name


def phase_build() -> None:
    """nvcc for every kernel source and g++ / gcc for native/'s two host
    libraries (the C++ engine, the C interner), all started at once."""
    import threading

    from kubernetes_tpu_torch import native
    from kubernetes_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    host = {}

    def build_host():
        try:
            native.build()
            host["s"] = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 — re-raised below, after nvcc
            host["error"] = e

    th = threading.Thread(target=build_host)
    th.start()
    kernels.build()
    dt = time.perf_counter() - t0
    th.join()
    if "error" in host:
        raise host["error"]
    for name, log in kernels.BUILD_LOG.items():
        info = [ln.strip() for ln in log.splitlines() if re.search(r"registers|Used|spill", ln)]
        print(f"[build] {name}: " + " | ".join(info), flush=True)
    print(f"[build] {len(set(kernels.SOURCES.values()))} kernel libraries ({len(kernels.SOURCES)} kernels) "
          f"in {dt:.2f} s; native/ host libraries (scheduler.cpp, interner.c) in {host['s']:.2f} s "
          f"into {native.BUILD_DIR.name}/", flush=True)


def on_c_path(interner, tag: str) -> None:
    check(interner.path == "c", f"{tag}: the spec interner is on its {interner.path} path, not C")


def phase_interner() -> None:
    """SpecInterner at the north star's 50000 pending pods (activeQ order, as
    DeltaEncoder.encode groups them): the C path's cold group (a fresh
    table) and warm groups (bench.py's waves 2 and 3: clones sharing the
    field objects) against the Python loop's (SpecInterner(native=False))
    on the same pods; the outputs equal."""
    from kubernetes_tpu_torch.api.snapshot import SpecInterner, activeq_order
    from kubernetes_tpu_torch.bench import workloads as w

    snap = w.heterogeneous(20000, 50000, seed=0)
    waves = [snap.pending_pods] + [w.mk_wave(snap, k) for k in (2, 3)]
    waves = [[ps[i] for i in activeq_order(ps)] for ps in waves]
    times = {"c": [], "python": []}
    outs = {}
    for path in ("c", "python"):
        it = SpecInterner(native=path == "c")
        check(it.path == path, f"interner: asked for the {path} path, got {it.path}")
        for pods in waves:
            t0 = time.perf_counter()
            reps, inv, keys = it.group(pods)
            times[path].append(time.perf_counter() - t0)
            pos = {id(p): i for i, p in enumerate(pods)}
            outs.setdefault(path, []).append(([pos[id(r)] for r in reps], inv.tobytes(), keys))
        check(it.path == path, f"interner: the {path} interner left its path")
    check(outs["c"] == outs["python"], "interner: the C path's groups differ from the Python loop's")
    c, py = times["c"], times["python"]
    print(f"[interner] {len(waves[0])} pods, {len(outs['c'][0][0])} specs: C path cold {c[0]:.4f} s, warm "
          f"{c[1]:.4f} / {c[2]:.4f} s; Python loop cold {py[0]:.4f} s, warm {py[1]:.4f} / {py[2]:.4f} s "
          f"(host clock); reps, inv and rep_keys equal on all three", flush=True)


def phase_mixed() -> None:
    import torch

    from kubernetes_tpu_torch.api.snapshot import encode_snapshot
    from kubernetes_tpu_torch.bench.workloads import mixed
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, infer_score_config, schedule_batch
    from kubernetes_tpu_torch.ops import filters, kernels
    from kubernetes_tpu_torch.ops.assign import schedule_scan_plain

    snap = mixed()
    arr, meta = encode_snapshot(snap, device="cuda")
    arr_cpu, _ = encode_snapshot(snap, device="cpu")
    sf_k = kernels.static_feasible(arr)
    sf_p = filters.static_feasible_plain(arr)
    torch.cuda.synchronize()
    check(torch.equal(sf_k, sf_p), "mixed: static_feasible kernel != plain")
    for strategy, shape in STRATEGIES:
        cfg = infer_score_config(arr, dataclasses.replace(
            DEFAULT_SCORE_CONFIG, fit_strategy=strategy, rtcr_shape=shape))
        ck, uk, _ = kernels.fit_scan(sf_k, arr, cfg)
        cp, up = schedule_scan_plain(arr, cfg, sf=sf_p)
        cc, uc = schedule_batch(arr_cpu, cfg, device="cpu")
        torch.cuda.synchronize()
        check(torch.equal(ck, cp) and torch.equal(uk, up), f"mixed {strategy}: fit_scan kernel != plain")
        check(torch.equal(ck.cpu(), cc) and torch.equal(uk.cpu(), uc), f"mixed {strategy}: card != CPU")
        print(f"[mixed] {strategy}: P={arr.P} N={arr.N} R={arr.R} scheduled "
              f"{int((ck[:meta.n_pods] >= 0).sum())}/{meta.n_pods}; kernels == plain == CPU", flush=True)


def phase_north_star() -> list:
    import torch

    from kubernetes_tpu_torch.api.snapshot import encode_snapshot
    from kubernetes_tpu_torch.bench import score_explain, workloads
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, infer_score_config, schedule_batch
    from kubernetes_tpu_torch.ops import filters, kernels
    from kubernetes_tpu_torch.ops.assign import schedule_scan_plain

    snap = workloads.heterogeneous(**workloads.NORTH_STAR)
    t0 = time.perf_counter()
    arr, meta = encode_snapshot(snap)  # the card, as a user calls it
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    P, N, R = arr.P, arr.N, arr.R
    print(f"[north-star] encode_s {encode_s:.3f}: P={P} N={N} R={R} resources {meta.resources} "
          f"scale {meta.resource_scale.tolist()}", flush=True)

    # --- the per-pod route, counted (chunked=False: on the card the default
    # without class state is the dense chunked route, [north-star-dense]) ---
    kernels.reset_launches()
    t0 = time.perf_counter()
    choices, used = schedule_batch(arr, cfg, chunked=False)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = {k: v for k, v in kernels.LAUNCHES.items() if k in PER_POD_KERNELS}
    check(all(n > 0 for n in launches.values()), f"a kernel of the path was not launched: {launches}")
    c = choices[: meta.n_pods].cpu().numpy().astype("<i4")
    scheduled = int((c >= 0).sum())
    digest = hashlib.sha256(c.tobytes()).hexdigest()
    print(f"[north-star] schedule_batch step_s {step_s:.3f}: scheduled {scheduled}/{meta.n_pods}, "
          f"sha256 {digest}, launches {launches}", flush=True)
    check(scheduled == workloads.NORTH_STAR_SCHEDULED, f"scheduled {scheduled} != {workloads.NORTH_STAR_SCHEDULED}")
    check(digest == workloads.NORTH_STAR_CHOICES_SHA256, "choices differ from the JAX package's")

    # --- kernel 1 against its plain version over the whole [P, N] ---
    sf = kernels.static_feasible(arr)
    sf_p = filters.static_feasible_plain(arr)
    k1_err = int((sf != sf_p).any())  # |kernel - plain| over 0/1 entries
    check(k1_err == 0, "north-star: static_feasible kernel != plain")
    del sf_p
    k1_ms = cuda_ms(lambda: kernels.static_feasible(arr), reps=10, warmup=2)
    k1_card, k1_host = score_explain.card_host(lambda: kernels.static_feasible(arr), reps=10)
    k1_lib, k1_lib_card = term_match_library([arr], reps=10)
    k1_ops = k1_calls_checked(lambda: kernels.static_feasible(arr), "north-star")
    k1_plain_ms = cuda_ms(lambda: filters.static_feasible_plain(arr), reps=3)
    k1_bound, k1_by = bound(*k1_work(arr))
    print(f"[north-star] static_feasible: kernel == plain over [{P}, {N}]; kernel {k1_ms:.4f} ms back to back, "
          f"{k1_card:.4f} ms of card time, host {k1_host:.1f} us a call, {k1_ops} device operations a call; the "
          f"term match's torch.einsum {k1_lib:.4f} ms ({k1_lib_card:.4f} card); plain {k1_plain_ms:.4f} ms, bound "
          f"{k1_bound:.4f} ms ({k1_by})", flush=True)

    # --- kernel 2 against its plain version: the first PREFIX pods, then all ---
    pre = arr.pod_prefix(PREFIX)
    ck, uk, _ = kernels.fit_scan(sf[:PREFIX].contiguous(), pre, cfg)
    cp, up = schedule_scan_plain(pre, cfg, sf=sf[:PREFIX])
    torch.cuda.synchronize()
    check(torch.equal(ck, cp) and torch.equal(uk, up), "north-star prefix: fit_scan kernel != plain")
    check(torch.equal(ck, choices[:PREFIX]), "north-star prefix: prefix scan != full scan")
    print(f"[north-star] fit_scan: kernel == plain on the first {PREFIX} pods", flush=True)

    out = {}

    def run_kernel():
        out["k"] = kernels.fit_scan(sf, arr, cfg)

    k2_ms = cuda_ms(run_kernel, reps=3)
    k2_kc = kernels.LAST_CLUSTER["fit_scan"]
    ck, uk, n_scored = out["k"]
    check(torch.equal(ck, choices), "north-star: timed fit_scan != the main path's")
    # the plain scan over all pods takes ~70 s; a prefix of the scan is a
    # scan, so the plain version re-runs the first PLAIN_PODS pods
    pre = arr.pod_prefix(PLAIN_PODS)
    ckp, ukp, _ = kernels.fit_scan(sf[:PLAIN_PODS].contiguous(), pre, cfg)
    t0 = time.perf_counter()
    cp, up = schedule_scan_plain(pre, cfg, sf=sf[:PLAIN_PODS])
    torch.cuda.synchronize()
    k2_plain_ms = (time.perf_counter() - t0) * 1e3
    k2_err = max(int((ckp.long() - cp.long()).abs().max()), int((ukp.long() - up.long()).abs().max()))
    check(k2_err == 0, f"north-star: fit_scan kernel != plain on the first {PLAIN_PODS} pods")
    check(torch.equal(ckp, choices[:PLAIN_PODS]), "north-star: prefix scan != full scan")
    n_scored = int(n_scored.item())
    # the scan's floor: the same launch with every sf bit clear, so each pod
    # still streams its row and pays the block reduction and the barriers,
    # but nothing passes to fit or scoring
    empty = torch.zeros_like(sf)
    floor_ms = cuda_ms(lambda: kernels.fit_scan(empty, arr, cfg), reps=3)
    del empty
    k2_bytes = P * N + 4 * P * R + P + 3 * 4 * N * R + 4 * P
    k2_ops = n_scored * f32_ops_per_scored_node(cfg)
    k2_bound, k2_by = bound(k2_bytes, k2_ops)
    print(f"[north-star] fit_scan: kernel == plain on the first {PLAIN_PODS} pods; kernel {k2_ms:.3f} ms "
          f"over all {P} ({k2_ms / P * 1e3:.3f} us per pod, one cluster of {k2_kc} blocks; with no feasible node "
          f"{floor_ms:.3f} ms, {floor_ms / P * 1e3:.3f} us per pod: the {P} cluster reductions and barriers), "
          f"plain {k2_plain_ms:.1f} ms on {PLAIN_PODS} pods (host clock), bound {k2_bound:.4f} ms "
          f"({k2_by}: {k2_bytes} B, {n_scored} scored pairs x {f32_ops_per_scored_node(cfg)} f32 ops)",
          flush=True)
    return step_s, [
        dict(name="static_feasible", route="cuda", source="kubernetes_tpu_torch/csrc/static_feasible.cu",
             replaces="kubernetes_tpu/ops/filters.py:81", launches=launches["static_feasible"],
             max_abs_err=k1_err, ms=k1_ms, card_ms=k1_card, host_us=k1_host, plain_ms=k1_plain_ms,
             bound_ms=k1_bound, bound_by=k1_by, library_ms=k1_lib, library_card_ms=k1_lib_card,
             device_ops=k1_ops),
        dict(name="fit_scan", route="cuda", source="kubernetes_tpu_torch/csrc/fit_scan.cu",
             replaces="kubernetes_tpu/ops/assign.py:181", launches=launches["fit_scan"],
             max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain_ms, bound_ms=k2_bound, bound_by=k2_by,
             library_ms=None, plain_scope=f"first {PLAIN_PODS} pods", kc=k2_kc, floor_ms=floor_ms),
    ], (arr, meta, cfg, choices, used)


def f32_bits(x):
    import torch

    return x.contiguous().view(torch.int32)


def same(a, b) -> bool:
    """Bitwise equality of two tensors (f32 compared as bits)."""
    import torch

    if a.dtype == torch.float32:
        a, b = f32_bits(a), f32_bits(b)
    return a.shape == b.shape and torch.equal(a, b)


def mismatch(a, b) -> int:
    """Entries that differ (f32 as bits)."""
    if a.dtype.is_floating_point:
        a, b = f32_bits(a), f32_bits(b)
    return int((a != b).sum())


def hold_class_kernels(arr, meta, cfg, tag: str, **knobs) -> dict:
    """Hold K3, K4 (full and column list), K5 and K6 to their plain versions
    on these arrays (the plain versions run on the card's tensors) and the
    route's choices to the per-pod route's; `knobs` are the route's wave_k /
    wave_block.  -> the wave's counters."""
    import torch

    from kubernetes_tpu_torch.ops import assign, incremental, kernels
    from kubernetes_tpu_torch.ops.incremental import HoistCache, class_view

    inc = HoistCache().ensure(arr, meta, cfg)
    check(inc is not None, f"{tag}: no class state")
    r_u = torch.as_tensor(meta.class_first_pod, device=arr.device)
    stat_p = incremental._static_hoist_plain(class_view(arr, r_u))[0]
    check(same(inc.stat_u, stat_p), f"{tag}: class_static_hoist != plain")
    base_p, fit_p = incremental._usage_hoist_plain(inc.req_u, arr.node_used, arr.node_alloc, cfg)
    check(same(inc.base_u, base_p) and same(inc.fit_u, fit_p), f"{tag}: class_usage_hoist != plain")
    # column list: dirty a third of the nodes, several sharing a word
    N = arr.N
    g = torch.Generator().manual_seed(7)
    dirty = torch.randperm(N, generator=g)[: max(1, N // 3)].sort().values.to(arr.device)
    used2 = arr.node_used.clone()
    used2[dirty] += arr.pod_req[0]
    cols = torch.full((incremental._round_up_pow2(len(dirty)),), N, dtype=torch.int32, device=arr.device)
    cols[: len(dirty)] = dirty.to(torch.int32)
    bk, fk = kernels.class_usage_hoist(inc.req_u, used2, arr.node_alloc, cfg, cols=cols,
                                       base_u=inc.base_u, fit_u=inc.fit_u)
    bp, fp = incremental._patch_hoist_plain(inc.base_u, inc.fit_u, inc.req_u, used2, arr.node_alloc, cols, cfg)
    bf, ff = kernels.class_usage_hoist(inc.req_u, used2, arr.node_alloc, cfg)
    check(same(bk, bp) and same(fk, fp), f"{tag}: class_usage_hoist column list != plain")
    check(same(bk, bf) and same(fk, ff), f"{tag}: patched columns != a full hoist")
    check(same(inc.base_u, base_p), f"{tag}: the column list wrote into the resident base_u")
    # K5
    wk = kernels.wave_commit(arr, inc, cfg, **knobs)
    t0u = assign.t0u_prologue(inc, N)
    wp = assign.wave_commit_plain(inc.cls, arr.pod_valid, arr.pod_req, arr.node_used, t0u, inc.stat_u,
                                  arr.node_alloc, inc.req_u, cfg, **knobs)
    names = ("committed", "out", "ordinal", "used", "t0u")
    for name, a, b in zip(names, wk[:5], wp[:5]):
        check(same(a, b), f"{tag}: wave_commit {name} != plain ({mismatch(a, b)} entries)")
    check(int(wk[5]) == wp[5] and int(wk[6]) == wp[6],
          f"{tag}: wave_commit blocks/epochs {int(wk[5])}/{int(wk[6])} != plain {wp[5]}/{wp[6]}")
    # K6 after the plain wave (so each kernel is held alone), and with no wave
    wave_p = (wp[0], wp[1], wp[2], torch.tensor(wp[5], dtype=torch.int32, device=arr.device))
    for leg, wave, used0, t0 in (("waves", wave_p, wp[3], wp[4]), ("no waves", None, arr.node_used, None)):
        ck = kernels.chunk_rounds(arr, inc, cfg, used0, t0, wave)
        cp = assign.schedule_scan_chunked_plain(
            arr, cfg, inc, used0, t0u if t0 is None else t0,
            None if wave is None else (wp[0], wp[1], wp[2], wp[5]))
        for name, a, b in zip(("choices", "used", "ordinals"), ck[:3], cp[:3]):
            check(same(a, b), f"{tag} {leg}: chunk_rounds {name} != plain ({mismatch(a, b)} entries)")
        sweeps = kernels.read_sweeps(ck[3])
        check(sweeps == cp[3], f"{tag} {leg}: chunk_rounds sweeps {sweeps} != plain {cp[3]}")
    # the route against the per-pod route
    c1, u1 = assign.schedule_batch(arr, cfg)
    for waves in (True, False):
        c2, u2, o2, s2 = assign.schedule_batch_ordinals(arr, cfg, inc=inc, class_waves=waves, **knobs)
        check(torch.equal(c1, c2) and torch.equal(u1, u2), f"{tag} waves={waves}: route != per-pod route")
    return dict(blocks=wp[5], epochs=wp[6], stage_b=int((~wp[0][: meta.n_pods]).sum()), U1=inc.req_u.shape[0])


def phase_waves_mixed() -> None:
    from kubernetes_tpu_torch.api.snapshot import encode_snapshot
    from kubernetes_tpu_torch.bench import workloads
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, infer_score_config

    cases = [(f"mixed {name}", workloads.mixed(), name, shape, {}) for name, shape in STRATEGIES]
    cases += [
        ("interference", workloads.interference(), "LeastAllocated", STRATEGIES[0][1], {}),
        ("heterogeneous(64, 300)", workloads.heterogeneous(64, 300), "LeastAllocated", STRATEGIES[0][1], {}),
        ("mixed, wave_block=4 wave_k=8", workloads.mixed(), "MostAllocated", STRATEGIES[1][1],
         dict(wave_block=4, wave_k=8)),
        # two-entry lists in 64-pod blocks: the block budget runs out and
        # chunk_rounds continues after a partial wave
        ("basic(48, 1500), wave_block=64 wave_k=2", workloads.basic(48, 1500), "LeastAllocated",
         STRATEGIES[0][1], dict(wave_block=64, wave_k=2)),
    ]
    for tag, snap, strategy, shape, knobs in cases:
        arr, meta = encode_snapshot(snap, device="cuda")
        cfg = infer_score_config(arr, dataclasses.replace(
            DEFAULT_SCORE_CONFIG, fit_strategy=strategy, rtcr_shape=shape))
        info = hold_class_kernels(arr, meta, cfg, tag, **knobs)
        if tag == "interference":
            check(info["epochs"] > 0, "interference: the wave never refreshed an epoch")
        if tag.startswith("basic"):
            check(info["stage_b"] > 0, f"{tag}: the wave left nothing to stage B")
        print(f"[waves-mixed] {tag}: P={arr.P} N={arr.N} U1={info['U1']} wave blocks {info['blocks']} "
              f"epochs {info['epochs']} left to stage B {info['stage_b']}; class_static_hoist, "
              f"class_usage_hoist (full, columns), wave_commit, chunk_rounds == plain; route == per-pod",
              flush=True)


def stage_b(arr, inc, cfg, wk, per_score: int) -> tuple:
    """K6 as the class-wave step runs it, after K5's wave `wk`, and its plain
    version on the same inputs -> (K6's outputs, plain's, K6 ms, plain ms,
    stage B's bound ms and its kind, the bytes, the chunks that need
    rounds, K6's back-to-back ms).  K6's ms is its card time (card_ms: the
    wrapper's host call, not the card, paces back-to-back calls when the
    wave leaves nothing).  The bound: bench/stage_b_preempt.py
    stage_b_bytes, and per chunk that needs rounds a selection over a class
    row a pod and its placements' columns scored for every class."""
    from kubernetes_tpu_torch.bench.stage_b_preempt import open_pods, stage_b_bytes
    from kubernetes_tpu_torch.ops import assign, kernels

    C = assign.INC_CHUNK
    U1 = inc.req_u.shape[0]
    wave = (wk[0], wk[1], wk[2], wk[5])
    pwave = (wk[0], wk[1], wk[2], int(wk[5]))
    k = kernels.chunk_rounds(arr, inc, cfg, wk[3], wk[4], wave)
    p = assign.schedule_scan_chunked_plain(arr, cfg, inc, wk[3], wk[4], pwave)
    b2b = cuda_ms(lambda: kernels.chunk_rounds(arr, inc, cfg, wk[3], wk[4], wave), reps=20, warmup=2)
    ms = card_ms(lambda: kernels.chunk_rounds(arr, inc, cfg, wk[3], wk[4], wave), reps=20)
    plain = cuda_ms(lambda: assign.schedule_scan_chunked_plain(arr, cfg, inc, wk[3], wk[4], pwave), reps=3)
    listed = open_pods(wk[0], C)
    placed = int(((p[0] >= 0) & ~wk[0]).sum())
    nbytes = stage_b_bytes(arr.P, arr.N, arr.R, U1, listed)
    b_ms, b_by = bound(nbytes, listed * arr.N + U1 * placed * per_score)
    return k, p, ms, plain, b_ms, b_by, nbytes, listed // C, b2b


def phase_north_star_waves(per_pod_step_s: float) -> list:
    import torch

    from kubernetes_tpu_torch.api.snapshot import encode_snapshot
    from kubernetes_tpu_torch.bench import score_explain, workloads
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, incremental, infer_score_config, kernels
    from kubernetes_tpu_torch.ops.incremental import HoistCache, IncState, class_view

    snap = workloads.heterogeneous(**workloads.NORTH_STAR)
    arr, meta = encode_snapshot(snap)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    P, N, R = arr.P, arr.N, arr.R
    n = meta.n_pods

    def digest(x):
        return hashlib.sha256(x[:n].cpu().numpy().astype("<i4").tobytes()).hexdigest()

    # --- the class-wave route, counted ---
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = HoistCache()
    inc = cache.ensure(arr, meta, cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    choices, used, ords, sweeps = assign.schedule_batch_ordinals(arr, cfg, inc=inc)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counted()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if k in WAVE_KERNELS}
    check(all(v > 0 for v in launches.values()), f"a kernel of the class-wave route was not launched: {launches}")
    U1 = inc.req_u.shape[0]
    scheduled = int((choices[:n] >= 0).sum())
    print(f"[north-star-waves] HoistCache.ensure {t1 - t0:.3f} s ({cache.last['action']}), "
          f"schedule_batch(inc) {t2 - t1:.3f} s (first call): U1={U1} scheduled {scheduled}/{n}, "
          f"sweeps {sweeps}, choices sha256 {digest(choices)}, ordinals sha256 {digest(ords)}, "
          f"launches {launches}", flush=True)
    check(U1 == workloads.NORTH_STAR_CLASSES, f"U1 {U1} != {workloads.NORTH_STAR_CLASSES}")
    check(scheduled == workloads.NORTH_STAR_SCHEDULED, "north-star waves: scheduled count")
    check(digest(choices) == workloads.NORTH_STAR_CHOICES_SHA256, "north-star waves: choices differ from JAX")
    check(sweeps == workloads.NORTH_STAR_WAVE_SWEEPS, f"north-star waves: sweeps {sweeps}")
    check(digest(ords) == workloads.NORTH_STAR_WAVE_ORDINALS_SHA256, "north-star waves: ordinals differ from JAX")
    # step_s after a warm-up, both routes on the same snapshot
    def route():
        return assign.schedule_batch(arr, cfg, inc=cache.ensure(arr, meta, cfg))

    route()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    route()
    torch.cuda.synchronize()
    wave_step_s = time.perf_counter() - t0
    print(f"[north-star-waves] step_s: class-wave route {wave_step_s:.4f} s (ensure hit + schedule_batch), "
          f"per-pod route {per_pod_step_s:.4f} s ([north-star], first call)", flush=True)

    # --- K3 and K4 against plain over all [U1, N] ---
    r_u = torch.as_tensor(meta.class_first_pod, device=arr.device)
    stat_p = incremental._static_hoist_plain(class_view(arr, r_u))[0]
    k3_err = mismatch(inc.stat_u, stat_p)
    check(k3_err == 0, "north-star: class_static_hoist != plain")
    base_p, fit_p = incremental._usage_hoist_plain(inc.req_u, arr.node_used, arr.node_alloc, cfg)
    k4_err = mismatch(inc.base_u, base_p) + mismatch(inc.fit_u, fit_p)
    check(k4_err == 0, "north-star: class_usage_hoist != plain")
    k3_ms = cuda_ms(lambda: kernels.class_static_hoist(arr, r_u), reps=20, warmup=2)
    k3_plain = cuda_ms(lambda: incremental._static_hoist_plain(class_view(arr, r_u))[0], reps=5)
    k4_ms = cuda_ms(lambda: kernels.class_usage_hoist(inc.req_u, arr.node_used, arr.node_alloc, cfg), reps=20,
                    warmup=2)
    k4_plain = cuda_ms(lambda: incremental._usage_hoist_plain(inc.req_u, arr.node_used, arr.node_alloc, cfg),
                       reps=5)
    k4_card, k4_host = score_explain.card_host(
        lambda: kernels.class_usage_hoist(inc.req_u, arr.node_used, arr.node_alloc, cfg), reps=50)
    T, TT = arr.node_taint_ns.shape[1], arr.pod_terms.shape[1]
    S, E_, L = arr.sel_mask.shape
    W = -(-N // 32)
    k3_bytes = N * (1 + T + L) + U1 * (T + 1 + 4 + 4 * TT + 8) + S * E_ * L + 4 * S * E_ + 4 * U1 * W
    k3_bound, k3_by = bound(k3_bytes, U1 * N * (3 + T + TT))
    per_score = f32_ops_per_scored_node(cfg)
    k4_bytes = 4 * U1 * R + 2 * 4 * N * R + 4 * U1 * N + 4 * U1 * W
    k4_bound, k4_by = bound(k4_bytes, U1 * N * per_score)
    print(f"[north-star-waves] class_static_hoist == plain over [{U1}, {N}]: {k3_ms:.4f} ms, plain "
          f"{k3_plain:.4f} ms, bound {k3_bound:.5f} ms ({k3_by}); class_usage_hoist == plain: {k4_ms:.4f} ms "
          f"back to back, {k4_card:.4f} ms of card time, {k4_host:.1f} us host a call, plain {k4_plain:.4f} ms, "
          f"bound {k4_bound:.5f} ms ({k4_by}: {k4_bytes} B, {U1 * N} scores)", flush=True)

    # --- K5 against plain over the whole wave ---
    out = {}

    def run_k5():
        out["w"] = kernels.wave_commit(arr, inc, cfg)

    k5_ms = cuda_ms(run_k5, reps=5, warmup=1)
    wk = out["w"]
    t0u = assign.t0u_prologue(inc, N)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wp = assign.wave_commit_plain(inc.cls, arr.pod_valid, arr.pod_req, arr.node_used, t0u, inc.stat_u,
                                  arr.node_alloc, inc.req_u, cfg)
    torch.cuda.synchronize()
    k5_plain = (time.perf_counter() - t0) * 1e3
    k5_err = sum(mismatch(a, b) for a, b in zip(wk[:5], wp[:5]))
    check(k5_err == 0 and int(wk[5]) == wp[5] and int(wk[6]) == wp[6], "north-star: wave_commit != plain")
    placed = int((wp[1] >= 0).sum())
    n_blocks, epochs = wp[5], wp[6]
    k5_bytes = (4 * P + P + 4 * P * R + 4 * N * R + 2 * 4 * U1 * W + 4 * U1 * N + 4 * N * R + 4 * U1 * R
                + P + 4 * P + 4 * P + 4 * N * R + 4 * U1 * N)
    # each placed pod's post-placement column is scored for every class; each
    # refresh reads every class row once
    k5_ops = U1 * placed * per_score + (epochs + 1) * U1 * N
    k5_bound, k5_by = bound(k5_bytes, k5_ops)
    print(f"[north-star-waves] wave_commit == plain over the whole wave ({n_blocks} blocks, {epochs} epochs, "
          f"{placed} placed): {k5_ms:.3f} ms, plain {k5_plain:.1f} ms (host clock), bound {k5_bound:.5f} ms "
          f"({k5_by}: {k5_bytes} B, {k5_ops} ops)", flush=True)
    # K6 as the default class-wave step runs it: stage B after the wave,
    # == plain (the JAX skip where the wave committed every pod), beside
    # stage B's own bound
    sb_k, sb_p, sb_ms, sb_plain, sb_bound, sb_by, sb_bytes, sb_chunks, sb_b2b = stage_b(arr, inc, cfg, wk, per_score)
    sb_err = sum(mismatch(a, b) for a, b in zip(sb_k[:3], sb_p[:3])) + abs(kernels.read_sweeps(sb_k[3]) - sb_p[3])
    check(sb_err == 0, "north-star: chunk_rounds as stage B != plain")
    print(f"[north-star-waves] chunk_rounds as the class-wave step's stage B (after the wave; {sb_chunks} of "
          f"{P // assign.INC_CHUNK} chunks need rounds, {sb_p[3]} sweeps) == plain: {sb_ms:.4f} ms of card time "
          f"({sb_b2b:.4f} ms back to back, paced by the wrapper's host call), plain "
          f"{sb_plain:.4f} ms, stage B's bound {sb_bound:.6f} ms ({sb_by}: {sb_bytes} B)", flush=True)

    # --- the route with class_waves=False: chunk_rounds carries every chunk ---
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c_off, u_off, o_off, s_off = assign.schedule_batch_ordinals(arr, cfg, inc=inc, class_waves=False)
    torch.cuda.synchronize()
    off_s = time.perf_counter() - t0
    check(kernels.LAUNCHES["chunk_rounds"] == 1 and kernels.LAUNCHES["wave_commit"] == 0,
          f"waves off: launches {kernels.LAUNCHES}")
    print(f"[north-star-waves] class_waves=False {off_s:.3f} s: sweeps {s_off}, choices sha256 "
          f"{digest(c_off)}, ordinals sha256 {digest(o_off)}", flush=True)
    check(digest(c_off) == workloads.NORTH_STAR_CHOICES_SHA256, "waves off: choices differ from JAX")
    check(s_off == workloads.NORTH_STAR_NOWAVE_SWEEPS, f"waves off: sweeps {s_off}")
    check(digest(o_off) == workloads.NORTH_STAR_NOWAVE_ORDINALS_SHA256, "waves off: ordinals differ from JAX")
    k6_full_ms = cuda_ms(lambda: kernels.chunk_rounds(arr, inc, cfg, arr.node_used, None, None), reps=3)
    # K6 against plain on the first chunks: a prefix of the chunk scan is a scan
    npre = WAVE_PREFIX_CHUNKS * assign.INC_CHUNK
    pre = arr.pod_prefix(npre)
    inc_pre = IncState(cls=inc.cls[:npre].contiguous(), req_u=inc.req_u, stat_u=inc.stat_u, base_u=inc.base_u,
                       fit_u=inc.fit_u)
    ck = kernels.chunk_rounds(pre, inc_pre, cfg, arr.node_used, None, None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cp = assign.schedule_scan_chunked_plain(pre, cfg, inc_pre, arr.node_used, t0u, None)
    torch.cuda.synchronize()
    k6_plain = (time.perf_counter() - t0) * 1e3
    k6_err = sum(mismatch(a, b) for a, b in zip(ck[:3], cp[:3])) + abs(kernels.read_sweeps(ck[3]) - cp[3])
    check(k6_err == 0, f"north-star: chunk_rounds != plain on the first {WAVE_PREFIX_CHUNKS} chunks")
    check(torch.equal(ck[0], c_off[:npre]) and torch.equal(ck[2], o_off[:npre]), "chunk prefix != full run")
    k6_ms = cuda_ms(lambda: kernels.chunk_rounds(pre, inc_pre, cfg, arr.node_used, None, None), reps=5)
    k6_bytes = (4 * npre * R + npre + 4 * npre + 4 * N * R + 4 * U1 * R + 2 * 4 * U1 * W + 4 * U1 * N
                + 4 * N * R + 4 * npre + 4 * N * R + 4 * U1 * N + 4 * npre)
    # each pod's list is one selection over its class row; each stage-B
    # placement re-scores its column for every class
    k6_ops = npre * N + U1 * int((cp[0] >= 0).sum()) * per_score
    k6_bound, k6_by = bound(k6_bytes, k6_ops)
    print(f"[north-star-waves] chunk_rounds == plain on the first {WAVE_PREFIX_CHUNKS} chunks ({cp[3]} rounds): "
          f"{k6_ms:.3f} ms, plain {k6_plain:.1f} ms (host clock), bound {k6_bound:.5f} ms ({k6_by}); "
          f"all {P // assign.INC_CHUNK} chunks ({s_off} rounds): {k6_full_ms:.3f} ms", flush=True)

    # --- a warm cycle: the first 2048 pods' usage, patched columns ---
    arr2 = dataclasses.replace(arr, node_used=choices_used(arr, choices, 2048))
    kernels.reset_launches()
    inc2 = cache.ensure(arr2, meta, cfg)
    counted()
    check(cache.last["action"] == "patch" and kernels.LAUNCHES["class_usage_hoist"] == 1,
          f"warm cycle: action {cache.last['action']}, launches {kernels.LAUNCHES}")
    bf, ff = kernels.class_usage_hoist(inc2.req_u, arr2.node_used, arr2.node_alloc, cfg)
    check(same(inc2.base_u, bf) and same(inc2.fit_u, ff), "warm cycle: patched != a full hoist")
    dirty = cache.last["patched_cols"]
    cols = torch.full((incremental._round_up_pow2(dirty),), N, dtype=torch.int32, device=arr.device)
    cols[:dirty] = torch.nonzero((arr2.node_used != arr.node_used).any(dim=1)).flatten().to(torch.int32)
    bp, fp = incremental._patch_hoist_plain(inc.base_u, inc.fit_u, inc.req_u, arr2.node_used, arr.node_alloc,
                                            cols, cfg)
    check(same(inc2.base_u, bp) and same(inc2.fit_u, fp), "warm cycle: patched != plain patch")
    kp_ms = cuda_ms(lambda: kernels.class_usage_hoist(inc.req_u, arr2.node_used, arr.node_alloc, cfg, cols=cols,
                                                      base_u=inc.base_u, fit_u=inc.fit_u), reps=20, warmup=2)
    kp_card, kp_host = score_explain.card_host(
        lambda: kernels.class_usage_hoist(inc.req_u, arr2.node_used, arr.node_alloc, cfg, cols=cols,
                                          base_u=inc.base_u, fit_u=inc.fit_u), reps=50)
    c2, u2 = assign.schedule_batch(arr2, cfg, inc=inc2)
    c3, u3 = assign.schedule_batch(arr2, cfg)
    check(torch.equal(c2, c3) and torch.equal(u2, u3), "warm cycle: class-wave route != per-pod route")
    print(f"[north-star-waves] warm cycle: {dirty} dirty columns patched ({len(cols)} in the list) == a full "
          f"hoist == plain, {kp_ms:.4f} ms back to back ({kp_card:.4f} ms of card time, {kp_host:.1f} us host) with "
          f"the copy of the resident pair; route == per-pod route "
          f"({int((c2[:n] >= 0).sum())} scheduled)", flush=True)
    common = dict(route="cuda", library_ms=None)
    return [
        dict(name="class_static_hoist", source="kubernetes_tpu_torch/csrc/class_hoist.cu",
             replaces="kubernetes_tpu/ops/incremental.py:146", launches=launches["class_static_hoist"],
             max_abs_err=k3_err, ms=k3_ms, plain_ms=k3_plain, bound_ms=k3_bound, bound_by=k3_by, **common),
        dict(name="class_usage_hoist", source="kubernetes_tpu_torch/csrc/class_hoist.cu",
             replaces="kubernetes_tpu/ops/incremental.py:188", launches=launches["class_usage_hoist"],
             max_abs_err=k4_err, ms=k4_ms, card_ms=k4_card, host_us=k4_host, plain_ms=k4_plain,
             bound_ms=k4_bound, bound_by=k4_by, patch_ms=kp_ms, patch_card_ms=kp_card, patch_host_us=kp_host,
             **common),
        dict(name="wave_commit", source="kubernetes_tpu_torch/csrc/wave_commit.cu",
             replaces="kubernetes_tpu/ops/assign.py:530", launches=launches["wave_commit"],
             max_abs_err=k5_err, ms=k5_ms, plain_ms=k5_plain, bound_ms=k5_bound, bound_by=k5_by, **common),
        dict(name="chunk_rounds", source="kubernetes_tpu_torch/csrc/chunk_rounds.cu",
             replaces="kubernetes_tpu/ops/assign.py:1093", launches=launches["chunk_rounds"],
             max_abs_err=k6_err + sb_err, ms=sb_ms, plain_ms=sb_plain, bound_ms=sb_bound, bound_by=sb_by,
             scope="stage B after the wave, the class-wave step's default; card time", stage_b_bytes=sb_bytes,
             ms_back_to_back=sb_b2b,
             waves_off_prefix_ms=k6_ms, waves_off_prefix_plain_ms=k6_plain, waves_off_prefix_bound_ms=k6_bound,
             waves_off_prefix_scope=f"first {WAVE_PREFIX_CHUNKS} chunks", waves_off_all_chunks_ms=k6_full_ms,
             **common),
    ]


def dense_scored_pairs(arr, sfs, choices) -> int:
    """(pod, node) pairs the dense hoist scores: static bit set and fit
    against the usage at the pod's chunk start (rebuilt from the choices)."""
    import torch

    from kubernetes_tpu_torch.ops import assign, bitplane

    C = assign.CHUNK
    used = arr.node_used.clone()
    total = 0
    for c0 in range(0, arr.P, C):
        req = arr.pod_req[c0:c0 + C]
        sf = bitplane.unpack(sfs[c0:c0 + C], arr.N)
        fit = ((req[:, None, :] == 0) | (req[:, None, :] <= (arr.node_alloc - used)[None])).all(dim=2)
        total += int((sf & fit).sum())
        ch = choices[c0:c0 + C].to(torch.int64)
        m = ch >= 0
        used.index_add_(0, ch[m], req[m])
    return total


def phase_north_star_dense() -> list:
    import torch

    from kubernetes_tpu_torch.api.delta import DeltaEncoder
    from kubernetes_tpu_torch.bench import static_rows, workloads
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, infer_score_config, kernels

    snap = workloads.heterogeneous(**workloads.NORTH_STAR)
    enc = DeltaEncoder()
    on_c_path(enc._interner, "north-star-dense")
    t0 = time.perf_counter()
    host, meta = enc.encode(snap)
    t1 = time.perf_counter()
    arr, meta = enc.to_device(host, meta)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    print(f"[north-star-dense] cold DeltaEncoder encode_s {encode_s:.3f}: host encode {t1 - t0:.3f} s, "
          f"to_device {encode_s - (t1 - t0):.3f} s", flush=True)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    P, N, R = arr.P, arr.N, arr.R
    W = -(-N // 32)
    n = meta.n_pods

    def digest(x):
        return hashlib.sha256(x[:n].cpu().numpy().astype("<i4").tobytes()).hexdigest()

    # --- the dense route, counted ---
    kernels.reset_launches()
    t0 = time.perf_counter()
    choices, used, ords, sweeps = assign.schedule_batch_ordinals(arr, cfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counted()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if k in DENSE_KERNELS}
    check(all(v > 0 for v in launches.values()), f"a kernel of the dense route was not launched: {launches}")
    check(sum(kernels.LAUNCHES.values()) == sum(launches.values()), f"dense route launches {kernels.LAUNCHES}")
    scheduled = int((choices[:n] >= 0).sum())
    print(f"[north-star-dense] schedule_batch_ordinals (dense) "
          f"{first_s:.3f} s (first call): scheduled {scheduled}/{n}, sweeps {sweeps}, choices sha256 "
          f"{digest(choices)}, ordinals sha256 {digest(ords)}, launches {launches}", flush=True)
    check(scheduled == workloads.NORTH_STAR_SCHEDULED, "dense: scheduled count")
    check(digest(choices) == workloads.NORTH_STAR_CHOICES_SHA256, "dense: choices differ from JAX")
    check(sweeps == workloads.NORTH_STAR_DENSE_SWEEPS, f"dense: sweeps {sweeps}")
    check(digest(ords) == workloads.NORTH_STAR_DENSE_ORDINALS_SHA256, "dense: ordinals differ from JAX")
    step_dense_s = float("inf")
    for _ in range(3):  # bench.py's step_dense_s: the best of three
        t0 = time.perf_counter()
        c2, _ = assign.schedule_batch(arr, cfg)
        torch.cuda.synchronize()
        step_dense_s = min(step_dense_s, time.perf_counter() - t0)
    check(torch.equal(c2, choices), "dense: a repeated step differs")

    # --- K7 against plain over all [P, W] ---
    sfs = kernels.packed_static_rows(arr)
    sfs_p = assign.packed_static_rows_plain(arr)
    k7_err = mismatch(sfs, sfs_p)
    check(k7_err == 0, f"north-star: packed_static_rows != plain ({k7_err} words)")
    k7_ms = cuda_ms(lambda: kernels.packed_static_rows(arr), reps=10, warmup=2)
    k7_plain = cuda_ms(lambda: assign.packed_static_rows_plain(arr), reps=2)
    k7_bytes, k7_ops = static_rows.k7_work(arr, False)
    k7_bound, k7_by = bound(k7_bytes, k7_ops)
    print(f"[north-star-dense] packed_static_rows == plain over [{P}, {W}]: {k7_ms:.4f} ms, plain "
          f"{k7_plain:.3f} ms, bound {k7_bound:.4f} ms ({k7_by}: {k7_bytes} B)", flush=True)

    # --- K8 over all chunks, then against plain on the first chunks ---
    out = {}

    def run_k8():
        out["k"] = kernels.chunk_rounds_dense(arr, cfg, sfs)

    k8_ms = cuda_ms(run_k8, reps=3)
    ck = out["k"]
    check(torch.equal(ck[0], choices) and torch.equal(ck[2], ords), "dense: timed chunk_rounds_dense != route")
    npre = DENSE_PREFIX_CHUNKS * assign.CHUNK
    pre = arr.pod_prefix(npre)
    kp = kernels.chunk_rounds_dense(pre, cfg, sfs[:npre].contiguous())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pp = assign.schedule_scan_chunked_dense_plain(pre, cfg, sfs_p[:npre])
    torch.cuda.synchronize()
    k8_plain = (time.perf_counter() - t0) * 1e3
    k8_err = sum(mismatch(a, b) for a, b in zip(kp[:3], pp[:3])) + abs(kernels.read_sweeps(kp[3]) - pp[3])
    check(k8_err == 0, f"north-star: chunk_rounds_dense != plain on the first {DENSE_PREFIX_CHUNKS} chunks")
    check(torch.equal(kp[0], choices[:npre]) and torch.equal(kp[2], ords[:npre]), "dense prefix != full run")
    k8_pre_ms = cuda_ms(lambda: kernels.chunk_rounds_dense(pre, cfg, sfs[:npre].contiguous()), reps=5)
    scored = dense_scored_pairs(arr, sfs, choices)
    per_score = f32_ops_per_scored_node(cfg)
    k8_bytes = 4 * P * W + 4 * P * R + P + 3 * 4 * N * R + 2 * 4 * P
    # the hoist's fit test over every (pod, node), each scored pair's score,
    # and one list selection per pod over its row
    k8_ops = P * N * R + scored * per_score + P * N
    k8_bound, k8_by = bound(k8_bytes, k8_ops)
    print(f"[north-star-dense] chunk_rounds_dense == plain on the first {DENSE_PREFIX_CHUNKS} chunks "
          f"({pp[3]} rounds): {k8_pre_ms:.3f} ms, plain {k8_plain:.1f} ms (host clock); all {P // assign.CHUNK} "
          f"chunks ({sweeps} rounds): {k8_ms:.3f} ms ({k8_ms / (P // assign.CHUNK) * 1e3:.1f} us per chunk), "
          f"bound {k8_bound:.4f} ms ({k8_by}: {k8_bytes} B, {scored} scored pairs x {per_score} + "
          f"{P * N * (R + 1)} ops); step_dense_s {step_dense_s:.4f} (best of 3)", flush=True)
    common = dict(route="cuda", library_ms=None)
    return step_dense_s, (choices, meta), dict(arr=arr, meta=meta, used=used), [
        dict(name="packed_static_rows", source="kubernetes_tpu_torch/csrc/class_hoist.cu",
             replaces="kubernetes_tpu/ops/filters.py:92", launches=launches["packed_static_rows"],
             max_abs_err=k7_err, ms=k7_ms, plain_ms=k7_plain, bound_ms=k7_bound, bound_by=k7_by, **common),
        dict(name="chunk_rounds_dense", source="kubernetes_tpu_torch/csrc/chunk_rounds_dense.cu",
             replaces="kubernetes_tpu/ops/assign.py:1418", launches=launches["chunk_rounds_dense"],
             max_abs_err=k8_err, ms=k8_ms, plain_ms=k8_plain, bound_ms=k8_bound, bound_by=k8_by,
             plain_scope=f"first {DENSE_PREFIX_CHUNKS} chunks", prefix_ms=k8_pre_ms, **common),
    ]


def phase_warm_loop(cold) -> dict:
    """bench.py:283-327 at both depths; `cold` is the dense step's (choices,
    meta) of wave 1, whose decisions are the class-wave step's."""
    from kubernetes_tpu_torch.bench import workloads

    res = run_warm_loop("warm-loop", workloads.heterogeneous(**workloads.NORTH_STAR), cold,
                        workloads.NORTH_STAR_WARM_DIGESTS, workloads.NORTH_STAR_WARM_ACTIONS,
                        workloads.NORTH_STAR_SCHEDULED, WAVE_KERNELS, "class_waves")
    check(res[1]["overlap"] > 0.0, "warm loop: nothing overlapped at depth 1")
    return res


def run_warm_loop(tag, snap, cold, want_digests, want_actions, want_sched, need_kernels, route, mesh=None,
                  depths=(1, 0), waves_cls=None, want_stats=None) -> dict:
    """bench.py's warm waves 2..7 over `snap` through PipelinedBatchLoop at
    each of `depths` (1, then 0), each counted on its own: every wave's
    digest and the HoistCache action as the JAX loop's, every kernel of
    `need_kernels` launched, `route` taken by each of the six steps; on
    the node mesh `mesh` when given (the encoder and the loop take it).
    `waves_cls`: a factory of warm_waves' snapshot_cls, made anew for each
    depth (default Snapshot); `want_stats`: the encoder's full and delta
    counts after the cold encode and the six waves."""
    import torch

    from kubernetes_tpu_torch.api.delta import DeltaEncoder
    from kubernetes_tpu_torch.api.snapshot import Snapshot
    from kubernetes_tpu_torch.bench import workloads
    from kubernetes_tpu_torch.ops import assign, kernels
    from kubernetes_tpu_torch.parallel.pipeline import PipelinedBatchLoop

    choices, meta = cold
    first = workloads.verdicts_of(choices.cpu().numpy(), meta)
    names = [nd.name for nd in snap.nodes]
    res = {}
    for depth in depths:
        enc = DeltaEncoder(mesh=mesh)
        on_c_path(enc._interner, tag)
        enc.encode_device(snap)  # the cold encode the loop's encoder carries on from, as in bench.py
        torch.cuda.synchronize()
        loop = PipelinedBatchLoop(encoder=enc, depth=depth, mesh=mesh)
        kernels.reset_launches()
        assign.reset_trace_counts()
        waves, fetched, walls, submits = workloads.warm_waves(snap, first, loop.submit, loop.drain,
                                                              waves_cls() if waves_cls else Snapshot)
        torch.cuda.synchronize()
        launches = counted()
        routes = {k: v for k, v in assign.TRACE_COUNTS.items() if v}
        digests = {w: workloads.wave_digest(waves[w], fetched[w], names) for w in sorted(fetched) if w >= 2}
        actions = [h["action"] for h in loop.hoist.history]
        steady = sorted(walls[2:])
        end_to_end_s = steady[len(steady) // 2]  # bench.py:377-379
        delta_s = loop.host_seconds["encode"][0] / max(1, len(walls))
        overlap = loop.overlap_fraction()
        sched = [sum(1 for v in fetched[w].values() if v) for w in sorted(digests)]
        print(f"[{tag}] depth {depth}: walls {[round(x, 4) for x in walls]}, end_to_end_s {end_to_end_s:.4f} "
              f"(median of the steady walls), delta_s {delta_s:.4f} (encode + dispatch per cycle), "
              f"overlap_fraction {overlap:.3f}, host seconds {loop.host_seconds}, encoder {enc.stats}, "
              f"scheduled {sched}, launches {launches}, routes {routes}", flush=True)
        cycles = len(walls)
        split = {k: round(v / cycles, 4) for k, v in loop.phase_seconds.items()}
        caller = sum(a - b for a, b in zip(walls, submits)) / cycles
        print(f"[{tag}] depth {depth}: per cycle, host seconds: caller feedback (mk_wave + place) "
              f"{caller:.4f}, in submit {sum(submits) / cycles:.4f} = {split}", flush=True)
        for w in sorted(digests):
            print(f"[{tag}] depth {depth} wave {w}: HoistCache {actions[w - 2]} "
                  f"(patched columns {loop.hoist.history[w - 2]['patched_cols']}), choices {digests[w]}", flush=True)
        check(digests == want_digests, f"{tag} depth {depth}: choices differ from JAX")
        check(actions == want_actions, f"{tag} depth {depth}: HoistCache actions {actions}")
        check(enc.stats["delta"] >= 3, f"{tag}: delta path did not engage: {enc.stats}")
        if want_stats is not None:
            check({k: enc.stats[k] for k in want_stats} == want_stats, f"{tag}: encoder {enc.stats}")
        check(all(x == want_sched for x in sched), f"{tag}: scheduled {sched}")
        check(routes.get(route, 0) == len(walls), f"{tag} depth {depth}: routes {routes}")
        for k in need_kernels:
            check(launches.get(k, 0) > 0, f"{tag} depth {depth}: {k} was not launched: {launches}")
        res[depth] = dict(digests=digests, end_to_end_s=end_to_end_s, delta_s=delta_s, overlap=overlap,
                          walls=walls)
    if 0 in res and 1 in res:
        check(res[0]["digests"] == res[1]["digests"], f"{tag}: depth 0 != depth 1")
    if 0 in res:
        check(res[0]["overlap"] == 0.0, f"{tag}: overlap_fraction {res[0]['overlap']} at depth 0")
    return res


def mesh_step(tag, arr, cfg, mesh, need, inc=None) -> tuple:
    """One counted step on the mesh: launches of exactly `need`, the route's
    outputs and its best-of-two step_s (host clock to a synchronise)."""
    import torch

    from kubernetes_tpu_torch.ops import assign, kernels

    kernels.reset_launches()
    assign.reset_trace_counts()
    out = assign.schedule_batch_ordinals(arr, cfg, inc=inc, mesh=mesh)
    torch.cuda.synchronize()
    launches = counted()
    routes = {k: v for k, v in assign.TRACE_COUNTS.items() if v}
    check(set(launches) == set(need), f"{tag}: launches {launches}, want {need}")
    check(routes.get("sharded_chunked_inc" if inc is not None else "sharded_chunked") == 1, f"{tag}: routes {routes}")
    step_s = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        assign.schedule_batch(arr, cfg, inc=inc, mesh=mesh)
        torch.cuda.synchronize()
        step_s = min(step_s, time.perf_counter() - t0)
    return out, launches, routes, step_s


def phase_mesh_north_star(used_sha: str) -> list:
    """The north star on make_mesh(4) and make_mesh(3): the dense and the
    class-wave step, each counted on its own, against the single-device
    digests; K17 and the per-shard K3 / K4 / K7 against their plain versions."""
    import torch

    from kubernetes_tpu_torch.api.delta import DeltaEncoder
    from kubernetes_tpu_torch.bench import score_explain, workloads
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, bitplane, incremental, infer_score_config
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.ops.incremental import HoistCache
    from kubernetes_tpu_torch.parallel.collectives import all_gather_nodes
    from kubernetes_tpu_torch.parallel.mesh import make_mesh

    snap = workloads.heterogeneous(**workloads.NORTH_STAR)
    host, meta = DeltaEncoder().encode(snap)
    n = meta.n_pods
    N0 = host.N

    def sha(x):
        return hashlib.sha256(x.cpu().numpy().astype("<i4").tobytes()).hexdigest()

    stitch = {"launches": 0}
    for S in (4, 3):
        mesh = make_mesh(S)
        enc = DeltaEncoder(mesh=mesh)
        t0 = time.perf_counter()
        arr, _ = enc.to_device(host, meta)
        torch.cuda.synchronize()
        place_s = time.perf_counter() - t0
        cfg = infer_score_config(host, DEFAULT_SCORE_CONFIG)
        N, nl = arr.N, arr.nl
        tag = f"mesh-north-star S={S}"
        print(f"[mesh-north-star] {mesh}: N {N0} -> {N} ({N - N0} pad nodes), nl {nl}, node-axis fields resident "
              f"per shard (to_device {place_s:.3f} s)", flush=True)
        check(repr(mesh) == f"NodeMesh({S} shards on 1 card)", f"mesh repr {mesh!r}")
        # --- the dense step ---
        (c, u, o, sw), la, routes, dense_s = mesh_step(tag + " dense", arr, cfg, mesh, MESH_DENSE_KERNELS)
        check(la["packed_static_rows"] == S and la["stitch_planes"] == 1 and la["chunk_rounds_dense"] == 1,
              f"{tag} dense: launches {la}")
        stitch["launches"] += la["stitch_planes"]
        check(sha(c[:n]) == workloads.NORTH_STAR_CHOICES_SHA256, f"{tag} dense: choices differ from JAX")
        check(sw == workloads.NORTH_STAR_DENSE_SWEEPS, f"{tag} dense: sweeps {sw}")
        check(sha(o[:n]) == workloads.NORTH_STAR_DENSE_ORDINALS_SHA256, f"{tag} dense: ordinals differ from JAX")
        check(sha(u[:N0]) == used_sha and not u[N0:].any(), f"{tag} dense: usage != the single-device step's")
        print(f"[mesh-north-star] S={S} dense: sweeps {sw}, choices/ordinals/usage == single device, launches "
              f"{la}, step_s {dense_s:.4f} (best of 2)", flush=True)
        # --- the class-wave step ---
        kernels.reset_launches()
        t0 = time.perf_counter()
        hc = HoistCache(mesh=mesh)
        inc = hc.ensure(arr, meta, cfg, host=host)
        torch.cuda.synchronize()
        ensure_s = time.perf_counter() - t0
        hoist_la = counted()
        check(hoist_la == {"class_static_hoist": S, "class_usage_hoist": S, "stitch_planes": 2},
              f"{tag}: HoistCache launches {hoist_la}")
        check(inc.req_u.shape[0] == workloads.NORTH_STAR_CLASSES and inc.base_u.shape[1] == N, f"{tag}: IncState")
        (c, u, o, sw), la, routes, wave_s = mesh_step(tag + " waves", arr, cfg, mesh, ("wave_commit", "chunk_rounds"),
                                                      inc=inc)
        check(routes.get("class_waves") == 1, f"{tag} waves: routes {routes}")
        stitch["launches"] += hoist_la["stitch_planes"]
        check(sha(c[:n]) == workloads.NORTH_STAR_CHOICES_SHA256, f"{tag} waves: choices differ from JAX")
        check(sw == workloads.NORTH_STAR_WAVE_SWEEPS, f"{tag} waves: sweeps {sw}")
        check(sha(o[:n]) == workloads.NORTH_STAR_WAVE_ORDINALS_SHA256, f"{tag} waves: ordinals differ from JAX")
        check(sha(u[:N0]) == used_sha and not u[N0:].any(), f"{tag} waves: usage != the single-device step's")
        print(f"[mesh-north-star] S={S} class waves: HoistCache.ensure {ensure_s:.4f} s ({hc.last['action']}, "
              f"launches {hoist_la}), sweeps {sw}, choices/ordinals/usage == single device, step launches {la}, "
              f"step_s {wave_s:.4f} (best of 2; the ensure not included)", flush=True)
        # --- the kernels against their plain versions on this mesh's shapes ---
        r_u = torch.as_tensor(meta.class_first_pod, device=arr.device)
        err = 0
        for j, sh in enumerate(arr.shards):
            base = mesh.base(j, N)
            if j == S - 1:  # one shard's K7 (~40 ms of plain each), the last: the largest base
                err += mismatch(kernels.packed_static_rows(sh, base=base),
                                assign.packed_static_rows_plain(sh, base=base))
            err += mismatch(inc.shards[j].stat_u,
                            incremental._static_hoist_plain(incremental.class_view(sh, r_u), base=base)[0])
            bp, fp = incremental._usage_hoist_plain(inc.req_u, sh.node_used, sh.node_alloc, cfg)
            err += mismatch(inc.shards[j].base_u, bp) + mismatch(inc.shards[j].fit_u, fp)
        check(err == 0, f"{tag}: per-shard K3 / K4 / K7 != plain ({err} entries)")
        tiled = all_gather_nodes([x.stat_u for x in inc.shards], 1, arr.device)
        k17_err = mismatch(kernels.stitch_planes(tiled, nl), bitplane.stitch_planes_plain(tiled, nl))
        check(k17_err == 0 and same(inc.stat_u, kernels.stitch_planes(tiled, nl)), f"{tag}: stitch_planes != plain")
        print(f"[mesh-north-star] S={S}: per-shard class_static_hoist, class_usage_hoist, packed_static_rows (shard "
              f"{S - 1}, base {mesh.base(S - 1, N)}) == plain; stitch_planes == plain on the class planes "
              f"[{tiled.shape[0]}, {tiled.shape[1]}] -> {inc.stat_u.shape[1]} words"
              + (" (nl % 32 == 0: the two layouts coincide, the kernel was a copy)" if nl % 32 == 0 else ""),
              flush=True)
        if S == 3:
            blocks = [kernels.packed_static_rows(sh, base=mesh.base(j, N)) for j, sh in enumerate(arr.shards)]
            big = all_gather_nodes(blocks, 1, arr.device)
            del blocks
            flat = kernels.stitch_planes(big, nl)
            rows = big.shape[0]
            for r0 in range(0, rows, STITCH_PLAIN_ROWS):
                k17_err += mismatch(flat[r0:r0 + STITCH_PLAIN_ROWS],
                                    bitplane.stitch_planes_plain(big[r0:r0 + STITCH_PLAIN_ROWS], nl))
            check(k17_err == 0, f"{tag}: stitch_planes != plain on the dense rows ({k17_err} words)")
            k17_ms = cuda_ms(lambda: kernels.stitch_planes(big, nl), reps=20, warmup=2)

            def plain_all():
                for r0 in range(0, rows, STITCH_PLAIN_ROWS):
                    bitplane.stitch_planes_plain(big[r0:r0 + STITCH_PLAIN_ROWS], nl)

            k17_plain = cuda_ms(plain_all, reps=1)
            k17_small = cuda_ms(lambda: kernels.stitch_planes(tiled, nl), reps=50, warmup=2)
            k17_card, k17_host = score_explain.card_host(lambda: kernels.stitch_planes(big, nl), reps=20)
            k17_small_card = score_explain.card_host(lambda: kernels.stitch_planes(tiled, nl), reps=50)[0]
            k17_bytes = 4 * rows * (big.shape[1] + flat.shape[1])
            k17_bound, k17_by = bound(k17_bytes, rows * flat.shape[1] * 8)
            print(f"[mesh-north-star] stitch_planes == plain on the dense static rows [{rows}, {big.shape[1]}] -> "
                  f"[{rows}, {flat.shape[1]}]: {k17_ms:.4f} ms back to back, {k17_card:.4f} ms of card time, "
                  f"{k17_host:.1f} us host, plain {k17_plain:.2f} ms (blocks of {STITCH_PLAIN_ROWS} rows), bound "
                  f"{k17_bound:.5f} ms ({k17_by}: {k17_bytes} B); on the class planes {k17_small:.4f} ms back to "
                  f"back, {k17_small_card:.4f} of card time", flush=True)
            stitch.update(max_abs_err=k17_err, ms=k17_ms, card_ms=k17_card, host_us=k17_host, plain_ms=k17_plain,
                          bound_ms=k17_bound, bound_by=k17_by, class_planes_ms=k17_small,
                          class_planes_card_ms=k17_small_card, shape=f"[{rows}, {big.shape[1]}] nl={nl}")
            del big, flat
        del arr, inc, hc
        torch.cuda.empty_cache()
    launches = stitch.pop("launches")
    return [dict(name="stitch_planes", route="cuda", source="kubernetes_tpu_torch/csrc/stitch_planes.cu",
                 replaces="kubernetes_tpu/ops/assign.py:1000-1010 (tiled all_gather of packed planes, "
                          "ops/bitplane.py:100-175)",
                 launches=launches, library_ms=None, **stitch)]


def phase_mesh_warm_loop(cold, single) -> None:
    """bench.py's warm loop at depth 1 on make_mesh(4), then once more on one
    device, beside [warm-loop]'s (host time drifts within a run, so the
    two forms run in turns: one device, the mesh, one device)."""
    from kubernetes_tpu_torch.bench import workloads
    from kubernetes_tpu_torch.parallel.mesh import make_mesh

    snap = workloads.heterogeneous(**workloads.NORTH_STAR)
    want = (cold, workloads.NORTH_STAR_WARM_DIGESTS, workloads.NORTH_STAR_WARM_ACTIONS,
            workloads.NORTH_STAR_SCHEDULED)
    res = run_warm_loop("mesh-warm-loop", snap, *want, MESH_WAVE_KERNELS, "sharded_chunked_inc", mesh=make_mesh(4),
                        depths=(1,))
    again = run_warm_loop("mesh-warm-loop single", snap, *want, WAVE_KERNELS, "class_waves", depths=(1,))
    print(f"[mesh-warm-loop] end_to_end_s {res[1]['end_to_end_s']:.4f} on 4 shards; one device "
          f"{single[1]['end_to_end_s']:.4f} before it ([warm-loop]) and {again[1]['end_to_end_s']:.4f} after it; "
          f"delta_s {res[1]['delta_s']:.4f} / {single[1]['delta_s']:.4f} / {again[1]['delta_s']:.4f}", flush=True)


def ring_hop_ops(sel, kind, lab) -> int:
    """Operations one ring_match hop does on these inputs: 2 per label
    (compare and add) for each expression csrc/ring_match.cu evaluates --
    the non-PAD expressions of a (term, row) up to and including its first
    failing one (the kernel's loop ends there)."""
    import torch

    counts = torch.einsum("sel,bl->seb", (sel != 0).double().cpu(), (lab != 0).double().cpu())
    k = kind.cpu()[:, :, None]
    ok = torch.where(k == 1, counts > 0, torch.where(k == 2, counts == 0, k == 0)).int()
    through = torch.cumprod(ok, dim=1)  # every expression ok up to and including e
    reached = torch.cat([torch.ones_like(through[:, :1]), through[:, :-1]], dim=1).bool()
    return 2 * sel.shape[2] * int((reached & (k != 0)).sum())


def config3_match_inputs():
    """BASELINE config 3's selector x pod-label match (spread_affinity(5000,
    10000)): the batch's distinct pairwise terms against its pods' label
    rows as api/pairwise.py match_inputs lowers them, and _match_matrix's
    answer."""
    import torch

    from kubernetes_tpu_torch.api.delta import _pod_pairwise_terms
    from kubernetes_tpu_torch.api.pairwise import _match_matrix, match_inputs
    from kubernetes_tpu_torch.bench import workloads

    pods = workloads.spread_affinity(5000, 10000, seed=0).pending_pods
    terms = {}
    for pod in pods:
        aff, anti, pref, spread = _pod_pairwise_terms(pod)
        for k in (*aff, *anti, *(x[0] for x in pref), *(x[0] for x in spread)):
            terms.setdefault(k, None)
    terms = list(terms)
    sel, kind, labels = (torch.from_numpy(x) for x in match_inputs(terms, pods))
    return sel, kind, labels, torch.from_numpy(_match_matrix(terms, pods)).bool()


def phase_ring() -> list:
    """ring_match of the north star's selector terms against its node labels
    on 4 shards (exactness), then of BASELINE config 3's 80 terms against
    its 10000 pod label rows on 4 shards (K16's row: the matrix the ring
    exists for); all_to_all_pods_to_nodes of a config-3-sized plane."""
    import torch

    from kubernetes_tpu_torch.api.snapshot import encode_snapshot
    from kubernetes_tpu_torch.bench import score_explain, workloads
    from kubernetes_tpu_torch.ops import filters, kernels
    from kubernetes_tpu_torch.parallel import all_to_all_pods_to_nodes, make_mesh, ring_match
    from kubernetes_tpu_torch.parallel.ring import match_block_plain

    d = 4
    mesh = make_mesh(d)
    cpu_mesh = make_mesh(d, devices="cpu")
    arr, _ = encode_snapshot(workloads.heterogeneous(**workloads.NORTH_STAR))
    S0, E, L = arr.sel_mask.shape
    S = -(-S0 // d) * d
    sel = torch.zeros((S, E, L), dtype=torch.float32, device=arr.device)
    sel[:S0] = arr.sel_mask.float()
    kind = torch.zeros((S, E), dtype=torch.int32, device=arr.device)  # pad terms: PAD kinds (always true)
    kind[:S0] = arr.sel_kind
    labels = arr.node_labels.float()
    kernels.reset_launches()
    tiles = ring_match(sel, kind, labels, mesh)
    torch.cuda.synchronize()
    counted()
    ns_launches = kernels.LAUNCHES["ring_match"]
    check(ns_launches == d * d and sum(kernels.LAUNCHES.values()) == ns_launches,
          f"ring: launches {kernels.LAUNCHES}")
    got = torch.cat(tiles)
    plain = torch.cat(ring_match(sel.cpu(), kind.cpu(), labels.cpu(), cpu_mesh))
    tm = filters.term_match(arr.sel_mask, arr.sel_kind, arr.node_labels)
    ns_err = mismatch(got.cpu(), plain) + mismatch(got[:S0], tm)
    check(ns_err == 0 and bool(got[S0:].all()), "ring: ring_match != the plain ring / the dense term match")
    # one hop at the north star's shape: shard 0's terms x one node label block
    ns_hop = (sel[:S // d].contiguous(), kind[:S // d].contiguous(), labels[:labels.shape[0] // d].contiguous())
    ns_hop_err = mismatch(kernels.ring_match(*ns_hop), match_block_plain(*ns_hop))
    check(ns_hop_err == 0, "ring: one north-star ring_match hop != plain")
    ns_hop_card = card_ms(lambda: kernels.ring_match(*ns_hop), reps=200)
    print(f"[ring] north star: ring_match on {mesh}: node-selector terms {S0} padded to {S}, E={E}, L={L}, "
          f"node label rows {labels.shape[0]}: {ns_launches} ring_match launches == the plain ring == the dense "
          f"term match; one hop [{S // d}, {E}, {L}] x [{labels.shape[0] // d}, {L}] == plain, "
          f"{ns_hop_card:.4f} ms of card time", flush=True)
    del arr, sel, kind, labels, tiles, got, ns_hop

    t0 = time.perf_counter()
    sel, kind, labels, dense = config3_match_inputs()
    build_s = time.perf_counter() - t0
    S, E, L = sel.shape
    P = labels.shape[0]
    check(S == 80 and P == 10000, f"ring: config 3 gave {S} terms x {P} pods, not 80 x 10000")
    plain = torch.cat(ring_match(sel, kind, labels, cpu_mesh))
    sel, kind, labels = sel.cuda(), kind.cuda(), labels.cuda()
    kernels.reset_launches()
    tiles = ring_match(sel, kind, labels, mesh)
    torch.cuda.synchronize()
    counted()
    launches = kernels.LAUNCHES["ring_match"]
    check(launches == d * d and sum(kernels.LAUNCHES.values()) == launches, f"ring: launches {kernels.LAUNCHES}")
    got = torch.cat(tiles).cpu()
    k16_err = ns_err + mismatch(got, plain) + mismatch(got, dense)
    check(k16_err == 0, "ring: config 3 ring_match != the plain ring / the host match matrix")
    # one hop at the ring's shape: shard 0's terms x one pod label block
    sl, pl = S // d, P // d
    hs, hk, hl = sel[:sl].contiguous(), kind[:sl].contiguous(), labels[:pl].contiguous()
    hop_err = mismatch(kernels.ring_match(hs, hk, hl), match_block_plain(hs, hk, hl))
    check(hop_err == 0, "ring: one ring_match hop != plain")
    k16_ms = cuda_ms(lambda: kernels.ring_match(hs, hk, hl), reps=200, warmup=5)
    k16_card, k16_host = score_explain.card_host(lambda: kernels.ring_match(hs, hk, hl), reps=200)
    k16_plain = cuda_ms(lambda: match_block_plain(hs, hk, hl), reps=20, warmup=2)
    lib_ms = cuda_ms(lambda: torch.einsum("sel,bl->seb", hs, hl), reps=200, warmup=5)
    lib_card = score_explain.card_host(lambda: torch.einsum("sel,bl->seb", hs, hl), reps=200)[0]
    k16_ops = ring_hop_ops(hs, hk, hl)
    k16_bytes = 4 * (sl * E * L + sl * E + pl * L) + sl * pl
    k16_bound, k16_by = bound(k16_bytes, k16_ops)
    ring_ms = cuda_ms(lambda: ring_match(sel, kind, labels, mesh), reps=20, warmup=2)
    print(f"[ring] config 3: {S} terms x {P} pod label rows (E={E}, L={L}; built on the host in {build_s:.3f} s), "
          f"{dense.sum().item()} matches: ring_match on {mesh}: {launches} ring_match launches == the plain ring "
          f"== the host match matrix (api/pairwise.py _match_matrix); the whole ring {ring_ms:.4f} ms; one hop "
          f"[{sl}, {E}, {L}] x [{pl}, {L}]: {k16_ms:.4f} ms back to back ({k16_card:.4f} ms of card time, queued "
          f"behind a sleep; host {k16_host:.1f} us a call), plain {k16_plain:.4f} ms, torch.einsum of the counts "
          f"{lib_ms:.4f} ms ({lib_card:.4f} card), bound "
          f"{k16_bound:.6f} ms ({k16_by}: {k16_bytes} B, {k16_ops} operations evaluated of "
          f"{2 * sl * E * L * pl} at most)", flush=True)
    del sel, kind, labels, tiles, hs, hk, hl
    x = torch.randn((10240, 6144), generator=torch.Generator().manual_seed(0)).to("cuda")
    blocks = all_to_all_pods_to_nodes(x, mesh)
    torch.cuda.synchronize()
    check(all(tuple(b.shape) == (10240, 6144 // d) for b in blocks), "all_to_all: block shapes")
    check(torch.equal(torch.cat(blocks, dim=1), x), "all_to_all: values not preserved")
    a2a_ms = cuda_ms(lambda: all_to_all_pods_to_nodes(x, mesh), reps=10, warmup=2)
    print(f"[ring] all_to_all_pods_to_nodes of [10240, 6144] f32 on {mesh}: values preserved, node-sharded "
          f"blocks [10240, {6144 // d}]; {a2a_ms:.4f} ms (on one card the pod blocks are row views of the "
          f"plane, the exchange reads and writes {2 * x.numel() * 4 / 1e6:.0f} MB)", flush=True)
    return [dict(name="ring_match", route="cuda", source="kubernetes_tpu_torch/csrc/ring_match.cu",
                 replaces="kubernetes_tpu/parallel/ring.py:35 (_eval_block, in ring_match :47)", launches=launches,
                 max_abs_err=k16_err + hop_err + ns_hop_err, ms=k16_ms, plain_ms=k16_plain, bound_ms=k16_bound,
                 bound_by=k16_by,
                 library_ms=lib_ms, card_ms=k16_card, host_us=k16_host, library_card_ms=lib_card, ring_ms=ring_ms,
                 a2a_ms=a2a_ms, north_star_hop_card_ms=ns_hop_card, shape=f"[{sl}, {E}, {L}] x [{pl}, {L}]")]


def phase_wide_planes() -> list:
    import torch

    from kubernetes_tpu_torch.api.delta import DeltaEncoder
    from kubernetes_tpu_torch.bench import gang_unpack, score_explain, workloads
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, bitplane, infer_score_config, kernels, schedule_batch

    snap = workloads.wide_taints(**workloads.WIDE_TAINTS)
    enc = DeltaEncoder()
    host, meta = enc.encode(snap)
    kernels.reset_launches()
    arr, meta = enc.to_device(host, meta)
    torch.cuda.synchronize()
    counted()
    launches = kernels.LAUNCHES["unpack_planes"]
    wide = ("node_taint_ns", "pod_tol_ns", "node_taint_pref", "pod_tol_pref")
    check(launches == len(wide), f"wide planes: unpack_planes launched {launches} times ({', '.join(wide)})")
    for name in wide:
        check(torch.equal(getattr(arr, name).cpu(), torch.from_numpy(getattr(host, name))),
              f"wide planes: {name} unpacked != host")
    words = torch.from_numpy(bitplane.np_pack_lastaxis(host.pod_tol_ns).view("int32")).cuda()
    n_w = host.pod_tol_ns.shape[1]
    k9_err = mismatch(kernels.unpack_planes(words, n_w), bitplane.unpack(words, n_w))
    check(k9_err == 0, "wide planes: unpack_planes != plain")
    k9_b2b = cuda_ms(lambda: kernels.unpack_planes(words, n_w), reps=50, warmup=3)
    k9_ms, k9_host = score_explain.card_host(lambda: kernels.unpack_planes(words, n_w), reps=50)
    k9_plain = cuda_ms(lambda: bitplane.unpack(words, n_w), reps=10)
    rows = words.shape[0]
    k9_bytes, k9_ops = gang_unpack.k9_work(rows, n_w)
    k9_bound, k9_by = bound(k9_bytes, k9_ops)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    choices, _ = schedule_batch(arr, cfg)
    c = choices[: meta.n_pods].cpu().numpy().astype("<i4")
    scheduled = int((c >= 0).sum())
    check(scheduled == workloads.WIDE_TAINTS_SCHEDULED, f"wide planes: scheduled {scheduled}")
    check(hashlib.sha256(c.tobytes()).hexdigest() == workloads.WIDE_TAINTS_CHOICES_SHA256,
          "wide planes: choices differ from JAX")
    print(f"[wide-planes] {len(snap.nodes)} nodes, {meta.n_pods} pods, {n_w} hard taints: node_taint_ns "
          f"{tuple(arr.node_taint_ns.shape)}, pod_tol_ns {tuple(arr.pod_tol_ns.shape)} and their "
          f"PreferNoSchedule twins sent packed, "
          f"unpack_planes x{launches} == host == plain; scheduled {scheduled}/{meta.n_pods}, choices == JAX; "
          f"unpack_planes [{rows}, {n_w}]: {k9_ms:.4f} ms of card time, {k9_host:.1f} us host a call "
          f"({k9_b2b:.4f} ms back to back), plain {k9_plain:.4f} ms, bound {k9_bound:.6f} ms "
          f"({k9_by}: {k9_bytes} B)", flush=True)
    return [dict(name="unpack_planes", route="cuda", source="kubernetes_tpu_torch/csrc/unpack_planes.cu",
                 replaces="kubernetes_tpu/api/delta.py:922", launches=launches, max_abs_err=k9_err, ms=k9_ms,
                 plain_ms=k9_plain, bound_ms=k9_bound, bound_by=k9_by, library_ms=None, host_us=k9_host,
                 b2b_ms=k9_b2b)]


def full_bytes(arr) -> int:
    """Bytes the full-stage scans must move: every input read once (the two
    packed planes, the pod arrays and slots, the node arrays and the
    per-domain count tables), every output written once."""
    P, N = arr.P, arr.N
    W = -(-N // 32)
    pod = sum(getattr(arr, f).numel() * getattr(arr, f).element_size() for f in (
        "pod_req", "pod_valid", "pod_spread_terms", "pod_spread_maxskew", "pod_spread_hard", "pod_aff_terms",
        "pod_aff_self", "pod_anti_terms", "pod_match_terms", "pod_match_vals", "pod_pref_aff_terms",
        "pod_pref_aff_w", "pod_ports"))
    node = sum(getattr(arr, f).numel() * getattr(arr, f).element_size() for f in (
        "node_alloc", "node_used", "node_dom", "term_key", "term_counts0", "anti_counts0", "pref_own0",
        "node_ports0"))
    img = arr.image_score.numel() * 2 if arr.image_score.shape[1] == N else 0
    return 2 * 4 * P * W + pod + node + img + 3 * 4 * P + arr.node_used.numel() * 4


def full_ops(arr, cfg, sfs, eligs, choices) -> tuple:
    """(operations, scored pairs): the work a sequential full-stage scan
    must do on this run's data, real pods and nodes only.  A scored pair is
    a (pod, node) pair that passes the static and fit tests against the
    usage the earlier pods left (rebuilt from the choices).  Per scored
    pair: the fit and balanced scores; 4 per hard spread slot (count + 1 -
    min, the compare, the raw sum) and 1 per soft one; 1 per required
    affinity and anti-affinity slot; 2 per matched slot (the existing pods'
    anti-affinity) and, with the inter-pod score on, 2 per preferred and
    matched slot; 2 per host port; 6 per normalised stage the pod's data
    needs (the reduction, the formula's 3, the weighted add): taint where
    cfg scores it, node affinity for a pod with preferred terms, spread for
    a pod with a spread slot, inter-pod for one with a preferred or matched
    slot; 2 for the image score.  Per pod: the fit test over the real
    nodes' resources, each hard spread slot's minimum over the eligible
    nodes with its key and, when placed, the commit over the real nodes (2
    per matched and anti-affinity slot; with the inter-pod score 2 per
    preferred slot and hardPodAffinityWeight affinity slot; 1 per port)."""
    import torch

    from kubernetes_tpu_torch.ops import assign, bitplane

    dev = arr.device
    P, N, R = arr.P, arr.N, arr.R
    n_nodes = int(arr.node_valid.sum())
    pw = bool(cfg.enable_pairwise)
    ips = pw and bool(cfg.enable_interpod_score)
    zero = torch.zeros((P,), dtype=torch.int64, device=dev)

    def count(mask):
        return mask.sum(dim=1).to(torch.int64)

    on_sp = (arr.pod_spread_terms >= 0) & arr.pod_spread_hard
    hard = count(on_sp) if pw else zero
    soft = count((arr.pod_spread_terms >= 0) & ~arr.pod_spread_hard) if pw else zero
    aff = count(arr.pod_aff_terms >= 0) if pw else zero
    anti = count(arr.pod_anti_terms >= 0) if pw else zero
    match = count(arr.pod_match_terms >= 0) if pw else zero
    pref = count(arr.pod_pref_aff_terms >= 0) if ips else zero
    ports = count(arr.pod_ports) if cfg.enable_ports else zero
    na = count(arr.pod_pref_terms >= 0) if cfg.enable_node_pref else zero
    stages = ((na > 0).to(torch.int64) + (hard + soft > 0).to(torch.int64) + int(bool(cfg.enable_taint_score))
              + ((pref + match > 0).to(torch.int64) if ips else zero))
    per_pair = (f32_ops_per_scored_node(cfg) + 4 * hard + soft + aff + anti + 2 * match
                + (2 * (pref + match) if ips else zero) + 2 * ports + 6 * stages
                + 2 * int(assign._image_on(arr, cfg)))
    hpaw = aff if ips and cfg.hard_pod_affinity_weight else zero
    placed = (choices >= 0).to(torch.int64)
    valid = arr.pod_valid.to(torch.int64)
    per_pod = (valid * n_nodes * R + placed * (2 * n_nodes * (match + anti + (pref + hpaw if ips else zero)) + ports))
    dbt, D = assign.dom_by_term(arr)
    has_key = dbt < D
    used = arr.node_used.clone()
    scored = torch.zeros((P,), dtype=torch.int64, device=dev)
    for p0 in range(0, P, 256):
        req = arr.pod_req[p0:p0 + 256]
        sf = bitplane.unpack(sfs[p0:p0 + 256], N)
        if pw:  # the hard spread minimum: eligible nodes with the slot's key
            el = bitplane.unpack(eligs[p0:p0 + 256], N)
            for s in range(on_sp.shape[1]):
                hk = has_key[torch.clamp_min(arr.pod_spread_terms[p0:p0 + 256, s], 0).to(torch.int64)]
                per_pod[p0:p0 + 256] += count(el & hk) * on_sp[p0:p0 + 256, s]
        for k in range(req.shape[0]):
            fit = ((req[k] == 0) | (req[k] <= arr.node_alloc - used)).all(dim=1)
            scored[p0 + k] = (sf[k] & fit).sum()
            c = int(choices[p0 + k])
            if c >= 0:
                used[c] += req[k]
    return int((scored * per_pair).sum() + per_pod.sum()), int(scored.sum())


def same_state(a: dict, b: dict) -> int:
    """Entries of the pairwise state {cnt, anti, pref, total, ports} that
    differ (f32 compared as bits)."""
    return sum(mismatch(a[k], b[k]) for k in ("cnt", "anti", "pref", "total", "ports"))


def phase_config3() -> tuple:
    """BASELINE config 3 through the rounds route (the card's default for a
    pairwise config): K7 with the eligibility plane, then K12."""
    import torch

    from kubernetes_tpu_torch.api.delta import DeltaEncoder
    from kubernetes_tpu_torch.bench import workloads
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, infer_score_config, kernels

    snap = workloads.spread_affinity(**workloads.CONFIG3)
    enc = DeltaEncoder()
    on_c_path(enc._interner, "config3")
    t0 = time.perf_counter()
    host, meta = enc.encode(snap)
    t1 = time.perf_counter()
    arr, meta = enc.to_device(host, meta)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    P, N, R = arr.P, arr.N, arr.R
    T, D1 = arr.term_counts0.shape
    n = meta.n_pods
    check(cfg.enable_pairwise and cfg.enable_interpod_score and not cfg.enable_ports, f"config 3: {cfg}")
    print(f"[config3] cold DeltaEncoder encode_s {encode_s:.3f} (host {t1 - t0:.3f} s): P={P} N={N} R={R} "
          f"T={T} D={D1 - 1} slots spread/aff/anti/pref/match {arr.pod_spread_terms.shape[1]}/"
          f"{arr.pod_aff_terms.shape[1]}/{arr.pod_anti_terms.shape[1]}/{arr.pod_pref_aff_terms.shape[1]}/"
          f"{arr.pod_match_terms.shape[1]}", flush=True)

    def digest(x):
        return hashlib.sha256(x[:n].cpu().numpy().astype("<i4").tobytes()).hexdigest()

    kernels.reset_launches()
    t0 = time.perf_counter()
    choices, used, ords, sweeps = assign.schedule_batch_ordinals(arr, cfg)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = counted()
    check(launches == {"packed_static_rows": 1, "rounds": 1}, f"config 3 rounds route launches {launches}")
    scheduled = int((choices[:n] >= 0).sum())
    print(f"[config3] schedule_batch_ordinals (rounds) {first_s:.3f} s (first call): scheduled {scheduled}/{n}, "
          f"sweeps {sweeps}, choices sha256 {digest(choices)}, ordinals sha256 {digest(ords)}, "
          f"launches {launches}", flush=True)
    check(scheduled == workloads.CONFIG3_SCHEDULED, "config 3: scheduled count")
    check(digest(choices) == workloads.CONFIG3_CHOICES_SHA256, "config 3: choices differ from JAX")
    check(sweeps == workloads.CONFIG3_ROUNDS_SWEEPS, f"config 3: sweeps {sweeps}")
    check(digest(ords) == workloads.CONFIG3_ROUNDS_ORDINALS_SHA256, "config 3: ordinals differ from JAX")
    step_rounds_s = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        c2, _ = assign.schedule_batch(arr, cfg)
        torch.cuda.synchronize()
        step_rounds_s = min(step_rounds_s, time.perf_counter() - t0)
    check(torch.equal(c2, choices), "config 3: a repeated step differs")

    # --- K7's two planes against plain over [P, W] ---
    sfs, eligs = kernels.packed_static_rows(arr, with_elig=True)
    sfs_p, eligs_p = assign.packed_static_rows_plain(arr, with_elig=True)
    k7_err = mismatch(sfs, sfs_p) + mismatch(eligs, eligs_p)
    check(k7_err == 0, f"config 3: packed_static_rows (with eligibility) != plain ({k7_err} words)")

    # --- K12 over all chunks, then against plain on the first chunks ---
    out = {}

    def run_k12():
        out["k"] = kernels.rounds(arr, cfg, sfs, eligs, (None, None))

    k12_ms = cuda_ms(run_k12, reps=3)
    ck = out["k"]
    check(torch.equal(ck[0], choices) and torch.equal(ck[2], ords), "config 3: timed rounds != route")
    npre = ROUNDS_PREFIX_CHUNKS * assign.RCHUNK
    pre = arr.pod_prefix(npre)
    kp = kernels.rounds(pre, cfg, sfs[:npre].contiguous(), eligs[:npre].contiguous(), (None, None),
                        with_state=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pp = assign.schedule_scan_rounds_plain(pre, cfg, sfs_p[:npre], eligs_p[:npre], (None, None), with_state=True)
    torch.cuda.synchronize()
    k12_plain = (time.perf_counter() - t0) * 1e3
    k12_err = (sum(mismatch(a, b) for a, b in zip(kp[:3], pp[:3])) + abs(kernels.read_sweeps(kp[3]) - pp[3])
               + same_state(kp[4], pp[4]))
    check(k12_err == 0, f"config 3: rounds != plain on the first {ROUNDS_PREFIX_CHUNKS} chunks ({k12_err})")
    check(torch.equal(kp[0], choices[:npre]) and torch.equal(kp[2], ords[:npre]), "config 3 prefix != full run")
    k12_pre_ms = cuda_ms(lambda: kernels.rounds(pre, cfg, sfs[:npre].contiguous(), eligs[:npre].contiguous(),
                                                (None, None)), reps=3)
    k_ops, scored = full_ops(arr, cfg, sfs, eligs, choices)
    k_bytes = full_bytes(arr)
    k12_bound, k12_by = bound(k_bytes, k_ops)
    print(f"[config3] packed_static_rows (static + eligibility) == plain over [{P}, {-(-N // 32)}] x 2; "
          f"rounds == plain on the first {ROUNDS_PREFIX_CHUNKS} chunks ({pp[3]} rounds; choices, usage, "
          f"ordinals, count planes): {k12_pre_ms:.3f} ms, plain {k12_plain:.1f} ms (host clock); all "
          f"{P // assign.RCHUNK} chunks ({sweeps} rounds): {k12_ms:.3f} ms ({k12_ms / sweeps * 1e3:.1f} us per "
          f"round), bound {k12_bound:.4f} ms ({k12_by}: {k_bytes} B, {k_ops} ops over {scored} scored pairs); "
          f"step_rounds_s {step_rounds_s:.4f} (best of 3)", flush=True)
    row = dict(name="rounds", route="cuda", source="kubernetes_tpu_torch/csrc/rounds.cu",
               replaces="kubernetes_tpu/ops/assign.py:1464", launches=launches["rounds"], max_abs_err=k12_err,
               ms=k12_ms, plain_ms=k12_plain, bound_ms=k12_bound, bound_by=k12_by, library_ms=None,
               plain_scope=f"first {ROUNDS_PREFIX_CHUNKS} chunks", prefix_ms=k12_pre_ms)
    return (arr, meta, cfg, choices, sfs, eligs, sfs_p, eligs_p, k_ops), step_rounds_s, row


def phase_config3_perpod(c3) -> tuple:
    """The same arrays through the per-pod route (chunked=False): K7, then
    K11 over all pods."""
    import torch

    from kubernetes_tpu_torch.bench import workloads
    from kubernetes_tpu_torch.ops import assign, bitplane, kernels

    arr, meta, cfg, rchoices, sfs, eligs, sfs_p, eligs_p, k_ops = c3
    P, N = arr.P, arr.N
    n = meta.n_pods
    kernels.reset_launches()
    t0 = time.perf_counter()
    choices, used = assign.schedule_batch(arr, cfg, chunked=False)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = counted(default=False)
    check(launches == {"packed_static_rows": 1, "full_scan": 1}, f"config 3 per-pod route launches {launches}")
    digest = hashlib.sha256(choices[:n].cpu().numpy().astype("<i4").tobytes()).hexdigest()
    print(f"[config3-perpod] schedule_batch(chunked=False) {first_s:.3f} s (first call): scheduled "
          f"{int((choices[:n] >= 0).sum())}/{n}, choices sha256 {digest}, launches {launches}", flush=True)
    check(digest == workloads.CONFIG3_CHOICES_SHA256, "config 3 per-pod: choices differ from JAX")
    check(torch.equal(choices, rchoices), "config 3: per-pod route != rounds route")
    step_perpod_s = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        c2, _ = assign.schedule_batch(arr, cfg, chunked=False)
        torch.cuda.synchronize()
        step_perpod_s = min(step_perpod_s, time.perf_counter() - t0)
    check(torch.equal(c2, choices), "config 3 per-pod: a repeated step differs")
    k11_ms = cuda_ms(lambda: kernels.full_scan(arr, cfg, sfs, eligs, (None, None)), reps=2)
    k11_kc = kernels.LAST_CLUSTER["full_scan"]
    # the scan's floor: the same launch with every static bit clear
    empty = torch.zeros_like(sfs)
    floor_ms = cuda_ms(lambda: kernels.full_scan(arr, cfg, empty, eligs, (None, None)), reps=2)
    del empty
    pre = arr.pod_prefix(PERPOD_PREFIX)
    kp = kernels.full_scan(pre, cfg, sfs[:PERPOD_PREFIX].contiguous(), eligs[:PERPOD_PREFIX].contiguous(),
                           (None, None), with_state=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pp = assign.schedule_scan_plain(pre, cfg, sf=bitplane.unpack(sfs_p[:PERPOD_PREFIX], N), planes=(None, None),
                                    with_state=True)
    torch.cuda.synchronize()
    k11_plain = (time.perf_counter() - t0) * 1e3
    k11_err = mismatch(kp[0], pp[0]) + mismatch(kp[1], pp[1]) + same_state(kp[2], pp[2])
    check(k11_err == 0, f"config 3: full_scan != plain on the first {PERPOD_PREFIX} pods ({k11_err})")
    check(torch.equal(kp[0], choices[:PERPOD_PREFIX]), "config 3 per-pod prefix != full run")
    k_bytes = full_bytes(arr)
    k11_bound, k11_by = bound(k_bytes, k_ops)
    print(f"[config3-perpod] full_scan == plain on the first {PERPOD_PREFIX} pods (choices, usage, count "
          f"planes); kernel {k11_ms:.3f} ms over all {P} ({k11_ms / P * 1e3:.2f} us per pod, one cluster of "
          f"{k11_kc} blocks; with no feasible node {floor_ms:.3f} ms, {floor_ms / P * 1e3:.2f} us per pod), plain "
          f"{k11_plain:.1f} ms on {PERPOD_PREFIX} pods (host clock), bound {k11_bound:.4f} ms ({k11_by}); "
          f"step_perpod_s {step_perpod_s:.4f} (best of 2)", flush=True)
    row = dict(name="full_scan", route="cuda", source="kubernetes_tpu_torch/csrc/full_scan.cu",
               replaces="kubernetes_tpu/ops/assign.py:181", launches=launches["full_scan"], max_abs_err=k11_err,
               ms=k11_ms, plain_ms=k11_plain, bound_ms=k11_bound, bound_by=k11_by, library_ms=None,
               plain_scope=f"first {PERPOD_PREFIX} pods", kc=k11_kc, floor_ms=floor_ms)
    return step_perpod_s, row


def phase_perpod_small() -> None:
    """A scheduling cycle of 8 pending pods through schedule_batch, the
    card's default route, on the north star's and on config 3's nodes:
    exact launch counts, == the plain route on the CPU, the step's wall;
    then the same cycle on make_mesh(4) (K1 x 4 + K2 in shard mode, or K7 x
    4 + K11 in shard mode): == the one-device cycle and the JAX digest."""
    import torch

    from kubernetes_tpu_torch.api.snapshot import encode_snapshot
    from kubernetes_tpu_torch.bench import workloads
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, infer_score_config, kernels, schedule_batch
    from kubernetes_tpu_torch.parallel import mesh as tm

    for tag, snap in (("north star", workloads.heterogeneous(**workloads.NORTH_STAR)),
                      ("config 3", workloads.spread_affinity(**workloads.CONFIG3))):
        snap = dataclasses.replace(snap, pending_pods=snap.pending_pods[:workloads.PERPOD_SMALL_PODS])
        arr, meta = encode_snapshot(snap)
        cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
        kernels.reset_launches()
        choices, used = schedule_batch(arr, cfg)
        torch.cuda.synchronize()
        launches = counted()
        fit = tag == "north star"
        want = ({"static_feasible": 1, "fit_scan": 1} if fit else
                {"packed_static_rows": 1, "full_scan": 1,
                 **({"score_planes": 1} if cfg.enable_taint_score or cfg.enable_node_pref else {})})
        check(arr.P == workloads.PERPOD_SMALL_PODS and launches == want,
              f"perpod-small {tag}: P={arr.P}, launches {launches}")
        digest = hashlib.sha256(choices[:meta.n_pods].cpu().numpy().astype("<i4").tobytes()).hexdigest()
        check(digest == workloads.PERPOD_SMALL_CHOICES_SHA256[tag], f"perpod-small {tag}: choices differ from JAX")
        arr_cpu, _ = encode_snapshot(snap, device="cpu")
        cp, up = schedule_batch(arr_cpu, infer_score_config(arr_cpu, DEFAULT_SCORE_CONFIG), device="cpu")
        check(torch.equal(choices.cpu(), cp) and torch.equal(used.cpu(), up), f"perpod-small {tag}: card != CPU")
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            c2, _ = schedule_batch(arr, cfg)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        check(torch.equal(c2, choices), f"perpod-small {tag}: a repeated step differs")
        kc = kernels.LAST_CLUSTER["fit_scan" if fit else "full_scan"]
        print(f"[perpod-small] {tag}: P={arr.P} ({meta.n_pods} pending) N={arr.N}, launches {launches}, "
              f"{'fit_scan' if fit else 'full_scan'} one cluster of {kc} blocks; choices {choices.tolist()} (the JAX "
              f"digest) and usage == the plain route on the CPU; step wall "
              f"{min(walls) * 1e3:.3f} ms (best of 3; {[round(w * 1e3, 3) for w in walls]})", flush=True)
        # the same cycle on a node mesh of 4 shards: the shard mode of the per-pod scan
        m = tm.make_mesh(4)
        mtag = f"perpod-small {tag} {m}"
        mkey = "fit_scan_shard" if fit else "full_scan_shard"
        per = {k: 4 for k in want if not k.endswith("_scan")} | {mkey: 1}
        (mc, mu), ml, m_first = sharded_counted(mtag, lambda: schedule_batch(arr, cfg, mesh=m), per, "sharded_plain")
        digest_m = hashlib.sha256(mc[:meta.n_pods].cpu().numpy().astype("<i4").tobytes()).hexdigest()
        check(digest_m == workloads.PERPOD_SMALL_CHOICES_SHA256[tag], f"{mtag}: choices differ from JAX")
        check(torch.equal(mc, choices) and torch.equal(mu[:arr.N], used) and not mu[arr.N:].any(),
              f"{mtag}: != the one-device cycle")
        mwalls = []
        for _ in range(3):
            t0 = time.perf_counter()
            schedule_batch(arr, cfg, mesh=m)
            torch.cuda.synchronize()
            mwalls.append(time.perf_counter() - t0)
        print(f"[perpod-small] {tag} on {m}: launches {ml}, {mkey} one cluster of {kernels.LAST_CLUSTER[mkey]} "
              f"blocks over the 4 shards' nodes; choices (the JAX digest) and usage == the one-device cycle; "
              f"first call {m_first:.3f} s, step wall {min(mwalls) * 1e3:.3f} ms (best of 3)", flush=True)


def phase_k1_pinned() -> dict:
    """K1 at a label vocabulary as wide as the cluster: the pinned gang wave
    gang_pinned('perpod-fit') (P = 8, N = 6144, L = 5000: a hostname In over
    a pool of config 3's 5000 nodes) as one fit-only cycle through
    schedule_batch, the card's default route, counted (K1 + K2), == the
    plain route on the CPU; K1 == plain; its back-to-back, card and host
    time a call, its device operations a call (at most its two launches),
    the term match's library call (torch.einsum of the float masks alone)
    and the bound."""
    import torch

    from kubernetes_tpu_torch.api.delta import DeltaEncoder
    from kubernetes_tpu_torch.bench import score_explain
    from kubernetes_tpu_torch.bench import workloads as w
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, filters, infer_score_config, kernels, schedule_batch

    snap = w.gang_pinned("perpod-fit")
    arr, meta = DeltaEncoder().encode_device(snap)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    P, N, L = arr.P, arr.N, arr.sel_mask.shape[2]
    check((P, N, L) == (8, 6144, 5000), f"k1-pinned: P={P} N={N} L={L}")
    kernels.reset_launches()
    choices, used = schedule_batch(arr, cfg)
    torch.cuda.synchronize()
    launches = counted()
    check(launches == {"static_feasible": 1, "fit_scan": 1}, f"k1-pinned: launches {launches}")
    arr_cpu, _ = DeltaEncoder(device="cpu").encode_device(snap)
    cp, up = schedule_batch(arr_cpu, infer_score_config(arr_cpu, DEFAULT_SCORE_CONFIG), device="cpu")
    check(torch.equal(choices.cpu(), cp) and torch.equal(used.cpu(), up), "k1-pinned: card != the CPU route")
    sf = kernels.static_feasible(arr)
    t0 = time.perf_counter()
    sf_p = filters.static_feasible_plain(arr)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = mismatch(sf, sf_p)
    check(err == 0, "k1-pinned: static_feasible kernel != plain")
    ms = cuda_ms(lambda: kernels.static_feasible(arr), reps=100, warmup=5)
    card, host = score_explain.card_host(lambda: kernels.static_feasible(arr), reps=100)
    ops = k1_calls_checked(lambda: kernels.static_feasible(arr), "k1-pinned")
    lib_ms, lib_card = term_match_library([arr], reps=100)
    b, by = bound(*k1_work(arr))
    print(f"[k1-pinned] gang_pinned('perpod-fit'): P={P} N={N} L={L}, {int(arr.sel_mask.sum())} literals; "
          f"schedule_batch launches {launches}, choices {choices[:meta.n_pods].tolist()} == the CPU route; "
          f"static_feasible == plain: {ms:.4f} ms back to back, {card:.4f} ms of card time, host {host:.1f} us a "
          f"call, {ops} device operations a call; the term match's torch.einsum {lib_ms:.4f} ms ({lib_card:.4f} "
          f"card); plain {plain_ms:.3f} ms (host clock); bound {b:.6f} ms ({by})", flush=True)
    return dict(name="static_feasible (wide vocabulary)", route="cuda",
                source="kubernetes_tpu_torch/csrc/static_feasible.cu", replaces="kubernetes_tpu/ops/filters.py:81",
                launches=launches["static_feasible"], max_abs_err=err, ms=ms, card_ms=card, host_us=host,
                plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=lib_ms, library_card_ms=lib_card,
                device_ops=ops, shape=f"P={P} N={N} L={L}")


def phase_all_stages() -> list:
    """Every optional stage on: K10 == plain on both planes, and the rounds
    and per-pod routes (K7, K10, K12 / K11) == plain and == the JAX
    package's digests."""
    import torch

    from kubernetes_tpu_torch.api.snapshot import encode_snapshot
    from kubernetes_tpu_torch.bench import score_explain, workloads
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, filters, incremental, infer_score_config, kernels
    from kubernetes_tpu_torch.ops.incremental import HoistCache, class_view

    arr, meta = encode_snapshot(workloads.all_stages())
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    check(all((cfg.enable_pairwise, cfg.enable_ports, cfg.enable_taint_score, cfg.enable_node_pref,
               cfg.enable_image, cfg.enable_interpod_score)), f"all stages: {cfg}")
    P, N = arr.P, arr.N
    n = meta.n_pods

    def digest(x):
        return hashlib.sha256(x[:n].cpu().numpy().astype("<i4").tobytes()).hexdigest()

    # --- the rounds route, counted ---
    kernels.reset_launches()
    choices, used, ords, sweeps = assign.schedule_batch_ordinals(arr, cfg)
    torch.cuda.synchronize()
    launches = counted()
    check(launches == {"packed_static_rows": 1, "score_planes": 1, "rounds": 1}, f"all stages rounds {launches}")
    check(int((choices[:n] >= 0).sum()) == workloads.ALL_STAGES_SCHEDULED, "all stages: scheduled count")
    check(digest(choices) == workloads.ALL_STAGES_CHOICES_SHA256, "all stages: choices differ from JAX")
    check(sweeps == workloads.ALL_STAGES_ROUNDS_SWEEPS, f"all stages: sweeps {sweeps}")
    check(digest(ords) == workloads.ALL_STAGES_ROUNDS_ORDINALS_SHA256, "all stages: ordinals differ from JAX")
    # --- the per-pod route, counted ---
    kernels.reset_launches()
    pchoices, pused = assign.schedule_batch(arr, cfg, chunked=False)
    torch.cuda.synchronize()
    plaunch = counted(default=False)  # chunked=False
    check(plaunch == {"packed_static_rows": 1, "score_planes": 1, "full_scan": 1}, f"all stages per-pod {plaunch}")
    check(torch.equal(pchoices, choices) and torch.equal(pused, used), "all stages: per-pod route != rounds route")
    # --- the rounds route on class state, counted: K3 (with eligibility), K10 over the class view, K4, K12 ---
    kernels.reset_launches()
    assign.reset_trace_counts()
    inc = HoistCache().ensure(arr, meta, cfg)
    ic, iu, io, i_s = assign.schedule_batch_ordinals(arr, cfg, inc=inc)
    torch.cuda.synchronize()
    ilaunch = counted()
    check(ilaunch == {"class_static_hoist": 1, "score_planes": 1, "class_usage_hoist": 1, "rounds": 1},
          f"all stages class state: launches {ilaunch}")
    check(assign.TRACE_COUNTS["rounds_inc"] == 1, f"all stages class state: routes {assign.TRACE_COUNTS}")
    check(torch.equal(ic, choices) and torch.equal(iu, used) and torch.equal(io, ords) and i_s == sweeps,
          "all stages: the class-state rounds route != the dense rounds route")
    r_u = torch.as_tensor(meta.class_first_pod, device=arr.device)
    cv = class_view(arr, r_u)
    planes_p = incremental._static_hoist_plain(cv, True, True, True)
    k10u_err = sum(mismatch(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                            b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
                   for a, b in zip((inc.stat_u, inc.elig_u, inc.traw_u, inc.naraw_u), planes_p))
    check(k10u_err == 0, f"all stages: class planes (K3 with eligibility, K10 over the class view) != plain "
          f"({k10u_err})")
    check(same(inc.img_u, arr.image_score[r_u]), "all stages: img_u != the class rows of image_score")
    k10u_ms = cuda_ms(lambda: kernels.score_planes(cv), reps=20, warmup=2)
    k10u_card, k10u_host = score_explain.card_host(lambda: kernels.score_planes(cv), reps=50)

    # --- K10 against plain, bit for bit on both planes ---
    traw, naraw = kernels.score_planes(arr)
    traw_p, naraw_p = assign.score_planes_plain(arr)
    k10_err = mismatch(traw.view(torch.int16), traw_p.view(torch.int16)) + mismatch(
        naraw.view(torch.int16), naraw_p.view(torch.int16))
    check(k10_err == 0, f"all stages: score_planes != plain ({k10_err} entries)")
    k10_ms = cuda_ms(lambda: kernels.score_planes(arr), reps=20, warmup=2)
    # back to back the wrapper's host call paces a launch this small: card and host time apart
    k10_card, k10_host = score_explain.card_host(lambda: kernels.score_planes(arr), reps=50)
    k10_plain = cuda_ms(lambda: assign.score_planes_plain(arr), reps=5)
    tm = filters.term_match(arr.sel_mask, arr.sel_kind, arr.node_labels).to(torch.float32)
    S = tm.shape[0]
    W_na = torch.zeros((P, S), dtype=torch.float32, device=arr.device)
    ids = torch.clamp_min(arr.pod_pref_terms, 0).to(torch.int64)
    W_na.index_put_((torch.arange(P, device=arr.device)[:, None].expand_as(ids), ids),
                    torch.where(arr.pod_pref_terms >= 0, arr.pod_pref_weights, torch.zeros_like(arr.pod_pref_weights)),
                    accumulate=True)
    k10_lib = cuda_ms(lambda: torch.matmul(W_na, tm), reps=20, warmup=2)
    k10_lib_card = score_explain.card_host(lambda: torch.matmul(W_na, tm), reps=50)[0]
    # the whole function in the fewest torch calls: both f32 products, each cast to bf16
    tolf = (~arr.pod_tol_pref).to(torch.float32)
    taint_t = arr.node_taint_pref.to(torch.float32).T.contiguous()

    def whole():
        return torch.matmul(tolf, taint_t).to(torch.bfloat16), torch.matmul(W_na, tm).to(torch.bfloat16)

    check(all(torch.equal(a.view(torch.int16), b.view(torch.int16)) for a, b in zip(whole(), (traw, naraw))),
          "all stages: the torch products != score_planes")
    k10_whole = cuda_ms(whole, reps=20, warmup=2)
    k10_whole_card = score_explain.card_host(whole, reps=50)[0]
    k10_bytes, k10_ops = score_explain.k10_work(arr)
    k10_bound, k10_by = bound(k10_bytes, k10_ops)

    # --- K12 and K11 against plain over the whole snapshot ---
    sfs, eligs = kernels.packed_static_rows(arr, with_elig=True)
    kr = kernels.rounds(arr, cfg, sfs, eligs, (traw, naraw), with_state=True)
    pr = assign.schedule_scan_rounds_plain(arr, cfg, sfs, eligs, (traw, naraw), with_state=True)
    k12_err = (sum(mismatch(a, b) for a, b in zip(kr[:3], pr[:3])) + abs(kernels.read_sweeps(kr[3]) - pr[3])
               + same_state(kr[4], pr[4]))
    check(k12_err == 0, f"all stages: rounds != plain ({k12_err})")
    kf = kernels.full_scan(arr, cfg, sfs, eligs, (traw, naraw), with_state=True)
    pf = assign.schedule_scan_plain(arr, cfg, sf=filters.static_feasible_plain(arr), planes=(traw, naraw),
                                    with_state=True)
    k11_err = mismatch(kf[0], pf[0]) + mismatch(kf[1], pf[1]) + same_state(kf[2], pf[2])
    check(k11_err == 0, f"all stages: full_scan != plain ({k11_err})")
    check(torch.equal(kf[0], choices), "all stages: full_scan != the route")
    print(f"[all-stages] P={P} N={N}, every stage on: rounds route ({launches}) and per-pod route ({plaunch}): "
          f"scheduled {int((choices[:n] >= 0).sum())}/{n}, choices, sweeps ({sweeps}) and ordinals == JAX; "
          f"rounds == plain and full_scan == plain (choices, usage, ordinals, count planes); score_planes == "
          f"plain on both bf16 planes: {k10_ms:.4f} ms back to back, {k10_card:.4f} ms of card time, "
          f"{k10_host:.1f} us of host time a call; plain {k10_plain:.4f} ms; torch.matmul of the node-affinity "
          f"product {k10_lib:.4f} ms ({k10_lib_card:.4f} of card time), the whole function in torch (two "
          f"products cast to bf16) {k10_whole:.4f} ms ({k10_whole_card:.4f}); bound {k10_bound:.6f} ms "
          f"({k10_by}: {k10_bytes} B); class state ({ilaunch}): the same choices, usage, ordinals and sweeps, "
          f"every class plane == plain, score_planes over the class view [{inc.req_u.shape[0]}, {N}] "
          f"{k10u_ms:.4f} ms ({k10u_card:.4f} of card time, {k10u_host:.1f} us host)", flush=True)
    return [dict(name="score_planes", route="cuda", source="kubernetes_tpu_torch/csrc/score_planes.cu",
                 replaces="kubernetes_tpu/ops/scores.py:229", launches=launches["score_planes"],
                 max_abs_err=k10_err, ms=k10_ms, card_ms=k10_card, host_us=k10_host, plain_ms=k10_plain,
                 bound_ms=k10_bound, bound_by=k10_by, library_ms=k10_lib, library_card_ms=k10_lib_card,
                 library_whole_ms=k10_whole, library_whole_card_ms=k10_whole_card,
                 class_view_ms=k10u_ms, class_view_card_ms=k10u_card)], (k11_err, k12_err)


def phase_config3_inc(c3) -> tuple:
    """Config 3's cold step with class state: HoistCache.ensure (K3 with the
    eligibility words, K4), then the rounds route in class mode (K12
    class-row mode alone)."""
    import torch

    from kubernetes_tpu_torch.bench import score_explain, workloads
    from kubernetes_tpu_torch.ops import assign, incremental, kernels
    from kubernetes_tpu_torch.ops.incremental import HoistCache, class_view

    arr, meta, cfg, rchoices, sfs, eligs, sfs_p, eligs_p, k_ops = c3
    P, N = arr.P, arr.N
    n = meta.n_pods

    def digest(x):
        return hashlib.sha256(x[:n].cpu().numpy().astype("<i4").tobytes()).hexdigest()

    kernels.reset_launches()
    assign.reset_trace_counts()
    t0 = time.perf_counter()
    cache = HoistCache()
    inc = cache.ensure(arr, meta, cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    choices, used, ords, sweeps = assign.schedule_batch_ordinals(arr, cfg, inc=inc)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = counted()
    routes = {k: v for k, v in assign.TRACE_COUNTS.items() if v}
    U1 = inc.req_u.shape[0]
    print(f"[config3-inc] HoistCache.ensure {t1 - t0:.3f} s ({cache.last['action']}; U1={U1}, planes "
          f"{[k for k in ('elig_u', 'traw_u', 'naraw_u', 'img_u') if getattr(inc, k) is not None]}), "
          f"schedule_batch_ordinals(inc) {t2 - t1:.3f} s (first call): scheduled {int((choices[:n] >= 0).sum())}/{n}, "
          f"sweeps {sweeps}, choices sha256 {digest(choices)}, ordinals sha256 {digest(ords)}, launches {launches}, "
          f"routes {routes}", flush=True)
    check(launches == {"class_static_hoist": 1, "class_usage_hoist": 1, "rounds": 1},
          f"config 3 inc: launches {launches}")
    check(routes == {"rounds_inc": 1}, f"config 3 inc: routes {routes}")
    check(U1 == workloads.CONFIG3_CLASSES, f"config 3 inc: U1 {U1}")
    check(int((choices[:n] >= 0).sum()) == workloads.CONFIG3_SCHEDULED, "config 3 inc: scheduled count")
    check(digest(choices) == workloads.CONFIG3_CHOICES_SHA256, "config 3 inc: choices differ from JAX")
    check(sweeps == workloads.CONFIG3_ROUNDS_SWEEPS, f"config 3 inc: sweeps {sweeps}")
    check(digest(ords) == workloads.CONFIG3_ROUNDS_ORDINALS_SHA256, "config 3 inc: ordinals differ from JAX")
    check(torch.equal(choices, rchoices), "config 3 inc: class state != dense rounds route")
    step_rounds_inc_s = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        c2, _ = assign.schedule_batch(arr, cfg, inc=cache.ensure(arr, meta, cfg))
        torch.cuda.synchronize()
        step_rounds_inc_s = min(step_rounds_inc_s, time.perf_counter() - t0)
    check(torch.equal(c2, choices) and cache.last["action"] == "hit", "config 3 inc: a repeated step differs")

    # --- K3 with the eligibility words against plain over [U1, W] x 2 ---
    r_u = torch.as_tensor(meta.class_first_pod, device=arr.device)
    stat_p, elig_p, _, _ = incremental._static_hoist_plain(class_view(arr, r_u), True, False, False)
    k3_err = mismatch(inc.stat_u, stat_p) + mismatch(inc.elig_u, elig_p)
    check(k3_err == 0, f"config 3 inc: class_static_hoist (with eligibility) != plain ({k3_err} words)")
    k3_ms = cuda_ms(lambda: kernels.class_static_hoist(arr, r_u, with_elig=True), reps=20, warmup=2)
    k3_plain = cuda_ms(lambda: incremental._static_hoist_plain(class_view(arr, r_u), True, False, False), reps=5)
    T, TT = arr.node_taint_ns.shape[1], arr.pod_terms.shape[1]
    S, E_, L = arr.sel_mask.shape
    W = -(-N // 32)
    k3_bytes = N * (1 + T + L) + U1 * (T + 1 + 4 + 4 * TT + 8) + S * E_ * L + 4 * S * E_ + 2 * 4 * U1 * W
    k3_bound, k3_by = bound(k3_bytes, U1 * N * (3 + T + TT))
    # --- K4 at config 3's class state, the largest full hoist the port runs ---
    base_p, fit_p = incremental._usage_hoist_plain(inc.req_u, arr.node_used, arr.node_alloc, cfg)
    k4_err = mismatch(inc.base_u, base_p) + mismatch(inc.fit_u, fit_p)
    check(k4_err == 0, f"config 3 inc: class_usage_hoist != plain ({k4_err} entries)")
    del base_p, fit_p
    k4_card, k4_host = score_explain.card_host(
        lambda: kernels.class_usage_hoist(inc.req_u, arr.node_used, arr.node_alloc, cfg), reps=20)
    R = arr.R
    k4_bound = bound(4 * U1 * R + 2 * 4 * N * R + 4 * U1 * N + 4 * U1 * W, U1 * N * f32_ops_per_scored_node(cfg))
    print(f"[config3-inc] class_usage_hoist == plain over [{U1}, {N}], R={R}: {k4_card:.4f} ms of card time, "
          f"{k4_host:.1f} us host a call, bound {k4_bound[0]:.6f} ms ({k4_bound[1]})", flush=True)
    k4_c3 = dict(config3_card_ms=k4_card, config3_host_us=k4_host, config3_bound_ms=k4_bound[0],
                 config3_shape=f"[{U1}, {N}] R={R}", max_abs_err=k4_err)

    # --- K12 class-row mode: == dense K12 == plain on the first chunks, then timed in turns with dense ---
    npre = ROUNDS_PREFIX_CHUNKS * assign.RCHUNK
    pre = arr.pod_prefix(npre)
    inc_pre = inc._replace(cls=inc.cls[:npre].contiguous())
    ki = kernels.rounds(pre, cfg, inc=inc_pre, with_state=True)
    kd = kernels.rounds(pre, cfg, sfs[:npre].contiguous(), eligs[:npre].contiguous(), (None, None), with_state=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pi = assign.schedule_scan_rounds_plain(pre, cfg, inc=inc_pre, with_state=True)
    torch.cuda.synchronize()
    k12i_plain = (time.perf_counter() - t0) * 1e3
    ksw = kernels.read_sweeps(ki[3])
    k12i_err = (sum(mismatch(a, b) for a, b in zip(ki[:3], pi[:3])) + abs(ksw - pi[3]) + same_state(ki[4], pi[4])
                + sum(mismatch(a, b) for a, b in zip(ki[:3], kd[:3])) + abs(ksw - kernels.read_sweeps(kd[3]))
                + same_state(ki[4], kd[4]))
    check(k12i_err == 0, f"config 3 inc: rounds (class rows) != plain / dense on the first {ROUNDS_PREFIX_CHUNKS} "
          f"chunks ({k12i_err})")
    out = {}

    def run_inc():
        out["i"] = kernels.rounds(arr, cfg, inc=inc)

    def run_dense():
        out["d"] = kernels.rounds(arr, cfg, sfs, eligs, (None, None))

    dense_a = cuda_ms(run_dense, reps=2)
    inc_a = cuda_ms(run_inc, reps=2)
    inc_b = cuda_ms(run_inc, reps=2)
    dense_b = cuda_ms(run_dense, reps=2)
    k12i_ms = (inc_a + inc_b) / 2
    check(torch.equal(out["i"][0], choices) and torch.equal(out["i"][2], ords), "config 3 inc: timed rounds != route")
    k12_bytes = full_bytes(arr) - 2 * 4 * P * W + 2 * 4 * U1 * W + 4 * P  # class planes and the class index
    k12_bound, k12_by = bound(k12_bytes, k_ops)
    print(f"[config3-inc] class_static_hoist (with eligibility) == plain over [{U1}, {W}] x 2: {k3_ms:.4f} ms, "
          f"plain {k3_plain:.4f} ms, bound {k3_bound:.6f} ms ({k3_by}); rounds class-row mode == plain == dense on "
          f"the first {ROUNDS_PREFIX_CHUNKS} chunks ({pi[3]} rounds; plain {k12i_plain:.1f} ms, host clock); all "
          f"chunks, in turns dense {dense_a:.3f} / class rows {inc_a:.3f} / class rows {inc_b:.3f} / dense "
          f"{dense_b:.3f} ms, bound {k12_bound:.4f} ms ({k12_by}); step_rounds_inc_s {step_rounds_inc_s:.4f} "
          f"(best of 3, ensure hit included)", flush=True)
    rows = [dict(name="class_static_hoist+elig", route="cuda", source="kubernetes_tpu_torch/csrc/class_hoist.cu",
                 replaces="kubernetes_tpu/ops/incremental.py:146", launches=launches["class_static_hoist"],
                 max_abs_err=k3_err, ms=k3_ms, plain_ms=k3_plain, bound_ms=k3_bound, bound_by=k3_by,
                 library_ms=None),
            dict(name="rounds_class_rows", route="cuda", source="kubernetes_tpu_torch/csrc/rounds.cu",
                 replaces="kubernetes_tpu/ops/assign.py:1464", launches=launches["rounds"], max_abs_err=k12i_err,
                 ms=k12i_ms, plain_ms=k12i_plain, bound_ms=k12_bound, bound_by=k12_by, library_ms=None,
                 plain_scope=f"first {ROUNDS_PREFIX_CHUNKS} chunks", dense_ms=(dense_a + dense_b) / 2)]
    return (choices, meta), step_rounds_inc_s, rows, k4_c3


def phase_config3_warm(cold) -> dict:
    """Config 3's warm loop: bench.py's waves 2..7 over spread_affinity(5000,
    10000) at depth 1 and 0, each step on the rounds route with class state
    (K3 and K4 in the HoistCache, K12 in class-row mode)."""
    from kubernetes_tpu_torch.bench import workloads

    return run_warm_loop("config3-warm", workloads.spread_affinity(**workloads.CONFIG3), cold,
                         workloads.CONFIG3_WARM_DIGESTS, workloads.CONFIG3_WARM_ACTIONS, workloads.CONFIG3_SCHEDULED,
                         ("class_static_hoist", "class_usage_hoist", "rounds"), "rounds_inc")


def gang_run(tag, spec, want) -> dict:
    """One gang snapshot through both fixpoints, each counted on its own:
    the host fixpoint on class state (the class-wave route, K3 + K4 in the
    HoistCache, K5 + K6 per iteration) and the device fixpoint (K7 + K8 +
    K13 queued G + 1 times).  `want`: the JAX numbers."""
    import torch

    from kubernetes_tpu_torch.api.delta import DeltaEncoder
    from kubernetes_tpu_torch.bench import gang_unpack, score_explain, workloads
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, gang, infer_score_config, kernels
    from kubernetes_tpu_torch.ops.incremental import HoistCache

    snap = workloads.gang(**spec)
    enc = DeltaEncoder()
    t0 = time.perf_counter()
    arr, meta = enc.encode_device(snap)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    n = meta.n_pods
    G = arr.group_min.shape[0]
    check(assign.fit_only(cfg, arr) and assign._chunkable(arr, cfg), f"{tag}: {cfg}")

    def digest(x):
        return hashlib.sha256(x[:n].cpu().numpy().astype("<i4").tobytes()).hexdigest()

    def groups_placed(c):
        pg = arr.pod_group[:n].to(torch.int64)
        placed = torch.bincount(pg[c[:n] >= 0], minlength=G)
        return int((placed >= arr.group_min).sum())

    # --- the host fixpoint on class state, counted ---
    kernels.reset_launches()
    assign.reset_trace_counts()
    t0 = time.perf_counter()
    cache = HoistCache()
    inc = cache.ensure(arr, meta, cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    hc, hu, ho, hs = gang.schedule_with_gangs(arr, cfg, with_ordinals=True, inc=inc)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t1
    hl = counted()
    iters = assign.TRACE_COUNTS["chunked_inc"]
    print(f"[{tag}] cold DeltaEncoder encode {encode_s:.3f} s: P={arr.P} N={arr.N} R={arr.R} G={G} "
          f"U1={inc.req_u.shape[0]}; HoistCache.ensure {t1 - t0:.3f} s; host fixpoint (class-wave route) "
          f"{host_s:.4f} s: {iters} iterations, scheduled {int((hc[:n] >= 0).sum())}/{n}, groups "
          f"{groups_placed(hc)}/{G}, sweeps {hs}, choices sha256 {digest(hc)}, ordinals sha256 {digest(ho)}, "
          f"launches {hl}", flush=True)
    check(iters == want["iterations"], f"{tag}: host fixpoint iterations {iters}")
    check(int((hc[:n] >= 0).sum()) == want["scheduled"] and groups_placed(hc) == want["groups"],
          f"{tag}: host fixpoint placed pods / groups")
    check(hs == want["sweeps"], f"{tag}: host fixpoint sweeps {hs}")
    check(digest(hc) == want["choices"], f"{tag}: host fixpoint choices differ from JAX")
    check(digest(ho) == want["ordinals"], f"{tag}: host fixpoint ordinals differ from JAX")
    for k in WAVE_KERNELS:
        check(hl.get(k, 0) > 0, f"{tag}: host fixpoint did not launch {k}: {hl}")

    # --- the device fixpoint, counted ---
    kernels.reset_launches()
    torch.cuda.synchronize()
    stats = {}
    t0 = time.perf_counter()
    g = gang.gang_dispatch(arr, cfg)
    enqueue_s = time.perf_counter() - t0
    dc, du = gang.gang_finish(g, stats)
    torch.cuda.synchronize()
    device_s = time.perf_counter() - t0
    dl = counted()
    print(f"[{tag}] device fixpoint (K7 + K8 + K13 queued {G + 1} times, one read at the end) {device_s:.4f} s, "
          f"host enqueue {enqueue_s:.4f} s: {stats['iterations']} iterations, choices sha256 {digest(dc)}, "
          f"launches {dl}", flush=True)
    check(dl == {"packed_static_rows": G + 1, "chunk_rounds_dense": G + 1, "gang_quorum": G + 1},
          f"{tag}: device fixpoint launches {dl}")
    check(stats["iterations"] == want["iterations"], f"{tag}: device fixpoint iterations {stats['iterations']}")
    check(torch.equal(dc, hc) and torch.equal(du, hu), f"{tag}: device fixpoint != host fixpoint")

    # --- K13 against plain on the first iteration's inputs (every pod valid),
    # and on the revocation path (groups G/2 and G-1 unplaced); its card and
    # host time a call on both, with the fixpoint's persistent outputs ---
    sfs = kernels.packed_static_rows(arr)
    c1 = kernels.chunk_rounds_dense(arr, cfg, sfs)[0]
    c_rev = gang_unpack.revocation_choices(arr, c1)
    k13_err, k13_done = 0, []
    for ch in (c1, c_rev):
        pv_k = arr.pod_valid.clone()
        kq = kernels.gang_quorum(ch, arr.pod_group, pv_k, arr.group_min)
        pq = gang.gang_quorum_plain(ch, arr.pod_group, arr.pod_valid, arr.group_min)
        k13_err += (mismatch(kq[0], pq[0]) + mismatch(kq[1], pq[1]) + mismatch(kq[2], pq[2])
                    + mismatch(kq[3], pq[3]) + mismatch(pv_k, pq[4]) + int(bool(kq[4].item()) != pq[5]))
        k13_done.append(pq[5])
    check(k13_err == 0, f"{tag}: gang_quorum != plain ({k13_err})")
    check(not k13_done[1], f"{tag}: no group failed on the revocation input")
    qo = kernels.gang_quorum_out(G, arr.device)
    k13_card = {}
    for mode, ch in (("first", c1), ("revocation", c_rev)):
        pool = gang_unpack.Pool(arr.pod_valid, gang_unpack.pool_size(100))

        def k13(ch=ch, pool=pool):
            pv_i, done_i = pool.next()
            return kernels.gang_quorum(ch, arr.pod_group, pv_i, arr.group_min, done=done_i, out=qo)

        k13_card[mode] = score_explain.card_host(k13, reps=100)
    k13_kc = kernels.LAST_CLUSTER["gang_quorum"]
    print(f"[{tag}] gang_quorum == plain on the first iteration ({'no' if k13_done[0] else 'a'} group failing) "
          f"and revoking group {G // 2}; one cluster of {k13_kc} "
          f"blocks; card {k13_card['first'][0] * 1e3:.2f} us, host {k13_card['first'][1]:.1f} us a call "
          f"(revocation: card {k13_card['revocation'][0] * 1e3:.2f} us, host {k13_card['revocation'][1]:.1f} us), "
          f"with the fixpoint's out buffers", flush=True)

    # --- where the walls go: one iteration of each route's kernels, and the
    # host cost of one gated iteration's three wrapper calls ---
    wk = kernels.wave_commit(arr, inc, cfg)
    k5_ms = cuda_ms(lambda: kernels.wave_commit(arr, inc, cfg), reps=2)
    sb_k, sb_p, k6_ms, _, sb_bound, sb_by, sb_bytes, sb_chunks, _ = stage_b(arr, inc, cfg, wk,
                                                                          f32_ops_per_scored_node(cfg))
    check(all(same(a, b) for a, b in zip(sb_k[:3], sb_p[:3])) and kernels.read_sweeps(sb_k[3]) == sb_p[3],
          f"{tag}: chunk_rounds as stage B != plain")
    k7_ms = cuda_ms(lambda: kernels.packed_static_rows(arr), reps=5)
    k8_ms = cuda_ms(lambda: kernels.chunk_rounds_dense(arr, cfg, sfs), reps=2)
    done = torch.ones((1,), dtype=torch.int32, device=arr.device)
    out = (torch.empty_like(c1), torch.empty_like(arr.node_used), torch.empty_like(c1),
           torch.zeros((2,), dtype=torch.int32, device=arr.device))
    pv_g = arr.pod_valid.clone()
    torch.cuda.synchronize()
    host_us = {}
    for name, call in (("packed_static_rows", lambda: kernels.packed_static_rows(arr, done=done, out=sfs)),
                       ("chunk_rounds_dense", lambda: kernels.chunk_rounds_dense(arr, cfg, sfs, done=done, out=out)),
                       ("gang_quorum", lambda: kernels.gang_quorum(c1, arr.pod_group, pv_g, arr.group_min, done=done,
                                                                   out=qo))):
        t0 = time.perf_counter()
        for _ in range(100):
            call()
        host_us[name] = (time.perf_counter() - t0) * 1e4
    torch.cuda.synchronize()
    gated_ms = cuda_ms(lambda: (kernels.packed_static_rows(arr, done=done, out=sfs),
                                kernels.chunk_rounds_dense(arr, cfg, sfs, done=done, out=out),
                                kernels.gang_quorum(c1, arr.pod_group, pv_g, arr.group_min, done=done, out=qo)),
                       reps=100)
    gated_card_ms = card_ms(lambda: (kernels.packed_static_rows(arr, done=done, out=sfs),
                                     kernels.chunk_rounds_dense(arr, cfg, sfs, done=done, out=out),
                                     kernels.gang_quorum(c1, arr.pod_group, pv_g, arr.group_min, done=done, out=qo)),
                            reps=100)
    k13_gated = score_explain.card_host(
        lambda: kernels.gang_quorum(c1, arr.pod_group, pv_g, arr.group_min, done=done, out=qo), reps=100)
    check(torch.equal(pv_g, arr.pod_valid), f"{tag}: a gated gang_quorum launch moved pv")
    # K7 alone in the gated mode (done set): its card time, nothing written;
    # and with done clear against its plain version
    sfs_real = kernels.packed_static_rows(arr)
    k7_gated_ms = card_ms(lambda: kernels.packed_static_rows(arr, done=done, out=sfs), reps=100)
    k7_moved = mismatch(sfs, sfs_real)
    check(k7_moved == 0, f"{tag}: a gated packed_static_rows launch wrote {k7_moved} words")
    k7_err = mismatch(kernels.packed_static_rows(arr, done=torch.zeros_like(done), out=sfs),
                      assign.packed_static_rows_plain(arr))
    check(k7_err == 0, f"{tag}: packed_static_rows (done clear) != plain ({k7_err} words)")
    k7_plain = cuda_ms(lambda: assign.packed_static_rows_plain(arr), reps=2)
    print(f"[{tag}] packed_static_rows (done clear) == plain over [{arr.P}, {sfs.shape[1]}]; done set: "
          f"{k7_gated_ms * 1e3:.2f} us of card time, nothing written", flush=True)
    print(f"[{tag}] one iteration's kernels: wave_commit {k5_ms:.3f} ms + chunk_rounds {k6_ms:.4f} ms of card time "
          f"(the host fixpoint's route; stage B: {sb_chunks} of {arr.P // assign.INC_CHUNK} chunks need rounds, == plain, "
          f"bound {sb_bound:.6f} ms ({sb_by}: {sb_bytes} B)), packed_static_rows {k7_ms:.3f} ms + chunk_rounds_dense {k8_ms:.3f} ms (the device "
          f"fixpoint's); a gated iteration: host {sum(host_us.values()):.1f} us "
          f"({', '.join(f'{k} {v:.1f}' for k, v in host_us.items())}), device {gated_ms * 1e3:.1f} us back to "
          f"back, {gated_card_ms * 1e3:.1f} us of card time queued behind a sleep; gang_quorum gated alone "
          f"{k13_gated[0] * 1e3:.2f} us of card time, {k13_gated[1]:.1f} us host", flush=True)
    return dict(arr=arr, c1=c1, G=G, host_s=host_s, device_s=device_s, enqueue_s=enqueue_s,
                launches=dl, k13_err=k13_err, encode_s=encode_s, k7_ms=k7_ms, k7_gated_ms=k7_gated_ms,
                k7_err=k7_err + k7_moved, k7_plain=k7_plain, k13_card=k13_card, k13_gated=k13_gated, k13_kc=k13_kc,
                gated_host_us=host_us)


def phase_gang_small() -> None:
    from kubernetes_tpu_torch.bench import workloads as w

    gang_run("gang-small", w.GANG_SMALL, dict(
        iterations=w.GANG_SMALL_ITERATIONS, scheduled=w.GANG_SMALL_SCHEDULED, groups=w.GANG_SMALL_GROUPS,
        sweeps=w.GANG_SMALL_SWEEPS, choices=w.GANG_SMALL_CHOICES_SHA256, ordinals=w.GANG_SMALL_ORDINALS_SHA256))


def phase_config5() -> list:
    """BASELINE config 5, gang(1000, 64, 2000): both fixpoints, and K13 timed
    beside its plain version and the one PyTorch call of its quorum count."""
    import torch

    from kubernetes_tpu_torch.bench import gang_unpack, score_explain, static_rows
    from kubernetes_tpu_torch.bench import workloads as w
    from kubernetes_tpu_torch.ops import gang, kernels

    r = gang_run("config5", w.CONFIG5, dict(
        iterations=w.CONFIG5_ITERATIONS, scheduled=w.CONFIG5_SCHEDULED, groups=w.CONFIG5_GROUPS,
        sweeps=w.CONFIG5_SWEEPS, choices=w.CONFIG5_CHOICES_SHA256, ordinals=w.CONFIG5_ORDINALS_SHA256))
    arr, c1, G = r["arr"], r["c1"], r["G"]
    P = arr.P
    pv = arr.pod_valid.clone()
    qo = kernels.gang_quorum_out(G, arr.device)
    k13_b2b = cuda_ms(lambda: kernels.gang_quorum(c1, arr.pod_group, pv, arr.group_min, out=qo), reps=50, warmup=3)
    check(torch.equal(pv, arr.pod_valid), "config 5: a quorum check revoked a group")
    k13_plain = cuda_ms(lambda: gang.gang_quorum_plain(c1, arr.pod_group, arr.pod_valid, arr.group_min), reps=10)
    gidx = torch.where((arr.pod_group >= 0) & arr.pod_valid & (c1 >= 0), arr.pod_group, G).to(torch.int64)
    ones = torch.ones((P,), dtype=torch.int32, device=arr.device)
    k13_lib = score_explain.card_host(
        lambda: torch.zeros((G + 1,), dtype=torch.int32, device=arr.device).index_add_(0, gidx, ones), reps=50)[0]
    k13_bincount = cuda_ms(lambda: torch.bincount(gidx, minlength=G + 1), reps=50, warmup=3)
    k13_bytes, k13_ops = gang_unpack.k13_work(P, G)
    k13_bound, k13_by = bound(k13_bytes, k13_ops)
    k13_ms, k13_host = r["k13_card"]["first"]
    print(f"[config5] gang_quorum == plain: {k13_ms:.4f} ms of card time over P={P}, G={G} (one cluster of "
          f"{r['k13_kc']} blocks; {k13_b2b:.4f} ms back to back; revocation {r['k13_card']['revocation'][0]:.4f} ms), "
          f"plain {k13_plain:.4f} ms, torch.zeros(G + 1).index_add_ of the quorum count {k13_lib:.4f} ms of card "
          f"time (torch.bincount {k13_bincount:.4f} ms back to back, a host read), bound {k13_bound:.6f} ms "
          f"({k13_by}: {k13_bytes} B); walls: host fixpoint {r['host_s']:.4f} s, device fixpoint {r['device_s']:.4f} s "
          f"(host enqueue {r['enqueue_s']:.4f} s, {r['enqueue_s'] / (G + 1) * 1e6:.1f} us an iteration)", flush=True)
    k7_bound, k7_by = bound(*static_rows.k7_work(arr, False))
    return [dict(name="gang_quorum", route="cuda", source="kubernetes_tpu_torch/csrc/gang.cu",
                 replaces="kubernetes_tpu/ops/gang.py:112", launches=r["launches"]["gang_quorum"],
                 max_abs_err=r["k13_err"], ms=k13_ms, plain_ms=k13_plain, bound_ms=k13_bound, bound_by=k13_by,
                 library_ms=k13_lib, host_us=k13_host, b2b_ms=k13_b2b, revocation_ms=r["k13_card"]["revocation"][0],
                 gated_ms=r["k13_gated"][0], gated_host_us=r["k13_gated"][1], cluster=r["k13_kc"],
                 bincount_b2b_ms=k13_bincount),
            dict(name="packed_static_rows (gated mode)", route="cuda",
                 source="kubernetes_tpu_torch/csrc/class_hoist.cu",
                 replaces="kubernetes_tpu/ops/filters.py:92 (per gang-fixpoint iteration, kubernetes_tpu/ops/gang.py:112)",
                 launches=r["launches"]["packed_static_rows"], max_abs_err=r["k7_err"], ms=r["k7_ms"],
                 plain_ms=r["k7_plain"], bound_ms=k7_bound, bound_by=k7_by, library_ms=None,
                 gated_ms=r["k7_gated_ms"])]


def phase_gang_rounds(k_ops3: int, k12_row: dict) -> dict:
    """BASELINE config 3 in PodGroups of 64 through the device fixpoint on
    the rounds route (K7 with the eligibility plane + K12 + K13 queued G + 1
    times): the JAX digests, == the port's host fixpoint; K12's gated mode
    == plain on the first chunks with `done` clear, writing nothing with it
    set; the wall, the host enqueue of the first fixpoint and of a second
    (steady) one, and a gated iteration's card time."""
    import torch

    from kubernetes_tpu_torch.api.delta import DeltaEncoder
    from kubernetes_tpu_torch.bench import workloads as w
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, gang, infer_score_config, kernels

    snap = w.grouped(w.spread_affinity(**w.CONFIG3), 64)
    t0 = time.perf_counter()
    arr, meta = DeltaEncoder().encode_device(snap)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    n, G, P, N = meta.n_pods, arr.group_min.shape[0], arr.P, arr.N
    check(G == w.GANG_ROUNDS_GROUPS and not assign._chunkable(arr, cfg) and assign._rounds_capable(arr, cfg),
          f"gang-rounds: G={G}, {cfg}")

    def digest(x, k=None):
        x = x if k is None else x[:k]
        return hashlib.sha256(x.cpu().numpy().astype("<i4").tobytes()).hexdigest()

    t0 = time.perf_counter()
    hc, hu = gang.schedule_with_gangs(arr, cfg)
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    kernels.reset_launches()
    torch.cuda.synchronize()
    stats = {}
    t0 = time.perf_counter()
    g = gang.gang_dispatch(arr, cfg)
    enqueue_s = time.perf_counter() - t0
    busy = not torch.cuda.current_stream().query()  # the real K12 alone outlasts the enqueue
    dc, du = gang.gang_finish(g, stats)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    dl = counted()
    t0 = time.perf_counter()
    g2 = gang.gang_dispatch(arr, cfg)
    steady_enqueue_s = time.perf_counter() - t0
    dc2, du2 = gang.gang_finish(g2)
    want = {"packed_static_rows": G + 1, "rounds": G + 1, "gang_quorum": G + 1}
    if cfg.enable_taint_score or cfg.enable_node_pref:
        want["score_planes"] = 1
    print(f"[gang-rounds] grouped(spread_affinity(5000, 10000), 64): P={P} N={N} G={G}, encode {encode_s:.3f} s; "
          f"device fixpoint (route {stats['route']}, {G + 1} iterations queued) wall {wall_s:.4f} s, host "
          f"enqueue {enqueue_s:.4f} s (a second fixpoint: {steady_enqueue_s:.4f} s): {stats['iterations']} "
          f"iterations, scheduled {int((dc[:n] >= 0).sum())}/{n}, choices sha256 {digest(dc, n)}, used sha256 "
          f"{digest(du)}, launches {dl}; host fixpoint {host_s:.4f} s", flush=True)
    check(torch.equal(dc2, dc) and torch.equal(du2, du), "gang-rounds: a second fixpoint differs")
    check(busy, "gang-rounds: gang_dispatch returned after the card had finished (a host read in the enqueue?)")
    check(dl == want, f"gang-rounds: launches {dl}")
    check(stats["route"] == "rounds" and stats["iterations"] == w.GANG_ROUNDS_ITERATIONS,
          f"gang-rounds: {stats}")
    check(digest(dc, n) == w.GANG_ROUNDS_CHOICES_SHA256 and digest(du) == w.GANG_ROUNDS_USED_SHA256,
          "gang-rounds: the device fixpoint differs from JAX")
    check(int((dc[:n] >= 0).sum()) == w.GANG_ROUNDS_SCHEDULED, "gang-rounds: scheduled count")
    check(torch.equal(dc, hc) and torch.equal(du, hu), "gang-rounds: device fixpoint != host fixpoint")

    # a gated iteration: K7 + K12 + K13 with `done` set (the fixpoint ended)
    iterate, res, _, _, done = gang._card_loop(arr, cfg, "rounds")
    done.fill_(1)
    before = [x.clone() for x in res]
    t0 = time.perf_counter()
    for _ in range(100):
        iterate()
    gated_host_us = (time.perf_counter() - t0) * 1e4
    gated_iter_ms = card_ms(iterate, reps=100)
    check(all(torch.equal(a, b) for a, b in zip(before, res)), "gang-rounds: a gated iteration moved the result")

    # K12's gated mode against plain on the first chunks, and timed at full size
    npre = ROUNDS_PREFIX_CHUNKS * assign.RCHUNK
    pre = arr.pod_prefix(npre)
    sfs, eligs = kernels.packed_static_rows(arr, with_elig=True)
    sp, ep = sfs[:npre].contiguous(), eligs[:npre].contiguous()
    zero = torch.zeros((1,), dtype=torch.int32, device=arr.device)
    so = kernels.scan_out(pre, assign.RCHUNK)
    kp = kernels.rounds(pre, cfg, sp, ep, (None, None), with_state=True, done=zero, out=so)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pp = assign.schedule_scan_rounds_plain(pre, cfg, sp, ep, (None, None), with_state=True)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = (sum(mismatch(a, b) for a, b in zip(kp[:3], pp[:3])) + abs(kernels.read_sweeps(kp[3]) - pp[3])
           + same_state(kp[4], pp[4]))
    check(err == 0, f"gang-rounds: rounds (gated mode, done clear) != plain on the first chunks ({err})")
    before = [x.clone() for x in (so.choices, so.ordinals, so.scal, *so.state.values())]
    one = torch.ones((1,), dtype=torch.int32, device=arr.device)
    gated_ms = card_ms(lambda: kernels.rounds(pre, cfg, sp, ep, (None, None), done=one, out=so), reps=100)
    moved = sum(mismatch(a, b) for a, b in zip(before, (so.choices, so.ordinals, so.scal, *so.state.values())))
    check(moved == 0, f"gang-rounds: a gated rounds launch wrote {moved} entries")
    so_full = kernels.scan_out(arr, assign.RCHUNK)
    full_ms = cuda_ms(lambda: kernels.rounds(arr, cfg, sfs, eligs, (None, None), done=zero, out=so_full), reps=2)
    check(torch.equal(so_full.choices, dc), "gang-rounds: the gated-mode launch != the fixpoint's iteration")
    k_bytes = full_bytes(arr)
    b_ms, b_by = bound(k_bytes, k_ops3)
    print(f"[gang-rounds] a gated iteration (K7 + K12 + K13, done set): card {gated_iter_ms * 1e3:.1f} us, host "
          f"{gated_host_us:.1f} us; rounds in the gated mode: done clear == plain on the first "
          f"{ROUNDS_PREFIX_CHUNKS} chunks (plain {plain_ms:.1f} ms, host clock), all chunks {full_ms:.3f} ms "
          f"(ungated {k12_row['ms']:.3f} ms), bound {b_ms:.4f} ms ({b_by}); done set: {gated_ms * 1e3:.2f} us, "
          f"nothing written", flush=True)
    row = dict(name="rounds (gated mode)", route="cuda", source="kubernetes_tpu_torch/csrc/rounds.cu",
               replaces="kubernetes_tpu/ops/gang.py:112 (schedule_batch_impl per iteration)",
               launches=dl["rounds"], max_abs_err=err + moved, ms=full_ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=None, gated_ms=gated_ms, plain_scope=f"first {ROUNDS_PREFIX_CHUNKS} chunks")
    return row


def phase_gang_contended(k12_gated: dict) -> list:
    """The contended gang batches off the dense route: rounds with pairwise
    stages and fit-only at P = 64, the per-pod route at P = 8 fit-only (K1 +
    K2 + K13) and with the full stage set (K7 + K11 + K13), first on their
    own 2-8 nodes (bench/workloads.py gang_contended), then pinned to a pool
    of BASELINE config 3's 5000 nodes (gang_pinned: the sidecar's wave
    sizes against a cluster of real size, N = 6144), each through the
    device fixpoint with exact launch counts, the JAX digests, == the host
    fixpoint and a gated iteration's card time; at real size each gated
    kernel of the route held against its plain version with `done` clear
    and writing nothing with it set, and timed."""
    import torch

    from kubernetes_tpu_torch.api.delta import DeltaEncoder
    from kubernetes_tpu_torch.bench import score_explain
    from kubernetes_tpu_torch.bench import workloads as w
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, bitplane, filters, gang
    from kubernetes_tpu_torch.ops import infer_score_config, kernels

    per_route = {"rounds": ("packed_static_rows", "rounds"), "perpod-fit": ("static_feasible", "fit_scan"),
                 "perpod-full": ("packed_static_rows", "full_scan")}
    rows = {}
    for scale, name in [(scale, name) for scale in (False, True) for name in w.GANG_CONTENDED]:
        tag = f"{name} at N=6144" if scale else name
        route, iters, sched, want_c, want_u = (w.GANG_PINNED_WANT if scale else w.GANG_CONTENDED_WANT)[name]
        arr, meta = DeltaEncoder().encode_device((w.gang_pinned if scale else w.gang_contended)(name))
        cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
        n, G = meta.n_pods, arr.group_min.shape[0]
        hc, hu = gang.schedule_with_gangs(arr, cfg)
        kernels.reset_launches()
        torch.cuda.synchronize()
        stats = {}
        t0 = time.perf_counter()
        g = gang.gang_dispatch(arr, cfg)
        dc, du = gang.gang_finish(g, stats)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        dl = counted()
        want = {k: G + 1 for k in (*per_route[route], "gang_quorum")}
        dig_c = hashlib.sha256(dc[:n].cpu().numpy().astype("<i4").tobytes()).hexdigest()
        dig_u = hashlib.sha256(du.cpu().numpy().astype("<i4").tobytes()).hexdigest()
        iterate, res, _, _, done = gang._card_loop(arr, cfg, route)
        done.fill_(1)
        before = [x.clone() for x in res]
        gated_iter_ms = card_ms(iterate, reps=50)
        print(f"[gang-contended] {tag}: P={arr.P} N={arr.N} G={G}, route {stats['route']}, {stats['iterations']} "
              f"iterations, scheduled {int((dc[:n] >= 0).sum())}/{n}, wall {wall_s:.4f} s, a gated iteration "
              f"{gated_iter_ms * 1e3:.1f} us of card time, choices sha256 {dig_c}, launches {dl}", flush=True)
        check(dl == want, f"gang-contended {tag}: launches {dl}")
        check(stats["route"] == route and stats["iterations"] == iters, f"gang-contended {tag}: {stats}")
        check(int((dc[:n] >= 0).sum()) == sched and dig_c == want_c and dig_u == want_u,
              f"gang-contended {tag}: differs from JAX")
        check(torch.equal(dc, hc) and torch.equal(du, hu), f"gang-contended {tag}: device != host fixpoint")
        check(all(torch.equal(a, b) for a, b in zip(before, res)), f"gang-contended {tag}: a gated iteration wrote")
        if not scale:
            continue

        # the route's gated kernels against plain (done clear), then done set
        zero = torch.zeros((1,), dtype=torch.int32, device=arr.device)
        one = torch.ones((1,), dtype=torch.int32, device=arr.device)
        if route == "perpod-fit":
            sf = torch.zeros((arr.P, arr.N), dtype=torch.bool, device=arr.device)
            kernels.static_feasible(arr, done=zero, out=sf)
            t0 = time.perf_counter()
            sf_p = filters.static_feasible_plain(arr)
            torch.cuda.synchronize()
            k1_plain = (time.perf_counter() - t0) * 1e3
            fo = kernels.fit_scan_out(arr, cfg)
            ck, uk, n_scored = kernels.fit_scan(sf, arr, cfg, done=zero, out=fo)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cp, up = assign.schedule_scan_plain(arr, cfg, sf=sf_p)
            torch.cuda.synchronize()
            k2_plain = (time.perf_counter() - t0) * 1e3
            err1 = mismatch(sf, sf_p)
            err2 = mismatch(ck, cp) + mismatch(uk.contiguous(), up)
            k1_ms = cuda_ms(lambda: kernels.static_feasible(arr, done=zero, out=sf), reps=20)
            k1_card, k1_host = score_explain.card_host(lambda: kernels.static_feasible(arr, done=zero, out=sf), reps=50)
            k1_lib, k1_lib_card = term_match_library([arr], reps=50)
            k2_ms = cuda_ms(lambda: kernels.fit_scan(sf, arr, cfg, done=zero, out=fo), reps=20)
            before = [x.clone() for x in (sf, fo.choices, fo.used_t, fo.n_scored)]
            k1_gated = card_ms(lambda: kernels.static_feasible(arr, done=one, out=sf), reps=50)
            k2_gated = card_ms(lambda: kernels.fit_scan(sf, arr, cfg, done=one, out=fo), reps=50)
            moved = sum(mismatch(a, b) for a, b in zip(before, (sf, fo.choices, fo.used_t, fo.n_scored)))
            check(err1 + err2 + moved == 0, f"gang-contended {tag}: K1/K2 gated mode ({err1}, {err2}, {moved})")
            P, N = arr.P, arr.N
            b1 = bound(*k1_work(arr))
            b2 = bound(P * N + sum(t.numel() * t.element_size() for t in (arr.pod_req, arr.pod_valid,
                                                                           arr.node_alloc, arr.node_used))
                       + 4 * P + 4 * N * arr.R,  # the choices and the usage written
                       f32_ops_per_scored_node(cfg) * int(n_scored.item()))
            print(f"[gang-contended] {tag}: static_feasible / fit_scan in the gated mode == plain (done clear: "
                  f"{k1_ms:.4f} / {k2_ms:.4f} ms; done set: {k1_gated * 1e3:.2f} / {k2_gated * 1e3:.2f} us, "
                  f"nothing written); static_feasible done clear {k1_card:.4f} ms of card time, host {k1_host:.1f} "
                  f"us a call, the term match's torch.einsum {k1_lib_card:.4f} ms of card time", flush=True)
            for kname, src, rep_, lc, err, ms, pms, b, gms in (
                    ("static_feasible", "static_feasible.cu", "kubernetes_tpu/ops/filters.py:81", dl["static_feasible"],
                     err1, k1_ms, k1_plain, b1, k1_gated),
                    ("fit_scan", "fit_scan.cu", "kubernetes_tpu/ops/assign.py:181", dl["fit_scan"], err2, k2_ms,
                     k2_plain, b2, k2_gated)):
                rows[kname] = dict(name=f"{kname} (gated mode)", route="cuda",
                                   source=f"kubernetes_tpu_torch/csrc/{src}", replaces=rep_, launches=lc,
                                   max_abs_err=err + moved, ms=ms, plain_ms=pms, bound_ms=b[0], bound_by=b[1],
                                   library_ms=None, gated_ms=gms, shape=f"P={arr.P} N={arr.N}")
            rows["static_feasible"].update(card_ms=k1_card, host_us=k1_host, library_ms=k1_lib,
                                           library_card_ms=k1_lib_card)
        else:
            sfs, eligs = kernels.packed_static_rows(arr, with_elig=True)
            planes = assign.score_planes(arr, cfg)
            scan = "rounds" if route == "rounds" else "full_scan"
            so = kernels.scan_out(arr, assign.RCHUNK if scan == "rounds" else None)

            def launch(done):
                if scan == "rounds":
                    return kernels.rounds(arr, cfg, sfs, eligs, planes, with_state=True, done=done, out=so)
                return kernels.full_scan(arr, cfg, sfs, eligs, planes, with_state=True, done=done, out=so)

            kr = launch(zero)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if scan == "rounds":
                pr = assign.schedule_scan_rounds_plain(arr, cfg, sfs, eligs, planes, with_state=True)
                err = (mismatch(kr[0], pr[0]) + mismatch(kr[1], pr[1]) + mismatch(kr[2], pr[2])
                       + abs(kernels.read_sweeps(kr[3]) - pr[3]) + same_state(kr[4], pr[4]))
            else:
                pr = assign.schedule_scan_plain(arr, cfg, sf=bitplane.unpack(sfs, arr.N), planes=planes,
                                                with_state=True)
                err = mismatch(kr[0], pr[0]) + mismatch(kr[1], pr[1]) + same_state(kr[2], pr[2])
            torch.cuda.synchronize()
            p_ms = (time.perf_counter() - t0) * 1e3
            ms = cuda_ms(lambda: launch(zero), reps=20)
            before = [x.clone() for x in (so.choices, so.ordinals, so.scal, *so.state.values())]
            g_ms = card_ms(lambda: launch(one), reps=50)
            moved = sum(mismatch(a, b) for a, b in zip(before, (so.choices, so.ordinals, so.scal,
                                                                  *so.state.values())))
            check(err + moved == 0, f"gang-contended {tag}: {scan} gated mode ({err}, {moved})")
            print(f"[gang-contended] {tag}: {scan} in the gated mode == plain (done clear {ms:.4f} ms, plain "
                  f"{p_ms:.1f} ms host clock; done set {g_ms * 1e3:.2f} us, nothing written)", flush=True)
            if scan == "rounds":
                k12_gated["max_abs_err"] += err + moved
            else:
                ops, _ = full_ops(arr, cfg, sfs, eligs, dc)
                b = bound(full_bytes(arr), ops)
                rows["full_scan"] = dict(name="full_scan (gated mode)", route="cuda",
                                         source="kubernetes_tpu_torch/csrc/full_scan.cu",
                                         replaces="kubernetes_tpu/ops/assign.py:181", launches=dl["full_scan"],
                                         max_abs_err=err + moved, ms=ms, plain_ms=p_ms, bound_ms=b[0],
                                         bound_by=b[1], library_ms=None, gated_ms=g_ms,
                                         shape=f"P={arr.P} N={arr.N}")
    return [rows["static_feasible"], rows["fit_scan"], rows["full_scan"]]


def sidecar_run(tag: str, snap, gang_wave: bool, waves: int, want: list, want_launches) -> dict:
    """The sidecar engine on the card, a session built directly (no wire):
    workloads.session_waves, counted; each wave's verdicts == the JAX
    engine's; the encode / dispatch (both under the device lock) / step
    (the read back, outside it) split per wave."""
    import torch

    from kubernetes_tpu_torch.api.snapshot import SpecInterner
    from kubernetes_tpu_torch.bench import workloads as w
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.runtime.convert import clone_pod
    from kubernetes_tpu_torch.runtime.sidecar import _Engine, _Session

    eng = _Engine(device="cuda")
    seen = {}
    observe = eng.metrics.observe

    def record(name, v):
        seen.setdefault(name, []).append(v)
        observe(name, v)

    eng.metrics.observe = record
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = w.session_waves(eng, lambda: _Session(1.0, "cuda"), clone_pod, SpecInterner(), snap, gang_wave, waves)
    wall_s = time.perf_counter() - t0
    dl = counted()
    enc, disp, step = (seen[f"sidecar_{k}_seconds"] for k in ("encode", "dispatch", "step"))
    for i, r in enumerate(res):
        print(f"[{tag}] wave {i + 1}: scheduled {r['scheduled']}, verdicts sha256 {r['sha256']}; "
              f"sidecar_encode_seconds {enc[i]:.4f}, sidecar_dispatch_seconds {disp[i]:.4f} (the lock held "
              f"{enc[i] + disp[i]:.4f} s), sidecar_step_seconds {step[i]:.4f}", flush=True)
    print(f"[{tag}] {waves} waves {wall_s:.3f} s (pregrouping included), launches {dl}", flush=True)
    check([(r["scheduled"], r["sha256"]) for r in res] == [tuple(x) for x in want], f"{tag}: differs from JAX")
    check(dl == want_launches, f"{tag}: launches {dl}")
    return dict(engine=eng, dispatch=disp, launches=dl)


def phase_sidecar_north_star() -> None:
    """The sidecar engine at the north star: wave 1 the whole pending set
    through run_session(gang=False) (the dense route), then bench.py's wave
    2 with wave 1's placements bound; and the pregrouped encode against
    encode_device on wave 1, each on a cold encoder."""
    import torch

    from kubernetes_tpu_torch.api.delta import DeltaEncoder
    from kubernetes_tpu_torch.api.snapshot import SpecInterner
    from kubernetes_tpu_torch.bench import workloads as w

    snap = w.heterogeneous(**w.NORTH_STAR)
    sidecar_run("sidecar-north-star", snap, False, 2, w.SIDECAR_NORTH_STAR_WAVES,
                {"packed_static_rows": 2, "chunk_rounds_dense": 2})
    t0 = time.perf_counter()
    uids, reps, inv = w.pregroup(snap.pending_pods, SpecInterner())
    t1 = time.perf_counter()
    a1, m1 = DeltaEncoder().encode_device_pregrouped(snap.nodes, snap.bound_pods, snap.pod_groups, uids, reps, inv)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    a2, m2 = DeltaEncoder().encode_device(snap)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    check(all(torch.equal(getattr(a1, f), getattr(a2, f)) for f in type(a1).FIELDS),
          "sidecar-north-star: the pregrouped encode != encode_device")
    print(f"[sidecar-north-star] cold encodes of wave 1: encode_device_pregrouped {t2 - t1:.4f} s (+ the "
          f"interning a wire client does, {t1 - t0:.4f} s) against encode_device {t3 - t2:.4f} s; arrays equal",
          flush=True)


def phase_sidecar_config5() -> None:
    """The sidecar engine on BASELINE config 5, in a fresh process (this
    script with --sidecar-config5): one gang wave through
    run_session(gang=True), the device fixpoint on the dense route (1001
    queued iterations under the lock), then the same wave again on a new
    session.  In a fresh process the engine has loaded every route's
    kernel modules when it started, so the first wave's dispatch under the
    lock should be the enqueue alone, as the second's is."""
    import torch

    torch.cuda.empty_cache()
    run = subprocess.run([sys.executable, os.path.abspath(__file__), "--sidecar-config5"], capture_output=True,
                         text=True, timeout=600, cwd=HERE)
    lines = run.stdout.splitlines()
    ok = run.returncode == 0 and bool(lines) and lines[-1].startswith("{")
    for line in lines[:-1] if ok else lines:
        print(line, flush=True)
    check(ok, f"sidecar-config5: the child failed ({run.returncode}): {run.stderr[-4000:]}")
    r = json.loads(lines[-1])
    add_launches(r["launches"])
    print(f"[sidecar-config5] fresh process: the lock held for dispatch {r['dispatch'][0]:.4f} s on the first "
          f"gang wave, {r['dispatch'][1]:.4f} s on the second (ratio {r['dispatch'][0] / r['dispatch'][1]:.3f}); "
          f"engine start (build + module loads) {r['engine_start_s']:.3f} s", flush=True)


def sidecar_config5_child() -> int:
    """The child of phase_sidecar_config5: prints its phase lines, then one
    JSON line (the dispatch seconds of both waves, the engine's start)."""
    import torch

    from kubernetes_tpu_torch.api.snapshot import SpecInterner
    from kubernetes_tpu_torch.bench import workloads as w
    from kubernetes_tpu_torch.runtime import sidecar

    G = w.CONFIG5["n_groups"]
    snap = w.gang(**w.CONFIG5)
    t0 = time.perf_counter()
    sidecar._Engine(device="cuda")  # a first engine: the build and the module loads
    start_s = time.perf_counter() - t0
    r = sidecar_run("sidecar-config5", snap, True, 1, w.SIDECAR_CONFIG5_WAVES,
                    {"packed_static_rows": G + 1, "chunk_rounds_dense": G + 1, "gang_quorum": G + 1})
    sess = sidecar._Session(1.0, "cuda")
    sess.nodes, sess.pod_groups = list(snap.nodes), dict(snap.pod_groups)
    choices, _ = r["engine"].run_session(sess, w.pregroup(snap.pending_pods, SpecInterner()), True)
    torch.cuda.synchronize()
    check(int((choices >= 0).sum()) == w.SIDECAR_CONFIG5_WAVES[0][0], "sidecar-config5: the second wave differs")
    print(json.dumps({"dispatch": r["dispatch"], "engine_start_s": start_s, "launches": RUN_LAUNCHES}), flush=True)
    return 0


def phase_config4s() -> tuple:
    """BASELINE Config4S, heterogeneous_storage(20000, 20000, seed=0): the
    storage state resolved by the encoder (api/volumes.py: R = 6, the last
    resource attachable-volumes-csi), then the dense step (K7 + K8) and the
    class-wave step (HoistCache.ensure: K3 + K4, then K5 + K6), each counted
    on its own: the JAX digests, sweeps and ordinals."""
    import torch

    from kubernetes_tpu_torch.api.delta import DeltaEncoder
    from kubernetes_tpu_torch.api.volumes import resolve_snapshot
    from kubernetes_tpu_torch.bench import workloads as w
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, infer_score_config, kernels
    from kubernetes_tpu_torch.ops.incremental import HoistCache

    snap = w.heterogeneous_storage(**w.CONFIG4S)
    t0 = time.perf_counter()
    resolve_snapshot(snap)
    resolve_s = time.perf_counter() - t0
    enc = DeltaEncoder()
    on_c_path(enc._interner, "config4s")
    t0 = time.perf_counter()
    host, meta = enc.encode(snap)
    t1 = time.perf_counter()
    arr, meta = enc.to_device(host, meta)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    n = meta.n_pods
    print(f"[config4s] heterogeneous_storage(20000, 20000): P {arr.P}, N {arr.N}, R {arr.R} {meta.resources}, "
          f"{len(snap.pvs)} PVs, {len(snap.pvcs)} PVCs; cold encode_s {encode_s:.3f} (resolution included: host "
          f"encode {t1 - t0:.3f} s, to_device {encode_s - (t1 - t0):.3f} s); resolve_snapshot alone "
          f"{resolve_s:.3f} s", flush=True)
    check(list(meta.resources) == w.CONFIG4S_RESOURCES, f"config4s: resources {meta.resources}")

    def digest(x):
        return hashlib.sha256(x[:n].cpu().numpy().astype("<i4").tobytes()).hexdigest()

    out = {}
    for route, need in (("dense", DENSE_KERNELS), ("class-wave", WAVE_KERNELS)):
        kernels.reset_launches()
        assign.reset_trace_counts()
        t0 = time.perf_counter()
        inc = HoistCache().ensure(arr, meta, cfg) if route == "class-wave" else None
        choices, used, ords, sweeps = assign.schedule_batch_ordinals(arr, cfg, inc=inc)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = counted()
        routes = {k: v for k, v in assign.TRACE_COUNTS.items() if v}
        scheduled = int((choices[:n] >= 0).sum())
        step_s = float("inf")
        for _ in range(3):  # the best of three, the class state kept
            t0 = time.perf_counter()
            c2, _ = assign.schedule_batch(arr, cfg, inc=inc)
            torch.cuda.synchronize()
            step_s = min(step_s, time.perf_counter() - t0)
        u1 = inc.req_u.shape[0] if inc is not None else meta.n_classes
        print(f"[config4s] {route}: {first_s:.3f} s (first call), step_s {step_s:.4f} (best of 3), U1 {u1}, "
              f"scheduled {scheduled}/{n}, sweeps {sweeps}, choices sha256 {digest(choices)}, ordinals sha256 "
              f"{digest(ords)}, launches {launches}, routes {routes}", flush=True)
        want = (w.CONFIG4S_DENSE_SWEEPS, w.CONFIG4S_DENSE_ORDINALS_SHA256) if route == "dense" else \
            (w.CONFIG4S_WAVE_SWEEPS, w.CONFIG4S_WAVE_ORDINALS_SHA256)
        check(set(launches) == set(need) and all(v == 1 for v in launches.values()),
              f"config4s {route}: launches {launches}")
        check(scheduled == w.CONFIG4S_SCHEDULED, f"config4s {route}: scheduled {scheduled}")
        check(digest(choices) == w.CONFIG4S_CHOICES_SHA256, f"config4s {route}: choices differ from JAX")
        check((sweeps, digest(ords)) == want, f"config4s {route}: sweeps / ordinals differ from JAX ({sweeps})")
        check(u1 == w.CONFIG4S_CLASSES, f"config4s: U1 {u1}")
        check(torch.equal(c2, choices), f"config4s {route}: a repeated step differs")
        out[route] = dict(step_s=step_s, choices=choices)
    return snap, (out["class-wave"]["choices"], meta)


def phase_config4s_warm(snap, cold) -> dict:
    """Config4S's warm loop: bench.py's waves 2..7 over the storage-carrying
    snapshots (workloads.StorageWaves: the PVC default/claim-wffc-0 replaced
    from wave 5 on) at depth 1 and 0: the JAX loop's digests and HoistCache
    actions; the encoder on the delta path but for one rebuild, at wave 5."""
    from kubernetes_tpu_torch.bench import workloads as w

    return run_warm_loop("config4s-warm", snap, cold, w.CONFIG4S_WARM_DIGESTS, w.CONFIG4S_WARM_ACTIONS,
                         w.CONFIG4S_SCHEDULED, WAVE_KERNELS, "class_waves", waves_cls=lambda: w.StorageWaves(snap),
                         want_stats=w.CONFIG4S_WARM_STATS)


def phase_config4s_sidecar(snap, cold) -> None:
    """Config4S through the wire: the port's TPUScoreClient (session mode;
    it resolves volumes before the wire and fingerprints the raw storage
    state) against the port's TPUScoreServer(engine=_Engine(device="cuda"))
    on loopback, wave 1 and then [config4s-warm]'s waves 2..7 (each submit
    returns the previous wave's verdicts, as the loop's).  Verdicts: wave 1
    == the in-process dense step's, waves 2..7 == [config4s-warm]'s digests;
    the client's calls: full, delta x 3, full at the PVC change, delta x 2;
    each call the server's device fixpoint (the client's gang=True)."""
    import torch

    from kubernetes_tpu_torch.bench import workloads as w
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.runtime.client import TPUScoreClient
    from kubernetes_tpu_torch.runtime.sidecar import TPUScoreServer, _Engine

    # a threshold above any wave: every cold session is served inline (no
    # not_ready round trip)
    eng = _Engine(warmup_threshold=1 << 62, device="cuda")
    seen = {}
    observe = eng.metrics.observe

    def record(name, v):
        seen.setdefault(name, []).append(v)
        observe(name, v)

    eng.metrics.observe = record
    srv = TPUScoreServer(engine=eng)
    srv.start()
    client = TPUScoreClient(f"127.0.0.1:{srv.port}")
    on_c_path(client._interner, "config4s-sidecar")
    walls, pending = [], []
    try:
        def call(s):
            t0 = time.perf_counter()
            v = client.schedule(s, deadline_ms=600_000)
            walls.append(time.perf_counter() - t0)
            return {p.name: v[p.uid] for p in s.pending_pods}

        kernels.reset_launches()
        first = call(snap)
        check(first == w.verdicts_of(cold[0].cpu().numpy(), cold[1]), "config4s-sidecar: wave 1 != the card route")
        stats1 = dict(client.stats)

        def submit(s):
            pending.append(call(s))
            return pending[-2] if len(pending) > 1 else None

        waves, fetched, _, _ = w.warm_waves(snap, first, submit, lambda: pending[-1], w.StorageWaves(snap))
        torch.cuda.synchronize()
        launches = counted()
    finally:
        client.close()
        srv.stop()
    names = [nd.name for nd in snap.nodes]
    digests = {k: w.wave_digest(waves[k], fetched[k], names) for k in sorted(fetched) if k >= 2}
    st = client.stats
    print(f"[config4s-sidecar] client stats after wave 1 {stats1}, after wave 7 {st}; launches {launches}; "
          f"digests {digests}", flush=True)
    keys = ("decode", "encode", "dispatch", "step", "schedule")
    for i, wall in enumerate(walls):
        parts = ", ".join(f"sidecar_{k}_seconds {seen[f'sidecar_{k}_seconds'][i]:.4f}" for k in keys
                          if len(seen.get(f"sidecar_{k}_seconds", ())) > i)
        print(f"[config4s-sidecar] wave {i + 1}: client wall {wall:.4f} s ({'full' if i in (0, 4) else 'delta'}); "
              f"server: {parts}", flush=True)
    check(digests == w.CONFIG4S_WARM_DIGESTS, "config4s-sidecar: waves 2..7 differ from [config4s-warm]")
    check((stats1["full"], stats1["delta"]) == (1, 0) and (st["full"], st["delta"]) == (2, 5)
          and st["resync"] == st["not_ready"] == 0, f"config4s-sidecar: client stats {st}")
    # the client's gang=True (its default, as a scheduler sends it): the
    # server's device fixpoint on the dense route, G = 1 (no groups), so one
    # real and one gated iteration a call
    check(launches == {k: 2 * len(walls) for k in (*DENSE_KERNELS, "gang_quorum")},
          f"config4s-sidecar: launches {launches}")


def phase_dra_small() -> None:
    """Device claims on the card: workloads.dra_small (ResourceSlices, two
    overlapping DeviceClasses, a ReadWriteOncePod claim shared by three
    pods) resolved by the encoder, then its default route (dense: K7 + K8)
    and the per-pod route (chunked=False: K1 + K2), each counted: the JAX
    choices digest."""
    import torch

    from kubernetes_tpu_torch.api.delta import DeltaEncoder
    from kubernetes_tpu_torch.bench import workloads as w
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, infer_score_config, kernels

    arr, meta = DeltaEncoder().encode_device(w.dra_small())
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    n = meta.n_pods
    check(list(meta.resources) == w.DRA_SMALL_RESOURCES, f"dra-small: resources {meta.resources}")
    for route, kw, need in (("default", {}, DENSE_KERNELS), ("per-pod", dict(chunked=False), PER_POD_KERNELS)):
        kernels.reset_launches()
        c, _ = assign.schedule_batch(arr, cfg, **kw)
        torch.cuda.synchronize()
        launches = counted(default=not kw)
        sha = hashlib.sha256(c[:n].cpu().numpy().astype("<i4").tobytes()).hexdigest()
        scheduled = int((c[:n] >= 0).sum())
        print(f"[dra-small] {route} route: P {arr.P}, N {arr.N}, R {arr.R}, scheduled {scheduled}/{n}, "
              f"choices sha256 {sha}, launches {launches}", flush=True)
        check(set(launches) == set(need), f"dra-small {route}: launches {launches}")
        check((scheduled, sha) == (w.DRA_SMALL_SCHEDULED, w.DRA_SMALL_CHOICES_SHA256),
              f"dra-small {route}: differs from JAX")


SPLIT_SPANS = ("batch.cycle", "batch.encode", "batch.kernel", "batch.commit", "batch.explain", "commit_overlap")


def span_split(col) -> dict:
    """Host seconds summed per span name over a traced Scheduler run: the
    cycles, their encode (host encode + to_device), kernel (class state,
    dispatch, the commit overlap, finish and the one read back) and commit
    (binds, or their deferral, and the failure loop: diagnosis, preemption)
    spans, the diagnosis inside the commit, and the deferred binds'
    publication (commit_overlap: inside the next cycle's kernel span, or at
    run_until_idle's end)."""
    out = dict.fromkeys(SPLIT_SPANS, 0.0)
    for sp in col.spans():
        if sp.name in out and sp.end is not None:
            out[sp.name] += sp.end - sp.start
    check(col.spans_dropped == 0, f"the trace ring wrapped ({col.spans_dropped} spans dropped)")
    return out


def split_text(split: dict) -> str:
    return ", ".join(f"{k} {v:.3f}" for k, v in split.items())


def scheduler_run(tag: str, snap_fn, want: dict, need, card: str, mode: str = "tpu",
                  traced_runs: tuple = (False, True)) -> dict:
    """A snapshot through the port's Scheduler on the card, as users run it:
    bench/harness.py run_snapshot_workload(..., mode) (setup_cluster, then
    run_until_idle), on a fresh store for each of `traced_runs`: untraced,
    as the harness runs it by default (every count set to 0 just before:
    the kernels `need` launched; in mode="native" none, a successful cycle
    places nothing on the card), then traced by a TraceCollector(enabled=
    True) for the span split.  Each run gives the JAX Scheduler's Scheduled
    / FailedScheduling counts, batch cycles and bindings digest.  -> the
    runs' results by traced."""
    import torch

    from kubernetes_tpu_torch.bench.harness import run_snapshot_workload
    from kubernetes_tpu_torch.ops import assign, kernels
    from kubernetes_tpu_torch.scheduler.tracing import TraceCollector

    runs = {}
    for traced in traced_runs:
        snap = snap_fn()
        col = TraceCollector(capacity=1 << 19, enabled=True) if traced else None
        kernels.reset_launches()
        assign.reset_trace_counts()
        r = run_snapshot_workload(tag, snap, mode, device="cuda", collector=col)
        torch.cuda.synchronize()
        launches = counted(default=not traced)
        routes = {k: v for k, v in assign.TRACE_COUNTS.items() if v}
        sched = r.pop("scheduler")
        hoist = sched._hoist_cache.history if sched._hoist_cache is not None else []
        got = dict(scheduled=r["scheduled"], unschedulable=r["unschedulable"], batches=r["batches"],
                   bindings=r["bindings_sha256"])
        print(f"[{tag}] mode={mode} {'traced' if traced else 'untraced'}: {len(snap.nodes)} nodes, "
              f"{len(snap.pending_pods)} pods: run_until_idle wall {r['wall_s']:.3f} s, {r['pods_per_sec']:.1f} pods/s, batches "
              f"{r['batches']} (batch p50 {r['batch_p50_ms']:.1f} ms, p99 {r['batch_p99_ms']:.1f} ms), scheduled "
              f"{r['scheduled']}, unschedulable {r['unschedulable']}, bindings sha256 {r['bindings_sha256']}; encoder "
              f"{sched._delta_enc.stats}, HoistCache {[h['action'] for h in hoist]}; routes {routes}, launches "
              f"{launches}; {card}", flush=True)
        check(got == want, f"{tag}: {got} differs from the JAX Scheduler's {want}")
        on_c_path(sched._delta_enc._interner, tag)
        if mode == "native":
            check(not launches, f"{tag}: a native cycle with no failed pod launched {launches}")
            check(sched._hoist_cache is None, f"{tag}: native mode built class state")
        else:
            check(set(need) <= set(launches), f"{tag}: launches {launches}, want every one of {need}")
        runs[traced] = r
        if traced:
            split = span_split(col)
            print(f"[{tag}] mode={mode} span split (host s, traced): {split_text(split)}; outside the cycles' "
                  f"spans (the queue's pop_all, the drain) "
                  f"{r['wall_s'] - split['batch.cycle'] - split['commit_overlap']:.3f}"
                  + (f"; tracing cost {r['wall_s'] - runs[False]['wall_s']:.3f} s of wall" if False in runs else ""),
                  flush=True)
        del snap, sched, r
    return runs


def phase_scheduler_config4(card: str) -> float:
    """BASELINE Config4, heterogeneous(20000, 20000, seed=0), not cut, through
    the Scheduler: one batch cycle on the class-wave route (K3 + K4 by
    HoistCache.ensure, then K5 + K6); with the default GangScheduling gate
    on, the cycle takes the gang fixpoint and binds synchronously (as in
    the JAX package).  Then once more with the gate off: the routed
    non-gang branch (dispatch, the deferred binds' flush, finish, one read
    back), its 20000 binds deferred into the drain at run_until_idle's end.
    Then the commit overlap itself (scheduler_two_profiles)."""
    import torch

    from kubernetes_tpu_torch.bench import workloads as w
    from kubernetes_tpu_torch.bench.harness import run_snapshot_workload
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.scheduler import SchedulerConfiguration

    runs = scheduler_run("scheduler-config4", lambda: w.heterogeneous(**w.SCHEDULER_CONFIG4),
                         w.SCHEDULER_CONFIG4_WANT, WAVE_KERNELS, card)
    kernels.reset_launches()
    r = run_snapshot_workload("scheduler-config4", w.heterogeneous(**w.SCHEDULER_CONFIG4), "tpu", device="cuda",
                              config=SchedulerConfiguration(mode="tpu", feature_gates=NO_GANGS))
    torch.cuda.synchronize()
    launches = counted()
    flush = r.pop("scheduler").metrics.hists.get("pipeline_deferred_commit_seconds")
    got = dict(scheduled=r["scheduled"], unschedulable=r["unschedulable"], batches=r["batches"],
               bindings=r["bindings_sha256"])
    print(f"[scheduler-config4] GangScheduling off (the non-gang branch): wall {r['wall_s']:.3f} s, "
          f"{r['pods_per_sec']:.1f} pods/s, bindings sha256 {r['bindings_sha256']}; deferred flushes "
          f"{flush.count if flush else 0}, {flush.sum if flush else 0.0:.3f} s publishing; launches {launches}",
          flush=True)
    check(got == w.SCHEDULER_CONFIG4_WANT, f"scheduler-config4 (gangs off): {got}")
    check(flush is not None and flush.count == 1, "scheduler-config4 (gangs off): the binds were not deferred")
    check(set(WAVE_KERNELS) <= set(launches), f"scheduler-config4 (gangs off): launches {launches}")
    scheduler_two_profiles(card)
    return runs[False]["wall_s"]



def scheduler_two_profiles(card: str) -> None:
    """The commit overlap on the card: Config4's pods split between two
    profiles (bench/workloads.py two_profile_split), GangScheduling off, so
    each batch cycle runs the two profiles' programs back to back and the
    second one's device window (dispatch, the flush, finish) publishes the
    first one's deferred binds.  At heterogeneous(2000, 2000, seed=0),
    traced: the JAX Scheduler's counts, bindings digest and overlapped
    binds.  At Config4's full size, traced, with the overlap and without it
    (pipeline_commit=False, the binds synchronous): the same bindings, and
    the overlap's pods inside the second kernel span.  -> the un-killed
    untraced run's wall."""
    import dataclasses

    import torch

    from kubernetes_tpu_torch.bench import workloads as w
    from kubernetes_tpu_torch.bench.harness import overlapped_binds, run_snapshot_workload
    from kubernetes_tpu_torch.ops import assign, kernels
    from kubernetes_tpu_torch.scheduler import Profile, SchedulerConfiguration
    from kubernetes_tpu_torch.scheduler.tracing import TraceCollector

    cfg = SchedulerConfiguration(mode="tpu", feature_gates=NO_GANGS,
                                 profiles=(Profile(), Profile(scheduler_name=w.SECOND_PROFILE)))
    full = {}
    for size, pipeline_commit in ((w.SCHEDULER_TWO_PROFILES, True), (w.SCHEDULER_CONFIG4, True),
                                  (w.SCHEDULER_CONFIG4, False)):
        snap = w.two_profile_split(w.heterogeneous(**size))
        col = TraceCollector(capacity=1 << 19, enabled=True)
        kernels.reset_launches()
        assign.reset_trace_counts()
        r = run_snapshot_workload("scheduler-two-profiles", snap, "tpu", device="cuda", collector=col,
                                  config=dataclasses.replace(cfg, pipeline_commit=pipeline_commit))
        torch.cuda.synchronize()
        launches = counted()
        routes = {k: v for k, v in assign.TRACE_COUNTS.items() if v}
        r.pop("scheduler")
        got = dict(scheduled=r["scheduled"], unschedulable=r["unschedulable"], batches=r["batches"],
                   overlapped=overlapped_binds(col), bindings=r["bindings_sha256"])
        split = span_split(col)
        print(f"[scheduler-config4] two profiles, GangScheduling off, {len(snap.nodes)} nodes, "
              f"{len(snap.pending_pods)} pods, {'overlapped commit' if pipeline_commit else 'synchronous binds'}, traced: "
              f"run_until_idle wall {r['wall_s']:.3f} s, {r['pods_per_sec']:.1f} pods/s, {got}; routes {routes}, "
              f"launches {launches}; span split (host s): {split_text(split)}; {card}",
              flush=True)
        check(set(WAVE_KERNELS) <= set(launches), f"scheduler-two-profiles: launches {launches}")
        if size is w.SCHEDULER_TWO_PROFILES:
            check(got == w.SCHEDULER_TWO_PROFILES_WANT, f"scheduler-two-profiles: {got} differs from the JAX "
                  f"Scheduler's {w.SCHEDULER_TWO_PROFILES_WANT}")
            continue
        full[pipeline_commit] = got
        del snap, r
    check(full[True]["overlapped"] > 0, "scheduler-two-profiles: no bind was published inside a kernel span")
    check(full[False]["overlapped"] == 0 and {k: v for k, v in full[True].items() if k != "overlapped"}
          == {k: v for k, v in full[False].items() if k != "overlapped"},
          f"scheduler-two-profiles: the overlapped run {full[True]} differs from the synchronous one {full[False]}")


def phase_scheduler_config5(card: str) -> None:
    """BASELINE Config5, gang(1000, 64, 2000, seed=0), not cut, through the
    Scheduler: the gang branch, the host fixpoint on class state (one
    iteration: K3 + K4, K5 + K6)."""
    from kubernetes_tpu_torch.bench import workloads as w

    scheduler_run("scheduler-config5", lambda: w.gang(**w.SCHEDULER_CONFIG5), w.SCHEDULER_CONFIG5_WANT, WAVE_KERNELS,
                  card)


def phase_scheduler_preempt(card: str, mode: str = "tpu") -> None:
    """The preemption bench's build(20000, 1000) loaded into a store as the
    JAX bench builds it (nodes, the 40000 bound fillers, the 1000
    preemptors), then the Scheduler, then one schedule_batch() cycle under
    KTPU_EXPLAIN=1, untraced (counted) and then traced on a fresh store:
    the class-wave step (K3 + K4, K5 + K6; in mode="native" the C++ engine
    on the host arrays, no launch) fails every preemptor, the diagnosis
    (K14) and BatchedPreemption's waves (K3 + K15) evict 1000 fillers and
    nominate 1000 nodes: the JAX Scheduler's failure_outcome digest."""
    import torch

    from kubernetes_tpu_torch.bench import preempt_bench as pb
    from kubernetes_tpu_torch.bench import workloads as w
    from kubernetes_tpu_torch.bench.harness import failure_outcome
    from kubernetes_tpu_torch.ops import assign, kernels
    from kubernetes_tpu_torch.scheduler import ClusterStore, Scheduler, SchedulerConfiguration
    from kubernetes_tpu_torch.scheduler.tracing import TraceCollector

    need = ("class_static_hoist", "explain_counts", "preempt_eval")
    if mode == "tpu":
        need = WAVE_KERNELS + need
    tag = "scheduler-preempt" if mode == "tpu" else "scheduler-native"
    old = os.environ.get("KTPU_EXPLAIN")
    os.environ["KTPU_EXPLAIN"] = "1"
    walls = {}
    try:
        for traced in (False, True):
            snap = pb.build(**w.PREEMPT)
            store = ClusterStore()
            for nd in snap.nodes:
                store.add_node(nd)
            for p in snap.bound_pods + snap.pending_pods:
                store.add_pod(p)
            col = TraceCollector(capacity=1 << 19, enabled=traced)
            sched = Scheduler(store, SchedulerConfiguration(mode=mode), collector=col, device="cuda")
            before = [p.name for p in store.pods.values()]
            kernels.reset_launches()
            assign.reset_trace_counts()
            t0 = time.perf_counter()
            sched.schedule_batch()
            torch.cuda.synchronize()
            wall = walls[traced] = time.perf_counter() - t0
            launches = counted(default=not traced)
            routes = {k: v for k, v in assign.TRACE_COUNTS.items() if v}
            out = failure_outcome(before, sched)
            print(f"[{tag}] mode={mode} {'traced' if traced else 'untraced'}: build(20000, 1000), one "
                  f"schedule_batch() under KTPU_EXPLAIN=1: wall {wall:.3f} s, {w.PREEMPT['n_pre'] / wall:.1f} "
                  f"preemptors/s (scheduled {len(sched.events.by_reason('Scheduled'))}), evicted "
                  f"{len(out['evicted'])}, nominated {len(out['nominated'])}, messages {out['messages']}, "
                  f"preemption_victims {sched.metrics.counters.get('preemption_victims', 0)}, outcome sha256 "
                  f"{out['sha256']}; routes {routes}, launches {launches}; {card}", flush=True)
            check(len(out["evicted"]) == w.SCHEDULER_PREEMPT_EVICTED, f"{tag}: evictions")
            check(len(out["nominated"]) == w.SCHEDULER_PREEMPT_NOMINATED, f"{tag}: nominations")
            check(out["messages"] == w.SCHEDULER_PREEMPT_MESSAGES, f"{tag}: messages {out['messages']}")
            check(out["sha256"] == w.SCHEDULER_PREEMPT_OUTCOME_SHA256, f"{tag}: outcome differs from the JAX one")
            check(set(need) <= set(launches), f"{tag}: launches {launches}, want every one of {need}")
            on_c_path(sched._delta_enc._interner, tag)
            if mode == "native":
                check(not set(launches) & {"class_usage_hoist", "wave_commit", "chunk_rounds"},
                      f"{tag}: the engine's cycle launched a commit kernel: {launches}")
            if traced:
                split = span_split(col)
                print(f"[{tag}] mode={mode} span split (host s, traced): {split_text(split)}; the failure loop "
                      f"(commit less the diagnosis) {split['batch.commit'] - split['batch.explain']:.3f}; tracing "
                      f"cost {wall - walls[False]:.3f} s of wall", flush=True)
            del snap, store, sched
    finally:
        if old is None:
            os.environ.pop("KTPU_EXPLAIN")
        else:
            os.environ["KTPU_EXPLAIN"] = old


def phase_scheduler_native(card: str) -> None:
    """BASELINE Config1, Config2 and Config3 (workloads.SCHEDULER_BASELINE),
    seed 0, not cut, through run_until_idle: in mode="native" untraced and
    traced (the C++ engine; no launch), then in mode="tpu" untraced (the
    class-wave route for 1 and 2: K3 + K4, K5 + K6; rounds on class state
    for 3: K3 + K4, K12); every run the JAX Scheduler's digest.  Then the
    failing cycle of [scheduler-preempt] in mode="native"."""
    from kubernetes_tpu_torch.bench import workloads as w

    need = {"config1": WAVE_KERNELS, "config2": WAVE_KERNELS,
            "config3": ("class_static_hoist", "class_usage_hoist", "rounds")}
    for key, (gen, args, want) in w.SCHEDULER_BASELINE.items():
        def snap_fn(gen=gen, args=args):
            return getattr(w, gen)(*args, seed=0)

        nat = scheduler_run(f"scheduler-native {key}", snap_fn, want, (), card, mode="native")
        tpu = scheduler_run(f"scheduler-native {key}", snap_fn, want, need[key], card, mode="tpu",
                            traced_runs=(False,))
        print(f"[scheduler-native] {key} {gen}{args}: untraced wall native {nat[False]['wall_s']:.3f} s "
              f"({nat[False]['pods_per_sec']:.1f} pods/s), tpu {tpu[False]['wall_s']:.3f} s "
              f"({tpu[False]['pods_per_sec']:.1f} pods/s); both the JAX digest; {card}", flush=True)
    phase_scheduler_preempt(card, mode="native")


@contextlib.contextmanager
def env_var(name: str, value):
    """os.environ[name] = value (None: unset) inside the block."""
    old = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


@contextlib.contextmanager
def restore_probe():
    """Records each Scheduler.restore while open: its report, its wall, the
    launch counts just before it and the instance restored."""
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.scheduler import Scheduler

    seen = []
    orig = Scheduler.restore

    def restore(self, killed_site=None):
        at = dict(kernels.LAUNCHES)
        t0 = time.perf_counter()
        rep = orig(self, killed_site=killed_site)
        t1 = time.perf_counter()
        seen.append(dict(report=rep, restore_s=t1 - t0, t_end=t1, launches=at, sched=self))
        return rep

    Scheduler.restore = restore
    try:
        yield seen
    finally:
        Scheduler.restore = orig


def restart_run(tag: str, snap, want: dict, spec: str, card: str, config=None, armed=False, ha=False,
                need=WAVE_KERNELS, unkilled_s=None) -> dict:
    """One snapshot through setup_cluster, then run_restartable (ha: the
    standby takeover, run_ha_restartable) under the kill plan `spec`, every
    count set to 0 just before: the restarts the plan makes, the JAX
    Scheduler's bindings digest and Scheduled count, every kernel of `need`
    launched again after the last restore, the replacement's first
    HoistCache action a full hoist.  `armed`: a checkpoint dir in a fresh
    temporary directory (KTPU_CHECKPOINT_DIR), else crash-only."""
    import torch

    from kubernetes_tpu_torch import chaos
    from kubernetes_tpu_torch.bench.harness import bindings_digest, ha_fields, setup_cluster
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.scheduler import run_ha_restartable, run_restartable

    ckpt = tempfile.mkdtemp(prefix="ktpu-ckpt-") if armed else None
    try:
        with env_var("KTPU_CHECKPOINT_DIR", ckpt):
            sched = setup_cluster(snap, "tpu", device="cuda", config=config)
            torch.cuda.synchronize()
            kernels.reset_launches()
            with restore_probe() as seen, chaos.chaos_plan(chaos.FaultPlan.parse(spec)):
                t0 = time.perf_counter()
                if ha:
                    final, restarts = run_ha_restartable(sched)
                else:
                    final, restarts = run_restartable(sched)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launches = counted()
    finally:
        if ckpt is not None:
            shutil.rmtree(ckpt, ignore_errors=True)
    last = seen[-1] if seen else None
    after = {k: v - last["launches"].get(k, 0) for k, v in kernels.LAUNCHES.items()} if last else {}
    hoist = [h["action"] for h in final._hoist_cache.history] if final._hoist_cache is not None else []
    got = dict(scheduled=len(final.events.by_reason("Scheduled")),
               unschedulable=len(final.events.by_reason("FailedScheduling")),
               bindings=bindings_digest(final.store.pods.values()))
    want_got = {k: want[k] for k in got}
    repl_s = wall - (last["t_end"] - t0) if last else 0.0
    reports = [(x["report"], round(x["restore_s"], 4)) for x in seen]
    print(f"[{tag}] {spec}{' (armed)' if armed else ' (crash-only)'}{' (HA takeover)' if ha else ''}: "
          f"restarts {restarts}, {got}; run wall {wall:.3f} s"
          + (f" (un-killed {unkilled_s:.3f} s)" if unkilled_s is not None else "")
          + f", restore reports and walls (s) {reports}, the replacement's run {repl_s:.3f} s; HoistCache "
          f"{hoist}; launches {launches}, after the last restore "
          f"{ {k: v for k, v in after.items() if v} }; {card}", flush=True)
    if ha:
        print(f"[{tag}] ha_fields {ha_fields(final.metrics)}; {card}", flush=True)
    check(got == want_got, f"{tag} {spec}: {got} differs from the JAX Scheduler's {want_got}")
    check(restarts == spec.count(";") + 1 and len(seen) == restarts, f"{tag} {spec}: restarts {restarts}")
    if need:  # the replacement ran a cycle (after a kill mid-flush the WAL replay may publish every pod)
        check(hoist[:1] == ["static_rebuild"], f"{tag} {spec}: the replacement's first HoistCache action {hoist[:1]}")
    for k in need:
        check(after.get(k, 0) > 0, f"{tag} {spec}: {k} was not launched after the restore: {after}")
    return dict(wall=wall, restarts=restarts, reports=reports, replacement_s=repl_s, restore_s=last["restore_s"],
                metrics=final.metrics)


def phase_scheduler_restart(card: str, unkilled_s: float) -> None:
    """The Scheduler's crash restart on the card (see the module docstring):
    BASELINE Config4 crash-only, Config1 armed and under HA takeover, and
    basic(1000, 1000) armed beside unarmed, each held to the JAX
    Scheduler's digest."""
    import torch

    from kubernetes_tpu_torch.bench import workloads as w
    from kubernetes_tpu_torch.bench.harness import ha_fields, run_snapshot_workload
    from kubernetes_tpu_torch.scheduler import SchedulerConfiguration
    from kubernetes_tpu_torch.scheduler import checkpoint as ck

    t_phase = time.perf_counter()
    c4, price = w.SCHEDULER_CONFIG4, (1000, 1000)
    for spec in (f"kill.post_assume:kill@{c4['n_pods'] // 2}", "kill.mid_step:kill@0"):
        restart_run("scheduler-restart", w.heterogeneous(**c4), w.SCHEDULER_CONFIG4_WANT, spec, card,
                    unkilled_s=unkilled_s)
    gen, args, want_c1 = w.SCHEDULER_BASELINE["config1"]
    for site in RESTART_SITES:
        # one batch cycle: kill.mid_step's first poke is the only one, so
        # every site is killed @0; the deferred flush needs the gang gate off
        # (the WAL replay then publishes every deferred bind: the
        # replacement may have nothing left to schedule)
        flush = site == "kill.mid_flush"
        cfg = SchedulerConfiguration(mode="tpu", feature_gates=NO_GANGS) if flush else None
        r = restart_run("scheduler-restart", getattr(w, gen)(*args, seed=0), want_c1, f"{site}:kill@0", card,
                        config=cfg, armed=True, need=() if flush else WAVE_KERNELS)
        rep = r["reports"][-1][0]
        print(f"[scheduler-restart] config1 armed {site}: wal_applied {rep['wal_applied']}, wal_skipped "
              f"{rep['wal_skipped']}, reconciled_assumed {rep['reconciled_assumed']}, wave_requeued "
              f"{rep['wave_requeued']}; {card}", flush=True)
    ha = restart_run("scheduler-restart", getattr(w, gen)(*args, seed=0), want_c1,
                     "kill.post_assume:kill@0;kill.post_checkpoint:kill@30", card, armed=True, ha=True)
    block = ha_fields(ha["metrics"])
    check(block["failover_count"] == 2 and block["leader_election_transitions_total"] == 2
          and block["failover_p99_ms"] > 0, f"scheduler-restart HA: {block}")
    # the price of arming: every assume (and WAL append, wave clear, flush)
    # saves the whole ledger and arrival table, fsync'd
    saves = {"n": 0, "s": 0.0}
    orig = ck.CheckpointManager.save

    def timed_save(self, name, data):
        t = time.perf_counter()
        orig(self, name, data)
        saves["n"] += 1
        saves["s"] += time.perf_counter() - t

    walls = {}
    ck.CheckpointManager.save = timed_save
    try:
        for armed in (False, True):
            d = tempfile.mkdtemp(prefix="ktpu-ckpt-") if armed else None
            try:
                with env_var("KTPU_CHECKPOINT_DIR", d):
                    r = run_snapshot_workload("price", w.basic(*price, seed=0), "tpu", device="cuda")
                    torch.cuda.synchronize()
            finally:
                if d is not None:
                    shutil.rmtree(d, ignore_errors=True)
            check(r["scheduled"] == price[1], f"scheduler-restart price: scheduled {r['scheduled']}")
            walls[armed] = (r["wall_s"], r["bindings_sha256"])
    finally:
        ck.CheckpointManager.save = orig
    check(walls[True][1] == walls[False][1], "scheduler-restart price: armed and unarmed bindings differ")
    print(f"[scheduler-restart] price of arming, basic{price} un-killed: wall unarmed {walls[False][0]:.3f} s, armed "
          f"{walls[True][0]:.3f} s, {saves['n']} checkpoint saves, {saves['s']:.3f} s saving, "
          f"{1e3 * saves['s'] / max(1, saves['n']):.3f} ms a save; {card}", flush=True)
    print(f"[scheduler-restart] phase {time.perf_counter() - t_phase:.1f} s; {card}", flush=True)


RESTART_SITES = ("kill.post_assume", "kill.post_checkpoint", "kill.mid_flush", "kill.mid_step")
STREAM_SITES = ("kill.submit@2", "kill.dispatch@2", "kill.collect@2", "kill.drain@0")


def phase_stream_restart(cold, card: str) -> None:
    """run_stream_restartable over bench.py's warm waves of the north star
    (see the module docstring), held to the JAX loop's digests; `cold` is
    wave 1's (choices, meta)."""
    import torch

    from kubernetes_tpu_torch import chaos
    from kubernetes_tpu_torch.api.delta import DeltaEncoder
    from kubernetes_tpu_torch.api.snapshot import Snapshot
    from kubernetes_tpu_torch.bench import workloads as w
    from kubernetes_tpu_torch.ops import kernels
    from kubernetes_tpu_torch.parallel.pipeline import PipelinedBatchLoop, load_stream_wal, run_stream_restartable
    from kubernetes_tpu_torch.scheduler.checkpoint import CheckpointManager
    from kubernetes_tpu_torch.scheduler.metrics import Metrics

    t_phase = time.perf_counter()
    snap, want = w.heterogeneous(**w.NORTH_STAR), w.NORTH_STAR_WARM_DIGESTS
    names = [nd.name for nd in snap.nodes]
    choices, meta = cold
    first = w.verdicts_of(torch.as_tensor(choices).cpu().numpy(), meta)
    enc = DeltaEncoder("cuda")
    enc.encode_device(snap)
    loop = PipelinedBatchLoop(encoder=enc, depth=1)
    snaps = []

    def submit(sw):
        snaps.append(sw)
        return loop.submit(sw)

    waves, fetched, _, _ = w.warm_waves(snap, first, submit, loop.drain, Snapshot)
    torch.cuda.synchronize()
    del loop, enc, waves

    def digests(results) -> dict:
        return {k + 2: w.wave_digest(sw.pending_pods, v, names) for k, (sw, v) in enumerate(zip(snaps, results))}

    check(digests([fetched[k] for k in range(2, 8)]) == want, "stream-restart: the built waves differ from JAX")

    def stream(spec):
        d = tempfile.mkdtemp(prefix="ktpu-stream-")
        ckpt, metrics, commits, loops = CheckpointManager(d), Metrics(), [], []

        def make(commit, wal):
            def commit_once(v):
                commits.append(1)
                commit(v)
            loops.append(PipelinedBatchLoop(depth=1, commit=commit_once, wal=wal, metrics=metrics, device="cuda"))
            return loops[-1]

        kernels.reset_launches()
        try:
            with chaos.chaos_plan(chaos.FaultPlan.parse(spec)) if spec else contextlib.nullcontext():
                t0 = time.perf_counter()
                results, restarts = run_stream_restartable(snaps, make, checkpoint=ckpt, metrics=metrics)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            ledger = load_stream_wal(ckpt)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        launches = counted()
        h = metrics.hists.get("failover_duration_seconds")
        blackouts = h.count if h is not None else 0
        check(digests(results) == want, f"stream-restart {spec}: wave digests differ from the JAX loop's")
        check(sorted(ledger) == list(range(len(snaps))) and len(commits) == len(snaps),
              f"stream-restart {spec}: stream WAL {sorted(ledger)}, {len(commits)} commits")
        check(restarts == (1 if spec else 0) and blackouts == restarts,
              f"stream-restart {spec}: restarts {restarts}, failover observations {blackouts}")
        # no pipeline.step fault is injected here: a wave replayed on the
        # dense route would hide a faulty class-wave kernel
        recovered = [lp.stats["recovered"] for lp in loops]
        check(not any(recovered), f"stream-restart {spec}: waves recovered {recovered}")
        return wall, launches, (h.sum if h is not None else 0.0)

    base, launches, _ = stream(None)
    print(f"[stream-restart] un-killed: {len(snaps)} fixed warm waves through run_stream_restartable (depth 1, "
          f"armed): wall {base:.3f} s, launches {launches}; {card}", flush=True)
    walls = {}
    for site in STREAM_SITES:
        spec = site.replace("@", ":kill@")
        wall, launches, blackout = stream(spec)
        walls[spec] = wall
        print(f"[stream-restart] {spec}: restarts 1, the JAX digests, stream WAL waves 0..{len(snaps) - 1} once, "
              f"wall {wall:.3f} s (un-killed {base:.3f} s: the kill costs {wall - base:.3f} s), blackout "
              f"{blackout:.4f} s; launches {launches}; {card}", flush=True)
    again, _, _ = stream(None)
    print(f"[stream-restart] un-killed again: wall {again:.3f} s (first {base:.3f} s); the kills cost "
          f"{ {k: round(v - (base + again) / 2, 3) for k, v in walls.items()} } s over their mean; {card}",
          flush=True)
    plain = None
    for action in (None, "error", "nan"):
        loop = PipelinedBatchLoop(depth=1, device="cuda", metrics=Metrics())
        kernels.reset_launches()
        spec = f"pipeline.step:{action}@2" if action else None
        with chaos.chaos_plan(chaos.FaultPlan.parse(spec)) if spec else contextlib.nullcontext():
            t0 = time.perf_counter()
            results = list(loop.run(snaps))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = counted()
        check(loop.stats["recovered"] == (1 if action else 0) and digests(results) == want,
              f"stream-restart {spec}: recovered {loop.stats['recovered']}")
        if action is None:
            plain = wall
            print(f"[stream-restart] the same waves through PipelinedBatchLoop.run, no fault: wall {wall:.3f} s; "
                  f"launches {launches}; {card}", flush=True)
            continue
        print(f"[stream-restart] {spec} through PipelinedBatchLoop.run: recovered 1 (serial replay), the JAX "
              f"digests, wall {wall:.3f} s (no fault {plain:.3f} s); launches {launches}; {card}", flush=True)
    print(f"[stream-restart] phase {time.perf_counter() - t_phase:.1f} s; {card}", flush=True)


def phase_env() -> None:
    """Whether the sidecar's wire modules exist on this machine (no phase
    depends on it)."""
    import importlib
    import importlib.util

    found = {}
    for name, parent in (("grpc", None), ("google.protobuf", "google")):
        ok = (parent is None or importlib.util.find_spec(parent) is not None) and \
            importlib.util.find_spec(name) is not None
        found[name] = getattr(importlib.import_module(name), "__version__", "?") if ok else None
    print(f"[env] grpc {found['grpc'] or 'absent'}, google.protobuf {found['google.protobuf'] or 'absent'}",
          flush=True)


def explain_bound(arr, F: int) -> tuple:
    """K14's least time: every input read once (the node planes, the term
    tables, F pod rows), the counts written once; the operations, per
    (rep, node), the taint, term, pin and fit tests (score_explain.k14_work)."""
    from kubernetes_tpu_torch.bench.score_explain import k14_work

    return bound(*k14_work(arr, F))


def phase_explain_north_star(ns) -> dict:
    """explain_classes over every north-star class at the dense step's
    post-step usage: the widest call a north-star cycle can make."""
    import torch

    from kubernetes_tpu_torch.api.delta import class_groups
    from kubernetes_tpu_torch.bench import score_explain
    from kubernetes_tpu_torch.bench import workloads as w
    from kubernetes_tpu_torch.ops import explain, kernels

    arr, meta, used = ns["arr"], ns["meta"], ns["used"]
    reps, _ = class_groups(meta, range(meta.n_pods))
    check(reps.size == w.NORTH_STAR_EXPLAIN_REPS, f"explain-north-star: {reps.size} classes")
    kernels.reset_launches()
    t0 = time.perf_counter()
    counts = explain.explain_classes(arr, reps, used)
    explain_s = time.perf_counter() - t0
    launched = counted()
    check(launched == {"explain_counts": 1}, f"explain-north-star launches {launched}")
    digest = hashlib.sha256(counts.astype("<i8").tobytes()).hexdigest()
    check(digest == w.NORTH_STAR_EXPLAIN_SHA256, "explain-north-star: counts differ from JAX")
    check(bool((counts.sum(axis=1) == meta.n_nodes).all()), "explain-north-star: a row misses nodes")
    F = explain._pad_pow2(reps.size)
    pr = torch.zeros(F, dtype=torch.int64, device=arr.device)
    pr[: reps.size] = torch.from_numpy(reps).to(arr.device)
    rv = torch.arange(F, device=arr.device) < reps.size
    k = kernels.explain_counts(arr, used, pr, rv)
    p = explain.explain_counts_plain(arr, used, pr, rv)
    err = int((k - p).abs().max())
    check(err == 0 and torch.equal(k[: reps.size].cpu().to(torch.int64), torch.from_numpy(counts)),
          "explain-north-star: explain_counts != plain")
    k14_ms = cuda_ms(lambda: kernels.explain_counts(arr, used, pr, rv), reps=50, warmup=3)
    # back to back the wrapper's host call paces a launch this small: card and host time apart
    k14_card, k14_host = score_explain.card_host(lambda: kernels.explain_counts(arr, used, pr, rv), reps=50)
    plain_ms = cuda_ms(lambda: explain.explain_counts_plain(arr, used, pr, rv), reps=5)
    tol = (~arr.pod_tol_ns[pr]).to(torch.float32)
    taint = arr.node_taint_ns.to(torch.float32)
    lib_ms = cuda_ms(lambda: tol @ taint.T, reps=50, warmup=3)
    lib_card = score_explain.card_host(lambda: tol @ taint.T, reps=50)[0]
    k14_bound, k14_by = explain_bound(arr, F)
    print(f"[explain-north-star] explain_classes over {reps.size} classes (F={F}, N={arr.N}, R={arr.R}) "
          f"{explain_s:.4f} s: counts sha256 {digest} (JAX's); explain_counts == plain: {k14_ms:.4f} ms back to "
          f"back, {k14_card:.4f} ms of card time, {k14_host:.1f} us of host time a call; plain {plain_ms:.3f} ms; "
          f"torch.matmul of the taint count {lib_ms:.4f} ms ({lib_card:.4f} of card time); bound "
          f"{k14_bound:.6f} ms ({k14_by})", flush=True)
    return dict(ms=k14_ms, card_ms=k14_card, host_us=k14_host, plain_ms=plain_ms, library_ms=lib_ms,
                library_card_ms=lib_card, bound_ms=k14_bound, bound_by=k14_by, max_abs_err=err)


def stack_frames(src: str) -> list:
    """ptxas's stack frame bytes of each kernel of `src`, from its build log."""
    from kubernetes_tpu_torch.ops import kernels

    return [int(x) for x in re.findall(r"(\d+) bytes stack frame", kernels.BUILD_LOG.get(src, ""))]


def first_k15_launches() -> tuple:
    """CUDA-event ms of two preempt_eval launches on a wave of one preemptor
    over 8 nodes: the process's first launch of the kernel (its module
    loads then) and the next."""
    import torch

    from kubernetes_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    N, V, R = 8, 2, 4
    i32 = dict(dtype=torch.int32, device=dev)
    args = (torch.zeros((1, 1), **i32), torch.ones((1, R), **i32), torch.zeros((1,), **i32), torch.ones((N, R), **i32),
            torch.zeros((N, R), **i32), torch.zeros((N, R), **i32), torch.zeros((N,), dtype=torch.bool, device=dev),
            torch.zeros((N, V, R), **i32), torch.zeros((N, V), **i32),
            torch.zeros((N, V), dtype=torch.bool, device=dev), torch.zeros((N, V), dtype=torch.bool, device=dev))
    out = []
    for _ in range(2):
        torch.cuda.synchronize()
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        kernels.preempt_eval(*args)
        ev[1].record()
        torch.cuda.synchronize()
        out.append(ev[0].elapsed_time(ev[1]))
    return tuple(out)


def phase_preempt(k14: dict) -> list:
    """The failure path at the JAX package's preemption bench size, on the
    card, counted on its own; every wave's K15 output held to plain after
    the run, on the inputs the WaveProbe kept."""
    import numpy as np
    import torch

    from kubernetes_tpu_torch.bench import preempt_bench as pb
    from kubernetes_tpu_torch.bench import score_explain
    from kubernetes_tpu_torch.bench import workloads as w
    from kubernetes_tpu_torch.ops import explain, kernels
    from kubernetes_tpu_torch.ops import preempt as tpre

    t0 = time.perf_counter()
    snap = pb.build(**w.PREEMPT)
    build_s = time.perf_counter() - t0
    first_ms = first_k15_launches()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with pb.WaveProbe(keep=True) as probe:
        r = pb.failure_cycle(snap)
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launched = counted()
    calls = probe.calls
    nwaves = len(calls)
    victims = sum(len(v) for _, _, v in r["decisions"])
    digest = pb.decisions_digest(r["decisions"])
    msgs = sorted(set(r["messages"].values()))
    print(f"[preempt] build(20000, 1000) {build_s:.3f} s; failure_cycle {wall_s:.3f} s: failed {len(r['failed'])}, "
          f"diagnosis {msgs}, nominated {len(r['nominated'])}, victims {victims}, decisions sha256 {digest}; "
          f"device evaluations {nwaves} (wave hits {r['wave_hits']}, single {r['single_hits']}); "
          f"launches {launched}", flush=True)
    check(len(r["failed"]) == w.PREEMPT_FAILED, "preempt: failed count")
    check(msgs == [w.PREEMPT_MESSAGE], "preempt: diagnosis differs from JAX")
    check(len(r["nominated"]) == w.PREEMPT_NOMINATED and victims == w.PREEMPT_VICTIMS, "preempt: nominations")
    check(digest == w.PREEMPT_DECISIONS_SHA256, "preempt: decisions differ from JAX")
    for name in ("packed_static_rows", "chunk_rounds_dense", "explain_counts", "class_static_hoist", "preempt_eval"):
        check(launched.get(name, 0) > 0, f"preempt: {name} was not launched ({launched})")
    check(launched["preempt_eval"] == nwaves and launched["explain_counts"] == 1, f"preempt: launches {launched}")
    # every device evaluation's K15 output against plain on the same inputs
    err = 0
    for c in calls:
        arr, idxs, *ins = c["inputs"]
        idx = torch.from_numpy(idxs).to(arr.device)
        dins = [torch.from_numpy(np.ascontiguousarray(x)).to(arr.device) for x in ins]
        want = tpre.preempt_eval_plain(arr, idx, tpre.static_rows_plain(arr, idx), *dins)
        if len(c["outputs"]) == 6:  # a single preemptor: preempt_eval's [N, ...] rows
            want = [x[0] for x in want[:6]]
        for h, x in zip(c["outputs"], want):
            err = max(err, int((torch.from_numpy(np.asarray(h)).to(arr.device).long() - x.long()).abs().max()))
    check(err == 0, f"preempt: preempt_eval != plain (max |kernel - plain| {err})")
    tm = r["times"]
    dev_s = sum(c["build_s"] if c["build_s"] is not None else c["launch_s"] + c["read_s"] for c in calls)
    launch_s, read_s = sum(c["launch_s"] for c in calls), sum(c["read_s"] for c in calls)
    ks = [c["kernel_ms"] for c in calls]
    print(f"[preempt] split (host s): encode {tm['encode_s']:.3f}, step {tm['step_s']:.3f}, explain "
          f"{tm['explain_s']:.4f}, BatchedPreemption + prefetch {tm['setup_s']:.3f}, loop {tm['loop_s']:.3f} = "
          f"device evaluations {dev_s:.3f} (tables and state {dev_s - launch_s - read_s:.3f}, launch "
          f"{launch_s:.4f}, read back {read_s:.4f}) + decide/repair {tm['evaluate_s'] - dev_s:.3f} + "
          f"apply_eviction {tm['evict_s']:.3f}", flush=True)
    print(f"[preempt] per wave (K, K padded, K15 ms by CUDA events, read back s): "
          f"{[(c['k'], c['kp'], round(c['kernel_ms'], 4), round(c['read_s'], 5)) for c in calls]}", flush=True)
    print(f"[preempt] the process's first preempt_eval launches, before the cycle, on a one-preemptor wave of 8 "
          f"nodes: {first_ms[0]:.4f} ms (the module's lazy load), then {first_ms[1]:.4f} ms; the cycle's first wave "
          f"{ks[0]:.4f} ms against a median of {sorted(ks)[len(ks) // 2]:.4f} ms over its {nwaves} waves", flush=True)

    # K15 on the first wave's inputs: timed beside its plain version
    arr, idxs, *ins = calls[0]["inputs"]
    idx = torch.from_numpy(idxs).to(arr.device)
    ins = [torch.from_numpy(np.ascontiguousarray(x)).to(arr.device) for x in ins]
    del probe, calls
    stat_w = kernels.class_static_hoist(arr, idx.long())
    k15_b2b = cuda_ms(lambda: kernels.preempt_eval(stat_w, arr.pod_req, idx, arr.node_alloc, *ins), reps=50, warmup=3)
    # the wrapper's host call paces back-to-back calls: the card time is K15's
    k15_ms = card_ms(lambda: kernels.preempt_eval(stat_w, arr.pod_req, idx, arr.node_alloc, *ins), reps=50)
    st = tpre.static_rows_plain(arr, idx)
    plain_ms = cuda_ms(lambda: tpre.preempt_eval_plain(arr, idx, st, *ins), reps=5)
    K, N, R = idx.shape[0], arr.N, arr.R
    V = ins[3].shape[1]
    W = -(-N // 32)
    k15_read = dict(
        stat_w=4 * K * W, pod_rows=4 * K * R, pod_idxs=4 * K,
        alloc_used_nom=3 * 4 * N * R, has_nom=N,
        vict_req=4 * N * V * R, vict_prio=4 * N * V, vict_viol_valid=2 * N * V,
    )
    # cand, static_ok and is_victim bytes; nvio, vmax, vsum, vcnt int32
    k15_write = K * N * (1 + 1 + V) + 4 * 4 * K * N
    k15_bytes = sum(k15_read.values()) + k15_write
    k15_ops = K * N * (V * R + 2 * R + 2 * R + 3 * V * R + 2 * R + 4 * V)
    k15_bound, k15_by = bound(k15_bytes, k15_ops)
    # K14 at the preempt cluster's call (F = 4: one failed class)
    pr = torch.zeros(4, dtype=torch.int64, device=arr.device)
    rv = torch.arange(4, device=arr.device) < 1
    k14_small = cuda_ms(lambda: kernels.explain_counts(arr, arr.node_used, pr, rv), reps=50, warmup=3)
    k14_small_card, k14_small_host = score_explain.card_host(
        lambda: kernels.explain_counts(arr, arr.node_used, pr, rv), reps=50)
    check(torch.equal(kernels.explain_counts(arr, arr.node_used, pr, rv),
                      explain.explain_counts_plain(arr, arr.node_used, pr, rv)),
          "preempt: explain_counts != plain at F=4")
    frames = {src: stack_frames(src) for src in ("preempt.cu", "chunk_rounds.cu")}
    check(frames["preempt.cu"] and not any(frames["preempt.cu"]),
          f"preempt.cu: ptxas reports a stack frame ({frames['preempt.cu']} bytes)")
    print(f"[preempt] ptxas stack frames (bytes, per kernel): {frames}", flush=True)
    print(f"[preempt] preempt_eval == plain on all {nwaves} waves; at K={K}, N={N}, V={V}, R={R}: {k15_ms:.4f} ms "
          f"of card time ({k15_b2b:.4f} ms back to back) "
          f"(wave mean by events {sum(ks) / len(ks):.4f} ms), plain {plain_ms:.3f} ms, bound {k15_bound:.6f} ms "
          f"({k15_by}: {k15_bytes} B = read {k15_read} + written {k15_write}); explain_counts == plain at F=4 "
          f"on this cluster: {k14_small:.4f} ms back to back, {k14_small_card:.4f} ms of card time, "
          f"{k14_small_host:.1f} us host", flush=True)
    common = dict(route="cuda", library_ms=None)
    return [
        dict(name="explain_counts", source="kubernetes_tpu_torch/csrc/explain.cu",
             replaces="kubernetes_tpu/ops/explain.py:86", launches=launched["explain_counts"],
             max_abs_err=k14["max_abs_err"], ms=k14["ms"], card_ms=k14["card_ms"], host_us=k14["host_us"],
             plain_ms=k14["plain_ms"], bound_ms=k14["bound_ms"], bound_by=k14["bound_by"], route="cuda",
             library_ms=k14["library_ms"], library_card_ms=k14["library_card_ms"], scope="north star, F=128",
             ms_f4_preempt=k14_small, card_ms_f4_preempt=k14_small_card, host_us_f4_preempt=k14_small_host),
        dict(name="preempt_eval", source="kubernetes_tpu_torch/csrc/preempt.cu",
             replaces="kubernetes_tpu/ops/preempt.py:52", launches=launched["preempt_eval"],
             max_abs_err=err, ms=k15_ms, plain_ms=plain_ms, bound_ms=k15_bound, bound_by=k15_by,
             ms_back_to_back=k15_b2b, scope="one failure-cycle wave; card time", **common),
    ]


# ---------------------------------------------------------------------------
# the node mesh's per-step collectives: the shard modes of K2, K11 and K12
# ---------------------------------------------------------------------------

MESH_PERPOD_PREFIX = 1024  # north-star pods of K2's shard mode held against the plain sharded scan
MESH_ROUNDS_PREFIX_CHUNKS = 4  # config-3 chunks of K12's shard mode held against the plain sharded scan
MESH_FULL_PREFIX = 128  # config-3 pods of K11's shard mode held against the plain sharded scan


def sharded_counted(tag, fn, need: dict, route, default: bool = True):
    """fn() on the mesh with every count set to 0 just before it: exactly the
    launches `need` and the route `route` once (a dict: exactly those route
    counts); `default`: fn takes a default route (see counted)."""
    import torch

    from kubernetes_tpu_torch.ops import assign, kernels

    kernels.reset_launches()
    assign.reset_trace_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = counted(default)
    routes = {k: v for k, v in assign.TRACE_COUNTS.items() if v}
    check(launches == need, f"{tag}: launches {launches}, want {need}")
    check(routes == (route if isinstance(route, dict) else {route: 1}), f"{tag}: routes {routes}")
    return out, launches, first_s


def mesh_frac_weights(S: int = 2) -> int:
    """tests/torch_rounds_contended_reference.py's frac-weights case
    (non-integer preferred inter-pod weights beside hardPodAffinityWeight on
    one term: the commit's add order, ROADMAP C4) on make_mesh(S): K12's
    shard mode, dense and class rows, against the plain sharded scan on the
    same card tensors -> the entries that differ in choices, usage,
    ordinals, sweeps and the pairwise state (every count plane, pref
    included, as bit patterns; the ports)."""
    import importlib.util

    from kubernetes_tpu_torch.ops import assign, kernels
    from kubernetes_tpu_torch.ops.incremental import HoistCache
    from kubernetes_tpu_torch.parallel import mesh as tm
    from kubernetes_tpu_torch.parallel import sharded

    spec = importlib.util.spec_from_file_location(
        "torch_rounds_contended_reference", os.path.join(HERE, "tests", "torch_rounds_contended_reference.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    arr, meta, cfg, iters = ref.port_arrays("frac-weights", "cuda")
    m = tm.make_mesh(S)
    sa = tm.shard_arrays(arr, m)
    rows = [assign.packed_static_rows(sh, with_elig=True, base=m.base(j, sa.N)) for j, sh in enumerate(sa.shards)]
    sfs, eligs = [r[0] for r in rows], [r[1] for r in rows]
    planes = [assign.score_planes(sh, cfg) for sh in sa.shards]
    inc = sharded.inc_applicable(sa, cfg, HoistCache(mesh=m).ensure(arr, meta, cfg))
    check(inc is not None, "mesh-frac-weights: the class state does not apply")
    errs = []
    for mode, k, p in (
        ("dense", lambda: kernels.rounds_shard(sa, cfg, sfs, eligs, planes, repair_iters=iters, with_state=True),
         lambda: sharded.sharded_schedule_scan_rounds_plain(sa, cfg, sfs, eligs, planes, repair_iters=iters,
                                                            with_state=True)),
        ("class rows", lambda: kernels.rounds_shard(sa, cfg, inc=inc, repair_iters=iters, with_state=True),
         lambda: sharded.sharded_schedule_scan_rounds_plain(sa, cfg, repair_iters=iters, inc=inc, with_state=True))):
        kk, pp = k(), p()
        e = (sum(mismatch(a, b) for a, b in zip(kk[:3], pp[:3])) + abs(kernels.read_sweeps(kk[3]) - pp[3])
             + same_state(kk[4], pp[4]))
        check(e == 0, f"mesh-frac-weights {mode}: rounds_shard != plain on {S} shards ({e} entries; pref "
                      f"{mismatch(kk[4]['pref'], pp[4]['pref'])})")
        errs.append(e)
    print(f"[mesh-frac-weights] {m}: P={arr.P} N={sa.N} nl={sa.nl}, hardPodAffinityWeight "
          f"{cfg.hard_pod_affinity_weight} beside non-integer preferred weights on one term: rounds_shard dense and "
          f"class rows == the plain sharded scan (choices, usage, ordinals, sweeps, cnt / anti / pref / total_t "
          f"as bits, ports)", flush=True)
    return sum(errs)


def phase_mesh_north_star_perpod(ns) -> list:
    """The north star's per-pod route on make_mesh(4): K1 x 4 with each
    shard's base, then K2 in shard mode; == [north-star]'s choices and usage;
    K1 (base) == plain per shard, K2's shard mode == the plain sharded scan
    on the first MESH_PERPOD_PREFIX pods."""
    import torch

    from kubernetes_tpu_torch.bench import score_explain, workloads
    from kubernetes_tpu_torch.ops import assign, filters, kernels
    from kubernetes_tpu_torch.parallel import mesh as tm
    from kubernetes_tpu_torch.parallel import sharded

    arr, meta, cfg, choices, used = ns
    m = tm.make_mesh(4)
    sa = tm.shard_arrays(arr, m)
    P, N, nl, R = sa.P, sa.N, sa.nl, arr.R
    n = meta.n_pods
    step, launches, first_s = sharded_counted(
        "mesh-north-star-perpod", lambda: assign.finish(assign.dispatch(sa, cfg, mesh=m, chunked=False)),
        {"static_feasible": 4, "fit_scan_shard": 1}, "sharded_plain", default=False)
    digest = hashlib.sha256(step.choices[:n].cpu().numpy().astype("<i4").tobytes()).hexdigest()
    check(digest == workloads.NORTH_STAR_CHOICES_SHA256, "mesh-north-star-perpod: choices differ from JAX")
    check(torch.equal(step.choices, choices) and torch.equal(step.used[:arr.N], used),
          "mesh-north-star-perpod: != [north-star]")
    step_s = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        assign.finish(assign.dispatch(sa, cfg, mesh=m, chunked=False))
        torch.cuda.synchronize()
        step_s = min(step_s, time.perf_counter() - t0)
    print(f"[mesh-north-star-perpod] {m}: P={P} N={N} nl={nl}; dispatch(chunked=False) {first_s:.3f} s (first "
          f"call), step_s {step_s:.4f} (best of 2): choices sha256 {digest} == [north-star], usage == "
          f"[north-star]'s, launches {launches}", flush=True)
    # K1 with the base against plain, every shard
    bases = [m.base(s, N) for s in range(4)]
    sfs = [kernels.static_feasible(sh, base=b) for sh, b in zip(sa.shards, bases)]
    k1_err = sum(int((k != filters.static_feasible_plain(sh, base=b)).any()) for k, sh, b in zip(sfs, sa.shards, bases))
    check(k1_err == 0, "mesh-north-star-perpod: static_feasible (base) != plain")
    k1_ms = cuda_ms(lambda: [kernels.static_feasible(sh, base=b) for sh, b in zip(sa.shards, bases)], reps=5)
    k1_card, k1_host = score_explain.card_host(
        lambda: [kernels.static_feasible(sh, base=b) for sh, b in zip(sa.shards, bases)], reps=10)
    k1_lib, k1_lib_card = term_match_library(sa.shards, reps=10)
    k1_plain = cuda_ms(lambda: [filters.static_feasible_plain(sh, base=b) for sh, b in zip(sa.shards, bases)], reps=2)
    k1_bytes, k1_ops = (sum(x) for x in zip(*(k1_work(sh) for sh in sa.shards)))
    k1_bound, k1_by = bound(k1_bytes, k1_ops)
    # K2's shard mode against the plain sharded scan on a prefix, and timed
    k = MESH_PERPOD_PREFIX
    pre = sa.pod_prefix(k)
    sf_pre = [x[:k].contiguous() for x in sfs]
    ck, uk = kernels.fit_scan_shard(sf_pre, pre, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cp, up = sharded.sharded_schedule_scan_plain(pre, cfg, sfs=sf_pre, planes=[(None, None)] * 4)
    torch.cuda.synchronize()
    k2_plain = (time.perf_counter() - t0) * 1e3
    k2_err = mismatch(ck, cp) + mismatch(uk, up)
    check(k2_err == 0, f"mesh-north-star-perpod: fit_scan_shard != plain on the first {k} pods ({k2_err})")
    check(torch.equal(ck, choices[:k]), "mesh-north-star-perpod: prefix != full run")
    # the shard mode beside the same call's one-device K2, in turns
    sf1 = kernels.static_feasible(arr)
    k2_ms, one_ms = in_turns_ms(lambda: kernels.fit_scan_shard(sfs, sa, cfg), lambda: kernels.fit_scan(sf1, arr, cfg))
    k2_kc = kernels.LAST_CLUSTER["fit_scan_shard"]
    runs = kernels.scan_runs("fit_scan", 4, nl, k2_kc)
    # the one-device function's bytes: the shard mode has no exchange of its own
    k2_bytes = P * N + 4 * P * R + P + 3 * 4 * N * R + 4 * P
    n_scored = int(kernels.fit_scan(sf1, arr, cfg)[2].item())
    del sf1
    k2_bound, k2_by = bound(k2_bytes, n_scored * f32_ops_per_scored_node(cfg))
    print(f"[mesh-north-star-perpod] static_feasible (base) x 4 == plain per shard: {k1_ms:.4f} ms the four, "
          f"{k1_card:.4f} ms of card time, host {k1_host:.1f} us the four calls; the term match's torch.einsum "
          f"x 4 {k1_lib_card:.4f} ms of card time; plain {k1_plain:.4f} ms, bound {k1_bound:.4f} ms ({k1_by}); "
          f"fit_scan_shard == plain sharded scan on the "
          f"first {k} pods (plain {k2_plain:.1f} ms, host clock): {k2_ms:.3f} ms over all {P} pods "
          f"({k2_ms / P * 1e3:.3f} us per pod), one cluster of {k2_kc} blocks ({sum(len(r) > 1 for r in runs)} of "
          f"{len(runs)} runs span shards), beside the same call's one-device fit_scan {one_ms:.3f} ms in turns: "
          f"shard / one device {k2_ms / one_ms:.3f}x; bound {k2_bound:.4f} ms ({k2_by})", flush=True)
    return [
        dict(name="static_feasible (base)", route="cuda", source="kubernetes_tpu_torch/csrc/static_feasible.cu",
             replaces="kubernetes_tpu/ops/assign.py:189 (schedule_scan's my_nodes under shard_map)",
             launches=launches["static_feasible"], max_abs_err=k1_err, ms=k1_ms, card_ms=k1_card, host_us=k1_host,
             plain_ms=k1_plain, bound_ms=k1_bound, bound_by=k1_by, library_ms=k1_lib, library_card_ms=k1_lib_card,
             scope="4 shards of the north star"),
        dict(name="fit_scan (shard)", route="cuda", source="kubernetes_tpu_torch/csrc/fit_scan.cu",
             replaces="kubernetes_tpu/ops/assign.py:181 (axis_name; :320-326)", launches=launches["fit_scan_shard"],
             max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain, bound_ms=k2_bound, bound_by=k2_by, library_ms=None,
             plain_scope=f"first {k} pods", one_device_ms=one_ms, shard_over_one_device=k2_ms / one_ms,
             cluster=k2_kc),
    ]


def phase_mesh_config3(c3, k12_row: dict, k11_row: dict) -> list:
    """BASELINE config 3 on make_mesh(4) (nl 1536) and make_mesh(5) (N pads
    to 6145, nl 1229): the rounds route dense (K7 x S with eligibility, K12
    in shard mode), on class state (HoistCache(mesh=): K3 x S, K4 x S; K12
    in shard class-row mode) and the per-pod route (K7 x S, K11 in shard
    mode), each counted on its own, against the single-device digests,
    sweeps and usage; K12 (both modes) and K11 in shard mode == their plain
    sharded versions on a prefix, timed."""
    import torch

    from kubernetes_tpu_torch.bench import workloads as w
    from kubernetes_tpu_torch.ops import assign, bitplane, kernels
    from kubernetes_tpu_torch.ops.incremental import HoistCache
    from kubernetes_tpu_torch.parallel import mesh as tm
    from kubernetes_tpu_torch.parallel import sharded

    arr, meta, cfg, choices, sfs1, eligs1, _, _, k_ops = c3
    n, P = meta.n_pods, arr.P
    used1 = choices_used(arr, choices, P)
    inc1 = HoistCache().ensure(arr, meta, cfg)  # one device's class state, for the shard mode's yardstick
    frac_err = mesh_frac_weights()

    def digest(x):
        return hashlib.sha256(x[:n].cpu().numpy().astype("<i4").tobytes()).hexdigest()

    def same(tag, step, sweeps=True):
        check(digest(step.choices) == w.CONFIG3_CHOICES_SHA256, f"{tag}: choices differ from JAX")
        check(torch.equal(step.used[:arr.N], used1) and not step.used[arr.N:].any(), f"{tag}: usage")
        if sweeps:
            check(step.sweeps == w.CONFIG3_ROUNDS_SWEEPS, f"{tag}: sweeps {step.sweeps}")
            check(digest(step.ordinals) == w.CONFIG3_ROUNDS_ORDINALS_SHA256, f"{tag}: ordinals differ from JAX")

    rows = []
    for S in (4, 5):
        m = tm.make_mesh(S)
        sa = tm.shard_arrays(arr, m)
        nl, N = sa.nl, sa.N
        tag = f"mesh-config3 S={S}"
        # the rounds route, dense
        d, dl, d_first = sharded_counted(tag, lambda: assign.finish(assign.dispatch(sa, cfg, mesh=m)),
                                         {"packed_static_rows": S, "rounds_shard": 1}, "sharded_rounds")
        same(tag + " rounds", d)
        # the rounds route on class state
        cache = HoistCache(mesh=m)
        kernels.reset_launches()
        t0 = time.perf_counter()
        inc = cache.ensure(sa, meta, cfg)
        torch.cuda.synchronize()
        ensure_s = time.perf_counter() - t0
        hl = counted()
        check(hl == {"class_static_hoist": S, "class_usage_hoist": S}, f"{tag}: HoistCache launches {hl}")
        ci, il, i_first = sharded_counted(tag, lambda: assign.finish(assign.dispatch(sa, cfg, inc=inc, mesh=m)),
                                          {"rounds_shard": 1}, "sharded_rounds_inc")
        same(tag + " rounds_inc", ci)
        # the per-pod route
        pp, pl, p_first = sharded_counted(tag, lambda: assign.finish(assign.dispatch(sa, cfg, mesh=m, chunked=False)),
                                          {"packed_static_rows": S, "full_scan_shard": 1}, "sharded_plain",
                                          default=False)
        same(tag + " per-pod", pp, sweeps=False)
        print(f"[mesh-config3] {m}: N={N} nl={nl}; rounds dense {d_first:.3f} s, launches {dl}; HoistCache.ensure "
              f"{ensure_s:.4f} s ({hl}), rounds on class state {i_first:.3f} s, launches {il}; per-pod "
              f"{p_first:.3f} s, launches {pl}: choices, usage, ordinals and sweeps ({w.CONFIG3_ROUNDS_SWEEPS}) == "
              f"[config3] / [config3-inc] / [config3-perpod]", flush=True)
        # the kernels against their plain sharded versions on a prefix, and timed
        bases = [m.base(s, N) for s in range(S)]
        planes = [assign.packed_static_rows(sh, with_elig=True, base=b) for sh, b in zip(sa.shards, bases)]
        sfs, eligs = [p_[0] for p_ in planes], [p_[1] for p_ in planes]
        npre = MESH_ROUNDS_PREFIX_CHUNKS * assign.RCHUNK
        pre = sa.pod_prefix(npre)
        sp, ep = [x[:npre].contiguous() for x in sfs], [x[:npre].contiguous() for x in eligs]
        nn = [(None, None)] * S
        kd = kernels.rounds_shard(pre, cfg, sp, ep, nn, with_state=True)
        inc_pre = inc._replace(cls=inc.cls[:npre].contiguous(),
                               shards=tuple(x._replace(cls=x.cls[:npre].contiguous()) for x in inc.shards))
        ki = kernels.rounds_shard(pre, cfg, inc=inc_pre, with_state=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pd = sharded.sharded_schedule_scan_rounds_plain(pre, cfg, sp, ep, nn, with_state=True)
        torch.cuda.synchronize()
        k12_plain = (time.perf_counter() - t0) * 1e3
        pi = sharded.sharded_schedule_scan_rounds_plain(pre, cfg, inc=inc_pre, with_state=True)
        errs = []
        for kk, pp_ in ((kd, pd), (ki, pi)):
            errs.append(sum(mismatch(a, b) for a, b in zip(kk[:3], pp_[:3])) + abs(kernels.read_sweeps(kk[3]) - pp_[3])
                        + same_state(kk[4], pp_[4]))
        check(errs == [0, 0], f"{tag}: rounds_shard (dense, class rows) != plain on the first chunks {errs}")
        check(torch.equal(kd[0], choices[:npre]) and torch.equal(ki[0], choices[:npre]), f"{tag}: prefix != full")
        fpre = sa.pod_prefix(MESH_FULL_PREFIX)
        kf = kernels.full_scan_shard(fpre, cfg, [x[:MESH_FULL_PREFIX].contiguous() for x in sfs],
                                     [x[:MESH_FULL_PREFIX].contiguous() for x in eligs], nn, with_state=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pf = sharded.sharded_schedule_scan_plain(fpre, cfg, sfs=[bitplane.unpack(x[:MESH_FULL_PREFIX], nl) for x in sfs],
                                                 planes=nn, with_state=True)
        torch.cuda.synchronize()
        k11_plain = (time.perf_counter() - t0) * 1e3
        k11_err = mismatch(kf[0], pf[0]) + mismatch(kf[1], pf[1]) + same_state(kf[2], pf[2])
        check(k11_err == 0, f"{tag}: full_scan_shard != plain on the first {MESH_FULL_PREFIX} pods ({k11_err})")
        # the shard mode beside the same call's one-device K12, each mode in turns
        kd_ms = cuda_ms(lambda: kernels.rounds_shard(sa, cfg, sfs, eligs, nn), reps=3)
        one_ms = cuda_ms(lambda: kernels.rounds(arr, cfg, sfs1, eligs1, (None, None)), reps=3)
        one_i_ms = cuda_ms(lambda: kernels.rounds(arr, cfg, inc=inc1), reps=3)
        ki_ms = cuda_ms(lambda: kernels.rounds_shard(sa, cfg, inc=inc), reps=3)
        kf_ms, one_f_ms = in_turns_ms(lambda: kernels.full_scan_shard(sa, cfg, sfs, eligs, nn),
                                      lambda: kernels.full_scan(arr, cfg, sfs1, eligs1, (None, None)))
        kf_kc = kernels.LAST_CLUSTER["full_scan_shard"]
        runs = kernels.scan_runs("full_scan", S, nl, kf_kc)
        k_bytes = full_bytes(arr)
        sw_ = w.CONFIG3_ROUNDS_SWEEPS
        # the one-device function's bound, K12's and K11's: no shard mode has an exchange of its own
        b12, b12_by = bound(k_bytes, k_ops)
        print(f"[mesh-config3] {m}: rounds_shard dense / class rows == plain on the first "
              f"{MESH_ROUNDS_PREFIX_CHUNKS} chunks (plain {k12_plain:.1f} ms, host clock), full_scan_shard == plain "
              f"on the first {MESH_FULL_PREFIX} pods (plain {k11_plain:.1f} ms); all pods: rounds_shard dense "
              f"{kd_ms:.3f} ms ({kd_ms / sw_ * 1e3:.1f} us per round) beside the same call's one-device rounds "
              f"{one_ms:.3f} ms ({kd_ms / one_ms:.3f}x; [config3] {k12_row['ms']:.3f}), class rows {ki_ms:.3f} ms "
              f"beside one device's {one_i_ms:.3f} ms ({ki_ms / one_i_ms:.3f}x), full_scan_shard {kf_ms:.3f} ms "
              f"({kf_ms / P * 1e3:.2f} us per pod), one cluster of {kf_kc} blocks ({sum(len(r) > 1 for r in runs)} "
              f"of {len(runs)} runs span shards), beside the same call's one-device full_scan {one_f_ms:.3f} ms in "
              f"turns ({kf_ms / one_f_ms:.3f}x; [config3-perpod] full_scan {k11_row['ms']:.3f}); bound "
              f"{b12:.4f} ms ({b12_by})", flush=True)
        if S == 4:
            rows += [
                dict(name="rounds (shard)", route="cuda", source="kubernetes_tpu_torch/csrc/rounds.cu",
                     replaces="kubernetes_tpu/ops/assign.py:1464 (axis_name; :56-110)", launches=dl["rounds_shard"],
                     max_abs_err=errs[0] + frac_err, ms=kd_ms, plain_ms=k12_plain, bound_ms=b12, bound_by=b12_by,
                     library_ms=None, plain_scope=f"first {MESH_ROUNDS_PREFIX_CHUNKS} chunks; frac-weights on 2 "
                     f"shards", shards=S, one_device_ms=one_ms),
                dict(name="rounds (shard, class rows)", route="cuda", source="kubernetes_tpu_torch/csrc/rounds.cu",
                     replaces="kubernetes_tpu/ops/assign.py:1464 (axis_name, inc=)", launches=il["rounds_shard"],
                     max_abs_err=errs[1], ms=ki_ms, plain_ms=k12_plain, bound_ms=b12, bound_by=b12_by,
                     library_ms=None, plain_scope=f"first {MESH_ROUNDS_PREFIX_CHUNKS} chunks (dense plain)", shards=S,
                     one_device_ms=one_i_ms),
                dict(name="full_scan (shard)", route="cuda", source="kubernetes_tpu_torch/csrc/full_scan.cu",
                     replaces="kubernetes_tpu/ops/assign.py:181 (axis_name; :252-344), ops/pairwise.py:56",
                     launches=pl["full_scan_shard"], max_abs_err=k11_err, ms=kf_ms, plain_ms=k11_plain,
                     bound_ms=b12, bound_by=b12_by, library_ms=None, plain_scope=f"first {MESH_FULL_PREFIX} pods",
                     shards=S, one_device_ms=one_f_ms, shard_over_one_device=kf_ms / one_f_ms, cluster=kf_kc),
            ]
        del sa, inc, cache
    return rows


def phase_mesh_config3_warm(cold3, single) -> None:
    """bench.py's warm waves on config 3 through PipelinedBatchLoop(depth=1,
    mesh=make_mesh(4)): every step the sharded rounds route on class state
    (K3 / K4 per shard in the HoistCache, K12 in shard class-row mode); the
    digests and HoistCache actions of [config3-warm]."""
    from kubernetes_tpu_torch.bench import workloads as w
    from kubernetes_tpu_torch.parallel.mesh import make_mesh

    res = run_warm_loop("mesh-config3-warm", w.spread_affinity(**w.CONFIG3), cold3, w.CONFIG3_WARM_DIGESTS,
                        w.CONFIG3_WARM_ACTIONS, w.CONFIG3_SCHEDULED,
                        ("class_static_hoist", "class_usage_hoist", "rounds_shard"), "sharded_rounds_inc",
                        mesh=make_mesh(4), depths=(1,))
    print(f"[mesh-config3-warm] end_to_end_s {res[1]['end_to_end_s']:.4f} on 4 shards; one device "
          f"{single[1]['end_to_end_s']:.4f} ([config3-warm], depth 1); delta_s {res[1]['delta_s']:.4f} / "
          f"{single[1]['delta_s']:.4f}", flush=True)


def phase_mesh_gangs() -> None:
    """schedule_with_gangs(mesh=make_mesh(4)): [gang-rounds]'s batch (config
    3 in PodGroups of 64; each iteration the sharded rounds route) and
    config 5 on class state (each iteration the sharded class-wave route);
    each == the host fixpoint's digests."""
    import torch

    from kubernetes_tpu_torch.api.delta import DeltaEncoder
    from kubernetes_tpu_torch.bench import workloads as w
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, gang, infer_score_config, kernels
    from kubernetes_tpu_torch.ops.incremental import HoistCache
    from kubernetes_tpu_torch.parallel.mesh import make_mesh

    m = make_mesh(4)

    def digest(x, k=None):
        x = x if k is None else x[:k]
        return hashlib.sha256(x.cpu().numpy().astype("<i4").tobytes()).hexdigest()

    arr, meta = DeltaEncoder().encode_device(w.grouped(w.spread_affinity(**w.CONFIG3), 64))
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    n = meta.n_pods
    kernels.reset_launches()
    assign.reset_trace_counts()
    t0 = time.perf_counter()
    c, u = gang.schedule_with_gangs(arr, cfg, mesh=m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counted()
    routes = {k: v for k, v in assign.TRACE_COUNTS.items() if v}
    print(f"[mesh-gangs] gang-rounds on {m}: {wall:.4f} s, routes {routes}, launches {launches}, choices sha256 "
          f"{digest(c, n)}, used sha256 {digest(u[:arr.N])}", flush=True)
    check(routes == {"sharded_rounds": w.GANG_ROUNDS_ITERATIONS}, f"mesh-gangs rounds: routes {routes}")
    check(launches.get("rounds_shard") == w.GANG_ROUNDS_ITERATIONS, f"mesh-gangs rounds: launches {launches}")
    check(digest(c, n) == w.GANG_ROUNDS_CHOICES_SHA256 and digest(u[:arr.N]) == w.GANG_ROUNDS_USED_SHA256,
          "mesh-gangs: the gang-rounds decisions differ from the host fixpoint's")
    del arr, c, u
    arr, meta = DeltaEncoder().encode_device(w.gang(**w.CONFIG5))
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    n = meta.n_pods
    kernels.reset_launches()
    assign.reset_trace_counts()
    t0 = time.perf_counter()
    inc = HoistCache(mesh=m).ensure(arr, meta, cfg)
    hc, hu, ho, hs = gang.schedule_with_gangs(arr, cfg, with_ordinals=True, inc=inc, mesh=m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counted()
    routes = {k: v for k, v in assign.TRACE_COUNTS.items() if v}
    print(f"[mesh-gangs] config 5 on {m}, class state: {wall:.4f} s (HoistCache.ensure included), routes {routes}, "
          f"launches {launches}, sweeps {hs}, choices sha256 {digest(hc, n)}, ordinals sha256 {digest(ho, n)}",
          flush=True)
    check(routes.get("sharded_chunked_inc") == w.CONFIG5_ITERATIONS, f"mesh-gangs config 5: routes {routes}")
    check(digest(hc, n) == w.CONFIG5_CHOICES_SHA256 and digest(ho, n) == w.CONFIG5_ORDINALS_SHA256
          and hs == w.CONFIG5_SWEEPS, "mesh-gangs: config 5 differs from the host fixpoint's")


MESH2D = (2, 4)  # the pods x nodes grid of the mesh2d phases: 2 pod rows x 4 node shards
DCN_SHAPES = {"1d": None, "2x2": (2, 2)}  # the [dcn] runs: two ranks x 2 positions of the one card
DCN_TIMEOUT_S = 300  # one [dcn] run's two workers


def sha_i32(x) -> str:
    return hashlib.sha256(x.cpu().numpy().astype("<i4").tobytes()).hexdigest()


def best_step_s(fn, reps: int = 2) -> float:
    """Best of `reps` host-clock times of fn() to a synchronise."""
    import torch

    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    return best


def entry_gather(ga, inc=None) -> tuple:
    """The grid's entry gather (ops/assign.py pod_unshard) -> (CUDA-event ms,
    bytes it writes: each gathered pod-axis tensor and the class index once,
    per bytes of the arrays a pod row carries)."""
    from kubernetes_tpu_torch.ops import assign

    ms = cuda_ms(lambda: assign.pod_unshard(ga, inc), reps=10)
    sa, full = assign.pod_unshard(ga, inc)
    from kubernetes_tpu_torch.parallel.partition_rules import POD_AXIS_FIELDS

    out = {id(t): t.numel() * t.element_size() for sh in sa.shards
           for t in (getattr(sh, f) for f in (*POD_AXIS_FIELDS, "image_score"))}
    nbytes = sum(out.values()) + (0 if full is None else full.cls.numel() * 4)
    return ms, nbytes, nbytes // sa.P


def phase_mesh2d_north_star(used_sha: str) -> None:
    """The north star on make_mesh(shape=(2, 4)) of cuda:0, through
    DeltaEncoder(mesh=): pod-axis fields resident per pod row, node-axis
    fields per node column; the dense step (the entry gather, then K7 x 4 +
    K17 + K8: the 1-D mesh's launches) and the class-wave step
    (HoistCache(mesh=): K3 x 4 + K4 x 4 + K17 x 2, then K5 + K6) against
    [north-star-dense] / [north-star-waves]; the entry gather's time and
    bytes; the peak device memory beside shard_hbm_estimate(pod_shards=2)."""
    import torch

    from kubernetes_tpu_torch.api.delta import DeltaEncoder
    from kubernetes_tpu_torch.bench import workloads as w
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, infer_score_config, kernels
    from kubernetes_tpu_torch.ops.incremental import HoistCache
    from kubernetes_tpu_torch.parallel import mesh as tm

    snap = w.heterogeneous(**w.NORTH_STAR)
    host, meta = DeltaEncoder().encode(snap)
    n, N0 = meta.n_pods, host.N
    g = tm.make_mesh(shape=MESH2D)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    enc = DeltaEncoder(mesh=g)
    t0 = time.perf_counter()
    ga, _ = enc.to_device(host, meta)
    torch.cuda.synchronize()
    place_s = time.perf_counter() - t0
    check(isinstance(ga, tm.GridArrays) and repr(g) == "GridMesh(2x4 on 1 card)", f"mesh2d-north-star: {g!r}")
    cfg = infer_score_config(host, DEFAULT_SCORE_CONFIG)
    P, N, pl, nl, R = ga.P, ga.N, ga.pl, ga.nl, host.R
    print(f"[mesh2d-north-star] {g}: P {P} (pl {pl} a pod row), N {N} (nl {nl} a node column); pod-axis fields "
          f"resident per pod row, node-axis fields per node column (to_device {place_s:.3f} s)", flush=True)
    tag = "mesh2d-north-star"

    def same(t, step, sweeps, ords):
        check(sha_i32(step.choices[:n]) == w.NORTH_STAR_CHOICES_SHA256, f"{t}: choices differ from JAX")
        check(step.sweeps == sweeps and sha_i32(step.ordinals[:n]) == ords, f"{t}: sweeps {step.sweeps} / ordinals")
        check(sha_i32(step.used[:N0]) == used_sha and not step.used[N0:].any(), f"{t}: usage != one device's")

    d, dl, d_first = sharded_counted(tag + " dense", lambda: assign.finish(assign.dispatch(ga, cfg, mesh=g)),
                                     {"packed_static_rows": 4, "stitch_planes": 1, "chunk_rounds_dense": 1},
                                     "sharded_chunked")
    same(tag + " dense", d, w.NORTH_STAR_DENSE_SWEEPS, w.NORTH_STAR_DENSE_ORDINALS_SHA256)
    dense_s = best_step_s(lambda: assign.finish(assign.dispatch(ga, cfg, mesh=g)))
    g_ms, g_bytes, row_bytes = entry_gather(ga)
    print(f"[mesh2d-north-star] dense: {d_first:.3f} s (first call), step_s {dense_s:.4f} (best of 2), launches "
          f"{dl} (as on make_mesh(4)); choices, usage, ordinals and {d.sweeps} sweeps == [north-star-dense]; entry "
          f"gather {g_ms:.4f} ms (CUDA events), {g_bytes} B ({row_bytes} B a pod)", flush=True)
    kernels.reset_launches()
    t0 = time.perf_counter()
    hc = HoistCache(mesh=g)
    inc = hc.ensure(ga, meta, cfg, host=host)
    torch.cuda.synchronize()
    ensure_s = time.perf_counter() - t0
    hl = counted()
    check(hl == {"class_static_hoist": 4, "class_usage_hoist": 4, "stitch_planes": 2}, f"{tag}: HoistCache {hl}")
    check(isinstance(inc.cls, tuple) and [c.shape[0] for c in inc.cls] == [pl, pl], f"{tag}: the class index")
    v, vl, v_first = sharded_counted(tag + " waves",
                                     lambda: assign.finish(assign.dispatch(ga, cfg, inc=inc, mesh=g)),
                                     {"wave_commit": 1, "chunk_rounds": 1},
                                     {"sharded_chunked_inc": 1, "class_waves": 1})
    same(tag + " waves", v, w.NORTH_STAR_WAVE_SWEEPS, w.NORTH_STAR_WAVE_ORDINALS_SHA256)
    waves_s = best_step_s(lambda: assign.finish(assign.dispatch(ga, cfg, inc=inc, mesh=g)))
    gi_ms, gi_bytes, _ = entry_gather(ga, inc)
    peak = torch.cuda.max_memory_allocated() - base_mem
    est = tm.shard_hbm_estimate(P, N, MESH2D[1], n_res=R, u_classes=w.NORTH_STAR_CLASSES, pod_shards=MESH2D[0],
                                pod_row_bytes=row_bytes)
    print(f"[mesh2d-north-star] class waves: HoistCache.ensure {ensure_s:.4f} s ({hc.last['action']}, launches "
          f"{hl}), {v_first:.3f} s (first call), step_s {waves_s:.4f} (best of 2; the ensure not included), "
          f"launches {vl}; choices, usage, ordinals and {v.sweeps} sweeps == [north-star-waves]; entry gather with "
          f"the class index {gi_ms:.4f} ms, {gi_bytes} B", flush=True)
    print(f"[mesh2d-north-star] device memory: peak {peak} B above the phase's start (every position on the one "
          f"card); shard_hbm_estimate(pod_shards=2) a position {est}, x 8 positions {8 * est['total']} B",
          flush=True)
    del ga, inc, hc, enc
    torch.cuda.empty_cache()


def phase_mesh2d_config3(c3) -> None:
    """BASELINE config 3 on make_mesh(shape=(2, 4)): the rounds route dense
    (the entry gather, K7 x 4 + K12 in shard mode), on class rows
    (HoistCache(mesh=): K3 x 4 + K4 x 4, then K12 shard class rows) and the
    per-pod route (K7 x 4 + K11 in shard mode): [config3] / [config3-inc] /
    [config3-perpod]'s choices, usage, ordinals and sweeps."""
    import torch

    from kubernetes_tpu_torch.bench import workloads as w
    from kubernetes_tpu_torch.ops import assign, kernels
    from kubernetes_tpu_torch.ops.incremental import HoistCache
    from kubernetes_tpu_torch.parallel import mesh as tm

    arr, meta, cfg, choices = c3[:4]
    n, P = meta.n_pods, arr.P
    used1 = choices_used(arr, choices, P)
    g = tm.make_mesh(shape=MESH2D)
    ga = tm.grid_arrays(arr, g)
    tag = "mesh2d-config3"

    def same(t, step, sweeps=True):
        check(sha_i32(step.choices[:n]) == w.CONFIG3_CHOICES_SHA256, f"{t}: choices differ from JAX")
        check(torch.equal(step.used[:arr.N], used1) and not step.used[arr.N:].any(), f"{t}: usage")
        if sweeps:
            check(step.sweeps == w.CONFIG3_ROUNDS_SWEEPS, f"{t}: sweeps {step.sweeps}")
            check(sha_i32(step.ordinals[:n]) == w.CONFIG3_ROUNDS_ORDINALS_SHA256, f"{t}: ordinals differ from JAX")

    def run(**kw):
        return assign.finish(assign.dispatch(ga, cfg, mesh=g, **kw))

    d, dl, d_first = sharded_counted(tag, run, {"packed_static_rows": 4, "rounds_shard": 1}, "sharded_rounds")
    same(tag + " rounds", d)
    d_s = best_step_s(run)
    kernels.reset_launches()
    t0 = time.perf_counter()
    inc = HoistCache(mesh=g).ensure(ga, meta, cfg)
    torch.cuda.synchronize()
    ensure_s = time.perf_counter() - t0
    hl = counted()
    check(hl == {"class_static_hoist": 4, "class_usage_hoist": 4}, f"{tag}: HoistCache launches {hl}")
    ci, il, i_first = sharded_counted(tag, lambda: run(inc=inc), {"rounds_shard": 1}, "sharded_rounds_inc")
    same(tag + " rounds_inc", ci)
    i_s = best_step_s(lambda: run(inc=inc))
    pp, pl_, p_first = sharded_counted(tag, lambda: run(chunked=False), {"packed_static_rows": 4, "full_scan_shard": 1},
                                       "sharded_plain", default=False)
    same(tag + " per-pod", pp, sweeps=False)
    g_ms, g_bytes, _ = entry_gather(ga, inc)
    print(f"[mesh2d-config3] {g}: P {ga.P} (pl {ga.pl}), N {ga.N} (nl {ga.nl}); rounds dense {d_first:.3f} s first, "
          f"step_rounds_s {d_s:.4f} (best of 2), launches {dl}; HoistCache.ensure {ensure_s:.4f} s ({hl}), rounds "
          f"on class rows {i_first:.3f} s first, step_rounds_inc_s {i_s:.4f}, launches {il}; per-pod "
          f"{p_first:.3f} s, launches {pl_}: choices, usage, ordinals and sweeps ({w.CONFIG3_ROUNDS_SWEEPS}) == "
          f"[config3] / [config3-inc] / [config3-perpod]; entry gather {g_ms:.4f} ms, {g_bytes} B", flush=True)
    del ga, inc
    torch.cuda.empty_cache()


def phase_mesh2d_warm_loop(cold, single) -> None:
    """bench.py's warm waves 2..7 through PipelinedBatchLoop(depth=1,
    mesh=make_mesh(shape=(2, 4))): the [warm-loop] digests and HoistCache
    actions, every step the class-wave route after the entry gather."""
    from kubernetes_tpu_torch.bench import workloads
    from kubernetes_tpu_torch.parallel.mesh import make_mesh

    snap = workloads.heterogeneous(**workloads.NORTH_STAR)
    want = (cold, workloads.NORTH_STAR_WARM_DIGESTS, workloads.NORTH_STAR_WARM_ACTIONS,
            workloads.NORTH_STAR_SCHEDULED)
    res = run_warm_loop("mesh2d-warm-loop", snap, *want, MESH_WAVE_KERNELS, "sharded_chunked_inc",
                        mesh=make_mesh(shape=MESH2D), depths=(1,))
    print(f"[mesh2d-warm-loop] end_to_end_s {res[1]['end_to_end_s']:.4f} on the 2x4 grid; one device "
          f"{single[1]['end_to_end_s']:.4f} ([warm-loop], depth 1); delta_s {res[1]['delta_s']:.4f} / "
          f"{single[1]['delta_s']:.4f}", flush=True)


def phase_dcn(ns_used_sha: str, c3_used_sha: str) -> None:
    """Two torch.distributed ranks on the one card: this script re-invoked
    as two worker processes (--dcn-worker RANK PORT SHAPE, each a fresh
    interpreter), after [build], so no worker builds.  Backend gloo with
    CUDA tensors, staged through host memory by parallel/collectives.py
    (NCCL refuses two ranks on one card); not NCCL and not a scale-out: the
    two ranks time-slice the card.  1d: the node mesh of 2 ranks x 2 shards
    on the north star's dense chunked route (K7 per shard, the stitch's
    gather across the ranks, K17, K8 on each rank) and its class-wave route
    (HoistCache(mesh=): K3 and K4 per shard, the class planes' stitch
    across the ranks, K17 x 2; K5 + K6 on each rank); 2x2: the grid with the
    pod axis across the ranks (the entry gather across them, then each
    rank's row of 2 node shards) on the same two routes and config 3's
    rounds route (K7 x 2 + K12 in shard mode).  Every rank's choices, usage,
    ordinals and sweeps == the single process's; a worker that fails or
    outlasts DCN_TIMEOUT_S fails the phase."""
    import socket

    import torch

    torch.cuda.empty_cache()
    want = {"north-star": ns_used_sha, "north-star-waves": ns_used_sha, "config3": c3_used_sha}
    for shape in DCN_SHAPES:
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dcn-worker", str(r), str(port), shape],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=HERE)
                 for r in (0, 1)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=DCN_TIMEOUT_S)[0])
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.wait()
            raise SmokeFailure(f"dcn {shape}: the workers did not finish within {DCN_TIMEOUT_S} s")
        results = []
        for r, (p, out) in enumerate(zip(procs, outs)):
            for line in out.splitlines():
                print(f"[dcn {shape} rank {r}] {line}", flush=True)
            check(p.returncode == 0, f"dcn {shape}: rank {r} exited {p.returncode}")
            res = [json.loads(x[len("DCN-RESULT "):]) for x in out.splitlines() if x.startswith("DCN-RESULT ")]
            for x in out.splitlines():
                if x.startswith("DCN-LAUNCHES "):
                    add_launches(json.loads(x[len("DCN-LAUNCHES "):]))
            check(len(res) == (2 if shape == "1d" else 3), f"dcn {shape}: rank {r} printed {len(res)} results")
            results.append(res)
        for r, res in enumerate(results):
            for x in res:
                check(x["used_sha"] == want[x["cell"]], f"dcn {shape} rank {r} {x['cell']}: usage != one process's")
        print(f"[dcn] {shape}: both ranks' choices, usage, ordinals and sweeps == the single process's; per rank "
              + "; ".join(f"rank {r}: " + ", ".join(f"{x['cell']} step_s {x['step_s']:.4f} (cross-rank gathers "
                                                    f"{x['gather_s']:.4f} s, {x['exchanges']} exchanges, "
                                                    f"{x['staged_bytes']} B staged)" for x in res)
                          for r, res in enumerate(results))
              + " (gloo on one card, the ranks time-sliced: not NCCL, not a scale-out)", flush=True)


def dcn_worker(rank: int, port: int, shape: str) -> int:
    """One rank of phase_dcn: joins the gloo group, places its blocks through
    DeltaEncoder(mesh=), runs the cell's steps, checks the single-process
    digests and prints one DCN-RESULT JSON line per cell."""
    import torch
    import torch.distributed as dist

    from kubernetes_tpu_torch.api.delta import DeltaEncoder
    from kubernetes_tpu_torch.bench import workloads as w
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, infer_score_config, kernels
    from kubernetes_tpu_torch.ops.incremental import HoistCache
    from kubernetes_tpu_torch.parallel.mesh import init_distributed

    mesh = init_distributed(f"127.0.0.1:{port}", 2, rank, mesh_shape=DCN_SHAPES[shape], backend="gloo",
                            devices=["cuda:0"] * 2)
    span = mesh.span
    print(f"{mesh}: backend {dist.get_backend()}, CUDA tensors staged through host memory for gloo", flush=True)
    cells = [("north-star", w.heterogeneous(**w.NORTH_STAR), w.NORTH_STAR_CHOICES_SHA256, w.NORTH_STAR_DENSE_SWEEPS,
              w.NORTH_STAR_DENSE_ORDINALS_SHA256, {"packed_static_rows": 2, "stitch_planes": 1,
                                                   "chunk_rounds_dense": 1})]
    if shape != "1d":
        cells.append(("config3", w.spread_affinity(**w.CONFIG3), w.CONFIG3_CHOICES_SHA256, w.CONFIG3_ROUNDS_SWEEPS,
                      w.CONFIG3_ROUNDS_ORDINALS_SHA256, {"packed_static_rows": 2, "rounds_shard": 1}))
    def run(cell, step_fn, need, want_c, want_sw, want_o, n, n_nodes):
        kernels.reset_launches()
        step = step_fn()
        torch.cuda.synchronize()
        launches = counted()
        check(launches == need, f"dcn {shape} {cell}: launches {launches}, want {need}")
        digest = sha_i32(step.choices[:n])
        check(digest == want_c, f"dcn {shape} {cell}: choices differ from JAX")
        check(step.sweeps == want_sw and sha_i32(step.ordinals[:n]) == want_o, f"dcn {shape} {cell}: ordinals")
        stats0 = dict(span.stats)
        step_s = best_step_s(step_fn)
        st = span.stats
        calls = st["calls"] - stats0["calls"]
        gather_s = (st["seconds"] - stats0["seconds"]) / 2
        print(f"{cell}: choices sha256 {digest}, sweeps {step.sweeps}, launches {launches}, step_s {step_s:.4f} "
              f"(best of 2), cross-rank gathers {gather_s:.4f} s a step ({calls // 2} exchanges)", flush=True)
        print("DCN-RESULT " + json.dumps(dict(cell=cell, choices_sha=digest, used_sha=sha_i32(step.used[:n_nodes]),
                                              step_s=step_s, gather_s=gather_s, exchanges=calls // 2,
                                              staged_bytes=(st["staged_bytes"] - stats0["staged_bytes"]) // 2)),
              flush=True)

    for cell, snap, want_c, want_sw, want_o, need in cells:
        enc = DeltaEncoder(mesh=mesh)
        host, meta = enc.encode(snap)
        arr, _ = enc.to_device(host, meta)
        cfg = infer_score_config(host, DEFAULT_SCORE_CONFIG)
        n = meta.n_pods
        run(cell, lambda: assign.finish(assign.dispatch(arr, cfg, mesh=mesh)), need, want_c, want_sw, want_o, n,
            host.N)
        if cell == "north-star":
            kernels.reset_launches()
            inc = HoistCache(mesh=mesh).ensure(arr, meta, cfg, host=host)
            torch.cuda.synchronize()
            hl = counted()
            check(hl == {"class_static_hoist": 2, "class_usage_hoist": 2, "stitch_planes": 2},
                  f"dcn {shape}: HoistCache launches {hl}")
            run("north-star-waves", lambda: assign.finish(assign.dispatch(arr, cfg, inc=inc, mesh=mesh)),
                {"wave_commit": 1, "chunk_rounds": 1}, want_c, w.NORTH_STAR_WAVE_SWEEPS,
                w.NORTH_STAR_WAVE_ORDINALS_SHA256, n, host.N)
            del inc
        del arr, enc
        torch.cuda.empty_cache()
    dist.barrier()
    dist.destroy_process_group()
    print("DCN-LAUNCHES " + json.dumps(RUN_LAUNCHES), flush=True)
    return 0



def choices_used(arr, choices, k: int):
    """node_used after the first k pods' placements."""
    import torch

    used = arr.node_used.clone()
    c = choices[:k].to(torch.int64)
    m = c >= 0
    used.index_add_(0, c[m], arr.pod_req[:k][m])
    return used


def launch_key(name: str) -> str:
    """The LAUNCHES key of a kernels-line row (a mode's row: its kernel's)."""
    shard = {"fit_scan (shard)": "fit_scan_shard", "full_scan (shard)": "full_scan_shard",
             "rounds (shard)": "rounds_shard", "rounds (shard, class rows)": "rounds_shard"}
    return shard.get(name) or re.split(r"[ +]", name)[0].replace("rounds_class_rows", "rounds")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "kubernetes_tpu_torch")):
        print("chip_smoke: kubernetes_tpu_torch is not beside this script", file=sys.stderr)
        return 2
    card, name = phase_card()
    phase_env()
    phase_build()
    phase_interner()
    phase_mixed()
    step_s, rows, ns_pp = phase_north_star()
    rows += phase_mesh_north_star_perpod(ns_pp)
    del ns_pp
    phase_waves_mixed()
    rows += phase_north_star_waves(step_s)
    step_dense_s, cold, ns, dense_rows = phase_north_star_dense()
    rows += dense_rows
    k14 = phase_explain_north_star(ns)
    used_sha = hashlib.sha256(ns["used"].cpu().numpy().astype("<i4").tobytes()).hexdigest()
    del ns
    warm = phase_warm_loop(cold)
    rows += phase_mesh_north_star(used_sha)
    phase_mesh_warm_loop(cold, warm)
    phase_mesh2d_north_star(used_sha)
    phase_mesh2d_warm_loop(cold, warm)
    rows += phase_ring()
    rows += phase_wide_planes()
    c3, _, k12_row = phase_config3()
    _, k11_row = phase_config3_perpod(c3)
    phase_perpod_small()
    rows.append(phase_k1_pinned())
    cold3, _, inc_rows, k4_c3 = phase_config3_inc(c3)
    k4_row = next(r for r in rows if r["name"] == "class_usage_hoist")
    k4_row["max_abs_err"] += k4_c3.pop("max_abs_err")
    k4_row.update(k4_c3)
    mesh3_rows = phase_mesh_config3(c3, k12_row, k11_row)
    phase_mesh2d_config3(c3)
    c3_used_sha = sha_i32(choices_used(c3[0], c3[3], c3[0].P)[:c3[0].N])
    k_ops3 = c3[-1]
    del c3
    warm3 = phase_config3_warm(cold3)
    phase_mesh_config3_warm(cold3, warm3)
    k10_rows, (k11_err, k12_err) = phase_all_stages()
    k11_row["max_abs_err"] += k11_err
    k12_row["max_abs_err"] += k12_err
    rows += k10_rows + [k11_row, k12_row] + inc_rows + mesh3_rows
    phase_gang_small()
    rows += phase_config5()
    k12_gated = phase_gang_rounds(k_ops3, k12_row)
    phase_mesh_gangs()
    rows += phase_gang_contended(k12_gated) + [k12_gated]
    phase_sidecar_north_star()
    phase_sidecar_config5()
    snap4s, cold4s = phase_config4s()
    phase_config4s_warm(snap4s, cold4s)
    phase_config4s_sidecar(snap4s, cold4s)
    del snap4s, cold4s
    phase_dra_small()
    t0 = time.perf_counter()
    unkilled4_s = phase_scheduler_config4(card)
    phase_scheduler_config5(card)
    phase_scheduler_preempt(card)
    phase_scheduler_native(card)
    print(f"[scheduler] the four Scheduler phases took {time.perf_counter() - t0:.1f} s", flush=True)
    rows += phase_preempt(k14)
    phase_dcn(used_sha, c3_used_sha)
    phase_scheduler_restart(card, unkilled4_s)
    phase_stream_restart(cold, card)
    for row in rows:
        row["launches_run"] = RUN_LAUNCHES.get(launch_key(row["name"]), 0)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dcn-worker"]:
        sys.exit(dcn_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(sidecar_config5_child() if sys.argv[1:] == ["--sidecar-config5"] else main())
