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
  post-step usage -> F and the sha256 of the int64 counts.

kubernetes_tpu_torch/bench/workloads.py keeps these numbers and
chip_smoke.py holds the port's routes on the card against them.  The
dense leg takes minutes on the CPU (one dense step is tens of seconds
there), the whole script about ten minutes and a few GB:

    JAX_PLATFORMS=cpu python tests/torch_north_star_digest.py [LEG ...]

(LEG: waves, waves-off, dense, warm, wide, config3, config3-rounds,
all-stages, config3-inc, config3-warm, gang-small, config5, gang-rounds,
gang-contended, gang-pinned, sidecar-north-star, sidecar-config5, preempt or explain
runs only those legs.  The warm leg alone on a smaller heterogeneous(N_NODES, N_PODS), as
tests/test_torch_pipeline.py runs it: KTPU_FORCE_CHUNKED=1 python
tests/torch_north_star_digest.py --leg warm N_NODES N_PODS; the config-3
warm leg on spread_affinity(N_NODES, N_PODS) as tests/test_torch_rounds_inc.py
runs it: --leg config3-warm N_NODES N_PODS; any gang(G, S, N): --leg gang G
S N; any preempt build: --leg preempt N_NODES N_PRE.)
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
    the class state) -> each wave's digest and the HoistCache actions."""
    from kubernetes_tpu.api.delta import DeltaEncoder
    from kubernetes_tpu.api.snapshot import Snapshot
    from kubernetes_tpu.bench import workloads
    from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG, infer_score_config
    from kubernetes_tpu.ops.assign import TRACE_COUNTS, schedule_batch_routed
    from kubernetes_tpu.ops.incremental import HoistCache
    from kubernetes_tpu.parallel.pipeline import PipelinedBatchLoop
    from kubernetes_tpu_torch.bench.workloads import verdicts_of, warm_waves, wave_digest

    name = "warm" if workload == "heterogeneous" else "config3-warm"
    snap = getattr(workloads, workload)(n_nodes, n_pods, seed=0)
    enc = DeltaEncoder()
    arr, meta = enc.encode(snap)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    inc = HoistCache().ensure(arr, meta, cfg)
    choices = np.asarray(schedule_batch_routed(arr, cfg, donate=False, inc=inc)[0])
    print(f"{name}: wave 1 choices sha256 {_sha(choices[: meta.n_pods])}", flush=True)
    loop = PipelinedBatchLoop(encoder=enc, donate=False, depth=0, memwatch=False)
    waves, fetched, *_ = warm_waves(snap, verdicts_of(choices, meta), loop.submit, loop.drain, Snapshot)
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


LEGS = {"dense": dense_leg, "warm": warm_leg, "wide": wide_leg, "config3": config3_leg,
        "config3-rounds": config3_rounds_leg, "all-stages": all_stages_leg, "config3-inc": config3_inc_leg,
        "config3-warm": lambda: warm_leg(5000, 10000, "spread_affinity"),
        "gang-small": lambda: gang_leg(48, 64, 40, "gang-small"),
        "config5": lambda: gang_leg(1000, 64, 2000, "config5"), "preempt": preempt_leg, "explain": explain_leg,
        "gang-rounds": gang_rounds_leg, "gang-contended": gang_contended_leg, "gang-pinned": gang_pinned_leg,
        "sidecar-north-star": lambda: sidecar_leg("sidecar-north-star"),
        "sidecar-config5": lambda: sidecar_leg("sidecar-config5")}


def main() -> None:
    if len(sys.argv) >= 3 and sys.argv[1] == "--leg":
        if sys.argv[2] == "warm" and len(sys.argv) == 5:  # a smaller warm stream (the CPU tests')
            warm_leg(int(sys.argv[3]), int(sys.argv[4]))
        elif sys.argv[2] == "config3-warm" and len(sys.argv) == 5:
            warm_leg(int(sys.argv[3]), int(sys.argv[4]), "spread_affinity")
        elif sys.argv[2] == "gang" and len(sys.argv) == 6:  # any gang(G, S, N)
            gang_leg(*(int(x) for x in sys.argv[3:6]))
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
            ("gang-rounds", {}), ("gang-contended", {}), ("gang-pinned", {}), ("sidecar-north-star", {}), ("sidecar-config5", {})]
    for name, extra in runs:
        if only and name not in only:
            continue
        env = {**os.environ, "KTPU_FORCE_CHUNKED": "1", **extra}
        subprocess.run([sys.executable, os.path.abspath(__file__), "--leg", name], env=env, check=True)


if __name__ == "__main__":
    main()
