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
  scheduled count and the choices digest.

kubernetes_tpu_torch/bench/workloads.py keeps these numbers and
chip_smoke.py holds the port's routes on the card against them.  The
dense leg takes minutes on the CPU (one dense step is tens of seconds
there), the whole script about ten minutes and a few GB:

    JAX_PLATFORMS=cpu python tests/torch_north_star_digest.py [LEG ...]

(LEG: waves, waves-off, dense, warm or wide runs only those legs.  The warm leg
alone on a smaller heterogeneous(N_NODES, N_PODS), as tests/test_torch_pipeline.py
runs it: KTPU_FORCE_CHUNKED=1 python tests/torch_north_star_digest.py --leg
warm N_NODES N_PODS.)
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


def warm_leg(n_nodes: int = 20000, n_pods: int = 50000) -> None:
    from kubernetes_tpu.api.delta import DeltaEncoder
    from kubernetes_tpu.api.snapshot import Snapshot
    from kubernetes_tpu.bench.workloads import heterogeneous
    from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG, infer_score_config
    from kubernetes_tpu.ops.assign import schedule_batch_routed
    from kubernetes_tpu.ops.incremental import HoistCache
    from kubernetes_tpu.parallel.pipeline import PipelinedBatchLoop
    from kubernetes_tpu_torch.bench.workloads import verdicts_of, warm_waves, wave_digest

    snap = heterogeneous(n_nodes, n_pods, seed=0)
    enc = DeltaEncoder()
    arr, meta = enc.encode(snap)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    inc = HoistCache().ensure(arr, meta, cfg)
    choices = np.asarray(schedule_batch_routed(arr, cfg, donate=False, inc=inc)[0])
    print(f"warm: wave 1 choices sha256 {_sha(choices[: meta.n_pods])}", flush=True)
    loop = PipelinedBatchLoop(encoder=enc, donate=False, depth=0, memwatch=False)
    waves, fetched, *_ = warm_waves(snap, verdicts_of(choices, meta), loop.submit, loop.drain, Snapshot)
    names = [nd.name for nd in snap.nodes]
    digests = {w: wave_digest(waves[w], fetched[w], names) for w in sorted(fetched) if w >= 2}
    sched = {w: sum(1 for v in fetched[w].values() if v) for w in sorted(digests)}
    print(f"warm: digests {digests}", flush=True)
    print(f"warm: scheduled {sched}", flush=True)
    print(f"warm: hoist actions {[h['action'] for h in loop.hoist.history]}", flush=True)
    print(f"warm: encoder stats {enc.stats}", flush=True)
    print("warm-json: " + json.dumps({"verdicts": {str(w): fetched[w] for w in sorted(digests)},
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


LEGS = {"dense": dense_leg, "warm": warm_leg, "wide": wide_leg}


def main() -> None:
    if len(sys.argv) >= 3 and sys.argv[1] == "--leg":
        if sys.argv[2] == "warm" and len(sys.argv) == 5:  # a smaller warm stream (the CPU tests')
            warm_leg(int(sys.argv[3]), int(sys.argv[4]))
        else:
            LEGS.get(sys.argv[2], lambda: wave_leg(sys.argv[2]))()
        return
    only = sys.argv[1:]
    if not only:
        per_pod_leg()
    runs = [("waves", {"KTPU_CLASS_WAVES": "1"}), ("waves-off", {"KTPU_CLASS_WAVES": "0"}),
            ("dense", {}), ("warm", {"KTPU_MEMWATCH": "0"}), ("wide", {"KTPU_FORCE_CHUNKED": "0"})]
    for name, extra in runs:
        if only and name not in only:
            continue
        env = {**os.environ, "KTPU_FORCE_CHUNKED": "1", **extra}
        subprocess.run([sys.executable, os.path.abspath(__file__), "--leg", name], env=env, check=True)


if __name__ == "__main__":
    main()
