"""Print the JAX package's reference numbers at the north-star shape.

At heterogeneous(20000, 50000, seed=0) on the CPU:

- the per-pod leg: the JAX package's schedule_batch (its per-pod scan) ->
  the number of scheduled pods and the sha256 of choices[:n_pods] as
  little-endian int32;
- the class-wave legs, each in a fresh process (the JAX package reads its
  routing knobs at import): KTPU_FORCE_CHUNKED=1, DeltaEncoder,
  HoistCache.ensure, schedule_batch_ordinals_routed, once with the class
  waves on and once with KTPU_CLASS_WAVES=0 -> the sweep count, the sha256
  of ordinals[:n_pods] and of choices[:n_pods] (little-endian int32).

kubernetes_tpu_torch/bench/workloads.py keeps these numbers and
chip_smoke.py holds the port's route on the card against them.  About a
minute and 2 GB on the CPU:

    JAX_PLATFORMS=cpu python tests/torch_north_star_digest.py
"""

import hashlib
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


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--leg":
        wave_leg(sys.argv[2])
        return
    per_pod_leg()
    for name, waves in (("waves", "1"), ("waves-off", "0")):
        env = {**os.environ, "KTPU_FORCE_CHUNKED": "1", "KTPU_CLASS_WAVES": waves}
        subprocess.run([sys.executable, os.path.abspath(__file__), "--leg", name], env=env, check=True)


if __name__ == "__main__":
    main()
