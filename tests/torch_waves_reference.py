"""The JAX package's class-wave route on small snapshots, for
tests/test_torch_waves.py.

The JAX package reads its routing knobs when it is imported
(KTPU_FORCE_CHUNKED at trace time, KTPU_CLASS_WAVES / KTPU_WAVE_K /
KTPU_WAVE_BLOCK at import), so each leg runs in a fresh process with its
environment pinned (LEGS below):

    JAX_PLATFORMS=cpu python tests/torch_waves_reference.py LEG OUT.npz

For every snapshot of the leg it encodes with DeltaEncoder, builds the class
state with HoistCache.ensure and runs schedule_batch_ordinals_routed, and
saves choices, used, ordinals and sweeps under "<snapshot>/<field>".  The
"dense" leg (DENSE, for tests/test_torch_dense.py) builds no class state:
the route is the dense chunked one, 128-pod chunks.
"""

import os
import random
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# leg -> (environment, snapshots, the port's knobs for the same route)
LEGS = {
    "waves": ({"KTPU_FORCE_CHUNKED": "1"}, ("random", "selectors", "heterogeneous", "interference", "mixed"), {}),
    "waves-off": ({"KTPU_FORCE_CHUNKED": "1", "KTPU_CLASS_WAVES": "0"},
                  ("random", "selectors", "heterogeneous", "interference", "mixed"), {"class_waves": False}),
    # two-entry lists in 64-pod blocks: the block budget runs out and stage B
    # continues the serial order over the rest
    "truncated": ({"KTPU_FORCE_CHUNKED": "1", "KTPU_WAVE_K": "2", "KTPU_WAVE_BLOCK": "64"},
                  ("basic-truncated",), {"wave_k": 2, "wave_block": 64}),
}


# the dense chunked route (no class state) on the waves leg's snapshots,
# every one of which has P >= 128
DENSE = ({"KTPU_FORCE_CHUNKED": "1"}, ("random", "selectors", "heterogeneous", "interference", "mixed"))


def snapshot(name: str):
    """The snapshots both packages encode (JAX-typed ones and the port's
    mixed/interference, which the JAX encoder reads as they are)."""
    sys.path.insert(0, HERE)
    from helpers import random_cluster
    from kubernetes_tpu.bench import workloads as jw
    from kubernetes_tpu_torch.bench import workloads as tw

    return {
        "random": lambda: random_cluster(random.Random(42), n_nodes=24, n_pods=120),
        "selectors": lambda: random_cluster(random.Random(5), n_nodes=16, n_pods=200, with_selectors=True),
        "heterogeneous": lambda: jw.heterogeneous(64, 300),
        "interference": tw.interference,
        "mixed": tw.mixed,
        "basic-truncated": lambda: jw.basic(48, 1500),
    }[name]()


def main() -> None:
    leg, out = sys.argv[1], sys.argv[2]
    env, names = DENSE if leg == "dense" else LEGS[leg][:2]
    for k, v in env.items():
        if os.environ.get(k) != v:
            raise SystemExit(f"{leg}: run with {k}={v}")
    sys.path.insert(0, os.path.dirname(HERE))
    from __graft_entry__ import force_cpu_platform

    force_cpu_platform(1)
    from kubernetes_tpu.api.delta import DeltaEncoder
    from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG, infer_score_config
    from kubernetes_tpu.ops.assign import schedule_batch_ordinals_routed
    from kubernetes_tpu.ops.incremental import HoistCache

    res = {}
    for name in names:
        arr, meta = DeltaEncoder().encode(snapshot(name))
        cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
        inc = None if leg == "dense" else HoistCache().ensure(arr, meta, cfg)
        c, u, o, s = schedule_batch_ordinals_routed(arr, cfg, donate=False, inc=inc)
        for field, x in (("choices", c), ("used", u), ("ordinals", o), ("sweeps", s)):
            res[f"{name}/{field}"] = np.asarray(x)
    np.savez(out, **res)


if __name__ == "__main__":
    main()
