"""The JAX package's gang fixpoints on tests/test_torch_gang.py's snapshots.

The JAX package routes class state only on its chunked routes and reads
KTPU_FORCE_CHUNKED when it traces, so this runs in a fresh process with it
pinned:

    KTPU_FORCE_CHUNKED=1 JAX_PLATFORMS=cpu python tests/torch_gang_reference.py OUT.npz

For every snapshot (SNAPSHOTS: kubernetes_tpu_torch/bench/workloads.py gang
draws, built by the JAX package's own copy) it encodes with the JAX
DeltaEncoder (-> "<name>/pod_group", "<name>/group_min", "<name>/pod_class")
and runs schedule_with_gangs with ordinals on its HoistCache class state
(the class-wave route each iteration; -> "<name>/inc_choices", "inc_used",
"inc_ordinals", "inc_sweeps"), without class state (the dense chunked
route; -> "<name>/dense_choices", "dense_ordinals", "dense_sweeps") and
gang_fixpoint_device (-> "<name>/device_choices", "<name>/device_used").
For every NO_GROUPS batch (basic(24, n_pods, seed=n_pods), encoded by
encode_snapshot, with every pod's group cleared and G = 0) it runs
gang_fixpoint_device, which is the plain batch step there
(-> "<name>/device_choices", "<name>/device_used").
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PINNED = {"KTPU_FORCE_CHUNKED": "1"}
# gang(n_groups, group_size, n_nodes, seed): tests/test_gang.py's 24 groups
# of 8 on 12 nodes (every group fits), and 16 groups of 16 on 3 nodes (five
# groups revoked, six fixpoint iterations)
SNAPSHOTS = {"gang-24x8": (24, 8, 12, 11), "gang-16x16-tight": (16, 16, 3, 1)}
# basic(24, n_pods, seed=n_pods) without a PodGroup: G = 0
NO_GROUPS = {f"basic-{n}": n for n in (50, 300)}


def main() -> None:
    out = sys.argv[1]
    for k, v in PINNED.items():
        if os.environ.get(k) != v:
            raise SystemExit(f"run with {k}={v}")
    sys.path.insert(0, os.path.dirname(HERE))
    from __graft_entry__ import force_cpu_platform

    force_cpu_platform(1)
    import dataclasses

    import jax.numpy as jnp

    from kubernetes_tpu.api.delta import DeltaEncoder
    from kubernetes_tpu.api.snapshot import encode_snapshot
    from kubernetes_tpu.bench.workloads import basic, gang
    from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG, infer_score_config
    from kubernetes_tpu.ops.gang import gang_fixpoint_device, schedule_with_gangs
    from kubernetes_tpu.ops.incremental import HoistCache

    res = {}
    for name, (g, s, n, seed) in SNAPSHOTS.items():
        arr, meta = DeltaEncoder().encode(gang(g, s, n, seed=seed))
        cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
        inc = HoistCache().ensure(arr, meta, cfg)
        runs = {
            "inc": schedule_with_gangs(arr, cfg, with_ordinals=True, inc=inc),
            "dense": schedule_with_gangs(arr, cfg, with_ordinals=True),
        }
        for mode, (c, u, o, sw) in runs.items():
            for field, x in (("choices", c), ("used", u), ("ordinals", o), ("sweeps", sw)):
                res[f"{name}/{mode}_{field}"] = np.asarray(x)
        dc, du = gang_fixpoint_device(arr, cfg)
        res[f"{name}/device_choices"] = np.asarray(dc)
        res[f"{name}/device_used"] = np.asarray(du)
        for field in ("pod_group", "group_min"):
            res[f"{name}/{field}"] = np.asarray(getattr(arr, field))
        res[f"{name}/pod_class"] = np.asarray(meta.pod_class)
    for name, n in NO_GROUPS.items():
        arr, _ = encode_snapshot(basic(24, n, seed=n))
        arr = dataclasses.replace(arr, pod_group=jnp.full_like(arr.pod_group, -1), group_min=arr.group_min[:0])
        dc, du = gang_fixpoint_device(arr, infer_score_config(arr, DEFAULT_SCORE_CONFIG))
        res[f"{name}/device_choices"] = np.asarray(dc)
        res[f"{name}/device_used"] = np.asarray(du)
    np.savez(out, **res)


if __name__ == "__main__":
    main()
