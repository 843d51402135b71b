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

Off the dense route: for every CONTENDED snapshot (the port's
bench/workloads.py gang_contended, built in the port's types and carried
over by to_jax) and every RANDOM seed (tests/test_gang.py's
test_device_fixpoint_matches_host_loop draws, built with tests/helpers.py)
it runs gang_fixpoint_device, whose batch step takes the rounds route (P a
multiple of 16) or the per-pod scan (P = 8), and the host fixpoint
schedule_with_gangs (-> "<name>/device_choices", "<name>/device_used",
"<name>/host_choices", "<name>/host_used"); the same for every AT_SCALE
wave (the port's gang_pinned: the contended batch pinned to a pool of
BASELINE config 3's 5000 nodes; keys "scale-<name>/...").
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
# the port's contended gang batches off the dense route, and test_gang.py's
# eight random gang draws
CONTENDED = ("rounds-pairwise", "rounds-fit", "perpod-fit", "perpod-full")
AT_SCALE = CONTENDED
RANDOM = {f"random-{s}": s for s in range(8)}


def to_jax(obj):
    """A port-typed Node / Pod / Snapshot (or a container of them) as the
    JAX package's types: the same field values."""
    import dataclasses

    from kubernetes_tpu.api import snapshot as jsnap
    from kubernetes_tpu.api import types as jt

    if isinstance(obj, (list, tuple)):
        return type(obj)(to_jax(x) for x in obj)
    if isinstance(obj, dict):
        return {k: to_jax(x) for k, x in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = getattr(jt, type(obj).__name__, None) or getattr(jsnap, type(obj).__name__)
        return cls(**{f.name: to_jax(getattr(obj, f.name)) for f in dataclasses.fields(obj)})
    return obj


def contended(name: str):
    """The JAX snapshot of the port's gang_contended(name)."""
    from kubernetes_tpu_torch.bench.workloads import gang_contended

    return to_jax(gang_contended(name))


def pinned(name: str):
    """The JAX snapshot of the port's gang_pinned(name)."""
    from kubernetes_tpu_torch.bench.workloads import gang_pinned

    return to_jax(gang_pinned(name))


def random_gang(seed: int):
    """tests/test_gang.py test_device_fixpoint_matches_host_loop's draw
    (JAX types)."""
    import random

    sys.path.insert(0, HERE)
    from helpers import mk_node, mk_pod
    from kubernetes_tpu.api.snapshot import Snapshot

    rng = random.Random(seed)
    nodes = [mk_node(f"n{i}", cpu=rng.choice([1000, 2000, 4000])) for i in range(rng.randint(2, 5))]
    pods = []
    for g in range(rng.randint(1, 4)):
        size = rng.randint(2, 5)
        for i in range(size):
            pods.append(mk_pod(f"g{g}-{i}", cpu=rng.choice([300, 600, 900]), pod_group=f"grp{g}"))
    for i in range(rng.randint(0, 3)):
        pods.append(mk_pod(f"solo{i}", cpu=rng.choice([200, 500])))
    return Snapshot(nodes=nodes, pending_pods=pods)


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
    from kubernetes_tpu.api.snapshot import encode_snapshot as jencode

    for name, snap in [*((n, contended(n)) for n in CONTENDED), *((n, random_gang(s)) for n, s in RANDOM.items()),
                       *((f"scale-{n}", pinned(n)) for n in AT_SCALE)]:
        arr, _ = jencode(snap)
        cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
        dc, du = gang_fixpoint_device(arr, cfg)
        hc, hu = schedule_with_gangs(arr, cfg)
        for field, x in (("device_choices", dc), ("device_used", du), ("host_choices", hc), ("host_used", hu)):
            res[f"{name}/{field}"] = np.asarray(x)
    np.savez(out, **res)


if __name__ == "__main__":
    main()
