"""The JAX package's per-pod scan and rounds scan on the pairwise snapshots
of tests/test_assign_parity.py, the all-stages snapshot and two fit-only
batches too small to chunk, for tests/test_torch_rounds.py and
tests/test_torch_rounds_inc.py.

The JAX package reads the rounds kernel's knobs when it is imported
(KTPU_RCHUNK, KTPU_REPAIR_ITERS), so this runs in a fresh process with them
pinned:

    KTPU_RCHUNK=16 KTPU_REPAIR_ITERS=1 KTPU_FORCE_CHUNKED=1 JAX_PLATFORMS=cpu \
        python tests/torch_rounds_reference.py OUT.npz

For every snapshot (SNAPSHOTS) it encodes with the JAX DeltaEncoder and
runs schedule_scan (-> "<name>/choices", "<name>/used") and
schedule_scan_rounds with ordinals (-> "<name>/rounds_choices",
"<name>/rounds_used", "<name>/ordinals", "<name>/sweeps"); then the class
state of its HoistCache and, where inc_applicable admits it
("<name>/inc_applied"), schedule_scan_rounds(inc=) with ordinals (->
"<name>/inc_choices", "<name>/inc_used", "<name>/inc_ordinals",
"<name>/inc_sweeps").
"""

import os
import random
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PINNED = {"KTPU_RCHUNK": "16", "KTPU_REPAIR_ITERS": "1", "KTPU_FORCE_CHUNKED": "1"}


def _same_app_spread():
    """Every pod shares one DoNotSchedule zone spread term (one app)."""
    from helpers import mk_node, mk_pod
    from kubernetes_tpu.api import types as t
    from kubernetes_tpu.api.snapshot import Snapshot

    nodes = [mk_node(f"n{i}", cpu=4000, pods=300, labels={t.LABEL_ZONE: f"zone-{i % 3}"}) for i in range(9)]
    spread = (t.TopologySpreadConstraint(max_skew=1, topology_key=t.LABEL_ZONE, when_unsatisfiable=t.DO_NOT_SCHEDULE,
                                         label_selector=t.LabelSelector.of(app="one")),)
    pods = [mk_pod(f"p{i:04d}", cpu=50, labels={"app": "one"}, topology_spread=spread) for i in range(128)]
    return Snapshot(nodes=nodes, pending_pods=pods)


def _anti_one_per_node():
    """Hostname-scoped required anti-affinity against the pod's own app."""
    from helpers import mk_node, mk_pod
    from kubernetes_tpu.api import types as t
    from kubernetes_tpu.api.snapshot import Snapshot

    term = t.PodAffinityTerm(topology_key=t.LABEL_HOSTNAME, label_selector=t.LabelSelector.of(app="solo"))
    nodes = [mk_node(f"n{i:03d}", cpu=4000) for i in range(140)]
    pods = [mk_pod(f"p{i:04d}", cpu=100, labels={"app": "solo"},
                   affinity=t.Affinity(required_pod_anti_affinity=(term,))) for i in range(128)]
    return Snapshot(nodes=nodes, pending_pods=pods)


def _skew_exhaustion():
    """maxSkew=1 over unbalanced zones (6/3/1 nodes) and capacity that runs
    out mid-chunk."""
    from helpers import mk_node, mk_pod
    from kubernetes_tpu.api import types as t
    from kubernetes_tpu.api.snapshot import Snapshot

    nodes = [mk_node(f"n{i}", cpu=1200, pods=8,
                     labels={t.LABEL_ZONE: f"zone-{0 if i < 6 else (1 if i < 9 else 2)}"}) for i in range(10)]
    spread = (t.TopologySpreadConstraint(max_skew=1, topology_key=t.LABEL_ZONE, when_unsatisfiable=t.DO_NOT_SCHEDULE,
                                         label_selector=t.LabelSelector.of(app="a")),)
    pods = [mk_pod(f"p{i:04d}", cpu=300, labels={"app": "a"}, topology_spread=spread) for i in range(128)]
    return Snapshot(nodes=nodes, pending_pods=pods)


def _rounds_random(seed: int):
    from helpers import random_cluster

    rng = random.Random(4000 + seed)
    return random_cluster(rng, n_nodes=rng.randint(6, 40), n_pods=rng.choice([128, 256]), with_taints=True,
                          with_selectors=True, with_pairwise=True)


def _pairwise(seed: int, n_nodes: int = 15, n_pods: int = 37):
    from helpers import random_cluster

    return random_cluster(random.Random(seed), n_nodes=n_nodes, n_pods=n_pods, with_taints=True,
                          with_selectors=True, with_pairwise=True)


def _all_stages():
    from kubernetes_tpu_torch.bench.workloads import all_stages

    return all_stages(24, 256)


def _fit_only(n_nodes: int, n_pods: int, seed: int):
    """A fit-only batch of fewer than 128 pods: not chunkable, so off the
    CPU it takes the rounds route with every pairwise stage off."""
    from kubernetes_tpu_torch.bench.workloads import mixed

    return mixed(n_nodes, n_pods, seed=seed)


SNAPSHOTS = {
    **{f"pairwise-{s}": (lambda s=s: _pairwise(2000 + s)) for s in range(8)},
    "pairwise-medium": lambda: _pairwise(77, 48, 150),
    **{f"rounds-random-{s}": (lambda s=s: _rounds_random(s)) for s in range(4)},
    "same-app-spread": _same_app_spread,
    "anti-one-per-node": _anti_one_per_node,
    "skew-exhaustion": _skew_exhaustion,
    "all-stages": _all_stages,
    "fit-only-64": lambda: _fit_only(40, 64, 0),
    "fit-only-32": lambda: _fit_only(12, 32, 5),
}
FIT_ONLY = ("fit-only-64", "fit-only-32")


def snapshot(name: str):
    sys.path.insert(0, HERE)
    return SNAPSHOTS[name]()


def main() -> None:
    out = sys.argv[1]
    for k, v in PINNED.items():
        if os.environ.get(k) != v:
            raise SystemExit(f"run with {k}={v}")
    sys.path.insert(0, os.path.dirname(HERE))
    from __graft_entry__ import force_cpu_platform

    force_cpu_platform(1)
    import jax

    from kubernetes_tpu.api.delta import DeltaEncoder
    from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG, infer_score_config
    from kubernetes_tpu.ops.assign import inc_applicable, schedule_scan, schedule_scan_rounds
    from kubernetes_tpu.ops.incremental import HoistCache

    scan = jax.jit(schedule_scan, static_argnames=("cfg",))
    rounds = jax.jit(schedule_scan_rounds, static_argnames=("cfg", "with_ordinals"))
    res = {}
    for name in SNAPSHOTS:
        arr, meta = DeltaEncoder().encode(snapshot(name))
        cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
        c, u = scan(arr, cfg)
        rc, ru, o, s = rounds(arr, cfg, with_ordinals=True)
        for field, x in (("choices", c), ("used", u), ("rounds_choices", rc), ("rounds_used", ru),
                         ("ordinals", o), ("sweeps", s)):
            res[f"{name}/{field}"] = np.asarray(x)
        inc = inc_applicable(arr, cfg, HoistCache().ensure(arr, meta, cfg))
        res[f"{name}/inc_applied"] = np.asarray(inc is not None)
        if inc is not None:
            ic, iu, io, i_s = rounds(arr, cfg, with_ordinals=True, inc=inc)
            for field, x in (("inc_choices", ic), ("inc_used", iu), ("inc_ordinals", io), ("inc_sweeps", i_s)):
                res[f"{name}/{field}"] = np.asarray(x)
    np.savez(out, **res)


if __name__ == "__main__":
    main()
