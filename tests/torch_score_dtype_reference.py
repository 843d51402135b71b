"""One side of tests/test_torch_score_dtype.py: the JAX package or the port
on the same snapshots, under one KTPU_SCORE_DTYPE.

Both packages read the knob when they are imported, so each side runs in a
fresh process with it pinned, beside the rounds knobs the JAX scans read:

    KTPU_SCORE_DTYPE=f32 KTPU_RCHUNK=16 KTPU_REPAIR_ITERS=1 KTPU_FORCE_CHUNKED=1 \\
        JAX_PLATFORMS=cpu python tests/torch_score_dtype_reference.py jax|port OUT.npz

What it writes, under the same keys for both sides:

- ``c5/bound``: the node the ROADMAP C5 case's pod is bound to by the
  side's Scheduler in mode="tpu" (the port's on the CPU); the JAX side
  adds ``c5/oracle``, the serial oracle's node;
- for every seed of SEEDS, a random_cluster snapshot given preferred
  node-affinity terms (summed weights off the bf16 lattice) and images
  (ImageLocality scores off it): the per-pod scan (``choices``, ``used``),
  the rounds scan (``rounds_*``, ``ordinals``, ``sweeps``), the rounds scan
  on the HoistCache's class state (``inc_*``), the native engine
  (``native_*``), and the raw planes as f32 bit patterns: the score planes'
  plain producers (``traw``, ``naraw``), the encoder's ``image_score``, the
  native mirror's (``np_traw``, ``np_naraw``).
"""

import os
import random
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PINNED = {"KTPU_RCHUNK": "16", "KTPU_REPAIR_ITERS": "1", "KTPU_FORCE_CHUNKED": "1"}
SEEDS = tuple(range(8))
C5_WEIGHTS = {"a": 100, "b": 100, "c": 57, "d": 56}


def c5_objects():
    """ROADMAP C5: two equal nodes, a pod whose preferred node-affinity
    terms weigh a 100, b 100, c 57, d 56; node-b (added first) matches a,
    b, d (256), node-a matches a, b, c (257, which bf16 stores as 256)."""
    from helpers import mk_node, mk_pod
    from kubernetes_tpu.api import types as t

    def term(key, w):
        req = t.NodeSelectorRequirement(key=key, operator=t.OP_EXISTS)
        return t.PreferredSchedulingTerm(weight=w, preference=t.NodeSelectorTerm(match_expressions=(req,)))

    nodes = [mk_node("node-b", cpu=4000, labels={"a": "1", "b": "1", "d": "1"}),
             mk_node("node-a", cpu=4000, labels={"a": "1", "b": "1", "c": "1"})]
    aff = t.Affinity(preferred_node_terms=tuple(term(k, w) for k, w in C5_WEIGHTS.items()))
    return nodes, mk_pod("pod-0", cpu=100, affinity=aff)


def sweep_snapshot(seed: int):
    """random_cluster(15 nodes, 37 pods, every feature) whose pods also
    carry 2-5 preferred node-affinity terms (weights 1-100, so the sums pass
    256) and images the nodes hold (sizes that give scores off the bf16
    lattice)."""
    import dataclasses

    from helpers import random_cluster
    from kubernetes_tpu.api import types as t

    rng = random.Random(6000 + seed)
    snap = random_cluster(rng, n_nodes=15, n_pods=37, with_taints=True, with_selectors=True, with_pairwise=True)
    images = [f"img-{k}" for k in range(6)]
    for nd in snap.nodes:
        nd.images = {im: rng.randint(30, 700) * 1024 * 1024 + rng.randint(0, 999) for im in images
                     if rng.random() < 0.5}
    keys = ((t.LABEL_ZONE, ("zone-0", "zone-1", "zone-2")), ("disktype", ("ssd", "hdd")), ("tier", ("a", "b", "c")))
    pods = []
    for pod in snap.pending_pods:
        kw = {}
        if rng.random() < 0.7:
            prefs = []
            for _ in range(rng.randint(2, 5)):
                key, vals = rng.choice(keys)
                req = t.NodeSelectorRequirement(key=key, operator=rng.choice([t.OP_IN, t.OP_NOT_IN]),
                                                values=(rng.choice(vals),))
                prefs.append(t.PreferredSchedulingTerm(weight=rng.randint(1, 100),
                                                       preference=t.NodeSelectorTerm(match_expressions=(req,))))
            aff = pod.affinity or t.Affinity()
            kw["affinity"] = dataclasses.replace(aff, preferred_node_terms=tuple(prefs))
        if rng.random() < 0.6:
            kw["images"] = tuple(rng.sample(images, rng.randint(1, 3)))
        pods.append(dataclasses.replace(pod, **kw) if kw else pod)
    return dataclasses.replace(snap, pending_pods=pods)


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.int32)


def jax_side() -> dict:
    sys.path.insert(0, os.path.dirname(HERE))
    from __graft_entry__ import force_cpu_platform

    force_cpu_platform(1)
    import jax
    import jax.numpy as jnp

    from kubernetes_tpu import native as jnative
    from kubernetes_tpu.api.delta import DeltaEncoder
    from kubernetes_tpu.api.snapshot import Snapshot, encode_snapshot
    from kubernetes_tpu.native import static_np
    from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG, infer_score_config
    from kubernetes_tpu.ops import assign, filters, scores
    from kubernetes_tpu.ops.assign import inc_applicable, schedule_scan, schedule_scan_rounds
    from kubernetes_tpu.ops.incremental import HoistCache
    from kubernetes_tpu.oracle import oracle_schedule
    from torch_scheduler_sides import Side

    res = {}
    nodes, pod = c5_objects()
    side = Side("jax")
    store, sched = side.cluster("tpu", nodes=nodes)
    store.add_pod(pod)
    sched.run_until_idle()
    res["c5/bound"] = np.asarray(store.pods[pod.uid].node_name or "")
    res["c5/oracle"] = np.asarray(dict(oracle_schedule(Snapshot(nodes=c5_objects()[0], pending_pods=[pod]),
                                                       DEFAULT_SCORE_CONFIG))["pod-0"] or "")

    scan = jax.jit(schedule_scan, static_argnames=("cfg",))
    rounds = jax.jit(schedule_scan_rounds, static_argnames=("cfg", "with_ordinals"))
    for seed in SEEDS:
        k = f"s{seed}"
        snap = sweep_snapshot(seed)
        arr, meta = DeltaEncoder().encode(snap)
        cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
        c, u = scan(arr, cfg)
        rc, ru, o, s = rounds(arr, cfg, with_ordinals=True)
        out = dict(choices=c, used=u, rounds_choices=rc, rounds_used=ru, ordinals=o, sweeps=s)
        inc = inc_applicable(arr, cfg, HoistCache().ensure(arr, meta, cfg))
        out["inc_applied"] = inc is not None
        if inc is not None:
            out.update(zip(("inc_choices", "inc_used", "inc_ordinals", "inc_sweeps"),
                           rounds(arr, cfg, with_ordinals=True, inc=inc)))
        tm = filters.term_match(arr.sel_mask, arr.sel_kind, arr.node_labels)
        out["traw"] = _bits(jnp.asarray(scores.taint_prefer_counts(arr), jnp.float32))
        out["naraw"] = _bits(jnp.asarray(assign._preferred_node_affinity_raw(arr, tm), jnp.float32))
        out["image_score"] = _bits(jnp.asarray(arr.image_score, jnp.float32))
        harr, _ = encode_snapshot(snap)
        hcfg = infer_score_config(harr, DEFAULT_SCORE_CONFIG)
        out["native_choices"], out["native_used"] = jnative.schedule_batch_native(harr, hcfg)
        out["np_traw"] = _bits(static_np.taint_prefer_counts(harr))
        out["np_naraw"] = _bits(static_np.preferred_na_raw(harr, static_np.static_feasible(harr)[2]))
        res.update({f"{k}/{name}": np.asarray(x) for name, x in out.items()})
    return res


def port_side() -> dict:
    import torch

    from kubernetes_tpu_torch import native
    from kubernetes_tpu_torch.api.delta import DeltaEncoder
    from kubernetes_tpu_torch.api.snapshot import encode_snapshot
    from kubernetes_tpu_torch.convert import from_jax_objects
    from kubernetes_tpu_torch.native import static_np
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, infer_score_config
    from kubernetes_tpu_torch.ops.incremental import HoistCache
    from torch_scheduler_sides import Side

    torch.set_num_threads(1)
    res = {}
    nodes, pod = c5_objects()
    side = Side("port")
    store, sched = side.cluster("tpu", nodes=nodes)
    store.add_pod(pod)
    sched.run_until_idle()
    res["c5/bound"] = np.asarray(store.pods[pod.uid].node_name or "")

    for seed in SEEDS:
        k = f"s{seed}"
        snap = sweep_snapshot(seed)
        arr, meta = encode_snapshot(snap, device="cpu")
        cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
        c, u = assign.schedule_scan_plain(arr, cfg)
        rc, ru, o, s = assign.schedule_scan_rounds_plain(arr, cfg)
        out = dict(choices=c, used=u, rounds_choices=rc, rounds_used=ru, ordinals=o, sweeps=s)
        inc = assign.inc_applicable(arr, cfg, HoistCache().ensure(arr, meta, cfg))
        out["inc_applied"] = inc is not None
        if inc is not None:
            out.update(zip(("inc_choices", "inc_used", "inc_ordinals", "inc_sweeps"),
                           assign.schedule_scan_rounds_plain(arr, cfg, inc=inc)))
        traw, naraw = assign.score_planes_plain(arr)
        out["traw"], out["naraw"] = _bits(traw.to(torch.float32)), _bits(naraw.to(torch.float32))
        out["image_score"] = _bits(arr.image_score.to(torch.float32))
        host, _ = DeltaEncoder("cpu").encode(from_jax_objects(snap))
        hcfg = infer_score_config(host, DEFAULT_SCORE_CONFIG)
        out["native_choices"], out["native_used"] = native.schedule_batch_native(host, hcfg)
        harr = native.host_arrays(host)
        out["np_traw"] = _bits(static_np.taint_prefer_counts(harr))
        out["np_naraw"] = _bits(static_np.preferred_na_raw(harr, static_np.static_feasible(harr)[2]))
        res.update({f"{k}/{name}": (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x))
                    for name, x in out.items()})
    return res


def main() -> None:
    side, out = sys.argv[1], sys.argv[2]
    for k, v in PINNED.items():
        if os.environ.get(k) != v:
            raise SystemExit(f"run with {k}={v}")
    sys.path.insert(0, HERE)
    np.savez(out, **(jax_side() if side == "jax" else port_side()))


if __name__ == "__main__":
    main()
