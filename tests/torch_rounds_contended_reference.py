"""Batches that stress the rounds scan's round loop (kernel K12's function),
and the JAX package's results on them, for tests/test_torch_rounds_contended.py.

The JAX package reads the rounds knobs when it is imported, so its side
runs in a fresh process with them pinned (KTPU_REPAIR_ITERS=2 for the one
case that asks for two repair iterations):

    KTPU_RCHUNK=16 KTPU_REPAIR_ITERS=1 KTPU_FORCE_CHUNKED=1 JAX_PLATFORMS=cpu \\
        python tests/torch_rounds_contended_reference.py OUT.npz

For every case whose repair iterations match KTPU_REPAIR_ITERS it encodes
the snapshot with the JAX DeltaEncoder (unbucketed: N and P are the case's
own), applies the case's patch to the arrays (the same numpy function the
port's side applies), infers the score config from the case's overrides
and runs schedule_scan_rounds with ordinals (-> "<case>/choices", "used",
"ordinals", "sweeps") and, where the JAX gate admits its HoistCache's class
state, schedule_scan_rounds(inc=) (-> "<case>/inc_applied",
"inc_choices", ...).  The count planes the route leaves (cnt, anti, pref
[T, N], total [T]; "<case>/cnt", ...) are the JAX route's absorb
(ops/assign.py:2133-2180) replayed round by round from its own ordinals:
one scatter-add a plane section over the (pod, slot) rows of the pods a
round committed, in pod order, as the route adds them.
"""

import os
import random
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PINNED = {"KTPU_RCHUNK": "16", "KTPU_FORCE_CHUNKED": "1"}
MILLI = 1000
GI = 1024**3


def _node(t, name, cpu=4 * MILLI, mem=16 * GI, pods=110, labels=None):
    return t.Node(name=name, allocatable={t.CPU: cpu, t.MEMORY: mem, t.PODS: pods}, labels=dict(labels or {}))


def _pod(t, name, cpu=100, mem=GI // 4, **kw):
    return t.Pod(name=name, requests={t.CPU: cpu, t.MEMORY: mem}, **kw)


def _zone(t, i, k=3):
    return {t.LABEL_ZONE: f"zone-{i % k}"}


def _neutral(t, **kw):
    """A preferred anti-affinity that matches no pod: the pairwise stages
    are on, but no pod's state writes touch a term another reads, so a
    round can commit many pods."""
    term = t.WeightedPodAffinityTerm(weight=10, term=t.PodAffinityTerm(
        topology_key=t.LABEL_HOSTNAME, label_selector=t.LabelSelector.of(app="nobody")))
    return t.Affinity(preferred_pod_anti_affinity=(term,), **kw)


def _one_argmax(t, Snapshot):
    """One large empty node and 31 half-full ones: all 16 pods of a chunk
    take the large node as their argmax, so the speculation disperses them
    over their top-32 lists by rank."""
    nodes = [_node(t, "big", 64 * MILLI, 256 * GI, 256, _zone(t, 0))]
    nodes += [_node(t, f"n{i:02d}", labels=_zone(t, i + 1)) for i in range(31)]
    bound = [_pod(t, f"b{i:02d}", 2 * MILLI, 8 * GI, node_name=f"n{i:02d}") for i in range(31)]
    pods = [_pod(t, f"p{i:03d}", labels={"app": "one"}, affinity=_neutral(t)) for i in range(64)]
    return Snapshot(nodes=nodes, pending_pods=pods, bound_pods=bound)


def _ties(t, Snapshot):
    """40 equal empty nodes and 64 equal pods whose preferred anti-affinity
    matches no pod: every score ties, so every pick goes to the lower node
    index."""
    nodes = [_node(t, f"n{i:02d}", labels=_zone(t, i)) for i in range(40)]
    pods = [_pod(t, f"p{i:03d}", labels={"app": "tie"}, affinity=_neutral(t)) for i in range(64)]
    return Snapshot(nodes=nodes, pending_pods=pods)


def _odd_n(t, Snapshot):
    """45 nodes of mixed sizes (N not a multiple of 32) and 64 pods of
    mixed sizes, every fourth under a hard zone spread."""
    rng = random.Random(45)
    spread = (t.TopologySpreadConstraint(max_skew=2, topology_key=t.LABEL_ZONE, when_unsatisfiable=t.DO_NOT_SCHEDULE,
                                         label_selector=t.LabelSelector.of(app="odd")),)
    nodes = [_node(t, f"n{i:02d}", rng.choice([2, 4, 8]) * MILLI, labels=_zone(t, i)) for i in range(45)]
    pods = [_pod(t, f"p{i:03d}", rng.choice([100, 300, 700]), labels={"app": "odd" if i % 4 == 0 else "any"},
                 topology_spread=spread if i % 4 == 0 else (), affinity=_neutral(t)) for i in range(64)]
    return Snapshot(nodes=nodes, pending_pods=pods)


def _n_below_zr(t, Snapshot):
    """13 nodes (fewer than the 32 entries of a top list: Zr = N) that fill
    up under 32 pods with a hard zone spread and hostname anti-affinity to
    half of them."""
    spread = (t.TopologySpreadConstraint(max_skew=1, topology_key=t.LABEL_ZONE, when_unsatisfiable=t.DO_NOT_SCHEDULE,
                                         label_selector=t.LabelSelector.of(app="few")),)
    anti = t.PodAffinityTerm(topology_key=t.LABEL_HOSTNAME, label_selector=t.LabelSelector.of(tier="solo"))
    nodes = [_node(t, f"n{i:02d}", 1 * MILLI, labels=_zone(t, i)) for i in range(13)]
    pods = [_pod(t, f"p{i:03d}", 300, labels={"app": "few", **({"tier": "solo"} if i % 2 else {})},
                 topology_spread=spread,
                 affinity=t.Affinity(required_pod_anti_affinity=(anti,)) if i % 2 else None) for i in range(32)]
    return Snapshot(nodes=nodes, pending_pods=pods)


def _extreme(t, Snapshot):
    """Every pod prefers the one ssd node, which holds one pod: the pod after
    the first sees its candidate column unfit under the prefix at the
    normalisation maximum of its node-affinity raw (the repair's hazard), so
    the round stops there."""
    pref = (t.PreferredSchedulingTerm(weight=50, preference=t.NodeSelectorTerm(
        match_expressions=(t.NodeSelectorRequirement(key="disk", operator="In", values=("ssd",)),))),)
    nodes = [_node(t, "ssd", 150, labels={"disk": "ssd", **_zone(t, 0)})]
    nodes += [_node(t, f"n{i:02d}", labels=_zone(t, i)) for i in range(20)]
    pods = [_pod(t, f"p{i:03d}", labels={"app": "ext"}, affinity=_neutral(t, preferred_node_terms=pref))
            for i in range(32)]
    return Snapshot(nodes=nodes, pending_pods=pods)


def _port_collision(t, Snapshot):
    """32 pods on one host port over 10 nodes: two pods of a round that pick
    one node collide on the port (the share hazard), and the 11th pod on
    finds no node."""
    nodes = [_node(t, f"n{i:02d}", labels=_zone(t, i)) for i in range(10)]
    pods = [_pod(t, f"p{i:03d}", labels={"app": "port"}, host_ports=(("TCP", 8080),)) for i in range(32)]
    return Snapshot(nodes=nodes, pending_pods=pods)


def _invalid_pods(t, Snapshot):
    """64 pods, every fifth one gated (invalid), so each chunk holds invalid
    pods between valid ones; every third under a hard zone spread."""
    spread = (t.TopologySpreadConstraint(max_skew=1, topology_key=t.LABEL_ZONE, when_unsatisfiable=t.DO_NOT_SCHEDULE,
                                         label_selector=t.LabelSelector.of(app="gate")),)
    nodes = [_node(t, f"n{i:02d}", labels=_zone(t, i)) for i in range(24)]
    pods = [_pod(t, f"p{i:03d}", labels={"app": "gate" if i % 3 == 0 else "any"},
                 topology_spread=spread if i % 3 == 0 else (), affinity=_neutral(t),
                 scheduling_gates=("wait",) if i % 5 == 2 else ()) for i in range(64)]
    return Snapshot(nodes=nodes, pending_pods=pods)


def _frac_weights(t, Snapshot):
    """Client pods that require and prefer zone affinity to the bound web
    pods: one interned term in both their preferred (pref_w) and required
    (at hardPodAffinityWeight) slots, and the clients match no term, so a
    round commits several of them and adds both kinds to one pref row; the
    patch makes the weights non-integers, so the adds' order shows."""
    term = t.PodAffinityTerm(topology_key=t.LABEL_ZONE, label_selector=t.LabelSelector.of(app="web"))
    nodes = [_node(t, f"n{i:02d}", labels=_zone(t, i)) for i in range(24)]
    bound = [_pod(t, f"w{i}", labels={"app": "web"}, node_name=f"n{i:02d}") for i in range(2)]
    pods = [_pod(t, f"p{i:03d}", labels={"app": "client"}, affinity=t.Affinity(
        required_pod_affinity=(term,),
        preferred_pod_affinity=(t.WeightedPodAffinityTerm(weight=1 + i % 4, term=term),))) for i in range(64)]
    return Snapshot(nodes=nodes, pending_pods=pods, bound_pods=bound)


def _repair_twice(t, Snapshot):
    """A random pairwise cluster scheduled with two repair iterations a round."""
    rng = random.Random(4242)
    spread = (t.TopologySpreadConstraint(max_skew=1, topology_key=t.LABEL_ZONE, when_unsatisfiable=t.DO_NOT_SCHEDULE,
                                         label_selector=t.LabelSelector.of(app="a")),)
    anti = t.PodAffinityTerm(topology_key=t.LABEL_HOSTNAME, label_selector=t.LabelSelector.of(app="b"))
    nodes = [_node(t, f"n{i:02d}", rng.choice([1, 2, 4]) * MILLI, labels=_zone(t, i)) for i in range(30)]
    pods = []
    for i in range(64):
        app = rng.choice(["a", "b", "c"])
        pods.append(_pod(t, f"p{i:03d}", rng.choice([100, 250, 500]), labels={"app": app},
                         topology_spread=spread if app == "a" else (),
                         affinity=t.Affinity(required_pod_anti_affinity=(anti,)) if app == "b" else None))
    return Snapshot(nodes=nodes, pending_pods=pods)


def frac_patch(fields: dict) -> None:
    """Non-integer preferred inter-pod weights, a function of the encoded
    weight (so a pod class keeps one row)."""
    w = fields["pod_pref_aff_w"]
    fields["pod_pref_aff_w"] = np.where(w != 0, w * np.float32(0.37) + np.float32(0.11), w).astype(np.float32)


# case -> (snapshot builder, ScoreConfig overrides, array patch, repair iterations)
CASES = {
    "one-argmax": (_one_argmax, {}, None, 1),
    "ties": (_ties, {}, None, 1),
    "odd-n": (_odd_n, {}, None, 1),
    "n-below-zr": (_n_below_zr, {}, None, 1),
    "extreme": (_extreme, {}, None, 1),
    "port-collision": (_port_collision, {}, None, 1),
    "invalid-pods": (_invalid_pods, {}, None, 1),
    "frac-weights": (_frac_weights, {"hard_pod_affinity_weight": 1.3}, frac_patch, 1),
    "repair-twice": (_repair_twice, {}, None, 2),
}


def snapshot(name: str, package: str = "kubernetes_tpu"):
    """The case's snapshot in the types of `package` (the JAX package's or
    the port's: the two build the same cluster)."""
    import importlib

    t = importlib.import_module(f"{package}.api.types")
    Snapshot = importlib.import_module(f"{package}.api.snapshot").Snapshot
    return CASES[name][0](t, Snapshot)


def patched(name: str, fields: dict) -> dict:
    """The case's patch applied to a dict of numpy arrays (a copy)."""
    out = {k: np.array(v) for k, v in fields.items()}
    patch = CASES[name][2]
    if patch is not None:
        patch(out)
    return out


def port_arrays(name: str, device):
    """The case through the port's encoder (no JAX: the card's machine has
    none), cut back from its bucketed node count to the case's own, with
    the case's patch -> (the port's arrays on `device`, its metadata, the
    score config, the repair iterations)."""
    import dataclasses

    import torch

    from kubernetes_tpu_torch.api.snapshot import ClusterArrays, encode_snapshot
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, infer_score_config
    from kubernetes_tpu_torch.parallel.partition_rules import node_axis_of

    snap = snapshot(name, "kubernetes_tpu_torch")
    arr, meta = encode_snapshot(snap, device="cpu")
    n = len(snap.nodes)
    fields = {}
    for f in dataclasses.fields(arr):
        x = getattr(arr, f.name)
        if not isinstance(x, torch.Tensor):
            continue
        ax = node_axis_of(f.name, tuple(x.shape), arr.N)
        if ax is not None:
            x = x.narrow(ax, 0, n)
        fields[f.name] = (x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 else x.numpy())
    arr = ClusterArrays.from_numpy(patched(name, fields), device)
    _, over, _, iters = CASES[name]
    return arr, meta, infer_score_config(arr, dataclasses.replace(DEFAULT_SCORE_CONFIG, **over)), iters


def count_planes(arr, cfg, choices, ordinals):
    """The count planes (cnt, anti, pref, total) the JAX rounds route leaves:
    its absorb replayed per round, in round order, from its own choices and
    ordinals (a round's pods in pod order)."""
    import jax.numpy as jnp

    D = arr.term_counts0.shape[1] - 1
    dbt = arr.node_dom[arr.term_key]
    cnt = jnp.take_along_axis(arr.term_counts0, dbt, axis=1)
    anti = jnp.take_along_axis(arr.anti_counts0, dbt, axis=1)
    pref = jnp.take_along_axis(arr.pref_own0, dbt, axis=1)
    total = arr.term_counts0[:, :D].sum(axis=1)
    if not cfg.enable_pairwise:
        return cnt, anti, pref, total
    ips = cfg.enable_interpod_score
    choices, ordinals = np.asarray(choices), np.asarray(ordinals)
    placed = choices >= 0
    for r in sorted(set(ordinals[placed].tolist())):
        pods = np.nonzero(placed & (ordinals == r))[0]
        cn = jnp.asarray(choices[pods])

        def scatter(state, ids, w):
            tids = jnp.maximum(ids, 0).reshape(-1)
            nodes = jnp.broadcast_to(cn[:, None], ids.shape).reshape(-1)
            dcol = dbt[tids, nodes]
            same = dbt[tids] == dcol[:, None]
            return state.at[tids].add(w.reshape(-1)[:, None] * same), tids, dcol, w.reshape(-1)

        mt = arr.pod_match_terms[pods]
        cnt, tids, dcol, wf = scatter(cnt, mt, jnp.where(mt >= 0, arr.pod_match_vals[pods], 0.0))
        total = total.at[tids].add(wf * (dcol < D))
        an = arr.pod_anti_terms[pods]
        anti = scatter(anti, an, (an >= 0).astype(jnp.float32))[0]
        if ips:
            pt = arr.pod_pref_aff_terms[pods]
            pref = scatter(pref, pt, jnp.where(pt >= 0, arr.pod_pref_aff_w[pods], 0.0))[0]
            if cfg.hard_pod_affinity_weight:
                af = arr.pod_aff_terms[pods]
                pref = scatter(pref, af, jnp.where(af >= 0, jnp.float32(cfg.hard_pod_affinity_weight), 0.0))[0]
    return cnt, anti, pref, total


def main() -> None:
    out = sys.argv[1]
    for k, v in PINNED.items():
        if os.environ.get(k) != v:
            raise SystemExit(f"run with {k}={v}")
    iters = int(os.environ.get("KTPU_REPAIR_ITERS", "0"))
    if iters < 1:
        raise SystemExit("run with KTPU_REPAIR_ITERS set")
    sys.path.insert(0, os.path.dirname(HERE))
    from __graft_entry__ import force_cpu_platform

    force_cpu_platform(1)
    import dataclasses

    import jax
    import jax.numpy as jnp

    from kubernetes_tpu.api.delta import DeltaEncoder
    from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG, infer_score_config
    from kubernetes_tpu.ops.assign import inc_applicable, schedule_scan_rounds
    from kubernetes_tpu.ops.incremental import HoistCache

    rounds = jax.jit(schedule_scan_rounds, static_argnames=("cfg", "with_ordinals"))
    res = {}
    for name, (_, over, _, want_iters) in CASES.items():
        if want_iters != iters:
            continue
        arr, meta = DeltaEncoder(bucket=False).encode(snapshot(name))
        fields = patched(name, {f.name: np.asarray(getattr(arr, f.name)) for f in dataclasses.fields(arr)})
        arr = dataclasses.replace(arr, **{k: jnp.asarray(v) for k, v in fields.items()})
        cfg = infer_score_config(arr, dataclasses.replace(DEFAULT_SCORE_CONFIG, **over))
        c, u, o, s = rounds(arr, cfg, with_ordinals=True)
        planes = count_planes(arr, cfg, c, o)
        for field, x in zip(("choices", "used", "ordinals", "sweeps", "cnt", "anti", "pref", "total"),
                            (c, u, o, s) + tuple(planes)):
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
