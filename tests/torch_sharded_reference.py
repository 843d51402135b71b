"""The JAX package's sharded per-pod and rounds scans, and the collectives
they are built from, for tests/test_torch_mesh_steps.py.

The JAX package's sharded entry points pass ``check_rep=`` to shard_map,
which this JAX release does not take; so this script builds the shard_map
itself, around the JAX package's own programs, with ``check_vma=False``:

    jax.shard_map(body, mesh=make_mesh(S), in_specs=(clusterarrays_specs(img),
                  [incstate_specs(...)]), out_specs=..., check_vma=False)

with ``body`` = ``schedule_scan(a, cfg, axis_name="nodes", image_sharded=img)``
or ``schedule_scan_rounds(a, cfg, with_ordinals=True, axis_name="nodes",
axis_size=S, image_sharded=img[, inc=inc])``.  The arrays are padded by the
JAX package's pad_nodes first and the class state comes from its
HoistCache(mesh=).  It runs in a fresh process with 8 virtual CPU devices
and the knobs pinned:

    KTPU_RCHUNK=16 KTPU_REPAIR_ITERS=1 KTPU_FORCE_CHUNKED=1 JAX_PLATFORMS=cpu \\
        python tests/torch_sharded_reference.py OUT.npz

For every snapshot (SNAPSHOTS, encoded with DeltaEncoder(bucket=False), so
N stays as given: 24 divides into 2, 3 and 8 shards, 25 = 4 * 6 + 1 into
none) the single-device scan, rounds scan and rounds scan on class state
("<snap>/single/<kind>/<field>"), and for each (S, snapshot) of MESH the
sharded ones ("<snap>/s<S>/<kind>/<field>"): kind scan -> choices, used;
rounds and inc -> choices, used, ordinals, sweeps (used on the padded
axis).  ``pinned`` pins pods to a node in every shard.

The gang host fixpoint on one device (GANGS: "gang/<name>/<field>",
choices, used, ordinals, sweeps), for the port's schedule_with_gangs(mesh=).

The collectives (HELPERS): for S in {2, 4, 8} and nl in {5, 40} (under and
over the speculation's 32), on seeded inputs with ties across shard
boundaries and +-inf, the JAX package's _rmax, _rmin, _gather_cols (f32 and
bool), _gather_at_nodes and _global_top_k, and spread_step with a shard
where no node is eligible, each under the same shard_map
("helpers/s<S>-nl<nl>/<name>", inputs included).

THE PODS x NODES GRID (``--grid OUT.npz``, for tests/test_torch_mesh_2d.py):
for every snapshot of GRID_SNAPSHOTS (``grid_snapshot``; DeltaEncoder(
bucket=False)) the JAX single-device routed step, dense and with
HoistCache.ensure's class state ("<snap>/single/<mode>/<field>"), and for
every grid (p, n) of GRIDS the JAX 2-D program:

    jax.shard_map(body, mesh=make_mesh(shape=(p, n)), in_specs=(
                  clusterarrays_specs(img, pod_sharded=True)[, incstate_specs(
                  ..., pod_sharded=True)]), out_specs=..., check_vma=False)

with ``body`` = ``pod_unshard(a[, inc], axis_name="pods")`` followed by the
route the JAX package's sharded_schedule_batch_routed picks on the padded
arrays (pad_nodes, then pad_pods; schedule_scan_chunked,
schedule_scan_rounds or schedule_scan), its per-pod outputs sliced back to
the caller's P ("<snap>/g<p>x<n>/<mode>/<field>", and ".../route"), the
class state from the JAX HoistCache(mesh=grid).
"""

import dataclasses
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PINNED = {"KTPU_RCHUNK": "16", "KTPU_REPAIR_ITERS": "1", "KTPU_FORCE_CHUNKED": "1"}
# name -> (generator, nodes, pods)
SNAPSHOTS = {"sa-24": ("spread_affinity", 24, 64), "sa-25": ("spread_affinity", 25, 64),
             "basic-24": ("basic", 24, 48), "basic-25": ("basic", 25, 48)}
# the snapshots with class state (basic's pods are all distinct: U1 >= P)
WITH_INC = ("sa-24", "sa-25")
# (shards, snapshot node count) the JAX sharded programs run on
MESH = ((2, 24), (3, 25), (8, 25), (8, 24))
# pinned nodes: one in every shard of 2, 3 and 8 shards holding a real node
# (of either size), and node-24, which exists only in the 25-node clusters
PIN_NODES = (1, 4, 7, 10, 13, 16, 19, 22, 24)
# the gang host fixpoint (single device): gang(16, 8, 1, seed=1) on the
# chunked route, and two of the port's gang_pinned batches (BASELINE config
# 3's 5000 nodes, N=6144) on the rounds route
GANGS = ("gang-16x8", "rounds-fit", "rounds-pairwise")
HELPER_S = (2, 4, 8)
HELPER_NL = (5, 40)
# the pods x nodes grids, and their snapshots: name -> (what, nodes, pods).
# het: fit-only, the chunked routes (P 256 on 3 rows pads to 258: the
# per-pod scan); rnd: test_sharded_routed.py's rounds snapshot (every stage,
# 48 pods: the rounds route on 3 rows too); sa: spread_affinity with pins,
# the rounds route dense and on class state (64 pods on 3 rows: 66, the
# per-pod scan); pad: test_mesh_2d.py's pod-padding snapshot (51 pods on 2
# rows: 52)
GRIDS = ((2, 4), (2, 2), (3, 2))
GRID_SNAPSHOTS = {"het": ("heterogeneous", 48, 256), "rnd": ("rounds_snap", 27, 48),
                  "sa": ("spread_affinity", 25, 64), "pad": ("random_cluster", 24, 51)}
GRID_WITH_INC = ("het", "sa")


def pinned(workloads, gen: str, n_nodes: int, n_pods: int):
    """workloads.<gen>(n_nodes, n_pods, seed=3) with pod 1 + 5 k pinned to
    PIN_NODES[k] (spec.nodeName)."""
    snap = getattr(workloads, gen)(n_nodes, n_pods, seed=3)
    pods = list(snap.pending_pods)
    for k, node in enumerate(PIN_NODES):
        i = 1 + 5 * k
        pods[i] = dataclasses.replace(pods[i], node_name=f"node-{node}")
    return dataclasses.replace(snap, pending_pods=pods)


def helper_inputs(s: int, nl: int) -> dict:
    """Seeded inputs of the collectives: small integers (ties everywhere,
    across shard boundaries too) with +-inf, global column ids, a term x node
    count plane, and an eligibility row with no eligible node in shard 1."""
    rng = np.random.default_rng(100 * s + nl)
    n = s * nl
    x = rng.integers(0, 4, (3, n)).astype(np.float32)
    x[rng.random((3, n)) < 0.1] = np.inf
    x[rng.random((3, n)) < 0.2] = -np.inf
    elig = rng.random(n) < 0.6
    elig[nl:2 * nl] = False
    return {
        "x": x, "b": rng.random((3, n)) < 0.5,
        "cols": rng.integers(0, n, 7).astype(np.int32),
        "dom": rng.integers(0, 6, (4, n)).astype(np.int32),
        "rows": rng.integers(0, 4, 7).astype(np.int32),
        "cnt": rng.integers(0, 5, (4, n)).astype(np.float32),
        "has_key": rng.random((4, n)) < 0.8,
        "terms": np.array([0, 2, -1, 3], dtype=np.int32),
        "skew": np.array([1, 2, 1, 1], dtype=np.int32),
        "hard": np.array([True, True, False, True]),
        "elig": elig,
    }


def _helpers(res) -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from kubernetes_tpu.ops import assign as A
    from kubernetes_tpu.ops import pairwise
    from kubernetes_tpu.parallel.mesh import make_mesh

    ax = "nodes"
    for s in HELPER_S:
        mesh = make_mesh(s)
        for nl in HELPER_NL:
            inp = helper_inputs(s, nl)
            k = min(32, s * nl)

            def body(x, b, cnt, has_key, elig, dom, cols=inp["cols"], rows=inp["rows"], nl=nl, k=k):
                base = jax.lax.axis_index(ax).astype(jnp.int32) * nl
                c = jnp.asarray(cols)
                tv, ti = A._global_top_k(x, k, ax, base)
                ok, raw = pairwise.spread_step(cnt, has_key, jnp.asarray(inp["terms"]), jnp.asarray(inp["skew"]),
                                               jnp.asarray(inp["hard"]), elig, ax)
                return (A._rmax(x, ax), A._rmin(x, ax), A._gather_cols(x, c, ax, base, nl),
                        A._gather_cols(b, c, ax, base, nl),
                        A._gather_at_nodes(dom, jnp.asarray(rows), c, ax, base, nl), tv, ti, ok, raw)

            node = P(None, ax)
            fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(node, node, node, node, P(ax), node),
                                       out_specs=(P(), P(), P(), P(), P(), P(), P(), P(ax), P(ax)),
                                       check_vma=False))
            out = fn(inp["x"], inp["b"], inp["cnt"], inp["has_key"], inp["elig"], inp["dom"])
            key = f"helpers/s{s}-nl{nl}"
            for name, v in zip(("rmax", "rmin", "gcols", "gcols_bool", "gat", "topv", "topi", "spread_ok",
                                "spread_raw"), out):
                res[f"{key}/{name}"] = np.asarray(v)


def gang_snapshot(name: str):
    """GANGS[name] in the JAX package's types."""
    if name == "gang-16x8":
        from kubernetes_tpu.bench.workloads import gang

        return gang(16, 8, 1, seed=1)
    sys.path.insert(0, HERE)
    from torch_gang_reference import pinned as gang_pinned

    return gang_pinned(name)


def _gangs(res) -> None:
    from kubernetes_tpu.api.snapshot import encode_snapshot
    from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG, infer_score_config
    from kubernetes_tpu.ops.gang import schedule_with_gangs

    for name in GANGS:
        arr, _ = encode_snapshot(gang_snapshot(name))
        out = schedule_with_gangs(arr, infer_score_config(arr, DEFAULT_SCORE_CONFIG), with_ordinals=True)
        for field, x in zip(("choices", "used", "ordinals", "sweeps"), out):
            res[f"gang/{name}/{field}"] = np.asarray(x)


def grid_snapshot(name: str):
    """GRID_SNAPSHOTS[name] in the JAX package's types."""
    import random

    from kubernetes_tpu.bench import workloads

    sys.path.insert(0, HERE)
    from helpers import random_cluster

    what, n, p = GRID_SNAPSHOTS[name]
    if what == "heterogeneous":
        return workloads.heterogeneous(n, p, seed=3)
    if what == "spread_affinity":
        return pinned(workloads, what, n, p)
    if what == "rounds_snap":
        return random_cluster(random.Random(9), n_nodes=n, n_pods=p, with_taints=True, with_selectors=True,
                              with_pairwise=True)
    return random_cluster(random.Random(77), n_nodes=n, n_pods=p)


def _grid(res) -> None:
    import jax
    import jax.numpy as jnp

    from kubernetes_tpu.api.delta import DeltaEncoder
    from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG, infer_score_config
    from kubernetes_tpu.ops import assign as A
    from kubernetes_tpu.ops.assign import schedule_batch_ordinals_routed
    from kubernetes_tpu.ops.incremental import HoistCache
    from kubernetes_tpu.parallel.mesh import make_mesh, pad_nodes, pad_pods
    from kubernetes_tpu.parallel.partition_rules import clusterarrays_specs, incstate_specs
    from kubernetes_tpu.parallel.sharded import _out_spec

    fields = ("choices", "used", "ordinals", "sweeps")
    for name in GRID_SNAPSHOTS:
        arr, meta = DeltaEncoder(bucket=False).encode(grid_snapshot(name))
        cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
        modes = ("dense", "inc") if name in GRID_WITH_INC else ("dense",)
        for mode in modes:
            inc = HoistCache().ensure(arr, meta, cfg) if mode == "inc" else None
            assert mode == "dense" or A.inc_applicable(arr, cfg, inc) is not None, name
            for field, x in zip(fields, schedule_batch_ordinals_routed(arr, cfg, donate=False, inc=inc)):
                res[f"{name}/single/{mode}/{field}"] = np.asarray(x)
        for p, n in GRIDS:
            mesh = make_mesh(shape=(p, n))
            padded, _ = pad_nodes(arr, n)
            padded, p0 = pad_pods(padded, p)
            img = padded.image_score.shape[1] == padded.N
            kind = "chunked" if A._chunk_routed(padded, cfg) else "rounds" if A._rounds_routed(padded, cfg) else "scan"
            for mode in modes:
                inc = HoistCache(mesh=mesh).ensure(arr, meta, cfg) if mode == "inc" else None
                inc = A.inc_applicable(padded, cfg, inc) if kind != "scan" else None
                key = f"{name}/g{p}x{n}/{mode}"
                if mode == "inc" and inc is None:  # the class state does not apply: the dense program
                    for field in fields:
                        res[f"{key}/{field}"] = res[f"{name}/g{p}x{n}/dense/{field}"]
                    res[f"{key}/route"] = np.asarray(kind)
                    continue

                def body(a, i=None, kind=kind, img=img, n=n):
                    a, i = A.pod_unshard(a, i, axis_name="pods")
                    if kind == "scan":
                        c, u = A.schedule_scan(a, cfg=cfg, axis_name="nodes", image_sharded=img)
                        return c, u, jnp.arange(a.P, dtype=jnp.int32), jnp.int32(a.P)
                    kern = A.schedule_scan_chunked if kind == "chunked" else A.schedule_scan_rounds
                    extra = {} if i is None else {"inc": i}
                    return kern(a, cfg=cfg, with_ordinals=True, axis_name="nodes", axis_size=n, image_sharded=img,
                                **extra)

                in_specs = (clusterarrays_specs(img, pod_sharded=True),)
                args = (padded,)
                if inc is not None:
                    sig = (inc.elig_u is not None, inc.traw_u is not None, inc.naraw_u is not None,
                           inc.img_u is not None)
                    in_specs += (incstate_specs(*sig, pod_sharded=True),)
                    args += (inc,)
                used = _out_spec("out.node_used_scan" if kind == "scan" else "out.node_used", mesh)
                out_specs = (_out_spec("out.assignment", mesh), used, _out_spec("out.ordinals", mesh),
                             _out_spec("out.n_commits", mesh))
                fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                                           check_vma=False))
                c, u, o, sw = fn(*args)
                for field, x in zip(fields, (np.asarray(c)[:p0], u, np.asarray(o)[:p0], sw)):
                    res[f"{key}/{field}"] = np.asarray(x)
                res[f"{key}/route"] = np.asarray(kind)


def main() -> None:
    grid = sys.argv[1] == "--grid"
    out = sys.argv[-1]
    for k, v in PINNED.items():
        if os.environ.get(k) != v:
            raise SystemExit(f"run with {k}={v}")
    sys.path.insert(0, os.path.dirname(HERE))
    from __graft_entry__ import force_cpu_platform

    force_cpu_platform(8)
    import jax

    if grid:
        res = {}
        _grid(res)
        np.savez(out, **res)
        return

    from kubernetes_tpu.api.delta import DeltaEncoder
    from kubernetes_tpu.bench import workloads
    from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG, infer_score_config
    from kubernetes_tpu.ops import assign as A
    from kubernetes_tpu.ops.incremental import HoistCache
    from kubernetes_tpu.parallel.mesh import make_mesh, pad_nodes
    from kubernetes_tpu.parallel.partition_rules import clusterarrays_specs, incstate_specs
    from kubernetes_tpu.parallel.sharded import _out_spec

    scan = jax.jit(A.schedule_scan, static_argnames=("cfg",))
    rounds = jax.jit(A.schedule_scan_rounds, static_argnames=("cfg", "with_ordinals"))
    res = {}
    _helpers(res)
    enc = {}
    for name, (gen, n, p) in SNAPSHOTS.items():
        arr, meta = DeltaEncoder(bucket=False).encode(pinned(workloads, gen, n, p))
        assert arr.N == n and arr.P == p, (arr.N, arr.P)
        cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
        enc[name] = (arr, meta, cfg)
        runs = {"scan": scan(arr, cfg), "rounds": rounds(arr, cfg, with_ordinals=True)}
        if name in WITH_INC:
            inc = A.inc_applicable(arr, cfg, HoistCache().ensure(arr, meta, cfg))
            runs["inc"] = rounds(arr, cfg, with_ordinals=True, inc=inc)
        for kind, vals in runs.items():
            for field, x in zip(("choices", "used", "ordinals", "sweeps"), vals):
                res[f"{name}/single/{kind}/{field}"] = np.asarray(x)
    for s, n in MESH:
        mesh = make_mesh(s)
        for name in (k for k, v in SNAPSHOTS.items() if v[1] == n):
            arr, meta, cfg = enc[name]
            padded, _ = pad_nodes(arr, s)
            img = padded.image_score.shape[1] == padded.N
            specs = clusterarrays_specs(img)
            inc = HoistCache(mesh=mesh).ensure(arr, meta, cfg) if name in WITH_INC else None
            sig = inc is not None and (inc.elig_u is not None, inc.traw_u is not None, inc.naraw_u is not None,
                                       inc.img_u is not None)
            ords = (_out_spec("out.ordinals", mesh), _out_spec("out.n_commits", mesh))
            used_scan, used_rep = _out_spec("out.node_used_scan", mesh), _out_spec("out.node_used", mesh)
            assign_spec = _out_spec("out.assignment", mesh)
            progs = {
                "scan": (lambda a: A.schedule_scan(a, cfg=cfg, axis_name="nodes", image_sharded=img),
                         (specs,), (assign_spec, used_scan), (padded,)),
                "rounds": (lambda a: A.schedule_scan_rounds(a, cfg=cfg, with_ordinals=True, axis_name="nodes",
                                                            axis_size=s, image_sharded=img),
                           (specs,), (assign_spec, used_rep) + ords, (padded,)),
            }
            if inc is not None:
                progs["inc"] = (lambda a, i: A.schedule_scan_rounds(a, cfg=cfg, with_ordinals=True, axis_name="nodes",
                                                                   axis_size=s, image_sharded=img, inc=i),
                                (specs, incstate_specs(*sig)), (assign_spec, used_rep) + ords, (padded, inc))
            for kind, (body, in_specs, out_specs, args) in progs.items():
                want = {"scan": "sharded_plain", "rounds": "sharded_rounds", "inc": "sharded_rounds_inc"}[kind]
                before = A.TRACE_COUNTS[want]
                fn = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                                           check_vma=False))
                vals = fn(*args)
                assert A.TRACE_COUNTS[want] == before + 1, (kind, dict(A.TRACE_COUNTS))
                for field, x in zip(("choices", "used", "ordinals", "sweeps"), vals):
                    res[f"{name}/s{s}/{kind}/{field}"] = np.asarray(x)
    _gangs(res)
    np.savez(out, **res)


if __name__ == "__main__":
    main()
