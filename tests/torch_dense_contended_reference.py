"""Snapshots that stress the dense chunked route's round loop, and the JAX
package's decisions on them, for tests/test_torch_dense_contended.py.

The JAX package reads KTPU_FORCE_CHUNKED at trace time, so its side runs
in a fresh process:

    KTPU_FORCE_CHUNKED=1 JAX_PLATFORMS=cpu python tests/torch_dense_contended_reference.py OUT.npz

For every case it encodes the snapshot with the JAX DeltaEncoder (unbucketed
where the case says so: N and P are then the snapshot's own; every case
has a multiple of 128 pods), infers the
score config from the case's overrides, runs schedule_batch_ordinals_routed
with no class state (the dense chunked route, 128-pod chunks) and saves
choices, used, ordinals and sweeps under "<case>/<field>".
"""

import os
import random
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
MILLI = 1000
GI = 1024**3


def _node(t, name, cpu, mem, pods=110):
    return t.Node(name=name, allocatable={t.CPU: cpu, t.MEMORY: mem, t.PODS: pods})


def _pod(t, name, cpu, mem, **kw):
    return t.Pod(name=name, requests={t.CPU: cpu, t.MEMORY: mem}, **kw)


def _one_best_node(t, Snapshot, workloads):
    """128 equal pods, one large empty node and 63 half-full ones: every
    pod of the chunk ranks node 0 first, and it holds them all."""
    nodes = [_node(t, "big", 256 * MILLI, 1024 * GI, pods=256)]
    nodes += [_node(t, f"n{i}", 4 * MILLI, 8 * GI) for i in range(63)]
    bound = [_pod(t, f"b{i}", 2 * MILLI, 4 * GI, node_name=f"n{i}") for i in range(63)]
    pods = [_pod(t, f"p{i:03d}", 500, GI) for i in range(128)]
    return Snapshot(nodes=nodes, pending_pods=pods, bound_pods=bound)


def _ties(t, Snapshot, workloads):
    """50 equal empty nodes and 256 equal pods: every score ties, so each
    choice is decided by the lower node index."""
    nodes = [_node(t, f"n{i:02d}", 16 * MILLI, 64 * GI) for i in range(50)]
    pods = [_pod(t, f"p{i:03d}", 250, GI // 2) for i in range(256)]
    return Snapshot(nodes=nodes, pending_pods=pods)


def _odd_n(t, Snapshot, workloads):
    """45 heterogeneous nodes (N not a multiple of 32) and 256 pods."""
    return workloads.heterogeneous(45, 256, seed=3)


def _p_eq_c(t, Snapshot, workloads):
    """Exactly one chunk: 128 pods of random sizes on 37 random nodes."""
    rng = random.Random(11)
    nodes = [_node(t, f"n{i:02d}", rng.choice([2, 4, 8]) * MILLI, rng.choice([4, 8, 16]) * GI) for i in range(37)]
    pods = [_pod(t, f"p{i:03d}", rng.choice([100, 200, 500, 1000]), rng.choice([1, 2, 4]) * GI // 4,
                 priority=rng.choice([0, 10])) for i in range(128)]
    return Snapshot(nodes=nodes, pending_pods=pods)


def _invalid_chunk(t, Snapshot, workloads):
    """Three chunks, the middle one all gated (invalid) pods."""
    rng = random.Random(7)
    nodes = [_node(t, f"n{i:02d}", rng.choice([8, 16, 32]) * MILLI, rng.choice([16, 64]) * GI) for i in range(40)]
    pods = [_pod(t, f"p{i:03d}", rng.choice([100, 250, 500]), rng.choice([1, 2]) * GI // 4,
                 scheduling_gates=("wait",) if 128 <= i < 256 else ()) for i in range(384)]
    return Snapshot(nodes=nodes, pending_pods=pods)


def _round_cap(t, Snapshot, workloads):
    """MostAllocated bin packing, 128 equal pods, 80 equal nodes that hold
    two pods each: a pod's pick beside an earlier pod's always changes the
    next pod's ranking, so every round commits one pod and the chunk takes
    C = 128 rounds, the cap (nrounds > C is the overflow)."""
    nodes = [_node(t, f"n{i:02d}", 2 * MILLI, 64 * GI) for i in range(80)]
    pods = [_pod(t, f"p{i:03d}", MILLI, GI) for i in range(128)]
    return Snapshot(nodes=nodes, pending_pods=pods)


# case -> (snapshot, DeltaEncoder keyword arguments, ScoreConfig overrides)
CASES = {
    "one-best-node": (_one_best_node, {"bucket": False}, {}),
    "ties": (_ties, {"bucket": False}, {}),
    "odd-n": (_odd_n, {"bucket": False}, {}),
    "p-eq-c": (_p_eq_c, {"bucket": False}, {}),
    "invalid-chunk": (_invalid_chunk, {"bucket": False}, {}),
    "round-cap": (_round_cap, {"bucket": False}, {"fit_strategy": "MostAllocated"}),
}


def snapshot(name: str, package: str = "kubernetes_tpu"):
    """The case's snapshot in the types of `package` (the JAX package's or
    the port's: the two build the same cluster)."""
    import importlib

    t = importlib.import_module(f"{package}.api.types")
    Snapshot = importlib.import_module(f"{package}.api.snapshot").Snapshot
    workloads = importlib.import_module(f"{package}.bench.workloads")
    return CASES[name][0](t, Snapshot, workloads)


def main() -> None:
    out = sys.argv[1]
    if os.environ.get("KTPU_FORCE_CHUNKED") != "1":
        raise SystemExit("run with KTPU_FORCE_CHUNKED=1")
    sys.path.insert(0, os.path.dirname(HERE))
    from __graft_entry__ import force_cpu_platform

    force_cpu_platform(1)
    import dataclasses

    from kubernetes_tpu.api.delta import DeltaEncoder
    from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG, infer_score_config
    from kubernetes_tpu.ops.assign import schedule_batch_ordinals_routed

    res = {}
    for name, (_, enc_kw, over) in CASES.items():
        arr, _ = DeltaEncoder(**enc_kw).encode(snapshot(name))
        cfg = infer_score_config(arr, dataclasses.replace(DEFAULT_SCORE_CONFIG, **over))
        c, u, o, s = schedule_batch_ordinals_routed(arr, cfg, donate=False, inc=None)
        for field, x in (("choices", c), ("used", u), ("ordinals", o), ("sweeps", s)):
            res[f"{name}/{field}"] = np.asarray(x)
    np.savez(out, **res)


if __name__ == "__main__":
    main()
