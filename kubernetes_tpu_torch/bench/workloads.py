"""Seeded synthetic snapshots.

``basic`` and ``heterogeneous`` are copies of the JAX package's
``bench/workloads.py`` generators: both draw from ``random.Random(seed)`` in
the same order, so one seed builds the same snapshot in both packages.
``heterogeneous(20000, 50000, seed=0)`` is the north-star shape (P=51200,
N=20480, R=5 after bucketing).  ``mixed`` is a small snapshot that drives
every filter of the fit-only slice: nodeSelector, required node affinity
with every operator, nodeName pins (one to a missing node), an unschedulable
node, NoSchedule and NoExecute taints with and without tolerations, a
scheduling gate, bound pods and two priorities.
"""

from __future__ import annotations

import dataclasses
import hashlib
import random
from typing import Callable, Dict, List, Optional

import numpy as np

from ..api import types as t
from ..api.snapshot import Snapshot

MILLI = 1000
GI = 1024**3

# The north-star shape and the JAX package's decisions there: the count of
# scheduled pods and the sha256 of its choices[:n_pods] as little-endian
# int32, from `JAX_PLATFORMS=cpu python tests/torch_north_star_digest.py`
# (its per-pod leg: the JAX package's schedule_batch on the CPU).
NORTH_STAR = dict(n_nodes=20000, n_pods=50000, seed=0)
NORTH_STAR_SCHEDULED = 50000
NORTH_STAR_CHOICES_SHA256 = "06714885065d2bdf07c90eee8d4d5bd3e05569be5e34beb5e7a51edabddc9e53"
# The JAX package's class-wave route there (KTPU_FORCE_CHUNKED=1,
# DeltaEncoder -> HoistCache.ensure -> schedule_batch_ordinals_routed), from
# the same script's two class-wave legs: the total sweep count (wave blocks
# + stage-B rounds) and the sha256 of ordinals[:n_pods] as little-endian
# int32, with the waves on and with KTPU_CLASS_WAVES=0.  Both legs' choices
# hash to NORTH_STAR_CHOICES_SHA256.  1319 is also the rounds_executed that
# BENCH_r07-r09 recorded.
NORTH_STAR_CLASSES = 101  # U1: 100 pod specs + the padding class
NORTH_STAR_WAVE_SWEEPS = 1319
NORTH_STAR_WAVE_ORDINALS_SHA256 = "2c13b3c4e3fc9962b190a602252c8ec6d746e065c05623b18f8d1d251eeef879"
NORTH_STAR_NOWAVE_SWEEPS = 2635
NORTH_STAR_NOWAVE_ORDINALS_SHA256 = "7f1f1312ba63845b250797dfa3be3b14cd27e2401d1dfead3f03c79641bc3ad4"
# The JAX package's dense chunked route there (KTPU_FORCE_CHUNKED=1,
# DeltaEncoder -> schedule_batch_ordinals_routed with no class state: 400
# chunks of 128 pods), from the same script's dense leg: the sweep count
# and the sha256 of ordinals[:n_pods].  Its choices hash to
# NORTH_STAR_CHOICES_SHA256.
NORTH_STAR_DENSE_SWEEPS = 2027
NORTH_STAR_DENSE_ORDINALS_SHA256 = "b4e8f69508fe1971fa4411978c8a61778c2b9a4a01e4d49cd55cf97001dd6e10"
# bench.py's warm loop there (waves 2..7, warm_waves below) through the JAX
# package's PipelinedBatchLoop at depth 0 (run_serial's order) under
# KTPU_FORCE_CHUNKED=1, from the same script's warm leg: wave -> its
# wave_digest (every wave schedules 50000/50000), and the loop's HoistCache
# action per wave (the loop's own cache starts cold at wave 2; waves 4 and 6
# bind a wave that moved most nodes' usage, so they re-hoist in full).  The
# JAX encoder ran 1 full and 6 delta cycles.
NORTH_STAR_WARM_DIGESTS: Dict[int, str] = {
    2: "3cecc627ae03162d6ed3175e0a2840d7b79adc4ab20e548b878d36d2ba9fba4e",
    3: "3cecc627ae03162d6ed3175e0a2840d7b79adc4ab20e548b878d36d2ba9fba4e",
    4: "f985bd155eed995f8160379beff4d3314af146fecaaee560234522fbb441515d",
    5: "f985bd155eed995f8160379beff4d3314af146fecaaee560234522fbb441515d",
    6: "fdd8faa02edf432e2c106b92c8ab2ac83984a3ec46568dd77899c579ac6be357",
    7: "fdd8faa02edf432e2c106b92c8ab2ac83984a3ec46568dd77899c579ac6be357",
}
NORTH_STAR_WARM_ACTIONS: List[str] = ["static_rebuild", "hit", "full", "hit", "full", "hit"]
# wide_taints at this size, through the JAX package's encoder and per-pod
# scan (the same script's wide leg): the scheduled count and the sha256 of
# choices[:n_pods].
WIDE_TAINTS = dict(n_nodes=2000, n_pods=5000)
WIDE_TAINTS_SCHEDULED = 5000
WIDE_TAINTS_CHOICES_SHA256 = "f1508798386437d40839a4b4d338967d5876d9d21f1d1f339f09a0df25c89ca5"


def basic(n_nodes: int, n_pods: int, seed: int = 0) -> Snapshot:
    """Homogeneous nodes, cpu+mem-requesting pods."""
    rng = random.Random(seed)
    nodes = [
        t.Node(
            name=f"node-{i}",
            allocatable={t.CPU: 32 * MILLI, t.MEMORY: 128 * GI, t.PODS: 110},
            labels={t.LABEL_ZONE: f"zone-{i % 3}"},
        )
        for i in range(n_nodes)
    ]
    pods = [
        t.Pod(
            name=f"pod-{i}",
            requests={
                t.CPU: rng.choice([100, 250, 500, 1000]),
                t.MEMORY: rng.choice([128, 256, 512, 1024]) * 1024**2,
            },
        )
        for i in range(n_pods)
    ]
    return Snapshot(nodes=nodes, pending_pods=pods)


def heterogeneous(n_nodes: int, n_pods: int, seed: int = 0) -> Snapshot:
    """Heterogeneous capacities + an extended resource + taints/tolerations."""
    rng = random.Random(seed)
    nodes = []
    for i in range(n_nodes):
        alloc = {
            t.CPU: rng.choice([8, 16, 32, 64]) * MILLI,
            t.MEMORY: rng.choice([32, 64, 128, 256]) * GI,
            t.PODS: rng.choice([64, 110, 256]),
        }
        taints = ()
        if i % 5 == 0:
            alloc["example.com/accel"] = rng.choice([4, 8])
            taints = (t.Taint(key="accel", value="true", effect=t.NO_SCHEDULE),)
        nodes.append(
            t.Node(
                name=f"node-{i}",
                allocatable=alloc,
                labels={t.LABEL_ZONE: f"zone-{i % 9}", "pool": f"pool-{i % 17}"},
                taints=taints,
            )
        )
    pods = []
    for i in range(n_pods):
        req = {
            t.CPU: rng.choice([100, 250, 500, 1000, 2000]),
            t.MEMORY: rng.choice([128, 256, 512, 2048, 4096]) * 1024**2,
        }
        tols = ()
        sel = ()
        if i % 10 == 0:
            req["example.com/accel"] = 1
            tols = (t.Toleration(key="accel", operator=t.OP_EXISTS),)
        pods.append(
            t.Pod(
                name=f"pod-{i}",
                requests=req,
                tolerations=tols,
                node_selector=sel,
                priority=rng.choice([0, 0, 0, 100]),
            )
        )
    return Snapshot(nodes=nodes, pending_pods=pods)


def mixed(n_nodes: int = 40, n_pods: int = 160, seed: int = 0) -> Snapshot:
    """Every filter of the fit-only slice on a small, crowded cluster."""
    rng = random.Random(seed)
    nodes = []
    for i in range(n_nodes):
        labels = {
            t.LABEL_ZONE: f"zone-{i % 3}",
            "disktype": rng.choice(["ssd", "hdd"]),
            "gen": str(i % 6),
        }
        if i % 4 == 0:
            labels["gpu"] = rng.choice(["a100", "h100"])
        taints = ()
        if i % 7 == 1:
            taints = (t.Taint(key="dedicated", value=rng.choice(["infra", "batch"])),)
        elif i % 11 == 2:
            taints = (t.Taint(key="maint", value="true", effect=t.NO_EXECUTE),)
        alloc = {
            t.CPU: rng.choice([1, 2, 4]) * MILLI,
            t.MEMORY: rng.choice([2, 4, 8]) * GI,
            t.PODS: rng.choice([4, 8, 16]),
        }
        if i % 5 == 0:
            alloc["example.com/accel"] = 2
        nodes.append(t.Node(
            name=f"node-{i}", allocatable=alloc, labels=labels, taints=taints,
            unschedulable=(i == 3),
        ))

    def req(op, key, *values):
        return t.NodeSelectorRequirement(key=key, operator=op, values=tuple(values))

    affinities = [
        (t.NodeSelectorTerm((req(t.OP_IN, "disktype", "ssd"), req(t.OP_NOT_IN, "gen", "0", "1"))),),
        (t.NodeSelectorTerm((req(t.OP_EXISTS, "gpu"),)),
         t.NodeSelectorTerm((req(t.OP_GT, "gen", "3"),))),
        (t.NodeSelectorTerm((req(t.OP_DOES_NOT_EXIST, "gpu"), req(t.OP_LT, "gen", "2"))),),
        (t.NodeSelectorTerm((req(t.OP_IN, "gpu", "tpu"),)),),  # no node matches
        (t.NodeSelectorTerm(()),),  # an empty term matches nothing
    ]
    tolerations = [
        (t.Toleration(key="dedicated", operator=t.OP_EXISTS),),
        (t.Toleration(key="dedicated", value="infra"),),
        (t.Toleration(key="maint", operator=t.OP_EXISTS, effect=t.NO_EXECUTE),),
        (t.Toleration(operator=t.OP_EXISTS),),  # tolerates everything
    ]
    pods = []
    for i in range(n_pods):
        kind = rng.random()
        sel = ()
        aff = None
        pin = ""
        if kind < 0.2:
            sel = (("disktype", rng.choice(["ssd", "hdd"])),)
        elif kind < 0.45:
            aff = t.Affinity(required_node_terms=rng.choice(affinities))
        elif kind < 0.5:
            pin = rng.choice([f"node-{rng.randrange(n_nodes)}", "node-missing"])
        requests = {
            t.CPU: rng.choice([100, 250, 500, 1000]),
            t.MEMORY: rng.choice([0, 256, 512, 1024]) * 1024**2,
        }
        if i % 9 == 0:
            requests["example.com/accel"] = 1
        pods.append(t.Pod(
            name=f"pod-{i}",
            requests=requests,
            priority=rng.choice([0, 100]),
            node_selector=sel,
            affinity=aff,
            node_name=pin,
            tolerations=rng.choice(tolerations) if rng.random() < 0.3 else (),
            scheduling_gates=("wait",) if i == 5 else (),
        ))
    bound = [
        t.Pod(
            name=f"bound-{j}",
            requests={t.CPU: 500, t.MEMORY: 512 * 1024**2},
            node_name=f"node-{(3 * j) % n_nodes}",
        )
        for j in range(n_nodes // 2)
    ]
    return Snapshot(nodes=nodes, pending_pods=pods, bound_pods=bound)


def interference(n_nodes: int = 8, n_big: int = 240, n_small: int = 16) -> Snapshot:
    """One dominant class hammering a few nearly-full nodes: almost every
    commit moves the winning node's score, so wave blocks truncate, the
    exact fallback rescore runs, fallbacks stack on claimed nodes (epoch
    refreshes) and capacity runs out mid-wave.  The port of the JAX
    package's tests/test_class_waves.py _interference_snap."""
    nodes = [
        t.Node(name=f"n{i}", allocatable={t.CPU: 4000, t.MEMORY: 8 * GI, t.PODS: 40})
        for i in range(n_nodes)
    ]
    pods = [t.Pod(name=f"p{i:03d}", requests={t.CPU: 1000, t.MEMORY: 128 * 1024**2}) for i in range(n_big)]
    pods += [t.Pod(name=f"q{i}", requests={t.CPU: 500, t.MEMORY: 128 * 1024**2}) for i in range(n_small)]
    return Snapshot(nodes=nodes, pending_pods=pods)


# ---------------------------------------------------------------------------
# bench.py's warm loop (bench.py:283-327), shared by chip_smoke.py and the
# JAX reference script so both drive the same dataflow
# ---------------------------------------------------------------------------

def mk_wave(snap, w: int) -> list:
    """Wave w: the snapshot's pending pods renamed (bench.py mk_wave)."""
    return [dataclasses.replace(p, name=f"w{w}-{p.name}", uid="") for p in snap.pending_pods]


def place(pods, verdicts) -> list:
    """The pods that were placed, bound to their nodes (bench.py place)."""
    return [dataclasses.replace(p, node_name=verdicts[p.name]) for p in pods if verdicts.get(p.name)]


def verdicts_of(choices, meta) -> Dict[str, Optional[str]]:
    """choices (node index or -1, in meta.pod_names order) -> verdicts."""
    c = np.asarray(choices)
    return {
        meta.pod_names[k]: (meta.node_names[int(c[k])] if int(c[k]) >= 0 else None)
        for k in range(meta.n_pods)
    }


def wave_digest(pods, verdicts, node_names) -> str:
    """sha256 of each pod's node index (-1: unscheduled), in wave order, as
    little-endian int32."""
    index = {n: i for i, n in enumerate(node_names)}
    a = np.array([index[verdicts[p.name]] if verdicts[p.name] is not None else -1 for p in pods], dtype="<i4")
    return hashlib.sha256(a.tobytes()).hexdigest()


def warm_waves(snap, first: Dict[str, Optional[str]], submit: Callable, drain: Callable, snapshot_cls,
               last: int = 7, clock: Callable = None):
    """bench.py's warm cycles: wave w (2..last) binds the placements of the
    newest fetched wave w-2 (the pipeline's one-wave lag), `submit` takes
    each wave's snapshot and returns the previous wave's verdicts (or None),
    `drain` the last.  `first` are wave 1's verdicts.

    -> (waves {w: pods}, fetched {w: verdicts}, walls [s per cycle, mark
    to mark, the caller-side feedback included, as bench.py measures],
    submits [s in submit() per cycle])."""
    import time

    clock = clock or time.perf_counter
    waves = {1: snap.pending_pods}
    fetched = {1: first}
    walls, submits = [], []
    t_mark = clock()
    for w in range(2, last + 1):
        src = w - 2 if w - 2 in fetched else max(fetched)
        snapw = snapshot_cls(nodes=snap.nodes, pending_pods=mk_wave(snap, w),
                             bound_pods=place(waves[src], fetched[src]))
        waves[w] = snapw.pending_pods
        t_sub = clock()
        v = submit(snapw)
        now = clock()
        submits.append(now - t_sub)
        walls.append(now - t_mark)
        t_mark = now
        if v is not None:
            fetched[w - 1] = v
    fetched[last] = drain()
    return waves, fetched, walls, submits


def wide_taints(n_nodes: int = 2000, n_pods: int = 5000, n_taints: int = 80, seed: int = 0) -> Snapshot:
    """Dedicated node pools: `n_taints` distinct NoSchedule taints
    (team-k=true), three nodes in four carrying one, and pods tolerating
    none, one or two teams.  node_taint_ns and pod_tol_ns are then
    `n_taints` wide, which for 64 or more makes the encoder send them packed
    (api/delta.py — DeltaEncoder._packed_put; kernel K9 unpacks them)."""
    rng = random.Random(seed)
    nodes = []
    pools = 0
    for i in range(n_nodes):
        taints = ()
        if i % 4:
            taints = (t.Taint(key=f"team-{pools % n_taints}", value="true", effect=t.NO_SCHEDULE),)
            pools += 1
        nodes.append(t.Node(
            name=f"node-{i}",
            allocatable={t.CPU: rng.choice([8, 16, 32]) * MILLI, t.MEMORY: rng.choice([32, 64]) * GI,
                         t.PODS: 110},
            labels={t.LABEL_ZONE: f"zone-{i % 3}"},
            taints=taints,
        ))
    pods = []
    for i in range(n_pods):
        teams = rng.sample(range(n_taints), i % 3)
        pods.append(t.Pod(
            name=f"pod-{i}",
            requests={t.CPU: rng.choice([250, 500, 1000]), t.MEMORY: rng.choice([256, 512, 1024]) * 1024**2},
            tolerations=tuple(t.Toleration(key=f"team-{k}", value="true", effect=t.NO_SCHEDULE) for k in teams),
            priority=rng.choice([0, 0, 100]),
        ))
    return Snapshot(nodes=nodes, pending_pods=pods)
