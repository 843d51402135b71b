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

import random

from ..api import types as t
from ..api.snapshot import Snapshot

MILLI = 1000
GI = 1024**3

# The north-star shape and the JAX package's decisions there: the count of
# scheduled pods and the sha256 of its choices[:n_pods] as little-endian
# int32, from `JAX_PLATFORMS=cpu python tests/torch_north_star_digest.py`
# (the JAX package's schedule_batch on the CPU, which runs its per-pod scan).
NORTH_STAR = dict(n_nodes=20000, n_pods=50000, seed=0)
NORTH_STAR_SCHEDULED = 50000
NORTH_STAR_CHOICES_SHA256 = "06714885065d2bdf07c90eee8d4d5bd3e05569be5e34beb5e7a51edabddc9e53"


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
