"""Seeded synthetic snapshots.

``basic``, ``heterogeneous``, ``spread_affinity`` and ``gang`` are copies of the JAX
package's ``bench/workloads.py`` generators: each draws from
``random.Random(seed)`` in the same order, so one seed builds the same
snapshot in both packages.  ``spread_affinity(5000, 10000, seed=0)`` is
BASELINE config 3 (P=10240, N=6144 after bucketing), ``gang(1000, 64, 2000,
seed=0)`` BASELINE config 5 (P=65536, N=2048, G=1000); ``all_stages`` turns
every optional score and filter stage on at once.
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
# BASELINE config 3, spread_affinity(5000, 10000, seed=0) (P=10240, N=6144,
# R=4, 80 terms, 5003 domains), through the JAX package's encoder: its
# per-pod scan (the same script's config3 leg) -> the scheduled count and
# the sha256 of choices[:n_pods]; its rounds route (KTPU_FORCE_CHUNKED=1,
# the config3-rounds leg: 640 chunks of 16) -> the sweep count and the
# sha256 of ordinals[:n_pods] (its choices hash to CONFIG3_CHOICES_SHA256).
CONFIG3 = dict(n_nodes=5000, n_pods=10000, seed=0)
CONFIG3_SCHEDULED = 10000
CONFIG3_CHOICES_SHA256 = "0ed727a5e4bec796440ebbc8497ada5a0e3f6bb9d0f4aff48a6e7dfb187b7db0"
CONFIG3_ROUNDS_SWEEPS = 1691
CONFIG3_ROUNDS_ORDINALS_SHA256 = "9a80440cacec0772c847cf9bc518a7f41b5d4f494b6c7c254e0de048f88f04b8"
# A scheduling cycle of the first PERPOD_SMALL_PODS pending pods of the north
# star and of config 3, each on its cluster (P buckets to 8: the per-pod
# scan on every route), through the JAX package's encoder and
# schedule_batch (the same script's perpod-small leg) -> the sha256 of each
# one's choices.
PERPOD_SMALL_PODS = 8
PERPOD_SMALL_CHOICES_SHA256 = {
    "north star": "44ddea9fe9bba0725fa1b284a55e3cc75f0481ae45257987f29d412b7a811dc8",
    "config 3": "ff1f6ee5d67458cfac950f62e93042e21fcb867e2234dcc8721801231064ad40",
}
# all_stages() (P=512, N=256, every optional stage on) through the JAX
# package's encoder, per-pod scan and rounds kernel (the all-stages leg):
# scheduled count, choices digest, sweeps and ordinals digest.
ALL_STAGES_SCHEDULED = 510
ALL_STAGES_CHOICES_SHA256 = "6518d422ee031a901d03bd5930f82657c0367789836ab29ee8a0d32d8e260fed"
ALL_STAGES_ROUNDS_SWEEPS = 316
ALL_STAGES_ROUNDS_ORDINALS_SHA256 = "0e41def53fba92103c3a7077e2b5817e309fd58c863d4a2e704570065bbebe16"
# Config 3 with class state (the config3-inc leg: KTPU_FORCE_CHUNKED=1,
# HoistCache.ensure, the rounds route's class mode schedule_scan_rounds(inc=),
# U1 = 2423): the same sweeps, ordinals and choices as the dense rounds route.
CONFIG3_CLASSES = 2423
# Config 3's warm loop (the config3-warm leg: bench.py's waves 2..7 through
# the JAX PipelinedBatchLoop at depth 0 under KTPU_FORCE_CHUNKED=1, each wave
# on the rounds route with class state, every wave 10000/10000 scheduled):
# wave -> wave_digest, and the HoistCache action per wave.  The JAX encoder
# ran 1 full and 6 delta cycles.
CONFIG3_WARM_DIGESTS: Dict[int, str] = {
    2: "2a0d1ddf95d34f4a482505624b3f618ea75356365f00a521e5ba54de601b7cfa",
    3: "2a0d1ddf95d34f4a482505624b3f618ea75356365f00a521e5ba54de601b7cfa",
    4: "fcf8a05703661cc1b6386cab6628bd72fe9083798096d920f65ddac925132b0f",
    5: "fcf8a05703661cc1b6386cab6628bd72fe9083798096d920f65ddac925132b0f",
    6: "99d25b388106e45c7f621e9db8bef5889baa5a5856de2e1571d442f290a5ef0a",
    7: "99d25b388106e45c7f621e9db8bef5889baa5a5856de2e1571d442f290a5ef0a",
}
CONFIG3_WARM_ACTIONS: List[str] = ["static_rebuild", "hit", "full", "hit", "full", "hit"]
# Gangs (the gang-small and config5 legs, KTPU_FORCE_CHUNKED=1): the JAX
# package's host fixpoint schedule_with_gangs(with_ordinals=True) on its
# HoistCache class state (the class-wave route each iteration) -> the
# iterations, placed pods and groups, the summed sweeps, the sha256 of
# ordinals[:n_pods] and of choices[:n_pods]; its device fixpoint
# gang_fixpoint_device gives the same choices.  BASELINE config 5 is
# gang(1000, 64, 2000, seed=0): P=65536, N=2048, R=4, G=1000, U1=2001, fit-only;
# ~128k cores for ~75k requested, so its fixpoint revokes nothing.
GANG_SMALL = dict(n_groups=48, group_size=64, n_nodes=40, seed=0)
GANG_SMALL_ITERATIONS = 13
GANG_SMALL_SCHEDULED = 2304
GANG_SMALL_GROUPS = 36
GANG_SMALL_SWEEPS = 1916
GANG_SMALL_ORDINALS_SHA256 = "8ff7be71e5f8c563292dd4a8811a298a0dd5a6f2c94f7e983cc8543f44fcb487"
GANG_SMALL_CHOICES_SHA256 = "030c03aeff71937b42409729ed083b192f452e8f46cf71aff44305690db7116b"
CONFIG5 = dict(n_groups=1000, group_size=64, n_nodes=2000, seed=0)
CONFIG5_ITERATIONS = 1
CONFIG5_SCHEDULED = 64000
CONFIG5_GROUPS = 1000
CONFIG5_CLASSES = 2001
CONFIG5_SWEEPS = 2355
CONFIG5_ORDINALS_SHA256 = "9ee94793846000839a150ec75c45adab5c1b2666baafae72c3a13241aa6812aa"
CONFIG5_CHOICES_SHA256 = "6fda447d9c2e8d38713a71ea09d44e718f90587fbc1d13cfed27af19c9e66d30"
# The failure path on the JAX package's preemption bench cluster,
# bench/preempt_bench.py build(20000, 1000) (20000 full nodes, 1000
# priority-100 preemptors), through the JAX encoder, batch step,
# diagnose_failed and BatchedPreemption in failure_cycle's sequence, from
# the same script's preempt leg: every preemptor fails the step with one
# diagnosis, each is nominated with one victim, and the sha256 of the
# [preemptor, node, sorted victims] list (preempt_bench.decisions_digest).
PREEMPT = dict(n_nodes=20000, n_pre=1000)
PREEMPT_FAILED = 1000
PREEMPT_MESSAGE = "0/20000 nodes are available: 20000 Insufficient cpu."
PREEMPT_NOMINATED = 1000
PREEMPT_VICTIMS = 1000
PREEMPT_DECISIONS_SHA256 = "760e98c8aace211b464a8018fd9f1d2acec444b46c060b2c812afaf99862a30f"
# The diagnosis at the north star, from the same script's explain leg: the
# JAX explain_classes over the reps of all 100 pod classes (F padded to
# 128) at the dense step's post-step usage; the sha256 of the i64 counts
# [100, 4 + 5 + 1] as little-endian bytes (every row sums to 20000).
NORTH_STAR_EXPLAIN_REPS = 100
NORTH_STAR_EXPLAIN_SHA256 = "214e9bb97dd5b9f4b48b9d859b644ab1611aad32291ebf6e6d25b2e75afa9ceb"


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


def gang(n_groups: int, group_size: int, n_nodes: int, seed: int = 0) -> Snapshot:
    """BASELINE config 5: gang-scheduled ML jobs (PodGroups, all-or-nothing;
    the JAX package's bench/workloads.py:99, draw for draw)."""
    rng = random.Random(seed)
    nodes = [
        t.Node(
            name=f"node-{i}",
            allocatable={t.CPU: 64 * MILLI, t.MEMORY: 256 * GI, t.PODS: 256},
            labels={t.LABEL_ZONE: f"zone-{i % 4}"},
        )
        for i in range(n_nodes)
    ]
    pods, groups = [], {}
    for g in range(n_groups):
        name = f"job-{g}"
        groups[name] = t.PodGroup(name=name, min_member=group_size)
        cpu = rng.choice([500, 1000, 2000])
        for m in range(group_size):
            pods.append(
                t.Pod(
                    name=f"{name}-w{m}",
                    labels={"job": name},
                    requests={t.CPU: cpu, t.MEMORY: 2 * GI},
                    pod_group=name,
                    priority=rng.choice([0, 10]),
                )
            )
    return Snapshot(nodes=nodes, pending_pods=pods, pod_groups=groups)


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


def heterogeneous_storage(n_nodes: int, n_pods: int, seed: int = 0) -> Snapshot:
    """Config 4 + storage (the JAX package's bench/workloads.py:173): the
    heterogeneous shape where a slice of pods claim volumes -- some bound to
    zone-restricted static PVs, some unbound through a WaitForFirstConsumer
    StorageClass with zone topology -- plus CSI attach limits on a slice of
    nodes.  heterogeneous_storage(20000, 20000) is BASELINE Config4S."""
    from ..api.cluster import StorageClass

    snap = heterogeneous(n_nodes, n_pods, seed=seed)
    snap.storage_classes["fast-wffc"] = StorageClass(
        name="fast-wffc",
        provisioner="csi.example.com",
        volume_binding_mode="WaitForFirstConsumer",
        allowed_topology=((t.LABEL_ZONE, "zone-0"), (t.LABEL_ZONE, "zone-1")),
    )
    # static zone-pinned PVs, one per 40 nodes, pre-bound to claims
    n_static = max(1, n_nodes // 40)
    for v in range(n_static):
        snap.pvs.append(t.PersistentVolume(
            name=f"pv-{v}", capacity=100 * GI, storage_class="static",
            allowed_topology=((t.LABEL_ZONE, f"zone-{v % 9}"),), claim_ref=f"default/claim-static-{v}"))
        snap.pvcs[f"default/claim-static-{v}"] = t.PersistentVolumeClaim(
            name=f"claim-static-{v}", request=50 * GI, storage_class="static", volume_name=f"pv-{v}")
    # unbound WFFC claims for a slice of pods
    n_wffc = max(1, n_pods // 50)
    for c in range(n_wffc):
        snap.pvcs[f"default/claim-wffc-{c}"] = t.PersistentVolumeClaim(
            name=f"claim-wffc-{c}", request=10 * GI, storage_class="fast-wffc", wait_for_first_consumer=True)
    # attach limits on a slice of nodes
    for i, nd in enumerate(snap.nodes):
        if i % 7 == 0:
            nd.volume_attach_limit = 16
    # pods claiming volumes: every 50th pod a WFFC claim, every 97th a
    # static claim (claims may be shared: ReadWriteMany semantics)
    for i, p in enumerate(snap.pending_pods):
        if i % 50 == 0:
            p.pvcs = (f"claim-wffc-{(i // 50) % n_wffc}",)
        elif i % 97 == 0:
            p.pvcs = (f"claim-static-{(i // 97) % n_static}",)
    return snap


def dra_small(n_nodes: int = 48, n_pods: int = 160, seed: int = 0) -> Snapshot:
    """Test and smoke data for device claims (after tests/test_sidecar.py's
    DRA case): heterogeneous(n_nodes, n_pods) with ResourceSlices on every
    third node (four devices each, of type gpu, half of them also fast=yes),
    two DeviceClasses whose selectors overlap ("gpu": type=gpu, "fast":
    fast=yes; a device matching both counts for "fast", the first class by
    name), pods claiming one or two devices of either class, and a
    ReadWriteOncePod claim shared by three pending pods (the first keeps it,
    the other two fold an unsatisfiable term)."""
    from ..api.cluster import DeviceClass, DeviceSelector, DraDevice, ResourceSlice

    snap = heterogeneous(n_nodes, n_pods, seed=seed)
    snap.device_classes = {
        "gpu": DeviceClass(name="gpu", selector=DeviceSelector(terms=(("type", "gpu"),))),
        "fast": DeviceClass(name="fast", selector=DeviceSelector(terms=(("fast", "yes"),))),
    }
    for i, nd in enumerate(snap.nodes):
        if i % 3 == 0:
            devs = tuple(DraDevice(f"{nd.name}-d{k}", attributes=(("type", "gpu"),) + ((("fast", "yes"),)
                                                                                      if k % 2 else ()))
                         for k in range(4))
            snap.resource_slices.append(ResourceSlice(name=f"{nd.name}-gpus", node_name=nd.name,
                                                      driver="gpu.example.com", devices=devs))
    rwop = t.PersistentVolumeClaim(name="rwop-0", request=GI, read_write_once_pod=True,
                                   wait_for_first_consumer=True)
    snap.pvcs[rwop.key] = rwop
    for i, p in enumerate(snap.pending_pods):
        if i in (1, 2, 3):
            p.pvcs = ("rwop-0",)
        if i % 5 == 0:
            p.resource_claims = (t.ResourceClaimRef("gpu", 1 + (i // 5) % 2),)
        elif i % 7 == 0:
            p.resource_claims = (t.ResourceClaimRef("fast", 1),)
    return snap


class StorageWaves:
    """A `snapshot_cls` for warm_waves over a storage-carrying snapshot: each
    wave's snapshot carries `snap`'s PVs, PVCs, StorageClasses,
    ResourceSlices and DeviceClasses (a bare Snapshot(nodes=, pending_pods=,
    bound_pods=) would drop them, and every claim pod would resolve
    "missing claim").  From wave 5 on, the PVC default/claim-wffc-0 is
    replaced by a copy with its request doubled (dataclasses.replace: a
    storage state change the encoder's fingerprint sees).  warm_waves calls
    it once a wave, from wave 2."""

    PVC = "default/claim-wffc-0"
    CHANGE_AT = 5

    def __init__(self, snap, snapshot_cls=Snapshot):
        self.snap, self.cls, self.wave = snap, snapshot_cls, 2
        pvc = snap.pvcs[self.PVC]
        self.changed = {**snap.pvcs, self.PVC: dataclasses.replace(pvc, request=2 * pvc.request)}

    def __call__(self, nodes, pending_pods, bound_pods):
        s = self.snap
        pvcs = self.changed if self.wave >= self.CHANGE_AT else s.pvcs
        self.wave += 1
        return self.cls(nodes=nodes, pending_pods=pending_pods, bound_pods=bound_pods, pvs=s.pvs, pvcs=pvcs,
                        storage_classes=s.storage_classes, resource_slices=s.resource_slices,
                        device_classes=s.device_classes)


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

# BASELINE Config4S, heterogeneous_storage(20000, 20000, seed=0): volumes
# resolved (R=6, the last resource attachable-volumes-csi; P=20480,
# N=20480, U1=315), through the JAX package's encoder and, under
# KTPU_FORCE_CHUNKED=1, its dense chunked route and its class-wave route
# (HoistCache.ensure), from the same script's config4s leg: each route's
# sweep count and sha256 of ordinals[:n_pods]; both routes' choices hash
# to CONFIG4S_CHOICES_SHA256.  The config4s-warm leg: bench.py's waves 2..7
# over the storage-carrying snapshots (StorageWaves: the PVC
# default/claim-wffc-0 replaced from wave 5 on) through the JAX
# PipelinedBatchLoop at depth 0 -> each wave's wave_digest (every wave
# schedules 20000/20000), the HoistCache action per wave, and the encoder's
# stats (the cold encode, then a rebuild at wave 5 only).
CONFIG4S = dict(n_nodes=20000, n_pods=20000, seed=0)
CONFIG4S_SCHEDULED = 20000
CONFIG4S_CLASSES = 315
CONFIG4S_RESOURCES = ["cpu", "memory", "pods", "ephemeral-storage", "example.com/accel", "attachable-volumes-csi"]
CONFIG4S_CHOICES_SHA256 = "73eeccab01af3011d7d970f6d4c17a4480c1831f0769fe87aa12cf4517197ade"
CONFIG4S_DENSE_SWEEPS = 890
CONFIG4S_DENSE_ORDINALS_SHA256 = "2ada252e60ac6bf503d3e61f6f614507beeeea9bed50287dd59fb4a3d9805767"
CONFIG4S_WAVE_SWEEPS = 565
CONFIG4S_WAVE_ORDINALS_SHA256 = "cdc07d5298f8552bc4de861744136da3d4d042ee5c128ac94b8135be1eee1254"
CONFIG4S_WARM_DIGESTS: Dict[int, str] = {
    2: "69fd60db8c5ab233b0df08bacf1bb14b0a3df0fc6aceb398460ce5cdb05c0f6f",
    3: "69fd60db8c5ab233b0df08bacf1bb14b0a3df0fc6aceb398460ce5cdb05c0f6f",
    4: "269aff7bd05dd668b9a542ae3db18756101575d1dbdff8b53e9b891df9bef47f",
    5: "269aff7bd05dd668b9a542ae3db18756101575d1dbdff8b53e9b891df9bef47f",
    6: "680dd605984d93190bfe6c640952fbfb74321e6191c0e5d6a4c851432aac62b2",
    7: "680dd605984d93190bfe6c640952fbfb74321e6191c0e5d6a4c851432aac62b2",
}
CONFIG4S_WARM_ACTIONS: List[str] = ["static_rebuild", "hit", "full", "static_rebuild", "full", "hit"]
CONFIG4S_WARM_STATS = {"full": 2, "delta": 5}

# dra_small() (device claims through ResourceSlices and two overlapping
# DeviceClasses, a ReadWriteOncePod claim shared by three pods) through the
# JAX package's encoder (its resolution) and per-pod scan, from the same
# script's dra-small leg: the resolved resource axis, the scheduled count and
# the sha256 of choices[:n_pods] (P=256, N=64).
DRA_SMALL_RESOURCES = ["cpu", "memory", "pods", "ephemeral-storage", "example.com/accel",
                       "attachable-volumes-csi", "claim/gpu", "claim/fast"]
DRA_SMALL_SCHEDULED = 146
DRA_SMALL_CHOICES_SHA256 = "ab2aee700a050ead0c99299dde60bd9c25bb7eafea2e2b4a4639a41b6c273e46"

# The Scheduler itself, from the same script's scheduler-* legs: BASELINE
# Config4 (heterogeneous(20000, 20000, seed=0)) and Config5 (gang(1000, 64,
# 2000, seed=0)) through the JAX Scheduler's run_until_idle (its harness's
# _setup_cluster, mode="tpu"): the Scheduled / FailedScheduling counts, the
# batch cycles and bench/harness.py bindings_digest over the store; the
# preemption bench's build(20000, 1000) store through one JAX
# Scheduler.schedule_batch() under KTPU_EXPLAIN=1: bench/harness.py
# failure_outcome (the 1000 evicted fillers, the 1000 nominations, the one
# FailedScheduling message, the bindings) and its sha256.
SCHEDULER_CONFIG4 = dict(n_nodes=20000, n_pods=20000, seed=0)
SCHEDULER_CONFIG4_WANT = dict(scheduled=20000, unschedulable=0, batches=1,
                              bindings="732cb57d3d52667fad49618058f027502b5fd16aa38c04480e502554b702308f")
SCHEDULER_CONFIG5 = dict(n_groups=1000, group_size=64, n_nodes=2000, seed=0)
SCHEDULER_CONFIG5_WANT = dict(scheduled=64000, unschedulable=0, batches=1,
                              bindings="6734d9c3eeb5b93fcbcff6e9805b0047c1bbb359a67b18e805eba35224bd8cdb")
SCHEDULER_PREEMPT_EVICTED = 1000
SCHEDULER_PREEMPT_NOMINATED = 1000
SCHEDULER_PREEMPT_MESSAGES = {"0/20000 nodes are available: 20000 Insufficient cpu.": 1000}
SCHEDULER_PREEMPT_OUTCOME_SHA256 = "7a6748cbbf84580cb1fa3a347b5b22e1cc312b09e7c8891f7bb279d438071791"
# Config4's pods split between two profiles (every odd pod names the second
# one, SECOND_PROFILE), GangScheduling off: each batch cycle runs the two
# profiles' programs back to back, and the second one's device window
# publishes the first one's deferred binds (the commit overlap).  From the
# same script's scheduler-two-profiles leg, at heterogeneous(2000, 2000,
# seed=0): the counts, the bindings digest and the binds the overlap
# published.
SECOND_PROFILE = "second"
SCHEDULER_TWO_PROFILES = dict(n_nodes=2000, n_pods=2000, seed=0)
SCHEDULER_TWO_PROFILES_WANT = dict(scheduled=2000, unschedulable=0, batches=1, overlapped=1000,
                                   bindings="51abed5fe6aa34053ff0e74b785402f23dda91dd3080fbc7f2ad51133f7eb907")
# BASELINE Config1 (basic(100, 100, seed=0)), Config2 (basic(1000, 5000,
# seed=0)) and Config3 (spread_affinity(5000, 10000, seed=0)) through the
# JAX Scheduler's run_until_idle in mode="native" (the same script's
# scheduler-config1 / -config2 / -config3 legs): (generator, its arguments,
# the counts, the batch cycles and the bindings digest).  Every route gives
# these decisions, so the port's mode="tpu" is held to them too.
SCHEDULER_BASELINE = {
    "config1": ("basic", (100, 100), dict(scheduled=100, unschedulable=0, batches=1,
                bindings="0d2108a05f240de80ffcf517fdbae91d9f59d11374d54d4dcd4e4f667810b67f")),
    "config2": ("basic", (1000, 5000), dict(scheduled=5000, unschedulable=0, batches=1,
                bindings="4870f4213ae2e2b4a8ce258752bfeec1d33f109463fce31458d365984a3b1fbd")),
    "config3": ("spread_affinity", (5000, 10000), dict(scheduled=10000, unschedulable=0, batches=1,
                bindings="79cb820f4b69e14067fb1c68bef2d054ea97e424d81757f795a6e0c9fec70328")),
}
# The control plane at bench/control_plane.py FULL (5000 nodes, 50
# Deployments of 600 replicas): the JAX package's modules driven by the
# same scenario in mode="tpu" (KTPU_FORCE_CHUNKED=1 KTPU_MEMWATCH=0
# JAX_PLATFORMS=cpu python tests/torch_control_plane_reference.py): the
# digest over every pod, EndpointSlice and Scheduler event, and the run's
# counts.  The port's mode="native" on the CPU gives the same.
CONTROL_PLANE_DIGEST = "57e064ddc5558b6693ccbb7f947cbdd3547d158021cf4800031bcec298a0f171"
CONTROL_PLANE_WANT = dict(rounds=8, rounds_up=2, rounds_scale=2, rounds_drain=2, rounds_churn=2, deleted=300,
                          drain_pods=5, final_pods=30060, events={"Scheduled": 30365})


def two_profile_split(snap):
    """`snap` with every odd pending pod sent to SECOND_PROFILE (works on
    either package's Snapshot: it reads only dataclass fields)."""
    pods = [dataclasses.replace(p, scheduler_name=SECOND_PROFILE) if i % 2 else p
            for i, p in enumerate(snap.pending_pods)]
    return dataclasses.replace(snap, pending_pods=pods)

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


def spread_affinity(n_nodes: int, n_pods: int, seed: int = 0, zones: int = 3) -> Snapshot:
    """BASELINE config 3 (PodTopologySpread + InterPodAffinity across zones),
    the JAX package's bench/workloads.py:45 draw for draw: pods of
    max(4, n_pods // 250) apps, a quarter with a hard zone spread, a quarter
    with a soft one, a tenth with required zone affinity to their app and a
    tenth with hostname anti-affinity to it (one replica per node)."""
    rng = random.Random(seed)
    nodes = [
        t.Node(
            name=f"node-{i}",
            allocatable={t.CPU: 32 * MILLI, t.MEMORY: 128 * GI, t.PODS: 110},
            labels={t.LABEL_ZONE: f"zone-{i % zones}"},
        )
        for i in range(n_nodes)
    ]
    apps = [f"svc-{i}" for i in range(max(4, n_pods // 250))]
    pods = []
    for i in range(n_pods):
        app = rng.choice(apps)
        kind = rng.random()
        spread = ()
        aff = None
        if kind < 0.5:
            spread = (
                t.TopologySpreadConstraint(
                    max_skew=rng.choice([1, 2]),
                    topology_key=t.LABEL_ZONE,
                    when_unsatisfiable=t.DO_NOT_SCHEDULE if kind < 0.25 else t.SCHEDULE_ANYWAY,
                    label_selector=t.LabelSelector.of(app=app),
                ),
            )
        elif kind < 0.7:
            if kind < 0.6:
                term = t.PodAffinityTerm(topology_key=t.LABEL_ZONE, label_selector=t.LabelSelector.of(app=app))
                aff = t.Affinity(required_pod_affinity=(term,))
            else:
                term = t.PodAffinityTerm(topology_key=t.LABEL_HOSTNAME, label_selector=t.LabelSelector.of(app=app))
                aff = t.Affinity(required_pod_anti_affinity=(term,))
        pods.append(
            t.Pod(
                name=f"pod-{i}",
                labels={"app": app},
                requests={t.CPU: rng.choice([100, 250, 500]), t.MEMORY: rng.choice([128, 256, 512]) * 1024**2},
                topology_spread=spread,
                affinity=aff,
            )
        )
    return Snapshot(nodes=nodes, pending_pods=pods)


def all_stages(n_nodes: int = 240, n_pods: int = 512, seed: int = 99) -> Snapshot:
    """Every optional stage at once (the construction of the JAX package's
    tests/test_assign_parity.py test_rounds_scan_all_stages_on, at a larger
    size): zone spread (hard and soft), required and preferred inter-pod
    affinity and preferred anti-affinity (the inter-pod score with its
    hardPodAffinityWeight half), a host port, PreferNoSchedule taints on a
    quarter of the nodes, preferred node affinity, and an image present on
    a third of the nodes."""
    rng = random.Random(seed)
    nodes = []
    for i in range(n_nodes):
        taints = ()
        if i % 4 == 0:
            taints = (t.Taint(key="soft", value="x", effect=t.PREFER_NO_SCHEDULE),)
        nd = t.Node(
            name=f"n{i:03d}",
            allocatable={t.CPU: 8000, t.MEMORY: 8 * GI, t.PODS: 64},
            labels={t.LABEL_ZONE: f"zone-{i % 3}", "tier": rng.choice(["a", "b"])},
            taints=taints,
        )
        if i % 3 == 0:
            nd.images = {"registry/app:v1": 500 * 1024**2}
        nodes.append(nd)
    apps = ["web", "db", "cache"]
    pods = []
    for i in range(n_pods):
        app = rng.choice(apps)
        spread = ()
        aff_kw = {}
        if i % 3 == 0:
            spread = (t.TopologySpreadConstraint(
                max_skew=1, topology_key=t.LABEL_ZONE,
                when_unsatisfiable=t.DO_NOT_SCHEDULE if i % 6 else t.SCHEDULE_ANYWAY,
                label_selector=t.LabelSelector.of(app=app)),)
        if i % 4 == 1:
            aff_kw["required_pod_affinity"] = (t.PodAffinityTerm(
                topology_key=t.LABEL_ZONE, label_selector=t.LabelSelector.of(app=rng.choice(apps))),)
        if i % 4 == 2:
            aff_kw["preferred_pod_affinity"] = (t.WeightedPodAffinityTerm(
                weight=rng.choice([10, 50]),
                term=t.PodAffinityTerm(topology_key=t.LABEL_ZONE,
                                       label_selector=t.LabelSelector.of(app=rng.choice(apps)))),)
        if i % 5 == 0:
            aff_kw["preferred_pod_anti_affinity"] = (t.WeightedPodAffinityTerm(
                weight=20,
                term=t.PodAffinityTerm(topology_key=t.LABEL_HOSTNAME, label_selector=t.LabelSelector.of(app=app))),)
        if i % 7 == 0:
            aff_kw["preferred_node_terms"] = (t.PreferredSchedulingTerm(
                weight=rng.choice([1, 5]),
                preference=t.NodeSelectorTerm(match_expressions=(
                    t.NodeSelectorRequirement(key="tier", operator=t.OP_IN, values=("a",)),))),)
        pod = t.Pod(
            name=f"p{i:04d}",
            requests={t.CPU: rng.choice([100, 250]), t.MEMORY: 128 * 1024**2},
            labels={"app": app},
            topology_spread=spread,
            affinity=t.Affinity(**aff_kw) if aff_kw else None,
            host_ports=(("TCP", 9100),) if i % 11 == 0 else (),
        )
        if i % 6 == 0:
            pod.images = ("registry/app:v1",)
        pods.append(pod)
    return Snapshot(nodes=nodes, pending_pods=pods)


SCORE_DTYPE_CASE_WEIGHTS = {"a": 100, "b": 100, "c": 57, "d": 56}

# the JAX package's digests under KTPU_SCORE_DTYPE=f32
# (tests/torch_north_star_digest.py config3 config3-rounds all-stages
# config3-inc, run with the knob set): config 3 has no score plane, and
# all_stages' f32 image scores (48.82 where bf16 stores 48.75) move no
# decision, so they are the bf16 digests above
SCORE_F32_DIGESTS = {
    "config3": dict(scheduled=CONFIG3_SCHEDULED, choices=CONFIG3_CHOICES_SHA256),
    "config3-rounds": dict(scheduled=CONFIG3_SCHEDULED, sweeps=CONFIG3_ROUNDS_SWEEPS,
                           ordinals=CONFIG3_ROUNDS_ORDINALS_SHA256, choices=CONFIG3_CHOICES_SHA256),
    "config3-inc": dict(scheduled=CONFIG3_SCHEDULED, sweeps=CONFIG3_ROUNDS_SWEEPS,
                        ordinals=CONFIG3_ROUNDS_ORDINALS_SHA256, choices=CONFIG3_CHOICES_SHA256),
    "all-stages": dict(scheduled=ALL_STAGES_SCHEDULED, sweeps=ALL_STAGES_ROUNDS_SWEEPS,
                       ordinals=ALL_STAGES_ROUNDS_ORDINALS_SHA256, choices=ALL_STAGES_CHOICES_SHA256),
}


def score_dtype_case() -> Snapshot:
    """ROADMAP C5's case: two equal nodes and one pod whose preferred
    node-affinity terms (key Exists) weigh a 100, b 100, c 57, d 56.
    node-b, listed first, matches a, b, d (256); node-a matches a, b, c
    (257, which bf16 stores as 256).  Under bf16 the two tie and the lower
    index, node-b, wins; under KTPU_SCORE_DTYPE=f32 node-a does, as the
    JAX package and its oracle bind it (tests/test_torch_score_dtype.py)."""
    nodes = [t.Node(name=name, allocatable={t.CPU: 4000, t.MEMORY: 8 * GI, t.PODS: 110},
                    labels={k: "1" for k in keys}) for name, keys in (("node-b", "abd"), ("node-a", "abc"))]
    terms = tuple(t.PreferredSchedulingTerm(weight=w, preference=t.NodeSelectorTerm(match_expressions=(
        t.NodeSelectorRequirement(key=k, operator=t.OP_EXISTS),))) for k, w in SCORE_DTYPE_CASE_WEIGHTS.items())
    pod = t.Pod(name="pod-0", requests={t.CPU: 100, t.MEMORY: 128 * 1024**2},
                affinity=t.Affinity(preferred_node_terms=terms))
    return Snapshot(nodes=nodes, pending_pods=[pod])


# ---------------------------------------------------------------------------
# gangs off the dense route, and the sidecar's session waves
# ---------------------------------------------------------------------------

def grouped(snap, size: int = 64, group_cls=t.PodGroup):
    """`snap` with its pending pods put into PodGroups of `size` in list
    order (pg-0, pg-1, ...), each needing all its pods: the last group is
    smaller and its min_member is its size.  `group_cls` is the PodGroup
    type of the snapshot's package (the port's, or the JAX package's for
    the reference), so one definition serves both."""
    pods = snap.pending_pods
    out, groups = [], dict(snap.pod_groups)
    for g0 in range(0, len(pods), size):
        name = f"pg-{g0 // size}"
        members = pods[g0:g0 + size]
        groups[name] = group_cls(name=name, min_member=len(members))
        out.extend(dataclasses.replace(p, pod_group=name) for p in members)
    return dataclasses.replace(snap, pending_pods=out, pod_groups=groups)


def _job_pod(name: str, job: str, cpu: int, prio: int, **kw) -> t.Pod:
    return t.Pod(name=name, labels={"job": job}, requests={t.CPU: cpu, t.MEMORY: GI}, pod_group=job,
                 priority=prio, **kw)


def gang_contended(name: str, seed: int = 0) -> Snapshot:
    """Contended gang batches that revoke groups, one per route the device
    fixpoint takes off the dense route (P after bucketing):

    rounds-pairwise  P=64: 12 jobs of 4 on 8 nodes in 2 zones, each job
                     one pod per node (hostname anti-affinity to itself)
                     and spread over the zones (maxSkew 1);
    rounds-fit       P=64, fit-only: 10 jobs of 5 on 4 nodes;
    perpod-fit       P=8, fit-only: jobs of 3, 3 and 2 on 2 nodes;
    perpod-full      P=8: two jobs of 4 with hostname anti-affinity to
                     themselves on 3 nodes (the first needs all 4)."""
    rng = random.Random(seed)

    def nodes(n, cpu, zones=1):
        return [t.Node(name=f"n{i}", allocatable={t.CPU: cpu, t.MEMORY: 64 * GI, t.PODS: 110},
                       labels={t.LABEL_ZONE: f"z{i % zones}"}) for i in range(n)]

    def anti(job):
        return t.Affinity(required_pod_anti_affinity=(
            t.PodAffinityTerm(topology_key=t.LABEL_HOSTNAME, label_selector=t.LabelSelector.of(job=job)),))

    pods, groups = [], {}
    if name == "rounds-pairwise":
        ns = nodes(8, 4000, zones=2)
        for g in range(12):
            job = f"job-{g}"
            groups[job] = t.PodGroup(job, 4 if g % 3 else 3)
            spread = (t.TopologySpreadConstraint(max_skew=1, topology_key=t.LABEL_ZONE,
                                                 label_selector=t.LabelSelector.of(job=job)),)
            cpu, prio = rng.choice([1000, 1500, 2500]), rng.choice([0, 10])
            pods += [_job_pod(f"{job}-w{m}", job, cpu, prio, affinity=anti(job), topology_spread=spread)
                     for m in range(4)]
    elif name == "rounds-fit":
        ns = nodes(4, 4000)
        for g in range(10):
            job = f"job-{g}"
            groups[job] = t.PodGroup(job, 5)
            cpu, prio = rng.choice([500, 1000, 1500]), rng.choice([0, 10])
            pods += [_job_pod(f"{job}-w{m}", job, cpu, prio) for m in range(5)]
    elif name == "perpod-fit":
        ns = nodes(2, 2000)
        for g, size in enumerate((3, 3, 2)):
            job = f"job-{g}"
            groups[job] = t.PodGroup(job, size)
            cpu, prio = rng.choice([600, 900]), rng.choice([0, 10])
            pods += [_job_pod(f"{job}-w{m}", job, cpu, prio) for m in range(size)]
    elif name == "perpod-full":
        ns = nodes(3, 4000)
        for g in range(2):
            job = f"job-{g}"
            groups[job] = t.PodGroup(job, 4 - g)
            pods += [_job_pod(f"{job}-w{m}", job, 500, 0, affinity=anti(job)) for m in range(4)]
    else:
        raise KeyError(name)
    return Snapshot(nodes=ns, pending_pods=pods, pod_groups=groups)


GANG_CONTENDED = ("rounds-pairwise", "rounds-fit", "perpod-fit", "perpod-full")


def gang_pinned(name: str, n_nodes: int = CONFIG3["n_nodes"], seed: int = 0) -> Snapshot:
    """gang_contended(name)'s wave on BASELINE config 3's cluster
    (spread_affinity(n_nodes, 0, seed)'s nodes: 32 CPUs each, zones i % 3),
    each job pinned to a pool of the cluster's nodes, as a gang is pinned
    to the nodes that hold its reservation: the small batch's k nodes become
    the first k cluster nodes in zones 0 and 1 (alternating, as the small
    batch's two zones), every pod gets required node affinity to their
    hostnames, and its CPU request is scaled by 32000 / the small node's
    CPU, so the contention is the small batch's.  The wave is as small as
    the sidecar sends it (P = 64 or 8); every kernel runs over the whole
    cluster."""
    small = gang_contended(name, seed)
    cluster = spread_affinity(n_nodes, 0, seed).nodes
    pool = tuple(nd.name for nd in cluster if nd.labels[t.LABEL_ZONE] != "zone-2")[:len(small.nodes)]
    pin = t.NodeSelectorTerm((t.NodeSelectorRequirement(t.LABEL_HOSTNAME, t.OP_IN, pool),))
    scale = cluster[0].allocatable[t.CPU] // small.nodes[0].allocatable[t.CPU]
    pods = []
    for p in small.pending_pods:
        aff = p.affinity or t.Affinity()
        pods.append(dataclasses.replace(p, requests={**p.requests, t.CPU: p.requests[t.CPU] * scale},
                                        affinity=dataclasses.replace(aff, required_node_terms=(pin,))))
    return Snapshot(nodes=cluster, pending_pods=pods, pod_groups=small.pod_groups)


def pregroup(pods, interner):
    """A wave as the sidecar's wire carries it, interned by spec: (uids,
    reps, inv) — `interner` is the package's SpecInterner."""
    reps, inv, _ = interner.group(pods)
    return [p.uid for p in pods], list(reps), np.asarray(inv, dtype=np.int64)


def session_waves(engine, new_session: Callable, clone_pod, interner, snap, gang: bool,
                  waves: int = 2) -> List[dict]:
    """The sidecar engine's session path without the wire, the same for the
    port and the JAX package (each passes its own _Engine, a factory of its
    _Session at hardPodAffinityWeight 1, convert.clone_pod and
    SpecInterner): wave 1 is the whole pending set,
    pregrouped, through engine.run_session; wave w > 1 is bench.py's wave w
    (mk_wave) with the placements of wave w - 1 bound as the server binds
    them, clone_pod of the spec rep.  -> per wave {"verdicts": node index
    per pod in request order (-1: unscheduled), "scheduled", "sha256"}."""
    sess = new_session()
    sess.nodes = list(snap.nodes)
    sess.bound = {p.uid: p for p in snap.bound_pods}
    sess.pod_groups = dict(snap.pod_groups)
    names = [nd.name for nd in sess.nodes]
    pods = snap.pending_pods
    out = []
    for w in range(1, waves + 1):
        if w > 1:
            pods = mk_wave(snap, w)
        uids, reps, inv = pregroup(pods, interner)
        choices, meta = engine.run_session(sess, (uids, reps, inv), gang)
        v = np.full(meta.n_pods, -1, dtype=np.int64)
        v[meta.pod_perm] = np.asarray(choices[: meta.n_pods], dtype=np.int64)
        out.append({"verdicts": v, "scheduled": int((v >= 0).sum()),
                    "sha256": hashlib.sha256(v.astype("<i4").tobytes()).hexdigest()})
        sess.bound = {uid: clone_pod(reps[inv[k]], uid, uid, names[int(v[k])])
                      for k, uid in enumerate(uids) if v[k] >= 0}
    return out


# The JAX package's numbers for the gangs off the dense route and the
# sidecar's session path (tests/torch_north_star_digest.py, legs
# gang-rounds, gang-contended, gang-pinned, sidecar-north-star and sidecar-config5,
# KTPU_FORCE_CHUNKED=1 on the CPU).  gang-rounds: BASELINE config 3 in
# PodGroups of 64 (grouped(spread_affinity(5000, 10000, seed=0))) through
# the JAX gang_fixpoint_device, the rounds route each iteration: every
# group placed, so one real iteration; the sha256 of choices[:n_pods] and
# of the whole usage as little-endian int32.
GANG_ROUNDS_GROUPS = 157
GANG_ROUNDS_ITERATIONS = 1
GANG_ROUNDS_SCHEDULED = 10000
GANG_ROUNDS_CHOICES_SHA256 = "0ed727a5e4bec796440ebbc8497ada5a0e3f6bb9d0f4aff48a6e7dfb187b7db0"
GANG_ROUNDS_USED_SHA256 = "4f2b32c56a4a2126c435b5683b21dc261e18c4aa68a891501778229e2fc33e14"
# gang_contended(name) through the JAX device fixpoint: name -> (route,
# iterations = 1 + revoked groups, scheduled pods, choices sha256, usage
# sha256)
GANG_CONTENDED_WANT = {
    "rounds-pairwise": ("rounds", 8, 20, "449fac7eeaad99d362fa4de7dfea914c92fa2b6cc53d2225111f4fef8d7c760b",
                        "bd053d36318ddb75c40e97cd3104c3ea24346735c586d212ff9f973880607110"),
    "rounds-fit": ("rounds", 7, 20, "1267deeb7c051d7e87e9368e3dce7deccec6efb58b8b577f10869d19e12d4568",
                   "66ac01511a08aa1b78beee13d3445aa580d70a2e40741c7983730696c34e4dc0"),
    "perpod-fit": ("perpod-fit", 3, 3, "2b16db48fb6f31ff0dc873d36b7f4a54644bf7b5ae192c5bb53b786e318f3914",
                   "417796b7de9ca40312e769a2a058b78a3de27f2032a7ed00d1f03936cee8b95e"),
    "perpod-full": ("perpod-full", 2, 3, "f336f481e82e19a76f2daa26aac7a93f37d977c133b26934f5afb095cd01a8ed",
                    "5297cc54611e13063e8db1b640fe04dd1bbbf3744ecec575c414e07781cb551a"),
}
# gang_pinned(name) (the same batches pinned to a pool of config 3's 5000
# nodes: P = 64 or 8, N = 6144) through the JAX device fixpoint, as above
GANG_PINNED_WANT = {
    "rounds-pairwise": ("rounds", 8, 20, "9526714211eb3dc0f9d1b4ca150c84893f5711dec3f2b62554290a49ca631605",
                        "eb3d6447a2d312c686dd313550029dc482da404ff293af6efc473bf18f5ef8c8"),
    "rounds-fit": ("rounds", 7, 20, "99b94d93ca6d7b6529042e0310384a26dc5608d93c92fc01f536df039c06d97e",
                   "cdd4fdad971709cbfecb814cd93b14b682e583712f891f65d8d022ca40190859"),
    "perpod-fit": ("perpod-fit", 3, 3, "2b16db48fb6f31ff0dc873d36b7f4a54644bf7b5ae192c5bb53b786e318f3914",
                   "203b4f0d6588c99df2f60ca6a2d20cd574a68c399d218f32b1212287c3a277e5"),
    "perpod-full": ("perpod-full", 2, 3, "2624103bf017f0f785bd55a56499c5737c3066c5ab71b747566abdcaf70171b0",
                    "6e9051228e82fb732014dcdac19746d599c222af6be2ae9c632b60384b8e1ef6"),
}
# The JAX sidecar engine's session path (session_waves, no wire): per wave
# the scheduled count and the sha256 of the verdicts in request order.
# North star: wave 1 the whole pending set (the dense route), wave 2
# bench.py's wave 2 with wave 1's placements bound; config 5: one gang
# wave (the device fixpoint on the dense route).
SIDECAR_NORTH_STAR_WAVES = [
    (50000, "89d013b3a52282f3779216d3c0b0eac07183cb544d6b431cc566b7218c8b57f9"),
    (50000, "3cecc627ae03162d6ed3175e0a2840d7b79adc4ab20e548b878d36d2ba9fba4e"),
]
SIDECAR_CONFIG5_WAVES = [(64000, "c30542fc88c5fddd80e87efea50630cc738965afee72dba80cae17d71b523e64")]
