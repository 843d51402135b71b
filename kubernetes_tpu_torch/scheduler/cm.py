"""Container managers — the kubelet's cm/ subsystems beyond devices.

  CPUManagerStatic   pkg/kubelet/cm/cpumanager (static policy): pods of the
                     guaranteed tier requesting INTEGER CPUs get exclusive
                     cores carved from the node's shared pool; admission
                     fails when no whole cores remain (the kubelet's
                     UnexpectedAdmissionError path, same as devicemanager).
                     Allocation prefers the lowest-numbered free cores —
                     the reference's takeByTopology without the socket
                     hierarchy (nodes here have no core topology model).

  EvictionManager    pkg/kubelet/eviction (eviction_manager.go): when the
                     node comes under memory pressure, evict pods in
                     reclaim order until below threshold, and surface the
                     pressure as the memory-pressure NoSchedule taint so
                     the scheduler stops adding load (the reference sets a
                     node CONDITION that the NodeLifecycle controller
                     turns into this taint; the kubelet writes the taint
                     directly here — one hop shorter, same visible
                     contract).  "Usage" is the sum of running pods'
                     memory requests: the hollow runtime has no real RSS,
                     so pressure arises from overcommit paths that bypass
                     the scheduler (direct binds, daemons) — exactly the
                     case the reference's eviction manager exists for.

QoS (v1 qos.GetPodQOS) reduced to the model's fields: pods with no cpu AND
no memory request are BestEffort; everything else is Burstable, and
Burstable pods requesting whole CPUs play the Guaranteed role for CPU
pinning (the object model carries requests but not limits — documented
deviation, PARITY.md).

The port's copy of the JAX package's ``scheduler/cm.py``, the same semantics with its imports
re-pointed at the port; tests/test_torch_*.py hold the two equal.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ..api import types as t
from .store import ClusterStore

MEMORY_PRESSURE_TAINT_KEY = "node.kubernetes.io/memory-pressure"

QOS_BEST_EFFORT = "BestEffort"
QOS_BURSTABLE = "Burstable"


def pod_qos(pod: t.Pod) -> str:
    """qos.GetPodQOS reduced to requests-presence (no limits in the model)."""
    if pod.requests.get(t.CPU, 0) <= 0 and pod.requests.get(t.MEMORY, 0) <= 0:
        return QOS_BEST_EFFORT
    return QOS_BURSTABLE


class CPUAllocationError(Exception):
    pass


class CPUManagerStatic:
    """Exclusive-core accounting for one node (cpumanager static policy).

    With a CheckpointManager the assignments survive kubelet restart, the
    same cm/cpumanager/state checkpoint contract the devicemanager analog
    follows (a restarted kubelet must not double-assign cores that running
    containers still hold)."""

    def __init__(self, n_cpus: int, checkpoints=None, node_name: str = ""):
        self.n_cpus = n_cpus
        self.assignments: Dict[str, Tuple[int, ...]] = {}  # pod uid -> cores
        self._ckpt = checkpoints
        self._ckpt_name = f"cpumanager-{node_name or 'node'}"
        if checkpoints is not None:
            saved = checkpoints.load(self._ckpt_name)
            if saved:
                self.assignments = {
                    uid: tuple(cores) for uid, cores in saved.items()
                }

    def _persist(self) -> None:
        if self._ckpt is not None:
            self._ckpt.save(
                self._ckpt_name,
                {uid: list(c) for uid, c in self.assignments.items()},
            )

    def _free(self) -> List[int]:
        used: Set[int] = set()
        for cores in self.assignments.values():
            used.update(cores)
        return [c for c in range(self.n_cpus) if c not in used]

    @staticmethod
    def wants_exclusive(pod: t.Pod) -> int:
        """Whole-CPU count for pods in the guaranteed-for-CPU tier
        (integer cpu request in millis), else 0 (shared pool)."""
        req = pod.requests.get(t.CPU, 0)
        if req > 0 and req % 1000 == 0:
            return req // 1000
        return 0

    def allocate(self, pod: t.Pod) -> Tuple[int, ...]:
        """Idempotent per pod uid; raises CPUAllocationError when fewer
        whole cores remain than requested."""
        if pod.uid in self.assignments:
            return self.assignments[pod.uid]
        n = self.wants_exclusive(pod)
        if n == 0:
            return ()
        free = self._free()
        if len(free) < n:
            raise CPUAllocationError(
                f"want {n} exclusive CPUs, {len(free)} free of {self.n_cpus}"
            )
        cores = tuple(free[:n])  # lowest-numbered free cores
        self.assignments[pod.uid] = cores
        self._persist()
        return cores

    def free(self, pod_uid: str) -> None:
        if self.assignments.pop(pod_uid, None) is not None:
            self._persist()


class EvictionManager:
    """Node-pressure eviction for one node (synchronize() per kubelet tick)."""

    #: evict when running memory requests exceed this fraction of
    #: allocatable (the reference's memory.available hard threshold,
    #: expressed as a fraction of capacity)
    MEMORY_HARD_FRACTION = 0.95

    def __init__(self, store: ClusterStore, node_name: str,
                 pod_uids=None):
        """pod_uids: optional callable yielding this node's pod uids (the
        kubelet passes its watch-fed worker map, keeping the per-tick cost
        O(node pods) — the kubelet's no-cluster-scans contract); without
        it, falls back to scanning the store (standalone use)."""
        self.store = store
        self.node_name = node_name
        self._pod_uids = pod_uids

    def _running_pods(self) -> List[t.Pod]:
        if self._pod_uids is not None:
            pods = (self.store.pods.get(uid) for uid in self._pod_uids())
        else:
            pods = self.store.list_pods()
        return [
            p
            for p in pods
            if p is not None
            and p.node_name == self.node_name
            and p.phase not in (t.PHASE_SUCCEEDED, t.PHASE_FAILED)
        ]

    def synchronize(self) -> List[str]:
        """One eviction pass; returns evicted pod uids.  Ranks victims the
        way eviction/helpers.go does with the signals the model has:
        BestEffort first, then lowest priority, then largest memory
        request (usage stand-in); stops as soon as the node is below the
        threshold again."""
        node = self.store.nodes.get(self.node_name)
        if node is None:
            return []
        alloc = node.allocatable.get(t.MEMORY, 0)
        if alloc <= 0:
            return []
        limit = int(alloc * self.MEMORY_HARD_FRACTION)
        pods = self._running_pods()
        used = sum(p.requests.get(t.MEMORY, 0) for p in pods)
        evicted: List[str] = []
        if used > limit:
            ranked = sorted(
                pods,
                key=lambda p: (
                    pod_qos(p) != QOS_BEST_EFFORT,  # BestEffort first
                    p.priority,
                    -p.requests.get(t.MEMORY, 0),
                    p.name,
                ),
            )
            for p in ranked:
                if used <= limit:
                    break
                import copy

                q = copy.copy(self.store.pods[p.uid])
                q.phase = t.PHASE_FAILED
                self.store.update_pod_status(q)
                used -= p.requests.get(t.MEMORY, 0)
                evicted.append(p.uid)
        # the pressure taint reflects the POST-eviction state
        self._sync_taint(used > limit)
        return evicted

    def _sync_taint(self, pressure: bool) -> None:
        node = self.store.nodes.get(self.node_name)
        if node is None:
            return
        has = any(tn.key == MEMORY_PRESSURE_TAINT_KEY for tn in node.taints)
        if pressure == has:
            return
        import copy

        q = copy.copy(node)
        if pressure:
            q.taints = tuple(node.taints) + (
                t.Taint(key=MEMORY_PRESSURE_TAINT_KEY, value="",
                        effect=t.NO_SCHEDULE),
            )
        else:
            q.taints = tuple(
                tn for tn in node.taints
                if tn.key != MEMORY_PRESSURE_TAINT_KEY
            )
        self.store.update_node(q)
