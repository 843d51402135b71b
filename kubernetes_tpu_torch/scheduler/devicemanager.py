"""Device manager + topology manager analog — concrete device allocation on
the node.

reference: pkg/kubelet/cm/devicemanager (type ManagerImpl — Allocate: pick
SPECIFIC device IDs for a container, record them in a checksummed checkpoint
so a kubelet restart doesn't double-hand-out devices) and
pkg/kubelet/cm/topologymanager (NUMA alignment: prefer an allocation whose
devices share one NUMA node — the best-effort policy).

The scheduler counts device CAPACITY (api/volumes._device_counts folds
ResourceSlices into per-node per-class counts the Fit kernel enforces); this
manager performs the node-local half: which exact devices a pod gets.
Devices advertise their NUMA node through the reserved attribute key "numa"
on the ResourceSlice device (DraDevice attributes); devices without it are
topology-agnostic.

Allocation policy (deterministic):
  1. candidate devices = the node's slice devices matching the claim's
     DeviceClass selector, minus already-allocated ones;
  2. prefer the single NUMA node that can satisfy the whole claim with the
     fewest spare devices (best-fit — topologymanager's bitmask preference
     reduced to one dimension); fall back to spanning NUMA nodes;
  3. within a NUMA node, lowest device name first.

The port's copy of the JAX package's ``scheduler/devicemanager.py``, the same semantics with its imports
re-pointed at the port; tests/test_torch_*.py hold the two equal.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..api import types as t
from .checkpoint import CheckpointManager

_NUMA_ATTR = "numa"


class AllocationError(Exception):
    """Admission failure: the pod cannot start on this node (the reference
    fails the pod with UnexpectedAdmissionError)."""


class DeviceManager:
    """Per-node device allocator.  State: pod uid -> {class -> [device ids]}."""

    def __init__(
        self,
        node_name: str,
        checkpoints: Optional[CheckpointManager] = None,
    ):
        self.node_name = node_name
        self.checkpoints = checkpoints
        self.allocations: Dict[str, Dict[str, List[str]]] = {}
        if checkpoints is not None:
            saved = checkpoints.load(self._ckpt_name())
            if saved:
                self.allocations = {
                    uid: {cls: list(ids) for cls, ids in per.items()}
                    for uid, per in saved.items()
                }

    def _ckpt_name(self) -> str:
        return f"devicemanager-{self.node_name}"

    def _persist(self) -> None:
        if self.checkpoints is not None:
            self.checkpoints.save(self._ckpt_name(), self.allocations)

    # ------------------------------------------------------------ inventory
    def _devices_for_class(self, slices, device_class) -> List[Tuple[str, str]]:
        """-> [(device id, numa node)] on this node matching the class."""
        out = []
        for sl in slices:
            if sl.node_name != self.node_name:
                continue
            for dev in sl.devices:
                if device_class.selector.matches(dev):
                    numa = dict(dev.attributes).get(_NUMA_ATTR, "")
                    out.append((f"{sl.driver}/{dev.name}", numa))
        return out

    def _in_use(self) -> set:
        return {
            dev
            for per in self.allocations.values()
            for ids in per.values()
            for dev in ids
        }

    # ------------------------------------------------------------- allocate
    def allocate(self, pod: t.Pod, slices, device_classes) -> Dict[str, List[str]]:
        """Admit `pod`: pick concrete devices for each of its claims.
        Idempotent per pod (restart-safe).  Raises AllocationError when the
        inventory cannot satisfy a claim."""
        wanted: Dict[str, int] = {}
        for claim in pod.resource_claims:
            wanted[claim.device_class] = wanted.get(claim.device_class, 0) + claim.count
        cached = self.allocations.get(pod.uid)
        if cached is not None:
            if {cls: len(ids) for cls, ids in cached.items()} == wanted:
                return cached
            # same uid, different claims: a recreated pod reusing the name —
            # the old allocation is stale, release it and allocate afresh
            self.free(pod.uid)
        if not pod.resource_claims:
            return {}
        picked: Dict[str, List[str]] = {}
        in_use = self._in_use()
        for claim in pod.resource_claims:
            dc = device_classes.get(claim.device_class)
            if dc is None:
                raise AllocationError(
                    f"unknown device class {claim.device_class!r}"
                )
            free = [
                (dev, numa)
                for dev, numa in self._devices_for_class(slices, dc)
                if dev not in in_use
            ]
            chosen = self._pick(free, claim.count)
            if chosen is None:
                raise AllocationError(
                    f"{claim.device_class}: want {claim.count}, "
                    f"{len(free)} free on {self.node_name}"
                )
            # extend, not assign: a pod may carry several claims for the
            # same class (resolve_pod sums them on the scheduler side)
            picked.setdefault(claim.device_class, []).extend(chosen)
            in_use.update(chosen)
        self.allocations[pod.uid] = picked
        self._persist()
        return picked

    @staticmethod
    def _pick(free: List[Tuple[str, str]], count: int) -> Optional[List[str]]:
        if count <= 0:
            return []
        if len(free) < count:
            return None
        by_numa: Dict[str, List[str]] = {}
        for dev, numa in free:
            by_numa.setdefault(numa, []).append(dev)
        # single-NUMA candidates, best-fit (fewest leftovers), then numa id
        fitting = sorted(
            (len(devs), numa)
            for numa, devs in by_numa.items()
            if numa and len(devs) >= count
        )
        if fitting:
            _, numa = fitting[0]
            return sorted(by_numa[numa])[:count]
        # spanning fallback: lowest device names across all NUMA nodes
        return sorted(dev for dev, _ in free)[:count]

    # ----------------------------------------------------------------- free
    def free(self, pod_uid: str) -> None:
        if self.allocations.pop(pod_uid, None) is not None:
            self._persist()

    def numa_aligned(self, pod_uid: str, slices) -> bool:
        """True when every allocated device of the pod sits on one NUMA node
        (the topologymanager's single-numa-node check, for tests/metrics)."""
        numa_of: Dict[str, str] = {}
        for sl in slices:
            if sl.node_name == self.node_name:
                for dev in sl.devices:
                    numa_of[f"{sl.driver}/{dev.name}"] = dict(dev.attributes).get(
                        _NUMA_ATTR, ""
                    )
        nodes = {
            numa_of.get(dev, "")
            for per in [self.allocations.get(pod_uid, {})]
            for ids in per.values()
            for dev in ids
        }
        return len(nodes - {""}) <= 1
