"""Storage, DRA and event object types — the part of the JAX package's
``api/cluster.py`` that the port reads: ``StorageClass``, ``DraDevice``,
``ResourceSlice``, ``DeviceSelector`` and ``DeviceClass`` (its lines
467-558; volume resolution, api/volumes.py), and ``ClusterEvent`` (its
line 319; the Scheduler's event recorder publishes one per event,
scheduler/events.py).  The rest of that file (workload, network, policy
and flow-control objects) belongs to the control plane, which the port
does not have."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


@dataclass
class StorageClass:
    """storage.k8s.io/v1 — type StorageClass: provisioner + binding mode."""

    name: str
    provisioner: str = ""  # "" = no dynamic provisioning
    volume_binding_mode: str = "Immediate"  # or "WaitForFirstConsumer"
    # zone restriction applied to dynamically provisioned PVs
    allowed_topology: Tuple[Tuple[str, str], ...] = ()
    allow_volume_expansion: bool = False
    uid: str = ""

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"sc/{self.name}"

    @property
    def key(self) -> str:
        return self.name


@dataclass(frozen=True)
class DraDevice:
    """resource.k8s.io/v1 — type Device (basic): named device with string/num
    attributes and capacities."""

    name: str
    attributes: Tuple[Tuple[str, str], ...] = ()
    capacity: Tuple[Tuple[str, int], ...] = ()


@dataclass
class ResourceSlice:
    """resource.k8s.io/v1 — type ResourceSlice: the devices one driver
    publishes for one node."""

    name: str
    node_name: str = ""
    driver: str = ""
    pool: str = ""
    devices: Tuple[DraDevice, ...] = ()
    uid: str = ""

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"slice/{self.name}"

    @property
    def key(self) -> str:
        return self.name


@dataclass(frozen=True)
class DeviceSelector:
    """CEL selector reduced to attribute equality / existence terms (ANDed):
    (key, value) with value "" meaning existence."""

    terms: Tuple[Tuple[str, str], ...] = ()

    def matches(self, dev: DraDevice) -> bool:
        attrs = dict(dev.attributes)
        for k, v in self.terms:
            if k not in attrs:
                return False
            if v and attrs[k] != v:
                return False
        return True


@dataclass
class DeviceClass:
    """resource.k8s.io/v1 — type DeviceClass: a named selector over devices."""

    name: str
    selector: DeviceSelector = field(default_factory=DeviceSelector)
    uid: str = ""

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"dc/{self.name}"

    @property
    def key(self) -> str:
        return self.name


@dataclass
class ClusterEvent:
    """core/v1 — type Event (kind "Event"), reduced to the scheduling event
    surface with the reference's count-based aggregation: repeated identical
    events bump `count`/`last_seen` instead of creating new objects
    (client-go tools/record — EventAggregator)."""

    name: str
    namespace: str = "default"
    reason: str = ""  # Scheduled | FailedScheduling | Preempted | ...
    involved_object: str = ""  # "Pod/<ns>/<name>"
    node: str = ""
    message: str = ""
    count: int = 1
    first_seen: float = 0.0
    last_seen: float = 0.0
    uid: str = ""

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"ev/{self.namespace}/{self.name}"

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"
