"""Control-plane object kinds beyond the scheduling surface.

The reference's API groups the harness-side components consume:
core/v1 Service/Endpoints/Namespace/ResourceQuota/LimitRange,
scheduling.k8s.io PriorityClass, discovery.k8s.io EndpointSlice,
apps/v1 StatefulSet/DaemonSet, batch/v1 CronJob, autoscaling/v2 HPA,
rbac.authorization.k8s.io Role/RoleBinding, flowcontrol.apiserver.k8s.io
FlowSchema/PriorityLevelConfiguration, storage.k8s.io StorageClass, and
resource.k8s.io ResourceSlice/DeviceClass (DRA structured parameters).

All reduced to the fields this framework's controllers/authorizers/allocators
actually read, same convention as api/types.py.

The port's copy of the JAX package's ``api/cluster.py``, the same semantics with its imports
re-pointed at the port; tests/test_torch_*.py hold the two equal.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from .types import LabelSelector, Pod, ResourceList

# ---------------------------------------------------------------- Services


@dataclass(frozen=True)
class ServicePort:
    """core/v1 — type ServicePort."""

    port: int
    target_port: int = 0  # 0 => same as port
    protocol: str = "TCP"
    name: str = ""

    @property
    def backend_port(self) -> int:
        return self.target_port or self.port


@dataclass
class Service:
    """core/v1 — type Service (ClusterIP surface).  spec.selector is a plain
    label map in the reference (not a LabelSelector)."""

    name: str
    namespace: str = "default"
    selector: Tuple[Tuple[str, str], ...] = ()
    ports: Tuple[ServicePort, ...] = ()
    cluster_ip: str = ""  # allocated by the apiserver facade ("" = to allocate)
    session_affinity: str = "None"  # None | ClientIP
    uid: str = ""

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"svc/{self.namespace}/{self.name}"

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def selects(self, pod: Pod) -> bool:
        if not self.selector or pod.namespace != self.namespace:
            return False
        return all(pod.labels.get(k) == v for k, v in self.selector)


@dataclass(frozen=True)
class Endpoint:
    """discovery/v1 — type Endpoint (one backend)."""

    address: str
    pod_uid: str = ""
    node_name: str = ""
    ready: bool = True


@dataclass
class EndpointSlice:
    """discovery/v1 — type EndpointSlice; owned by its Service, maintained by
    the EndpointSliceController."""

    name: str
    namespace: str = "default"
    service_name: str = ""  # kubernetes.io/service-name label
    endpoints: Tuple[Endpoint, ...] = ()
    ports: Tuple[ServicePort, ...] = ()
    owner_references: tuple = ()
    uid: str = ""

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"eps/{self.namespace}/{self.name}"

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


# ------------------------------------------------------------ Namespaces etc.


@dataclass
class Namespace:
    """core/v1 — type Namespace; phase drives the NamespaceLifecycle admission
    plugin and the namespace controller's cascading deletion."""

    name: str
    phase: str = "Active"  # Active | Terminating
    labels: Dict[str, str] = field(default_factory=dict)
    uid: str = ""

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"ns/{self.name}"

    @property
    def key(self) -> str:
        return self.name


@dataclass
class PriorityClass:
    """scheduling.k8s.io/v1 — type PriorityClass (the Priority admission
    plugin resolves pod.spec.priorityClassName through these)."""

    name: str
    value: int = 0
    global_default: bool = False
    preemption_policy: str = "PreemptLowerPriority"  # or "Never"
    uid: str = ""

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"pc/{self.name}"

    @property
    def key(self) -> str:
        return self.name


@dataclass
class ResourceQuota:
    """core/v1 — type ResourceQuota: hard per-namespace caps on aggregate
    requests + object counts ("pods")."""

    name: str
    namespace: str = "default"
    hard: ResourceList = field(default_factory=dict)
    used: ResourceList = field(default_factory=dict)  # status
    uid: str = ""

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"quota/{self.namespace}/{self.name}"

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class LimitRange:
    """core/v1 — type LimitRange reduced to defaultRequest + max per pod
    (the LimitRanger admission plugin's surface)."""

    name: str
    namespace: str = "default"
    default_request: ResourceList = field(default_factory=dict)
    max_per_pod: ResourceList = field(default_factory=dict)
    uid: str = ""

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"limits/{self.namespace}/{self.name}"

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


# ------------------------------------------------------------------ Workloads


@dataclass
class StatefulSet:
    """apps/v1 — type StatefulSet: stable ordinal identities name-0..name-N-1,
    OrderedReady (default) or Parallel pod management."""

    name: str
    namespace: str = "default"
    replicas: int = 1
    selector: Optional[LabelSelector] = None
    template: Optional[Pod] = None
    pod_management_policy: str = "OrderedReady"  # or "Parallel"
    uid: str = ""
    ready_replicas: int = 0

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"sts/{self.namespace}/{self.name}"

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class DaemonSet:
    """apps/v1 — type DaemonSet: one pod per eligible node, pinned via
    node-affinity to metadata.name (the reference schedules daemon pods
    through the default scheduler with a per-node nodeAffinity since 1.12 —
    daemon_controller.go NodeShouldRunDaemonPod)."""

    name: str
    namespace: str = "default"
    selector: Optional[LabelSelector] = None
    template: Optional[Pod] = None
    uid: str = ""
    desired_number_scheduled: int = 0
    number_ready: int = 0

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"ds/{self.namespace}/{self.name}"

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class CronJob:
    """batch/v1 — type CronJob with the schedule reduced to a period in
    seconds (cron-expression parsing is presentation, not semantics; the
    controller logic — missed-run catch-up, concurrencyPolicy — is the part
    worth reproducing from cronjob_controllerv2.go)."""

    name: str
    namespace: str = "default"
    period_seconds: float = 60.0
    job_template: Optional[Pod] = None
    completions: int = 1
    parallelism: int = 1
    concurrency_policy: str = "Allow"  # Allow | Forbid | Replace
    suspend: bool = False
    uid: str = ""
    last_schedule_time: float = -1.0  # status

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"cj/{self.namespace}/{self.name}"

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class HorizontalPodAutoscaler:
    """autoscaling/v2 — type HorizontalPodAutoscaler: scale a Deployment
    between min/max replicas toward a target average metric value.  The
    controller applies the reference's ratio formula + tolerance
    (podautoscaler/replica_calculator.go)."""

    name: str
    namespace: str = "default"
    target_kind: str = "Deployment"
    target_name: str = ""
    min_replicas: int = 1
    max_replicas: int = 10
    metric_name: str = "cpu"
    target_value: float = 0.5  # target average utilization/value per pod
    tolerance: float = 0.1
    uid: str = ""
    # status
    current_replicas: int = 0
    desired_replicas: int = 0

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"hpa/{self.namespace}/{self.name}"

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


# ------------------------------------------------------------- ServiceAccount


@dataclass
class ServiceAccount:
    """core/v1 — type ServiceAccount.  `token` is the minted bearer token
    (the legacy token Secret collapsed onto the object; the token controller
    fills it and registers it with the authenticator)."""

    name: str
    namespace: str = "default"
    token: str = ""  # "" = not yet minted
    uid: str = ""

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"sa/{self.namespace}/{self.name}"

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    @property
    def username(self) -> str:
        """The authenticated identity (serviceaccount/util — MakeUsername)."""
        return f"system:serviceaccount:{self.namespace}:{self.name}"


# ------------------------------------------------------------------ Events


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


# ------------------------------------------------------------------ RBAC


@dataclass(frozen=True)
class PolicyRule:
    """rbac/v1 — type PolicyRule; "*" wildcards supported on verbs and
    resources (plugin/pkg/auth/authorizer/rbac — RuleAllows)."""

    verbs: Tuple[str, ...] = ()
    resources: Tuple[str, ...] = ()
    resource_names: Tuple[str, ...] = ()


@dataclass
class Role:
    """rbac/v1 — Role (namespaced) / ClusterRole (namespace="")."""

    name: str
    namespace: str = ""  # "" = ClusterRole
    rules: Tuple[PolicyRule, ...] = ()
    uid: str = ""

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"role/{self.namespace}/{self.name}"

    @property
    def key(self) -> str:
        # cluster-scoped (ClusterRole) objects key by bare name
        return f"{self.namespace}/{self.name}" if self.namespace else self.name


@dataclass(frozen=True)
class Subject:
    """rbac/v1 — type Subject."""

    kind: str  # User | Group | ServiceAccount
    name: str


@dataclass
class RoleBinding:
    """rbac/v1 — RoleBinding (namespaced) / ClusterRoleBinding (namespace="")."""

    name: str
    namespace: str = ""  # "" = ClusterRoleBinding
    role_name: str = ""
    role_namespace: str = ""  # "" = refers to a ClusterRole
    subjects: Tuple[Subject, ...] = ()
    uid: str = ""

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"rb/{self.namespace}/{self.name}"

    @property
    def key(self) -> str:
        # cluster-scoped (ClusterRoleBinding) objects key by bare name
        return f"{self.namespace}/{self.name}" if self.namespace else self.name


@dataclass(frozen=True)
class UserInfo:
    """authentication/user — type DefaultInfo."""

    name: str
    groups: Tuple[str, ...] = ()


# ----------------------------------------------------- API Priority & Fairness


@dataclass
class FlowSchema:
    """flowcontrol/v1 — type FlowSchema: classify a request to a priority
    level, with a flow distinguisher (per-user here, the common case)."""

    name: str
    priority_level: str = ""
    matching_precedence: int = 1000  # lower = matched first
    # match: any of these subjects ("*" = all), any of these resources
    subjects: Tuple[str, ...] = ("*",)
    resources: Tuple[str, ...] = ("*",)
    verbs: Tuple[str, ...] = ("*",)
    distinguisher: str = "ByUser"  # ByUser | ByNamespace | "" (single flow)
    uid: str = ""

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"fs/{self.name}"

    @property
    def key(self) -> str:
        return self.name


@dataclass
class PriorityLevelConfiguration:
    """flowcontrol/v1 — type PriorityLevelConfiguration (Limited type):
    concurrency shares + fair queuing parameters."""

    name: str
    concurrency_shares: int = 30
    queues: int = 64
    hand_size: int = 8
    queue_length_limit: int = 50
    exempt: bool = False
    uid: str = ""

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"plc/{self.name}"

    @property
    def key(self) -> str:
        return self.name


# ------------------------------------------------------------------ Storage


@dataclass
class StorageClass:
    """storage.k8s.io/v1 — type StorageClass: provisioner + binding mode;
    drives dynamic provisioning in the volume binder."""

    name: str
    provisioner: str = ""  # "" = no dynamic provisioning
    volume_binding_mode: str = "Immediate"  # or "WaitForFirstConsumer"
    # zone restriction applied to dynamically provisioned PVs
    allowed_topology: Tuple[Tuple[str, str], ...] = ()
    # allowVolumeExpansion: bound claims may grow their request; the
    # expand controller resizes the backing PV (pkg/controller/volume/expand)
    allow_volume_expansion: bool = False
    uid: str = ""

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"sc/{self.name}"

    @property
    def key(self) -> str:
        return self.name


# --------------------------------------------------- DRA structured parameters


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
class ResourceClaim:
    """resource.k8s.io/v1 — type ResourceClaim, reduced to the DRA-lite
    model (counted devices of one DeviceClass — the schedulable core behind
    Pod.resource_claims).  Generated claims carry their owner pod's uid
    (resourceclaim controller: created from pod claim templates, reserved
    for the pod while it runs, released and deleted when it finishes —
    pkg/controller/resourceclaim/controller.go)."""

    name: str
    namespace: str = "default"
    device_class: str = ""
    count: int = 1
    owner_pod_uid: str = ""  # "" = user-created standalone claim
    reserved_for: Tuple[str, ...] = ()  # status.reservedFor pod uids
    allocated: bool = False  # status.allocation present
    uid: str = ""

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"claim/{self.namespace}/{self.name}"

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class CertificateSigningRequest:
    """certificates.k8s.io/v1 — type CertificateSigningRequest: the kubelet
    serving/client certificate flow (cluster-scoped).  status: Pending ->
    Approved|Denied (approver policy) -> certificate issued (signer)."""

    name: str
    username: str = ""  # the requester (spec.username)
    groups: Tuple[str, ...] = ()
    signer_name: str = "kubernetes.io/kubelet-serving"
    usages: Tuple[str, ...] = ("digital signature", "server auth")
    status: str = "Pending"  # Pending | Approved | Denied
    certificate: str = ""  # status.certificate (issued by the signer)
    created_at: float = 0.0
    uid: str = ""

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"csr/{self.name}"

    @property
    def key(self) -> str:
        return self.name
