"""Cluster object model — the fields the scheduler reads.

The port's own copy of the JAX package's ``api/types.py`` object model,
restricted to what a scheduling snapshot carries: resource requests and
allocatable, labels, taints and tolerations, node selectors and
(anti-)affinity, topology-spread constraints, priority, host ports,
scheduling gates, volumes and claims.  Workload controllers and the kubelet's
lifecycle fields stay with the JAX package.

Quantities are plain integers in canonical units chosen by the caller (cpu in
millicores, memory in bytes, pods and extended resources in counts).  The
snapshot encoder rescales each resource axis independently so values fit
int32 exactly (api/snapshot.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

CPU = "cpu"
MEMORY = "memory"
PODS = "pods"
EPHEMERAL_STORAGE = "ephemeral-storage"
DEFAULT_RESOURCES: Tuple[str, ...] = (CPU, MEMORY)

ResourceList = Dict[str, int]

# Taint effects (core/v1/types.go — TaintEffect).
NO_SCHEDULE = "NoSchedule"
PREFER_NO_SCHEDULE = "PreferNoSchedule"
NO_EXECUTE = "NoExecute"

# Pod phases (core/v1/types.go — type PodPhase); "" on a Pod means the phase
# machinery is not in play (bound implies running).  Volume resolution
# (api/volumes.py) reads the terminal two: a finished pod releases its
# ReadWriteOncePod claim.
PHASE_PENDING = "Pending"
PHASE_RUNNING = "Running"
PHASE_SUCCEEDED = "Succeeded"
PHASE_FAILED = "Failed"

# Selector operators (core/v1/types.go — NodeSelectorOperator).
OP_IN = "In"
OP_NOT_IN = "NotIn"
OP_EXISTS = "Exists"
OP_DOES_NOT_EXIST = "DoesNotExist"
OP_GT = "Gt"
OP_LT = "Lt"

# Topology-spread unsatisfiable policies.
DO_NOT_SCHEDULE = "DoNotSchedule"
SCHEDULE_ANYWAY = "ScheduleAnyway"

LABEL_HOSTNAME = "kubernetes.io/hostname"
LABEL_ZONE = "topology.kubernetes.io/zone"
LABEL_REGION = "topology.kubernetes.io/region"


@dataclass(frozen=True)
class Taint:
    key: str
    value: str = ""
    effect: str = NO_SCHEDULE


@dataclass(frozen=True)
class Toleration:
    """operator "Equal" matches key+value; "Exists" matches any value of key.
    Empty key with operator Exists tolerates everything.  Empty effect matches
    all effects."""

    key: str = ""
    operator: str = "Equal"
    value: str = ""
    effect: str = ""
    toleration_seconds: Optional[int] = None

    def tolerates(self, taint: Taint) -> bool:
        # component-helpers scheduling/corev1 — ToleratesTaint
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if self.operator == OP_EXISTS:
            return True
        return self.value == taint.value


@dataclass(frozen=True)
class NodeSelectorRequirement:
    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist | Gt | Lt
    values: Tuple[str, ...] = ()


@dataclass(frozen=True)
class NodeSelectorTerm:
    """Conjunction of requirements; terms within a selector are ORed."""

    match_expressions: Tuple[NodeSelectorRequirement, ...] = ()


@dataclass(frozen=True)
class PreferredSchedulingTerm:
    weight: int
    preference: NodeSelectorTerm = field(default_factory=NodeSelectorTerm)


@dataclass(frozen=True)
class LabelSelectorRequirement:
    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist
    values: Tuple[str, ...] = ()


@dataclass(frozen=True)
class LabelSelector:
    """match_labels is sugar for In-with-one-value requirements."""

    match_labels: Tuple[Tuple[str, str], ...] = ()
    match_expressions: Tuple[LabelSelectorRequirement, ...] = ()

    @staticmethod
    def of(**labels: str) -> "LabelSelector":
        return LabelSelector(match_labels=tuple(sorted(labels.items())))

    def matches(self, labels: Dict[str, str]) -> bool:
        """An empty selector matches everything (a missing one, None, matches
        nothing: api/pairwise.py _matches)."""
        for k, v in self.match_labels:
            if labels.get(k) != v:
                return False
        for req in self.match_expressions:
            has = req.key in labels
            val = labels.get(req.key)
            if req.operator == OP_IN:
                if not has or val not in req.values:
                    return False
            elif req.operator == OP_NOT_IN:
                if has and val in req.values:
                    return False
            elif req.operator == OP_EXISTS:
                if not has:
                    return False
            elif req.operator == OP_DOES_NOT_EXIST:
                if has:
                    return False
            else:
                raise ValueError(f"bad label selector operator {req.operator}")
        return True


@dataclass(frozen=True)
class PodAffinityTerm:
    topology_key: str
    label_selector: Optional[LabelSelector] = None
    namespaces: Tuple[str, ...] = ()  # empty => pod's own namespace


@dataclass(frozen=True)
class WeightedPodAffinityTerm:
    weight: int
    term: PodAffinityTerm = None  # type: ignore[assignment]


@dataclass(frozen=True)
class Affinity:
    required_node_terms: Tuple[NodeSelectorTerm, ...] = ()  # ORed
    preferred_node_terms: Tuple[PreferredSchedulingTerm, ...] = ()
    required_pod_affinity: Tuple[PodAffinityTerm, ...] = ()
    required_pod_anti_affinity: Tuple[PodAffinityTerm, ...] = ()
    preferred_pod_affinity: Tuple[WeightedPodAffinityTerm, ...] = ()
    preferred_pod_anti_affinity: Tuple[WeightedPodAffinityTerm, ...] = ()


@dataclass(frozen=True)
class TopologySpreadConstraint:
    max_skew: int
    topology_key: str
    when_unsatisfiable: str = DO_NOT_SCHEDULE
    label_selector: Optional[LabelSelector] = None
    min_domains: Optional[int] = None


@dataclass(frozen=True)
class PersistentVolume:
    name: str
    capacity: int = 0
    storage_class: str = ""
    allowed_topology: Tuple[Tuple[str, str], ...] = ()
    claim_ref: str = ""


@dataclass(frozen=True)
class PersistentVolumeClaim:
    name: str
    namespace: str = "default"
    request: int = 0
    storage_class: str = ""
    volume_name: str = ""
    wait_for_first_consumer: bool = False
    read_write_once_pod: bool = False

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass(frozen=True)
class ResourceClaimRef:
    device_class: str
    count: int = 1


@dataclass
class Node:
    name: str
    allocatable: ResourceList = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    taints: Tuple[Taint, ...] = ()
    unschedulable: bool = False  # spec.unschedulable
    pod_cidr: str = ""
    images: Dict[str, int] = field(default_factory=dict)  # image -> bytes
    volume_attach_limit: int = 0  # 0 = unlimited
    volumes_attached: Tuple[str, ...] = ()

    def __post_init__(self) -> None:
        self.labels.setdefault(LABEL_HOSTNAME, self.name)
        if type(self.taints) is not tuple:
            self.taints = tuple(self.taints)


@dataclass
class Pod:
    """`requests` is the pod-level effective request."""

    name: str
    namespace: str = "default"
    requests: ResourceList = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    node_name: str = ""  # spec.nodeName: "" = pending; set = bound/running
    # spec.schedulerName: selects the scheduling profile ("" = the default
    # profile); pods naming no profile of a scheduler are not its to place
    scheduler_name: str = ""
    # status.nominatedNodeName: set by preemption, the node this pod's
    # victims were evicted from
    nominated_node_name: str = ""
    priority: int = 0
    tolerations: Tuple[Toleration, ...] = ()
    node_selector: Tuple[Tuple[str, str], ...] = ()  # spec.nodeSelector (AND of k=v)
    affinity: Optional[Affinity] = None
    topology_spread: Tuple[TopologySpreadConstraint, ...] = ()
    host_ports: Tuple[Tuple[str, int], ...] = ()  # (protocol, port)
    scheduling_gates: Tuple[str, ...] = ()
    pod_group: str = ""  # gang-scheduling group name ("" = none)
    images: Tuple[str, ...] = ()
    pvcs: Tuple[str, ...] = ()
    resource_claims: Tuple[ResourceClaimRef, ...] = ()
    uid: str = ""
    phase: str = ""  # status.phase

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"{self.namespace}/{self.name}"
        for f in ("tolerations", "topology_spread", "scheduling_gates", "images",
                  "pvcs", "resource_claims"):
            v = getattr(self, f)
            if type(v) is not tuple:
                setattr(self, f, tuple(v))
        if isinstance(self.node_selector, dict):
            self.node_selector = tuple(sorted(self.node_selector.items()))
        elif type(self.node_selector) is not tuple or any(
            type(kv) is not tuple for kv in self.node_selector
        ):
            self.node_selector = tuple(tuple(kv) for kv in self.node_selector)
        if type(self.host_ports) is not tuple or any(
            type(pp) is not tuple for pp in self.host_ports
        ):
            self.host_ports = tuple(tuple(pp) for pp in self.host_ports)


def pod_clone(pod: Pod, **overrides) -> Pod:
    """Shallow Pod clone: __new__ + __dict__ copy (about 4x cheaper than
    copy.copy at wave and bind rates), with field objects SHARED with the
    source: the invariant the encoder's identity-level interning and
    bind-absorb `is` checks rest on (the JAX package's types.pod_clone).
    The one clone idiom: the store's binding and the sidecar's wave decode
    both take it."""
    q = Pod.__new__(Pod)
    d = pod.__dict__.copy()
    d.update(overrides)
    q.__dict__ = d
    return q


@dataclass(frozen=True)
class PodGroup:
    name: str
    min_member: int


@dataclass
class PodDisruptionBudget:
    """policy/v1 — type PodDisruptionBudget, reduced to what the preemption
    evaluator reads (the JAX package's api/types.py:548).

    Exactly one of min_available / max_unavailable is meaningful; both are
    absolute counts.  `disruptions_allowed` is status, maintained by the
    disruption controller.
    """

    name: str
    namespace: str = "default"
    selector: Optional[LabelSelector] = None
    min_available: Optional[int] = None
    max_unavailable: Optional[int] = None
    # status (pkg/controller/disruption — updatePdbStatus)
    disruptions_allowed: int = 0
    current_healthy: int = 0
    desired_healthy: int = 0
    expected_pods: int = 0

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    def matches(self, pod: "Pod") -> bool:
        return pod.namespace == self.namespace and self.selector is not None and self.selector.matches(pod.labels)
