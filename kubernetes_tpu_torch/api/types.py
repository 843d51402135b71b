"""Cluster object model — the fields the scheduler reads.

This is the TPU framework's analog of the reference's API types
(staging/src/k8s.io/api/core/v1/types.go — type Pod, type Node) restricted to the
scheduling-relevant surface: resource requests/allocatable, labels, taints and
tolerations, node selectors and (anti-)affinity, topology-spread constraints,
priority, host ports, and scheduling gates.  Everything else (status machinery,
volumes-as-objects, probes, ...) belongs to components SURVEY.md §7 scopes out.

Quantities are plain integers in canonical units chosen by the caller (the
convention used throughout tests and benchmarks: cpu in millicores, memory in
bytes, pods/extended resources in counts).  The snapshot encoder rescales each
resource axis independently so values fit int32 exactly (api/snapshot.py).

The port's copy of the JAX package's ``api/types.py``, the same semantics with its imports
re-pointed at the port; tests/test_torch_*.py hold the two equal.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# Canonical well-known resource names (reference: pkg/api/v1/resource,
# noderesources/fit.go default resources).  Extended resources are any other key.
CPU = "cpu"
MEMORY = "memory"
PODS = "pods"
EPHEMERAL_STORAGE = "ephemeral-storage"
DEFAULT_RESOURCES: Tuple[str, ...] = (CPU, MEMORY)

ResourceList = Dict[str, int]

# Taint effects (reference: core/v1/types.go — TaintEffect).
NO_SCHEDULE = "NoSchedule"
PREFER_NO_SCHEDULE = "PreferNoSchedule"
NO_EXECUTE = "NoExecute"

# Selector operators (reference: core/v1/types.go — NodeSelectorOperator,
# metav1 LabelSelectorOperator).
OP_IN = "In"
OP_NOT_IN = "NotIn"
OP_EXISTS = "Exists"
OP_DOES_NOT_EXIST = "DoesNotExist"
OP_GT = "Gt"
OP_LT = "Lt"

# Topology-spread unsatisfiable policies (core/v1/types.go — UnsatisfiableConstraintAction).
DO_NOT_SCHEDULE = "DoNotSchedule"
SCHEDULE_ANYWAY = "ScheduleAnyway"

# Well-known topology label keys (component-helpers; used for default spread constraints).
LABEL_HOSTNAME = "kubernetes.io/hostname"
LABEL_ZONE = "topology.kubernetes.io/zone"
LABEL_REGION = "topology.kubernetes.io/region"


@dataclass(frozen=True)
class Taint:
    """reference: core/v1/types.go — type Taint."""

    key: str
    value: str = ""
    effect: str = NO_SCHEDULE


@dataclass(frozen=True)
class Toleration:
    """reference: core/v1/types.go — type Toleration.

    operator "Equal" matches key+value; "Exists" matches any value of key.
    Empty key with operator Exists tolerates everything.  Empty effect matches
    all effects.  (tolerationSeconds only matters for NoExecute eviction, which
    is the node-lifecycle controller's job, not filtering's; carried for parity.)
    """

    key: str = ""
    operator: str = "Equal"
    value: str = ""
    effect: str = ""
    toleration_seconds: Optional[int] = None

    def tolerates(self, taint: Taint) -> bool:
        # reference: component-helpers scheduling/corev1 — ToleratesTaint
        if self.effect and self.effect != taint.effect:
            return False
        if self.key and self.key != taint.key:
            return False
        if self.operator == OP_EXISTS:
            return True
        # Equal (default); empty key+Exists handled above via `self.key and ...`
        return self.value == taint.value


@dataclass(frozen=True)
class NodeSelectorRequirement:
    """reference: core/v1/types.go — type NodeSelectorRequirement."""

    key: str
    operator: str  # In | NotIn | Exists | DoesNotExist | Gt | Lt
    values: Tuple[str, ...] = ()


@dataclass(frozen=True)
class NodeSelectorTerm:
    """Conjunction of requirements; terms within a selector are ORed.

    reference: core/v1/types.go — type NodeSelectorTerm (matchFields folded into
    matchExpressions on the single supported field metadata.name).
    """

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
    """reference: apimachinery metav1 — type LabelSelector.

    match_labels is sugar for In-with-one-value requirements.  An empty selector
    matches everything; None (no selector) matches nothing.
    """

    match_labels: Tuple[Tuple[str, str], ...] = ()
    match_expressions: Tuple[LabelSelectorRequirement, ...] = ()

    @staticmethod
    def of(**labels: str) -> "LabelSelector":
        return LabelSelector(match_labels=tuple(sorted(labels.items())))

    def matches(self, labels: Dict[str, str]) -> bool:
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
    """reference: core/v1/types.go — type PodAffinityTerm."""

    topology_key: str
    label_selector: Optional[LabelSelector] = None
    namespaces: Tuple[str, ...] = ()  # empty => pod's own namespace


@dataclass(frozen=True)
class WeightedPodAffinityTerm:
    weight: int
    term: PodAffinityTerm = None  # type: ignore[assignment]


@dataclass(frozen=True)
class Affinity:
    """reference: core/v1/types.go — type Affinity (node + pod + podAntiAffinity)."""

    # nodeAffinity
    required_node_terms: Tuple[NodeSelectorTerm, ...] = ()  # ORed; empty => no constraint
    preferred_node_terms: Tuple[PreferredSchedulingTerm, ...] = ()
    # podAffinity / podAntiAffinity (requiredDuringSchedulingIgnoredDuringExecution)
    required_pod_affinity: Tuple[PodAffinityTerm, ...] = ()
    required_pod_anti_affinity: Tuple[PodAffinityTerm, ...] = ()
    preferred_pod_affinity: Tuple[WeightedPodAffinityTerm, ...] = ()
    preferred_pod_anti_affinity: Tuple[WeightedPodAffinityTerm, ...] = ()


@dataclass(frozen=True)
class TopologySpreadConstraint:
    """reference: core/v1/types.go — type TopologySpreadConstraint."""

    max_skew: int
    topology_key: str
    when_unsatisfiable: str = DO_NOT_SCHEDULE
    label_selector: Optional[LabelSelector] = None
    min_domains: Optional[int] = None


@dataclass(frozen=True)
class PersistentVolume:
    """Static-provisioned volume (core/v1 — type PersistentVolume), reduced to
    the scheduling-relevant surface: capacity, class, and topology (the node
    affinity the volume carries, typically a zone restriction)."""

    name: str
    capacity: int = 0  # bytes
    storage_class: str = ""
    # zone restriction: nodes must carry one of these (key, value) labels;
    # empty = accessible from everywhere
    allowed_topology: Tuple[Tuple[str, str], ...] = ()
    claim_ref: str = ""  # "namespace/name" of the bound PVC ("" = available)


@dataclass(frozen=True)
class PersistentVolumeClaim:
    """core/v1 — type PersistentVolumeClaim (scheduling surface)."""

    name: str
    namespace: str = "default"
    request: int = 0  # bytes
    storage_class: str = ""
    volume_name: str = ""  # pre-bound PV ("" = unbound)
    # WaitForFirstConsumer claims don't constrain scheduling (delayed binding)
    wait_for_first_consumer: bool = False
    # accessModes contains ReadWriteOncePod: at most ONE pod cluster-wide may
    # use the claim (volumerestrictions/volume_restrictions.go — the only
    # non-deprecated restriction the reference's plugin enforces)
    read_write_once_pod: bool = False

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass(frozen=True)
class ResourceClaimRef:
    """DRA-lite (resource.k8s.io ResourceClaim reduced to counted device
    classes — the dynamicresources plugin's schedulable core): a claim for
    `count` devices of `device_class`, modeled as extended resources."""

    device_class: str
    count: int = 1


@dataclass
class Node:
    """Scheduling view of a node.

    reference: core/v1/types.go — type Node + the scheduler's aggregation of it
    (pkg/scheduler/framework/types.go — type NodeInfo).
    """

    name: str
    allocatable: ResourceList = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    taints: Tuple[Taint, ...] = ()
    unschedulable: bool = False  # spec.unschedulable
    # spec.podCIDR — assigned by the NodeIPAM controller; the kubelet carves
    # pod IPs from it ("" = not yet assigned, kubelet falls back to a
    # process-local registry)
    pod_cidr: str = ""
    # image name -> size bytes present on the node (NodeStatus.Images;
    # ImageLocality's input)
    images: Dict[str, int] = field(default_factory=dict)
    # CSI attachable-volume limit (NodeVolumeLimits/csi.go); 0 = unlimited
    volume_attach_limit: int = 0
    # NodeStatus.VolumesAttached — PV names the attach/detach controller has
    # attached here (controllers.py — AttachDetachController)
    volumes_attached: Tuple[str, ...] = ()

    def __post_init__(self) -> None:
        self.labels.setdefault(LABEL_HOSTNAME, self.name)
        if type(self.taints) is not tuple:  # boundary normalization
            self.taints = tuple(self.taints)


@dataclass(frozen=True)
class OwnerReference:
    """metav1 — type OwnerReference (the GC graph edge + controller adoption)."""

    kind: str  # ReplicaSet | Deployment | Job | ...
    name: str
    uid: str
    controller: bool = True


# Pod phases (core/v1/types.go — type PodPhase); "" on a Pod means the phase
# machinery is not in play (bare scheduling harness objects)
PHASE_PENDING = "Pending"
PHASE_RUNNING = "Running"
PHASE_SUCCEEDED = "Succeeded"
PHASE_FAILED = "Failed"


@dataclass(frozen=True)
class Probe:
    """core/v1/types.go — type Probe (timing/threshold shape), reduced to
    what drives the hollow kubelet's prober: the reference's handler
    (httpGet/exec/tcpSocket) is replaced by a clock contract —
    `fail_after_seconds` > 0 means the probe starts FAILING once the
    container has been running that long (0 = always succeeds).  The
    kubemark trade, same as FakeCRI's run/crash knobs."""

    period_seconds: float = 10.0
    failure_threshold: int = 3
    # readiness only: a liveness probe with success_threshold != 1 is
    # rejected by Pod.__post_init__ (reference API validation)
    success_threshold: int = 1
    initial_delay_seconds: float = 0.0
    fail_after_seconds: float = 0.0  # hollow outcome knob


@dataclass
class Pod:
    """Scheduling view of a pod (pending or running).

    reference: core/v1/types.go — type Pod / PodSpec; requests aggregated the way
    pkg/scheduler/framework/plugins/noderesources — computePodResourceRequest does
    (max(sum(containers), initContainers) + overhead), which callers perform before
    constructing this object: `requests` here is the pod-level effective request.
    """

    name: str
    namespace: str = "default"
    requests: ResourceList = field(default_factory=dict)
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    node_name: str = ""  # spec.nodeName: "" = pending; set = bound/running
    # spec.schedulerName: selects the scheduling profile ("" = the default
    # profile).  Pods naming a profile this scheduler does not serve are
    # ignored entirely — another scheduler's responsibility
    # (schedule_one.go — frameworkForPod)
    scheduler_name: str = ""
    priority_class_name: str = ""  # resolved to `priority` by Priority admission
    pod_ip: str = ""  # status.podIP, assigned by the kubelet when Running
    # status.nominatedNodeName: set by preemption; the node this pod's victims
    # were evicted from, reserved against lower-priority competitors
    nominated_node_name: str = ""
    priority: int = 0
    tolerations: Tuple[Toleration, ...] = ()
    node_selector: Tuple[Tuple[str, str], ...] = ()  # spec.nodeSelector (AND of k=v)
    affinity: Optional[Affinity] = None
    topology_spread: Tuple[TopologySpreadConstraint, ...] = ()
    host_ports: Tuple[Tuple[str, int], ...] = ()  # (protocol, port)
    scheduling_gates: Tuple[str, ...] = ()
    pod_group: str = ""  # gang-scheduling group name ("" = none)
    images: Tuple[str, ...] = ()  # container images (ImageLocality's input)
    pvcs: Tuple[str, ...] = ()  # claimed PVC names (in the pod's namespace)
    resource_claims: Tuple[ResourceClaimRef, ...] = ()  # DRA-lite
    owner_references: Tuple[OwnerReference, ...] = ()  # GC graph + adoption
    # status.phase ("": phase machinery not in play — bound implies running)
    phase: str = ""
    # clock time the pod reached Succeeded/Failed (-1 = not finished or
    # untimed); stamped by the kubelet, consumed by PodGC's oldest-first sweep
    finished_at: float = -1.0
    # lifecycle knob for the hollow kubelet: pods whose workload completes
    # (Job pods) run for run_seconds then succeed; 0 = run forever
    run_seconds: float = 0.0
    # spec.restartPolicy (Always | OnFailure | Never) — what the kubelet's
    # pod worker does when the (hollow) container dies unexpectedly
    restart_policy: str = "Always"
    # fault-injection knob (hollow runtime): the container crashes this many
    # seconds after each (re)start; 0 = never crashes
    crash_after_seconds: float = 0.0
    # status.containerStatuses[0].restartCount, stamped by the kubelet
    restart_count: int = 0
    # spec.containers[0].{liveness,readiness}Probe — run by the kubelet's
    # prober (pkg/kubelet/prober); liveness failure restarts the container,
    # readiness gates the pod's Ready condition (and so EndpointSlices)
    liveness_probe: Optional[Probe] = None
    readiness_probe: Optional[Probe] = None
    # status.conditions[Ready] — True when no readiness probe is configured
    # (the reference defaults readiness true absent a probe).  A pending pod
    # WITH a readiness probe is forced False in __post_init__ (initial
    # readiness is Failure) and stays False until the kubelet's prober has
    # seen success_threshold consecutive passes
    ready: bool = True
    uid: str = ""

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"{self.namespace}/{self.name}"
        # reference API validation (core/validation — validateLivenessProbe):
        # a liveness probe's successThreshold must be 1; anything else is
        # rejected at admission, so reject it at construction here
        if (
            self.liveness_probe is not None
            and self.liveness_probe.success_threshold != 1
        ):
            raise ValueError(
                "liveness probe success_threshold must be 1 "
                f"(got {self.liveness_probe.success_threshold})"
            )
        # initial readiness is Failure under a readiness probe (the reference
        # holds the Ready condition false from creation until the probe has
        # passed success_threshold times) — without this a probed pod counts
        # Ready between bind and its first kubelet sync.  Only stamped on
        # still-pending pods: bound/running fixtures keep what they pass.
        if (
            self.readiness_probe is not None
            and not self.node_name
            and self.phase in ("", PHASE_PENDING)
        ):
            self.ready = False
        # Boundary normalization (the analog of apimachinery defaulting):
        # callers naturally pass lists / a dict nodeSelector; the encoder's
        # spec interner hashes these fields, so coerce them to the declared
        # tuple forms here rather than failing deep inside encode_snapshot.
        for f in (
            "tolerations", "topology_spread",
            "scheduling_gates", "images", "pvcs", "resource_claims",
            "owner_references",
        ):
            v = getattr(self, f)
            if type(v) is not tuple:
                setattr(self, f, tuple(v))
        # pair-valued fields coerce their inner pairs too (a list of
        # ["TCP", 80] pairs must hash); a dict nodeSelector sorts for a
        # canonical key
        if isinstance(self.node_selector, dict):
            self.node_selector = tuple(sorted(self.node_selector.items()))
        elif type(self.node_selector) is not tuple or any(
            type(kv) is not tuple for kv in self.node_selector
        ):
            self.node_selector = tuple(
                kv if type(kv) is tuple else tuple(kv)
                for kv in self.node_selector
            )
        if type(self.host_ports) is not tuple or any(
            type(pp) is not tuple for pp in self.host_ports
        ):
            self.host_ports = tuple(
                pp if type(pp) is tuple else tuple(pp)
                for pp in self.host_ports
            )


def pod_clone(pod: "Pod", **overrides) -> "Pod":
    """Shallow Pod clone: __new__ + __dict__ copy (~4x cheaper than
    copy.copy's reduce machinery at wave/bind rates), with field objects
    SHARED with the source — the invariant the encoder's identity-level
    interning and bind-absorb `is`-checks depend on.  THE one clone idiom:
    every hot path (store binding, sidecar wave decode, session bind
    copies) must route here so a future Pod change (slots, cached
    properties) has one place to fix."""
    q = Pod.__new__(Pod)
    d = pod.__dict__.copy()
    d.update(overrides)
    q.__dict__ = d
    return q


@dataclass(frozen=True)
class PodGroup:
    """Gang-scheduling group (analog of out-of-tree coscheduling PodGroup CRD;
    BASELINE config 5)."""

    name: str
    min_member: int


@dataclass
class ReplicaSet:
    """apps/v1 — type ReplicaSet (workload-controller surface): desired
    replicas + selector + pod template.  `template` is a prototype Pod whose
    name becomes the stamped pods' name prefix."""

    name: str
    namespace: str = "default"
    replicas: int = 1
    selector: Optional[LabelSelector] = None
    template: Optional["Pod"] = None
    owner_references: Tuple[OwnerReference, ...] = ()
    uid: str = ""
    # status
    ready_replicas: int = 0

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"rs/{self.namespace}/{self.name}"

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class Deployment:
    """apps/v1 — type Deployment: declarative rollout over ReplicaSets.
    Strategy reduced to RollingUpdate with maxSurge/maxUnavailable counts."""

    name: str
    namespace: str = "default"
    replicas: int = 1
    selector: Optional[LabelSelector] = None
    template: Optional["Pod"] = None
    max_surge: int = 1
    max_unavailable: int = 0
    uid: str = ""

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"deploy/{self.namespace}/{self.name}"

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"


@dataclass
class Job:
    """batch/v1 — type Job: run pods to completion (completions/parallelism).
    ttl_seconds_after_finished drives the TTL-after-finished controller."""

    name: str
    namespace: str = "default"
    completions: int = 1
    parallelism: int = 1
    template: Optional["Pod"] = None
    ttl_seconds_after_finished: Optional[int] = None
    owner_references: Tuple[OwnerReference, ...] = ()  # CronJob -> Job edge
    uid: str = ""
    # status
    succeeded: int = 0
    active: int = 0
    completion_time: float = -1.0  # clock time the job finished (-1 = not yet)

    def __post_init__(self) -> None:
        if not self.uid:
            self.uid = f"job/{self.namespace}/{self.name}"

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    @property
    def complete(self) -> bool:
        return self.succeeded >= self.completions


@dataclass
class PodDisruptionBudget:
    """policy/v1 — type PodDisruptionBudget, reduced to the scheduling surface
    the preemption evaluator reads (reference: defaultpreemption reads PDBs via
    a PDB lister and counts violations in SelectVictimsOnNode).

    Exactly one of min_available / max_unavailable is meaningful; both are
    absolute counts (the reference also accepts percentages, resolved against
    the expected count by the disruption controller — callers here pre-resolve).
    `disruptions_allowed` is status, maintained by the DisruptionController.
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
        return (
            pod.namespace == self.namespace
            and self.selector is not None
            and self.selector.matches(pod.labels)
        )
