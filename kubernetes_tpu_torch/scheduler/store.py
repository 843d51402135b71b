"""ClusterStore — the in-process cluster-state hub.

Plays the role the apiserver+etcd pair plays for the reference's scheduler in
scheduler_perf (SURVEY.md §3.5: real apiserver, in-process, nodes as bare API
objects): a strongly-ordered object store with monotonically increasing
resourceVersion and level-triggered watch fan-out (one event stream -> N
subscribers, the cacher pattern from apiserver/pkg/storage/cacher).

Besides the dedicated hot-path tables (nodes, pods, PDBs), the store carries a
**dynamic kind registry**: `register_kind()` creates a new keyed table with
full add/update/delete + watch semantics at runtime.  This is the framework's
CustomResourceDefinition mechanism (the apiextensions-apiserver analog —
reference: staging/src/k8s.io/apiextensions-apiserver serves user-defined
types through the same generic registry.Store the built-ins use); built-in
workload kinds (ReplicaSet, Deployment, Job, ...) are simply pre-registered
kinds in the same tables, exactly as CRDs and built-ins share one storage
layer in the reference.

Single-writer by design (one lock around mutations) — the framework's answer
to the reference's optimistic-concurrency CAS: there is exactly one scheduler
mutating bindings in-process, so CAS degenerates to serialized apply.

The port's copy of the JAX package's ``scheduler/store.py``: the same
tables, watch fan-out and event order (the Scheduler's decisions depend on
the order its queue receives pods).  One addition: ``pods_on_node``, a
node's bound pods from an index that every pod write keeps, so a hollow
kubelet's pod-IP search reads its own node's pods, not every pod.
"""

from __future__ import annotations

import uuid
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from ..api import types as t
from ..analysis.lockcheck import make_rlock


@dataclass(frozen=True)
class Event:
    kind: str  # Added | Modified | ModifiedStatus | Deleted
    obj_type: str  # Node | Pod | PDB | any registered kind
    obj: object
    resource_version: int
    # previous object on Modified events (QueueingHints compare old vs new —
    # framework/types.go ClusterEvent carries oldObj/newObj the same way)
    old: object = None


# kinds every store starts with (the reference's built-in API groups); more
# arrive via register_kind (the CRD path)
BUILTIN_KINDS = (
    "ReplicaSet",
    "Deployment",
    "Job",
    "StatefulSet",
    "DaemonSet",
    "CronJob",
    "Service",
    "EndpointSlice",
    "Namespace",
    "PriorityClass",
    "ResourceQuota",
    "LimitRange",
    "HorizontalPodAutoscaler",
    "Role",
    "RoleBinding",
    "FlowSchema",
    "PriorityLevelConfiguration",
    "StorageClass",
    "ResourceSlice",
    "DeviceClass",
    "ResourceClaim",
    "CertificateSigningRequest",
    "Event",
    "ServiceAccount",
)


def _key_of(obj) -> str:
    """namespace/name key (metav1 ObjectMeta identity)."""
    key = getattr(obj, "key", None)
    if key is not None:
        return key
    ns = getattr(obj, "namespace", "")
    name = getattr(obj, "name", "")
    return f"{ns}/{name}" if ns else name


class ClusterStore:
    def __init__(self) -> None:
        # re-entrant: watchers are invoked under the lock and may read back
        self._lock = make_rlock("ClusterStore._lock")
        self._rv = 0
        # cluster lineage: uids are deterministic (namespace/name), so a
        # crash-restart checkpoint written against ANOTHER store instance
        # could replay colliding uids into this one.  The checkpoint stamps
        # this id and restore() ignores a lineage mismatch — the analog of
        # the reference checking it is talking to the same cluster before
        # trusting local state.  Stable across restarts (the replacement
        # incarnation reattaches to the SAME store), unique per cluster.
        self.lineage = uuid.uuid4().hex
        self.nodes: Dict[str, t.Node] = {}
        self.pods: Dict[str, t.Pod] = {}  # by uid
        self.pdbs: Dict[str, t.PodDisruptionBudget] = {}  # by namespace/name
        self.pvs: Dict[str, t.PersistentVolume] = {}  # by name
        self.pvcs: Dict[str, t.PersistentVolumeClaim] = {}  # by namespace/name
        # the bound pods of `pods` by node as each pod write below left
        # them (pods_on_node): node name -> uids, and uid -> node name
        self._on_node: Dict[str, set] = {}
        self._node_of: Dict[str, str] = {}
        # dynamic kind registry: kind -> {key -> obj}
        self.objects: Dict[str, Dict[str, object]] = {k: {} for k in BUILTIN_KINDS}
        self._watchers: List[Callable[[Event], None]] = []

    def transaction(self):
        """The store's re-entrant lock, for callers performing multi-object
        read-modify-write sequences (e.g. volume binding's match-then-commit).
        The reference relies on apiserver optimistic concurrency
        (resourceVersion conflict on racing writers); this in-process analog
        serializes the sequence instead."""
        return self._lock

    # --- CRD mechanism ---
    def register_kind(self, kind: str) -> None:
        """Create a new object table at runtime — the CustomResourceDefinition
        path (apiextensions-apiserver: established CRDs get REST storage wired
        into the same generic registry as built-ins)."""
        with self._lock:
            if kind in ("Node", "Pod", "PDB"):
                raise ValueError(f"{kind} is a dedicated table")
            if kind not in self.objects:
                self.objects[kind] = {}

    def kinds(self) -> List[str]:
        return ["Node", "Pod", "PDB", *self.objects.keys()]

    # --- watch ---
    def watch(self, fn: Callable[[Event], None], replay: bool = True) -> None:
        """Subscribe; replay=True first delivers synthetic Added events for
        current state (the LIST half of LIST+WATCH)."""
        with self._lock:
            if replay:
                for nd in self.nodes.values():
                    fn(Event("Added", "Node", nd, self._rv))
                for p in self.pods.values():
                    fn(Event("Added", "Pod", p, self._rv))
                for pv in self.pvs.values():
                    fn(Event("Added", "PV", pv, self._rv))
                for pvc in self.pvcs.values():
                    fn(Event("Added", "PVC", pvc, self._rv))
            self._watchers.append(fn)

    def unwatch(self, fn: Callable[[Event], None]) -> None:
        """Drop a subscription (watch channel close) — no-op if absent."""
        with self._lock:
            try:
                self._watchers.remove(fn)
            except ValueError:
                pass

    def _emit(self, ev: Event) -> None:
        for fn in self._watchers:
            fn(ev)

    def _bump(self) -> int:
        self._rv += 1
        return self._rv

    # --- nodes ---
    def add_node(self, node: t.Node) -> None:
        with self._lock:
            self.nodes[node.name] = node
            self._emit(Event("Added", "Node", node, self._bump()))

    def update_node(self, node: t.Node) -> None:
        with self._lock:
            old = self.nodes.get(node.name)
            self.nodes[node.name] = node
            self._emit(Event("Modified", "Node", node, self._bump(), old=old))

    def delete_node(self, name: str) -> None:
        with self._lock:
            nd = self.nodes.pop(name, None)
            if nd is not None:
                self._emit(Event("Deleted", "Node", nd, self._bump()))

    # --- pods ---
    def _put_pod(self, pod: t.Pod) -> Optional[t.Pod]:
        """pods[pod.uid] = pod, the node index kept; the pod it replaced."""
        old = self.pods.get(pod.uid)
        self.pods[pod.uid] = pod
        self._unindex(pod.uid)
        if pod.node_name:
            self._on_node.setdefault(pod.node_name, set()).add(pod.uid)
            self._node_of[pod.uid] = pod.node_name
        return old

    def _unindex(self, uid: str) -> None:
        node = self._node_of.pop(uid, None)
        if node is not None:
            self._on_node[node].discard(uid)

    def add_pod(self, pod: t.Pod) -> None:
        with self._lock:
            self._put_pod(pod)
            self._emit(Event("Added", "Pod", pod, self._bump()))

    def update_pod(self, pod: t.Pod) -> None:
        with self._lock:
            old = self._put_pod(pod)
            self._emit(Event("Modified", "Pod", pod, self._bump(), old=old))

    def update_pod_status(self, pod: t.Pod) -> None:
        """The pods/{name}/status subresource: status-only writes (e.g.
        nominatedNodeName, phase) — watchers can tell them apart so the
        scheduler's queue does not treat them as spec changes (the reference's
        isPodUpdated check)."""
        with self._lock:
            self._put_pod(pod)
            self._emit(Event("ModifiedStatus", "Pod", pod, self._bump()))

    def delete_pod(self, uid: str) -> None:
        with self._lock:
            p = self.pods.pop(uid, None)
            if p is not None:
                self._unindex(uid)
                self._emit(Event("Deleted", "Pod", p, self._bump()))

    # --- generic objects (built-in workload kinds + CRDs) ---
    def _table(self, kind: str) -> Dict[str, object]:
        try:
            return self.objects[kind]
        except KeyError:
            raise KeyError(f"kind {kind!r} not registered (register_kind first)")

    def add_object(self, kind: str, obj) -> None:
        with self._lock:
            self._table(kind)[_key_of(obj)] = obj
            self._emit(Event("Added", kind, obj, self._bump()))

    def update_object(self, kind: str, obj) -> None:
        with self._lock:
            self._table(kind)[_key_of(obj)] = obj
            self._emit(Event("Modified", kind, obj, self._bump()))

    def delete_object(self, kind: str, key: str) -> None:
        with self._lock:
            obj = self._table(kind).pop(key, None)
            if obj is not None:
                self._emit(Event("Deleted", kind, obj, self._bump()))

    def get_object(self, kind: str, key: str):
        with self._lock:
            return self._table(kind).get(key)

    # --- snapshot LISTs (lock-consistent reads for concurrent components) ---
    # The dedicated tables (pods/nodes/pvs/pvcs) mutate IN PLACE under the
    # store lock; a component thread iterating .values() directly races the
    # writers ("dictionary changed size during iteration" under the soak).
    # Controllers, the proxier, kubelets and the apiserver take these
    # snapshots instead — the informer-cache LIST, one lock hold per pass.
    # Point reads (d.get(key)) stay lock-free: atomic under CPython.
    def list_pods(self) -> List[t.Pod]:
        with self._lock:
            return list(self.pods.values())

    def pods_on_node(self, node_name: str) -> List[t.Pod]:
        """The pods of list_pods() whose node_name is `node_name`, without
        a scan of every pod.  A pod whose node_name a caller set in place,
        with no store write, is seen only once a write stores it."""
        with self._lock:
            pods = (self.pods.get(uid) for uid in self._on_node.get(node_name, ()))
            return [p for p in pods if p is not None and p.node_name == node_name]

    def list_nodes(self) -> List[t.Node]:
        with self._lock:
            return list(self.nodes.values())

    def list_pvs(self) -> List[t.PersistentVolume]:
        with self._lock:
            return list(self.pvs.values())

    def list_pvcs(self) -> List[t.PersistentVolumeClaim]:
        with self._lock:
            return list(self.pvcs.values())

    def list_pdbs(self) -> List[t.PodDisruptionBudget]:
        with self._lock:
            return list(self.pdbs.values())

    def list_node_names(self) -> List[str]:
        with self._lock:
            return list(self.nodes)

    def list_objects(self, kind: str, namespace: Optional[str] = None) -> list:
        with self._lock:
            out = list(self._table(kind).values())
        if namespace is not None:
            out = [o for o in out if getattr(o, "namespace", "") == namespace]
        return out

    # --- workload aliases (original controller-facing API) ---
    @property
    def replicasets(self) -> Dict[str, t.ReplicaSet]:
        return self.objects["ReplicaSet"]  # type: ignore[return-value]

    @property
    def deployments(self) -> Dict[str, t.Deployment]:
        return self.objects["Deployment"]  # type: ignore[return-value]

    @property
    def jobs(self) -> Dict[str, t.Job]:
        return self.objects["Job"]  # type: ignore[return-value]

    def add_workload(self, kind: str, obj) -> None:
        self.add_object(kind, obj)

    def update_workload(self, kind: str, obj) -> None:
        self.update_object(kind, obj)

    def delete_workload(self, kind: str, key: str) -> None:
        self.delete_object(kind, key)

    # --- PodDisruptionBudgets (the preemption evaluator's PDB lister) ---
    def add_pdb(self, pdb: t.PodDisruptionBudget) -> None:
        with self._lock:
            self.pdbs[pdb.key] = pdb
            self._emit(Event("Added", "PDB", pdb, self._bump()))

    def update_pdb(self, pdb: t.PodDisruptionBudget) -> None:
        with self._lock:
            self.pdbs[pdb.key] = pdb
            self._emit(Event("Modified", "PDB", pdb, self._bump()))

    def delete_pdb(self, key: str) -> None:
        with self._lock:
            pdb = self.pdbs.pop(key, None)
            if pdb is not None:
                self._emit(Event("Deleted", "PDB", pdb, self._bump()))

    # --- storage objects (PV/PVC — the volumebinding plugin's informers) ---
    def add_pv(self, pv) -> None:
        with self._lock:
            self.pvs[pv.name] = pv
            self._emit(Event("Added", "PV", pv, self._bump()))

    def update_pv(self, pv) -> None:
        with self._lock:
            self.pvs[pv.name] = pv
            self._emit(Event("Modified", "PV", pv, self._bump()))

    def delete_pv(self, name: str) -> None:
        with self._lock:
            pv = self.pvs.pop(name, None)
            if pv is not None:
                self._emit(Event("Deleted", "PV", pv, self._bump()))

    def add_pvc(self, pvc) -> None:
        with self._lock:
            self.pvcs[pvc.key] = pvc
            self._emit(Event("Added", "PVC", pvc, self._bump()))

    def update_pvc(self, pvc) -> None:
        with self._lock:
            self.pvcs[pvc.key] = pvc
            self._emit(Event("Modified", "PVC", pvc, self._bump()))

    def delete_pvc(self, key: str) -> None:
        with self._lock:
            pvc = self.pvcs.pop(key, None)
            if pvc is not None:
                self._emit(Event("Deleted", "PVC", pvc, self._bump()))

    def bind(self, pod_uid: str, node_name: str) -> None:
        """The pods/{name}/binding subresource (defaultbinder's POST)."""
        with self._lock:
            p = self.pods[pod_uid]
            bound = replace_pod_nodename(p, node_name)
            self._put_pod(bound)
            self._emit(Event("Modified", "Pod", bound, self._bump()))


def replace_pod_nodename(pod: t.Pod, node_name: str) -> t.Pod:
    """Shallow copy with node_name set (types.pod_clone — the one shared
    clone idiom; field objects stay shared per copy-on-write)."""
    return t.pod_clone(pod, node_name=node_name)
