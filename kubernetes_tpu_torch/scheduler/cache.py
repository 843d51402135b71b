"""Scheduler cache: watch-driven NodeInfo aggregation + assumed pods.

Analog of pkg/scheduler/backend/cache/cache.go — cacheImpl: consumes store
events, maintains per-node NodeInfo (running pods, aggregated requests), and
an assumed-pod set so a bound-but-unconfirmed pod occupies capacity for later
cycles (AssumePod / FinishBinding / ForgetPod).  UpdateSnapshot produces the
api.Snapshot the encoder and the CPU path both consume.

The port's copy of the JAX package's ``scheduler/cache.py``.  The
checkpoint hook has no caller yet (checkpointing is ROADMAP A14).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set

from .. import chaos
from ..api import types as t
from ..api.snapshot import Snapshot
from .framework import NodeInfo
from .store import ClusterStore, Event, replace_pod_nodename
from ..analysis.lockcheck import make_lock


class SchedulerCache:
    def __init__(self, store: ClusterStore):
        self._lock = make_lock("SchedulerCache._lock")
        # crash-consistency hook (scheduler.py — _checkpoint_state): invoked
        # AFTER every assumed-ledger mutation, outside the cache lock, so the
        # reservation is durable before the bind path proceeds.  None = no
        # checkpointing (the port has no checkpoint yet).
        self.checkpoint_hook: Optional[Callable[[], None]] = None
        # kill-point router (scheduler.py — _kill_point): lets the owning
        # scheduler stamp kill.post_assume injections onto ITS tracer and
        # metrics (and latch _dead) like every other kill site; the bare
        # chaos.poke fallback keeps a standalone cache stormable
        self.kill_point: Optional[Callable[[str], None]] = None
        # registry kinds the snapshot LISTs at build time (StorageClass /
        # ResourceSlice / DeviceClass churn far less than pods; a per-cycle
        # LIST matches the reference's informer-cache read)
        self._store = store
        self.nodes: Dict[str, t.Node] = {}
        self.pods: Dict[str, t.Pod] = {}  # all pods by uid (pending + bound)
        self.assumed: Dict[str, str] = {}  # pod uid -> node (optimistic binds)
        self.pod_groups: Dict[str, t.PodGroup] = {}
        self.pvs: Dict[str, t.PersistentVolume] = {}
        self.pvcs: Dict[str, t.PersistentVolumeClaim] = {}
        store.watch(self._on_event)

    def _on_event(self, ev: Event) -> None:
        with self._lock:
            if ev.obj_type == "PV":
                if ev.kind == "Deleted":
                    self.pvs.pop(ev.obj.name, None)
                else:
                    self.pvs[ev.obj.name] = ev.obj
                return
            if ev.obj_type == "PVC":
                if ev.kind == "Deleted":
                    self.pvcs.pop(ev.obj.key, None)
                else:
                    self.pvcs[ev.obj.key] = ev.obj
                return
            if ev.obj_type == "Node":
                if ev.kind == "Deleted":
                    self.nodes.pop(ev.obj.name, None)
                else:
                    self.nodes[ev.obj.name] = ev.obj
            elif ev.obj_type == "Pod":
                if ev.kind == "Deleted":
                    self.pods.pop(ev.obj.uid, None)
                    self.assumed.pop(ev.obj.uid, None)
                else:
                    self.pods[ev.obj.uid] = ev.obj
                    if ev.obj.node_name and self.assumed.get(ev.obj.uid) == ev.obj.node_name:
                        # bind confirmed by the store: assumption retired
                        self.assumed.pop(ev.obj.uid, None)

    # --- assume cache (cache.go — AssumePod / ForgetPod / FinishBinding) ---
    def assume(self, pod_uid: str, node_name: str) -> None:
        with self._lock:
            self.assumed[pod_uid] = node_name
        # kill.post_assume: the enumerated kill point BETWEEN the in-memory
        # reservation and its durable checkpoint — a restart must requeue
        # the pod (the ledger on disk never saw it)
        kp = self.kill_point
        if kp is not None:
            kp("kill.post_assume")
        elif chaos.enabled():
            chaos.poke("kill.post_assume")
        self._checkpoint()

    def forget(self, pod_uid: str) -> None:
        with self._lock:
            dropped = self.assumed.pop(pod_uid, None) is not None
        if dropped:
            self._checkpoint()

    def _checkpoint(self) -> None:
        """Persist the assumed-pod ledger at every reservation change
        (checkpoint.py — fsync'd atomic-rename; the hook snapshots the
        ledger itself).  Called OUTSIDE the cache lock: the hook reads
        assumed via assumed_snapshot(), and file IO under the cache lock
        would serialize every concurrent binding worker behind fsync."""
        hook = self.checkpoint_hook
        if hook is not None:
            hook()

    def assumed_snapshot(self) -> Dict[str, str]:
        """Lock-consistent copy of the assumed ledger (the checkpoint's
        read side)."""
        with self._lock:
            return dict(self.assumed)

    def _effective_node(self, pod: t.Pod) -> str:
        return pod.node_name or self.assumed.get(pod.uid, "")

    def update_snapshot(self) -> Snapshot:
        """Snapshot for the batch/TPU path: bound = running + assumed pods."""
        # LIST the registry kinds BEFORE taking the cache lock: the store lock
        # is held inside list_objects, and store->watcher->_on_event already
        # acquires cache._lock under the store lock — taking them here in the
        # opposite order would be an ABBA inversion
        storage_classes = {
            sc.name: sc for sc in self._store.list_objects("StorageClass")
        }
        resource_slices = self._store.list_objects("ResourceSlice")
        device_classes = {
            dc.name: dc for dc in self._store.list_objects("DeviceClass")
        }
        with self._lock:
            nodes = list(self.nodes.values())
            pending, bound = [], []
            for p in self.pods.values():
                if p.phase in (t.PHASE_SUCCEEDED, t.PHASE_FAILED):
                    continue  # terminated pods release their capacity
                node = self._effective_node(p)
                if node:
                    q = p if p.node_name else replace_pod_nodename(p, node)
                    bound.append(q)
                else:
                    pending.append(p)
            return Snapshot(
                nodes=nodes,
                pending_pods=pending,
                bound_pods=bound,
                pod_groups=dict(self.pod_groups),
                pvs=list(self.pvs.values()),
                pvcs=dict(self.pvcs),
                storage_classes=storage_classes,
                resource_slices=resource_slices,
                device_classes=device_classes,
            )

    def node_infos(self, snap: Snapshot) -> List[NodeInfo]:
        return node_infos(snap)


def node_infos(snap: Snapshot) -> List[NodeInfo]:
    """Per-node NodeInfo of a snapshot's bound pods, in node order (the
    cache's node_infos, which also serves bench/preempt_bench.py's
    failure cycle, which has no cache)."""
    from ..api.snapshot import _resource_axis

    resources = _resource_axis(snap)
    infos = {nd.name: NodeInfo(node=nd) for nd in snap.nodes}
    for q in snap.bound_pods:
        if q.node_name in infos:
            infos[q.node_name].add_pod(q, resources)
    return list(infos.values())
