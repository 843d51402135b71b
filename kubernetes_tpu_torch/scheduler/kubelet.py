"""Hollow kubelet — the kubemark analog, with the reference kubelet's actual
control structure (SURVEY.md §2.3 kubelet row; §3.4 call stack):

  - WATCH-driven config source: the kubelet subscribes to the store and
    routes only pods with spec.nodeName == me to per-pod WORKERS
    (pkg/kubelet/kubelet.go — syncLoop's config channel; config/apiserver.go).
    No O(cluster) scans per tick.
  - POD WORKERS: one serialized state machine per pod UID
    (pkg/kubelet/pod_workers.go — type podWorkers: per-pod goroutine fed by a
    channel; here a per-UID worker object whose update() entries apply in
    arrival order).  Workers own admission (device allocation), start,
    completion, crash/restart, and teardown.
  - CRI BOUNDARY: all container work goes through the RuntimeService/
    ImageService protocols (scheduler/cri.py — the cri-api analog): pull
    images, RunPodSandbox (the sandbox owns the pod IP, as the CNI result
    the runtime reports), CreateContainer/StartContainer, and the
    stop-container -> stop-sandbox -> remove teardown ordering
    (kuberuntime_manager.go — SyncPod/killPodWithSyncResult).  The wired
    implementation is FakeCRI — clock-driven containers, the kubemark
    trade (pkg/kubemark/hollow_kubelet.go) — but the kubelet would run
    unchanged against a remote runtime speaking the same protocols.
  - PLEG: the Pod Lifecycle Event Generator relists CRI container states
    and emits ContainerStarted/ContainerDied events that drive workers,
    exactly the reference's generic PLEG relist (pkg/kubelet/pleg/
    generic.go — func (g *GenericPLEG) Relist), keyed on (container id,
    state) so a restarted container's crash is a fresh event.
  - restartPolicy: a died container restarts (restartCount++, a NEW
    container at attempt+1) under Always / OnFailure-with-nonzero-exit,
    else the pod goes Succeeded/Failed (kuberuntime_manager.go —
    computePodActions' ShouldContainerBeRestarted).
  - node Lease heartbeat per tick (pkg/kubelet/nodelease), consumed by the
    NodeLifecycleController for failure detection; pulled images publish
    to NodeStatus.Images (what ImageLocality scores against).

Phase transitions publish through the pods/status subresource so the
scheduler's queue never mistakes them for spec changes.

The port's copy of the JAX package's ``scheduler/kubelet.py``, the same semantics with its imports
re-pointed at the port; tests/test_torch_*.py hold the two equal.  One
change: ``_alloc_ip`` reads the in-use addresses from the store's
``pods_on_node`` instead of filtering every pod (the same set wherever a
pod's node is set by a store write, as every component here sets it; so the
same lowest free address), which makes a pod start O(node pods), not
O(pods).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple
from weakref import WeakKeyDictionary

from .. import chaos
from ..api import types as t
from . import cri as cri_mod
from .cri import (
    CONTAINER_EXITED,
    CONTAINER_RUNNING,
    ContainerConfig,
    CRIError,
    FakeCRI,
    PodSandboxConfig,
)
from .leases import LeaseStore
from .queue import Clock
from .store import ClusterStore, Event

# store -> {node_name: dense index}.  Scoping CIDR indices to the store (not
# the allocator instance) keeps per-node /24s disjoint even when several
# HollowClusters / standalone HollowKubelets share one store, and gives the
# same node the same subnet across kubelet restarts.
_CIDR_REGISTRY: "WeakKeyDictionary[ClusterStore, Dict[str, int]]" = WeakKeyDictionary()


def _cidr_index_for(store: ClusterStore, node_name: str) -> int:
    table = _CIDR_REGISTRY.setdefault(store, {})
    if node_name not in table:
        table[node_name] = len(table)
    return table[node_name]


@dataclass
class _PodWorker:
    """pod_workers.go — one serialized lifecycle machine per pod UID.  The
    worker owns the pod's sync state; updates apply in arrival order (the
    reference serializes via a per-pod channel; in-process, call order IS
    arrival order)."""

    pod: t.Pod
    admitted: bool = False
    terminated: bool = False  # reached Succeeded/Failed
    restarts: int = 0
    sandbox_id: str = ""  # CRI objects this worker owns
    container_id: str = ""


class PLEG:
    """pleg/generic.go — Relist: diff CRI container states (through
    RuntimeService.list_containers, nothing else) against the previous
    relist and emit lifecycle events.  Keyed on (container id, state):
    restarts create a NEW container, so a crash of the replacement is a
    fresh event even when the previous relist also saw an exited state."""

    def __init__(self, runtime: "cri_mod.RuntimeService"):
        self.runtime = runtime
        self._last: Dict[str, Tuple[str, str]] = {}

    def relist(self) -> List[Tuple[str, str]]:
        events: List[Tuple[str, str]] = []
        cur: Dict[str, Tuple[str, str]] = {}
        attempts: Dict[str, int] = {}
        for cs in self.runtime.list_containers():
            # newest ATTEMPT wins (ids are runtime-assigned and carry no
            # ordering contract — a remote runtime's are hashes)
            if cs.pod_uid not in cur or cs.attempt > attempts[cs.pod_uid]:
                cur[cs.pod_uid] = (cs.id, cs.state)
                attempts[cs.pod_uid] = cs.attempt
        for uid, (cid, state) in cur.items():
            if self._last.get(uid) != (cid, state):
                if state == CONTAINER_RUNNING:
                    events.append((uid, "ContainerStarted"))
                elif state == CONTAINER_EXITED:
                    events.append((uid, "ContainerDied"))
        for uid in self._last:
            if uid not in cur:
                events.append((uid, "ContainerRemoved"))
        self._last = cur
        return events


@dataclass
class _ProbeState:
    """One prober worker's result state (prober/worker.go — type worker:
    onHold/resultRun counters), keyed to a CONTAINER: a restarted container
    gets fresh counters (the reference spawns a new worker per container)."""

    container_id: str
    last_probe: float = float("-inf")
    fails: int = 0
    successes: int = 0
    result: Optional[bool] = None  # None = no result yet (probing not begun)


class ProbeManager:
    """prober/prober_manager.go — liveness/readiness probes, clock-driven.

    The reference runs one prober worker goroutine per (pod, container,
    probe kind), each ticking on its probe's period and feeding a results
    manager the kubelet's sync loop consults.  Here sync() is called from
    the kubelet's tick for each running worker: it runs whichever probes
    are DUE (period elapsed, initial delay passed) and returns the two
    consumable signals — "liveness says kill" and the pod's readiness.

    Probe outcomes come from the hollow contract on api.types.Probe
    (fail_after_seconds), the same clock trade FakeCRI makes for container
    lifecycles; thresholds and periods behave as the reference's
    (worker.go — doProbe: failure_threshold consecutive failures flip the
    result, success_threshold consecutive successes flip it back)."""

    def __init__(self, runtime: "cri_mod.RuntimeService", clock: Clock):
        self.runtime = runtime
        self.clock = clock
        self._state: Dict[Tuple[str, str], _ProbeState] = {}

    def remove(self, pod_uid: str) -> None:
        for kind in ("liveness", "readiness"):
            self._state.pop((pod_uid, kind), None)

    def _probe_one(self, w: "_PodWorker", kind: str,
                   probe: t.Probe, started_at: float) -> Optional[bool]:
        key = (w.pod.uid, kind)
        st = self._state.get(key)
        if st is None or st.container_id != w.container_id:
            st = self._state[key] = _ProbeState(container_id=w.container_id)
        now = self.clock.now()
        if now - started_at < probe.initial_delay_seconds:
            return st.result
        if now - st.last_probe >= probe.period_seconds:
            st.last_probe = now
            ok = not (
                probe.fail_after_seconds > 0
                and now - started_at >= probe.fail_after_seconds
            )
            if ok:
                st.successes += 1
                st.fails = 0
                if st.successes >= probe.success_threshold:
                    st.result = True
            else:
                st.fails += 1
                st.successes = 0
                if st.fails >= probe.failure_threshold:
                    st.result = False
        return st.result

    def sync(self, w: "_PodWorker") -> Tuple[bool, bool]:
        """Run due probes for this worker's current container.  Returns
        (liveness_kill, pod_ready).  No readiness probe -> always ready;
        a readiness probe holds the pod NOT ready until it has passed
        success_threshold times (the reference's initial readiness is
        Failure until proven)."""
        pod = w.pod
        if pod.liveness_probe is None and pod.readiness_probe is None:
            return False, True
        try:
            status = self.runtime.container_status(w.container_id)
        except CRIError:
            return False, pod.readiness_probe is None
        if status.state != CONTAINER_RUNNING:
            return False, pod.readiness_probe is None
        kill = False
        if pod.liveness_probe is not None:
            res = self._probe_one(w, "liveness", pod.liveness_probe,
                                  status.started_at)
            kill = res is False
        ready = True
        if pod.readiness_probe is not None:
            ready = self._probe_one(
                w, "readiness", pod.readiness_probe, status.started_at
            ) is True
        return kill, ready


class VolumeManager:
    """pkg/kubelet/volumemanager — the kubelet-side half of volume
    lifecycle: desired state (the volumes of admitted pods) reconciled
    against actual state (what is attached and mounted on THIS node).

    The control-plane half is the AttachDetachController, which converges
    NodeStatus.VolumesAttached; this manager's WaitForAttachAndMount
    (volumemanager/volume_manager.go) blocks a pod's containers until
    every PV its PVCs resolve to appears in that set, then records the
    mount.  Unmount happens at pod teardown; detach is again the
    controller's job once the last using pod leaves.  Hollow trade: mounts
    are bookkeeping (no filesystem), matching FakeCRI's container trade."""

    def __init__(self, store: ClusterStore, node_name: str):
        self.store = store
        self.node_name = node_name
        self.mounted: Dict[str, Tuple[str, ...]] = {}  # pod uid -> PV names

    def _resolve_pvs(self, pod: t.Pod) -> Optional[Tuple[str, ...]]:
        """PV names behind the pod's PVCs, or None while any claim is
        unbound (the volume binder / provisioner has not landed yet)."""
        pvs = []
        pv_by_claim = None
        for claim in pod.pvcs:
            key = f"{pod.namespace}/{claim}"
            pvc = self.store.pvcs.get(key)
            name = pvc.volume_name if pvc is not None else ""
            if not name:
                if pv_by_claim is None:
                    pv_by_claim = {
                        pv.claim_ref: pv.name
                        for pv in self.store.list_pvs()
                        if pv.claim_ref
                    }
                name = pv_by_claim.get(key, "")
            if not name:
                return None
            pvs.append(name)
        return tuple(pvs)

    def wait_for_attach_and_mount(self, pod: t.Pod) -> bool:
        """True once every volume is attached here AND recorded mounted —
        the SyncPod gate (kubelet.go calls this before containers)."""
        if not pod.pvcs:
            return True
        pvs = self._resolve_pvs(pod)
        if pvs is None:
            return False
        node = self.store.nodes.get(self.node_name)
        attached = set(node.volumes_attached) if node is not None else set()
        if not all(pv in attached for pv in pvs):
            return False
        self.mounted[pod.uid] = pvs
        return True

    def unmount(self, pod_uid: str) -> None:
        self.mounted.pop(pod_uid, None)


class HollowKubelet:
    def __init__(
        self,
        store: ClusterStore,
        leases: LeaseStore,
        node_name: str,
        clock: Optional[Clock] = None,
        pod_cidr_index: Optional[int] = None,
        checkpoint_dir: Optional[str] = None,
        tracer=None,
    ):
        from .checkpoint import CheckpointManager
        from .devicemanager import DeviceManager
        from .tracing import Tracer

        self.store = store
        self.leases = leases
        self.node_name = node_name
        self.clock = clock or leases.clock
        # pod syncs join the pod's trace via the collector's pod-context
        # table (component-base/tracing: the kubelet's syncPod spans)
        self.tracer = tracer or Tracer(component="kubelet")
        self.workers: Dict[str, _PodWorker] = {}  # pod_workers.go map
        # the CRI boundary: everything container-shaped goes through these
        # two protocol objects (FakeCRI implements both — the kubemark
        # runtime; the sandbox IP callback is the CNI-result analog)
        self.cri = FakeCRI(self.clock, ip_alloc=lambda uid: self._alloc_ip())
        self.runtime: "cri_mod.RuntimeService" = self.cri
        self.images: "cri_mod.ImageService" = self.cri
        self.pleg = PLEG(self.runtime)
        self.prober = ProbeManager(self.runtime, self.clock)
        self.sync_failures = 0  # syncs contained by the tick loop's catch
        self.volumemanager = VolumeManager(store, node_name)
        # cm/devicemanager analog: concrete device IDs per admitted pod,
        # checkpointed when a directory is given (restart-safe allocations)
        self.devices = DeviceManager(
            node_name,
            CheckpointManager(checkpoint_dir) if checkpoint_dir else None,
        )
        # cm/cpumanager static policy + the eviction manager (scheduler/cm.py)
        from .cm import CPUManagerStatic, EvictionManager

        node = store.nodes.get(node_name)
        n_cpus = (
            node.allocatable.get(t.CPU, 0) // 1000 if node is not None else 0
        )
        self.cpumanager = CPUManagerStatic(
            n_cpus,
            CheckpointManager(checkpoint_dir) if checkpoint_dir else None,
            node_name,
        )
        self.eviction = EvictionManager(
            store, node_name, pod_uids=lambda: list(self.workers)
        )
        self._cidr_index = (
            pod_cidr_index
            if pod_cidr_index is not None
            else _cidr_index_for(store, node_name)
        )
        # TLS bootstrap analog (pkg/kubelet/certificate — the serving-cert
        # manager): file a CertificateSigningRequest on startup; the
        # Certificates controller approves+signs it and serving_certificate
        # returns the issued cert once available
        self._csr_name = f"{node_name}-serving"
        try:
            from ..api import cluster as c

            if store.get_object(
                "CertificateSigningRequest", self._csr_name
            ) is None:
                store.add_object(
                    "CertificateSigningRequest",
                    c.CertificateSigningRequest(
                        name=self._csr_name,
                        username=f"system:node:{node_name}",
                        groups=("system:nodes",),
                    ),
                )
        except KeyError:
            pass  # stores without the kind registered (reduced harnesses)
        # config source: route my pods' watch events to workers — the
        # kubelet's syncLoop 'config updates' channel.  Seed from a LIST
        # (informer semantics), then stay event-driven.
        for pod in store.list_pods():
            if pod.node_name == self.node_name:
                self._dispatch(pod, removed=False)
        store.watch(self._on_event, replay=False)  # seeded above: my pods only

    # --- config channel ---
    def _on_event(self, ev: Event) -> None:
        if ev.obj_type != "Pod":
            return
        pod = ev.obj
        if ev.kind == "Deleted":
            if pod.uid in self.workers:
                self._dispatch(pod, removed=True)
        elif getattr(pod, "node_name", "") == self.node_name:
            self._dispatch(pod, removed=False)

    def _teardown(self, w: _PodWorker) -> None:
        """killPodWithSyncResult's ordering: stop container -> remove
        container -> stop sandbox -> remove sandbox, then release devices.
        Container and sandbox steps swallow CRIError INDEPENDENTLY: a
        container already gone must not orphan its sandbox (which would
        stay in list_pod_sandboxes, IP held, forever)."""
        try:
            if w.container_id:
                self.runtime.stop_container(w.container_id)
                self.runtime.remove_container(w.container_id)
        except CRIError:
            pass  # already gone (crash-only: teardown is idempotent)
        try:
            if w.sandbox_id:
                self.runtime.stop_pod_sandbox(w.sandbox_id)
                self.runtime.remove_pod_sandbox(w.sandbox_id)
        except CRIError:
            pass
        w.container_id = w.sandbox_id = ""
        self.devices.free(w.pod.uid)
        self.cpumanager.free(w.pod.uid)
        self.prober.remove(w.pod.uid)
        self.volumemanager.unmount(w.pod.uid)

    def _dispatch(self, pod: t.Pod, removed: bool) -> None:
        """UpdatePod (pod_workers.go): create/feed the pod's worker."""
        if removed:
            w = self.workers.pop(pod.uid, None)
            if w is not None:
                self._teardown(w)
            return
        w = self.workers.get(pod.uid)
        if w is None:
            w = self.workers[pod.uid] = _PodWorker(pod=pod)
        else:
            w.pod = pod
        if pod.phase in (t.PHASE_SUCCEEDED, t.PHASE_FAILED):
            w.terminated = True
            self._teardown(w)

    # --- the sync loop ---
    def tick(self) -> None:
        """One syncLoop iteration (syncLoopIteration's channel fan-in,
        sequenced): heartbeat, runtime advance, PLEG relist -> worker syncs,
        then housekeeping."""
        self.leases.renew_node_heartbeat(self.node_name)
        if not getattr(self, "_serving_cert", ""):
            # cache the issued serving cert EAGERLY (the CSR cleaner GCs
            # the request after its TTL); if the CSR vanished unissued,
            # re-file it (certificate manager rotation loop)
            if not self.serving_certificate():
                try:
                    from ..api import cluster as c

                    if self.store.get_object(
                        "CertificateSigningRequest", self._csr_name
                    ) is None:
                        self.store.add_object(
                            "CertificateSigningRequest",
                            c.CertificateSigningRequest(
                                name=self._csr_name,
                                username=f"system:node:{self.node_name}",
                                groups=("system:nodes",),
                            ),
                        )
                except KeyError:
                    pass
        self.cri.tick()  # the fake runtime's own event loop
        # node-pressure eviction BEFORE new syncs (the reference's eviction
        # manager runs on its own loop; per-tick ordering here keeps an
        # overcommitted node from starting even more work)
        self.eviction.synchronize()
        # PLEG events drive workers (syncLoopIteration's plegCh case)
        for uid, what in self.pleg.relist():
            w = self.workers.get(uid)
            if w is None or w.terminated:
                continue
            if what == "ContainerDied":
                self._sync_died(w)
        # config-driven syncs: admit + start pods whose worker is fresh.
        # Crash-consistent: one worker's sync dying (a CRI hiccup, an
        # injected kubelet.sync crash) must neither kill the tick loop nor
        # strand the pod — partial admission rolls back (devices/cpu freed,
        # admitted reset) and the un-admitted worker retries next tick.
        for uid, w in list(self.workers.items()):
            if w.terminated or w.admitted:
                continue
            try:
                self._sync_start(w)
            except Exception as e:  # noqa: BLE001 — per-pod containment
                self.sync_failures += 1
                if w.admitted:
                    # roll back the partial admission COMPLETELY through the
                    # CRI teardown path: an already-created sandbox (and its
                    # pod IP) must not orphan in the runtime while the retry
                    # creates a second one — teardown also frees devices,
                    # exclusive CPUs, probe state and mounts, idempotently
                    self._teardown(w)
                    w.admitted = False
                chaos.record_recovery(
                    "kubelet.sync", "retry_next_tick", tracer=self.tracer,
                    pod=uid, node=self.node_name, error=type(e).__name__,
                )
        # prober (prober_manager): due probes for every running container.
        # Liveness failure kills the container and routes through the SAME
        # died path as a crash (computePodActions sees an exited container;
        # restartPolicy decides restart vs pod failure); readiness feeds
        # the pod's Ready condition, which EndpointSlice consumes.
        for uid, w in list(self.workers.items()):
            if w.terminated or not w.admitted or not w.container_id:
                continue
            kill, ready = self.prober.sync(w)
            if kill:
                try:
                    self.runtime.stop_container(w.container_id)
                except CRIError:
                    pass
                self._sync_died(w)
                continue
            cur = self.store.pods.get(uid)
            if cur is not None and cur.ready != ready:
                q = self._status_copy(w.pod)
                q.ready = ready
                self.store.update_pod_status(q)
        # housekeeping (housekeepingCh): drop terminated workers whose pod
        # left the store (deletion events already handled; belt & braces),
        # and reclaim checkpoint-restored device allocations whose pod
        # vanished while the kubelet was down (no worker, no Deleted event)
        for uid in list(self.workers):
            if uid not in self.store.pods:
                self._dispatch(self.workers[uid].pod, removed=True)
        for uid in list(self.devices.allocations):
            cur = self.store.pods.get(uid)
            if cur is None or cur.node_name != self.node_name:
                self.devices.free(uid)
        for uid in list(self.cpumanager.assignments):
            cur = self.store.pods.get(uid)
            if cur is None or cur.node_name != self.node_name:
                self.cpumanager.free(uid)

    def serving_certificate(self) -> str:
        """The issued serving certificate, "" until the Certificates
        controller has approved and signed this kubelet's bootstrap CSR.
        Cached once observed: the CSR cleaner GCs issued requests after its
        TTL (certificate_controller's cleaner), but the cert itself lives
        with the kubelet."""
        if getattr(self, "_serving_cert", ""):
            return self._serving_cert
        try:
            csr = self.store.get_object(
                "CertificateSigningRequest", self._csr_name
            )
        except KeyError:
            return ""
        self._serving_cert = csr.certificate if csr is not None else ""
        return self._serving_cert

    def close(self) -> None:
        """Detach from the store's watch fan-out (a removed/restarted hollow
        node must stop consuming events — and being retained — forever)."""
        self.store.unwatch(self._on_event)

    # --- worker syncs (kuberuntime_manager.go — SyncPod over the CRI) ---
    def _start_container(self, w: _PodWorker) -> None:
        """CreateContainer + StartContainer inside the worker's sandbox."""
        pod = w.pod
        w.container_id = self.runtime.create_container(
            w.sandbox_id,
            ContainerConfig(
                name="main",
                image=pod.images[0] if pod.images else "",
                run_seconds=pod.run_seconds,
                crash_after_seconds=pod.crash_after_seconds,
            ),
        )
        self.runtime.start_container(w.container_id)

    def _sync_start(self, w: _PodWorker) -> None:
        """Traced SyncPod entry: admission + volumes + sandbox + containers
        under one kubelet.sync span chained onto the pod's trace."""
        if not self.tracer.enabled:
            return self._sync_start_inner(w)
        with self.tracer.span_for_pod(
            w.pod.uid, "kubelet.sync", pod=w.pod.uid, node=self.node_name
        ) as sp:
            self._sync_start_inner(w)
            if sp is not None:
                sp.attributes["admitted"] = w.admitted

    def _sync_start_inner(self, w: _PodWorker) -> None:
        pod = w.pod
        if pod.phase in (t.PHASE_SUCCEEDED, t.PHASE_FAILED):
            w.terminated = True
            return
        if chaos.enabled():
            # injected sync crash: contained by tick()'s per-worker catch
            chaos.poke("kubelet.sync", tracer=self.tracer,
                       pod=pod.uid, node=self.node_name)
        # WaitForAttachAndMount gates SyncPod: containers must not start
        # until the AttachDetach controller has attached every volume here
        # (checked BEFORE device/cpu allocation so nothing is held while
        # waiting; un-admitted workers retry next tick)
        if not self.volumemanager.wait_for_attach_and_mount(pod):
            return
        if pod.resource_claims:
            from .devicemanager import AllocationError

            slices = self.store.list_objects("ResourceSlice")
            classes = {dc.name: dc for dc in self.store.list_objects("DeviceClass")}
            try:
                self.devices.allocate(pod, slices, classes)
            except AllocationError:
                # UnexpectedAdmissionError: the pod fails on the node
                w.terminated = True
                self._set_phase(pod, t.PHASE_FAILED)
                return
        from .cm import CPUAllocationError

        try:
            # exclusive cores for integer-CPU pods (cpumanager static
            # policy); fragmentation -> the same UnexpectedAdmissionError
            # path as devices
            self.cpumanager.allocate(pod)
        except CPUAllocationError:
            w.terminated = True
            self.devices.free(pod.uid)
            self._set_phase(pod, t.PHASE_FAILED)
            return
        w.admitted = True
        # SyncPod: EnsureImagesExist -> RunPodSandbox -> containers
        for img in pod.images:
            self.images.pull_image(img)
        if pod.images:
            self._publish_images()
        w.sandbox_id = self.runtime.run_pod_sandbox(
            PodSandboxConfig(
                pod_uid=pod.uid, pod_name=pod.name, namespace=pod.namespace
            )
        )
        self._start_container(w)
        # the sandbox owns the pod IP (the CNI result the runtime reports)
        ip = self.runtime.pod_sandbox_status(w.sandbox_id).ip
        self._set_phase(pod, t.PHASE_RUNNING, pod_ip=ip)

    def _sync_died(self, w: _PodWorker) -> None:
        """computePodActions — ShouldContainerBeRestarted: a CRASHED container
        restarts under Always/OnFailure (restartCount++, a NEW container at
        the next attempt), else the pod goes Failed; a clean exit is the
        hollow Job contract (run_seconds elapsed: the workload is DONE) and
        terminates Succeeded."""
        if self.tracer.enabled:
            with self.tracer.span_for_pod(
                w.pod.uid, "kubelet.sync_died", pod=w.pod.uid,
                node=self.node_name,
            ):
                return self._sync_died_inner(w)
        return self._sync_died_inner(w)

    def _sync_died_inner(self, w: _PodWorker) -> None:
        try:
            status = self.runtime.container_status(w.container_id)
        except CRIError:
            status = None
        failed = status is not None and status.exit_code != 0
        policy = w.pod.restart_policy or "Always"
        if failed and policy in ("Always", "OnFailure"):
            w.restarts += 1
            # remove the dead container, then create+start the replacement
            # (kuberuntime prunes dead attempts as it restarts)
            self.runtime.remove_container(w.container_id)
            self._start_container(w)
            q = self._status_copy(w.pod)
            q.restart_count = w.restarts
            # the replacement container has not passed its readiness probe:
            # Ready drops NOW (the reference drops the condition on restart),
            # not one tick later when the prober next runs
            q.ready = w.pod.readiness_probe is None
            self.store.update_pod_status(q)
            return
        w.terminated = True
        self._teardown(w)
        self._set_phase(w.pod, t.PHASE_FAILED if failed else t.PHASE_SUCCEEDED)

    def _publish_images(self) -> None:
        """NodeStatus.Images from the runtime's image list (what
        ImageLocality scores against) — only when something new landed, so
        steady state never rewrites the Node object (identity fingerprints
        in the delta encoder stay warm)."""
        import copy

        node = self.store.nodes.get(self.node_name)
        if node is None:
            return
        have = self.images.list_images()
        merged = {**node.images, **have}
        if merged != node.images:
            q = copy.copy(node)
            q.images = merged
            self.store.update_node(q)

    # --- status publication ---
    def _status_copy(self, pod: t.Pod) -> t.Pod:
        import copy

        cur = self.store.pods.get(pod.uid, pod)
        return copy.copy(cur)

    def _set_phase(self, pod: t.Pod, phase: str, pod_ip: str = "") -> None:
        q = self._status_copy(pod)
        q.phase = phase
        if phase in (t.PHASE_SUCCEEDED, t.PHASE_FAILED):
            q.finished_at = self.clock.now()
        if phase == t.PHASE_RUNNING and not q.pod_ip:
            # status.podIP = the sandbox IP the runtime reported (CNI
            # result through RunPodSandbox); allocator fallback for direct
            # callers outside a sandbox
            q.pod_ip = pod_ip or self._alloc_ip()
        if phase == t.PHASE_RUNNING:
            # Ready starts False under a readiness probe (initial readiness
            # is Failure until the probe passes success_threshold times)
            q.ready = pod.readiness_probe is None
        self.store.update_pod_status(q)

    def _alloc_ip(self) -> str:
        """Lowest free host address in this node's /24 — collision-free
        across nodes (disjoint subnets) and within the node (scan this
        node's pods, max ~110).  The subnet is the node's
        spec.podCIDR when the NodeIPAM controller assigned one; otherwise
        the process-local registry index."""
        node = self.store.nodes.get(self.node_name)
        if node is not None and node.pod_cidr:
            prefix = node.pod_cidr.rsplit(".", 1)[0]  # "10.128.3.0/24" -> 10.128.3
        else:
            # 10.192/12 block: disjoint from NodeIPAM's 10.128/16 and the
            # 10.96/16 service VIP range
            n = self._cidr_index
            prefix = f"10.{192 + (n >> 8 & 0x3F)}.{n & 0xFF}"
        in_use = {
            int(p.pod_ip.rsplit(".", 1)[1])
            for p in self.store.pods_on_node(self.node_name)
            if p.pod_ip.startswith(prefix + ".")
        }
        host = next(h for h in range(1, 255) if h not in in_use)
        return f"{prefix}.{host}"


class HollowCluster:
    """kubemark's hollow-node fleet: one HollowKubelet per node in the store
    (nodes added later get a kubelet on the next tick)."""

    def __init__(self, store: ClusterStore, leases: LeaseStore):
        self.store = store
        self.leases = leases
        self.kubelets: Dict[str, HollowKubelet] = {}

    def tick(self) -> None:
        names = self.store.list_node_names()  # lock-consistent snapshot
        for name in names:
            if name not in self.kubelets:
                self.kubelets[name] = HollowKubelet(self.store, self.leases, name)
        names = set(names)
        for name in list(self.kubelets):
            if name not in names:
                self.kubelets.pop(name).close()
                continue
            self.kubelets[name].tick()
