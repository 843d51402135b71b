"""Workload controllers + garbage collector — the kube-controller-manager
analog (SURVEY.md §2.3: "each controller = informer→workqueue→sync loop").

Representative set per the reference's pkg/controller/*:

  ReplicaSetController   replica_set.go — syncReplicaSet/manageReplicas:
                         diff desired vs actual owned pods, create/delete
  DeploymentController   deployment/ — rollout via template-hashed ReplicaSets
                         (RollingUpdate with maxSurge/maxUnavailable)
  JobController          job/ — run pods to completion (completions/parallelism)
  GarbageCollector       garbagecollector/ — cascading delete of orphans whose
                         controller ownerReference points at a vanished owner

The workqueue is collapsed to a full reconcile pass per tick() — the same
level-triggered semantics (sync is idempotent, diff-driven), minus the
per-key scheduling, which only matters for fairness at scale.

The port's copy of the JAX package's ``scheduler/controllers.py``, the same semantics with its imports
re-pointed at the port; tests/test_torch_*.py hold the two equal.
"""

from __future__ import annotations

import copy as copy_module
import hashlib
import itertools
from dataclasses import replace
from typing import Dict, List, Optional, Tuple

from ..api import types as t
from .store import ClusterStore, _key_of


def _is_finished(pod: t.Pod) -> bool:
    return pod.phase in (t.PHASE_SUCCEEDED, t.PHASE_FAILED)


def _is_ready(pod: t.Pod) -> bool:
    """Bound, running ("" phase = harness objects without lifecycle), and
    passing its readiness probe — the Ready CONDITION, which gates ordered
    StatefulSet rollout and RS/DS ready counts in the reference, not just
    the phase."""
    return (
        bool(pod.node_name)
        and pod.phase in ("", t.PHASE_RUNNING)
        and pod.ready
    )


def _controller_of(pod: t.Pod) -> Optional[t.OwnerReference]:
    for ref in pod.owner_references:
        if ref.controller:
            return ref
    return None


def _stamp(template: t.Pod, name: str, namespace: str, owner: t.OwnerReference) -> t.Pod:
    import copy

    q = copy.copy(template)
    q.name = name
    q.namespace = namespace
    q.node_name = ""
    q.phase = t.PHASE_PENDING
    q.owner_references = (owner,)
    q.uid = f"{namespace}/{name}"
    q.labels = dict(template.labels)
    return q


class ReplicaSetController:
    """replica_set.go — syncReplicaSet: adopt matching orphans, then
    manageReplicas (create the shortfall / delete the excess, preferring
    pending and unready pods for deletion — getPodsToDelete's ranking)."""

    def __init__(self, store: ClusterStore):
        self.store = store
        self._seq = itertools.count()

    def _owned(self, rs: t.ReplicaSet) -> List[t.Pod]:
        out = []
        for pod in self.store.list_pods():
            if pod.namespace != rs.namespace:
                continue
            ctrl = _controller_of(pod)
            if ctrl is not None:
                if ctrl.uid == rs.uid:
                    out.append(pod)
            elif rs.selector is not None and rs.selector.matches(pod.labels):
                # adoption: matching orphan gains the controller ref
                import copy

                q = copy.copy(pod)
                q.owner_references = (
                    t.OwnerReference(kind="ReplicaSet", name=rs.name, uid=rs.uid),
                )
                self.store.update_pod(q)
                out.append(q)
        return out

    def sync(self, rs: t.ReplicaSet) -> None:
        owned = self._owned(rs)
        active = [p for p in owned if not _is_finished(p)]
        diff = rs.replicas - len(active)
        if diff > 0:
            owner = t.OwnerReference(kind="ReplicaSet", name=rs.name, uid=rs.uid)
            for _ in range(diff):
                name = f"{rs.name}-{next(self._seq):05d}"
                self.store.add_pod(
                    _stamp(rs.template or t.Pod(name="x"), name, rs.namespace, owner)
                )
        elif diff < 0:
            # delete excess: pending (unscheduled) first, then unready, then by name
            ranked = sorted(
                active,
                key=lambda p: (bool(p.node_name), _is_ready(p), p.name),
            )
            doomed = ranked[: -rs.replicas] if rs.replicas else ranked
            for p in doomed:
                self.store.delete_pod(p.uid)
            gone = {p.uid for p in doomed}
            active = [p for p in active if p.uid not in gone]
        ready = sum(1 for p in active if _is_ready(p))
        if ready != rs.ready_replicas:
            self.store.update_workload("ReplicaSet", replace(rs, ready_replicas=ready))

    def tick(self) -> None:
        for rs in self.store.list_objects("ReplicaSet"):
            self.sync(rs)


def _template_hash(template: Optional[t.Pod]) -> str:
    """pod-template-hash: stable digest of the rollout-relevant template
    fields (deployment_util.go — ComputeHash)."""
    if template is None:
        return "0"
    h = hashlib.sha256()
    h.update(repr((
        sorted(template.requests.items()),
        sorted(template.labels.items()),
        template.tolerations,
        template.node_selector,
        template.affinity,
        template.topology_spread,
        template.priority,
        template.host_ports,
        template.pvcs,
        template.resource_claims,
        template.scheduling_gates,
        template.images,
        template.run_seconds,
    )).encode())
    return h.hexdigest()[:10]


class DeploymentController:
    """deployment/sync.go — getAllReplicaSetsAndSyncRevision + the rolling
    update loop (rolling.go — reconcileNewReplicaSet/reconcileOldReplicaSets):
    scale the template-hashed new RS up within maxSurge, old RSes down within
    maxUnavailable, delete old RSes once drained."""

    def __init__(self, store: ClusterStore):
        self.store = store

    def sync(self, d: t.Deployment) -> None:
        hash_ = _template_hash(d.template)
        new_name = f"{d.name}-{hash_}"
        mine = [
            rs
            for rs in self.store.list_objects("ReplicaSet")
            if rs.namespace == d.namespace
            and any(r.uid == d.uid for r in rs.owner_references)
        ]
        new_rs = next((rs for rs in mine if rs.name == new_name), None)
        if new_rs is None:
            tmpl = None
            if d.template is not None:
                import copy

                tmpl = copy.copy(d.template)
                tmpl.labels = {**d.template.labels, "pod-template-hash": hash_}
            sel = d.selector or (
                t.LabelSelector.of(**d.template.labels) if d.template else None
            )
            new_rs = t.ReplicaSet(
                name=new_name,
                namespace=d.namespace,
                replicas=0,
                selector=sel,
                template=tmpl,
                owner_references=(
                    t.OwnerReference(kind="Deployment", name=d.name, uid=d.uid),
                ),
            )
            self.store.add_workload("ReplicaSet", new_rs)
        old = [rs for rs in mine if rs.name != new_name]

        total = new_rs.replicas + sum(rs.replicas for rs in old)
        ready_total = new_rs.ready_replicas + sum(rs.ready_replicas for rs in old)
        if new_rs.replicas > d.replicas:
            # the Deployment itself was scaled down: shrink the new RS directly
            self.store.update_workload(
                "ReplicaSet", replace(new_rs, replicas=d.replicas)
            )
        else:
            # scale new RS up within the surge budget
            allowed = d.replicas + d.max_surge - total
            if allowed > 0 and new_rs.replicas < d.replicas:
                grown = min(d.replicas, new_rs.replicas + allowed)
                self.store.update_workload(
                    "ReplicaSet", replace(new_rs, replicas=grown)
                )
        # scale old RSes down within the availability budget
        can_remove = ready_total - (d.replicas - d.max_unavailable)
        for rs in sorted(old, key=lambda r: r.name):
            if can_remove <= 0:
                break
            if rs.replicas > 0:
                drop = min(rs.replicas, can_remove)
                self.store.update_workload(
                    "ReplicaSet", replace(rs, replicas=rs.replicas - drop)
                )
                can_remove -= drop
        for rs in old:
            if rs.replicas == 0 and rs.ready_replicas == 0 and rs.key in self.store.replicasets:
                self.store.delete_workload("ReplicaSet", rs.key)

    def tick(self) -> None:
        for d in self.store.list_objects("Deployment"):
            self.sync(d)


# marker applied to succeeded Job pods once their completion has been added
# to status.succeeded — the finalizer-removal half of job tracking
_COUNTED_MARK = "batch.kubernetes.io/completion-counted"


class JobController:
    """job_controller.go — syncJob: keep min(parallelism, remaining) pods
    active until `completions` pods have succeeded; stamp completionTime when
    done (consumed by the TTL-after-finished controller)."""

    def __init__(self, store: ClusterStore, clock=None):
        from .queue import Clock

        self.store = store
        self.clock = clock or Clock()
        self._seq = itertools.count()

    def sync(self, job: t.Job) -> None:
        if job.completion_time >= 0:
            # Job status is authoritative once complete (the reference never
            # un-completes a Job): PodGC may have deleted the succeeded pods,
            # and recounting them would respawn the whole workload.
            return
        owned = [
            p
            for p in self.store.list_pods()
            if p.namespace == job.namespace
            and any(r.uid == job.uid for r in p.owner_references)
        ]
        # once-only completion accounting (the reference's finalizer-based
        # job tracking): each succeeded pod increments status.succeeded
        # exactly once and is then marked, so PodGC deleting it later can
        # never lose (or double-count) a completion
        fresh = [
            p
            for p in owned
            if p.phase == t.PHASE_SUCCEEDED and _COUNTED_MARK not in p.labels
        ]
        for p in fresh:
            q = copy_module.copy(p)
            q.labels = {**p.labels, _COUNTED_MARK: "true"}
            self.store.update_pod_status(q)
        succeeded = job.succeeded + len(fresh)
        active = [p for p in owned if not _is_finished(p)]
        want_active = min(job.parallelism, max(0, job.completions - succeeded))
        owner = t.OwnerReference(kind="Job", name=job.name, uid=job.uid)
        for _ in range(want_active - len(active)):
            name = f"{job.name}-{next(self._seq):05d}"
            tmpl = job.template or t.Pod(name="x", run_seconds=1.0)
            self.store.add_pod(_stamp(tmpl, name, job.namespace, owner))
        for p in active[want_active:] if want_active < len(active) else []:
            self.store.delete_pod(p.uid)
        done_now = succeeded >= job.completions and job.completion_time < 0
        if succeeded != job.succeeded or len(active) != job.active or done_now:
            self.store.update_workload(
                "Job",
                replace(
                    job,
                    succeeded=succeeded,
                    active=len(active),
                    completion_time=(
                        self.clock.now() if done_now else job.completion_time
                    ),
                ),
            )

    def tick(self) -> None:
        for job in self.store.list_objects("Job"):
            self.sync(job)


class ExpandController:
    """pkg/controller/volume/expand — expand_controller.go: a BOUND claim
    whose request grew past its volume's capacity is resized, provided its
    StorageClass allows expansion (allowVolumeExpansion).  The reference
    calls the CSI driver and leaves filesystem resize to the kubelet; the
    hollow trade collapses both into the PV capacity update (copy-on-write
    so watchers and the delta encoder see a fresh object).  Shrinking is
    never performed — the reference rejects it at validation."""

    def __init__(self, store: ClusterStore):
        self.store = store

    def tick(self) -> None:
        classes = {
            sc.name: sc
            for sc in (self.store.list_objects("StorageClass") if "StorageClass" in self.store.objects else ())
        }
        for pvc in self.store.list_pvcs():
            if not pvc.volume_name:
                continue
            pv = self.store.pvs.get(pvc.volume_name)
            if pv is None or pv.claim_ref != pvc.key:
                continue  # not actually BOUND to this claim (phase gate)
            if pvc.request <= pv.capacity:
                continue
            sc = classes.get(pvc.storage_class)
            if sc is None or not sc.allow_volume_expansion:
                continue
            self.store.update_pv(replace(pv, capacity=pvc.request))


class GarbageCollector:
    """garbagecollector/ — the dependency graph reduced to one cascading rule:
    an object whose controller ownerReference names a vanished uid is deleted.
    Covers Deployment→ReplicaSet→Pod and Job→Pod chains transitively (a pass
    per level; tick until quiescent for full cascades)."""

    def __init__(self, store: ClusterStore):
        self.store = store

    def _live_uids(self) -> set:
        live = set()
        # one lock-consistent pass: the object tables, pods and nodes all
        # mutate in place under the store lock while other components run
        with self.store.transaction():
            for table in self.store.objects.values():
                for obj in table.values():
                    uid = getattr(obj, "uid", "")
                    if uid:
                        live.add(uid)
            # pods and nodes can own objects too (EndpointSlice<-Service is
            # the common case, but Pod- and Node-owned objects exist in the
            # reference)
            for pod in self.store.pods.values():
                live.add(pod.uid)
            for name in self.store.nodes:
                live.add(f"node/{name}")
        return live

    def tick(self) -> int:
        """One pass; returns number of objects deleted.  Covers every
        registered kind (CRDs included) whose objects carry owner_references,
        then pods — the reference GC's dependency graph walks all GVRs the
        same way (garbagecollector/graph_builder.go monitors every
        deletable resource)."""
        deleted = 0
        live = self._live_uids()
        with self.store.transaction():
            tables = {
                kind: list(table.values())
                for kind, table in self.store.objects.items()
            }
        for kind, objs in tables.items():
            for obj in objs:
                refs = getattr(obj, "owner_references", ())
                ctrl = next((r for r in refs if r.controller), None)
                if ctrl is not None and ctrl.uid not in live:
                    self.store.delete_object(kind, _key_of(obj))
                    deleted += 1
        live = self._live_uids()
        for pod in self.store.list_pods():
            ctrl = _controller_of(pod)
            if ctrl is not None and ctrl.uid not in live:
                self.store.delete_pod(pod.uid)
                deleted += 1
        return deleted


class StatefulSetController:
    """statefulset/stateful_set_control.go — UpdateStatefulSet: stable ordinal
    identities `name-0 .. name-N-1`.  OrderedReady (default): ordinal i is
    created only after 0..i-1 are ready, and scale-down removes the highest
    ordinal one at a time; Parallel creates/deletes all at once."""

    def __init__(self, store: ClusterStore):
        self.store = store

    def _pod_name(self, sts, ordinal: int) -> str:
        return f"{sts.name}-{ordinal}"

    def sync(self, sts) -> None:
        owner = t.OwnerReference(kind="StatefulSet", name=sts.name, uid=sts.uid)
        by_ordinal: Dict[int, t.Pod] = {}
        for pod in self.store.list_pods():
            if pod.namespace == sts.namespace and any(
                r.uid == sts.uid for r in pod.owner_references
            ):
                try:
                    by_ordinal[int(pod.name.rsplit("-", 1)[1])] = pod
                except (IndexError, ValueError):
                    pass
        # a finished pod never becomes ready again: delete it and treat the
        # ordinal as vacant so it is recreated under the same identity
        for o, pod in list(by_ordinal.items()):
            if _is_finished(pod):
                self.store.delete_pod(pod.uid)
                del by_ordinal[o]
        ordered = sts.pod_management_policy == "OrderedReady"
        # create missing ordinals (in order; gate on predecessor readiness)
        for i in range(sts.replicas):
            if i in by_ordinal:
                if ordered and not _is_ready(by_ordinal[i]):
                    break  # wait for this ordinal before touching later ones
                continue
            tmpl = sts.template or t.Pod(name="x")
            pod = _stamp(tmpl, self._pod_name(sts, i), sts.namespace, owner)
            self.store.add_pod(pod)
            if ordered:
                break  # one at a time
        # delete excess ordinals: highest first, one per round when ordered
        excess = sorted((o for o in by_ordinal if o >= sts.replicas), reverse=True)
        for o in excess if not ordered else excess[:1]:
            self.store.delete_pod(by_ordinal[o].uid)
        ready = sum(
            1 for o, p in by_ordinal.items() if o < sts.replicas and _is_ready(p)
        )
        if ready != sts.ready_replicas:
            self.store.update_object("StatefulSet", replace(sts, ready_replicas=ready))

    def tick(self) -> None:
        for sts in self.store.list_objects("StatefulSet"):
            self.sync(sts)


class DaemonSetController:
    """daemon/daemon_controller.go — syncDaemonSet: one pod per eligible node.
    Since 1.12 daemon pods go through the default scheduler, pinned with a
    nodeAffinity on metadata.name (here: the kubernetes.io/hostname label the
    Node carries) — NodeShouldRunDaemonPod reduced to unschedulable/taint
    checks against the template's tolerations."""

    def __init__(self, store: ClusterStore):
        self.store = store

    def _eligible(self, ds, node: t.Node) -> bool:
        tmpl = ds.template or t.Pod(name="x")
        if node.unschedulable:
            # daemon pods tolerate unschedulable only if template says so
            if not any(
                tol.key == "node.kubernetes.io/unschedulable" for tol in tmpl.tolerations
            ):
                return False
        for taint in node.taints:
            # NoSchedule AND NoExecute are both hard filters in this
            # framework's scheduler (ops/filters.py), so both gate eligibility
            if taint.effect == t.PREFER_NO_SCHEDULE:
                continue
            if not any(tol.tolerates(taint) for tol in tmpl.tolerations):
                return False
        return True

    def sync(self, ds) -> None:
        owner = t.OwnerReference(kind="DaemonSet", name=ds.name, uid=ds.uid)
        have: Dict[str, t.Pod] = {}
        for pod in self.store.list_pods():
            if pod.namespace == ds.namespace and any(
                r.uid == ds.uid for r in pod.owner_references
            ):
                if _is_finished(pod):
                    # daemon pods must run for the node's lifetime: a
                    # Succeeded/Failed daemon pod is deleted and recreated
                    # (daemon_controller.go treats failed pods this way)
                    self.store.delete_pod(pod.uid)
                    continue
                target = pod.node_name or _pinned_node(pod)
                if target:
                    have[target] = pod
        want = {
            node.name for node in self.store.list_nodes()
            if self._eligible(ds, node)
        }
        for name in sorted(want - set(have)):
            tmpl = ds.template or t.Pod(name="x")
            pod = _stamp(tmpl, f"{ds.name}-{name}", ds.namespace, owner)
            # pin via required node affinity on the hostname label (the
            # scheduler still runs filters — resources, ports, etc.)
            pod.affinity = t.Affinity(
                required_node_terms=(
                    t.NodeSelectorTerm(
                        match_expressions=(
                            t.NodeSelectorRequirement(
                                key=t.LABEL_HOSTNAME, operator=t.OP_IN, values=(name,)
                            ),
                        )
                    ),
                )
            )
            self.store.add_pod(pod)
        for name in set(have) - want:
            self.store.delete_pod(have[name].uid)
        ready = sum(1 for n, p in have.items() if n in want and _is_ready(p))
        if ds.desired_number_scheduled != len(want) or ds.number_ready != ready:
            self.store.update_object(
                "DaemonSet",
                replace(ds, desired_number_scheduled=len(want), number_ready=ready),
            )

    def tick(self) -> None:
        for ds in self.store.list_objects("DaemonSet"):
            self.sync(ds)


def _pinned_node(pod: t.Pod) -> str:
    """Node a daemon pod is pinned to via its hostname affinity ("" if none)."""
    if pod.affinity is None:
        return ""
    for term in pod.affinity.required_node_terms:
        for req in term.match_expressions:
            if req.key == t.LABEL_HOSTNAME and req.operator == t.OP_IN and req.values:
                return req.values[0]
    return ""


class CronJobController:
    """cronjob/cronjob_controllerv2.go — syncCronJob: spawn a Job each period;
    concurrencyPolicy Allow (default) / Forbid (skip while one is active) /
    Replace (delete the active one first)."""

    def __init__(self, store: ClusterStore, clock=None):
        from .queue import Clock

        self.store = store
        self.clock = clock or Clock()

    def sync(self, cj) -> None:
        if cj.suspend:
            return
        now = self.clock.now()
        last = cj.last_schedule_time
        if last >= 0 and now - last < cj.period_seconds:
            return
        active = [
            j
            for j in self.store.list_objects("Job")
            if j.namespace == cj.namespace
            and any(r.uid == cj.uid for r in j.owner_references)
            and not j.complete
        ]
        if active:
            if cj.concurrency_policy == "Forbid":
                # missed run skipped entirely (not queued for catch-up)
                self.store.update_object(
                    "CronJob", replace(cj, last_schedule_time=now)
                )
                return
            if cj.concurrency_policy == "Replace":
                for j in active:
                    self.store.delete_object("Job", j.key)
        seq = int(now // max(cj.period_seconds, 1e-9))
        job = t.Job(
            name=f"{cj.name}-{seq}",
            namespace=cj.namespace,
            completions=cj.completions,
            parallelism=cj.parallelism,
            template=cj.job_template,
            owner_references=(
                t.OwnerReference(kind="CronJob", name=cj.name, uid=cj.uid),
            ),
        )
        if job.key not in self.store.jobs:
            self.store.add_object("Job", job)
        self.store.update_object("CronJob", replace(cj, last_schedule_time=now))

    def tick(self) -> None:
        for cj in self.store.list_objects("CronJob"):
            self.sync(cj)


class HPAController:
    """podautoscaler/horizontal.go + replica_calculator.go — the core ratio
    rule: desired = ceil(current * metricValue / target), no-op inside the
    tolerance band, clamped to [min,max]; scales the target Deployment."""

    def __init__(self, store: ClusterStore, metrics=None):
        # metrics(namespace, pods) -> average metric value per pod; pods is
        # the target's current pod list (the metrics-server role)
        self.store = store
        self.metrics = metrics

    def sync(self, hpa) -> None:
        if self.metrics is None or hpa.target_kind != "Deployment":
            return
        d = self.store.get_object("Deployment", f"{hpa.namespace}/{hpa.target_name}")
        if d is None:
            return
        pods = [
            p
            for p in self.store.list_pods()
            if p.namespace == hpa.namespace
            and d.selector is not None
            and d.selector.matches(p.labels)
            and not _is_finished(p)
        ]
        # ratio applies to the scale subresource's spec.replicas (the
        # reference's currentReplicas), NOT the observed pod count — pods only
        # feed the metric average (replica_calculator.go GetMetricReplicas)
        current = d.replicas
        if current == 0 or not pods:
            return
        value = self.metrics(hpa.namespace, pods)
        ratio = value / hpa.target_value if hpa.target_value else 1.0
        desired = current
        if abs(ratio - 1.0) > hpa.tolerance:
            import math

            desired = math.ceil(current * ratio)
        desired = max(hpa.min_replicas, min(hpa.max_replicas, desired))
        if desired != d.replicas:
            self.store.update_object("Deployment", replace(d, replicas=desired))
        if hpa.current_replicas != current or hpa.desired_replicas != desired:
            self.store.update_object(
                "HorizontalPodAutoscaler",
                replace(hpa, current_replicas=current, desired_replicas=desired),
            )

    def tick(self) -> None:
        for hpa in self.store.list_objects("HorizontalPodAutoscaler"):
            self.sync(hpa)


class NamespaceController:
    """namespace/namespace_controller.go — a Terminating namespace drains:
    delete every object in it across all kinds, then remove the namespace
    (the deletion finalizer's syncNamespaceFromKey)."""

    def __init__(self, store: ClusterStore):
        self.store = store

    def tick(self) -> None:
        for ns in self.store.list_objects("Namespace"):
            if ns.phase != "Terminating":
                continue
            remaining = 0
            for pod in self.store.list_pods():
                if pod.namespace == ns.name:
                    self.store.delete_pod(pod.uid)
                    remaining += 1
            for pdb in self.store.list_pdbs():
                if pdb.namespace == ns.name:
                    self.store.delete_pdb(pdb.key)
                    remaining += 1
            for pvc in self.store.list_pvcs():
                if pvc.namespace == ns.name:
                    self.store.delete_pvc(pvc.key)
                    remaining += 1
            with self.store.transaction():
                tables = {
                    kind: list(table.values())
                    for kind, table in self.store.objects.items()
                }
            for kind, objs in tables.items():
                if kind == "Namespace":
                    continue
                for obj in objs:
                    if getattr(obj, "namespace", None) == ns.name:
                        self.store.delete_object(kind, _key_of(obj))
                        remaining += 1
            if remaining == 0:
                self.store.delete_object("Namespace", ns.name)


class PodGCController:
    """podgc/gc_controller.go — three sweeps: orphaned pods bound to vanished
    nodes (force-deleted), unscheduled terminating pods, and terminated pods
    beyond the --terminated-pod-gc-threshold (oldest first)."""

    def __init__(self, store: ClusterStore, terminated_threshold: int = 12500):
        self.store = store
        self.terminated_threshold = terminated_threshold

    def tick(self) -> int:
        deleted = 0
        for pod in self.store.list_pods():
            if pod.node_name and pod.node_name not in self.store.nodes:
                self.store.delete_pod(pod.uid)
                deleted += 1
        finished = sorted(
            (p for p in self.store.list_pods() if _is_finished(p)),
            # oldest first by finish time (stamped by the kubelet; untimed
            # pods sort first = oldest), uid as the deterministic tie-break
            key=lambda p: (p.finished_at, p.uid),
        )
        for pod in finished[: max(0, len(finished) - self.terminated_threshold)]:
            self.store.delete_pod(pod.uid)
            deleted += 1
        return deleted


class TTLAfterFinishedController:
    """ttlafterfinished/ttlafterfinished_controller.go — delete Jobs whose
    ttlSecondsAfterFinished has elapsed since completion (pods cascade via GC)."""

    def __init__(self, store: ClusterStore, clock=None):
        from .queue import Clock

        self.store = store
        self.clock = clock or Clock()

    def tick(self) -> None:
        now = self.clock.now()
        for job in self.store.list_objects("Job"):
            if (
                job.ttl_seconds_after_finished is not None
                and job.completion_time >= 0
                and now - job.completion_time >= job.ttl_seconds_after_finished
            ):
                self.store.delete_object("Job", job.key)


class NodeIPAMController:
    """pkg/controller/nodeipam (range_allocator.go): assign each node a
    disjoint /24 from the cluster CIDR as spec.podCIDR; freed ranges are
    reused lowest-first when nodes go away."""

    def __init__(self, store: ClusterStore, cluster_prefix: str = "10.128"):
        self.store = store
        self.cluster_prefix = cluster_prefix  # /16 carved into /24s

    def tick(self) -> None:
        used = set()
        for nd in self.store.list_nodes():
            if nd.pod_cidr.startswith(self.cluster_prefix + "."):
                try:
                    used.add(int(nd.pod_cidr.split(".")[2]))
                except (IndexError, ValueError):
                    pass
        free = (i for i in range(256) if i not in used)
        for nd in sorted(self.store.list_nodes(), key=lambda n: n.name):
            if nd.pod_cidr:
                continue
            idx = next(free, None)
            if idx is None:
                return  # cluster CIDR exhausted
            q = copy_module.copy(nd)
            q.pod_cidr = f"{self.cluster_prefix}.{idx}.0/24"
            self.store.update_node(q)
            used.add(idx)


class ServiceAccountController:
    """pkg/controller/serviceaccount — serviceaccounts_controller (ensure the
    "default" ServiceAccount exists in every active namespace) fused with the
    token controller (tokens_controller: mint a bearer token per SA and
    register it with the authenticator; the token Secret is collapsed onto
    the SA object)."""

    def __init__(self, store: ClusterStore, authenticator=None):
        from ..api import cluster as c

        self._c = c
        self.store = store
        self.authn = authenticator
        self._minted: Dict[str, str] = {}  # SA key -> token
        self._mint_seq = itertools.count()

    def tick(self) -> None:
        c = self._c
        # revocation FIRST, against last tick's state: an SA that vanished —
        # or was deleted AND recreated between ticks (its live token field no
        # longer matches the minted credential) — loses the old credential
        for key, token in list(self._minted.items()):
            cur = self.store.get_object("ServiceAccount", key)
            if cur is None or cur.token != token:
                if self.authn is not None:
                    self.authn.remove_token(token)
                del self._minted[key]
        namespaces = {"default"} | {
            ns.name
            for ns in self.store.list_objects("Namespace")
            if ns.phase == "Active"
        }
        for ns in sorted(namespaces):
            if self.store.get_object("ServiceAccount", f"{ns}/default") is None:
                self.store.add_object(
                    "ServiceAccount", c.ServiceAccount(name="default", namespace=ns)
                )
        for sa in list(self.store.list_objects("ServiceAccount")):
            if sa.token:
                continue
            # nonce keeps a recreated SA from inheriting its predecessor's
            # credential (the reference mints a fresh random Secret)
            nonce = next(self._mint_seq)
            token = (
                f"sa-token-{hashlib.sha1(f'{sa.uid}:{nonce}'.encode()).hexdigest()[:16]}"
            )
            minted = copy_module.copy(sa)
            minted.token = token
            self.store.update_object("ServiceAccount", minted)
            self._minted[sa.key] = token
            if self.authn is not None:
                self.authn.add_token(
                    token,
                    sa.username,
                    groups=(
                        "system:serviceaccounts",
                        f"system:serviceaccounts:{sa.namespace}",
                    ),
                )


class AttachDetachController:
    """pkg/controller/volume/attachdetach — reconciler.go: converge the
    actual attachment state (NodeStatus.VolumesAttached) onto the desired
    state (every PV referenced through the PVCs of a non-finished pod bound
    to the node).  Detach happens when the last using pod leaves; nodes
    whose set is already correct are not touched (a node update would churn
    the delta encoder's identity fingerprints for nothing)."""

    def __init__(self, store: ClusterStore):
        self.store = store

    def tick(self) -> None:
        # claimRef -> PV index built once per tick: the steady-state no-op
        # pass must not pay O(pods x PVs) linear rescans
        pv_by_claim = {
            pv.claim_ref: pv.name
            for pv in self.store.list_pvs()
            if pv.claim_ref
        }
        desired: Dict[str, set] = {}
        for pod in self.store.list_pods():
            if not pod.node_name or _is_finished(pod):
                continue
            for claim in pod.pvcs:
                key = f"{pod.namespace}/{claim}"
                pvc = self.store.pvcs.get(key)
                pv = (
                    pvc.volume_name
                    if pvc is not None and pvc.volume_name
                    else pv_by_claim.get(key)
                )
                if pv is not None:
                    desired.setdefault(pod.node_name, set()).add(pv)
        for nd in self.store.list_nodes():
            want = tuple(sorted(desired.get(nd.name, ())))
            if tuple(nd.volumes_attached) != want:
                q = copy_module.copy(nd)
                q.volumes_attached = want
                self.store.update_node(q)


class ResourceClaimController:
    """pkg/controller/resourceclaim/controller.go reduced to the DRA-lite
    model: materialize a generated ResourceClaim per (pod, claim-template
    slot), reserve it for the pod once bound (status.reservedFor), and
    release + delete generated claims when their owner pod finishes or
    disappears (the ownerRef cascade)."""

    def __init__(self, store: ClusterStore):
        self.store = store

    @staticmethod
    def _claim_name(pod: t.Pod, i: int) -> str:
        return f"{pod.name}-claim-{i}"

    def tick(self) -> None:
        from ..api import cluster as c

        live: Dict[str, t.Pod] = {
            p.uid: p for p in self.store.list_pods() if not _is_finished(p)
        }
        wanted = set()
        for pod in live.values():
            for i, ref in enumerate(pod.resource_claims):
                key = f"{pod.namespace}/{self._claim_name(pod, i)}"
                wanted.add(key)
                cur = self.store.get_object("ResourceClaim", key)
                if cur is None:
                    self.store.add_object(
                        "ResourceClaim",
                        c.ResourceClaim(
                            name=self._claim_name(pod, i),
                            namespace=pod.namespace,
                            device_class=ref.device_class,
                            count=ref.count,
                            owner_pod_uid=pod.uid,
                            reserved_for=(pod.uid,) if pod.node_name else (),
                            allocated=bool(pod.node_name),
                        ),
                    )
                elif bool(pod.node_name) != cur.allocated or (
                    (pod.uid in cur.reserved_for) != bool(pod.node_name)
                ):
                    q = copy_module.copy(cur)
                    q.allocated = bool(pod.node_name)
                    q.reserved_for = (pod.uid,) if pod.node_name else ()
                    self.store.update_object("ResourceClaim", q)
        for claim in list(self.store.list_objects("ResourceClaim")):
            if not claim.owner_pod_uid:
                continue  # standalone user claim: not ours to manage
            if claim.key not in wanted:
                # owner gone or finished: release and GC the generated claim
                self.store.delete_object("ResourceClaim", claim.key)


class CertificatesController:
    """pkg/controller/certificates — the approver (approver.go sarApprove
    policy reduced to group membership) + signer (issue status.certificate
    for approved CSRs) + cleaner (certificate_controller's GC of stale
    CSRs after --csr-cleaner-interval; denied/expired requests age out)."""

    AUTO_APPROVE_SIGNERS = (
        "kubernetes.io/kubelet-serving",
        "kubernetes.io/kube-apiserver-client-kubelet",
    )
    TTL_S = 3600.0  # cleaner horizon for denied/issued CSRs

    def __init__(self, store: ClusterStore, clock=None):
        from .queue import Clock

        self.store = store
        self.clock = clock or Clock()  # one clock domain with the siblings
        self._seen: Dict[str, float] = {}  # csr uid -> first-observed time

    def tick(self) -> None:
        now = self.clock.now()
        listed = list(self.store.list_objects("CertificateSigningRequest"))
        # CSRs deleted by anyone else must not leak _seen entries forever
        live = {csr.uid for csr in listed}
        for uid in [u for u in self._seen if u not in live]:
            del self._seen[uid]
        for csr in listed:
            # age runs from first observation; "unset" is tracked separately
            # from the timestamp value (a FakeClock legitimately starts at 0)
            if csr.uid not in self._seen:
                self._seen[csr.uid] = now
                if csr.created_at:
                    self._seen[csr.uid] = csr.created_at
            if csr.status == "Pending":
                q = copy_module.copy(csr)
                ok = csr.signer_name in self.AUTO_APPROVE_SIGNERS and (
                    "system:nodes" in csr.groups
                    or csr.username.startswith("system:node:")
                )
                q.status = "Approved" if ok else "Denied"
                q.created_at = self._seen[csr.uid]
                self.store.update_object("CertificateSigningRequest", q)
                csr = q
            if csr.status == "Approved" and not csr.certificate:
                q = copy_module.copy(csr)
                digest = hashlib.sha1(
                    f"{csr.name}:{csr.username}:{csr.signer_name}".encode()
                ).hexdigest()
                q.certificate = f"-----BEGIN CERTIFICATE-----\n{digest}\n-----END CERTIFICATE-----"
                self.store.update_object("CertificateSigningRequest", q)
                csr = q
            if csr.status in ("Denied", "Approved"):
                if now - self._seen[csr.uid] > self.TTL_S:
                    self.store.delete_object(
                        "CertificateSigningRequest", csr.key
                    )
                    self._seen.pop(csr.uid, None)


class ControllerManager:
    """cmd/kube-controller-manager — runs the controller set; tick() is one
    reconcile round across all of them (deployment before replicaset so a
    rollout's RS scaling lands in the same round; cronjob before job so a
    spawned Job's pods land in the same round; HPA after metrics exist)."""

    def __init__(self, store: ClusterStore, clock=None, metrics=None,
                 authenticator=None):
        from .network import EndpointSliceController

        self.store = store
        self.nodeipam = NodeIPAMController(store)
        self.serviceaccounts = ServiceAccountController(store, authenticator)
        self.deployments = DeploymentController(store)
        self.replicasets = ReplicaSetController(store)
        self.statefulsets = StatefulSetController(store)
        self.daemonsets = DaemonSetController(store)
        self.cronjobs = CronJobController(store, clock=clock)
        self.jobs = JobController(store, clock=clock)
        self.hpa = HPAController(store, metrics=metrics)
        self.endpointslices = EndpointSliceController(store)
        self.namespaces = NamespaceController(store)
        self.podgc = PodGCController(store)
        self.ttl = TTLAfterFinishedController(store, clock=clock)
        self.attachdetach = AttachDetachController(store)
        self.expand = ExpandController(store)
        self.resourceclaims = ResourceClaimController(store)
        self.certificates = CertificatesController(store, clock=clock)
        self.gc = GarbageCollector(store)

    def tick(self) -> None:
        self.nodeipam.tick()
        self.serviceaccounts.tick()
        self.hpa.tick()
        self.deployments.tick()
        self.replicasets.tick()
        self.statefulsets.tick()
        self.daemonsets.tick()
        self.cronjobs.tick()
        self.jobs.tick()
        self.endpointslices.tick()
        self.namespaces.tick()
        self.podgc.tick()
        self.ttl.tick()
        self.attachdetach.tick()
        self.expand.tick()
        self.resourceclaims.tick()
        self.certificates.tick()
        self.gc.tick()

    def tick_until_quiescent(self, max_rounds: int = 20) -> None:
        for _ in range(max_rounds):
            before = self.store._rv
            self.tick()
            if self.store._rv == before:
                return
