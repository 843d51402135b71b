"""The Scheduler's measured entry: a store seeded from a snapshot, then
``run_until_idle`` — the part of the JAX package's ``bench/harness.py``
(its ``_setup_cluster`` and the run_until_idle leg of
``run_snapshot_workload``) that measures pods/s through the path users run.

    from kubernetes_tpu_torch.bench.harness import run_snapshot_workload
    from kubernetes_tpu_torch.bench.workloads import heterogeneous
    r = run_snapshot_workload("Config4", heterogeneous(20000, 20000), "tpu")

The JAX harness's AOT warm-up, device trace, HA restarts, YAML workloads
and artifact fields are not here (ROADMAP A14): the first cycle of a run
includes the kernels' first launches (their build is per process, in
ops/kernels.py, and a caller that wants it outside the wall builds first).

``bindings_digest`` and ``failure_outcome`` read only pod and scheduler
attributes both packages share, so one run of each package can be held
against the other.
"""

from __future__ import annotations

import hashlib
import json
import time
from collections import Counter
from typing import Dict, Iterable, Optional

from ..api.snapshot import Snapshot
from ..scheduler import ClusterStore, Scheduler, SchedulerConfiguration
from ..scheduler.tracing import TraceCollector


def setup_cluster(snap: Snapshot, mode: str = "tpu", device=None, collector=None,
                  config: Optional[SchedulerConfiguration] = None) -> Scheduler:
    """Store + scheduler seeded from a snapshot (pod groups, pre-bound pods
    and the storage/DRA objects), in the JAX harness's order: nodes, storage
    classes, PVs, PVCs, resource slices, device classes, the scheduler,
    pod groups, pending pods, bound pods.  `collector` defaults to a
    disabled TraceCollector (an untraced run allocates no span); `config`
    replaces SchedulerConfiguration(mode=mode)."""
    store = ClusterStore()
    for nd in snap.nodes:
        store.add_node(nd)
    for sc in snap.storage_classes.values():
        store.add_object("StorageClass", sc)
    for pv in snap.pvs:
        store.add_pv(pv)
    for pvc in snap.pvcs.values():
        store.add_pvc(pvc)
    for sl in snap.resource_slices:
        store.add_object("ResourceSlice", sl)
    for dc in snap.device_classes.values():
        store.add_object("DeviceClass", dc)
    if collector is None:
        collector = TraceCollector(enabled=False)
    sched = Scheduler(store, config or SchedulerConfiguration(mode=mode), collector=collector, device=device)
    for g, pg in snap.pod_groups.items():
        sched.cache.pod_groups[g] = pg
    for p in snap.pending_pods:
        store.add_pod(p)
    for p in snap.bound_pods:
        store.add_pod(p)
    return sched


def run_snapshot_workload(name: str, snap: Snapshot, mode: str = "tpu", device=None,
                          collector=None, config: Optional[SchedulerConfiguration] = None) -> Dict:
    """One workload through ``setup_cluster`` + ``run_until_idle`` -> the
    JAX harness's counts: ``scheduled`` / ``unschedulable`` (Scheduled and
    FailedScheduling events), ``wall_s`` (run_until_idle alone),
    ``pods_per_sec``, ``batches`` and the batch-duration histogram's
    ``batch_p50_ms`` / ``batch_p99_ms``; also ``bindings_sha256``
    (bindings_digest over the store) and ``scheduler``, the instance."""
    sched = setup_cluster(snap, mode, device=device, collector=collector, config=config)
    t0 = time.perf_counter()
    sched.run_until_idle()
    wall = time.perf_counter() - t0
    scheduled = len(sched.events.by_reason("Scheduled"))
    hist = sched.metrics.hists.get("batch_scheduling_duration_seconds")
    return {
        "name": name,
        "n_nodes": len(snap.nodes),
        "n_pods": len(snap.pending_pods),
        "scheduled": scheduled,
        "unschedulable": len(sched.events.by_reason("FailedScheduling")),
        "wall_s": wall,
        "pods_per_sec": scheduled / wall if wall > 0 else 0.0,
        "batches": hist.count if hist is not None else 0,
        "batch_p50_ms": hist.quantile(0.50) * 1e3 if hist else 0.0,
        "batch_p99_ms": hist.quantile(0.99) * 1e3 if hist else 0.0,
        "bindings_sha256": bindings_digest(sched.store.pods.values()),
        "scheduler": sched,
    }


def bindings_digest(pods: Iterable) -> str:
    """sha256 of the sorted [pod name, node] pairs of the bound pods, as
    compact JSON."""
    rows = sorted([p.name, p.node_name] for p in pods if p.node_name)
    return hashlib.sha256(json.dumps(rows, separators=(",", ":")).encode()).hexdigest()


def overlapped_binds(collector) -> int:
    """The deferred binds published inside a later ``batch.kernel`` span of
    a traced run: the commit overlap's pods (a flush at a drain point is
    outside every kernel span and does not count)."""
    kernel = [(sp.start, sp.end) for sp in collector.spans() if sp.name == "batch.kernel" and sp.end is not None]
    return sum(int(sp.attributes.get("pods", 0)) for sp in collector.spans()
               if sp.name == "commit_overlap" and any(a <= sp.start and sp.end <= b for a, b in kernel))


def failure_outcome(names_before: Iterable[str], sched) -> Dict:
    """What a failing cycle did to the cluster: the pods evicted (present
    in `names_before`, gone from the store), the nominations the queue
    holds, the FailedScheduling messages (message -> count), the bindings
    digest, and ``sha256`` over all of it."""
    now = {p.name for p in sched.store.pods.values()}
    out = {
        "evicted": sorted(set(names_before) - now),
        "nominated": sorted([p.name, node] for p, node in sched.queue.nominated.values()),
        "messages": dict(sorted(Counter(
            e.message for e in sched.events.by_reason("FailedScheduling")).items())),
        "bindings_sha256": bindings_digest(sched.store.pods.values()),
    }
    out["sha256"] = hashlib.sha256(json.dumps(out, separators=(",", ":")).encode()).hexdigest()
    return out


__all__ = ["bindings_digest", "failure_outcome", "overlapped_binds", "run_snapshot_workload", "setup_cluster"]
