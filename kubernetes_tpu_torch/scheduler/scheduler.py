"""The Scheduler: pop -> schedule -> bind, in two execution modes — the port
of the JAX package's ``scheduler/scheduler.py``.

Analog of pkg/scheduler/scheduler.go (type Scheduler, Run) and
schedule_one.go (ScheduleOne: schedulingCycle + bindingCycle):

  mode="cpu"  one pod per cycle through the plugin framework — the reference's
              exact shape (findNodesThatFitPod -> prioritizeNodes -> selectHost
              -> assume -> bind) and the mandated fallback path.  It touches
              no tensor and needs no card.
  mode="tpu"  drain the activeQ into a batch, lower the cache snapshot to
              tensors on the card (api/delta.py — DeltaEncoder), run the routed
              commit step (ops/assign.py — dispatch; the gang fixpoint,
              ops/gang.py, for pod groups) on the hand-written kernels, bind
              all placements.  Decision-identical to cpu mode (both tie-break
              to the lowest node index).
  mode="native"  the batch cycle on the host: the same encode, then the
              sequential C++ engine (native/: schedule_batch_native, the
              gang fixpoint over it) reads the host arrays; no class state.
              A failing cycle's diagnosis and BatchedPreemption run on the
              device as in mode="tpu", on the arrays placed for them then.

The device.  ``Scheduler(..., device=None)`` resolves the card in
mode="tpu" and mode="native" (device.resolve_device) and raises without
one; the tests pass device="cpu", which runs every kernel's plain
version.  The encoder returns host arrays and their placement on the
device; every host read of a cycle's arrays (the diagnosis' usage, the
verdicts) reads the host arrays or one explicit copy back.  The commit overlap of the JAX package is kept: the
step is dispatched without a host synchronisation, an earlier program's
deferred binds are published while it runs, and only then is the step
finished and its choices and ordinals copied back once.  Binds are
deferred only on the non-gang branch (GangScheduling off) with no pod
parked, so the overlap engages when a cycle runs a second profile's
program, or when a later cycle of one run_until_idle has pods; otherwise
the binds are published at the drain.  torch has no buffer donation, so
nothing here asks for it.

Failure path (both modes): PostFilter/preemption may evict victims and
nominate a node; the pod then re-queues with backoff and the freed capacity is
visible to its retry.  In the batch cycle a failed pod inside the batched
gate goes to ops/preempt.py's evaluator (scheduler/preemption.py —
BatchedPreemption, kernel K15 on the card), any other to the CPU PostFilter
(plugins/cpu.py — DefaultPreemption), as in the JAX package.  With
KTPU_EXPLAIN=1 the failed classes are diagnosed on the device first
(ops/explain.py, kernel K14).

Watch wiring: new pending pods pass PreEnqueue into the activeQ (gated pods
wait in unschedulablePods for a Pod/Update); Node add/update and Pod delete
events MoveAllToActiveOrBackoffQueue — the QueueingHint machinery reduced to
event kinds.

Crash restart (checkpoint.py, flightrecorder.py, leases.py): checkpoint_dir
or KTPU_CHECKPOINT_DIR arms the fsync'd checkpoint of the assumed-pod
ledger, the deferred-bind WAL, the in-flight commit wave and the arrival
and pop ages, saved at every assume / forget, WAL append, wave clear and
flush, and the decision flight recorder that dumps into the same
directory on a kill or a wave recovery.  A kill.* fault latches the
instance dead; run_restartable answers it with restart_scheduler (detach,
reincarnate on the same store, restore: the WAL replayed exactly once, the
class state invalidated so the replacement's first cycle hoists in full),
run_ha_restartable with a standby's lease takeover (ha_takeover).  Without
a directory the restart is crash-only: everything rebuilds from the
store's watch replay.

Not ported, refused with NotImplementedError naming its ROADMAP item: HTTP
extenders (A14).  The device-memory ledger is A13: KTPU_MEMWATCH has no
reader yet, and a flight record carries no memory block.  The JAX package's persistent compile cache (ops/aot.py) has no
counterpart: the kernels are built once per process (ops/kernels.py).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import chaos
from ..api import types as t
from ..api.snapshot import Snapshot
from ..ops.scores import infer_score_config
from .cache import SchedulerCache
from .config import SchedulerConfiguration
from .events import EventRecorder
from .features import FeatureGates
from .framework import CycleState, Framework, NodeInfo, Status
from .metrics import Metrics, SLI_PHASES
from .plugins.cpu import default_plugins
from .queue import (
    EV_NODE_ADD,
    EV_NODE_UPDATE,
    EV_POD_ADD,
    EV_POD_DELETE,
    Clock,
    PriorityQueue,
)
from .state import ScaledState
from .store import ClusterStore, Event, replace_pod_nodename
from ..analysis.lockcheck import make_lock


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: see ROADMAP.md {item}")


def _sli_phase_block(wave_phases: Dict[str, Dict[str, float]]) -> dict:
    """Compact per-cycle phase summary for the flight recorder: per-phase
    mean/max across the cycle's bound pods plus the worst pod's full phase
    vector (a record stays a few hundred bytes at any wave size)."""
    n = len(wave_phases)
    total = {ph: 0.0 for ph in SLI_PHASES}
    peak = {ph: 0.0 for ph in SLI_PHASES}
    worst_uid, worst_sli, worst_vec = "", -1.0, {}
    for uid, phases in wave_phases.items():
        sli = sum(phases.values())
        if sli > worst_sli:
            worst_uid, worst_sli, worst_vec = uid, sli, phases
        for ph, v in phases.items():
            total[ph] += v
            if v > peak[ph]:
                peak[ph] = v
    return {
        "pods": n,
        "mean_ms": {ph: round(total[ph] / n * 1e3, 3) for ph in SLI_PHASES},
        "max_ms": {ph: round(peak[ph] * 1e3, 3) for ph in SLI_PHASES},
        "worst": {
            "pod": worst_uid,
            "sli_ms": round(worst_sli * 1e3, 3),
            "phases_ms": {ph: round(v * 1e3, 3) for ph, v in worst_vec.items()},
        },
    }


class Scheduler:
    def __init__(
        self,
        store: ClusterStore,
        config: SchedulerConfiguration = SchedulerConfiguration(),
        clock: Optional[Clock] = None,
        logger=None,
        collector=None,
        metrics=None,
        checkpoint_dir: Optional[str] = None,
        device=None,
    ):
        from .tracing import TraceCollector, Tracer, default_collector

        if config.extenders:
            raise _not_ported("an HTTP scheduler extender (HTTPExtender)", "A14")
        # the batch cycle's device: the card unless the caller passes
        # device="cpu" (device.resolve_device raises without a card); the
        # per-pod cycle touches no tensor.  The native engine reads host
        # arrays, but a failing cycle's diagnosis and BatchedPreemption run
        # on the device, as in the JAX package's native mode
        self.device = None
        if config.mode in ("tpu", "native"):
            from ..device import resolve_device

            self.device = resolve_device(device)
        self.store = store
        self.config = config
        self.features = FeatureGates(config.feature_gates)
        self.cache = SchedulerCache(store)
        # kill.post_assume injections stamp THIS scheduler's tracer/metrics
        # (and latch _dead) like every other kill site
        self.cache.kill_point = self._kill_point
        # simulated-process liveness: a kill.* chaos fault latches this (and
        # the module-wide chaos.killed()) so the dying instance's unwind —
        # deferred-bind flush, binding drains — does nothing a SIGKILL'd
        # process couldn't.  restart_scheduler() builds the replacement.
        self._dead = False
        # span tracing: callers may inject a TraceCollector (pass
        # TraceCollector(enabled=False) to opt out of all span allocation);
        # default = the process-wide collector
        self.collector: TraceCollector = (
            collector if collector is not None else default_collector()
        )
        self.tracer = Tracer(self.collector, component="scheduler")
        # KTPU_CHAOS_SEED / KTPU_FAULT_PLAN arm the fault injector for any
        # scheduler-driven process (idempotent; no-op when unset)
        chaos.maybe_install_from_env()
        self.queue = PriorityQueue(
            clock, tracer=Tracer(self.collector, component="queue"),
            initial_backoff_s=config.pod_initial_backoff_seconds,
            max_backoff_s=config.pod_max_backoff_seconds,
            backoff_jitter=config.pod_backoff_jitter,
        )
        self.metrics = metrics if metrics is not None else Metrics()
        # the headline SLI: true per-pod arrival -> bind latency
        # (metrics.go — pod_scheduling_sli_duration_seconds), stamped at
        # queue admission and observed at bind publication.  Cached handle:
        # one lock per bound pod, no registry round-trip.
        self._sli_hist = self.metrics.hist("pod_scheduling_sli_duration_seconds")
        # per-wave introspection (populated only while tracing is enabled):
        # uid -> kernel ordinal estimate, which places the phase marks
        self.last_wave_estimates: Dict[str, float] = {}
        # per-pod SLI phase decomposition (queue_wait | wave_wait |
        # device_kernel | bind — metrics.py SLI_PHASES), observed at bind
        # publication behind the tracer.enabled gate
        self._phase_hists = {
            ph: self.metrics.labeled_hist("pod_sli_phase_duration_seconds",
                                          phase=ph)
            for ph in SLI_PHASES
        }
        # uid -> (kernel dispatch instant, decision-ready instant), consumed
        # at publication (deferred binds keep their marks until the flush)
        self._phase_marks: Dict[str, Tuple[float, float]] = {}
        # uid -> phase vector of the pods bound this batch cycle (cleared at
        # each cycle start): the flight recorder's per-cycle latency anatomy
        self.last_wave_phases: Dict[str, Dict[str, float]] = {}
        self.events = EventRecorder(store=store, metrics=self.metrics)
        from .klog import Logger

        self.log = (logger or Logger()).with_values(component="scheduler")
        # extenders are refused above (HTTPExtender is ROADMAP A14): the
        # plugins and the binding cycle see none
        self.extenders: list = []
        self._bind_pool = None
        self._bind_lock = make_lock("Scheduler._bind_lock")
        self._bind_futures: list = []
        if config.binding_workers > 0:
            from concurrent.futures import ThreadPoolExecutor

            self._bind_pool = ThreadPoolExecutor(
                max_workers=config.binding_workers,
                thread_name_prefix="binding-cycle",
            )
        # findNodesThatFitPod's rotating cursor (schedule_one.go —
        # nextStartNodeIndex)
        self._next_start_node_index = 0
        # coscheduling waiting-pods map: gang members on the CPU path hold
        # their assumption here until minMember siblings arrive; quorum
        # binds all, quiescence without quorum rejects all
        self._gang_waiting: Dict[str, List[Tuple[t.Pod, str, object, object]]] = {}
        self._gang_lock = make_lock("Scheduler._gang_lock")
        # one Framework per profile (frameworkForPod — pods select theirs by
        # spec.schedulerName); self.framework stays the default profile's
        self.frameworks: Dict[str, Framework] = {
            p.scheduler_name: Framework(
                default_plugins(
                    store,
                    filter_fn=self._filter_one,
                    nominated_fn=lambda n: self.queue.nominated_pods_for_node(n),
                    hard_pod_affinity_weight=p.hard_pod_affinity_weight,
                    plugin_specs=p.plugins,
                    extenders=self.extenders,
                    fit_strategy=p.fit_strategy,
                    rtcr_shape=p.rtcr_shape,
                ),
                tracer=self.tracer,
                metrics=self.metrics,
            )
            for p in config.profiles
        }
        self.default_profile_name = config.profiles[0].scheduler_name
        self.framework = self.frameworks[self.default_profile_name]
        # batch-cycle lead rotation (anti-starvation across profiles)
        self._last_profile_served: Optional[str] = None
        self._sidecar = None  # most-recent client (kept for tests/introspection)
        self._sidecars: Dict[str, object] = {}  # per-address lazy TPUScoreClients
        # batched-bind move coalescing: while a batch commit loop runs, watch
        # events' MoveAllToActiveOrBackoffQueue calls collapse into one move
        # per event kind at loop exit
        self._move_lock = make_lock("Scheduler._move_lock")
        self._move_coalesce: Optional[set] = None
        # resident incremental encoder for the batch path: cluster-side
        # state persists across cycles, absorbing bind/delete deltas, and
        # the device tensors of unchanged fields stay resident
        self._delta_enc = None
        # resident class state for the batch kernels (ops/incremental.py),
        # dirty-node patched per warm delta
        self._hoist_cache = None
        # pipelined batch commits: the bind/events/queue fan-out of cycle
        # i−1 is deferred into cycle i's device-step window whenever that is
        # provably serial-equivalent.  KTPU_PIPELINE=0 (or the config knob)
        # restores the fully synchronous commit.
        self._pipeline_commit = (
            config.pipeline_commit and os.environ.get("KTPU_PIPELINE") != "0"
        )
        self._deferred_binds: List[Tuple[t.Pod, str]] = []
        # deferral engages only under run_until_idle's cycle stream: a
        # directly-called schedule_batch() keeps its contract that binds
        # are store-visible on return
        self._cycle_streaming = False
        # wave WAL: while a commit wave is between verdict and full
        # publication, {"uids": [...], "verdict_crc": str} rides every
        # checkpoint save so restore() can reconcile the killed wave
        self._wave_wal: Optional[Dict] = None
        # node mesh for the batch path's sharded routed step: KTPU_MESH
        # wins, else the largest profile meshDevices from TPUScoreArgs.
        # None = one device, the default.  Both batch branches thread it
        # (the routed step and the gang host fixpoint); the encoder keeps
        # its arrays on the scheduler's device and each step shards them.
        self.mesh = None
        if config.mode == "tpu":
            from ..parallel.mesh import mesh_from_env

            on = "cpu" if self.device.type == "cpu" else None
            self.mesh = mesh_from_env(devices=on)
            if self.mesh is None:
                md = max(
                    (p.tpu_score.mesh_devices for p in config.profiles
                     if p.tpu_score is not None),
                    default=1,
                )
                if md > 1:
                    self.mesh = mesh_from_env(str(md), source="meshDevices", devices=on)
        # crash-consistent state (checkpoint.py): KTPU_CHECKPOINT_DIR (or the
        # explicit arg) arms the checksummed checkpoint of the assumed-pod
        # ledger + deferred-commit WAL + SLI arrival stamps — everything
        # else rebuilds from the watch (crash-only).  The ledger checkpoints
        # at every cache.assume/forget via the cache hook.
        self._ckpt = None
        ckpt_dir = checkpoint_dir or os.environ.get("KTPU_CHECKPOINT_DIR")
        if ckpt_dir:
            from .checkpoint import CheckpointManager

            self._ckpt = CheckpointManager(ckpt_dir, metrics=self.metrics, logger=self.log)
            self.cache.checkpoint_hook = self._checkpoint_state
        # decision flight recorder: a bounded ring of per-cycle decision
        # records, dumped into the checkpoint dir on a kill site or a wave
        # recovery (recording is skipped without a directory)
        from .flightrecorder import FlightRecorder

        self._flight = FlightRecorder(directory=ckpt_dir)
        self._last_diagnosis: List[dict] = []
        # the device-memory ledger (KTPU_MEMWATCH) is ROADMAP A13: no
        # reader yet, so the cycle-boundary sample is skipped
        self._memwatch = None
        store.watch(self._on_event)

    # --- watch plumbing ---
    def _move_all(self, event_kind: str, obj=None, old=None) -> None:
        """MoveAllToActiveOrBackoffQueue, coalesced while a batch bind loop is
        active (one real move per distinct event kind at loop exit; the
        coalesced flush carries no event object, so parked pods' QueueingHint
        callbacks are skipped conservatively — they wake on kind match)."""
        with self._move_lock:
            if self._move_coalesce is not None:
                self._move_coalesce.add(event_kind)
                return
        self.queue.move_all_to_active_or_backoff(event_kind, obj=obj, old=old)

    @contextlib.contextmanager
    def _coalesced_moves(self):
        with self._move_lock:
            first = self._move_coalesce is None
            if first:
                self._move_coalesce = set()
        try:
            yield
        finally:
            if first:
                with self._move_lock:
                    kinds, self._move_coalesce = self._move_coalesce, None
                for k in sorted(kinds):
                    self.queue.move_all_to_active_or_backoff(k)

    def _on_event(self, ev: Event) -> None:
        if ev.obj_type == "Pod":
            pod = ev.obj
            if ev.kind == "Deleted":
                self.queue.delete(pod.uid)
                # a recreated pod reuses the namespace/name-derived uid: drop
                # the trace context so its spans start a FRESH trace
                self.collector.detach_pod(pod.uid)
                # a gang member deleted while Permit-waiting must release its
                # assumption and stop counting toward quorum
                if pod.pod_group:
                    dropped = False
                    with self._gang_lock:
                        waiters = self._gang_waiting.get(pod.pod_group)
                        if waiters is not None:
                            kept = [w for w in waiters if w[0].uid != pod.uid]
                            dropped = len(kept) != len(waiters)
                            if dropped and kept:
                                self._gang_waiting[pod.pod_group] = kept
                            elif dropped:
                                del self._gang_waiting[pod.pod_group]
                    if dropped:
                        self.cache.forget(pod.uid)
                self._move_all(EV_POD_DELETE, obj=pod)
            elif ev.kind == "ModifiedStatus":
                # status-only write: no requeue of THIS pod — but a bound pod
                # reaching a terminal phase releases capacity
                if pod.node_name and pod.phase in (t.PHASE_SUCCEEDED, t.PHASE_FAILED):
                    self._move_all(EV_POD_DELETE, obj=pod)
            elif not pod.node_name:
                fw = self._fw(pod)
                if fw is None:
                    return  # another scheduler's pod: not queued, not failed
                st = fw.run_pre_enqueue(pod)
                if st.ok:
                    self.queue.add(pod)
                    self.metrics.inc("queue_incoming_pods_total")
                else:
                    self.queue.add_unschedulable(pod, {"Pod/Update"}, backoff=False)
            else:
                # assigned-pod add/update: a newly bound pod can satisfy
                # waiting pods' affinity/spread terms (AssignedPodAdd hint)
                self._move_all(EV_POD_ADD, obj=pod)
        elif ev.obj_type == "Node":
            self._move_all(
                EV_NODE_ADD if ev.kind == "Added" else EV_NODE_UPDATE,
                obj=ev.obj,
                old=getattr(ev, "old", None),
            )

    def _fw(self, pod: t.Pod) -> Optional[Framework]:
        """frameworkForPod (schedule_one.go): the profile the pod selects by
        spec.schedulerName, or None when no profile here serves that name."""
        return self.frameworks.get(pod.scheduler_name or self.default_profile_name)

    def _filter_one(self, state: CycleState, snap: Snapshot, pod: t.Pod, info: NodeInfo) -> Status:
        return self._fw(pod).run_filters(state, snap, pod, info)

    def _filter_with_nominated(
        self, state: CycleState, snap: Snapshot, pod: t.Pod, info: NodeInfo, i: int
    ) -> Status:
        """schedule_one.go — RunFilterPluginsWithNominatedPods: with
        equal-or-higher-priority pods nominated onto this node, the pod must
        pass Filter both WITH their resources/affinity terms counted and
        WITHOUT them."""
        nominated = [
            q
            for q in self.queue.nominated_pods_for_node(info.node.name)
            if q.uid != pod.uid and q.priority >= pod.priority
        ]
        if not nominated:
            return self._fw(pod).run_filters(state, snap, pod, info)
        sc = state.data["scaled"]
        sim = NodeInfo(node=info.node, pods=list(info.pods) + list(nominated))
        sc.push_sim(i, sim)
        try:
            st = self._fw(pod).run_filters(state, snap, pod, sim)
        finally:
            sc.pop_sim(i)
        if not st.ok:
            return st
        return self._fw(pod).run_filters(state, snap, pod, info)

    # --- findNodesThatFitPod helpers (CPU path) ---
    def _num_feasible_nodes_to_find(self, num_nodes: int, profile_name: str = "") -> int:
        """schedule_one.go — numFeasibleNodesToFind: percentageOfNodesToScore
        (0 = adaptive max(5, 50 - nodes/125)%), floored at
        minFeasibleNodesToFind = 100."""
        pct = self.config.profile(
            profile_name or self.default_profile_name
        ).percentage_of_nodes_to_score
        if pct == 0:
            pct = max(5, 50 - num_nodes // 125)
        if pct >= 100 or num_nodes <= 100:
            return num_nodes
        return max(100, num_nodes * pct // 100)

    def _find_feasible(self, state, snap, pod, infos):
        """Rotating-cursor filter fan-out with early stop at
        numFeasibleNodesToFind.  Traced runs flush ONE aggregate
        Filter/<plugin> span per cycle (framework.run_filters)."""
        tracing = self.tracer.enabled
        t_f0 = time.perf_counter() if tracing else 0.0
        n = len(infos)
        want = self._num_feasible_nodes_to_find(
            n, pod.scheduler_name or self.default_profile_name
        )
        feasible: List[int] = []
        statuses: Dict[str, Status] = {}
        processed = 0
        start = self._next_start_node_index % n if n else 0
        for k in range(n):
            i = (start + k) % n
            processed += 1
            fst = self._filter_with_nominated(state, snap, pod, infos[i], i)
            if fst.ok:
                feasible.append(i)
                if len(feasible) >= want:
                    break
            else:
                statuses[infos[i].node.name] = fst
        if n:
            self._next_start_node_index = (start + processed) % n
        feasible.sort()  # deterministic tie-break stays index-ordered
        if tracing:
            agg = state.data.pop("_filter_trace", None)
            if agg:
                off = t_f0
                for plugin_name, (dt, calls) in agg.items():
                    self.tracer.record_span(
                        f"Filter/{plugin_name}", start=off, end=off + dt,
                        extension_point="Filter", plugin=plugin_name,
                        nodes=calls,
                    )
                    off += dt
        return feasible, statuses

    # --- the CPU scheduling cycle (ScheduleOne) ---
    def schedule_one(self, pod: t.Pod) -> Optional[str]:
        """One pod through the plugin framework, wrapped in a
        scheduling.cycle span chained onto the pod's trace."""
        if not self.tracer.enabled:
            return self._schedule_one_cycle(pod)
        with self.tracer.span_for_pod(
            pod.uid, "scheduling.cycle", pod=pod.uid
        ) as sp:
            node = self._schedule_one_cycle(pod)
            if sp is not None:
                sp.attributes["node"] = node or ""
            return node

    def _schedule_one_cycle(self, pod: t.Pod) -> Optional[str]:
        from ..api.volumes import resolve_snapshot

        t0 = time.perf_counter()
        cycle_move_seq = self.queue.move_seq  # moveRequestCycle guard
        snap = resolve_snapshot(self.cache.update_snapshot())
        # the popped pod may have gained folded volume/claim constraints
        pod = next((q for q in snap.pending_pods if q.uid == pod.uid), pod)
        infos = self.cache.node_infos(snap)
        state = CycleState()
        state.data["scaled"] = ScaledState(snap, infos)
        fw = self._fw(pod)
        if fw is None:
            return None  # another scheduler's pod (defensive; not enqueued)
        st = fw.run_pre_filter(state, snap, pod)
        feasible: List[int] = []
        statuses: Dict[str, Status] = {}
        if st.ok:
            feasible, statuses = self._find_feasible(state, snap, pod, infos)
        if not feasible:
            nominated, pst = fw.run_post_filters(state, snap, pod, statuses)
            # fitError-shaped diagnosis from the per-plugin statuses this
            # cycle already holds, rendered by the SAME renderer the device
            # path's explain kernel uses (ops/explain.py)
            from ..ops.explain import dominant_reason, render_unschedulable

            counts: Dict[str, int] = {}
            metric_label: Dict[str, str] = {}
            for fst in statuses.values():
                reason = ((fst.reasons[0] if fst.reasons else "")
                          or fst.plugin or "unschedulable")
                counts[reason] = counts.get(reason, 0) + 1
                # bounded metric-label rule: free-form sources collapse
                metric_label[reason] = reason if fst.plugin else "extender"
            if not statuses and not st.ok:
                # PreFilter rejection marks every node
                reason = ((st.reasons[0] if st.reasons else "")
                          or st.plugin or "PreFilter rejected")
                counts[reason] = len(infos)
                metric_label[reason] = (reason if st.plugin
                                        else "PreFilter rejected")
            # label-sorted: a tied dominant reason must not flap with the
            # rotating node cursor
            counts = {k: counts[k] for k in sorted(counts)}
            if counts:
                self.metrics.inc_labeled(
                    "pod_unschedulable_reasons_total",
                    reason=metric_label[dominant_reason(counts)],
                )
            msg = render_unschedulable(len(infos), counts)
            if pst.ok:
                msg = msg.rstrip(".") + f"; preemption nominated {nominated}."
            self.events.record("FailedScheduling", pod.uid, message=msg)
            self.log.V(2).info("Unable to schedule pod", pod=pod.uid,
                               nodes=len(infos), failed=len(statuses),
                               nominated=nominated if pst.ok else "")
            if pst.ok and nominated:
                self.events.record("Preempted", pod.uid, node=nominated)
                self._nominate(pod, nominated)
            else:
                self._clear_nomination(pod)  # clearNominatedNode: stale
            # QueueingHints: park on the events the FAILING plugins
            # registered; a fresh nomination takes the plain backoff retry
            # (its victims' deletions already fired), and a move during the
            # cycle means a stale snapshot: plain backoff too
            failing = {s.plugin for s in statuses.values() if s.plugin}
            park = failing and not (pst.ok and nominated)
            hint_events = fw.events_for_plugins(failing) if park else None
            hints = fw.hints_for_plugins(failing) if park else None
            self.queue.add_unschedulable(
                pod, hint_events, backoff=True, cycle_move_seq=cycle_move_seq,
                hints=hints,
            )
            self.metrics.inc("scheduling_attempts_unschedulable")
            return None
        chosen = [infos[i] for i in feasible]
        fw.run_pre_score(state, snap, pod, chosen)
        scores = fw.run_scores(state, snap, pod, chosen)
        best = feasible[int(np.argmax(scores))]  # first max == lowest node index
        node_name = infos[best].node.name
        # assume: the assumed pod occupies capacity for the NEXT pod's cycle
        # while this one's binding runs
        self.cache.assume(pod.uid, node_name)
        st = fw.run_permit(state, snap, pod, node_name)
        if not st.ok:
            self.cache.forget(pod.uid)
            self.queue.add_unschedulable(pod, backoff=True)
            return None
        # coscheduling Permit-wait: a gang member holds its assumption until
        # minMember siblings are assumed or bound; the arrival that completes
        # the quorum binds every waiter
        if pod.pod_group and self.features.enabled("GangScheduling"):
            with self._gang_lock:
                waiters = self._gang_waiting.setdefault(pod.pod_group, [])
                # dedupe: a re-scheduled copy of an already-waiting member
                # REPLACES its entry, never inflates the quorum count
                waiters[:] = [w for w in waiters if w[0].uid != pod.uid]
                waiters.append((pod, node_name, state, snap))
                pg = snap.pod_groups.get(pod.pod_group)
                need = pg.min_member if pg else 1
                waiting_uids = {w[0].uid for w in waiters}
                bound = sum(
                    1
                    for q in snap.bound_pods
                    if q.pod_group == pod.pod_group and q.uid not in waiting_uids
                )
                if len(waiters) + bound < need:
                    return None  # waiting (assumed, not bound)
                waiters = self._gang_waiting.pop(pod.pod_group)
            out = None
            for wpod, wnode, wstate, wsnap in waiters:
                r = self._binding_cycle(wstate, wsnap, wpod, wnode, t0)
                if wpod.uid == pod.uid:
                    out = r
            return out
        if self._bind_pool is not None:
            # bindingCycle as its own goroutine overlapping the next pod's
            # schedulingCycle
            fut = self._bind_pool.submit(
                self._binding_cycle_safe, state, snap, pod, node_name, t0
            )
            with self._bind_lock:
                self._bind_futures = [f for f in self._bind_futures if not f.done()]
                self._bind_futures.append(fut)
            return node_name  # optimistic: assumed
        return self._binding_cycle(state, snap, pod, node_name, t0)

    def _binding_cycle_safe(self, state, snap, pod, node_name, t0) -> Optional[str]:
        """Worker-thread entry: an unexpected exception must not silently
        strand the assumed pod."""
        try:
            return self._binding_cycle(state, snap, pod, node_name, t0)
        except Exception as e:  # noqa: BLE001 — crash-only containment
            self.cache.forget(pod.uid)
            self.events.record("FailedScheduling", pod.uid,
                               message=f"binding error: {e}")
            self.queue.add_unschedulable(pod, backoff=True)
            self.metrics.inc("scheduling_attempts_error")
            return None

    def _binding_cycle(self, state, snap, pod, node_name, t0) -> Optional[str]:
        """PreBind -> Bind -> PostBind; failure forgets the assumption and
        requeues — schedule_one.go's bindingCycle, traced as binding.cycle
        under the pod's context (often on a binding-pool worker thread)."""
        if not self.tracer.enabled:
            return self._binding_cycle_inner(state, snap, pod, node_name, t0)
        with self.tracer.span_for_pod(
            pod.uid, "binding.cycle", pod=pod.uid, node=node_name
        ):
            return self._binding_cycle_inner(state, snap, pod, node_name, t0)

    def _binding_cycle_inner(self, state, snap, pod, node_name, t0) -> Optional[str]:
        fw = self._fw(pod) or self.framework
        st = fw.run_pre_bind(state, snap, pod, node_name)
        if st.ok:
            st = fw.run_bind(state, snap, pod, node_name)
        if not st.ok:
            self.cache.forget(pod.uid)
            self.queue.add_unschedulable(pod, backoff=True)
            return None
        fw.run_post_bind(state, snap, pod, node_name)
        self.queue.delete_nominated(pod.uid)
        self.events.record("Scheduled", pod.uid, node=node_name)
        self._observe_sli(pod.uid)
        dt = time.perf_counter() - t0
        self.metrics.observe("scheduling_attempt_duration_seconds", dt)
        self.metrics.inc("scheduling_attempts_scheduled")
        self.log.V(3).info("Scheduled pod", pod=pod.uid, node=node_name,
                           latency_ms=round(dt * 1e3, 2))
        return node_name

    def reject_incomplete_gangs(self) -> int:
        """Permit-timeout analog at a drain point: gangs still below quorum
        release their assumptions and requeue with backoff (the CPU-path
        equivalent of the batch fixpoint revoking a failed group)."""
        n = 0
        with self._gang_lock:
            drained = list(self._gang_waiting.items())
            self._gang_waiting.clear()
        for g, waiters in drained:
            for wpod, _wnode, _s, _sn in waiters:
                self.cache.forget(wpod.uid)
                self.events.record(
                    "FailedScheduling", wpod.uid,
                    message=f"gang {g} below quorum; Permit rejected",
                )
                self.queue.add_unschedulable(wpod, backoff=True)
                n += 1
        return n

    def wait_for_bindings(self) -> None:
        """Drain in-flight binding cycles; also a drain point for the batch
        path's deferred commit fan-out."""
        if self._dead or chaos.killed():
            return  # a SIGKILL'd process drains nothing
        self._flush_deferred_binds()
        if self._bind_pool is None:
            return
        while True:
            with self._bind_lock:
                pending = [f for f in self._bind_futures if not f.done()]
                self._bind_futures = pending
            if not pending:
                return
            for f in pending:
                f.result()

    # --- crash-restart & failover (checkpoint.py + leases.py) ---
    def _kill_point(self, site: str) -> None:
        """An enumerated process-death site: poke the injector and, when the
        plan kills here, mark this instance dead BEFORE the ProcessKilled
        unwinds (its finally-blocks must behave like a SIGKILL'd process)."""
        if not chaos.enabled():
            return
        try:
            chaos.poke(site, tracer=self.tracer, metrics=self.metrics)
        except chaos.ProcessKilled:
            self._dead = True
            # black-box dump on the way down — diagnostic only, never read
            # by restore() (flightrecorder.py)
            try:
                self._flight.dump(reason=site)
            except Exception:  # noqa: BLE001 — evidence must not mask the kill
                pass
            raise

    def _checkpoint_state(self) -> None:
        """Persist the crash-restart checkpoint (one fsync'd atomic file):
        assumed-pod ledger + deferred-commit WAL + in-flight wave + SLI
        arrival and pop ages — the state the watch cannot reconstruct.
        Invoked from the cache hook at every assume/forget, at every WAL
        append, at the wave WAL's clear, at flush completion and at the end
        of restore()."""
        if self._ckpt is None or self._dead or chaos.killed():
            return
        from .checkpoint import save_scheduler_state

        save_scheduler_state(
            self._ckpt,
            self.cache.assumed_snapshot(),
            [(p.uid, node) for p, node in self._deferred_binds],
            self.queue.export_arrivals(),
            lineage=self.store.lineage,
            wave=self._wave_wal,
            cursor=None,  # no open-loop replay driver in the port (ROADMAP A14)
            popped=self.queue.export_popped(),
        )

    def restore(self, killed_site: Optional[str] = None) -> Dict[str, int]:
        """The restart/takeover protocol: load the checkpoint, reconcile it
        against the relisted store, and leave the scheduler ready to resume.
        Runs on a FRESH instance (the constructor's watch replay already
        re-admitted every unbound pod and rebuilt the cache):

          1. restore arrival and pop ages, the blackout since the last save
             added to each (the SLI counts the dead time)
          2. replay the deferred-commit WAL exactly once: an entry whose pod
             is already bound was published before the kill (skip); an
             unbound one's verdict was durably decided, so publish it now
          3. count the assumed-but-unbound pods (their reservation died
             with the process; the watch replay requeued them) and the
             in-flight wave's unpublished remainder
          4. invalidate the class state and drop the encoder: the
             replacement's first cycle encodes cold and hoists in full

        Safe when no checkpoint exists (a pure crash-only rebuild), and a
        checkpoint of another cluster lineage is ignored.  killed_site (the
        chaos kill.* site that felled the previous incarnation) labels the
        recovery so injected and recovered counts reconcile.  Returns the
        report dict."""
        t0 = time.perf_counter()
        report = {
            "wal_applied": 0, "wal_skipped": 0, "reconciled_assumed": 0,
            "restored_arrivals": 0, "restored_popped": 0, "wave_requeued": 0,
        }
        doc = None
        if self._ckpt is not None:
            from .checkpoint import load_scheduler_state

            doc = load_scheduler_state(self._ckpt)
        if doc is not None and doc["lineage"] != self.store.lineage:
            # a checkpoint written against a DIFFERENT cluster: uids are
            # deterministic (namespace/name), so its WAL could bind
            # colliding pods of an unrelated workload — ignore it
            self.log.V(1).info(
                "Checkpoint from another cluster lineage ignored",
                checkpoint_lineage=doc["lineage"], store_lineage=self.store.lineage,
            )
            doc = None
        if doc:
            dead_s = max(0.0, time.time() - doc["saved_wall"]) if doc["saved_wall"] else 0.0
            report["restored_arrivals"] = self.queue.restore_arrivals(
                {u: a + dead_s for u, a in doc["arrivals"].items()}
            )
            # a pod popped into a wave before the kill keeps its queue_wait;
            # the dead time lands in wave_wait, where it passed
            report["restored_popped"] = self.queue.restore_popped(
                {u: a + dead_s for u, a in doc.get("popped", {}).items()}
            )
            node_names = set(self.store.list_node_names())
            for uid, node in doc["wal"]:
                cur = self.store.pods.get(uid)
                if cur is None or node not in node_names:
                    report["wal_skipped"] += 1  # pod/node gone while dead
                    continue
                if cur.node_name:
                    report["wal_skipped"] += 1  # already applied before the kill
                    continue
                self._publish_bind(uid, node)
                self.queue.delete(uid)  # drop the replay-admitted copy
                report["wal_applied"] += 1
            for uid, node in doc["assumed"].items():
                cur = self.store.pods.get(uid)
                if cur is not None and not cur.node_name:
                    report["reconciled_assumed"] += 1
            # the wave in flight at the kill splits three ways: published
            # prefix (the store shows it), durable suffix (the WAL above),
            # and the remainder the watch replay requeued — counted here
            wave = doc.get("wave")
            if wave:
                wal_uids = {u for u, _ in doc["wal"]}
                for uid in wave.get("uids", ()):
                    cur = self.store.pods.get(uid)
                    if cur is not None and not cur.node_name and uid not in wal_uids:
                        report["wave_requeued"] += 1
        # crash-only rule: the resident device state rebuilds from scratch
        if self._hoist_cache is not None:
            self._hoist_cache.invalidate()
        self._delta_enc = None
        self._deferred_binds = []
        self.metrics.inc("scheduler_restarts_total")
        self._checkpoint_state()  # persist the clean post-restore slate
        dt = time.perf_counter() - t0
        if self.tracer.enabled:
            self.tracer.record_span("scheduler.restore", start=t0, end=t0 + dt, **report)
        if killed_site is not None:
            chaos.record_recovery(
                killed_site, "restore", tracer=self.tracer,
                metrics=self.metrics, start=t0, **report,
            )
        self.log.V(1).info("Scheduler state restored", **report)
        return report

    def detach(self) -> None:
        """Disconnect a DEAD incarnation from the store's watch fan-out (the
        OS reclaiming a killed process's watch connections).  The instance
        stays inert afterwards (every drain/flush path returns on _dead)."""
        self._dead = True
        self.store.unwatch(self._on_event)
        self.store.unwatch(self.cache._on_event)

    # --- the batch cycle ---
    def schedule_batch(self) -> Dict[str, Optional[str]]:
        """Drain the activeQ and schedule the whole batch in one cycle.

        Multi-profile batches group by spec.schedulerName and the
        per-profile programs run back-to-back within THIS cycle; the
        round-robin lead decides which profile sees free capacity first.
        Gang members always ride ONE program — the PodGroup's first-seen
        member's profile."""
        t0 = time.perf_counter()
        if self.last_wave_phases:
            # per-cycle phase anatomy: this cycle's binds repopulate it
            self.last_wave_phases = {}
        self._sample_queue_depths()  # pre-drain: the activeQ's true depth
        batch: List[t.Pod] = self.queue.pop_all()
        if not batch:
            return {}
        with self.tracer.span("batch.cycle", pods=len(batch)):
            return self._schedule_batch_traced(batch, t0)

    def _sample_queue_depths(self) -> None:
        """Per-pool queue-depth gauges (activeQ / backoff / unschedulable /
        parked), sampled at each cycle boundary, with `_peak` high-water
        marks."""
        for pool, v in self.queue.depths().items():
            self.metrics.set(f"queue_pool_{pool}_pods", v)
            self.metrics.set_max(f"queue_pool_{pool}_pods_peak", v)

    def _schedule_batch_traced(
        self, batch: List[t.Pod], t0: float
    ) -> Dict[str, Optional[str]]:
        names = [p.scheduler_name or self.default_profile_name for p in batch]
        gang_profile: Dict[str, str] = {}
        if self.features.enabled("GangScheduling"):
            # with the gate off, pod_group is inert everywhere
            for p, n in zip(batch, names):
                if p.pod_group and p.pod_group not in gang_profile:
                    gang_profile[p.pod_group] = n
        for k, p in enumerate(batch):
            if p.pod_group in gang_profile and names[k] != gang_profile[p.pod_group]:
                coalesced = gang_profile[p.pod_group]
                self.events.record(
                    "GangProfileCoalesced", p.uid,
                    message=(
                        f"PodGroup {p.pod_group} members span schedulerNames; "
                        f"scheduling gang under profile {coalesced!r}"
                    ),
                )
                names[k] = coalesced
        present = list(dict.fromkeys(names))  # first-appearance order
        if len(present) > 1 and self._last_profile_served in present:
            i = (present.index(self._last_profile_served) + 1) % len(present)
            present = present[i:] + present[:i]
        self._last_profile_served = present[0]
        result: Dict[str, Optional[str]] = {}
        n_failed = 0
        for profile_name in present:
            group = [p for p, n in zip(batch, names) if n == profile_name]
            r, nf = self._schedule_profile_batch(profile_name, group)
            result.update(r)
            n_failed += nf
        dt = time.perf_counter() - t0
        self.log.V(2).info("Batch scheduled", batch=len(batch),
                           profiles=len(present),
                           scheduled=len(batch) - n_failed,
                           unschedulable=n_failed,
                           duration_ms=round(dt * 1e3, 1))
        self.metrics.observe("batch_scheduling_duration_seconds", dt)
        self.metrics.inc("scheduling_attempts_scheduled", len(batch) - n_failed)
        self.metrics.inc("scheduling_attempts_unschedulable", n_failed)
        self.metrics.set("pending_pods", self.queue.pending_total)
        self._sample_queue_depths()  # post-commit: requeues landed
        return result

    def _schedule_profile_batch(
        self, profile_name: str, batch: List[t.Pod]
    ) -> Tuple[Dict[str, Optional[str]], int]:
        """One profile's slice of the cycle: encode → kernel (or sidecar /
        native engine) → bind → preempt-on-failure.  Returns (pod name ->
        node | None, #unschedulable).  Bindings apply to the store/cache synchronously,
        so the next profile's update_snapshot sees them."""
        snap = self.cache.update_snapshot()
        bound_uids = {p.uid for p in snap.bound_pods}
        batch_uids = {p.uid for p in batch}
        node_names = {nd.name for nd in snap.nodes}
        # reserve out-of-batch nominated pods (still in backoff after their
        # preemption) by treating them as bound to their nominated node
        reserved = [
            replace_pod_nodename(q, node)
            for uid, (q, node) in self.queue.nominated.items()
            if uid not in batch_uids and uid not in bound_uids and node in node_names
        ]
        snap = Snapshot(
            nodes=snap.nodes,
            pending_pods=[p for p in batch if p.uid not in bound_uids],
            bound_pods=snap.bound_pods + reserved,
            pod_groups=snap.pod_groups,
            pvs=snap.pvs,
            pvcs=snap.pvcs,
            storage_classes=snap.storage_classes,
            resource_slices=snap.resource_slices,
            device_classes=snap.device_classes,
        )
        gang = self.features.enabled("GangScheduling")
        prof = self.config.profile(profile_name)
        batch_fw = self.frameworks[profile_name]
        verdicts: Optional[Dict[str, Optional[str]]] = None  # uid -> node|None
        offload = prof.tpu_score is not None and prof.tpu_score.sidecar_address != "local"
        if offload:
            # the wire carries hardPodAffinityWeight but not arbitrary plugin
            # weights: a profile with customized score weights schedules
            # in-process
            from dataclasses import replace as _dc_replace

            want_cfg = self.config.score_config(profile_name)
            if want_cfg != _dc_replace(
                type(want_cfg)(),
                hard_pod_affinity_weight=want_cfg.hard_pod_affinity_weight,
            ):
                offload = False
        if offload:
            # sidecar cycles have no async-dispatch window: publish the
            # previous cycle's deferred fan-out first
            self._flush_deferred_binds()
            from ..runtime.client import SidecarUnavailable, TPUScoreClient

            try:
                addr = prof.tpu_score.sidecar_address
                if self._sidecars.get(addr) is None:
                    self._sidecars[addr] = TPUScoreClient(
                        addr, metrics=self.metrics
                    )
                self._sidecar = self._sidecars[addr]
                verdicts = self._sidecar.schedule(
                    snap,
                    deadline_ms=prof.tpu_score.deadline_ms,
                    gang=gang,
                    hard_pod_affinity_weight=prof.hard_pod_affinity_weight,
                )
            except SidecarUnavailable:
                self.metrics.inc("tpuscore_fallback_total")
                result = {}
                for pod in snap.pending_pods:
                    result[pod.name] = self.schedule_one(pod)
                # the fallback is a drain point: gangs still short of quorum
                # reject here, preserving the batch path's all-or-nothing
                self.wait_for_bindings()
                self.reject_incomplete_gangs()
                n_unbound = 0
                for pod in snap.pending_pods:
                    cur = self.store.pods.get(pod.uid)
                    result[pod.name] = (cur.node_name or None) if cur else None
                    n_unbound += result[pod.name] is None
                return result, n_unbound
        arr = host = meta = None  # the cycle's arrays (batched preemption reuses them)
        native = self.config.mode == "native"
        # only the routed non-gang step has the async window the NEXT
        # cycle's deferred fan-out hides under
        async_window = False
        if verdicts is None:
            base_cfg = self.config.score_config(profile_name)
            if (
                self._delta_enc is None
                or self._delta_enc.hpaw != base_cfg.hard_pod_affinity_weight
            ):
                from ..api.delta import DeltaEncoder

                self._delta_enc = DeltaEncoder(
                    self.device,
                    hard_pod_affinity_weight=base_cfg.hard_pod_affinity_weight,
                )
            with self.tracer.span("batch.encode", profile=profile_name):
                host, meta = self._delta_enc.encode(snap)
                if not native:
                    arr, meta = self._delta_enc.to_device(host, meta)
            if chaos.enabled():
                # slow-host stall inside the encode window: latency only
                chaos.poke("host.stall", tracer=self.tracer,
                           metrics=self.metrics)
            cfg = infer_score_config(host, base_cfg)
            # resident class state (ops/incremental.py): serves the gang
            # fixpoint too — revocations only mask pod_valid, which the
            # class state leaves out.  The native engine keeps none;
            # recovery replays run without it.
            from ..ops.assign import inc_route_applies

            inc = None
            if not native and inc_route_applies(host, cfg):
                if self._hoist_cache is None:
                    from ..ops.incremental import HoistCache

                    self._hoist_cache = HoistCache(mesh=self.mesh)
                inc = self._hoist_cache.ensure(arr, meta, cfg, host=host)
            ords = sweeps = None
            from .tracing import incremental_attrs, mesh_attrs

            with self.tracer.span(
                "batch.kernel", profile=profile_name, mode=self.config.mode,
                **mesh_attrs(self.mesh),
                **(incremental_attrs(self._hoist_cache) if inc is not None
                   else {}),
            ):
                t_k0 = time.perf_counter()
                if native:
                    from ..native import schedule_batch_native, schedule_with_gangs_native

                    # synchronous host engine: no async window — commit the
                    # previous cycle's deferred fan-out before it runs
                    self._flush_deferred_binds()
                    fn = schedule_with_gangs_native if gang else schedule_batch_native
                    choices = fn(host, cfg)[0]
                    if not gang:
                        # the engine commits strictly in pod order: the
                        # ordinal IS the index, and every pod is one sweep
                        ords = np.arange(meta.n_pods, dtype=np.int64)
                        sweeps = meta.n_pods
                elif gang:
                    # the gang fixpoint reads its verdicts back between
                    # iterations, so there is no single-dispatch window:
                    # flush first
                    self._flush_deferred_binds()
                    try:
                        fault = (
                            chaos.poke("scheduler.step", tracer=self.tracer,
                                       metrics=self.metrics)
                            if chaos.enabled() else None
                        )
                        from ..ops.gang import schedule_with_gangs

                        choices, _, ords, sweeps = schedule_with_gangs(
                            arr, cfg, with_ordinals=True, inc=inc,
                            device=self.device, mesh=self.mesh,
                        )
                        # kill.mid_step: process death with the fixpoint's
                        # last step unfetched — a BaseException the recovery
                        # below can NOT catch
                        self._kill_point("kill.mid_step")
                        choices, ords = self._fetch(choices, ords)
                        if fault is not None and fault.action == "nan":
                            choices = chaos.poison(choices)
                        if chaos.poisoned_verdicts(
                            choices, len(meta.node_names)
                        ):
                            raise chaos.PoisonedWave(profile_name)
                    except Exception as e:  # noqa: BLE001 — wave recovery
                        choices, ords, sweeps = self._recover_batch_step(
                            arr, cfg, meta, e, gang=True
                        )
                else:
                    from ..ops.assign import dispatch, finish

                    try:
                        fault = (
                            chaos.poke("scheduler.step", tracer=self.tracer,
                                       metrics=self.metrics)
                            if chaos.enabled() else None
                        )
                        # launched without a host synchronisation
                        step = dispatch(arr, cfg, self.device, inc=inc,
                                        mesh=self.mesh)
                        # kill.mid_step: process death with the device step
                        # still in flight
                        self._kill_point("kill.mid_step")
                        # step i runs on the card: the deferred
                        # bind/events fan-out of step i−1 executes NOW,
                        # inside the device window — the commit overlap
                        self._flush_deferred_binds()
                        step = finish(step)
                        sweeps = step.sweeps
                        choices, ords = self._fetch(step.choices, step.ordinals)
                        if fault is not None and fault.action == "nan":
                            choices = chaos.poison(choices)
                        if chaos.poisoned_verdicts(
                            choices, len(meta.node_names)
                        ):
                            raise chaos.PoisonedWave(profile_name)
                    except Exception as e:  # noqa: BLE001 — wave recovery
                        choices, ords, sweeps = self._recover_batch_step(
                            arr, cfg, meta, e
                        )
                    async_window = True
            uid_of = {p.name: p.uid for p in snap.pending_pods}
            if ords is not None:
                self._observe_wave_latency(
                    ords[: meta.n_pods],
                    time.perf_counter() - t_k0,
                    int(sweeps),
                    uids=([uid_of[meta.pod_names[k]]
                           for k in range(meta.n_pods)]
                          if self.tracer.enabled else None),
                )
                if self.tracer.enabled and self.last_wave_estimates:
                    # phase-decomposition marks: the kernel dispatch instant
                    # and the pod's decision-ready instant, consumed at bind
                    # publication
                    for uid, est in self.last_wave_estimates.items():
                        self._phase_marks[uid] = (t_k0, t_k0 + est)
            verdicts = {
                uid_of[meta.pod_names[k]]: (
                    meta.node_names[int(choices[k])] if int(choices[k]) >= 0 else None
                )
                for k in range(meta.n_pods)
            }
        result: Dict[str, Optional[str]] = {}
        failed: List[t.Pod] = []
        # Deferred-commit gate: capacity is reserved through cache.assume
        # synchronously either way, so the store/events/queue fan-out may
        # lag into the NEXT cycle's device window without changing any
        # encode — PROVIDED the fan-out's move events could wake nobody (no
        # parked pods) and the pod needs no volume commitment
        defer_ok = (
            self._pipeline_commit
            and self._cycle_streaming
            and async_window
            and self.queue.parked_total == 0
        )
        # assumed_now tracks this cycle's reservations so a crash mid-commit
        # releases them
        assumed_now: List[str] = []
        done: set = set()  # pod names whose commit disposition fully landed
        # wave WAL: before the first assume of this commit wave, record its
        # membership + verdict crc in the checkpoint, so a kill anywhere
        # inside the wave leaves restore() enough to reconcile it (built
        # only when a checkpoint is armed: the crc is an O(P) pass; cleared
        # and re-persisted once the wave fully lands)
        if self._ckpt is not None:
            from .flightrecorder import fingerprint

            bound = {u: n for u, n in verdicts.items() if n is not None}
            self._wave_wal = {
                "uids": sorted(bound),
                "verdict_crc": fingerprint({u: bound[u] for u in sorted(bound)}),
            }

        def placed():
            """The cycle's arrays on the device; the native engine read the
            host arrays, so its cycle places them only for the failure path."""
            nonlocal arr
            if arr is None:
                arr, _ = self._delta_enc.to_device(host, meta)
            return arr

        try:
            self._commit_profile_batch(
                profile_name, snap, verdicts, result, failed, defer_ok,
                assumed_now, done, placed, host, meta, batch_fw,
            )
        except Exception:
            self._release_crashed_commit(snap, done, assumed_now)
            raise
        finally:
            if self._wave_wal is not None:
                self._wave_wal = None
                # persist the cleared wave record; on a kill this is a no-op
                # (_checkpoint_state returns on killed()), so the wave stays
                # durable for the restore to reconcile
                self._checkpoint_state()
        self._flight_record(profile_name, snap, result, len(failed), meta)
        return result, len(failed)

    @staticmethod
    def _fetch(choices, ords) -> Tuple[np.ndarray, np.ndarray]:
        """The step's choices and ordinals on the host, in one copy back."""
        import torch

        both = torch.stack((choices.to(torch.int32), ords.to(torch.int32))).cpu().numpy()
        return both[0], both[1]

    def _diagnose_failed(self, snap, result, arr, host, meta, failed) -> Dict[str, str]:
        """Device-path unschedulable diagnosis (ops/explain.py): one
        evaluation over the FAILED equivalence classes (kernel K14 on the
        card), decoded to upstream-shaped per-pod messages against
        POST-CYCLE usage — cycle-start node_used plus the requests this
        cycle's commits placed (`result`).  The usage and the requests are
        read from the cycle's host arrays, never from the card."""
        from ..ops.explain import diagnose_failed

        t0 = time.perf_counter()
        row_of = {name: k for k, name in enumerate(meta.pod_names)}
        node_row = {name: j for j, name in enumerate(meta.node_names)}
        used = np.array(host.node_used, copy=True)
        pod_req = np.asarray(host.pod_req)
        for p in snap.pending_pods:
            k = row_of.get(p.name)
            j = node_row.get(result.get(p.name) or "")
            if k is not None and j is not None:
                used[j] += pod_req[k]
        rows = [row_of[p.name] for p in failed if p.name in row_of]
        messages, dominant, records = diagnose_failed(arr, meta, rows, used)
        self._last_diagnosis = records
        msgs: Dict[str, str] = {}
        for p in failed:
            r = row_of.get(p.name)
            if r in messages:
                msgs[p.uid] = messages[r]
                self.metrics.inc_labeled(
                    "pod_unschedulable_reasons_total", reason=dominant[r]
                )
        dt = time.perf_counter() - t0
        self.metrics.observe("scheduling_explain_duration_seconds", dt)
        if self.tracer.enabled:
            self.tracer.record_span(
                "batch.explain", start=t0, end=t0 + dt,
                failed=len(failed), classes=len(records),
            )
        return msgs

    def _flight_record(self, profile_name, snap, result, n_failed, meta) -> None:
        """One compact decision record per profile batch for the flight
        recorder's ring — fingerprints, not payloads.  Armed by the
        checkpoint dir: without one nothing can ever dump the ring, so the
        cycle skips even the O(P) fingerprint passes."""
        if not self._flight.directory:
            return
        from .flightrecorder import fingerprint
        from .tracing import current_trace_id

        rec = {
            "ts": time.time(),
            "profile": profile_name,
            "mode": self.config.mode,
            "pods": len(snap.pending_pods),
            "scheduled": sum(1 for v in result.values() if v),
            "failed": n_failed,
            "verdict_crc": fingerprint(result),
            "trace_id": current_trace_id(),
        }
        if meta is not None:
            rec["classes"] = meta.n_classes
            if meta.pod_class is not None:
                rec["class_crc"] = fingerprint(meta.pod_class)
            rec["dirty_cols"] = int(meta.dirty_nodes.size) if meta.dirty_nodes is not None else -1
        if self._last_diagnosis:
            rec["diagnosis"] = self._last_diagnosis
        if self.last_wave_phases:
            # the latency anatomy of the pods bound this cycle (tracer-gated)
            rec["sli_phases"] = _sli_phase_block(self.last_wave_phases)
        self._flight.record(**rec)

    def _commit_profile_batch(
        self, profile_name, snap, verdicts, result, failed, defer_ok,
        assumed_now, done, placed, host, meta, batch_fw,
    ) -> None:
        """The bind fan-out and the failure loop.  `host` is the cycle's host
        arrays (None on the sidecar's verdicts), `placed()` the same on the
        device, placed at its first call."""
        with self.tracer.span("batch.commit", profile=profile_name), \
                self._coalesced_moves():
            for pod in snap.pending_pods:
                node_name = verdicts.get(pod.uid)
                if node_name and pod.pvcs:
                    # PreBind volume commitment (static match / provisioning);
                    # failure sends the pod down the ordinary retry path
                    from .volumebinder import bind_pod_volumes

                    err = bind_pod_volumes(self.store, pod, node_name)
                    if err is not None:
                        node_name = None
                if node_name:
                    self.cache.assume(pod.uid, node_name)
                    assumed_now.append(pod.uid)
                    self._kill_point("kill.post_checkpoint")
                    if defer_ok and not pod.pvcs:
                        self._deferred_binds.append((pod, node_name))
                        # WAL append before the publication window: a
                        # restart replays this verdict exactly once
                        self._checkpoint_state()
                        result[pod.name] = node_name
                        done.add(pod.name)
                        continue
                    self._publish_bind(pod.uid, node_name)
                    result[pod.name] = node_name
                    done.add(pod.name)
                else:
                    failed.append(pod)
                    result[pod.name] = None
                    # a failed pod's retry wave re-stamps fresh marks
                    self._phase_marks.pop(pod.uid, None)
            if failed:
                # the preemption loop below reads AND mutates the store
                # (victim evictions): the deferred fan-out lands first
                self._flush_deferred_binds()
            # on-demand unschedulable diagnosis (KTPU_EXPLAIN=1): only
            # failing cycles pay, and only for the failed classes
            diag_msgs: Dict[str, str] = {}
            self._last_diagnosis = []
            if failed and host is not None:
                from ..ops.explain import explain_enabled

                if explain_enabled():
                    diag_msgs = self._diagnose_failed(
                        snap, result, placed(), host, meta, failed
                    )
            # failure path: preemption, then requeue.  Three lazily
            # maintained pieces, each invalidated only by what stales it:
            #   snap2    fresh resolved snapshot + bound-priority counts
            #            (None = rebuild); batched evictions update the
            #            counts incrementally
            #   state    the CPU PostFilter's what-if ScaledState — built
            #            only when a pod actually takes the CPU branch
            #   batched  ops/preempt.py's evaluator with its own
            #            incremental ledger; dropped only when a CPU-path
            #            eviction happens outside that ledger
            from collections import Counter

            state = None
            snap2 = None
            # True while snap2 exactly reflects the store (no eviction since
            # it was resolved)
            snap2_fresh = False
            batched = None
            use_batched = (
                host is not None
                and self.features.enabled("BatchedPreemption")
                and self.features.enabled("DefaultPreemption")
            )
            min_bound_prio: Optional[int] = None
            bound_prios: Counter = Counter()
            for pod_i, pod in enumerate(failed):
                if snap2 is None:
                    from ..api.volumes import resolve_snapshot

                    snap2 = resolve_snapshot(self.cache.update_snapshot())
                    snap2_fresh = True
                    state = None  # what-if state pinned to the old snapshot
                    bound_prios = Counter(
                        q.priority for q in snap2.bound_pods
                    )
                    min_bound_prio = (
                        min(bound_prios) if bound_prios else None
                    )
                    if use_batched and batched is None:
                        from .preemption import BatchedPreemption

                        batched = BatchedPreemption(
                            placed(), meta, snap2, self.store, self.queue
                        )
                        # evaluate-many: batch the gate-passing preemptors
                        # of the unprocessed suffix into device waves
                        if min_bound_prio is not None:
                            batched.prefetch([
                                q for q in failed[pod_i:]
                                if q.priority > min_bound_prio
                            ])
                self.events.record("FailedScheduling", pod.uid,
                                   message=diag_msgs.get(pod.uid, ""))
                if min_bound_prio is None or pod.priority <= min_bound_prio:
                    if batched is not None:
                        batched.note_nomination_cleared(pod)
                    self._clear_nomination(pod)
                elif batched is not None and batched.applicable(pod):
                    # device-vectorized victim search (decision-identical to
                    # the CPU evaluator within its gate)
                    res = batched.evaluate(pod)
                    if res is not None:
                        node_name, victims = res
                        for q in victims:
                            self.store.delete_pod(q.uid)
                            bound_prios[q.priority] -= 1
                            if bound_prios[q.priority] <= 0:
                                del bound_prios[q.priority]
                        min_bound_prio = (
                            min(bound_prios) if bound_prios else None
                        )
                        self.metrics.inc("preemption_victims", len(victims))
                        batched.apply_eviction(node_name, victims)
                        self.events.record("Preempted", pod.uid, node=node_name)
                        # a nomination carried from a prior cycle moves OFF
                        # its old node here
                        batched.note_nomination_cleared(pod)
                        self._nominate(pod, node_name)
                        state = None  # CPU what-if (if built) is stale now
                        snap2_fresh = False  # eviction went through the store
                    else:
                        batched.note_nomination_cleared(pod)
                        self._clear_nomination(pod)
                else:
                    if state is None:
                        # lazy CPU what-if: only pods outside the batched
                        # gate pay for it; snap2 is reused while fresh
                        if not snap2_fresh:
                            from ..api.volumes import resolve_snapshot

                            snap2 = resolve_snapshot(
                                self.cache.update_snapshot()
                            )
                            snap2_fresh = True
                        infos = self.cache.node_infos(snap2)
                        state = CycleState()
                        state.data["scaled"] = ScaledState(snap2, infos)
                    nominated, pst = batch_fw.run_post_filters(state, snap2, pod, {})
                    if pst.ok and nominated:
                        self.events.record("Preempted", pod.uid, node=nominated)
                        self._nominate(pod, nominated)
                        state = None  # evictions changed the cluster: rebuild lazily
                        snap2 = None
                        if batched is not None:
                            batched = None  # CPU path evicted outside our ledger
                    else:
                        if batched is not None:
                            batched.note_nomination_cleared(pod)
                        self._clear_nomination(pod)
                self.queue.add_unschedulable(pod, backoff=True)
                done.add(pod.name)

    def _release_crashed_commit(
        self, snap, done: set, assumed_now: List[str]
    ) -> None:
        """A crash mid-commit must not leak: publish the already-deferred
        binds, release every other assumption this cycle made, and requeue
        the pods whose disposition never landed.  The exception itself
        re-raises."""
        t0 = time.perf_counter()
        try:
            self._flush_deferred_binds()
        except Exception:  # noqa: BLE001 — flush keeps its tail deferred
            pass  # the retained binds hold their assumes; a later drain retries
        deferred_uids = {p.uid for p, _ in self._deferred_binds}
        released = 0
        for uid in assumed_now:
            if uid in deferred_uids:
                continue  # still slated to bind: the reservation must hold
            cur = self.store.pods.get(uid)
            if cur is None or not cur.node_name:
                self.cache.forget(uid)
                released += 1
        requeued = 0
        for pod in snap.pending_pods:
            if pod.name in done or pod.uid in deferred_uids:
                continue
            cur = self.store.pods.get(pod.uid)
            if cur is not None and not cur.node_name:
                self.queue.add(pod)
                requeued += 1
        self.metrics.inc("scheduling_attempts_error")
        self.log.V(1).info("Batch commit crashed; released assumptions",
                           released=released, requeued=requeued)
        chaos.record_recovery(
            "scheduler.commit", "assume_release", tracer=self.tracer,
            metrics=self.metrics, start=t0, released=released,
            requeued=requeued,
        )

    def _recover_batch_step(self, arr, cfg, meta, err: BaseException,
                            gang: bool = False):
        """Serial replay of a batch wave that died on the device (a launch
        error or a poisoned read back): the previous cycle's deferred
        fan-out flushes first, then the same routes run again with no class
        state, so the replay's verdicts are the ones the fault killed."""
        t0 = time.perf_counter()
        self._flush_deferred_binds()
        if gang:
            from ..ops.gang import schedule_with_gangs

            choices, _, ords, sweeps = schedule_with_gangs(
                arr, cfg, with_ordinals=True, device=self.device, mesh=self.mesh
            )
        else:
            from ..ops.assign import dispatch, finish

            choices, _, ords, sweeps = finish(
                dispatch(arr, cfg, self.device, mesh=self.mesh)
            )
        choices, ords = self._fetch(choices, ords)
        if chaos.poisoned_verdicts(choices, len(meta.node_names)):
            raise chaos.PoisonedWave(
                "serial replay still poisoned — not a transient fault"
            ) from err
        self.metrics.inc("scheduling_wave_recoveries_total")
        self.log.V(1).info("Batch wave recovered by serial replay",
                           error=type(err).__name__)
        chaos.record_recovery(
            "scheduler.step", "serial_replay", tracer=self.tracer,
            metrics=self.metrics, start=t0, error=type(err).__name__,
        )
        # a wave that needed serial replay is parity evidence: dump the
        # decision ring next to the checkpoint
        self._flight.dump(reason=f"wave_recovery:{type(err).__name__}")
        return choices, ords, sweeps

    def _flush_deferred_binds(self) -> None:
        """Commit the deferred bind/events/queue fan-out of the previous
        batch cycle — inside the NEXT cycle's device-step window or at a
        drain point, always before anything that reads bind-visible state
        the serial loop would have seen.  Every deferred pod was
        cache.assume()d at verdict time, so encodes already counted it as
        bound; the deferral only moves the store publication, its watch
        fan-out (a no-op move: the gate required zero parked pods) and the
        Scheduled event later in wall time."""
        if not self._deferred_binds or self._dead or chaos.killed():
            return  # nothing deferred, or a dead process publishes nothing
        binds, self._deferred_binds = self._deferred_binds, []
        t0 = time.perf_counter()
        k = 0
        try:
            with self._coalesced_moves():
                for k, (pod, node_name) in enumerate(binds):
                    self._kill_point("kill.mid_flush")
                    cur = self.store.pods.get(pod.uid)
                    if cur is None:
                        # deleted (or preempted) while deferred: never
                        # resurrect the pod as bound
                        self.cache.forget(pod.uid)
                        self._phase_marks.pop(pod.uid, None)
                        continue
                    if cur.node_name == node_name:
                        continue  # already published (a crashed flush retried)
                    self._publish_bind(pod.uid, node_name)
        except Exception:
            # keep the failed bind and the unprocessed tail deferred (their
            # assumes stay held) so a later flush or drain retries them
            self._deferred_binds = binds[k:] + self._deferred_binds
            raise
        # flush complete: the WAL drains with it (a later restart must not
        # replay what the store already shows)
        self._checkpoint_state()
        dt = time.perf_counter() - t0
        self.metrics.observe("pipeline_deferred_commit_seconds", dt)
        if self.tracer.enabled:
            self.tracer.record_span(
                "commit_overlap", start=t0, end=t0 + dt, pods=len(binds),
            )

    def _publish_bind(self, pod_uid: str, node_name: str) -> None:
        """The bind publication fan-out, shared VERBATIM by the synchronous
        commit loop and the deferred flush: store bind + per-pod bind span +
        nomination cleanup + Scheduled event."""
        t_b0 = time.perf_counter()
        self.store.bind(pod_uid, node_name)
        if self.tracer.enabled:
            self.tracer.record_span(
                "bind", start=t_b0, pod_uid=pod_uid,
                pod=pod_uid, node=node_name,
            )
        self.queue.delete_nominated(pod_uid)
        self.events.record("Scheduled", pod_uid, node=node_name)
        self._observe_sli(pod_uid)

    def _observe_sli(self, pod_uid: str) -> None:
        """Record the pod's TRUE arrival -> bind latency at the instant its
        bind became visible (a deferred pod's SLI includes the deferral)."""
        arrived = self.queue.take_arrival(pod_uid)
        if arrived is None:
            self._phase_marks.pop(pod_uid, None)
            return  # bound outside the queue's lifecycle (direct store bind)
        now = time.perf_counter()
        sli = now - arrived
        self._sli_hist.observe(sli)
        if not self.tracer.enabled:
            return
        self._observe_sli_phases(pod_uid, arrived, now)

    def _observe_sli_phases(
        self, pod_uid: str, arrived: float, now: float
    ) -> None:
        """Decompose one pod's SLI into the four adjacent phase windows
        (metrics.py — SLI_PHASES), clamped to a monotone chain arrived <=
        popped <= k0 <= ready <= now so the phases sum to the SLI."""
        marks = self._phase_marks.pop(pod_uid, None)
        popped = self.queue.take_popped(pod_uid)
        if popped is None:
            popped = arrived
        popped = min(max(arrived, popped), now)
        k0, ready = marks if marks is not None else (popped, popped)
        k0 = min(max(popped, k0), now)
        ready = min(max(k0, ready), now)
        phases = {
            "queue_wait": popped - arrived,
            "wave_wait": k0 - popped,
            "device_kernel": ready - k0,
            "bind": now - ready,
        }
        for ph, v in phases.items():
            self._phase_hists[ph].observe(v)
        if marks is not None:
            # batch-wave pods only: the flight recorder's per-cycle latency
            # anatomy (cleared at each batch-cycle start, so bounded)
            self.last_wave_phases[pod_uid] = phases

    def _observe_wave_latency(
        self, ordinals: np.ndarray, t_kernel: float, sweeps: int,
        uids: Optional[List[str]] = None,
    ) -> None:
        """Per-pod estimated scheduling latency within one batch wave: pod
        i's decision became available ~(ordinal+1)/sweeps of the way
        through the kernel wall (the ordinal is the index of the device
        sweep that decided it, each route's own)."""
        if ordinals.size == 0 or sweeps <= 0:
            return
        est = (ordinals.astype(np.float64) + 1.0) * (t_kernel / float(sweeps))
        self.metrics.observe_many(
            "scheduling_attempt_duration_estimate_seconds", est
        )
        if uids is not None and self.tracer.enabled:
            self.last_wave_estimates = dict(zip(uids, est.tolist()))

    def _nominate(self, pod: t.Pod, node_name: str) -> None:
        """Record the nomination (queue nominator) and publish it on the pod's
        status (the reference's PATCH of status.nominatedNodeName)."""
        import copy

        q = copy.copy(pod)
        q.nominated_node_name = node_name
        self.queue.add_nominated(q, node_name)
        if pod.uid in self.store.pods:
            self.store.update_pod_status(q)

    def _clear_nomination(self, pod: t.Pod) -> None:
        """clearNominatedNode: a failed retry that produced no fresh nomination
        must not leave a phantom reservation blocking the node."""
        import copy

        self.queue.delete_nominated(pod.uid)
        cur = self.store.pods.get(pod.uid)
        if cur is not None and cur.nominated_node_name:
            q = copy.copy(cur)
            q.nominated_node_name = ""
            self.store.update_pod_status(q)

    # --- driver ---
    def run_until_idle(self, max_cycles: Optional[int] = None,
                       stall_limit: int = 1000) -> None:
        """Schedule until the activeQ drains to a fixpoint (backoff and
        unschedulable pods wait for their clock/events — the tests advance
        a FakeClock).

        With max_cycles=None (the default) this drains completely and raises
        RuntimeError if stall_limit consecutive cycles make no scheduling
        progress while the queue stays non-empty.  An explicit max_cycles
        bounds the work and returns possibly-non-idle."""
        self._cycle_streaming = True  # deferred commits may span cycles here
        try:
            self._run_until_idle_loop(max_cycles, stall_limit)
        finally:
            self._cycle_streaming = False
            self._flush_deferred_binds()

    def _run_until_idle_loop(self, max_cycles, stall_limit) -> None:
        cycles = 0
        stall = 0
        while max_cycles is None or cycles < max_cycles:
            cycles += 1
            # progress = a pod bound, or the activeQ net-shrank
            q_before = len(self.queue)
            if self.config.mode in ("tpu", "native"):
                result = self.schedule_batch()
                scheduled = any(v is not None for v in result.values())
                if not result:
                    self.wait_for_bindings()  # sidecar-fallback cycles
                    if not len(self.queue):
                        return
            else:
                pod = self.queue.pop()
                if pod is None:
                    # a failed async bind may requeue a pod after the drain
                    self.wait_for_bindings()
                    pod = self.queue.pop()
                    if pod is None:
                        # quiescence = the Permit-timeout drain point
                        self.reject_incomplete_gangs()
                        return
                scheduled = self.schedule_one(pod) is not None
            stall = 0 if scheduled or len(self.queue) < q_before else stall + 1
            if max_cycles is None and stall >= stall_limit:
                self.wait_for_bindings()
                raise RuntimeError(
                    f"run_until_idle: no scheduling progress after {stall} "
                    f"consecutive cycles with {self.queue.pending_total} pods "
                    "still pending (non-quiescent workload)"
                )
        self.wait_for_bindings()


def reincarnate(dead: Scheduler) -> Scheduler:
    """Build (but do NOT restore) the replacement incarnation on a dead
    scheduler's store: the same config, checkpoint dir and device, sharing
    the collector, Metrics, backoff clock, PodGroups and event sink (the
    apiserver's, which outlives the process).  The constructor's watch
    replay re-admits every unbound pod; the caller (restart_scheduler or an
    HAReplica takeover) runs restore()."""
    sched = Scheduler(
        dead.store,
        dead.config,
        clock=dead.queue.clock,
        collector=dead.collector,
        metrics=dead.metrics,
        checkpoint_dir=dead._ckpt.directory if dead._ckpt is not None else None,
        device=dead.device,
    )
    sched.cache.pod_groups.update(dead.cache.pod_groups)
    sched.events = dead.events
    return sched


def restart_scheduler(dead: Scheduler, killed_site: Optional[str] = None) -> Scheduler:
    """The crash-restart driver step: detach the killed incarnation's watch
    subscriptions, clear the kill latch, and bring up + restore() the
    replacement on the SAME store.  killed_site (ProcessKilled.fault.site)
    labels the recovery."""
    dead.detach()
    chaos.revive()
    sched = reincarnate(dead)
    sched.restore(killed_site=killed_site)
    return sched


def run_restartable(sched: Scheduler, max_restarts: int = 64) -> Tuple[Scheduler, int]:
    """Drive run_until_idle across kill.* chaos faults: every ProcessKilled
    is answered with restart_scheduler and the loop resumes on the
    replacement.  Returns (final incarnation, #restarts).  Other exceptions
    propagate untouched."""
    restarts = 0
    while True:
        try:
            sched.run_until_idle()
            return sched, restarts
        except chaos.ProcessKilled as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            sched = restart_scheduler(sched, killed_site=e.fault.site)


def run_ha_restartable(sched: Scheduler, lease_duration_s: float = 0.25,
                       max_restarts: int = 64) -> Tuple[Scheduler, int]:
    """run_restartable with the active/standby protocol: every kill is
    answered by a standby's leader takeover (leases.py — HAReplica), so
    every blackout lands in `failover_duration_seconds` and
    `leader_election_transitions_total`.  The short default lease keeps
    blackouts in fractions of a second (client-go's default is 15 s)."""
    from .leases import LeaderElector, LeaseStore

    leases = LeaseStore()  # real clock: blackouts are real wall time
    leader = LeaderElector(leases, "sched-0", lease_duration_s=lease_duration_s)
    leader.tick()  # incarnation 0 is the initial leader
    restarts = 0
    while True:
        try:
            sched.run_until_idle()
            return sched, restarts
        except chaos.ProcessKilled as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            sched, leader = ha_takeover(
                sched, leases, leader, killed_site=e.fault.site,
                lease_duration_s=lease_duration_s, name=f"sched-{restarts}",
            )


def ha_takeover(dead: Scheduler, leases, leader, killed_site: Optional[str],
                lease_duration_s: float = 0.25,
                name: str = "sched-standby") -> Tuple[Scheduler, object]:
    """One standby leader takeover over a just-killed leader.  The leader's
    final renewal is modelled at the death instant, so the standby's
    blackout measures death -> takeover (one lease expiry + build and
    restore).  Returns (restored replacement, its elector)."""
    from .leases import HAReplica

    leader.tick()
    dead.detach()
    chaos.revive()  # the latch belongs to the dead leader
    standby = HAReplica(
        name, leases, lambda d=dead: reincarnate(d),
        lease_duration_s=lease_duration_s,
        metrics=dead.metrics, tracer=dead.tracer, killed_site=killed_site,
    )
    # tick on the retry period until the dead leader's lease decays
    while not standby.tick():
        time.sleep(lease_duration_s / 10.0)
    return standby.scheduler, standby.elector
