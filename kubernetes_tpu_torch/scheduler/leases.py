"""Leases + leader election + node lifecycle — the failure-detection stack.

reference (SURVEY.md §5):
  - kubelet heartbeats as coordination.k8s.io Lease objects
    (pkg/kubelet/nodelease); here: Lease records renewed against the store
  - pkg/controller/nodelifecycle/node_lifecycle_controller.go: nodes whose
    lease goes stale past the 40 s grace become NotReady, get the
    node.kubernetes.io/unreachable:NoExecute taint, and their pods are
    evicted after tolerationSeconds (default 300 s)
  - client-go tools/leaderelection: active-passive HA via lease CAS
    (15 s lease / 10 s renew / 2 s retry)

All clocks injectable (FakeClock) for deterministic tests.

The port's copy of the JAX package's ``scheduler/leases.py``: HAReplica's
takeover builds the port's Scheduler through the caller's factory and
restores it (scheduler.py — restore), on the replica's chaos module.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from ..api import types as t
from .queue import Clock
from .store import ClusterStore

UNREACHABLE_TAINT_KEY = "node.kubernetes.io/unreachable"
NOT_READY_TAINT_KEY = "node.kubernetes.io/not-ready"
DEFAULT_GRACE_S = 40.0
DEFAULT_EVICTION_S = 300.0

LEASE_DURATION_S = 15.0
RENEW_DEADLINE_S = 10.0
RETRY_PERIOD_S = 2.0


@dataclass
class Lease:
    holder: str
    renew_time: float
    resource_version: int = 0


class LeaseStore:
    """coordination.k8s.io-style lease table with compare-and-swap semantics
    (the optimistic-concurrency primitive every reference component HA story
    rests on)."""

    def __init__(self, clock: Optional[Clock] = None):
        self.clock = clock or Clock()
        self._leases: Dict[str, Lease] = {}

    def get(self, name: str) -> Optional[Lease]:
        return self._leases.get(name)

    def try_acquire_or_renew(self, name: str, holder: str, duration_s: float) -> bool:
        """CAS: acquire if absent/expired/ours; fail if another live holder."""
        now = self.clock.now()
        cur = self._leases.get(name)
        if cur is not None and cur.holder != holder and now < cur.renew_time + duration_s:
            return False
        rv = (cur.resource_version + 1) if cur else 1
        self._leases[name] = Lease(holder=holder, renew_time=now, resource_version=rv)
        return True

    def renew_node_heartbeat(self, node_name: str) -> None:
        self.try_acquire_or_renew(f"node/{node_name}", node_name, float("inf"))


class LeaderElector:
    """tools/leaderelection — LeaderElector.Run reduced to tick()."""

    def __init__(self, leases: LeaseStore, identity: str,
                 name: str = "kube-scheduler",
                 lease_duration_s: float = LEASE_DURATION_S):
        self.leases = leases
        self.identity = identity
        self.name = name
        self.lease_duration_s = lease_duration_s

    def tick(self) -> bool:
        """Attempt acquire/renew; returns True while this identity leads."""
        return self.leases.try_acquire_or_renew(
            self.name, self.identity, self.lease_duration_s
        )

    @property
    def is_leader(self) -> bool:
        cur = self.leases.get(self.name)
        return cur is not None and cur.holder == self.identity


class HAReplica:
    """One scheduler replica of an active/standby pair — the LeaderElector
    run loop with the takeover protocol attached.

    Both replicas tick() on their retry period; only the lease holder owns a
    live Scheduler.  The standby holds NO scheduler at all (a fresh takeover
    LISTs the world exactly like a restarted process — the crash-only rule),
    so when the active dies silently (kill -9: it simply stops renewing) the
    standby's first successful CAS after lease expiry triggers:

      build scheduler (factory) -> restore() (checkpoint + relist + WAL
      replay + forced hoist re-fingerprint) -> record the blackout

    Blackout = (lease-clock time past the dead leader's expiry when the CAS
    landed) + (real seconds the takeover build+restore took), observed into
    `failover_duration_seconds`; every leadership change bumps
    `leader_election_transitions_total` and emits a `leader.takeover` span.
    The pair-level invariant (tests): takeover completes within ONE lease
    duration of the expiry, and placements stay bit-identical to a
    never-failed scheduler."""

    def __init__(self, identity: str, leases: LeaseStore, make_scheduler,
                 name: str = "kube-scheduler",
                 lease_duration_s: float = LEASE_DURATION_S,
                 metrics=None, tracer=None,
                 killed_site: Optional[str] = None):
        self.identity = identity
        self.elector = LeaderElector(
            leases, identity, name=name, lease_duration_s=lease_duration_s
        )
        self.make_scheduler = make_scheduler
        self.metrics = metrics
        self.tracer = tracer
        self.scheduler = None
        self.dead = False  # a killed active stops ticking (kill -9 semantics)
        self._was_leader = False
        # the chaos kill.* site that felled the leader this standby replaces
        # (the takeover drivers — scheduler.ha_takeover — stamp it from
        # ProcessKilled.fault) — restore() records the recovery under that
        # site so injected/recovered counts reconcile; None for organic
        # takeovers (no injected fault)
        self.killed_site: Optional[str] = killed_site

    def kill(self) -> None:
        """Simulate kill -9 on this replica: it stops renewing (the lease
        simply expires) and its scheduler instance is abandoned mid-state —
        never drained, never flushed (Scheduler.detach marks it inert the
        way the OS would reclaim a dead process)."""
        self.dead = True
        if self.scheduler is not None:
            self.scheduler.detach()
        from .. import chaos

        chaos.revive()  # the latch belongs to the dead replica, not the pair

    def tick(self) -> bool:
        """One leaderelection retry-period step; returns True while this
        replica leads.  A dead replica never ticks (its lease decays)."""
        if self.dead:
            return False
        import time as _t

        prev = self.elector.leases.get(self.elector.name)
        lead = self.elector.tick()
        if lead and not self._was_leader:
            t0 = _t.perf_counter()
            # blackout's lease-clock half: how long past the previous
            # holder's expiry the takeover CAS landed (0 on first election
            # or an uncontended hand-back)
            blackout = 0.0
            if prev is not None and prev.holder != self.identity:
                expiry = prev.renew_time + self.elector.lease_duration_s
                blackout = max(0.0, self.elector.leases.clock.now() - expiry)
            self.scheduler = self.make_scheduler()
            self.scheduler.restore(killed_site=self.killed_site)
            dt = _t.perf_counter() - t0
            m = self.metrics if self.metrics is not None else self.scheduler.metrics
            m.inc("leader_election_transitions_total")
            m.observe("failover_duration_seconds", blackout + dt)
            tr = self.tracer if self.tracer is not None else self.scheduler.tracer
            if tr is not None and tr.enabled:
                tr.record_span(
                    "leader.takeover", start=t0, end=t0 + dt,
                    identity=self.identity,
                    previous=prev.holder if prev is not None else "",
                    blackout_s=round(blackout, 6),
                )
        self._was_leader = lead
        return lead


class NodeLifecycleController:
    """node_lifecycle_controller.go: stale heartbeat -> unreachable taint ->
    taint-based eviction after tolerationSeconds."""

    def __init__(
        self,
        store: ClusterStore,
        leases: LeaseStore,
        grace_s: float = DEFAULT_GRACE_S,
        eviction_s: float = DEFAULT_EVICTION_S,
    ):
        self.store = store
        self.leases = leases
        self.grace_s = grace_s
        self.eviction_s = eviction_s
        self._tainted_at: Dict[str, float] = {}

    def tick(self) -> List[str]:
        """Reconcile once; returns uids of pods evicted this pass."""
        now = self.leases.clock.now()
        evicted: List[str] = []
        for node in self.store.list_nodes():
            name = node.name
            lease = self.leases.get(f"node/{name}")
            stale = lease is None or now > lease.renew_time + self.grace_s
            has_taint = any(tn.key == UNREACHABLE_TAINT_KEY for tn in node.taints)
            if stale and not has_taint:
                node2 = _copy_node(node)
                node2.taints = tuple(node.taints) + (
                    t.Taint(key=UNREACHABLE_TAINT_KEY, effect=t.NO_EXECUTE),
                )
                self.store.update_node(node2)
                self._tainted_at[name] = now
            elif not stale and has_taint:
                node2 = _copy_node(node)
                node2.taints = tuple(
                    tn for tn in node.taints if tn.key != UNREACHABLE_TAINT_KEY
                )
                self.store.update_node(node2)
                self._tainted_at.pop(name, None)
        # taint-based eviction (NoExecute + tolerationSeconds)
        for pod in self.store.list_pods():
            uid = pod.uid
            if not pod.node_name:
                continue
            tainted = self._tainted_at.get(pod.node_name)
            if tainted is None:
                continue
            deadline = tainted + self._toleration_window(pod)
            if now >= deadline:
                self.store.delete_pod(uid)
                evicted.append(uid)
        return evicted

    def _toleration_window(self, pod: t.Pod) -> float:
        for tol in pod.tolerations:
            if tol.key in (UNREACHABLE_TAINT_KEY, "") and tol.effect in (t.NO_EXECUTE, ""):
                if tol.toleration_seconds is None:
                    return float("inf")  # tolerates forever
                return float(tol.toleration_seconds)
        return self.eviction_s  # default added by admission in the reference


def _copy_node(node: t.Node) -> t.Node:
    import copy

    return copy.copy(node)
