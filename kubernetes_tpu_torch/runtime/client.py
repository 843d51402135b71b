"""TPUScore client — the scheduler side of the sidecar protocol, the port
of the JAX package's ``runtime/client.py``.

Wraps the gRPC channel with the fallback contract: deadline exceeded,
transport failure, or a cold (still-warming) sidecar raises
SidecarUnavailable and the caller falls back to its in-process CPU path,
as the reference tolerates a misbehaving HTTP extender (extender.go
ignorable errors).

Sessions: the client ships the cluster once, then per cycle only the
spec-interned wave and the bound-pod diff (tpuscore.proto — SessionDelta),
computed here against the last acknowledged state; a gap the server reports
(resync_required, e.g. after a restart) triggers ONE full-snapshot retry in
the same call.  Volumes and resource claims are resolved here
(api/volumes.py) before anything reaches the wire, which carries no storage
schema; the session is conditioned on the RAW snapshot's fingerprints
(api/delta.py raw_fingerprints, the encoder's own), so a stable storage
state stays on the delta path and a replaced PV, PVC, class or slice
resyncs.  The requests are the JAX package's client's byte for byte.

    from kubernetes_tpu_torch.runtime.client import TPUScoreClient
    client = TPUScoreClient("127.0.0.1:50151")
    verdicts = client.schedule(snap)  # pod uid -> node name or None
"""

from __future__ import annotations

import random
import time
import uuid
from typing import Dict, Optional, Tuple

import grpc

from ..api import types as t
from ..api.snapshot import Snapshot
from .. import chaos
from . import tpuscore_pb2 as pb
from .convert import node_to_proto, pod_to_proto
from .sidecar import SERVICE


class SidecarUnavailable(Exception):
    """The caller must fall back to the in-process CPU branch.

    retryable distinguishes transport-shaped failures (a drop, a deadline,
    a partial response — a fresh attempt may land) from structural ones (a
    still-compiling sidecar, a resync loop, an exhausted failure budget —
    retrying inside the same cycle cannot help)."""

    def __init__(self, msg: str, retryable: bool = False):
        super().__init__(msg)
        self.retryable = retryable


# one shared field list + comparator with the encoder's bind-absorb
# revalidation — the two drift checks cannot diverge
from ..api.delta import bound_spec_fields_match as _spec_fields_match


class TPUScoreClient:
    """retry/degrade contract (the Borg/Omega failure-is-common posture):
    each schedule() retries transport failures up to max_attempts with
    capped exponential backoff + jitter (seeded — reproducible waits), then
    raises for the per-cycle CPU fallback.  failure_budget CONSECUTIVE
    exhausted calls trip the circuit: the channel is marked degraded and
    schedule() raises immediately (no dial, no deadline wait) until
    degraded_cooldown_s elapses, after which one half-open probe attempt is
    allowed; any success fully resets the budget."""

    def __init__(self, address: str, session: bool = True, metrics=None,
                 max_attempts: int = 3, backoff_base_s: float = 0.05,
                 backoff_cap_s: float = 2.0, failure_budget: int = 3,
                 degraded_cooldown_s: float = 30.0, sleep_fn=time.sleep):
        from ..scheduler.metrics import Metrics
        from .sidecar import TPUScoreServer

        self.address = address
        self.metrics = metrics if metrics is not None else Metrics()
        self.max_attempts = max(1, max_attempts)
        self.backoff_base_s = backoff_base_s
        self.backoff_cap_s = backoff_cap_s
        self.failure_budget = max(1, failure_budget)
        self.degraded_cooldown_s = degraded_cooldown_s
        self._sleep = sleep_fn
        self._retry_rng = random.Random(0xC4A05)  # jitter only; never a decision
        self.degraded = False
        self._degraded_until = 0.0
        self._consecutive_failures = 0
        self._channel = grpc.insecure_channel(
            address,
            options=[
                ("grpc.max_receive_message_length", TPUScoreServer.MAX_MSG),
                ("grpc.max_send_message_length", TPUScoreServer.MAX_MSG),
            ],
        )
        self._schedule = self._channel.unary_unary(
            f"/{SERVICE}/Schedule",
            request_serializer=pb.ScheduleRequest.SerializeToString,
            response_deserializer=pb.ScheduleResponse.FromString,
        )
        self._health = self._channel.unary_unary(
            f"/{SERVICE}/Health",
            request_serializer=pb.HealthRequest.SerializeToString,
            response_deserializer=pb.HealthResponse.FromString,
        )
        # session state (None session_id = legacy stateless requests)
        from ..api.snapshot import SpecInterner

        self._interner = SpecInterner()  # persistent wave spec interning
        self._spec_msgs: Dict[Tuple, object] = {}  # canonical key -> pb.Pod
        self.session_id = uuid.uuid4().hex if session else ""
        self._epoch = 0
        self._synced = False
        self._nodes_fp: Optional[Tuple] = None
        self._last_wave: Dict[str, t.Pod] = {}
        self._known_bound: Dict[str, t.Pod] = {}
        self._last_assign: Dict[str, str] = {}  # server's previous assignment
        self._fp_refs: Tuple = ()
        self.stats = {
            "full": 0, "delta": 0, "resync": 0, "not_ready": 0,
            "binds_compressed": 0, "binds_explicit": 0, "retries": 0,
        }

    def health(self, timeout_s: float = 2.0) -> pb.HealthResponse:
        """Health RPC.  A transport failure is never swallowed silently: it
        increments sidecar_health_failures_total, counts toward the failure
        budget (marking the channel degraded when exhausted), and forces a
        full session resync on the next schedule() — the server may have
        restarted and lost the session (the reconnect-after-health-failure
        contract; tests/test_chaos.py asserts it)."""
        try:
            if chaos.enabled():
                chaos.poke("sidecar.health", metrics=self.metrics)
            resp = self._health(pb.HealthRequest(), timeout=timeout_s)
        except (grpc.RpcError, chaos.FaultInjected) as e:
            self.metrics.inc("sidecar_health_failures_total")
            self._synced = False
            self._note_failure()
            code = str(e.code()) if isinstance(e, grpc.RpcError) else "INJECTED"
            raise SidecarUnavailable(code, retryable=True) from e
        self._note_success()
        return resp

    # --- failure budget / circuit state ---
    def _note_failure(self) -> None:
        self._consecutive_failures += 1
        if not self.degraded and self._consecutive_failures >= self.failure_budget:
            self.degraded = True
            self._degraded_until = time.monotonic() + self.degraded_cooldown_s
            self.metrics.inc("sidecar_degraded_total")
            chaos.record_recovery(
                "sidecar.rpc", "degrade", metrics=self.metrics,
                failures=self._consecutive_failures,
            )

    def _note_success(self) -> None:
        self._consecutive_failures = 0
        if self.degraded:
            self.degraded = False
            self.metrics.inc("sidecar_degraded_recovered_total")
            chaos.record_recovery("sidecar.rpc", "reconnect", metrics=self.metrics)

    def _check_degraded(self) -> bool:
        """While degraded, fail fast (no dial, no deadline wait) so every
        cycle takes the in-process CPU branch immediately; after the
        cooldown one half-open probe call is let through — its success
        resets the budget, its failure re-arms the cooldown.  Returns True
        when THIS call is the half-open probe: the caller restricts it to a
        single attempt (probing a still-dead sidecar must not pay the full
        retry ladder inside one scheduling cycle)."""
        if not self.degraded:
            return False
        now = time.monotonic()
        if now < self._degraded_until:
            self.metrics.inc("sidecar_degraded_skips_total")
            raise SidecarUnavailable(
                "degraded (failure budget exhausted)", retryable=False
            )
        self._degraded_until = now + self.degraded_cooldown_s  # re-arm
        return True

    def _backoff_sleep(self, attempt: int) -> None:
        """Capped exponential backoff with multiplicative jitter between
        retry attempts (seeded RNG: reproducible waits, never a decision
        input)."""
        d = min(self.backoff_cap_s, self.backoff_base_s * (2 ** attempt))
        self._sleep(d * (1.0 + self._retry_rng.random()))

    def _retrying(self, attempt_fn, max_attempts: Optional[int] = None):
        attempts = max_attempts if max_attempts is not None else self.max_attempts
        for attempt in range(attempts):
            try:
                out = attempt_fn()
            except SidecarUnavailable as e:
                if not e.retryable:
                    # structural (still compiling / resync loop): the
                    # transport is fine — neither retry nor budget
                    raise
                self.metrics.inc("sidecar_rpc_failures_total")
                if attempt + 1 < attempts:
                    self.stats["retries"] = self.stats.get("retries", 0) + 1
                    self._backoff_sleep(attempt)
                    continue
                self._note_failure()
                raise
            if attempt > 0:
                chaos.record_recovery(
                    "sidecar.rpc", "retry", metrics=self.metrics,
                    attempts=attempt + 1,
                )
            self._note_success()
            return out

    @staticmethod
    def _trace_metadata():
        """The W3C-traceparent analog for the sidecar hop: stamp the ACTIVE
        span's trace_id/span_id (the scheduler's batch.cycle is current when
        schedule() runs) into gRPC metadata.  The server rebuilds the span
        context from it (sidecar.py — _parent_ctx), so a sidecar-routed
        wave renders as ONE connected trace instead of an orphan root per
        RPC."""
        from ..scheduler.tracing import current_span

        sp = current_span()
        if sp is None:
            return None
        return (
            ("ktpu-trace-id", sp.trace_id),
            ("ktpu-span-id", sp.span_id),
        )

    # --- request builders ---
    def _wave_msg(self, pods) -> pb.InternedWave:
        """The spec-interned wave message: per-template
        canonical keying AND pb.Pod serialization happen once, not per cycle
        (steady-state waves re-send only uids + spec indices)."""
        reps, inv, rep_keys = self._interner.group(pods)
        if len(self._spec_msgs) > 4 * (len(rep_keys) + 256):
            self._spec_msgs.clear()
        specs = []
        for rep, k in zip(reps, rep_keys):
            msg = self._spec_msgs.get(k)
            if msg is None:
                msg = pod_to_proto(rep)
                msg.ClearField("name")
                msg.ClearField("uid")
                self._spec_msgs[k] = msg
            specs.append(msg)
        msg = pb.InternedWave(specs=specs)
        msg.uids.extend(p.uid for p in pods)
        msg.spec_idx.extend(inv.tolist())
        return msg

    def _full_request(self, snap: Snapshot, deadline_ms, gang, hpaw):
        req = pb.ScheduleRequest(
            deadline_ms=deadline_ms,
            gang=gang,
            hard_pod_affinity_weight=hpaw,
            session_id=self.session_id,
            epoch=self._epoch,
            wave=self._wave_msg(snap.pending_pods),
        )
        req.snapshot.nodes.extend(node_to_proto(n) for n in snap.nodes)
        req.snapshot.bound_pods.extend(pod_to_proto(p) for p in snap.bound_pods)
        req.snapshot.pod_groups.extend(
            pb.PodGroup(name=g.name, min_member=g.min_member)
            for g in snap.pod_groups.values()
        )
        self.stats["full"] += 1
        return req

    def _delta_request(self, snap: Snapshot, deadline_ms, gang, hpaw):
        req = pb.ScheduleRequest(
            deadline_ms=deadline_ms,
            gang=gang,
            hard_pod_affinity_weight=hpaw,
            session_id=self.session_id,
            epoch=self._epoch,
            wave=self._wave_msg(snap.pending_pods),
        )
        req.delta.SetInParent()  # presence even when the diff is empty
        d = req.delta
        d.base_epoch = self._epoch - 1
        covered = set()
        for p in snap.bound_pods:
            known = self._known_bound.get(p.uid)
            if known is not None:
                # already on the server — but a REPLACED object (label or
                # other metadata update to a bound pod; the in-process
                # encoder's `rec[_OBJ] is not q` case) must ship so the
                # session doesn't silently diverge from the stateless path
                if known is p or (
                    p.node_name == known.node_name and _spec_fields_match(known, p)
                ):
                    continue
                d.added_bound.append(pod_to_proto(p))
                continue
            prev = self._last_wave.get(p.uid)
            if prev is not None and _spec_fields_match(prev, p):
                # the common steady-state bind: if it lands exactly where
                # the server's previous response assigned it, it rides the
                # bind_prev_assignment compression instead of a Bind message
                if self._last_assign.get(p.uid) == p.node_name:
                    covered.add(p.uid)
                else:
                    d.binds.add(pod_uid=p.uid, node=p.node_name)
            else:
                # never seen pending (external bind), or the bound copy
                # drifted from the wave spec (e.g. label update raced the
                # bind): ship the object itself
                d.added_bound.append(pod_to_proto(p))
        if covered:
            exc = [uid for uid in self._last_assign if uid not in covered]
            if len(exc) < len(covered):
                d.bind_prev_assignment = True
                d.bind_prev_except.extend(exc)
                self.stats["binds_compressed"] += len(covered)
            else:
                # a mostly-unbound assignment: the exception list would
                # outweigh the saved Bind messages — ship binds explicitly
                for uid in covered:
                    d.binds.add(pod_uid=uid, node=self._last_assign[uid])
        self.stats["binds_explicit"] += len(d.binds)
        bound_now = {p.uid for p in snap.bound_pods}
        d.deleted_uids.extend(
            uid for uid in self._known_bound if uid not in bound_now
        )
        req.snapshot.pod_groups.extend(
            pb.PodGroup(name=g.name, min_member=g.min_member)
            for g in snap.pod_groups.values()
        )
        self.stats["delta"] += 1
        return req

    # --- the call ---
    def schedule(
        self,
        snap: Snapshot,
        deadline_ms: float = 1000.0,
        gang: bool = True,
        hard_pod_affinity_weight: float = 1.0,
    ) -> Dict[str, Optional[str]]:
        """-> pod uid -> node name (None = unschedulable).  Transport-shaped
        failures retry in-call with capped backoff + jitter; raises
        SidecarUnavailable once retries exhaust, the failure budget trips
        (degraded channel — fails fast until the cooldown), or the sidecar
        is still compiling (caller falls back to the CPU branch)."""
        from ..api.volumes import resolve_snapshot

        probing = self._check_degraded()
        attempts = 1 if probing else None  # half-open: exactly one attempt
        if not self.session_id:
            rsnap = resolve_snapshot(snap)
            return self._retrying(
                lambda: self._schedule_stateless(
                    rsnap, deadline_ms, gang, hard_pod_affinity_weight
                ),
                max_attempts=attempts,
            )
        return self._retrying(
            lambda: self._schedule_session_once(
                snap, deadline_ms, gang, hard_pod_affinity_weight
            ),
            max_attempts=attempts,
        )

    def _schedule_session_once(
        self,
        snap: Snapshot,
        deadline_ms: float,
        gang: bool,
        hard_pod_affinity_weight: float,
    ) -> Dict[str, Optional[str]]:
        from ..api.delta import raw_fingerprints, raw_keepalive_refs
        from ..api.volumes import resolve_snapshot
        # fingerprint the RAW cluster (resolution rebuilds node objects per
        # cycle whenever volume/DRA state exists) with the SAME helpers the
        # delta encoder conditions on, then resolve for the wire
        nodes_fp = raw_fingerprints(snap)
        raw_snap = snap
        snap = resolve_snapshot(snap)
        self._epoch += 1
        if self._synced and nodes_fp == self._nodes_fp:
            req = self._delta_request(
                snap, deadline_ms, gang, hard_pod_affinity_weight
            )
        else:
            req = self._full_request(
                snap, deadline_ms, gang, hard_pod_affinity_weight
            )
        md = self._trace_metadata()
        try:
            fault = (
                chaos.poke("sidecar.rpc", metrics=self.metrics)
                if chaos.enabled() else None
            )
            resp = self._schedule(req, timeout=deadline_ms / 1e3, metadata=md)
            if resp.resync_required:
                # server lost the session (restart / eviction): reconnect by
                # re-sending the full snapshot once, same call
                self.stats["resync"] += 1
                self._synced = False
                req = self._full_request(
                    snap, deadline_ms, gang, hard_pod_affinity_weight
                )
                resp = self._schedule(
                    req, timeout=deadline_ms / 1e3, metadata=md
                )
                if resp.resync_required:
                    raise SidecarUnavailable("resync loop")
            if fault is not None and fault.action == "partial":
                # truncated response (a connection cut mid-stream): the
                # validation below must catch it, never decode it
                del resp.assignment[len(resp.assignment) // 2:]
        except (grpc.RpcError, chaos.FaultInjected) as e:
            # transport/deadline failure: the server may or may not have
            # applied this epoch — force a full resync next cycle
            self._synced = False
            code = str(e.code()) if isinstance(e, grpc.RpcError) else "INJECTED"
            raise SidecarUnavailable(code, retryable=True) from e
        # the server applied this request's state even when answering
        # not_ready — record it so the next cycle's diff is correct
        self._synced = True
        if nodes_fp != self._nodes_fp:
            # (re)synchronized against a new raw state: pin every object the
            # fingerprints id() so address reuse can never alias them; on
            # matching cycles the existing refs already pin the same objects
            self._fp_refs = raw_keepalive_refs(raw_snap)
            self._nodes_fp = nodes_fp
        self._last_wave = {p.uid: p for p in snap.pending_pods}
        self._known_bound = {p.uid: p for p in snap.bound_pods}
        if resp.not_ready:
            self.stats["not_ready"] += 1
            self._last_assign = {}  # no assignment to echo next cycle
            raise SidecarUnavailable("sidecar compiling (not ready)")
        if len(resp.assignment) != len(snap.pending_pods):
            # a partial/truncated response: zip() below would silently drop
            # the tail's verdicts (pods would vanish into the preemption
            # path on a healthy cluster) — treat it as the transport
            # failure it is and resync
            self._synced = False
            self.metrics.inc("sidecar_partial_responses_total")
            raise SidecarUnavailable(
                f"partial response ({len(resp.assignment)} verdicts for "
                f"{len(snap.pending_pods)} pods)", retryable=True,
            )
        # aligned-array verdicts: assignment[i] is a node index (our own node
        # list's order) for pending pod i in the order we sent the wave
        names = [nd.name for nd in snap.nodes]
        out = {
            p.uid: (names[c] if c >= 0 else None)
            for p, c in zip(snap.pending_pods, resp.assignment)
        }
        self._last_assign = {u: n for u, n in out.items() if n is not None}
        return out

    def _schedule_stateless(self, snap, deadline_ms, gang, hpaw):
        from .convert import snapshot_to_proto

        req = pb.ScheduleRequest(
            snapshot=snapshot_to_proto(snap),
            deadline_ms=deadline_ms,
            gang=gang,
            hard_pod_affinity_weight=hpaw,
        )
        try:
            fault = (
                chaos.poke("sidecar.rpc", metrics=self.metrics)
                if chaos.enabled() else None
            )
            resp = self._schedule(
                req, timeout=deadline_ms / 1e3,
                metadata=self._trace_metadata(),
            )
            if fault is not None and fault.action == "partial":
                del resp.verdicts[len(resp.verdicts) // 2:]
        except (grpc.RpcError, chaos.FaultInjected) as e:
            code = str(e.code()) if isinstance(e, grpc.RpcError) else "INJECTED"
            raise SidecarUnavailable(code, retryable=True) from e
        if len(resp.verdicts) != len(snap.pending_pods):
            self.metrics.inc("sidecar_partial_responses_total")
            raise SidecarUnavailable(
                f"partial response ({len(resp.verdicts)} verdicts for "
                f"{len(snap.pending_pods)} pods)", retryable=True,
            )
        return {v.pod_uid: (v.node if v.scheduled else None) for v in resp.verdicts}

    def close(self) -> None:
        self._channel.close()
