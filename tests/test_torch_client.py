"""The sidecar's client in the port (runtime/client.py TPUScoreClient, with
the port's chaos/) against the JAX package's client, on loopback.

- A session over a storage-carrying stream (heterogeneous_storage: static
  and WaitForFirstConsumer claims, attach limits; each wave bench.py's next
  wave with the last one's placements bound): a full call, deltas whose
  binds ride the bind_prev_assignment compression, a delta with an
  explicit bind and a departure, then a replaced PVC, which resyncs in
  full.  The port's client against the port's CPU server and against the
  JAX server gives the verdicts of the JAX client against the JAX server,
  with the same client stats; every request it sends is the JAX client's
  byte for byte.  The stateless path gives the same verdicts.
- tests/test_sidecar.py test_session_deltas_survive_volume_state, and the
  client cases of tests/test_chaos.py (retries to identical verdicts under
  a dropped, hung and truncated RPC; the failure budget degrading and
  recovering; the half-open probe as a single attempt; a failed health
  call marking the session for a full resync), on the port's client with
  the port's chaos, against the port's server.

Tolerance: none.
"""

import dataclasses
import time

import pytest

from helpers import mk_node, mk_pod
from kubernetes_tpu.api import types as jt
from kubernetes_tpu.api.snapshot import Snapshot as JaxSnapshot
from kubernetes_tpu.bench import workloads as jw
from kubernetes_tpu_torch import chaos
from kubernetes_tpu_torch.api.snapshot import Snapshot
from kubernetes_tpu_torch.runtime.client import SidecarUnavailable, TPUScoreClient
from kubernetes_tpu_torch.runtime.sidecar import _Engine
from test_torch_volumes import _Carry
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

DEADLINE = 60_000
SESSION = "0123456789abcdef0123456789abcdef"


@pytest.fixture(scope="module")
def servers():
    """(JAX server, the port's server on the CPU), both on loopback."""
    from kubernetes_tpu.runtime import TPUScoreServer as JaxServer
    from kubernetes_tpu_torch.runtime.sidecar import TPUScoreServer

    jax_srv = JaxServer()
    port_srv = TPUScoreServer(engine=_Engine(device="cpu"))
    jax_srv.start()
    port_srv.start()
    yield jax_srv, port_srv
    jax_srv.stop()
    port_srv.stop()


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    yield
    chaos.uninstall()


class _Recorded:
    """A client whose every Schedule request is kept serialized."""

    def __init__(self, client):
        self.client, self.sent = client, []
        call = client._schedule

        def send(req, **kw):
            self.sent.append(req.SerializeToString())
            return call(req, **kw)

        client._schedule = send


def _jax_client(srv, **kw):
    from kubernetes_tpu.runtime import TPUScoreClient as JaxClient

    return JaxClient(f"127.0.0.1:{srv.port}", **kw)


def _stream():
    """The JAX snapshots of a storage-carrying session, built wave by wave
    from the verdicts: -> a generator taking each wave's verdicts (by
    uid) and yielding the next snapshot."""
    base = jw.heterogeneous_storage(40, 96, seed=1)
    storage = dict(pvs=base.pvs, storage_classes=base.storage_classes)
    pvcs = dict(base.pvcs)
    bound = []
    pods = base.pending_pods
    for w in range(1, 6):
        if w == 5:  # a replaced PVC: the session resyncs in full
            key = "default/claim-wffc-0"
            pvcs = {**pvcs, key: dataclasses.replace(pvcs[key], request=2 * pvcs[key].request)}
        verdicts = yield JaxSnapshot(nodes=base.nodes, pending_pods=pods, bound_pods=list(bound), pvcs=pvcs,
                                     **storage)
        placed = [dataclasses.replace(p, node_name=verdicts[p.uid]) for p in pods if verdicts.get(p.uid)]
        if w == 3 and len(placed) > 2:
            # an explicit bind (a pod bound off its assignment) and a departure
            placed[0] = dataclasses.replace(placed[0], node_name=placed[1].node_name)
            bound = bound[1:]
        bound += placed
        pods = [dataclasses.replace(p, name=f"w{w + 1}-{p.name}", uid="") for p in base.pending_pods]


def test_session_over_a_storage_stream_matches_the_jax_client(servers):
    jax_srv, port_srv = servers
    jc = _Recorded(_jax_client(jax_srv))
    pc = _Recorded(TPUScoreClient(f"127.0.0.1:{port_srv.port}"))
    pj = TPUScoreClient(f"127.0.0.1:{jax_srv.port}")  # the port's client, the JAX server
    stateless = TPUScoreClient(f"127.0.0.1:{port_srv.port}", session=False)
    # the recorded pair on two servers shares its session id (the requests
    # carry it); the port's client on the JAX server has its own
    jc.client.session_id = pc.client.session_id = SESSION
    pj.session_id = SESSION[::-1]
    carry = _Carry()
    stream = _stream()
    snap = next(stream)
    calls = 0
    while True:
        tsnap = Snapshot(nodes=carry(snap.nodes), pending_pods=carry(snap.pending_pods),
                         bound_pods=carry(snap.bound_pods), pvs=carry(snap.pvs),
                         pvcs={k: carry(v) for k, v in snap.pvcs.items()},
                         storage_classes={k: carry(v) for k, v in snap.storage_classes.items()})
        want = jc.client.schedule(snap, deadline_ms=DEADLINE)
        got = pc.client.schedule(tsnap, deadline_ms=DEADLINE)
        assert got == want, calls
        assert pj.schedule(tsnap, deadline_ms=DEADLINE) == want, calls
        assert stateless.schedule(tsnap, deadline_ms=DEADLINE) == want, calls
        assert pc.sent == jc.sent, calls  # byte for byte
        assert pc.client.stats == jc.client.stats == pj.stats, calls
        calls += 1
        try:
            snap = stream.send(want)
        except StopIteration:
            break
    st = pc.client.stats
    assert calls == 5 and (st["full"], st["delta"]) == (2, 3), st
    assert st["binds_compressed"] > 0 and st["binds_explicit"] > 0, st
    assert sum(1 for v in want.values() if v) > 0
    for c in (jc.client, pc.client, pj, stateless):
        c.close()


def _wave(n, tag):
    return [mk_pod(f"{tag}-{i}", cpu=100 + 10 * i) for i in range(n)]


@pytest.mark.parametrize("server", ["port", "jax"])
def test_session_deltas_survive_volume_state(servers, server):
    """tests/test_sidecar.py's case on the port's client: the client
    fingerprints the RAW node set and storage state, so a stable PVC state
    stays on the delta path and a PVC change resyncs."""
    srv = servers[server == "port"]
    carry = _Carry()
    pvc = jt.PersistentVolumeClaim(name="claim", request=1, wait_for_first_consumer=True)
    client = TPUScoreClient(f"127.0.0.1:{srv.port}")
    nodes = []
    for i in range(4):
        nd = mk_node(f"n{i}", cpu=4000)
        nd.volume_attach_limit = 8
        nodes.append(nd)
    for cycle in range(3):
        wave = _wave(3, f"v{cycle}")
        wave.append(dataclasses.replace(mk_pod(f"vol-{cycle}", cpu=100), pvcs=("claim",)))
        v = client.schedule(Snapshot(nodes=carry(nodes), pending_pods=carry(wave), pvcs={pvc.key: carry(pvc)}),
                            deadline_ms=DEADLINE)
        assert any(v.values())
    assert client.stats["full"] == 1 and client.stats["delta"] == 2, client.stats
    pvc2 = dataclasses.replace(pvc, request=2)
    client.schedule(Snapshot(nodes=carry(nodes), pending_pods=carry(_wave(2, "after")),
                             pvcs={pvc2.key: carry(pvc2)}), deadline_ms=DEADLINE)
    assert client.stats["full"] == 2, client.stats
    client.close()


# ---------------------------------------------------------------------------
# tests/test_chaos.py's client cases, on the port's client and chaos
# ---------------------------------------------------------------------------

def _rig(n_nodes=4, n_pods=8):
    return Snapshot(nodes=[_port_node(f"n{i}") for i in range(n_nodes)],
                    pending_pods=[_port_pod(f"p{j}") for j in range(n_pods)])


def _port_node(name):
    from test_torch_volumes import to_port

    return to_port(mk_node(name, cpu=4000))


def _port_pod(name):
    from test_torch_volumes import to_port

    return to_port(mk_pod(name, cpu=300))


@pytest.mark.parametrize("spec", [
    "sidecar.rpc:error@0",  # dropped connection on the first try
    "sidecar.rpc:hang@0:0.01",  # hang then drop
    "sidecar.rpc:partial@0",  # truncated response (must be detected)
])
def test_sidecar_fault_retries_to_identical_verdicts(servers, spec):
    srv = servers[1]
    snap = _rig()
    clean = TPUScoreClient(f"127.0.0.1:{srv.port}")
    want = clean.schedule(snap, deadline_ms=DEADLINE)
    clean.close()
    client = TPUScoreClient(f"127.0.0.1:{srv.port}", backoff_base_s=0.001)
    with chaos.chaos_plan(chaos.FaultPlan.parse(spec)):
        got = client.schedule(snap, deadline_ms=DEADLINE)
    assert got == want
    assert client.stats["retries"] >= 1
    assert client.metrics.labeled_counter_total("framework_fault_recovery_total") >= 1
    client.close()


def test_sidecar_failure_budget_degrades_then_recovers(servers):
    """failure_budget consecutive exhausted calls trip the circuit: the
    channel fails fast (no dial) until the cooldown, then one half-open
    probe restores it on success."""
    srv = servers[1]
    snap = _rig()
    client = TPUScoreClient(f"127.0.0.1:{srv.port}", max_attempts=1, backoff_base_s=0.001, failure_budget=2,
                            degraded_cooldown_s=0.05)
    with chaos.chaos_plan(chaos.FaultPlan.parse("sidecar.rpc:error@0+2")):
        for _ in range(2):
            with pytest.raises(SidecarUnavailable):
                client.schedule(snap, deadline_ms=DEADLINE)
        assert client.degraded
        assert client.metrics.counters["sidecar_degraded_total"] == 1
        # fail-fast while degraded: no RPC attempted, the site counter stays
        before = chaos.active().counts.get("sidecar.rpc", 0)
        with pytest.raises(SidecarUnavailable):
            client.schedule(snap, deadline_ms=DEADLINE)
        assert chaos.active().counts.get("sidecar.rpc", 0) == before
        time.sleep(0.06)  # cooldown: the half-open probe is allowed (no fault now)
        got = client.schedule(snap, deadline_ms=DEADLINE)
    assert not client.degraded
    assert client.metrics.counters["sidecar_degraded_recovered_total"] == 1
    assert sorted(got) == sorted(p.uid for p in snap.pending_pods)
    client.close()


def test_half_open_probe_is_a_single_attempt(servers):
    """After the degraded cooldown the probe call makes exactly ONE
    transport attempt, never the full retry ladder inside one cycle."""
    srv = servers[1]
    snap = _rig()
    client = TPUScoreClient(f"127.0.0.1:{srv.port}", max_attempts=3, backoff_base_s=0.001, failure_budget=1,
                            degraded_cooldown_s=0.01)
    with chaos.chaos_plan(chaos.FaultPlan.parse("sidecar.rpc:error@*")):
        with pytest.raises(SidecarUnavailable):
            client.schedule(snap, deadline_ms=DEADLINE)  # trips the budget
        assert client.degraded
        time.sleep(0.02)  # cooldown elapsed: the next call is the probe
        before = chaos.active().counts.get("sidecar.rpc", 0)
        with pytest.raises(SidecarUnavailable):
            client.schedule(snap, deadline_ms=DEADLINE)
        assert chaos.active().counts["sidecar.rpc"] == before + 1
    assert client.degraded  # the failed probe re-armed the cooldown
    client.close()


def test_health_failure_marks_degraded_track_and_resyncs(servers):
    """health() never swallows a transport error: it increments
    sidecar_health_failures_total, counts toward the budget, and forces the
    next schedule() to a full resync."""
    srv = servers[1]
    snap = _rig()
    client = TPUScoreClient(f"127.0.0.1:{srv.port}")
    client.schedule(snap, deadline_ms=DEADLINE)
    assert client.stats["full"] == 1 and client._synced
    assert client.health().ready
    with chaos.chaos_plan(chaos.FaultPlan.parse("sidecar.health:error@0")):
        with pytest.raises(SidecarUnavailable):
            client.health()
    assert client.metrics.counters["sidecar_health_failures_total"] == 1
    assert client._consecutive_failures == 1
    assert not client._synced  # the server may have restarted
    got = client.schedule(snap, deadline_ms=DEADLINE)  # reconnect: the FULL snapshot again
    assert client.stats["full"] == 2 and client.stats["delta"] == 0
    assert sorted(got) == sorted(p.uid for p in snap.pending_pods)
    assert client._consecutive_failures == 0  # the success reset the budget
    client.close()


def test_schedule_span_joins_the_clients_trace():
    """The port's client stamps the span it is called in
    (scheduler/tracing.py current_span) into the gRPC metadata: the server's
    sidecar.schedule span is its child.  A retried call records a recovery
    span on the port's tracer (Tracer.record_span), under the same trace."""
    from kubernetes_tpu_torch.runtime.sidecar import TPUScoreServer
    from kubernetes_tpu_torch.scheduler.tracing import TraceCollector, Tracer, current_span, current_trace_id

    col, client_col = TraceCollector(), TraceCollector()
    srv = TPUScoreServer(engine=_Engine(device="cpu"), collector=col)
    srv.start()
    client = TPUScoreClient(f"127.0.0.1:{srv.port}", backoff_base_s=0.001)
    tracer = Tracer(client_col, component="scheduler")
    try:
        assert current_span() is None and current_trace_id() == ""
        with tracer.span("batch.cycle") as parent:
            assert current_span() is parent and current_trace_id() == parent.trace_id
            with chaos.chaos_plan(chaos.FaultPlan.parse("sidecar.rpc:error@0"), tracer=tracer):
                got = client.schedule(_rig(1, 1), deadline_ms=DEADLINE)
    finally:
        client.close()
        srv.stop()
    assert got == {"default/p0": "n0"}
    spans = col.spans("sidecar.schedule")
    assert [(sp.trace_id, sp.parent_id, sp.component) for sp in spans] == [
        (parent.trace_id, parent.span_id, "sidecar")]
    marks = {sp.name: sp for sp in client_col.spans() if sp.name in ("fault_injected", "recovery")}
    assert set(marks) == {"fault_injected", "recovery"}, client_col.spans()
    assert all(sp.trace_id == parent.trace_id and sp.parent_id == parent.span_id for sp in marks.values())
    assert marks["recovery"].attributes == {"site": "sidecar.rpc", "action": "retry", "attempts": 2}
