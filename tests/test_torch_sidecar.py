"""The sidecar's server side in the port (kubernetes_tpu_torch/runtime)
against the JAX package's.

On the CPU:

- ``DeltaEncoder.encode_pregrouped`` equals the JAX encoder's
  ``encode_pregrouped`` field for field over a churn of waves (binds
  absorbed through the spec reps the server clones bound copies from, a
  bound copy whose labels drifted, departures, a repeated wave), and the
  one-shot encode of the same pods;
- the JAX package's ``TPUScoreClient`` drives the port's
  ``TPUScoreServer(engine=_Engine(device="cpu"))`` over loopback, and the
  verdicts equal the JAX server's on the same calls and, where
  tests/test_sidecar.py holds them so, the oracle's: every case of that
  file that needs no Scheduler (stateless, gang, the session delta
  stream, the session over volume state, bind compression, label drift,
  bound-pod updates, a node change,
  a resync after a restart, health, zpages, a zero hard-pod-affinity
  weight, preferred affinity and images, the cold large session) and the
  JAX Scheduler offloading to it.  The wire (tpuscore.proto) is shared byte
  for byte.  The cold session waits on the engine's warm-up event, not on
  the wall clock.

The server's schedule span joins the JAX client's trace.

On the card (``cuda``, skipped here): ``_Engine(device="cuda")`` launches
every route's kernels once when it starts, and its ``run_session`` equals
the CPU engine's on a plain and on a gang wave, twice each.

Tolerance: none.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.api.delta import DeltaEncoder
from kubernetes_tpu_torch.api.snapshot import SpecInterner
from kubernetes_tpu_torch.bench import workloads as tw
from kubernetes_tpu_torch.runtime.convert import clone_pod
from kubernetes_tpu_torch.runtime.sidecar import HealthServer, _Engine, _Session
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

DEADLINE = 60_000


# ---------------------------------------------------------------------------
# the pregrouped encode against the JAX package's
# ---------------------------------------------------------------------------

class _ToJax:
    """Port objects as JAX objects, each converted once (identity across
    waves is kept on both sides)."""

    def __init__(self):
        from torch_gang_reference import to_jax

        self.to_jax = to_jax
        self.memo = {}

    def __call__(self, obj):
        ent = self.memo.get(id(obj))
        if ent is None or ent[0] is not obj:
            ent = self.memo[id(obj)] = (obj, self.to_jax(obj))
        return ent[1]


def _waves():
    """(nodes, [(uids, reps, inv, bound)]) over churn: a pairwise wave, the
    next wave with the first one bound by clone_pod of its reps, then half
    of those departed and one bound copy whose labels drifted, then the
    same wave again."""
    snap = tw.spread_affinity(24, 64, seed=3)
    names = [nd.name for nd in snap.nodes]
    interner = SpecInterner()
    out, bound = [], []
    for w in range(1, 5):
        pods = snap.pending_pods if w == 1 else tw.mk_wave(snap, min(w, 3))
        uids, reps, inv = tw.pregroup(pods, interner)
        out.append((uids, reps, inv, list(bound)))
        if w == 1:
            bound = [clone_pod(reps[inv[k]], u, u, names[k % len(names)]) for k, u in enumerate(uids)]
        elif w == 2:
            bound = bound[::2]
            drifted = dataclasses.replace(bound[0], labels={**bound[0].labels, "app": "drifted"})
            bound = [drifted, *bound[1:]] + [clone_pod(reps[inv[k]], u, u, names[(3 * k) % len(names)])
                                             for k, u in enumerate(uids)]
    return snap.nodes, out


def test_pregrouped_encode_matches_jax_over_churn():
    from kubernetes_tpu.api.delta import DeltaEncoder as JaxDeltaEncoder
    from test_torch_delta import assert_same_encoding

    nodes, waves = _waves()
    J = _ToJax()
    jnodes = [J(n) for n in nodes]
    tenc, jenc = DeltaEncoder("cpu"), JaxDeltaEncoder()
    for w, (uids, reps, inv, bound) in enumerate(waves, 1):
        ta, tm = tenc.encode_pregrouped(nodes, bound, {}, uids, reps, inv)
        ja, jm = jenc.encode_pregrouped(jnodes, [J(p) for p in bound], {}, uids, [J(r) for r in reps], inv)
        assert_same_encoding(ta, tm, ja, jm)
        assert tenc.stats == jenc.stats, (w, tenc.stats, jenc.stats)
        # the one-shot encode of the same pods, materialized (names = uids)
        from kubernetes_tpu_torch.api.snapshot import Snapshot

        pods = [clone_pod(reps[inv[k]], u, u) for k, u in enumerate(uids)]
        fa, fm = DeltaEncoder("cpu").encode(Snapshot(nodes=nodes, pending_pods=pods, bound_pods=bound))
        for name in type(ta).FIELDS:
            assert np.array_equal(np.asarray(getattr(ta, name)), np.asarray(getattr(fa, name))), (w, name)
        assert tm.pod_names == fm.pod_names
    assert tenc.stats["delta"] == len(waves) - 1


@pytest.mark.parametrize("name", ["rounds-fit", "perpod-full"])
def test_pregrouped_gang_wave_matches_jax(name):
    """Pod groups reach the pregrouped encode through `pod_groups`: every
    field, the gang fields included, equals the JAX encoder's
    encode_pregrouped, and the device fixpoint over it decides as over the
    one-shot encode."""
    from kubernetes_tpu.api.delta import DeltaEncoder as JaxDeltaEncoder
    from kubernetes_tpu_torch.api.snapshot import encode_snapshot
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, gang, infer_score_config
    from test_torch_delta import assert_same_encoding

    snap = tw.gang_contended(name)
    uids, reps, inv = tw.pregroup(snap.pending_pods, SpecInterner())
    J = _ToJax()
    ta, tm = DeltaEncoder("cpu").encode_pregrouped(snap.nodes, [], snap.pod_groups, uids, reps, inv)
    ja, jm = JaxDeltaEncoder().encode_pregrouped([J(n) for n in snap.nodes], [], J(snap.pod_groups), uids,
                                                 [J(r) for r in reps], inv)
    assert_same_encoding(ta, tm, ja, jm)
    arr = DeltaEncoder("cpu").to_device(ta, tm)[0]
    c, _ = gang.gang_fixpoint_device(arr, infer_score_config(arr, DEFAULT_SCORE_CONFIG), device="cpu", chunked=True)
    farr, fm = encode_snapshot(snap, device="cpu")
    fc, _ = gang.gang_fixpoint_device(farr, infer_score_config(farr, DEFAULT_SCORE_CONFIG), device="cpu",
                                      chunked=True)
    name_of = dict(zip(uids, (p.name for p in snap.pending_pods)))
    got = {name_of[tm.pod_names[k]]: int(c[k]) for k in range(tm.n_pods)}
    assert got == {fm.pod_names[k]: int(fc[k]) for k in range(fm.n_pods)}


# ---------------------------------------------------------------------------
# the JAX client against the port's server, beside the JAX server
# ---------------------------------------------------------------------------

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


def _client(srv, **kw):
    from kubernetes_tpu.runtime import TPUScoreClient

    return TPUScoreClient(f"127.0.0.1:{srv.port}", **kw)


def _on_both(servers, case):
    """case(server) on the JAX server and on the port's -> the port's
    result, which must equal the JAX server's."""
    jax_srv, port_srv = servers
    want = case(jax_srv)
    got = case(port_srv)
    assert got == want
    return got


def _oracle(snap):
    from kubernetes_tpu.oracle import oracle_schedule

    return {f"default/{n}": node for n, node in oracle_schedule(snap)}


def test_wire_is_the_jax_packages_byte_for_byte():
    """The port's proto conversion writes the JAX package's bytes and reads
    them back to the same decisions."""
    from helpers import random_cluster
    from kubernetes_tpu.api import types as jt
    from kubernetes_tpu.runtime.convert import snapshot_to_proto as jax_to_proto
    from kubernetes_tpu_torch.runtime import convert
    from torch_preempt_reference import to_port

    snap = random_cluster(random.Random(9), n_nodes=6, n_pods=12, with_taints=True, with_selectors=True,
                          with_pairwise=True)
    snap.pod_groups["g"] = jt.PodGroup(name="g", min_member=2)
    port_snap = to_port(snap)
    assert convert.snapshot_to_proto(port_snap).SerializeToString() == jax_to_proto(snap).SerializeToString()
    back = convert.snapshot_from_proto(jax_to_proto(snap))
    assert back == port_snap and back.pod_groups["g"].min_member == 2


@pytest.mark.parametrize("session", [True, False])
def test_sidecar_schedules_over_loopback(servers, session):
    from helpers import mk_node, mk_pod
    from kubernetes_tpu.api.snapshot import Snapshot

    snap = Snapshot(nodes=[mk_node("a"), mk_node("b")],
                    pending_pods=[mk_pod("p0"), mk_pod("p1"), mk_pod("huge", cpu=10**6)])

    def case(srv):
        client = _client(srv, session=session)
        try:
            h = client.health()
            assert h.ok and h.device_count >= 1
            return client.schedule(snap, deadline_ms=DEADLINE)
        finally:
            client.close()

    got = _on_both(servers, case)
    assert got["default/huge"] is None and got == _oracle(snap)


@pytest.mark.parametrize("session", [True, False])
def test_sidecar_matches_gang_semantics(servers, session):
    """All-or-nothing: a group that cannot place all its pods is revoked
    (the session path takes the device fixpoint, the stateless one the
    host fixpoint)."""
    from helpers import mk_node, mk_pod
    from kubernetes_tpu.api.snapshot import Snapshot
    from kubernetes_tpu.oracle.reference import oracle_schedule_with_gangs

    pods = [mk_pod(f"g-{i}", cpu=600, pod_group="job") for i in range(3)]
    pods += [mk_pod(f"h-{i}", cpu=100, pod_group="small") for i in range(2)]
    snap = Snapshot(nodes=[mk_node("n0", cpu=1000)], pending_pods=pods)

    def case(srv):
        client = _client(srv, session=session)
        try:
            return client.schedule(snap, deadline_ms=DEADLINE, gang=True)
        finally:
            client.close()

    got = _on_both(servers, case)
    assert all(got[f"default/g-{i}"] is None for i in range(3))
    assert got == {f"default/{n}": node for n, node in oracle_schedule_with_gangs(snap)}


def _wave(n, tag, cpu=100):
    from helpers import mk_pod

    return [mk_pod(f"{tag}-{i}", cpu=cpu, labels={"app": f"svc-{i % 3}"}) for i in range(n)]


def test_session_delta_stream_matches_stateless(servers):
    from helpers import mk_node
    from kubernetes_tpu.api.snapshot import Snapshot

    nodes = [mk_node(f"n{i}", cpu=4000) for i in range(8)]

    def case(srv):
        client, stateless = _client(srv), _client(srv, session=False)
        bound, out = [], []
        for cycle in range(4):
            wave = _wave(6, f"c{cycle}")
            snap = Snapshot(nodes=nodes, pending_pods=wave, bound_pods=list(bound))
            got = client.schedule(snap, deadline_ms=DEADLINE)
            assert got == stateless.schedule(snap, deadline_ms=DEADLINE), cycle
            out.append(got)
            bound += [dataclasses.replace(p, node_name=got[p.uid]) for p in wave if got[p.uid]]
            bound.pop(0)  # churn: a bound pod departs each cycle
        assert client.stats["full"] == 1 and client.stats["delta"] == 3, client.stats
        client.close()
        stateless.close()
        return out

    _on_both(servers, case)


def test_session_deltas_survive_volume_state(servers):
    """tests/test_sidecar.py's volume case: the JAX client resolves volumes
    before the wire and fingerprints the raw storage state, so a stable PVC
    state stays on the delta path and a replaced PVC resyncs; the port's
    server gives the JAX server's verdicts throughout."""
    from helpers import mk_node, mk_pod
    from kubernetes_tpu.api import types as jt
    from kubernetes_tpu.api.snapshot import Snapshot

    pvc = jt.PersistentVolumeClaim(name="claim", request=1, wait_for_first_consumer=True)
    nodes = []
    for i in range(4):
        nd = mk_node(f"n{i}", cpu=4000)
        nd.volume_attach_limit = 8
        nodes.append(nd)
    waves = [_wave(3, f"v{c}") + [dataclasses.replace(mk_pod(f"vol-{c}", cpu=100), pvcs=("claim",))]
             for c in range(3)]
    pvc2 = dataclasses.replace(pvc, request=2)

    def case(srv):
        client, out = _client(srv), []
        for wave in waves:
            out.append(client.schedule(Snapshot(nodes=nodes, pending_pods=wave, pvcs={pvc.key: pvc}),
                                       deadline_ms=DEADLINE))
            assert any(out[-1].values())
        assert client.stats["full"] == 1 and client.stats["delta"] == 2, client.stats
        out.append(client.schedule(Snapshot(nodes=nodes, pending_pods=_wave(2, "after"), pvcs={pvc2.key: pvc2}),
                                   deadline_ms=DEADLINE))
        assert client.stats["full"] == 2, client.stats
        client.close()
        return out

    _on_both(servers, case)


def test_session_bind_compression_engages_and_matches(servers):
    from helpers import mk_node
    from kubernetes_tpu.api.snapshot import Snapshot

    nodes = [mk_node(f"n{i}", cpu=4000) for i in range(6)]

    def case(srv):
        client, stateless = _client(srv), _client(srv, session=False)
        bound, out, skipped = [], [], None
        for cycle in range(4):
            wave = _wave(8, f"c{cycle}")
            snap = Snapshot(nodes=nodes, pending_pods=wave, bound_pods=list(bound))
            got = client.schedule(snap, deadline_ms=DEADLINE)
            assert got == stateless.schedule(snap, deadline_ms=DEADLINE), cycle
            out.append(got)
            for k, p in enumerate(wave):
                if got[p.uid] is None:
                    continue
                if k == 3:  # the client declines one bind per wave
                    skipped = p.uid
                    continue
                bound.append(dataclasses.replace(p, node_name=got[p.uid]))
            bound.pop(0)
        assert client.stats["binds_compressed"] > 0 and client.stats["binds_explicit"] == 0, client.stats
        sess = next(iter(srv.engine._sessions.values()))
        assert skipped is not None and skipped not in sess.bound
        client.close()
        stateless.close()
        srv.engine._sessions.clear()
        return out

    _on_both(servers, case)


def test_session_bind_with_label_drift_ships_object(servers):
    from helpers import mk_node, mk_pod
    from kubernetes_tpu.api import types as jt
    from kubernetes_tpu.api.snapshot import Snapshot

    nodes = [mk_node(f"n{i}", cpu=4000) for i in range(4)]
    anti = jt.Affinity(required_pod_anti_affinity=(
        jt.PodAffinityTerm(topology_key=jt.LABEL_HOSTNAME, label_selector=jt.LabelSelector.of(app="web")),))
    w1 = [mk_pod("w1-0", cpu=100, labels={"app": "web"}, affinity=anti), mk_pod("w1-1", cpu=100, labels={"app": "web"})]

    def case(srv):
        client, stateless = _client(srv), _client(srv, session=False)
        v1 = client.schedule(Snapshot(nodes=nodes, pending_pods=w1), deadline_ms=DEADLINE)
        drifted = dataclasses.replace(w1[0], labels={"app": "db"}, node_name=v1[w1[0].uid])
        bound = [drifted, dataclasses.replace(w1[1], node_name=v1[w1[1].uid])]
        w2 = [dataclasses.replace(w1[0], name="w2-0", uid="")]
        w2[0].__post_init__()
        snap2 = Snapshot(nodes=nodes, pending_pods=w2, bound_pods=bound)
        got = client.schedule(snap2, deadline_ms=DEADLINE)
        assert got == stateless.schedule(snap2, deadline_ms=DEADLINE)
        client.close()
        stateless.close()
        return [v1, got]

    _on_both(servers, case)


def test_session_ships_bound_pod_updates(servers):
    from helpers import mk_node, mk_pod
    from kubernetes_tpu.api import types as jt
    from kubernetes_tpu.api.snapshot import Snapshot

    nodes = [mk_node(f"n{i}", cpu=4000) for i in range(4)]
    w1 = [mk_pod("b0", cpu=100, labels={"app": "web"})]
    anti = jt.Affinity(required_pod_anti_affinity=(
        jt.PodAffinityTerm(topology_key=jt.LABEL_HOSTNAME, label_selector=jt.LabelSelector.of(app="db")),))

    def case(srv):
        client, stateless = _client(srv), _client(srv, session=False)
        v1 = client.schedule(Snapshot(nodes=nodes, pending_pods=w1), deadline_ms=DEADLINE)
        bound = [dataclasses.replace(w1[0], node_name=v1[w1[0].uid])]
        client.schedule(Snapshot(nodes=nodes, pending_pods=[mk_pod("w2", cpu=100)], bound_pods=bound),
                        deadline_ms=DEADLINE)
        bound2 = [dataclasses.replace(bound[0], labels={"app": "db"})]  # a new object, same uid
        w3 = [mk_pod("anti-db", cpu=100, affinity=anti)]
        snap3 = Snapshot(nodes=nodes, pending_pods=w3, bound_pods=bound2)
        got = client.schedule(snap3, deadline_ms=DEADLINE)
        assert got == stateless.schedule(snap3, deadline_ms=DEADLINE)
        assert got[w3[0].uid] != bound2[0].node_name
        client.close()
        stateless.close()
        return [v1, got]

    _on_both(servers, case)


def test_session_node_change_forces_full_resync(servers):
    from helpers import mk_node
    from kubernetes_tpu.api.snapshot import Snapshot

    nodes = [mk_node(f"n{i}", cpu=4000) for i in range(3)]
    nodes2 = nodes + [mk_node("n-new", cpu=9000)]

    def case(srv):
        client, stateless = _client(srv), _client(srv, session=False)
        client.schedule(Snapshot(nodes=nodes, pending_pods=_wave(3, "a")), deadline_ms=DEADLINE)
        client.schedule(Snapshot(nodes=nodes, pending_pods=_wave(3, "b")), deadline_ms=DEADLINE)
        assert client.stats["delta"] == 1
        snap = Snapshot(nodes=nodes2, pending_pods=_wave(3, "c", cpu=5000))
        got = client.schedule(snap, deadline_ms=DEADLINE)
        assert got == stateless.schedule(snap, deadline_ms=DEADLINE)
        assert client.stats["full"] == 2 and all(v == "n-new" for v in got.values() if v)
        client.close()
        stateless.close()
        return got

    _on_both(servers, case)


def test_session_resync_after_server_restart():
    """A new server has no session: the client resyncs with ONE full
    snapshot inside the same call."""
    from helpers import mk_node
    from kubernetes_tpu.api.snapshot import Snapshot
    from kubernetes_tpu_torch.runtime.sidecar import TPUScoreServer

    srv1 = TPUScoreServer(engine=_Engine(device="cpu"))
    srv1.start()
    client = _client(srv1)
    nodes = [mk_node(f"n{i}", cpu=4000) for i in range(4)]
    v1 = client.schedule(Snapshot(nodes=nodes, pending_pods=_wave(4, "a")), deadline_ms=DEADLINE)
    assert any(v1.values())
    port = srv1.port
    srv1.stop(grace=0)
    srv2 = TPUScoreServer(f"127.0.0.1:{port}", engine=_Engine(device="cpu"))
    srv2.start()
    try:
        snap = Snapshot(nodes=nodes, pending_pods=_wave(4, "b"))
        v2 = client.schedule(snap, deadline_ms=DEADLINE)
        assert v2 == _oracle(snap) and client.stats["resync"] == 1, client.stats
    finally:
        srv2.stop()
        client.close()


def test_cold_large_session_not_ready_exactly_once():
    """A cold session above the warm-up threshold answers not_ready once;
    after the background warm-up (waited for on the engine's event) the
    same shapes serve."""
    from helpers import mk_node
    from kubernetes_tpu.api.snapshot import Snapshot
    from kubernetes_tpu.runtime import SidecarUnavailable
    from kubernetes_tpu_torch.runtime.sidecar import TPUScoreServer

    srv = TPUScoreServer(engine=_Engine(warmup_threshold=1, device="cpu"))  # everything is "large"
    srv.start()
    client = _client(srv)
    try:
        nodes = [mk_node(f"n{i}", cpu=4000) for i in range(4)]
        assert not client.health().ready or not srv.engine._sessions
        with pytest.raises(SidecarUnavailable, match="not ready"):
            client.schedule(Snapshot(nodes=nodes, pending_pods=_wave(4, "a")), deadline_ms=DEADLINE)
        assert srv.engine.warmed.wait(timeout=300)
        assert client.health().ready
        snap = Snapshot(nodes=nodes, pending_pods=_wave(4, "b"))
        v = client.schedule(snap, deadline_ms=DEADLINE)
        assert any(v.values()) and client.stats["not_ready"] == 1, client.stats
    finally:
        srv.stop()
        client.close()


def test_health_reports_the_engine_device(servers):
    _, port_srv = servers
    client = _client(port_srv)
    try:
        h = client.health()
        assert h.ok and h.platform == "cpu" and h.device_count == 1
    finally:
        client.close()


def test_schedule_span_joins_the_clients_trace():
    """The server's sidecar.schedule span is a child of the span the JAX
    client was in when it called (the trace context rides the gRPC
    metadata), in the collector the server was given."""
    from helpers import mk_node, mk_pod
    from kubernetes_tpu.api.snapshot import Snapshot
    from kubernetes_tpu.scheduler.tracing import Tracer as JaxTracer
    from kubernetes_tpu_torch.runtime.sidecar import TPUScoreServer
    from kubernetes_tpu_torch.scheduler.tracing import TraceCollector

    col = TraceCollector()
    srv = TPUScoreServer(engine=_Engine(device="cpu"), collector=col)
    srv.start()
    client = _client(srv, session=True)
    try:
        with JaxTracer(component="scheduler").span("batch.cycle") as parent:
            got = client.schedule(Snapshot(nodes=[mk_node("a")], pending_pods=[mk_pod("p0")]), deadline_ms=DEADLINE)
    finally:
        client.close()
        srv.stop()
    assert got == {"default/p0": "a"}
    spans = col.spans("sidecar.schedule")
    assert [(sp.trace_id, sp.parent_id, sp.component) for sp in spans] == [
        (parent.trace_id, parent.span_id, "sidecar")]
    assert spans[0].end >= spans[0].start and spans[0].attributes["pods"] == 1


def test_health_server_zpages():
    import urllib.request

    from kubernetes_tpu_torch.scheduler.metrics import Metrics

    m = Metrics()
    m.observe("sidecar_encode_seconds", 0.25)
    hs = HealthServer(component="test-sidecar", metrics=m, flags={"listen": "127.0.0.1:0", "deadline_ms": 1000})
    port = hs.start()
    try:
        def get(path):
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}") as r:
                return r.status, r.read().decode()

        st, body = get("/statusz")
        assert st == 200 and "test-sidecar" in body and "uptime_seconds" in body
        st, body = get("/flagz")
        assert st == 200 and "deadline_ms=1000" in body and "listen=" in body
        assert get("/healthz")[0] == 200 and get("/readyz")[0] == 200
        st, body = get("/metrics")
        assert st == 200 and 'sidecar_encode_seconds_bucket{le="0.262144"} 1' in body
    finally:
        hs.stop()


def test_wire_preserves_zero_hard_pod_affinity_weight(servers):
    from helpers import mk_node, mk_pod
    from kubernetes_tpu.api import types as jt
    from kubernetes_tpu.api.snapshot import Snapshot

    anchor = mk_pod("anchor", labels={"app": "db"})
    anchor.affinity = jt.Affinity(required_pod_affinity=(
        jt.PodAffinityTerm(topology_key=jt.LABEL_ZONE, label_selector=jt.LabelSelector.of(app="db")),))
    anchor.node_name = "n-z2"
    follower = mk_pod("follower", labels={"app": "db"})
    nodes = [mk_node("n-z1", labels={jt.LABEL_ZONE: "z1"}), mk_node("n-z2", labels={jt.LABEL_ZONE: "z2"})]
    snap = Snapshot(nodes=nodes, pending_pods=[follower], bound_pods=[anchor])

    def case(srv):
        out = []
        for session in (True, False):
            client = _client(srv, session=session)
            out.append(client.schedule(snap, deadline_ms=DEADLINE, hard_pod_affinity_weight=10.0))
            out.append(client.schedule(snap, deadline_ms=DEADLINE, hard_pod_affinity_weight=0.0))
            client.close()
        return out

    got = _on_both(servers, case)
    assert [g["default/follower"] for g in got] == ["n-z2", "n-z1"] * 2


def test_wire_carries_preferred_affinity_and_images(servers):
    from helpers import mk_node, mk_pod
    from kubernetes_tpu.api import types as jt
    from kubernetes_tpu.api.snapshot import Snapshot

    img = "registry.io/model:v1"
    warm = mk_node("warm", labels={jt.LABEL_ZONE: "z1"})
    warm.images[img] = 900 * 1024 * 1024
    anchor = mk_pod("anchor", labels={"app": "db"})
    anchor.node_name = "warm"
    follower = mk_pod("follower", images=(img,))
    follower.affinity = jt.Affinity(preferred_pod_affinity=(jt.WeightedPodAffinityTerm(
        weight=100, term=jt.PodAffinityTerm(topology_key=jt.LABEL_ZONE, label_selector=jt.LabelSelector.of(app="db"))),))
    snap = Snapshot(nodes=[mk_node("cold"), warm], pending_pods=[follower], bound_pods=[anchor])

    def case(srv):
        out = []
        for session in (True, False):
            client = _client(srv, session=session)
            out.append(client.schedule(snap, deadline_ms=DEADLINE))
            client.close()
        return out

    got = _on_both(servers, case)
    assert all(g == _oracle(snap) and g["default/follower"] == "warm" for g in got)


def test_scheduler_offloads_to_the_ports_sidecar(servers):
    """The JAX Scheduler in tpu mode, its TPUScore plugin pointed at the
    port's server, binds as the oracle does."""
    from helpers import mk_node, mk_pod
    from kubernetes_tpu.scheduler import ClusterStore, Scheduler, SchedulerConfiguration
    from kubernetes_tpu.scheduler.config import Profile, TPUScoreArgs

    _, port_srv = servers
    prof = Profile(tpu_score=TPUScoreArgs(sidecar_address=f"127.0.0.1:{port_srv.port}", deadline_ms=DEADLINE))
    store = ClusterStore()
    store.add_node(mk_node("n0"))
    store.add_node(mk_node("n1", cpu=500))
    sched = Scheduler(store, SchedulerConfiguration(mode="tpu", profiles=(prof,)))
    store.add_pod(mk_pod("p", cpu=1000))
    sched.run_until_idle()
    assert store.pods["default/p"].node_name == "n0"
    assert sched.metrics.counters.get("tpuscore_fallback_total", 0) == 0


def test_run_session_enqueues_under_the_lock_and_reads_outside_it(monkeypatch):
    """run_session holds the device lock over the encode and the dispatch
    only: the gang fixpoint is queued under it and read back after it is
    released, and the metrics split the three phases."""
    from kubernetes_tpu_torch.ops import gang

    eng = _Engine(device="cpu")
    held = {}
    dispatch0, finish0 = gang.gang_dispatch, gang.gang_finish

    def spy_dispatch(*a, **k):
        held["dispatch"] = eng._lock.locked()
        return dispatch0(*a, **k)

    def spy_finish(*a, **k):
        held["finish"] = eng._lock.locked()
        return finish0(*a, **k)

    monkeypatch.setattr(gang, "gang_dispatch", spy_dispatch)
    monkeypatch.setattr(gang, "gang_finish", spy_finish)
    snap = tw.gang_contended("rounds-fit")
    res = tw.session_waves(eng, lambda: _Session(1.0, "cpu"), clone_pod, SpecInterner(), snap, True, waves=1)
    assert held == {"dispatch": True, "finish": False} and res[0]["scheduled"] == 20
    for name in ("sidecar_encode_seconds", "sidecar_dispatch_seconds", "sidecar_step_seconds"):
        assert eng.metrics.hist(name).stats()[2] == 1, name


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_engine_loads_every_route_kernel_at_start():
    """_Engine(device="cuda") launches K10 and one gated iteration of every
    route's kernels when it starts (ops/gang.py load_kernels), so no module
    loads lazily under the device lock."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card: python -m pytest --noconftest "
                    "-m cuda tests/test_torch_sidecar.py")
    from kubernetes_tpu_torch.ops import kernels

    kernels.reset_launches()
    _Engine(device="cuda")
    assert {k for k, v in kernels.LAUNCHES.items() if v} == {
        "score_planes", "packed_static_rows", "chunk_rounds_dense", "rounds", "static_feasible", "fit_scan",
        "full_scan", "gang_quorum"}


@pytest.mark.cuda
@pytest.mark.parametrize("name,gang", [("rounds-pairwise", False), ("rounds-pairwise", True), ("perpod-fit", True)])
def test_run_session_on_the_card(name, gang):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card: python -m pytest --noconftest "
                    "-m cuda tests/test_torch_sidecar.py")
    snap = tw.gang_contended(name)
    got = tw.session_waves(_Engine(device="cuda"), lambda: _Session(1.0, "cuda"), clone_pod, SpecInterner(), snap,
                           gang, waves=2)
    want = tw.session_waves(_Engine(device="cpu"), lambda: _Session(1.0, "cpu"), clone_pod, SpecInterner(), snap,
                            gang, waves=2)
    assert [(g["sha256"], g["scheduled"]) for g in got] == [(w["sha256"], w["scheduled"]) for w in want]
