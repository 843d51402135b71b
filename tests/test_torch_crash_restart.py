"""The port's crash restart and failover against the JAX package's, on the
CPU (after tests/test_crash_restart.py).

Every case runs once per package (tests/torch_scheduler_sides.py: the JAX
Scheduler, and the port's on device="cpu"), each under its own package's
chaos injector with the same fault plan, installed and uninstalled around
the case, and the returns are held equal, exactly:

- the store's placements, the event log, the queue's pools and counters
  (torch_scheduler_sides.observe), the restart count and every restore
  report, scheduler_restarts_total / checkpoint_corrupt_total and the
  fault ledger (framework_fault_injected_total{site,action},
  framework_fault_recovery_total{site,action});
- the checkpoint document each side finds when its replacement restores
  (what the killed incarnation last wrote), field by field, except
  saved_at / saved_wall (clocks), the lineage (a random id of each store,
  held to its own store's) and the arrival / pop ages' values (their keys
  are compared).

The cases: kill-point parity over every kill site x pipelined commits on /
off x class state on / off (KTPU_INCREMENTAL), with churn; a seeded kill
storm; crash-only restart without a checkpoint dir; the mid-flush suffix;
the dead instance's latch; corrupt, checksum-mismatched, absent and
other-lineage checkpoints, and the checkpoint files themselves; arrival
ages through a kill; standby takeover within one lease, its HA metrics and
ha_fields; a dead replica never reacquires; the node lifecycle
controller; sites_matching and the seeded plans.  Besides, each restart's
placements equal the port's fault-free run's, and no pod is lost.
Tolerance: none.
"""

import contextlib
import json
import os
import random
import time

import pytest

from helpers import mk_node, mk_pod
from torch_scheduler_sides import Side, Store, observe
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

pytest.importorskip("jax")

SIDES = ("jax", "port")
NO_GANGS = (("GangScheduling", False),)
CKPT = "scheduler_state.json"


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    sides = [Side(n) for n in SIDES]
    for x in sides:
        x.chaos.uninstall()
    yield
    for x in sides:
        x.chaos.uninstall()


def modules(x):
    """(scheduler module, checkpoint module, leases module, harness ha_fields) of a side."""
    if x.name == "jax":
        from kubernetes_tpu.bench.harness import ha_fields
        from kubernetes_tpu.scheduler import checkpoint, leases, scheduler
    else:
        from kubernetes_tpu_torch.bench.harness import ha_fields
        from kubernetes_tpu_torch.scheduler import checkpoint, leases, scheduler
    return scheduler, checkpoint, leases, ha_fields


def fault_ledger(m) -> dict:
    got = {name: sorted(m.labeled_counter_series(name).items())
           for name in ("framework_fault_injected_total", "framework_fault_recovery_total")}
    for name in ("scheduler_restarts_total", "checkpoint_corrupt_total", "leader_election_transitions_total"):
        got[name] = m.counters.get(name, 0)
    return got


def doc_shape(doc, lineage: str) -> dict:
    """A checkpoint document with its clock fields dropped and its ages'
    values replaced by their keys; its lineage held to the store's."""
    if doc is None:
        return None
    assert doc.pop("lineage") == lineage
    doc.pop("saved_at")
    doc.pop("saved_wall")
    for k in ("arrivals", "popped"):
        doc[k] = sorted(doc[k] or {})
    return doc


def bare_store(x, nodes=()):
    """(converting store, raw store) of side x with `nodes`, no Scheduler."""
    raw = x.S.ClusterStore()
    store = Store(raw, x.conv)
    for nd in nodes:
        store.add_node(nd)
    return store, raw


@contextlib.contextmanager
def restores(x):
    """Records each Scheduler.restore of side x while open: (the checkpoint
    document the replacement finds, the report)."""
    seen = []
    cls = x.S.Scheduler
    orig = cls.restore

    def restore(self, killed_site=None):
        doc = None
        if self._ckpt is not None and os.path.exists(os.path.join(self._ckpt.directory, CKPT)):
            with open(os.path.join(self._ckpt.directory, CKPT)) as f:
                doc = doc_shape(json.load(f)["data"], self.store.lineage)
        rep = orig(self, killed_site=killed_site)
        seen.append((doc, rep))
        return rep

    cls.restore = restore
    try:
        yield seen
    finally:
        cls.restore = orig


def run(x, monkeypatch, plan=None, ckpt_dir=None, pipeline=True, gang=True, incremental=True, churn=0,
        driver="run_restartable", **driver_kw):
    """test_crash_restart.py's _run on side x: 20 pods on 5 nodes driven
    through `driver` (every kill.* fault answered by a restart), then
    `churn` rounds that delete 6 bound pods and add their replacements.
    -> (placements, what the run saw)."""
    mod = modules(x)[0]
    monkeypatch.setenv("KTPU_PIPELINE", "1" if pipeline else "0")
    monkeypatch.setenv("KTPU_INCREMENTAL", "1" if incremental else "0")
    if ckpt_dir:
        monkeypatch.setenv("KTPU_CHECKPOINT_DIR", str(ckpt_dir / x.name))
    else:
        monkeypatch.delenv("KTPU_CHECKPOINT_DIR", raising=False)
    gates = () if gang else NO_GANGS
    with restores(x) as seen, (x.chaos.chaos_plan(plan) if plan is not None
                                            else contextlib.nullcontext()):
        store, sched = x.cluster(nodes=[mk_node(f"n{i}", cpu=3000, pods=16) for i in range(5)],
                                 config=x.cfg("tpu", feature_gates=gates))
        for i in range(20):
            store.add_pod(mk_pod(f"p{i}", cpu=250))
        sched, restarts = getattr(mod, driver)(sched, **driver_kw)
        rng = random.Random(5)
        for r in range(churn):
            bound = sorted((p for p in store.pods.values() if p.node_name), key=lambda p: p.uid)
            for v in rng.sample(bound, 6):
                store.delete_pod(v.uid)
                store.add_pod(mk_pod(f"{v.name}-r{r}", cpu=250))
            sched, more = getattr(mod, driver)(sched, **driver_kw)
            restarts += more
    placements = {p.name: p.node_name for p in store.pods.values()}
    return placements, dict(observe=observe(store, sched), restarts=restarts, ledger=fault_ledger(sched.metrics),
                            restores=list(seen))


def both_run(monkeypatch, tmp_path, spec=None, **kw):
    """run() on each side under the same fault plan (each side's own
    parse of `spec`), held equal; -> the port's (placements, seen)."""
    out = []
    for name in SIDES:
        x = Side(name)
        plan = spec(x) if callable(spec) else (x.chaos.FaultPlan.parse(spec) if spec else None)
        out.append(run(x, monkeypatch, plan=plan, **kw))
    (want, want_seen), (got, seen) = out
    assert got == want and seen == want_seen
    return got, seen


# --- kill-point parity: each enumerated point x pipeline x incremental ---
CASES = [(site, pipeline, incremental) for site in Side("port").chaos.KILL_SITES
         for pipeline in (True, False) for incremental in (True, False)
         if not (site == "kill.mid_flush" and not pipeline)]  # no deferred flush without pipelined commits


@pytest.mark.parametrize("site,pipeline,incremental", CASES)
def test_kill_point_parity_matches_jax(site, pipeline, incremental, monkeypatch, tmp_path):
    gang = site != "kill.mid_flush"
    spec = f"{site}:kill@1" if site == "kill.mid_step" else f"{site}:kill@0"
    got, seen = both_run(monkeypatch, tmp_path, spec, ckpt_dir=tmp_path, pipeline=pipeline, gang=gang,
                         incremental=incremental, churn=1)
    oracle, _ = run(Side("port"), monkeypatch, pipeline=False, gang=gang, incremental=incremental, churn=1)
    assert seen["restarts"] >= 1 and len(seen["restores"]) == seen["restarts"]
    assert got == oracle and all(got.values())  # zero lost pods
    assert seen["ledger"]["scheduler_restarts_total"] >= 1


def test_kill_storm_matches_jax(monkeypatch, tmp_path):
    """A seeded storm across all kill points, with churn: every kill
    answered by a restart; each pod has a Scheduled event."""
    got, seen = both_run(monkeypatch, tmp_path,
                         lambda x: x.chaos.FaultPlan.from_seed(7, sites=x.chaos.KILL_SITES, n_faults=6),
                         ckpt_dir=tmp_path, gang=False, churn=2)
    oracle, _ = run(Side("port"), monkeypatch, pipeline=False, gang=False, churn=2)
    assert seen["restarts"] >= 2 and got == oracle
    scheduled = {pod for reason, pod, _, _ in seen["observe"]["events"] if reason == "Scheduled"}
    assert {name for name, node in got.items() if node} <= {u.split("/", 1)[1] for u in scheduled}


def test_kill_without_checkpoint_dir_is_crash_only(monkeypatch, tmp_path):
    got, seen = both_run(monkeypatch, tmp_path, "kill.post_assume:kill@0")
    oracle, _ = run(Side("port"), monkeypatch, pipeline=False)
    assert seen["restarts"] == 1 and got == oracle
    assert seen["restores"][0][0] is None  # nothing checkpointed: the watch rebuilds everything


def test_mid_flush_kill_replays_exactly_the_unpublished_suffix(monkeypatch, tmp_path):
    got, seen = both_run(monkeypatch, tmp_path, "kill.mid_flush:kill@2", ckpt_dir=tmp_path, gang=False)
    assert seen["restarts"] == 1 and all(got.values())
    uids = [pod for reason, pod, _, _ in seen["observe"]["events"] if reason == "Scheduled"]
    assert len(uids) == 20 == len(set(uids))  # no pod published twice
    doc, rep = seen["restores"][0]
    assert rep["wal_applied"] == len(doc["wal"]) - rep["wal_skipped"] > 0


def latch(x):
    """While killed() is latched, the dying instance's flush publishes
    nothing; revive() re-arms it."""
    store, sched = x.cluster(nodes=[mk_node("n0", cpu=8000, pods=64)],
                             config=x.cfg("tpu", feature_gates=NO_GANGS))
    store.add_pod(mk_pod("d0", cpu=100))
    p = store.pods["default/d0"]
    sched.cache.assume(p.uid, "n0")
    sched._deferred_binds.append((p, "n0"))
    seen = []
    with x.chaos.chaos_plan(x.chaos.FaultPlan.parse("kill.post_assume:kill@99")):
        x.chaos.plan._KILLED = True  # the latch lives in the plan module
        try:
            sched._flush_deferred_binds()
            seen.append((len(sched._deferred_binds), store.pods[p.uid].node_name))
        finally:
            x.chaos.revive()
    sched._flush_deferred_binds()
    seen.append((len(sched._deferred_binds), store.pods[p.uid].node_name))
    return seen


def test_killed_latch_suppresses_dead_instance_teardown():
    want, got = (latch(Side(n)) for n in SIDES)
    assert got == want == [(1, ""), (0, "n0")]


# --- checkpoint corruption: quarantine, never silence ---
def corruption(x, tmp_path, how):
    _, ck, _, _ = modules(x)
    m = x.metrics_mod.Metrics()
    d = tmp_path / x.name
    cm = ck.CheckpointManager(str(d), metrics=m)
    path = str(d / CKPT)
    if how == "truncated":
        ck.save_scheduler_state(cm, {"u1": "n0"}, [("u2", "n1")], {"u1": 1.5})
        with open(path, "w") as f:
            f.write('{"truncated')
    elif how == "checksum":
        cm.save("scheduler_state", {"assumed": {"u": "n"}})
        doc = json.load(open(path))
        doc["data"]["assumed"]["u"] = "evil"  # a bit flip without re-checksum
        json.dump(doc, open(path, "w"))
    got = cm.load("scheduler_state")
    return got, os.path.exists(path + ".corrupt"), os.path.exists(path), m.counters.get("checkpoint_corrupt_total", 0), \
        sorted(os.listdir(str(d)))


@pytest.mark.parametrize("how", ["truncated", "checksum", "absent"])
def test_checkpoint_quarantine_matches_jax(how, tmp_path):
    want, got = (corruption(Side(n), tmp_path, how) for n in SIDES)
    assert got == want
    if how == "absent":
        assert got == (None, False, False, 0, [])  # a first boot is not corruption
    else:
        assert got[:4] == (None, True, False, 1)  # the evidence kept, counted


def test_checkpoint_documents_match_jax(tmp_path):
    """save_scheduler_state / load_scheduler_state round trip: the same file
    (the clocks aside) and the same defaults on each side."""
    docs = []
    for name in SIDES:
        _, ck, _, _ = modules(Side(name))
        cm = ck.CheckpointManager(str(tmp_path / name))
        ck.save_scheduler_state(cm, {"a": "n0"}, [("b", "n1"), ("c", "n2")], {"a": 1.25, "b": 0.5}, lineage="L",
                                wave={"uids": ["b", "c"], "verdict_crc": "0badf00d"},
                                cursor={"v_now": 1.5, "i": 7}, popped={"b": 0.25})
        raw = json.load(open(tmp_path / name / CKPT))
        loaded = ck.load_scheduler_state(cm)
        for d in (raw["data"], loaded):
            d.pop("saved_at"), d.pop("saved_wall")
        cm.save("other", {"x": [1, 2]})
        docs.append((raw["data"], sorted(raw), loaded, ck.load_assumed(cm), open(tmp_path / name / "other.json").read()))
    assert docs[0] == docs[1]


def corrupt_restore(x, tmp_path, monkeypatch):
    """A corrupt checkpoint at restore time: quarantined and counted, then a
    crash-only rebuild schedules everything."""
    monkeypatch.setenv("KTPU_CHECKPOINT_DIR", str(tmp_path / x.name))
    store, sched = x.cluster(nodes=[mk_node(f"n{i}", cpu=3000, pods=16) for i in range(5)])
    for i in range(20):
        store.add_pod(mk_pod(f"p{i}", cpu=250))
    with open(tmp_path / x.name / CKPT, "w") as f:
        f.write("not json at all")
    report = sched.restore()
    sched.run_until_idle()
    return report, fault_ledger(sched.metrics), observe(store, sched)


def test_restore_after_corrupt_checkpoint_matches_jax(tmp_path, monkeypatch):
    want, got = (corrupt_restore(Side(n), tmp_path, monkeypatch) for n in SIDES)
    assert got == want
    assert got[0]["wal_applied"] == 0 and got[1]["checkpoint_corrupt_total"] == 1
    assert all(node for _, node, _ in got[2]["pods"])


def lineage(x, tmp_path, monkeypatch):
    """A checkpoint dir reused by another cluster with a colliding uid never
    replays its WAL there; the same store's restart replays it once."""
    monkeypatch.setenv("KTPU_CHECKPOINT_DIR", str(tmp_path / x.name))
    store1, s1 = x.cluster(nodes=[mk_node("n0", cpu=8000, pods=16)])
    store1.add_pod(mk_pod("same-name", cpu=100))
    p = store1.pods["default/same-name"]
    s1._deferred_binds.append((p, "n0"))
    s1._checkpoint_state()  # a durable WAL entry for p's uid
    store2, s2 = x.cluster(nodes=[mk_node("n0", cpu=8000, pods=16)])
    store2.add_pod(mk_pod("same-name", cpu=100))
    report = s2.restore()
    seen = [report, store2.pods[p.uid].node_name, fault_ledger(s2.metrics)]
    s1._checkpoint_state()
    s1b = modules(x)[0].restart_scheduler(s1)
    seen += [store1.pods[p.uid].node_name, fault_ledger(s1b.metrics), observe(store1, s1b)]
    return seen


def test_checkpoint_from_another_cluster_lineage_is_ignored(tmp_path, monkeypatch):
    want, got = (lineage(Side(n), tmp_path, monkeypatch) for n in SIDES)
    assert got == want
    assert got[0]["wal_applied"] == 0 and got[1] == "" and got[3] == "n0"
    assert got[4]["scheduler_restarts_total"] >= 1


# --- SLI continuity across restart ---
def arrivals(x, tmp_path, monkeypatch):
    """A pod that waited before a kill.post_checkpoint crash keeps its served
    wait through run_restartable's restore: the SLI sample includes it."""
    monkeypatch.setenv("KTPU_CHECKPOINT_DIR", str(tmp_path / x.name))
    metrics = x.metrics_mod.Metrics()
    store, sched = x.cluster(nodes=[mk_node("n0", cpu=3000, pods=16)], metrics=metrics)
    store.add_pod(mk_pod("aged", cpu=250))
    time.sleep(0.08)  # the wait the restored SLI must keep
    with restores(x) as seen, \
            x.chaos.chaos_plan(x.chaos.FaultPlan.parse("kill.post_checkpoint:kill@0")):
        sched, restarts = modules(x)[0].run_restartable(sched)
    _p50, p99, count = metrics.hists["pod_scheduling_sli_duration_seconds"].stats()
    assert p99 >= 0.08  # a clock restarted at the reincarnation would observe ~ms
    return restarts, store.pods["default/aged"].node_name, count, list(seen), observe(store, sched), \
        fault_ledger(metrics)


def test_arrival_age_survives_kill_restore(tmp_path, monkeypatch):
    want, got = (arrivals(Side(n), tmp_path, monkeypatch) for n in SIDES)
    assert got == want
    assert got[:3] == (1, "n0", 1)
    doc, rep = got[3][0]
    assert doc["arrivals"] == ["default/aged"] and rep["restored_arrivals"] == 1


def stamps(x, tmp_path, monkeypatch):
    """A pod that waited before the crash (no node yet) keeps its served
    wait after restart_scheduler: the SLI sample includes it."""
    monkeypatch.setenv("KTPU_CHECKPOINT_DIR", str(tmp_path / x.name))
    store, sched = x.cluster()
    store.add_pod(mk_pod("w0", cpu=100))
    sched._checkpoint_state()
    with open(tmp_path / x.name / CKPT) as f:
        doc = doc_shape(json.load(f)["data"], store.lineage)
    time.sleep(0.05)  # the wait it serves while the process is "dead"
    sched2 = modules(x)[0].restart_scheduler(sched)
    store.add_node(mk_node("n0", cpu=8000, pods=16))
    sched2.run_until_idle()
    _p50, p99, count = sched2.metrics.hists["pod_scheduling_sli_duration_seconds"].stats()
    assert p99 >= 0.05  # the pre-restart wait is in the SLI
    return doc, count, store.pods["default/w0"].node_name, observe(store, sched2), fault_ledger(sched2.metrics)


def test_arrival_stamps_ride_the_checkpoint(tmp_path, monkeypatch):
    want, got = (stamps(Side(n), tmp_path, monkeypatch) for n in SIDES)
    assert got == want
    assert got[0]["arrivals"] == ["default/w0"] and got[1:3] == (1, "n0")


def test_stale_arrival_entries_do_not_seed_the_queue():
    for name in SIDES:
        x = Side(name)
        _, sched = x.cluster()
        assert sched.queue.restore_arrivals({"ghost-uid": 12.0}) == 0
        assert "ghost-uid" not in sched.queue._arrival_at


# --- active/standby failover ---
def takeover(x, tmp_path, monkeypatch):
    """The active dies silently; within the lease the standby's CAS fails,
    one retry period past expiry it wins, restores and schedules the
    backlog; the blackout lands in failover_duration_seconds and a
    leader.takeover span."""
    _, _, leases, _ = modules(x)
    monkeypatch.setenv("KTPU_CHECKPOINT_DIR", str(tmp_path / x.name))
    metrics = x.metrics_mod.Metrics()
    if x.name == "jax":
        from kubernetes_tpu.scheduler.tracing import TraceCollector
    else:
        from kubernetes_tpu_torch.scheduler.tracing import TraceCollector
    col = TraceCollector()
    store, raw = bare_store(x, [mk_node(f"h{i}", cpu=3000, pods=16) for i in range(5)])
    clock = x.FakeClock()
    lease_store = leases.LeaseStore(clock=clock)

    def make():
        return x.scheduler(raw, x.cfg("tpu"), metrics=metrics, collector=col)

    a = leases.HAReplica("sched-a", lease_store, make, lease_duration_s=5.0, metrics=metrics)
    b = leases.HAReplica("sched-b", lease_store, make, lease_duration_s=5.0, metrics=metrics)
    seen = [a.tick(), b.tick(), b.scheduler is None]
    for i in range(10):
        store.add_pod(mk_pod(f"q{i}", cpu=200))
    a.scheduler.run_until_idle()
    a.kill()
    clock.step(4.9)
    seen.append(b.tick())
    clock.step(0.2)
    seen.append(b.tick())
    for i in range(10, 20):
        store.add_pod(mk_pod(f"q{i}", cpu=200))
    b.scheduler.run_until_idle()
    _p50, _p99, count = metrics.hists["failover_duration_seconds"].stats()
    spans = col.spans(name="leader.takeover")
    blackouts = [s.attributes.get("blackout_s", 0.0) for s in spans]
    assert max(blackouts) <= 5.0  # within one lease duration of the expiry
    seen += [count, len(spans), [s.attributes["identity"] for s in spans], round(max(blackouts), 6),
             fault_ledger(metrics), observe(store, b.scheduler)]
    return seen


def test_standby_takes_over_within_one_lease_duration(tmp_path, monkeypatch):
    want, got = (takeover(Side(n), tmp_path, monkeypatch) for n in SIDES)
    assert got == want
    assert got[:5] == [True, False, True, False, True] and got[5] == 2  # the election and the takeover
    assert got[9]["leader_election_transitions_total"] == 2  # the first election and the takeover
    assert all(node for _, node, _ in got[10]["pods"])


def test_run_ha_restartable_records_failover_matches_jax(monkeypatch, tmp_path):
    """Every kill fells the leader and a standby's takeover resumes the run:
    the HA series and ha_fields."""
    lease_s = 0.1
    got, seen = both_run(monkeypatch, tmp_path, "kill.post_checkpoint:kill@0", ckpt_dir=tmp_path, gang=False,
                         driver="run_ha_restartable", lease_duration_s=lease_s)
    oracle, _ = run(Side("port"), monkeypatch, pipeline=False, gang=False)
    assert seen["restarts"] == 1 and got == oracle
    assert seen["ledger"]["leader_election_transitions_total"] == 1
    ha = []
    for name in SIDES:
        x = Side(name)
        _, _, _, ha_fields = modules(x)
        monkeypatch.setenv("KTPU_CHECKPOINT_DIR", str(tmp_path / ("ha-" + name)))
        with x.chaos.chaos_plan(x.chaos.FaultPlan.parse("kill.post_checkpoint:kill@0")):
            store, sched = x.cluster(nodes=[mk_node("n0", cpu=3000, pods=16)], config=x.cfg("tpu", feature_gates=NO_GANGS))
            store.add_pod(mk_pod("p0", cpu=250))
            sched, _ = modules(x)[0].run_ha_restartable(sched, lease_duration_s=lease_s)
        out = ha_fields(sched.metrics)
        # the blackout: how far past the dead leader's expiry the takeover
        # landed, plus the replacement's build and restore
        assert out["failover_p99_ms"] > 0 and out["failover_p50_ms"] > 0
        ha.append({k: v for k, v in out.items() if not k.startswith("failover_p")})
    assert ha[0] == ha[1] and ha[1]["failover_count"] == 1


def dead_replica(x):
    _, _, leases, _ = modules(x)
    clock = x.FakeClock()
    lease_store = leases.LeaseStore(clock=clock)
    _, raw = bare_store(x, [mk_node("h0", cpu=3000, pods=16)])
    a = leases.HAReplica("sched-a", lease_store, lambda: x.scheduler(raw, x.cfg("tpu")), lease_duration_s=5.0)
    b = leases.HAReplica("sched-b", lease_store, lambda: x.scheduler(raw, x.cfg("tpu")), lease_duration_s=5.0)
    seen = [a.tick()]
    a.kill()
    clock.step(100.0)
    seen += [a.tick(), b.tick(), lease_store.get("kube-scheduler").holder,
             lease_store.get("kube-scheduler").resource_version]
    return seen


def test_dead_replica_never_reacquires():
    want, got = (dead_replica(Side(n)) for n in SIDES)
    assert got == want == [True, False, True, "sched-b", 2]


def lifecycle(x):
    """NodeLifecycleController: a stale heartbeat taints the node
    unreachable, its pods are evicted after the toleration window, and a
    renewed heartbeat lifts the taint."""
    _, _, leases, _ = modules(x)
    clock = x.FakeClock()
    lease_store = leases.LeaseStore(clock=clock)
    store, raw = bare_store(x, [mk_node("h0", cpu=3000, pods=16), mk_node("h1", cpu=3000, pods=16)])
    for n in ("h0", "h1"):
        lease_store.renew_node_heartbeat(n)
    store.add_pod(mk_pod("b0", cpu=100))
    raw.bind("default/b0", "h1")
    ctl = leases.NodeLifecycleController(raw, lease_store, grace_s=40.0, eviction_s=300.0)
    seen = [ctl.tick()]
    clock.step(41.0)
    lease_store.renew_node_heartbeat("h0")
    seen.append(ctl.tick())
    seen.append(sorted((nd.name, [tn.key for tn in nd.taints]) for nd in raw.list_nodes()))
    clock.step(300.0)
    lease_store.renew_node_heartbeat("h0")
    seen.append(ctl.tick())
    lease_store.renew_node_heartbeat("h1")
    seen.append(ctl.tick())
    seen.append(sorted((nd.name, [tn.key for tn in nd.taints]) for nd in raw.list_nodes()))
    return seen


def test_node_lifecycle_matches_jax():
    want, got = (lifecycle(Side(n)) for n in SIDES)
    assert got == want and got[3] == ["default/b0"]


# --- chaos-site selection ---
def test_sites_matching_matches_jax():
    for x in (Side(n) for n in SIDES):
        c = x.chaos
        assert c.sites_matching("kill.*") == c.ALL_KILL_SITES == c.KILL_SITES + c.STREAM_KILL_SITES
        rest = c.sites_matching("*,!kill.*")
        assert not set(rest) & set(c.ALL_KILL_SITES) and "sidecar.rpc" in rest
        mixed = c.sites_matching("scheduler.*,kill.mid_flush")
        assert "scheduler.step" in mixed and "kill.mid_flush" in mixed
        assert c.sites_matching("no.such.*") == ()
    jx, pt = Side("jax").chaos, Side("port").chaos
    for spec in ("kill.*", "*,!kill.*", "scheduler.*,kill.mid_flush", "pipeline.*"):
        assert jx.sites_matching(spec) == pt.sites_matching(spec)
    for seed in range(12):
        # the default pool never draws a kill site; a kill-site storm draws only kills
        assert not any(f.site in pt.KILL_SITES for f in pt.FaultPlan.from_seed(seed).faults)
        assert all(f.action == "kill" for f in pt.FaultPlan.from_seed(seed, sites=pt.KILL_SITES).faults)
        assert jx.FaultPlan.from_seed(seed).describe() == pt.FaultPlan.from_seed(seed).describe()
        assert jx.FaultPlan.from_seed(seed, sites=jx.KILL_SITES).describe() == \
            pt.FaultPlan.from_seed(seed, sites=pt.KILL_SITES).describe()


def test_ha_fields_artifact_block():
    blocks = []
    for name in SIDES:
        x = Side(name)
        ha_fields = modules(x)[3]
        m = x.metrics_mod.Metrics()
        assert ha_fields(m) is None  # an untouched run keeps its artifact shape
        m.inc("scheduler_restarts_total")
        m.observe("failover_duration_seconds", 0.2)
        blocks.append(ha_fields(m))
    assert blocks[0] == blocks[1]
    assert blocks[1]["scheduler_restarts_total"] == 1.0 and blocks[1]["failover_count"] == 1
    assert blocks[1]["failover_p99_ms"] > 0
