"""The port's Scheduler under injected faults, against the JAX package's, on
the CPU.

Every case runs once per package (tests/torch_scheduler_sides.py), each
under its own package's chaos injector with the same fault plan, and the
returns are held equal, exactly: the store's bindings, the events, the
queue's pools, the counters (tests/torch_scheduler_sides.py observe), and
the fault ledger — framework_fault_injected_total{site,action},
framework_fault_recovery_total{site,action} and
scheduling_wave_recoveries_total.

The cases are test_chaos.py's scheduler-level ones, on both batch
branches: the gang fixpoint (GangScheduling on, the default) and the
routed dispatch -> flush -> finish branch (the gate off, with and without
the deferred binds):
  - a batch step that raises (scheduler.step:error) or reads back poisoned
    verdicts (scheduler.step:nan), recovered by the serial replay, and a
    slow host (host.stall); placements equal the fault-free run's;
  - a crash in the bind fan-out mid-commit (first and third bind), which
    releases the cycle's assumptions and requeues the stranded pods;
  - a crash mid-flush of the deferred binds, which keeps the tail;
  - the process-death points (kill.*): the instance latches dead and drains
    nothing.  Nothing restarts it in the port (ROADMAP A14), so a case
    holds the state a restart would find.
"""

import contextlib
import random

import pytest

from helpers import mk_node, mk_pod
from torch_scheduler_sides import Side, both, observe
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

pytest.importorskip("jax")

NO_GANGS = (("GangScheduling", False),)
# branch -> (feature gates, KTPU_PIPELINE)
BRANCHES = {"gang": ((), "1"), "routed": (NO_GANGS, "1"), "routed-serial": (NO_GANGS, "0")}


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    sides = (Side("jax"), Side("port"))
    for x in sides:
        x.chaos.uninstall()
    yield
    for x in sides:
        x.chaos.uninstall()


def fault_ledger(sched) -> dict:
    m = sched.metrics
    got = {name: sorted(m.labeled_counter_series(name).items())
           for name in ("framework_fault_injected_total", "framework_fault_recovery_total")}
    got["scheduling_wave_recoveries_total"] = m.counters.get("scheduling_wave_recoveries_total", 0)
    return got


def cluster(x, branch, monkeypatch, nodes):
    gates, pipeline = BRANCHES[branch]
    monkeypatch.setenv("KTPU_PIPELINE", pipeline)
    return x.cluster(nodes=nodes, config=x.cfg("tpu", feature_gates=gates))


def churn(x, branch, spec, monkeypatch):
    """test_chaos.py's churn workload: 20 pods, then two rounds that delete
    6 bound pods and add their replacements, each round to idle."""
    plan = x.chaos.FaultPlan.parse(spec) if spec else None
    with x.chaos.chaos_plan(plan) if plan else contextlib.nullcontext():
        store, sched = cluster(x, branch, monkeypatch, [mk_node(f"n{i}", cpu=3000, pods=16) for i in range(5)])
        for i in range(20):
            store.add_pod(mk_pod(f"p{i}", cpu=250))
        sched.run_until_idle()
        rng = random.Random(5)
        for r in range(2):
            bound = sorted((p for p in store.pods.values() if p.node_name), key=lambda p: p.uid)
            for v in rng.sample(bound, 6):
                store.delete_pod(v.uid)
                store.add_pod(mk_pod(f"{v.name}-r{r}", cpu=250))
            sched.run_until_idle()
    return observe(store, sched), fault_ledger(sched)


@pytest.mark.parametrize("branch", list(BRANCHES))
@pytest.mark.parametrize("spec", ["scheduler.step:error@1", "scheduler.step:nan@0", "host.stall:stall@0+3:0.005"])
def test_wave_fault_recovery_matches_jax(spec, branch, monkeypatch):
    (want, want_ledger), (got, ledger) = both(churn, branch, spec, monkeypatch)
    assert got == want and ledger == want_ledger
    clean, _ = churn(Side("port"), branch, None, monkeypatch)
    assert got["pods"] == clean["pods"] and all(node for _, node, _ in got["pods"])
    if spec.startswith("scheduler.step"):
        assert ledger["scheduling_wave_recoveries_total"] >= 1
        assert dict(ledger["framework_fault_recovery_total"])


def failing_store(sched, fail_at: int):
    """Make the store's bind raise on its fail_at-th call; returns the
    original bind."""
    orig = sched.store.bind
    calls = {"n": 0}

    def bad_bind(uid, node):
        calls["n"] += 1
        if calls["n"] == fail_at:
            raise RuntimeError("apiserver down")
        return orig(uid, node)

    sched.store.bind = bad_bind
    return orig


def commit_crash(x, branch, fail_at, monkeypatch):
    """A bind that raises part way through the commit: the published prefix
    stays bound, no assumption leaks, the failed pod and the tail go back
    to the activeQ once each, and a later drain binds them."""
    store, sched = cluster(x, branch, monkeypatch, [mk_node("n0", cpu=8000, pods=64)])
    for i in range(6):
        store.add_pod(mk_pod(f"p{i}", cpu=100))
    orig = failing_store(sched, fail_at)
    with pytest.raises(RuntimeError, match="apiserver down"):
        sched.schedule_batch()
    seen = [observe(store, sched), sorted(sched.cache.assumed), len(sched.queue),
            [p.name for p, _ in sched._deferred_binds], fault_ledger(sched)]
    assert seen[1] == [] and seen[3] == [] and seen[2] == 6 - (fail_at - 1)
    sched.store.bind = orig
    sched.run_until_idle()
    seen.append(observe(store, sched))
    assert all(p.node_name == "n0" for p in store.pods.values())
    return seen


@pytest.mark.parametrize("branch", ["gang", "routed"])
@pytest.mark.parametrize("fail_at", [1, 3])
def test_commit_crash_matches_jax(branch, fail_at, monkeypatch):
    want, got = both(commit_crash, branch, fail_at, monkeypatch)
    assert got == want


def flush_crash(x, monkeypatch):
    """A bind that raises mid-flush of the deferred binds keeps the failed
    bind and the tail deferred, their assumptions held, for the next
    flush."""
    store, sched = cluster(x, "routed", monkeypatch, [mk_node("n0", cpu=8000, pods=64)])
    for i in range(3):
        store.add_pod(mk_pod(f"d{i}", cpu=100))
    pods = sorted(sched.store.pods.values(), key=lambda p: p.name)
    for p in pods:
        sched.cache.assume(p.uid, "n0")
        sched._deferred_binds.append((p, "n0"))
    orig = failing_store(sched, 2)
    with pytest.raises(RuntimeError, match="apiserver down"):
        sched._flush_deferred_binds()
    seen = [observe(store, sched), [p.name for p, _ in sched._deferred_binds],
            sorted(sched.cache.assumed) == sorted(p.uid for p in pods[1:])]
    assert seen[1:] == [["d1", "d2"], True]
    sched.store.bind = orig
    sched._flush_deferred_binds()
    seen.append(observe(store, sched))
    assert sched._deferred_binds == [] and all(p.node_name == "n0" for p in store.pods.values())
    return seen


def test_deferred_flush_crash_matches_jax(monkeypatch):
    want, got = both(flush_crash, monkeypatch)
    assert got == want


def killed_run(x, site, at, branch, monkeypatch):
    """A kill.* fault ends the instance where the plan says: ProcessKilled
    unwinds past every recovery, the instance and the module latch dead,
    and a later drain publishes nothing."""
    with x.chaos.chaos_plan(x.chaos.FaultPlan.single(site, "kill", at=at)):
        store, sched = cluster(x, branch, monkeypatch, [mk_node(f"n{i}", cpu=3000, pods=16) for i in range(3)])
        for i in range(12):
            store.add_pod(mk_pod(f"p{i}", cpu=250))
        with pytest.raises(x.chaos.ProcessKilled):
            sched.run_until_idle()
        latched = (sched._dead, x.chaos.killed())
        sched.wait_for_bindings()
        return [observe(store, sched), fault_ledger(sched), latched, sorted(sched.cache.assumed),
                [p.name for p, _ in sched._deferred_binds]]


@pytest.mark.parametrize("site,at,branch", [
    ("kill.mid_step", 0, "gang"),
    ("kill.mid_step", 0, "routed"),
    ("kill.post_assume", 3, "gang"),
    ("kill.post_checkpoint", 3, "routed"),
    ("kill.mid_flush", 2, "routed"),
])
def test_kill_point_matches_jax(site, at, branch, monkeypatch):
    want, got = both(killed_run, site, at, branch, monkeypatch)
    assert got == want
    assert got[2] == (True, True) and dict(got[1]["framework_fault_injected_total"])
