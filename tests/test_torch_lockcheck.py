"""The port's runtime lock-order checker (kubernetes_tpu_torch/analysis/
lockcheck.py, KTPU_LOCK_CHECK), held to the JAX package's.

Every CheckedLock case of the JAX package's tests/test_static_analysis.py
(:679-831) runs on both packages' checkers (``pkg``), and the seeded chaos
storm of :867 runs through each package's Scheduler in mode="tpu" (the
port's on the CPU) with every lock instrumented: no lock-order cycle, the
placements of the un-instrumented run, and the same observed order graph
in both packages.
"""

import copy
import importlib
import random
import threading

import pytest

from helpers import mk_node, mk_pod
from torch_scheduler_sides import Side
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

PACKAGES = {"jax": "kubernetes_tpu", "port": "kubernetes_tpu_torch"}


@pytest.fixture(params=sorted(PACKAGES))
def lc(request):
    mod = importlib.import_module(f"{PACKAGES[request.param]}.analysis.lockcheck")
    mod.reset()
    yield mod
    mod.reset()


def test_checkedlock_detects_inverted_order(lc):
    a, b = lc.CheckedLock("A"), lc.CheckedLock("B")
    with a:
        with b:
            pass
    with b:
        with a:  # closes the cycle: A->B observed, now B->A
            pass
    vs = lc.violations()
    assert len(vs) == 1
    assert "A" in vs[0].cycle and "B" in vs[0].cycle
    assert vs[0].witnesses
    with pytest.raises(lc.LockOrderViolation):
        lc.assert_clean()


def test_checkedlock_consistent_order_across_threads(lc):
    a, b = lc.CheckedLock("A"), lc.CheckedLock("B")

    def worker():
        with a:
            with b:
                pass

    ts = [threading.Thread(target=worker) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    with a:
        with b:
            pass
    assert lc.violations() == []
    assert ("A", "B") in lc.order_graph()
    lc.assert_clean()


def test_checkedlock_reentrant_hold_adds_no_edge(lc):
    a = lc.CheckedLock("A", reentrant=True)
    with a:
        with a:
            pass
    assert lc.order_graph() == {}
    lc.assert_clean()


def test_checkedlock_distinct_instances_of_one_name_flagged(lc):
    a, b = lc.CheckedLock("StreamingHist._lock"), lc.CheckedLock("StreamingHist._lock")
    with a:
        with b:
            pass
    vs = lc.violations()
    assert len(vs) == 1 and vs[0].cycle == ["StreamingHist._lock", "StreamingHist._lock"]
    assert "distinct instances" in vs[0].witnesses[0]


def test_checkedlock_records_violation_before_blocking(lc):
    a, b = lc.CheckedLock("A"), lc.CheckedLock("B")
    with a:
        with b:
            pass  # establishes A -> B
    a.acquire()  # main thread holds A

    def worker():
        b.acquire()
        got = a.acquire(timeout=0.2)  # blocks: main holds A
        if got:
            a.release()
        b.release()

    t = threading.Thread(target=worker, name="worker")
    t.start()
    t.join()
    a.release()
    vs = lc.violations()
    assert vs and set(vs[0].cycle) == {"A", "B"}


def test_checkedlock_cross_thread_release_purges_hold(lc):
    a, b = lc.CheckedLock("A"), lc.CheckedLock("B")
    a.acquire()
    t = threading.Thread(target=a.release)
    t.start()
    t.join()
    with b:
        pass  # must NOT record A -> B
    assert lc.order_graph() == {}
    lc.assert_clean()


def test_checkedlock_illegal_release_keeps_checker_state(lc):
    a, b = lc.CheckedLock("A", reentrant=True), lc.CheckedLock("B")
    a.acquire()
    err: list = []

    def bad_release():
        try:
            a.release()
        except RuntimeError as e:
            err.append(e)

    t = threading.Thread(target=bad_release)
    t.start()
    t.join()
    assert err
    with b:
        pass  # main still holds A: edge A -> B must be recorded
    a.release()
    assert ("A", "B") in lc.order_graph()
    lc.assert_clean()


def test_checkedlock_nonreentrant_self_reacquire_recorded(lc):
    c = lc.CheckedLock("C")
    c.acquire()
    assert not c.acquire(timeout=0.05)
    c.release()
    vs = lc.violations()
    assert vs and vs[0].cycle == ["C", "C"]


def test_make_lock_reads_env_at_construction(lc, monkeypatch):
    monkeypatch.delenv("KTPU_LOCK_CHECK", raising=False)
    assert not isinstance(lc.make_lock("x"), lc.CheckedLock)
    monkeypatch.setenv("KTPU_LOCK_CHECK", "1")
    lk = lc.make_lock("x")
    assert isinstance(lk, lc.CheckedLock) and not lk.reentrant
    rl = lc.make_rlock("y")
    assert isinstance(rl, lc.CheckedLock) and rl.reentrant
    monkeypatch.setenv("KTPU_LOCK_CHECK", "0")
    assert not isinstance(lc.make_lock("x"), lc.CheckedLock)


def test_lockcheck_report_shape(lc, monkeypatch):
    monkeypatch.delenv("KTPU_LOCK_CHECK", raising=False)
    a, b = lc.CheckedLock("A"), lc.CheckedLock("B")
    with a:
        with b:
            pass
    rep = lc.report()
    assert rep["edges"] == ["A -> B"] and rep["violations"] == [] and rep["enabled"] is False


def test_same_cases_same_reports():
    """One mixed sequence (an inversion, a same-name nesting, a reentrant
    hold) gives the same report in both packages."""
    reps = []
    for pkg in sorted(PACKAGES):
        lc = importlib.import_module(f"{PACKAGES[pkg]}.analysis.lockcheck")
        lc.reset()
        a, b, c = lc.CheckedLock("A"), lc.CheckedLock("B"), lc.CheckedLock("C", reentrant=True)
        h1, h2 = lc.CheckedLock("H"), lc.CheckedLock("H")
        with a, b, c, c:
            pass
        with c, b, a:
            pass
        with h1, h2:
            pass
        reps.append(lc.report())
        lc.reset()
    assert reps[0] == reps[1]
    assert len(reps[0]["violations"]) >= 2


# --- the storm: seeded chaos churn under KTPU_LOCK_CHECK=1, both packages ---

def _churn(side: Side, seed: int) -> dict:
    S = side.S
    store = S.ClusterStore()
    for i in range(5):
        store.add_node(side.conv(mk_node(f"n{i}", cpu=3000, pods=16)))
    sched = side.scheduler(store, side.cfg("tpu"))
    for i in range(20):
        store.add_pod(side.conv(mk_pod(f"p{i}", cpu=250)))
    sched.run_until_idle()
    rng = random.Random(seed)
    for r in range(2):
        bound = sorted((p for p in store.list_pods() if p.node_name), key=lambda p: p.uid)
        for v in rng.sample(bound, 6):
            store.delete_pod(v.uid)
            q = copy.copy(v)
            q.name = f"{v.name}-r{r}"
            q.uid = ""
            q.node_name = ""
            q.__post_init__()
            store.add_pod(q)
        sched.run_until_idle()
    return {p.name: p.node_name for p in store.list_pods()}


def _storm(side: Side, monkeypatch):
    lc = importlib.import_module(f"{PACKAGES[side.name]}.analysis.lockcheck")
    monkeypatch.delenv("KTPU_LOCK_CHECK", raising=False)
    oracle = _churn(side, 5)  # plain locks
    monkeypatch.setenv("KTPU_LOCK_CHECK", "1")
    lc.reset()
    plan = side.chaos.FaultPlan.from_seed(0, sites=("scheduler.step", "host.stall"), n_faults=4)
    try:
        with side.chaos.chaos_plan(plan):
            got = _churn(side, 5)
    finally:
        side.chaos.uninstall()
        monkeypatch.delenv("KTPU_LOCK_CHECK", raising=False)
    rep = lc.report()
    lc.reset()
    return oracle, got, rep


def test_chaos_storm_under_lock_check_is_cycle_free_as_in_jax(monkeypatch):
    """The port's storm (JAX tests/test_static_analysis.py:867) under
    KTPU_LOCK_CHECK=1: no lock-order cycle, the un-instrumented run's
    placements (the checker observes, never perturbs), the hot nesting
    observed, and the JAX storm's placements and order graph."""
    monkeypatch.setenv("KTPU_PIPELINE", "1")
    out = {name: _storm(Side(name), monkeypatch) for name in ("jax", "port")}
    oracle, got, rep = out["port"]
    assert got == oracle
    assert rep["violations"] == []
    assert "ClusterStore._lock -> Scheduler._move_lock" in rep["edges"]
    j_oracle, j_got, j_rep = out["jax"]
    assert j_rep["violations"] == [] and j_got == j_oracle
    assert got == j_got
    assert rep["edges"] == j_rep["edges"]
