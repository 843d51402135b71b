"""The port's Scheduler against the JAX package's on its failure half, on
the CPU: preemption (batched and through the CPU PostFilter) and the
unschedulable diagnosis (KTPU_EXPLAIN).

As in tests/test_torch_scheduler.py, every case runs once per package
(tests/torch_scheduler_sides.py) and the returns are held equal, exactly:
bindings, nominations, events and their FailedScheduling messages, the
evicted victims, the queue's pools, the counters (preemption_victims and
pod_unschedulable_reasons_total{reason} among them).

The cases are the scheduler-level ones of the JAX package's
test_preemption_batched.py (batched preemption == the CPU evaluator, with
and without PDBs; anti-affinity preemptors falling back to the CPU
PostFilter; the batched branch really engaging; one device wave serving
several preemptors with the dirty nodes repaired) and test_explain.py
(decisions equal with the diagnosis on and off, on the JAX package's
default and forced-chunked routes; the device diagnosis' messages equal a
recount by the JAX host oracle; no messages with it off; the per-pod
cycle's per-plugin message), and the JAX preemption bench's cluster at
build(50, 12) through run_until_idle.
"""

import dataclasses
import random

import pytest

from helpers import mk_node, mk_pod
from torch_scheduler_sides import Side, both, observe
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

pytest.importorskip("jax")
from kubernetes_tpu.api import types as t  # noqa: E402


# ---------------------------------------------------------------------------
# test_preemption_batched.py
# ---------------------------------------------------------------------------

def preemption_run(x, seed: int, batched: bool, with_pdb: bool = False, pairwise: bool = False):
    """test_preemption_batched.py's _run: random victims, preemptors that
    exceed the free capacity -> (preempted, survivors, nominations,
    scheduled) and the whole observation."""
    rng = random.Random(seed)
    n_nodes = rng.randint(3, 6)
    gates = () if batched else (("BatchedPreemption", False),)
    store, sched = x.cluster(nodes=[mk_node(f"n{i}", cpu=2000, pods=8) for i in range(n_nodes)],
                             config=x.cfg("tpu", feature_gates=gates))
    for i in range(rng.randint(4, 10)):
        store.add_pod(mk_pod(f"low{i}", cpu=rng.choice([300, 500, 800]), priority=rng.choice([0, 5]),
                             node_name=f"n{rng.randrange(n_nodes)}", labels={"app": rng.choice(["web", "db"])}))
    if with_pdb:
        pdb = t.PodDisruptionBudget(name="web-pdb", selector=t.LabelSelector.of(app="web"),
                                    disruptions_allowed=rng.choice([0, 1]))
        store.pdbs[pdb.key] = x.conv(pdb)
    for i in range(rng.randint(2, 4)):
        kw = {}
        if pairwise:
            kw["affinity"] = t.Affinity(required_pod_anti_affinity=(t.PodAffinityTerm(
                topology_key=t.LABEL_HOSTNAME, label_selector=t.LabelSelector.of(app="hi")),))
        store.add_pod(mk_pod(f"hi{i}", cpu=1800, priority=100, labels={"app": "hi"}, **kw))
    sched.run_until_idle()
    summary = (sorted((e.pod, e.node) for e in sched.events.by_reason("Preempted")), sorted(store.pods),
               sorted((uid, node) for uid, (_, node) in sched.queue.nominated.items()),
               sorted((e.pod, e.node) for e in sched.events.by_reason("Scheduled")))
    return summary, observe(store, sched)


@pytest.mark.parametrize("pdb,seed", [(False, s) for s in range(8)] + [(True, s) for s in range(4)])
def test_batched_preemption_matches_cpu_evaluator_and_jax(pdb, seed):
    """The port's batched branch == the port's CPU evaluator
    (BatchedPreemption gated off) in preemptions, survivors, nominations and
    placements, and == the JAX Scheduler's batched branch in everything."""
    want, got = both(preemption_run, seed, True, with_pdb=pdb)
    assert got == want
    assert preemption_run(Side("port"), seed, False, with_pdb=pdb)[0] == got[0]


@pytest.mark.parametrize("seed", range(3))
def test_pairwise_preemptors_fall_back_and_match_jax(seed):
    """Anti-affinity preemptors are outside the batched gate: both
    settings of the gate take the CPU PostFilter, with the JAX outcome."""
    want, got = both(preemption_run, seed, True, pairwise=True)
    assert got == want
    assert preemption_run(Side("port"), seed, False, pairwise=True) == got


def engages(x):
    store, sched = x.cluster("tpu", nodes=[mk_node(f"n{i}", cpu=2000) for i in range(3)])
    for i in range(4):
        store.add_pod(mk_pod(f"low{i}", cpu=900, node_name=f"n{i % 3}"))
    store.add_pod(mk_pod("hi", cpu=1800, priority=50))
    sched.run_until_idle()
    assert sched.events.by_reason("Preempted") and sched.metrics.counters["preemption_victims"] > 0
    from_cache = sched.cache.update_snapshot()
    probe = x.conv(mk_pod("probe", cpu=1800, priority=50))
    from_cache.pending_pods.append(probe)
    arr, meta = sched._delta_enc.encode(from_cache)
    if x.name == "port":
        arr, meta = sched._delta_enc.to_device(arr, meta)
    bp = x.preemption.BatchedPreemption(arr, meta, from_cache, sched.store, sched.queue)
    return bp.applicable(probe), observe(store, sched)


def test_batched_preemption_actually_engages():
    """preemption_victims is bumped only by the batched branch: the device
    path ran, and the gate admits a plain preemptor."""
    want, got = both(engages)
    assert got == want and got[0]


def wave_path(x):
    instances = []
    orig = x.preemption.BatchedPreemption.__init__

    def spy(self, *a, **kw):
        orig(self, *a, **kw)
        instances.append(self)

    x.preemption.BatchedPreemption.__init__ = spy
    try:
        store, sched = x.cluster("tpu")
        for i in range(2):
            store.add_node(mk_node(f"n{i}", cpu=2000, pods=8))
            store.add_pod(mk_pod(f"low{i}", cpu=1800, node_name=f"n{i}"))
        for k in range(4):
            store.add_pod(mk_pod(f"hi{k}", cpu=1800, priority=50))
        sched.run_until_idle()
    finally:
        x.preemption.BatchedPreemption.__init__ = orig
    hits = (sum(b.wave_hits for b in instances), sum(b.single_hits for b in instances))
    assert len(sched.events.by_reason("Preempted")) == 2 and hits[0] >= 2 and hits[1] == 0
    return hits, observe(store, sched)


def test_wave_path_serves_multiple_preemptors_and_repairs_dirty_nodes():
    want, got = both(wave_path)
    assert got == want


def preempt_bench_cluster(x):
    """The JAX preemption bench's build(50, 12) through run_until_idle
    (the first run of its _parity_cross_check)."""
    from kubernetes_tpu.bench.preempt_bench import build

    store, sched = x.cluster("tpu")
    src = build(50, 12)
    for nd in src.nodes.values():
        store.add_node(nd)
    for p in src.pods.values():
        store.add_pod(p)
    sched.run_until_idle()
    return observe(store, sched)


def test_preempt_bench_cluster_matches_jax():
    want, got = both(preempt_bench_cluster)
    assert got == want
    assert got["counters"]["preemption_victims"] == 12


# ---------------------------------------------------------------------------
# test_explain.py
# ---------------------------------------------------------------------------

def _mixed_nodes():
    return [
        mk_node("n0", cpu=1000, labels={"zone": "a"}),
        mk_node("n1", cpu=1000, labels={"zone": "b"}, taints=(t.Taint(key="gpu", effect=t.NO_SCHEDULE),)),
        mk_node("n2", cpu=120, labels={"zone": "a"}),
        mk_node("n3", cpu=1000, unschedulable=True),
    ]


def _failing_pods():
    return [mk_pod("fit0", cpu=100), mk_pod("big0", cpu=5000),
            mk_pod("zoned0", cpu=50, node_selector={"zone": "nowhere"}),
            mk_pod("zoned1", cpu=50, node_selector={"zone": "nowhere"})]


def explain_run(x):
    store, sched = x.cluster("tpu", nodes=_mixed_nodes())
    for p in _failing_pods():
        store.add_pod(p)
    sched.run_until_idle()
    store.add_pod(mk_pod("late0", cpu=100))  # a warm delta after the first cycle
    store.add_pod(mk_pod("late-big", cpu=9000))
    sched.run_until_idle()
    return observe(store, sched)


@pytest.mark.parametrize("force_chunked", [None, "1"])
def test_decisions_bit_identical_explain_on_off(force_chunked, monkeypatch):
    """With KTPU_EXPLAIN=1 the placements are those of the explain-off run,
    in both packages (KTPU_FORCE_CHUNKED=1 moves the JAX package onto its
    chunked routes; the port takes its class-state routes either way), and
    every FailedScheduling carries the upstream-shaped message, the JAX
    one."""
    if force_chunked:
        monkeypatch.setenv("KTPU_FORCE_CHUNKED", force_chunked)
    monkeypatch.setenv("KTPU_EXPLAIN", "0")
    off_want, off_got = both(explain_run)
    monkeypatch.setenv("KTPU_EXPLAIN", "1")
    on_want, on_got = both(explain_run)
    assert off_got == off_want and on_got == on_want
    assert on_got["pods"] == off_got["pods"]
    fails = [e for e in on_got["events"] if e[0] == "FailedScheduling"]
    assert fails and all(e[3].startswith("0/4 nodes are available:") for e in fails)


def test_device_failure_events_match_host_oracle_recount(monkeypatch):
    """The port's diagnosis messages (K14's plain version over the failed
    classes at post-cycle usage) == the JAX Scheduler's == a recount by the
    JAX package's host oracle on a fresh encode of the post-cycle state."""
    from kubernetes_tpu.api.delta import DeltaEncoder
    from kubernetes_tpu.api.snapshot import Snapshot
    from kubernetes_tpu.ops import explain as ex

    monkeypatch.setenv("KTPU_EXPLAIN", "1")

    def case(x):
        store, sched = x.cluster("tpu", nodes=_mixed_nodes())
        for p in _failing_pods():
            store.add_pod(p)
        sched.run_until_idle()
        return observe(store, sched)

    want, got = both(case)
    assert got == want
    nodes, pods = _mixed_nodes(), {p.name: p for p in _failing_pods()}
    bound = [dataclasses.replace(pods[n], node_name=node) for n, node, _ in got["pods"] if node]
    failed = [pods[n] for n, node, _ in got["pods"] if not node]
    arr, meta = DeltaEncoder().encode(Snapshot(nodes=nodes, pending_pods=failed, bound_pods=bound))
    labels = ex.reason_labels(meta.resources)
    by_uid = {e[1]: e[3] for e in got["events"] if e[0] == "FailedScheduling"}
    for p in failed:
        counts = ex.explain_oracle(arr, [meta.pod_names.index(p.name)])[0]
        assert by_uid[p.uid] == ex.render_unschedulable(
            meta.n_nodes, {labels[j]: int(counts[j]) for j in range(len(labels))})
    assert sum(v for _, v in got["reasons"]) == len(failed)


def test_explain_off_keeps_device_events_silent(monkeypatch):
    monkeypatch.setenv("KTPU_EXPLAIN", "0")

    def case(x):
        store, sched = x.cluster("tpu", nodes=_mixed_nodes())
        store.add_pod(mk_pod("big", cpu=5000))
        sched.run_until_idle()
        return observe(store, sched)

    want, got = both(case)
    assert got == want
    assert [e[3] for e in got["events"] if e[0] == "FailedScheduling"] == [""] and got["reasons"] == []


def test_cpu_path_message_renders_per_plugin_breakdown():
    def case(x):
        store, sched = x.cluster("cpu", nodes=_mixed_nodes())
        store.add_pod(mk_pod("big", cpu=5000))
        sched.run_until_idle(max_cycles=2)
        return observe(store, sched)

    want, got = both(case)
    assert got == want
    msg = next(e[3] for e in got["events"] if e[0] == "FailedScheduling")
    assert msg.startswith("0/4 nodes are available:") and "Insufficient cpu" in msg
    assert sum(int(part.strip().split(" ", 1)[0]) for part in msg.split(":", 1)[1].rstrip(".").split(",")) == 4
