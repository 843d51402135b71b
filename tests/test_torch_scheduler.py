"""The port's Scheduler (kubernetes_tpu_torch/scheduler/) against the JAX
package's, on the CPU.

Every case runs twice, once per package (tests/torch_scheduler_sides.py):
the same JAX-built nodes and pods load into a JAX ClusterStore + Scheduler
and, carried across by convert.from_jax_objects, into the port's
(mode="tpu" with device="cpu": the batch cycle on the kernels' plain
versions; mode="cpu": the per-pod plugin cycle).  Both run the same script
(run_until_idle, schedule_batch, FakeClock steps, store events) and the
returns are held equal, exactly: the store's bindings and nominations, the
events with their messages, the queue's pools, the counters.  On the CPU
the port's batch cycle takes the class-state routes where the JAX package
runs its per-pod scan; decisions are the same on every route, so nothing
here reads a commit ordinal.

The cases are the scheduler-level ones of the JAX package's
test_scheduler_runtime.py (all 19), test_profiles.py (all 7),
test_nomination.py (all 6) and test_gang_fallback.py (all 3: the
per-pod cycle's Permit-wait, and the batch cycle's sidecar offload falling
back to it when nothing listens at the sidecar's address on the loopback);
one more runs a batch cycle on a node mesh of
two CPU shards (KTPU_MESH=2) against the JAX Scheduler on one device (the
JAX package's own sharded entry points fail on this JAX, ROADMAP C3).  The
refusals: mode="tpu" without a card and without device=; a checkpoint
directory (argument or KTPU_CHECKPOINT_DIR), the restart protocol's entry
points and an HTTP extender (ROADMAP A14).  mode="native" runs: its cases
are in tests/test_torch_native.py.

The batched preemption, explain and failure-path cases are in
tests/test_torch_scheduler_preempt.py.
"""

import copy
import json
import random

import pytest
import torch

from helpers import GI, MILLI, mk_node, mk_pod, random_cluster
from torch_scheduler_sides import Side, both, observe
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

pytest.importorskip("jax")
from kubernetes_tpu.api import types as t  # noqa: E402


def bound_map(store):
    return {p.name: (p.node_name or None) for p in store.pods.values()}


# ---------------------------------------------------------------------------
# test_scheduler_runtime.py
# ---------------------------------------------------------------------------

def end_to_end_bind(x, mode):
    store, sched = x.cluster(mode, nodes=[mk_node("n0"), mk_node("n1")])
    store.add_pod(mk_pod("p0"))
    store.add_pod(mk_pod("p1"))
    sched.run_until_idle()
    got = bound_map(store)
    assert got["p0"] and got["p1"] and len(sched.events.by_reason("Scheduled")) == 2
    return observe(store, sched)


def decision_parity(x, mode):
    snap = random_cluster(random.Random(321), n_nodes=12, n_pods=30, with_taints=True, with_selectors=True,
                          with_pairwise=True)
    store, sched = x.cluster(mode, nodes=[copy.deepcopy(nd) for nd in snap.nodes])
    for p in snap.pending_pods:
        store.add_pod(p)
    sched.run_until_idle()
    return observe(store, sched)


def preemption_evicts_lower_priority(x, mode):
    clock = x.FakeClock()
    store, sched = x.cluster(mode, nodes=[mk_node("only", cpu=1000)], clock=clock)
    store.add_pod(mk_pod("victim", cpu=800, priority=0))
    sched.run_until_idle()
    seen = [observe(store, sched)]
    store.add_pod(mk_pod("vip", cpu=800, priority=100))
    sched.run_until_idle()
    assert len(sched.events.by_reason("Preempted")) == 1 and "victim" not in bound_map(store)
    seen.append(observe(store, sched))
    clock.step(2.0)
    sched.run_until_idle()
    assert bound_map(store)["vip"] == "only"
    return seen + [observe(store, sched)]


def gated_pod_waits_for_update(x):
    store, sched = x.cluster("tpu", nodes=[mk_node("n0")])
    store.add_pod(mk_pod("gated", scheduling_gates=("wait",)))
    sched.run_until_idle()
    assert bound_map(store)["gated"] is None
    seen = [observe(store, sched)]
    store.update_pod(mk_pod("gated"))
    sched.run_until_idle()
    assert bound_map(store)["gated"] == "n0"
    return seen + [observe(store, sched)]


def unschedulable_wakes_on_node_add(x):
    clock = x.FakeClock()
    store, sched = x.cluster("tpu", nodes=[mk_node("small", cpu=100)], clock=clock)
    store.add_pod(mk_pod("big", cpu=4000))
    sched.run_until_idle()
    seen = [observe(store, sched)]
    store.add_node(mk_node("large", cpu=8000))
    clock.step(3.0)
    sched.run_until_idle()
    assert bound_map(store)["big"] == "large"
    return seen + [observe(store, sched)]


def backoff_is_exponential_and_capped(x):
    clock = x.FakeClock()
    store, sched = x.cluster("tpu", clock=clock)  # no nodes: always fails
    store.add_pod(mk_pod("p", cpu=100))
    sched.run_until_idle()
    durations = [sched.queue.backoff_duration("default/p")]
    for _ in range(6):
        clock.step(60)
        sched.run_until_idle()
        durations.append(sched.queue.backoff_duration("default/p"))
    assert durations[0] == 1.0 and durations[-1] == 10.0
    return durations, observe(store, sched)


def config_yaml_roundtrip_and_validation(x):
    pytest.importorskip("yaml")
    cfg = x.config.from_yaml("""
profiles:
  - schedulerName: default-scheduler
    percentageOfNodesToScore: 100
    plugins:
      - {name: TaintToleration, weight: 3}
      - {name: PodTopologySpread, weight: 2}
      - {name: InterPodAffinity, enabled: false}
    tpuScore: {sidecarAddress: local, deadlineMs: 500}
mode: tpu
parallelism: 16
""")
    sc = cfg.score_config()
    assert cfg.profile().tpu_score.deadline_ms == 500 and sc.interpod_weight == 0.0 and sc.taint_weight == 3.0
    assert x.config.validate(cfg) == []
    with pytest.raises(ValueError) as e:
        x.config.from_yaml("mode: gpu")
    return repr(cfg), repr(sc), str(e.value)


def disabled_plugin_changes_decisions(x):
    taint = (t.Taint(key="soft", effect=t.PREFER_NO_SCHEDULE),)
    prof = x.Profile(plugins=(x.PluginSpec(name="TaintToleration", enabled=False),))
    store, sched = x.cluster(nodes=[mk_node("soft-tainted", taints=taint), mk_node("clean")],
                             config=x.cfg("tpu", profiles=(prof,)))
    store.add_pod(mk_pod("p"))
    sched.run_until_idle()
    assert bound_map(store)["p"] == "soft-tainted"  # both tie without the taint score
    return observe(store, sched)


def feature_gate_validation(x):
    errors = []
    for gates in ((("NoSuchGate", True),), (("DefaultPreemption", False),)):
        with pytest.raises(ValueError) as e:
            x.features.FeatureGates(gates)
        errors.append(str(e.value))
    return errors, x.features.FeatureGates((("GangScheduling", False),)).enabled("GangScheduling")


def metrics_and_events_populate(x):
    store, sched = x.cluster("tpu", nodes=[mk_node("n0")])
    store.add_pod(mk_pod("p"))
    sched.run_until_idle()
    assert sched.metrics.counters["scheduling_attempts_scheduled"] == 1
    assert sched.metrics.hists["batch_scheduling_duration_seconds"].count
    return sched.events.by_reason("Scheduled")[0].node, observe(store, sched)


def fit_failure_parks_until_node_event(x):
    clock = x.FakeClock()
    store, sched = x.cluster("cpu", nodes=[mk_node("small", cpu=500)], clock=clock)
    store.add_pod(mk_pod("big", cpu=2000))
    sched.run_until_idle(5)
    assert "default/big" in sched.queue._unschedulable  # parked, not backoff
    seen = [observe(store, sched)]
    sched.queue.move_all_to_active_or_backoff(x.queue_mod.EV_POD_ADD)
    clock.step(30.0)
    assert sched.queue.pop() is None
    store.add_node(mk_node("roomy", cpu=4000))
    clock.step(30.0)
    sched.run_until_idle()
    assert bound_map(store)["big"] == "roomy"
    return seen + [observe(store, sched)]


def parked_pod_flushes_after_leftover_timeout(x):
    clock = x.FakeClock()
    store, sched = x.cluster("cpu", nodes=[mk_node("small", cpu=500)], clock=clock)
    store.add_pod(mk_pod("big", cpu=2000))
    sched.run_until_idle(5)
    assert "default/big" in sched.queue._unschedulable
    clock.step(301.0)
    first = sched.queue.pop()
    clock.step(30.0)
    pod = sched.queue.pop()
    assert first is None and pod is not None and pod.name == "big"
    return observe(store, sched)


def drains_past_100_cycles(x):
    store, sched = x.cluster("cpu", nodes=[mk_node("n0", cpu=200 * MILLI, mem=64 * GI, pods=200)])
    for i in range(150):
        store.add_pod(mk_pod(f"p{i}", cpu=10, mem=1024**2))
    sched.run_until_idle()
    assert sum(1 for v in bound_map(store).values() if v == "n0") == 150 and sched.queue.pending_total == 0
    return observe(store, sched)


def _ping_pong(sched):
    orig = sched.queue.add_unschedulable

    def ping_pong(pod, events=None, backoff=True, cycle_move_seq=None, **kw):
        orig(pod, events, backoff, cycle_move_seq, **kw)
        sched.queue.add(pod)  # a pathological event source re-activates it

    sched.queue.add_unschedulable = ping_pong


def raises_on_livelock(x, mode):
    store, sched = x.cluster(mode, nodes=[mk_node("n0", pods=0)])
    store.add_pod(mk_pod("p"))
    _ping_pong(sched)
    with pytest.raises(RuntimeError, match="no scheduling progress") as e:
        sched.run_until_idle(stall_limit=50 if mode == "cpu" else 10)
    return str(e.value), observe(store, sched)


def drains_large_unschedulable_backlog(x):
    store, sched = x.cluster("cpu", nodes=[mk_node("n0", pods=0)])
    for i in range(60):
        store.add_pod(mk_pod(f"u{i}"))
    sched.run_until_idle(stall_limit=10)
    assert len(sched.queue) == 0 and all(v is None for v in bound_map(store).values())
    return observe(store, sched)


def irrelevant_node_update_does_not_wake_fit_rejected(x):
    clock = x.FakeClock()
    store, sched = x.cluster("cpu", nodes=[mk_node("small", cpu=500)], clock=clock)
    store.add_pod(mk_pod("big", cpu=2000))
    sched.run_until_idle(5)
    store.update_node(mk_node("small", cpu=500, labels={"team": "a"}))
    assert "default/big" in sched.queue._unschedulable
    clock.step(30.0)
    assert sched.queue.pop() is None
    seen = [observe(store, sched)]
    store.update_node(mk_node("small", cpu=4000, labels={"team": "a"}))
    assert "default/big" not in sched.queue._unschedulable
    clock.step(30.0)
    sched.run_until_idle()
    assert bound_map(store)["big"] == "small"
    return seen + [observe(store, sched)]


def irrelevant_assigned_pod_does_not_wake_spread_rejected(x):
    clock = x.FakeClock()
    z0 = [mk_node(f"z0-{i}", labels={t.LABEL_ZONE: "z0"}) for i in range(2)]
    tainted = mk_node("z1-0", labels={t.LABEL_ZONE: "z1"},
                      taints=(t.Taint(key="dedic", value="x", effect=t.NO_SCHEDULE),))
    store, sched = x.cluster("cpu", nodes=[*z0, tainted], clock=clock)
    for i in range(3):
        store.add_pod(mk_pod(f"web-{i}", labels={"app": "web"}, node_name=f"z0-{i % 2}"))
    spread = (t.TopologySpreadConstraint(max_skew=1, topology_key=t.LABEL_ZONE,
                                         when_unsatisfiable=t.DO_NOT_SCHEDULE,
                                         label_selector=t.LabelSelector.of(app="web")),)
    store.add_pod(mk_pod("w", labels={"app": "web"}, topology_spread=spread))
    sched.run_until_idle(8)
    assert bound_map(store)["w"] is None and "default/w" in sched.queue._unschedulable
    seen = [observe(store, sched)]
    store.add_pod(mk_pod("db-0", labels={"app": "db"}, node_name="z0-0"))
    assert "default/w" in sched.queue._unschedulable
    store.add_pod(mk_pod("web-new", labels={"app": "web"}, node_name="z0-1"))
    assert "default/w" not in sched.queue._unschedulable
    return seen + [observe(store, sched)]


def queueing_hints_never_change_outcomes(x, seed):
    rng_master = random.Random(900 + seed)
    script = []
    for step in range(12):
        r = rng_master.random()
        if r < 0.5:
            script.append(("pod", f"p{step}", rng_master.choice([200, 1500, 4500]), rng_master.choice(["web", "db"])))
        elif r < 0.7:
            script.append(("node", f"extra{step}", rng_master.choice([2000, 6000])))
        elif r < 0.85:
            script.append(("grow", rng_master.choice([0, 1]), rng_master.choice([4000, 8000])))
        else:
            script.append(("label", rng_master.choice([0, 1]), f"v{step}"))

    def run(hints_enabled: bool):
        clock = x.FakeClock()
        store, sched = x.cluster("cpu", nodes=[mk_node("n0", cpu=2000), mk_node("n1", cpu=500)], clock=clock)
        if not hints_enabled:
            sched.framework.hints_for_plugins = lambda names: {}
        for ev in script:
            if ev[0] == "pod":
                store.add_pod(mk_pod(ev[1], cpu=ev[2], labels={"app": ev[3]}))
            elif ev[0] == "node":
                store.add_node(mk_node(ev[1], cpu=ev[2]))
            elif ev[0] == "grow":
                name = f"n{ev[1]}"
                grown = mk_node(name, cpu=ev[2])
                grown.labels.update(store.nodes[name].labels)
                store.update_node(grown)
            else:
                name = f"n{ev[1]}"
                nd = store.nodes[name]
                relabeled = mk_node(name, cpu=nd.allocatable[t.CPU])
                relabeled.labels = {**nd.labels, "team": ev[2]}
                store.update_node(relabeled)
            sched.run_until_idle(50)
            clock.step(2.0)
        for _ in range(6):
            clock.step(400.0)
            sched.run_until_idle(200)
        return bound_map(store), observe(store, sched)

    on, off = run(True), run(False)
    assert on[0] == off[0]
    return on, off


RUNTIME = {
    "end_to_end_bind[cpu]": lambda x: end_to_end_bind(x, "cpu"),
    "end_to_end_bind[tpu]": lambda x: end_to_end_bind(x, "tpu"),
    "cpu_tpu_decision_parity[cpu]": lambda x: decision_parity(x, "cpu"),
    "cpu_tpu_decision_parity[tpu]": lambda x: decision_parity(x, "tpu"),
    "preemption_evicts_lower_priority[cpu]": lambda x: preemption_evicts_lower_priority(x, "cpu"),
    "preemption_evicts_lower_priority[tpu]": lambda x: preemption_evicts_lower_priority(x, "tpu"),
    "gated_pod_waits_for_update": gated_pod_waits_for_update,
    "unschedulable_wakes_on_node_add": unschedulable_wakes_on_node_add,
    "backoff_is_exponential_and_capped": backoff_is_exponential_and_capped,
    "config_yaml_roundtrip_and_validation": config_yaml_roundtrip_and_validation,
    "disabled_plugin_changes_decisions": disabled_plugin_changes_decisions,
    "feature_gate_validation": feature_gate_validation,
    "metrics_and_events_populate": metrics_and_events_populate,
    "fit_failure_parks_until_node_event": fit_failure_parks_until_node_event,
    "parked_pod_flushes_after_leftover_timeout": parked_pod_flushes_after_leftover_timeout,
    "run_until_idle_drains_past_100_cycles": drains_past_100_cycles,
    "run_until_idle_raises_on_livelock": lambda x: raises_on_livelock(x, "cpu"),
    "run_until_idle_drains_large_unschedulable_backlog": drains_large_unschedulable_backlog,
    "run_until_idle_raises_on_tpu_mode_livelock": lambda x: raises_on_livelock(x, "tpu"),
    "irrelevant_node_update_does_not_wake_fit_rejected": irrelevant_node_update_does_not_wake_fit_rejected,
    "irrelevant_assigned_pod_does_not_wake_spread_rejected": irrelevant_assigned_pod_does_not_wake_spread_rejected,
    **{f"queueing_hints_never_change_outcomes[{s}]": (lambda x, s=s: queueing_hints_never_change_outcomes(x, s))
       for s in range(3)},
}


@pytest.mark.parametrize("case", list(RUNTIME))
def test_runtime_case_matches_jax(case):
    want, got = both(RUNTIME[case])
    assert got == want


# ---------------------------------------------------------------------------
# test_profiles.py
# ---------------------------------------------------------------------------

def _two_profile_cfg(x, mode):
    return x.cfg(mode, profiles=(
        x.Profile(),
        x.Profile(scheduler_name="busy-packer", plugins=(
            x.PluginSpec(name="NodeResourcesFit", enabled=False),
            x.PluginSpec(name="NodeResourcesBalancedAllocation", enabled=False))),
    ))


def pods_dispatch_to_their_profile(x, mode):
    store, sched = x.cluster(nodes=[mk_node("n0", cpu=4000), mk_node("n1", cpu=4000)],
                             config=_two_profile_cfg(x, mode))
    store.add_pod(mk_pod("filler", cpu=2000, node_name="n0"))
    store.add_pod(mk_pod("default-pod", cpu=500))
    store.add_pod(mk_pod("packer-pod", cpu=500, scheduler_name="busy-packer"))
    sched.run_until_idle()
    assert bound_map(store)["default-pod"] == "n1" and bound_map(store)["packer-pod"] == "n0"
    return observe(store, sched)


def unknown_scheduler_name_ignored(x, mode):
    store, sched = x.cluster(mode, nodes=[mk_node("n0", cpu=4000)])
    store.add_pod(mk_pod("ours", cpu=500))
    store.add_pod(mk_pod("theirs", cpu=500, scheduler_name="some-other-scheduler"))
    sched.run_until_idle()
    assert bound_map(store) == {"ours": "n0", "theirs": None}
    return observe(store, sched)


def disabled_plugin_keeps_its_filter(x, mode):
    store, sched = x.cluster(nodes=[mk_node("n0", cpu=1000)], config=x.cfg(mode, profiles=(
        x.Profile(plugins=(x.PluginSpec(name="NodeResourcesFit", enabled=False),)),)))
    store.add_pod(mk_pod("big", cpu=5000))
    sched.run_until_idle()
    assert bound_map(store)["big"] is None
    return observe(store, sched)


def mixed_profile_batch_schedules_in_one_cycle(x):
    store, sched = x.cluster(nodes=[mk_node("n0", cpu=64000, pods=200)], config=_two_profile_cfg(x, "tpu"))
    for i in range(6):
        store.add_pod(mk_pod(f"a{i}", cpu=100))
        store.add_pod(mk_pod(f"b{i}", cpu=100, scheduler_name="busy-packer"))
    first = sched.schedule_batch()
    assert len(first) == 12 and all(v == "n0" for v in first.values())
    sched.run_until_idle()
    assert all(v <= 1 for v in sched.queue._attempts.values())
    return first, observe(store, sched)


def custom_weight_profile_never_offloads_to_sidecar(x):
    cfg = x.cfg("tpu", profiles=(x.Profile(plugins=(x.PluginSpec(name="TaintToleration", weight=9.0),),
                                           tpu_score=x.TPUScoreArgs(sidecar_address="127.0.0.1:1")),))
    store, sched = x.cluster(nodes=[mk_node("n0", cpu=4000)], config=cfg)
    store.add_pod(mk_pod("p", cpu=500))
    sched.run_until_idle()
    assert bound_map(store)["p"] == "n0"
    return sched.metrics.counters.get("tpuscore_fallback_total", 0), observe(store, sched)


def batch_lead_profile_round_robins(x):
    store, sched = x.cluster(nodes=[mk_node("n0", cpu=64000, pods=500)], config=_two_profile_cfg(x, "tpu"))
    leads = []
    for wave in range(2):
        for i in range(4 * wave, 4 * wave + 4):
            store.add_pod(mk_pod(f"a{i}", cpu=100))
            store.add_pod(mk_pod(f"b{i}", cpu=100, scheduler_name="busy-packer"))
        sched.schedule_batch()
        leads.append(sched._last_profile_served)
    assert leads[0] != leads[1]
    sched.run_until_idle()
    return leads, observe(store, sched)


def cross_profile_gang_coalesces_to_one_program(x):
    store, sched = x.cluster(nodes=[mk_node("n0", cpu=64000, pods=200)], config=_two_profile_cfg(x, "tpu"))
    sched.cache.pod_groups["job"] = x.conv(t.PodGroup(name="job", min_member=4))
    for i in range(4):
        store.add_pod(mk_pod(f"g{i}", cpu=100, pod_group="job", labels={"job": "job"},
                             scheduler_name="busy-packer" if i % 2 else ""))
    res = sched.schedule_batch()
    assert len([v for v in res.values() if v]) == 4 and sched.events.by_reason("GangProfileCoalesced")
    return res, observe(store, sched)


PROFILES = {
    "pods_dispatch_to_their_profile[cpu]": lambda x: pods_dispatch_to_their_profile(x, "cpu"),
    "pods_dispatch_to_their_profile[tpu]": lambda x: pods_dispatch_to_their_profile(x, "tpu"),
    "unknown_scheduler_name_ignored[cpu]": lambda x: unknown_scheduler_name_ignored(x, "cpu"),
    "unknown_scheduler_name_ignored[tpu]": lambda x: unknown_scheduler_name_ignored(x, "tpu"),
    "disabled_plugin_keeps_its_filter[cpu]": lambda x: disabled_plugin_keeps_its_filter(x, "cpu"),
    "disabled_plugin_keeps_its_filter[tpu]": lambda x: disabled_plugin_keeps_its_filter(x, "tpu"),
    "mixed_profile_batch_schedules_in_one_cycle": mixed_profile_batch_schedules_in_one_cycle,
    "custom_weight_profile_never_offloads_to_sidecar": custom_weight_profile_never_offloads_to_sidecar,
    "batch_lead_profile_round_robins": batch_lead_profile_round_robins,
    "cross_profile_gang_coalesces_to_one_program": cross_profile_gang_coalesces_to_one_program,
}


@pytest.mark.parametrize("case", list(PROFILES))
def test_profile_case_matches_jax(case):
    want, got = both(PROFILES[case])
    assert got == want


# ---------------------------------------------------------------------------
# test_nomination.py and test_gang_fallback.py
# ---------------------------------------------------------------------------

def _preempt_setup(x, mode):
    clock = x.FakeClock()
    store, sched = x.cluster(mode, nodes=[mk_node("only", cpu=1000)], clock=clock)
    store.add_pod(mk_pod("victim", cpu=800, priority=0))
    sched.run_until_idle()
    store.add_pod(mk_pod("vip", cpu=800, priority=100))
    sched.run_until_idle()
    assert "default/victim" not in store.pods and sched.queue.nominated_pods_for_node("only")
    assert store.pods["default/vip"].nominated_node_name == "only"
    return clock, store, sched


def lower_priority_cannot_steal(x, mode):
    clock, store, sched = _preempt_setup(x, mode)
    store.add_pod(mk_pod("sneak", cpu=800, priority=0))
    sched.run_until_idle()
    seen = [observe(store, sched)]
    clock.step(2.0)
    sched.run_until_idle()
    assert bound_map(store)["vip"] == "only" and bound_map(store)["sneak"] is None
    assert not sched.queue.nominated_pods_for_node("only")
    return seen + [observe(store, sched)]


def higher_priority_ignores_nomination(x):
    clock, store, sched = _preempt_setup(x, "cpu")
    store.add_pod(mk_pod("super", cpu=800, priority=200))
    sched.run_until_idle()
    assert bound_map(store)["super"] == "only"
    return observe(store, sched)


def stale_nomination_cleared(x):
    clock, store, sched = _preempt_setup(x, "cpu")
    store.add_pod(mk_pod("super", cpu=800, priority=200))
    sched.run_until_idle()
    clock.step(2.0)
    sched.run_until_idle()
    assert not sched.queue.nominated_pods_for_node("only")
    store.add_pod(mk_pod("small", cpu=100, priority=0))
    sched.run_until_idle()
    assert bound_map(store)["small"] == "only"
    return observe(store, sched)


def preemption_respects_other_nomination(x):
    clock = x.FakeClock()
    store, sched = x.cluster("cpu", nodes=[mk_node("n0", cpu=1000)], clock=clock)
    store.add_pod(mk_pod("v1", cpu=200, priority=0))
    store.add_pod(mk_pod("filler", cpu=800, priority=0))
    sched.run_until_idle()
    store.add_pod(mk_pod("A", cpu=800, priority=100))
    sched.run_until_idle()
    store.add_pod(mk_pod("B", cpu=900, priority=50))
    sched.run_until_idle()
    assert "default/v1" in store.pods and store.pods["default/B"].nominated_node_name == ""
    seen = [observe(store, sched)]
    clock.step(2.0)
    sched.run_until_idle()
    assert bound_map(store)["A"] == "n0"
    return seen + [observe(store, sched)]


def nomination_cleared_on_pod_delete(x, mode):
    clock, store, sched = _preempt_setup(x, mode)
    store.delete_pod("default/vip")
    assert not sched.queue.nominated_pods_for_node("only")
    store.add_pod(mk_pod("sneak", cpu=800, priority=0))
    clock.step(2.0)
    sched.run_until_idle()
    assert bound_map(store)["sneak"] == "only"
    return observe(store, sched)


def deleted_pod_does_not_resurrect(x):
    clock = x.FakeClock()
    q = x.queue_mod.PriorityQueue(clock)
    old = x.conv(mk_pod("p", cpu=100))
    q.add(old)
    popped = q.pop() is old
    q.add_unschedulable(old, backoff=True)
    q.delete(old.uid)
    new = x.conv(mk_pod("p", cpu=200))
    q.add(new)
    again = q.pop() is new
    clock.step(60.0)
    assert popped and again and q.pop() is None
    return q.pending_total


def _gang_cluster(store):
    """2 nodes x 2000 cpu: "fits" (3 x 1000) can place, "toobig" (3 x 1500)
    at most 2 members, so it must bind none."""
    for i in range(2):
        store.add_node(mk_node(f"n{i}", cpu=2000, pods=10))
    for i in range(3):
        store.add_pod(mk_pod(f"fits-{i}", cpu=1000, pod_group="fits"))
    for i in range(3):
        store.add_pod(mk_pod(f"toobig-{i}", cpu=1500, pod_group="toobig"))


def cpu_mode_gang_atomicity(x):
    store, sched = x.cluster("cpu")
    sched.cache.pod_groups.update({g: x.conv(t.PodGroup(name=g, min_member=3)) for g in ("fits", "toobig")})
    _gang_cluster(store)
    sched.run_until_idle()
    got = {g: sum(1 for p in store.pods.values() if p.node_name and p.pod_group == g) for g in ("fits", "toobig")}
    assert got == {"fits": 3, "toobig": 0}
    return observe(store, sched)


def _dead_sidecar(x):
    return x.cfg("tpu", profiles=(x.Profile(tpu_score=x.TPUScoreArgs(sidecar_address="127.0.0.1:1",
                                                                      deadline_ms=150)),))


def sidecar_down_fallback(x):
    """The batch cycle's sidecar offload with nothing listening: the
    per-pod CPU fallback keeps the gangs all-or-nothing."""
    store, sched = x.cluster(config=_dead_sidecar(x))
    sched.cache.pod_groups.update({g: x.conv(t.PodGroup(name=g, min_member=3)) for g in ("fits", "toobig")})
    _gang_cluster(store)
    sched.run_until_idle()
    assert sched.metrics.counters["tpuscore_fallback_total"] >= 1
    return observe(store, sched)


def fallback_capacity_released(x):
    store, sched = x.cluster(nodes=[mk_node("n0", cpu=2000, pods=10)], config=_dead_sidecar(x))
    sched.cache.pod_groups.update({"g": x.conv(t.PodGroup(name="g", min_member=3))})
    for i in range(2):  # only 2 of 3 members exist
        store.add_pod(mk_pod(f"g-{i}", cpu=800, pod_group="g"))
    sched.run_until_idle()
    seen = [observe(store, sched)]
    store.add_pod(mk_pod("plain", cpu=1800))
    sched.run_until_idle()
    assert bound_map(store)["plain"] == "n0"
    return seen + [observe(store, sched)]


NOMINATION = {
    "lower_priority_pod_cannot_steal_nominated_capacity[cpu]": lambda x: lower_priority_cannot_steal(x, "cpu"),
    "lower_priority_pod_cannot_steal_nominated_capacity[tpu]": lambda x: lower_priority_cannot_steal(x, "tpu"),
    "higher_priority_pod_ignores_nomination_cpu": higher_priority_ignores_nomination,
    "stale_nomination_cleared_on_failed_retry_cpu": stale_nomination_cleared,
    "preemption_respects_other_pods_nomination_cpu": preemption_respects_other_nomination,
    "nomination_cleared_on_pod_delete[cpu]": lambda x: nomination_cleared_on_pod_delete(x, "cpu"),
    "nomination_cleared_on_pod_delete[tpu]": lambda x: nomination_cleared_on_pod_delete(x, "tpu"),
    "deleted_pod_does_not_resurrect_after_same_uid_readd": deleted_pod_does_not_resurrect,
    "cpu_mode_gang_atomicity": cpu_mode_gang_atomicity,
    "sidecar_down_fallback_preserves_gang_atomicity": sidecar_down_fallback,
    "fallback_gang_capacity_released_after_reject": fallback_capacity_released,
}


@pytest.mark.parametrize("case", list(NOMINATION))
def test_nomination_and_gang_case_matches_jax(case):
    want, got = both(NOMINATION[case])
    assert got == want


# ---------------------------------------------------------------------------
# the non-gang batch branch: dispatch, the deferred binds, finish
# ---------------------------------------------------------------------------

NO_GANGS = (("GangScheduling", False),)


def churn_deferred_commit(x, pipeline, monkeypatch):
    """test_pipeline_parity.py's churn workload with GangScheduling off, the
    one setting on which a batch cycle takes the routed non-gang branch and
    may defer its binds into the next cycle's device window (with it on,
    the default, every cycle takes the gang fixpoint, in both packages)."""
    monkeypatch.setenv("KTPU_PIPELINE", "1" if pipeline else "0")
    store, sched = x.cluster(nodes=[mk_node(f"n{i}", cpu=3000, pods=16) for i in range(6)],
                             config=x.cfg("tpu", feature_gates=NO_GANGS))
    for i in range(24):
        store.add_pod(mk_pod(f"p{i}", cpu=250))
    sched.run_until_idle()
    rng = random.Random(7)
    for r in range(3):
        bound = sorted((p for p in store.pods.values() if p.node_name), key=lambda p: p.uid)
        for v in rng.sample(bound, 8):
            store.delete_pod(v.uid)
            store.add_pod(mk_pod(f"{v.name}-r{r}", cpu=250))
        sched.run_until_idle()
    assert sched._deferred_binds == [] and all(p.node_name for p in store.pods.values())
    return observe(store, sched)


def parked_pod_turns_deferral_off(x):
    """A cycle defers its binds only while nothing is parked: the first
    cycle (nobody parked yet) defers and flushes before its failure loop;
    the second, with the failed pod in backoff, binds synchronously."""
    clock = x.FakeClock()
    store, sched = x.cluster(nodes=[mk_node("n0", cpu=2000)], clock=clock,
                             config=x.cfg("tpu", feature_gates=NO_GANGS))
    store.add_pod(mk_pod("big", cpu=5000))
    store.add_pod(mk_pod("a", cpu=500))
    sched.run_until_idle()
    seen = [observe(store, sched)]
    assert sched.queue.parked_total == 1 and seen[0]["deferred_flushes"] == 1
    store.add_pod(mk_pod("b", cpu=500))
    sched.run_until_idle()
    seen.append(observe(store, sched))
    assert seen[1]["deferred_flushes"] == 1 and bound_map(store)["b"] == "n0"
    return seen


@pytest.mark.parametrize("pipeline", [True, False])
def test_deferred_commit_churn_matches_jax(pipeline, monkeypatch):
    want, got = both(churn_deferred_commit, pipeline, monkeypatch)
    assert got == want
    assert (got["deferred_flushes"] > 0) == pipeline


def test_parked_pod_turns_deferral_off_as_in_jax():
    want, got = both(parked_pod_turns_deferral_off)
    assert got == want


def two_profile_overlap(x, pipeline_commit):
    """Two profiles in one cycle with GangScheduling off: the second
    profile's program is dispatched while the first one's binds are
    deferred, and its device window publishes them (the commit overlap;
    with one profile the deferred binds wait for run_until_idle's drain).
    With pipeline_commit off the cycle binds synchronously."""
    import importlib

    from kubernetes_tpu_torch.bench.harness import overlapped_binds

    col = importlib.import_module(x.S.__name__ + ".tracing").TraceCollector(enabled=True)
    store, sched = x.cluster(nodes=[mk_node(f"n{i}", cpu=3000, pods=16) for i in range(6)], collector=col,
                             config=x.cfg("tpu", feature_gates=NO_GANGS, pipeline_commit=pipeline_commit,
                                          profiles=(x.Profile(), x.Profile(scheduler_name="second"))))
    for i in range(24):
        store.add_pod(mk_pod(f"p{i}", cpu=250, scheduler_name="second" if i % 2 else ""))
    sched.run_until_idle()
    return observe(store, sched), overlapped_binds(col)


def test_two_profile_commit_overlap_matches_jax():
    (want, want_n), (got, n) = both(two_profile_overlap, True)
    assert got == want and n == want_n == 12
    sync, sync_n = two_profile_overlap(Side("port"), False)
    assert sync_n == 0 and sync["pods"] == got["pods"] and sync["events"] == got["events"]


def test_two_profile_overlap_matches_the_recorded_jax_digest():
    """The run chip_smoke.py holds on the card at heterogeneous(2000, 2000):
    the port on the CPU gives the JAX Scheduler's counts, overlapped binds
    and bindings digest (bench/workloads.py SCHEDULER_TWO_PROFILES_WANT,
    from tests/torch_north_star_digest.py's scheduler-two-profiles leg)."""
    from kubernetes_tpu_torch.bench import workloads as w
    from kubernetes_tpu_torch.bench.harness import overlapped_binds, run_snapshot_workload
    from kubernetes_tpu_torch.scheduler import Profile, SchedulerConfiguration
    from kubernetes_tpu_torch.scheduler.tracing import TraceCollector

    col = TraceCollector(capacity=1 << 16, enabled=True)
    cfg = SchedulerConfiguration(mode="tpu", feature_gates=NO_GANGS,
                                 profiles=(Profile(), Profile(scheduler_name=w.SECOND_PROFILE)))
    r = run_snapshot_workload("two-profiles", w.two_profile_split(w.heterogeneous(**w.SCHEDULER_TWO_PROFILES)),
                              "tpu", device="cpu", collector=col, config=cfg)
    got = dict(scheduled=r["scheduled"], unschedulable=r["unschedulable"], batches=r["batches"],
               overlapped=overlapped_binds(col), bindings=r["bindings_sha256"])
    assert got == w.SCHEDULER_TWO_PROFILES_WANT and col.spans_dropped == 0


# ---------------------------------------------------------------------------
# a node mesh, the refusals
# ---------------------------------------------------------------------------

def mesh_cluster(x):
    snap = random_cluster(random.Random(17), n_nodes=10, n_pods=40, with_taints=True, with_selectors=True)
    store, sched = x.cluster("tpu", nodes=snap.nodes)
    for p in snap.pending_pods:
        store.add_pod(p)
    sched.cache.pod_groups["g"] = x.conv(t.PodGroup(name="g", min_member=2))
    store.add_pod(mk_pod("g0", cpu=500, pod_group="g"))
    store.add_pod(mk_pod("g1", cpu=500, pod_group="g"))
    sched.run_until_idle()
    return sched.mesh, observe(store, sched)


def test_scheduler_on_a_node_mesh_matches_jax(monkeypatch):
    """KTPU_MESH=2: the port's batch cycle shards every step (and the gang
    fixpoint's) over two CPU shards; the JAX Scheduler runs on one device."""
    from kubernetes_tpu_torch.ops import assign

    (jmesh, want) = mesh_cluster(Side("jax"))
    monkeypatch.setenv("KTPU_MESH", "2")
    assign.reset_trace_counts()
    (mesh, got) = mesh_cluster(Side("port"))
    assert jmesh is None and mesh is not None and mesh.size == 2
    assert any(v for k, v in assign.TRACE_COUNTS.items() if k.startswith("sharded_")), assign.TRACE_COUNTS
    assert got == want


def test_refusals(tmp_path):
    """What the port still refuses (a card it does not have, HTTP
    extenders), and what it no longer refuses: a checkpoint dir arms the
    crash-restart checkpoint, and restore and the restart drivers run."""
    from kubernetes_tpu_torch.scheduler import scheduler as ts
    from kubernetes_tpu_torch.scheduler.extender import ExtenderConfig

    x = Side("port")
    store = x.S.ClusterStore()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            x.S.Scheduler(store, x.cfg("tpu"))
    armed = x.S.Scheduler(store, x.cfg("tpu"), device="cpu", checkpoint_dir=str(tmp_path / "ckpt"))
    assert armed._ckpt.directory == str(tmp_path / "ckpt") and armed._flight.directory == armed._ckpt.directory
    with pytest.raises(NotImplementedError, match="A14"):
        x.S.Scheduler(store, x.cfg("tpu", extenders=(ExtenderConfig(url_prefix="http://127.0.0.1:1"),)),
                      device="cpu")
    sched = x.S.Scheduler(store, x.cfg("cpu"))  # the per-pod cycle needs no card
    assert sched.device is None and sched.mesh is None
    assert sched.restore()["wal_applied"] == 0
    assert ts.run_restartable(sched)[1] == 0 and ts.run_ha_restartable(sched)[1] == 0
    again = ts.restart_scheduler(sched)
    assert again is not sched and sched._dead and again.metrics is sched.metrics
    assert sched.metrics.counters["scheduler_restarts_total"] == 2


def test_checkpoint_dir_env_is_refused(monkeypatch, tmp_path):
    """KTPU_CHECKPOINT_DIR is no longer refused: it arms the checkpoint as
    the JAX package's does, and both write the same document."""
    docs = []
    for x in (Side("jax"), Side("port")):
        monkeypatch.setenv("KTPU_CHECKPOINT_DIR", str(tmp_path / x.name))
        store, sched = x.cluster("tpu")
        store.add_pod(mk_pod("w0", cpu=100))
        sched._checkpoint_state()
        with open(tmp_path / x.name / "scheduler_state.json") as f:
            doc = json.load(f)["data"]
        docs.append({k: (sorted(v) if k in ("arrivals", "popped") else v) for k, v in doc.items()
                     if k not in ("saved_at", "saved_wall", "lineage")})
    assert docs[0] == docs[1] and docs[1]["arrivals"] == ["default/w0"]


def test_event_recorder_drop_accounting_matches_jax():
    """test_explain.py's token-bucket case: the refused publications are
    counted, the in-memory log stays complete."""
    def case(x):
        m = x.metrics_mod.Metrics()
        store = x.S.ClusterStore()
        rec = x.events_mod.EventRecorder(store=store, publish_qps=0.0, publish_burst=1, metrics=m)
        for i in range(3):
            rec.record("FailedScheduling", f"default/p{i}", message="m")
        return m.counters["events_publish_dropped_total"], len(rec.by_reason("FailedScheduling")), \
            sorted(store.objects["Event"])

    want, got = both(case)
    assert got == want and got[:2] == (2, 3)


def test_from_jax_objects_carries_a_cluster_store_state():
    """convert.from_jax_objects rebuilds what a ClusterStore holds (nodes,
    pods, PDBs, PVs, PVCs, StorageClasses, pod groups; in snapshots) as the
    port's types: the JAX package's Config4S and Config5 snapshots carried
    across equal the port's own generators', field for field, and a PDB
    keeps its selector."""
    from kubernetes_tpu.bench import workloads as jw
    from kubernetes_tpu_torch.api import types as tt
    from kubernetes_tpu_torch.bench import workloads as tw
    from kubernetes_tpu_torch.convert import from_jax_objects

    for jsnap, snap in ((jw.heterogeneous_storage(40, 60, seed=3), tw.heterogeneous_storage(40, 60, seed=3)),
                        (jw.gang(3, 4, 5, seed=1), tw.gang(3, 4, 5, seed=1))):
        got = from_jax_objects(jsnap)
        assert type(got) is type(snap) and got == snap
    pdb = from_jax_objects(t.PodDisruptionBudget(name="b", selector=t.LabelSelector.of(app="web"),
                                                 disruptions_allowed=1))
    assert isinstance(pdb, tt.PodDisruptionBudget) and pdb.matches(tt.Pod(name="p", labels={"app": "web"}))
