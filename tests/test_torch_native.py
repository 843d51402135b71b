"""The port's native engine (kubernetes_tpu_torch/native/: static_np.py,
scheduler.cpp, __init__.py) against the JAX package's native engine and
the JAX oracle, on the CPU.

Each case encodes one snapshot twice: the JAX encoder's arrays feed the
JAX package's schedule_batch_native / schedule_with_gangs_native, the
port's DeltaEncoder(device="cpu").encode host arrays (the same objects
carried across by convert.from_jax_objects) feed the port's.  Choices and
final usage are held bit-equal, and the decoded placements equal the JAX
oracle's.  The cases: random_cluster seeds 0-5 at 17 x 43 and seeds 0-2 at
96 x 400 (the JAX test_native.py's shapes), the three fit strategies
(test_fit_strategies.py's random clusters, its non-round-tripping RTCR
shape at exact fit and its zero-capacity node), the preferred inter-pod
cases of test_interpod_pref.py, snapshots with image locality (the port
keeps image_score as bf16 bit patterns, which the engine must read as
their f32 values), and gangs.  Also: the engine refuses a tensor on the
card, and the strategy and spread-constraint refusals.

The Scheduler in mode="native" (tests/torch_scheduler_sides.py: every
case once per package) against the JAX Scheduler in mode="native":
bindings, events and messages, queue pools, counters; the ordinals and
sweeps of cycles without gangs; a gang case; failing cycles under
KTPU_EXPLAIN=1 with BatchedPreemption (the port places the cycle's arrays
only then); a bind deferred by an earlier cycle, published before the
engine runs; bench/harness.py in mode="native".

Tolerance: none (integer choices and usage).
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch import native
from kubernetes_tpu_torch.api.delta import DeltaEncoder
from kubernetes_tpu_torch.convert import from_jax_objects
from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, infer_score_config
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

jax = pytest.importorskip("jax")
from helpers import GI, mk_node, mk_pod, random_cluster  # noqa: E402
from kubernetes_tpu import native as jnative  # noqa: E402
from kubernetes_tpu.api import types as t  # noqa: E402
from kubernetes_tpu.api.snapshot import Snapshot, encode_snapshot  # noqa: E402
from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG as J_DEFAULT  # noqa: E402
from kubernetes_tpu.ops import infer_score_config as j_infer  # noqa: E402
from kubernetes_tpu.oracle import oracle_schedule  # noqa: E402
from kubernetes_tpu.oracle.reference import oracle_schedule_with_gangs  # noqa: E402

STRATEGIES = [
    ("LeastAllocated", ((0.0, 0.0), (100.0, 10.0))),
    ("MostAllocated", ((0.0, 0.0), (100.0, 10.0))),
    ("RequestedToCapacityRatio", ((0.0, 10.0), (50.0, 2.0), (100.0, 0.0))),
]


def run_both(snap, gang=False, oracle=True, hpaw=1.0, **cfg_kw):
    """(port choices, port used) after holding them to the JAX engine's and
    the decoded placements to the JAX oracle's."""
    jarr, jmeta = encode_snapshot(snap, hard_pod_affinity_weight=hpaw)
    jcfg = j_infer(jarr, dataclasses.replace(J_DEFAULT, hard_pod_affinity_weight=hpaw, **cfg_kw))
    host, meta = DeltaEncoder("cpu", hard_pod_affinity_weight=hpaw).encode(from_jax_objects(snap))
    cfg = infer_score_config(host, dataclasses.replace(DEFAULT_SCORE_CONFIG, hard_pod_affinity_weight=hpaw,
                                                       **cfg_kw))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jfn = jnative.schedule_with_gangs_native if gang else jnative.schedule_batch_native
    fn = native.schedule_with_gangs_native if gang else native.schedule_batch_native
    want, want_used = jfn(jarr, jcfg)
    got, used = fn(host, cfg)
    assert got.dtype == np.int32 and used.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(used, want_used)
    assert meta.pod_names == list(jmeta.pod_names) and meta.node_names == list(jmeta.node_names)
    if oracle:
        placed = [(meta.pod_names[k], meta.node_names[int(got[k])] if got[k] >= 0 else None)
                  for k in range(meta.n_pods)]
        ref = oracle_schedule_with_gangs(snap, jcfg) if gang else oracle_schedule(snap, jcfg)
        assert placed == ref
    return got, used


@pytest.mark.parametrize("seed", range(6))
def test_native_matches_jax_small(seed):
    snap = random_cluster(random.Random(4000 + seed), n_nodes=17, n_pods=43, with_taints=True,
                          with_selectors=True, with_pairwise=True)
    run_both(snap)


@pytest.mark.parametrize("seed", range(3))
def test_native_matches_jax_medium(seed):
    snap = random_cluster(random.Random(99 + seed), n_nodes=96, n_pods=400, with_taints=True,
                          with_selectors=True, with_pairwise=True)
    run_both(snap, oracle=False)


@pytest.mark.parametrize("strategy,shape", STRATEGIES)
def test_fit_strategies_match_jax(strategy, shape):
    snap = random_cluster(random.Random(1 + hash(strategy) % 1000), n_nodes=10, n_pods=30,
                          with_selectors=True)
    run_both(snap, fit_strategy=strategy, rtcr_shape=shape)


def test_rtcr_exact_fit_non_round_tripping_shape():
    """test_fit_strategies.py:93: util == 100 exactly, a shape whose segment
    formula does not round-trip to its last y in f32."""
    snap = Snapshot(nodes=[mk_node("n0", cpu=500, mem=512 * 1024**2), mk_node("n1", cpu=4000, mem=8 * GI)],
                    pending_pods=[mk_pod("exact", cpu=500, mem=512 * 1024**2)])
    run_both(snap, fit_strategy="RequestedToCapacityRatio", rtcr_shape=((0.0, 0.1), (100.0, 0.3)))


def test_rtcr_zero_capacity():
    """test_fit_strategies.py:121: capacity 0 scores as full utilization."""
    snap = Snapshot(nodes=[mk_node("n0", cpu=4000, mem=0), mk_node("n1", cpu=4000)],
                    pending_pods=[mk_pod("memless", cpu=100, mem=0)])
    got, _ = run_both(snap, fit_strategy="RequestedToCapacityRatio", rtcr_shape=((0.0, 10.0), (100.0, 0.0)))
    assert got[0] == 1


def _zone_nodes():
    return [mk_node("n-a", labels={t.LABEL_ZONE: "a"}), mk_node("n-b", labels={t.LABEL_ZONE: "b"})]


def _pref_aff(weight=50, anti=False, key=t.LABEL_ZONE, **sel):
    term = t.WeightedPodAffinityTerm(weight=weight, term=t.PodAffinityTerm(
        topology_key=key, label_selector=t.LabelSelector.of(**sel)))
    return t.Affinity(preferred_pod_affinity=() if anti else (term,),
                      preferred_pod_anti_affinity=(term,) if anti else ())


def _req_aff(**sel):
    return t.Affinity(required_pod_affinity=(t.PodAffinityTerm(
        topology_key=t.LABEL_ZONE, label_selector=t.LabelSelector.of(**sel)),))


def _interpod_cases():
    """test_interpod_pref.py's snapshots."""
    cases = {
        "pull": Snapshot(nodes=_zone_nodes(), pending_pods=[mk_pod("web", affinity=_pref_aff(app="db"))],
                         bound_pods=[mk_pod("db", labels={"app": "db"}, node_name="n-b")]),
        "push": Snapshot(nodes=_zone_nodes(),
                         pending_pods=[mk_pod("quiet", affinity=_pref_aff(anti=True, app="noisy"))],
                         bound_pods=[mk_pod("noisy", labels={"app": "noisy"}, node_name="n-a")]),
        "symmetric": Snapshot(nodes=_zone_nodes(), pending_pods=[mk_pod("web", labels={"app": "web"})],
                              bound_pods=[mk_pod("fan", node_name="n-b", affinity=_pref_aff(app="web"))]),
        "tradeoff": Snapshot(nodes=_zone_nodes(), pending_pods=[mk_pod("web", affinity=t.Affinity(
            preferred_pod_affinity=(
                t.WeightedPodAffinityTerm(weight=10, term=t.PodAffinityTerm(
                    topology_key=t.LABEL_ZONE, label_selector=t.LabelSelector.of(app="cache"))),
                t.WeightedPodAffinityTerm(weight=90, term=t.PodAffinityTerm(
                    topology_key=t.LABEL_ZONE, label_selector=t.LabelSelector.of(app="db"))),
            )))],
            bound_pods=[mk_pod("cache", labels={"app": "cache"}, node_name="n-a"),
                        mk_pod("db", labels={"app": "db"}, node_name="n-b")]),
        "committed": Snapshot(nodes=_zone_nodes(), pending_pods=[
            mk_pod("anchor", labels={"app": "db"}, node_name="n-b"),
            mk_pod("follower", affinity=_pref_aff(app="db"))]),
        "hard-weight": Snapshot(nodes=_zone_nodes(), pending_pods=[mk_pod("web", labels={"app": "web"})],
                                bound_pods=[mk_pod("requirer", labels={"app": "db"}, node_name="n-b",
                                                   affinity=_req_aff(app="web"))]),
        "hard-committed": Snapshot(nodes=_zone_nodes(), pending_pods=[
            mk_pod("requirer", labels={"app": "db"}, node_name="n-b", priority=10, affinity=_req_aff(app="web")),
            mk_pod("web", labels={"app": "web"})]),
    }
    for seed, required in ((7, False), (8, False), (21, True), (22, True)):
        rng = random.Random(seed)
        nodes = [mk_node(f"n{i}", labels={t.LABEL_ZONE: f"z{i % 3}"}) for i in range(6)]
        pods = []
        for i in range(24):
            app = rng.choice(["web", "db", "cache"])
            kw = {}
            r = rng.random()
            if r < 0.4:
                kw["affinity"] = _pref_aff(weight=rng.choice([10, 50, 100]), anti=rng.random() < 0.5,
                                           app=rng.choice(["web", "db", "cache"]))
            elif required and r < 0.55:
                kw["affinity"] = _req_aff(app=rng.choice(["web", "db"]))
            pods.append(mk_pod(f"p{i}", labels={"app": app}, cpu=rng.choice([100, 200]),
                               priority=rng.choice([0, 5]), **kw))
        cases[f"random-{seed}"] = Snapshot(nodes=nodes, pending_pods=pods)
    return cases


INTERPOD = _interpod_cases()


@pytest.mark.parametrize("name", sorted(INTERPOD))
def test_preferred_interpod_matches_jax(name):
    run_both(INTERPOD[name])


@pytest.mark.parametrize("hpaw", [0.0, 100.0])
def test_hard_pod_affinity_weight_matches_jax(hpaw):
    run_both(INTERPOD["hard-weight"], hpaw=hpaw)


def _image_cluster(seed: int):
    """Nodes caching images of random sizes (some below the 23 MB floor),
    busy to random degrees, and pods asking for one or two images: the
    image score competes with the fit and balance scores."""
    rng = random.Random(seed)
    images = [f"repo/img{i}:v1" for i in range(6)]
    nodes = []
    for i in range(12):
        nd = mk_node(f"node-{i}", cpu=rng.choice([2000, 4000, 8000]), mem=rng.choice([4, 8, 16]) * GI)
        for im in rng.sample(images, rng.randint(0, 3)):
            nd.images[im] = rng.choice([10, 100, 300, 800, 1200]) * 1024**2
        nodes.append(nd)
    bound = [mk_pod(f"b{i}", cpu=rng.choice([500, 1000, 1500]), node_name=f"node-{rng.randrange(12)}")
             for i in range(10)]
    pods = [mk_pod(f"p{i}", cpu=rng.choice([100, 250, 500]), images=tuple(rng.sample(images, rng.randint(1, 2))))
            for i in range(30)]
    return Snapshot(nodes=nodes, pending_pods=pods, bound_pods=bound)


@pytest.mark.parametrize("seed", range(3))
def test_image_locality_matches_jax(seed):
    snap = _image_cluster(seed)
    host, _ = DeltaEncoder("cpu").encode(from_jax_objects(snap))
    jarr, _ = encode_snapshot(snap)
    assert host.image_score.dtype == np.uint16 and host.image_score.shape == (host.P, host.N)
    # the engine reads the f32 values of the bf16 bits, the JAX arrays' values
    np.testing.assert_array_equal(native.host_arrays(host).image_score,
                                  np.asarray(jarr.image_score).astype(np.float32))
    assert native.host_arrays(host).image_score.max() <= 100.0
    run_both(snap)


def test_gang_matches_jax():
    """test_native.py's gang case: one group short of its quorum is revoked."""
    pods = [mk_pod(f"g-{i}", cpu=600, pod_group="job") for i in range(3)]
    pods += [mk_pod(f"s-{i}", cpu=400, pod_group="small") for i in range(2)]
    groups = {"job": t.PodGroup(name="job", min_member=3), "small": t.PodGroup(name="small", min_member=2)}
    snap = Snapshot(nodes=[mk_node("n0", cpu=1000), mk_node("n1", cpu=1000)], pending_pods=pods,
                    pod_groups=groups)
    got, _ = run_both(snap, gang=True)
    assert (got[:5] >= 0).sum() in (0, 2, 3)


@pytest.mark.parametrize("seed", range(3))
def test_random_gangs_match_jax(seed):
    rng = random.Random(600 + seed)
    snap = random_cluster(rng, n_nodes=8, n_pods=36, with_selectors=True)
    pods = []
    for i, p in enumerate(snap.pending_pods):
        g = i // 6
        if g % 2 == 0:
            p = dataclasses.replace(p, pod_group=f"gang-{g}", requests={t.CPU: rng.choice([500, 1500, 3000]),
                                                                        t.MEMORY: GI})
        pods.append(p)
    groups = {f"gang-{g}": t.PodGroup(name=f"gang-{g}", min_member=rng.choice([4, 6])) for g in range(0, 6, 2)}
    run_both(Snapshot(nodes=snap.nodes, pending_pods=pods, pod_groups=groups), gang=True)


def test_engine_reads_host_arrays_only():
    """Tensors on the CPU are read as host arrays; a tensor on another
    device is refused, never copied back."""
    snap = random_cluster(random.Random(4003), n_nodes=17, n_pods=43, with_taints=True,
                          with_selectors=True, with_pairwise=True)
    host, _ = DeltaEncoder("cpu").encode(from_jax_objects(snap))
    cfg = infer_score_config(host, DEFAULT_SCORE_CONFIG)
    placed, _ = DeltaEncoder("cpu").encode_device(from_jax_objects(snap))
    want = native.schedule_batch_native(host, cfg)
    got = native.schedule_batch_native(placed, cfg)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    meta_dev = dataclasses.replace(placed, node_alloc=placed.node_alloc.to("meta"))
    with pytest.raises(ValueError, match="host arrays"):
        native.schedule_batch_native(meta_dev, cfg)


def test_refusals():
    snap = random_cluster(random.Random(4001), n_nodes=5, n_pods=9)
    host, _ = DeltaEncoder("cpu").encode(from_jax_objects(snap))
    cfg = infer_score_config(host, DEFAULT_SCORE_CONFIG)
    with pytest.raises(ValueError, match="scoringStrategy"):
        native.schedule_batch_native(host, dataclasses.replace(cfg, fit_strategy="Sideways"))
    with pytest.raises(ValueError, match="at most 8 points"):
        native.schedule_batch_native(host, dataclasses.replace(
            cfg, fit_strategy="RequestedToCapacityRatio", rtcr_shape=tuple((float(i), 1.0) for i in range(9))))
    wide = dataclasses.replace(host, pod_spread_terms=np.full((host.P, 9), -1, dtype=np.int32))
    with pytest.raises(ValueError, match="at most 8 spread constraints"):
        native.schedule_batch_native(wide, cfg)


@pytest.mark.parametrize("seed", range(3))
def test_static_stage_matches_jax(seed):
    """static_np on the port's host arrays (bool label planes, bf16 bits)
    == the JAX package's static_np on its arrays, every output."""
    from kubernetes_tpu.native import static_np as jstatic
    from kubernetes_tpu_torch.native import static_np

    snap = random_cluster(random.Random(4000 + seed), n_nodes=17, n_pods=43, with_taints=True,
                          with_selectors=True, with_pairwise=True)
    host, _ = DeltaEncoder("cpu").encode(from_jax_objects(snap))
    assert host.node_labels.dtype == np.bool_ and host.sel_mask.dtype == np.bool_
    jarr, _ = encode_snapshot(snap)
    for a, b in zip(static_np.static_feasible(native.host_arrays(host)), jstatic.static_feasible(jarr)):
        np.testing.assert_array_equal(a, b)
    tm = static_np.static_feasible(host)[2]
    np.testing.assert_array_equal(static_np.taint_prefer_counts(host), jstatic.taint_prefer_counts(jarr))
    np.testing.assert_array_equal(static_np.preferred_na_raw(host, tm), jstatic.preferred_na_raw(jarr, tm))


# ---------------------------------------------------------------------------
# the Scheduler in mode="native", held to the JAX Scheduler in mode="native"
# (tests/torch_scheduler_sides.py: every case once per package; the port's
# batch cycle on the CPU, device="cpu")
# ---------------------------------------------------------------------------

import test_torch_scheduler as ts  # noqa: E402  (its mode-taking cases)
from torch_scheduler_sides import Side, both, observe  # noqa: E402

NO_GANGS = (("GangScheduling", False),)


def _spy_waves(sched):
    """(ordinals, sweeps) of every cycle the engine served without gangs."""
    seen = []
    orig = sched._observe_wave_latency

    def spy(ordinals, t_kernel, sweeps, uids=None):
        seen.append((np.asarray(ordinals).tolist(), int(sweeps)))
        return orig(ordinals, t_kernel, sweeps, uids=uids)

    sched._observe_wave_latency = spy
    return seen


def random_run(x, seed, gates=()):
    snap = random_cluster(random.Random(300 + seed), n_nodes=12, n_pods=40, with_taints=True,
                          with_selectors=True, with_pairwise=True)
    store, sched = x.cluster(config=x.cfg("native", feature_gates=gates), nodes=snap.nodes)
    waves = _spy_waves(sched)
    for p in snap.pending_pods:
        store.add_pod(p)
    sched.run_until_idle()
    return waves, observe(store, sched)


def gang_run(x):
    """Two gangs on two nodes, one short of room for its quorum (revoked in
    both packages), a loose pod beside them."""
    store, sched = x.cluster("native", nodes=[mk_node("n0", cpu=1000), mk_node("n1", cpu=1000)])
    sched.cache.pod_groups["job"] = x.conv(t.PodGroup(name="job", min_member=3))
    sched.cache.pod_groups["small"] = x.conv(t.PodGroup(name="small", min_member=2))
    for i in range(3):
        store.add_pod(mk_pod(f"g-{i}", cpu=600, pod_group="job"))
    for i in range(2):
        store.add_pod(mk_pod(f"s-{i}", cpu=400, pod_group="small"))
    store.add_pod(mk_pod("loose", cpu=300))
    sched.run_until_idle()
    return observe(store, sched)


def failing_run(x, seed):
    """A failing cycle: preemptors beyond the free capacity over
    lower-priority bound pods; under KTPU_EXPLAIN=1 the diagnosis and
    BatchedPreemption read the cycle's arrays, placed for them."""
    rng = random.Random(seed)
    n_nodes = rng.randint(3, 6)
    store, sched = x.cluster(config=x.cfg("native"),
                             nodes=[mk_node(f"n{i}", cpu=2000, pods=8) for i in range(n_nodes)])
    for i in range(rng.randint(4, 10)):
        store.add_pod(mk_pod(f"low{i}", cpu=rng.choice([300, 500, 800]), priority=rng.choice([0, 5]),
                             node_name=f"n{rng.randrange(n_nodes)}", labels={"app": rng.choice(["web", "db"])}))
    for i in range(rng.randint(2, 4)):
        store.add_pod(mk_pod(f"hi{i}", cpu=1800, priority=100))
    store.add_pod(mk_pod("huge", cpu=9000, priority=100))
    sched.run_until_idle()
    return observe(store, sched)


def deferred_then_native(x, calls):
    """A bind deferred by an earlier cycle is published before the engine
    runs: at the engine's call the deferred list is empty and the pod is
    bound in the store."""
    store, sched = x.cluster("native", nodes=[mk_node("n0"), mk_node("n1")])
    store.add_pod(mk_pod("early"))
    pod = sched.queue.pop()
    sched.cache.assume(pod.uid, "n1")
    sched._deferred_binds.append((pod, "n1"))
    store.add_pod(mk_pod("late"))
    mod = jnative if x.name == "jax" else native
    orig = mod.schedule_with_gangs_native

    def engine(arr, cfg):
        calls.append((len(sched._deferred_binds), store.pods["default/early"].node_name))
        return orig(arr, cfg)

    mod.schedule_with_gangs_native = engine
    try:
        sched.schedule_batch()
    finally:
        mod.schedule_with_gangs_native = orig
    return observe(store, sched)


NATIVE_CASES = {
    "end_to_end_bind": lambda x: ts.end_to_end_bind(x, "native"),
    "decision_parity": lambda x: ts.decision_parity(x, "native"),
    "preemption_evicts_lower_priority": lambda x: ts.preemption_evicts_lower_priority(x, "native"),
    "raises_on_livelock": lambda x: ts.raises_on_livelock(x, "native"),
    "gang": gang_run,
    **{f"random[{s}]": (lambda x, s=s: random_run(x, s)) for s in range(3)},
    **{f"random-no-gangs[{s}]": (lambda x, s=s: random_run(x, s, NO_GANGS)) for s in range(3)},
}


@pytest.mark.parametrize("case", list(NATIVE_CASES))
def test_scheduler_native_matches_jax(case):
    want, got = both(NATIVE_CASES[case])
    assert got == want


def test_scheduler_native_ordinals_are_pod_order():
    """Without gangs the engine commits in pod order: each cycle's ordinals
    are 0..P-1 and its sweeps P, as in the JAX Scheduler."""
    want, got = both(random_run, 0, NO_GANGS)
    assert got == want
    waves = got[0]
    assert waves and all(o == list(range(s)) for o, s in waves)
    gang_waves, _ = random_run(Side("port"), 0)
    assert gang_waves == []  # the gang fixpoint reports no ordinals, as in JAX


@pytest.mark.parametrize("seed", range(4))
def test_scheduler_native_failure_path_matches_jax(seed, monkeypatch):
    """KTPU_EXPLAIN=1: the diagnosis' messages, BatchedPreemption's
    evictions and nominations, every event and counter equal the JAX
    Scheduler's in mode="native"; the port places the cycle's arrays only
    for a cycle that has failed pods."""
    from kubernetes_tpu_torch.api.delta import DeltaEncoder as PortEncoder

    monkeypatch.setenv("KTPU_EXPLAIN", "1")
    placed = []
    orig = PortEncoder.to_device

    def to_device(self, arr, meta):
        placed.append(meta.n_pods)
        return orig(self, arr, meta)

    monkeypatch.setattr(PortEncoder, "to_device", to_device)
    want, got = both(failing_run, seed)
    assert got == want
    assert got["counters"]["preemption_victims"] > 0
    assert any(e[0] == "FailedScheduling" and e[3].startswith("0/") for e in got["events"])
    assert any(e[0] == "Preempted" for e in got["events"])
    n_cycles = len([e for e in got["events"] if e[0] == "FailedScheduling"])
    assert 0 < len(placed) <= n_cycles
    placed.clear()
    both(random_run, 1)  # every pod fits: nothing is placed on the device
    assert placed == []


def test_scheduler_native_preempt_bench_cluster_matches_jax(monkeypatch):
    """The JAX preemption bench's build(50, 12) through run_until_idle in
    mode="native" under KTPU_EXPLAIN=1."""
    monkeypatch.setenv("KTPU_EXPLAIN", "1")

    def case(x):
        from kubernetes_tpu.bench.preempt_bench import build

        store, sched = x.cluster(config=x.cfg("native"))
        src = build(50, 12)
        for nd in src.nodes.values():
            store.add_node(nd)
        for p in src.pods.values():
            store.add_pod(p)
        sched.run_until_idle()
        return observe(store, sched)

    want, got = both(case)
    assert got == want
    assert got["counters"]["preemption_victims"] == 12


def test_scheduler_native_flushes_deferred_binds_before_the_engine():
    jcalls, pcalls = [], []
    want = deferred_then_native(Side("jax"), jcalls)
    got = deferred_then_native(Side("port"), pcalls)
    assert got == want and pcalls == jcalls == [(0, "n1")]
    assert got["deferred_flushes"] == 1


def test_scheduler_native_mode_runs():
    """mode="native" is a batch mode on the scheduler's device (the tests'
    CPU), with no mesh and no class state."""
    x = Side("port")
    store, sched = x.cluster("native", nodes=[mk_node("n0")])
    assert sched.device.type == "cpu" and sched.mesh is None
    store.add_pod(mk_pod("p"))
    sched.run_until_idle()
    assert store.pods["default/p"].node_name == "n0" and sched._hoist_cache is None
    assert sched._delta_enc._interner.path == "c"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            x.S.Scheduler(x.S.ClusterStore(), x.cfg("native"))


def test_harness_runs_native_mode():
    """bench/harness.py run_snapshot_workload(mode="native") at Config1's
    size == the recorded JAX digest (workloads.SCHEDULER_BASELINE)."""
    from kubernetes_tpu_torch.bench import workloads as tw
    from kubernetes_tpu_torch.bench.harness import run_snapshot_workload

    gen, args, want = tw.SCHEDULER_BASELINE["config1"]
    r = run_snapshot_workload("Config1", getattr(tw, gen)(*args, seed=0), "native", device="cpu")
    assert (r["scheduled"], r["unschedulable"], r["batches"], r["bindings_sha256"]) == \
        (want["scheduled"], want["unschedulable"], want["batches"], want["bindings"])
