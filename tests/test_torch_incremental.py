"""The port's class index and class hoists against the JAX package's.

- the port's encoder partitions pods into the same classes as the JAX
  encoder (DeltaEncoder), padding rows in a class of their own;
- _static_hoist_plain / _usage_hoist_plain / _patch_hoist_plain equal the
  JAX package's _static_hoist / _usage_hoist / _patch_hoist (packed words as
  bit patterns, base scores as f32 bits) on the JAX encoder's arrays carried
  across (convert.from_jax_arrays / from_jax_meta);
- over a churn of cycles (a few nodes dirty, none, most, a static field
  replaced) the port's HoistCache takes the JAX HoistCache's actions, keeps
  its stats and holds the same matrices, and never writes into the class
  state it handed out earlier;
- under KTPU_INCREMENTAL=0 ensure returns None and counts `disabled` as
  the JAX one does, and a Scheduler's cycle routes without class state
  with the JAX Scheduler's HoistCache stats and verdicts.  Tolerance: none.
"""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import random_cluster
from kubernetes_tpu.api.delta import DeltaEncoder
from kubernetes_tpu.bench import workloads as jw
from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG as JAX_DEFAULT
from kubernetes_tpu.ops import incremental as jinc
from kubernetes_tpu.ops import infer_score_config as jax_infer
from kubernetes_tpu_torch.api.snapshot import encode_snapshot
from kubernetes_tpu_torch.bench import workloads as tw
from kubernetes_tpu_torch.convert import from_jax_arrays, from_jax_meta
from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, incremental, infer_score_config
from kubernetes_tpu_torch.ops.incremental import HoistCache, class_view
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

STRATEGIES = {
    "least": ("LeastAllocated", ((0.0, 0.0), (100.0, 10.0))),
    "most": ("MostAllocated", ((0.0, 0.0), (100.0, 10.0))),
    "rtcr": ("RequestedToCapacityRatio", ((0.0, 10.0), (50.0, 2.0), (100.0, 0.0))),
}
PARTITIONS = {
    "mixed": (tw.mixed, tw.mixed),
    "heterogeneous-200x500": (lambda: jw.heterogeneous(200, 500), lambda: tw.heterogeneous(200, 500)),
    "random": (lambda: random_cluster(random.Random(3), n_nodes=20, n_pods=150, with_selectors=True),) * 2,
}
HOISTS = {
    "random-selectors": lambda: random_cluster(random.Random(11), n_nodes=37, n_pods=230, with_selectors=True),
    "random-plain": lambda: random_cluster(random.Random(12), n_nodes=64, n_pods=300),
    "heterogeneous": lambda: jw.heterogeneous(45, 400),
}


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype in (np.float32, np.uint32) else x


def _same(port, jax_value):
    t = port.numpy()
    np.testing.assert_array_equal(t.view(np.int32) if t.dtype == np.float32 else t, _bits(jax_value))


def _carry(ja, jm):
    return from_jax_arrays({f.name: np.asarray(getattr(ja, f.name)) for f in dataclasses.fields(ja)}, "cpu"), \
        from_jax_meta(jm)


@pytest.mark.parametrize("name", sorted(PARTITIONS))
def test_class_partition_matches_delta_encoder(name):
    jsnap, tsnap = (f() for f in PARTITIONS[name])
    _, jm = DeltaEncoder().encode(jsnap)
    _, tm = encode_snapshot(tsnap, device="cpu")
    a, b = np.asarray(jm.pod_class), tm.pod_class
    assert a.shape == b.shape
    pairs = np.unique(np.stack([a, b]), axis=1).shape[1]
    assert pairs == len(np.unique(a)) == len(np.unique(b))  # a bijection of class ids
    assert tm.n_classes == jm.n_classes == len(tm.class_first_pod)
    assert sorted(tm.class_first_pod.tolist()) == sorted(np.asarray(jm.class_first_pod).tolist())
    first = tm.class_first_pod
    assert (b[first[b[: tm.n_pods]]] == b[: tm.n_pods]).all()  # each class's first row is in the class
    if len(b) > tm.n_pods:
        assert (b[tm.n_pods:] == tm.n_classes - 1).all() and first[-1] == tm.n_pods


@pytest.fixture(scope="module", params=sorted(HOISTS))
def carried(request):
    ja, jm = DeltaEncoder().encode(HOISTS[request.param]())
    return ja, jm, *_carry(ja, jm)


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_hoists_match_jax(carried, strategy):
    ja, jm, arr, meta = carried
    name, shape = STRATEGIES[strategy]
    jcfg = jax_infer(ja, dataclasses.replace(JAX_DEFAULT, fit_strategy=name, rtcr_shape=shape))
    cfg = infer_score_config(arr, dataclasses.replace(DEFAULT_SCORE_CONFIG, fit_strategy=name, rtcr_shape=shape))
    r_u = np.asarray(jm.class_first_pod)
    stat_j = jinc._static_hoist(jinc.class_view(ja, r_u), False, False, False)[0]
    stat_t = incremental._static_hoist_plain(class_view(arr, torch.from_numpy(r_u)))[0]
    _same(stat_t, stat_j)
    req_u = np.ascontiguousarray(ja.pod_req[r_u])
    base_j, fit_j = jinc._usage_hoist(jnp.asarray(req_u), jnp.asarray(ja.node_used), jnp.asarray(ja.node_alloc), jcfg)
    req_t = torch.from_numpy(req_u)
    base_t, fit_t = incremental._usage_hoist_plain(req_t, arr.node_used, arr.node_alloc, cfg)
    _same(base_t, base_j)
    _same(fit_t, fit_j)
    # a third of the nodes dirty, several sharing a word, padded with N
    rng = np.random.default_rng(len(r_u))
    dirty = np.sort(rng.permutation(arr.N)[: arr.N // 3])
    used2 = np.array(ja.node_used)
    used2[dirty] += ja.pod_req[0]
    cols = np.full(incremental._round_up_pow2(len(dirty)), arr.N, dtype=np.int32)
    cols[: len(dirty)] = dirty
    pb_j, pf_j = jinc._patch_hoist(base_j, fit_j, jnp.asarray(req_u), jnp.asarray(used2),
                                   jnp.asarray(ja.node_alloc), jnp.asarray(cols), jcfg)
    pb_t, pf_t = incremental._patch_hoist_plain(base_t, fit_t, req_t, torch.from_numpy(used2), arr.node_alloc,
                                                torch.from_numpy(cols), cfg)
    _same(pb_t, pb_j)
    _same(pf_t, pf_j)
    full_b, full_f = incremental._usage_hoist_plain(req_t, torch.from_numpy(used2), arr.node_alloc, cfg)
    assert torch.equal(pb_t.view(torch.int32), full_b.view(torch.int32)) and torch.equal(pf_t, full_f)


def test_hoist_cache_churn_matches_jax():
    """Patch, hit, full, static rebuild, patch: the same actions, stats and
    matrices as the JAX HoistCache, and earlier class states untouched."""
    ja, jm = DeltaEncoder().encode(random_cluster(random.Random(21), n_nodes=48, n_pods=200, with_selectors=True))
    arr, meta = _carry(ja, jm)
    jcfg = jax_infer(ja, JAX_DEFAULT)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    jcache, tcache = jinc.HoistCache(), HoistCache()
    rng = np.random.default_rng(0)

    def bump(used, k):
        used = np.array(used)
        used[rng.permutation(ja.N)[:k]] += 1
        return used

    cycles = [
        lambda j, t: (j, t),  # cold: static rebuild
        lambda j, t: (lambda u: (dataclasses.replace(j, node_used=u),
                                 dataclasses.replace(t, node_used=torch.from_numpy(u))))(bump(j.node_used, 5)),
        lambda j, t: (j, t),  # nothing moved
        lambda j, t: (lambda u: (dataclasses.replace(j, node_used=u),
                                 dataclasses.replace(t, node_used=torch.from_numpy(u))))(bump(j.node_used, 40)),
        lambda j, t: (dataclasses.replace(j, node_taint_ns=np.array(j.node_taint_ns)),
                      dataclasses.replace(t, node_taint_ns=t.node_taint_ns.clone())),
        lambda j, t: (lambda u: (dataclasses.replace(j, node_used=u),
                                 dataclasses.replace(t, node_used=torch.from_numpy(u))))(bump(j.node_used, 3)),
    ]
    held = []
    actions = []
    for step in cycles:
        ja, arr = step(ja, arr)
        jstate = jcache.ensure(ja, jm, jcfg)
        tstate = tcache.ensure(arr, meta, cfg)
        assert tcache.last == jcache.last
        assert tcache.stats == jcache.stats
        for name in ("stat_u", "base_u", "fit_u", "req_u", "cls"):
            _same(getattr(tstate, name), getattr(jstate, name))
        held.append((tstate, [t.clone() for t in tstate[:5]]))
        actions.append(tcache.last["action"])
    assert actions == ["static_rebuild", "patch", "hit", "full", "static_rebuild", "patch"]
    for state, copies in held:
        for t, c in zip(state[:5], copies):
            assert torch.equal(t, c)
    assert tcache.summary() == jcache.summary()
    tcache.invalidate()
    tcache.ensure(arr, meta, cfg)
    assert tcache.last["action"] == "static_rebuild"


def test_degenerate_and_missing_class_index():
    arr, meta = encode_snapshot(tw.basic(4, 4), device="cpu")
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    cache = HoistCache()
    assert cache.ensure(arr, dataclasses.replace(meta, pod_class=None), cfg) is None
    # P = 8 rows, 1 spec + the padding class: not degenerate
    assert cache.ensure(arr, meta, cfg) is not None
    assert cache.ensure(arr.pod_prefix(2), dataclasses.replace(
        meta, pod_class=meta.pod_class[:2], class_first_pod=np.array([0, 1])), cfg) is None
    assert cache.last["action"] == "skipped_degenerate"
    assert cache.stats["skipped"] == 2


def test_incremental_knob_off_matches_jax(monkeypatch):
    """KTPU_INCREMENTAL=0: HoistCache.ensure returns None and counts
    `disabled`, as the JAX one does; the Scheduler's cycles then route with
    no class state (the port's routes), with the JAX Scheduler's HoistCache
    stats and verdicts (both sides under KTPU_FORCE_CHUNKED=1, where the
    JAX package builds class state on the CPU).  With the knob on, the same
    cycle routes on class state in both."""
    from helpers import mk_node, mk_pod
    from kubernetes_tpu_torch.ops import assign
    from torch_scheduler_sides import Side, observe

    ja, jm = DeltaEncoder().encode(random_cluster(random.Random(21), n_nodes=48, n_pods=200, with_selectors=True))
    arr, meta = _carry(ja, jm)
    monkeypatch.setenv("KTPU_INCREMENTAL", "0")
    jcache, tcache = jinc.HoistCache(), HoistCache()
    assert jcache.ensure(ja, jm, jax_infer(ja, JAX_DEFAULT)) is None
    assert tcache.ensure(arr, meta, infer_score_config(arr, DEFAULT_SCORE_CONFIG)) is None
    assert tcache.stats == jcache.stats and tcache.stats["disabled"] == 1 and tcache.history == []

    monkeypatch.setenv("KTPU_FORCE_CHUNKED", "1")
    seen = {}
    for knob in ("1", "0"):
        monkeypatch.setenv("KTPU_INCREMENTAL", knob)
        for name in ("jax", "port"):
            x = Side(name)
            assign.reset_trace_counts()
            store, sched = x.cluster(nodes=[mk_node(f"n{i}", cpu=3000, pods=16) for i in range(5)])
            for i in range(20):
                store.add_pod(mk_pod(f"p{i}", cpu=250))
            sched.run_until_idle()
            hc = sched._hoist_cache
            seen[knob, name] = (observe(store, sched), hc.stats, [h["action"] for h in hc.history])
            if name == "port":
                seen[knob, "routes"] = {k for k, v in assign.TRACE_COUNTS.items() if v}
        assert seen[knob, "port"] == seen[knob, "jax"]
    assert seen["0", "port"][1]["disabled"] == 1 and seen["0", "port"][2] == []
    assert seen["1", "port"][2] == ["static_rebuild"] and seen["0", "port"][0] == seen["1", "port"][0]
    assert seen["1", "routes"] == {"rounds_inc"} and not {r for r in seen["0", "routes"] if "inc" in r or "wave" in r}
