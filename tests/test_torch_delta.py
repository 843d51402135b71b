"""The port's DeltaEncoder against the JAX package's (after
tests/test_delta_encoder.py, with fit-only pod templates).

- over a churn stream (binds, deletes, new waves) every cycle's carried
  fields equal the JAX DeltaEncoder's value for value, with the same names,
  resources, scale, classes and stats, and the same decisions as a fresh
  one-shot encode;
- the fallbacks: a wave bringing a new referenced label key, a replaced
  node; the fast path on same-template waves; debug_verify catching an
  in-place mutation of a bound pod; a duplicate bound uid;
- a delta that brings a host port, an affinity term or a claim the cluster
  side lacks rebuilds and encodes as the JAX encoder does;
- the host pack/unpack give the JAX package's bytes, and a snapshot whose
  taint vocabulary is 64 or more wide travels packed and decides as the
  JAX package does;
- device placement keeps identity: an unchanged field comes back as the
  same tensor object, so a warm cycle's HoistCache keeps its static side
  and patches.
Tolerance: none.
"""

import dataclasses

import numpy as np
import pytest
import torch

from helpers import mk_node, mk_pod
from kubernetes_tpu.api import types as t
from kubernetes_tpu.api.delta import DeltaEncoder as JaxDeltaEncoder
from kubernetes_tpu.api.snapshot import Snapshot
from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG as JAX_DEFAULT
from kubernetes_tpu.ops import bitplane as jbit
from kubernetes_tpu.ops import infer_score_config as jax_infer
from kubernetes_tpu.oracle import oracle_schedule
from kubernetes_tpu_torch.api.delta import DeltaEncoder
from kubernetes_tpu_torch.api.snapshot import ClusterArrays, decode_choices, encode_snapshot
from kubernetes_tpu_torch.bench import workloads as tw
from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, bitplane, infer_score_config, schedule_batch
from kubernetes_tpu_torch.ops.incremental import HoistCache
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

GPU = (t.Toleration("gpu", "true", t.NO_SCHEDULE, "Equal"),)


def template(name, kind):
    """Pods stamped from a small fit-only template family."""
    if kind == 0:
        return mk_pod(name, cpu=250, mem=256 * 1024**2, labels={"app": "web"})
    if kind == 1:
        return mk_pod(name, cpu=500, labels={"app": "db"}, node_selector={t.LABEL_ZONE: "z1"})
    if kind == 2:
        term = t.NodeSelectorTerm((t.NodeSelectorRequirement(t.LABEL_ZONE, t.OP_IN, ("z0", "z2")),))
        return mk_pod(name, cpu=100, tolerations=GPU, affinity=t.Affinity(required_node_terms=(term,)))
    return mk_pod(name, cpu=50, mem=64 * 1024**2, tolerations=GPU, priority=100)


def cluster_nodes(n):
    return [mk_node(f"n{i}", labels={t.LABEL_ZONE: f"z{i % 3}"},
                    taints=(t.Taint("gpu", "true", t.NO_SCHEDULE),) if i % 5 == 0 else ()) for i in range(n)]


def assert_same_encoding(got, gm, want, wm):
    """The port's carried fields, names, scale and classes equal the JAX
    encoder's (node_labels: bool here, f32 there)."""
    for name in ClusterArrays.FIELDS:
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(want, name))
        assert a.shape == b.shape, name
        if name == "image_score":  # bf16 bit patterns on both sides
            b = b.view(np.uint16)
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=name)
    for name in ("node_names", "pod_names", "resources", "n_nodes", "n_pods", "n_classes"):
        assert getattr(gm, name) == getattr(wm, name), name
    for name in ("pod_perm", "resource_scale", "pod_class", "class_first_pod"):
        np.testing.assert_array_equal(getattr(gm, name), np.asarray(getattr(wm, name)), err_msg=name)


def _decisions(arr, meta):
    c, _ = schedule_batch(arr, infer_score_config(arr, DEFAULT_SCORE_CONFIG), device="cpu")
    return decode_choices(c, meta)


def test_churn_stream_matches_jax_and_fresh_encodes():
    rng = np.random.default_rng(0)
    nodes = cluster_nodes(24)
    bound = []
    port, jax_enc = DeltaEncoder("cpu"), JaxDeltaEncoder()
    serial = 0
    for cycle in range(6):
        kinds = [0, 1, 2, 3] * 2 if cycle == 0 else [int(k) for k in rng.integers(0, 4, int(rng.integers(4, 12)))]
        pending = [template(f"p{serial + i}", k) for i, k in enumerate(kinds)]
        serial += len(pending)
        snap = Snapshot(nodes=nodes, pending_pods=pending, bound_pods=list(bound))
        host, meta = port.encode(snap)
        want, wm = jax_enc.encode(snap)
        assert_same_encoding(host, meta, want, wm)
        assert port.stats == jax_enc.stats, cycle
        arr, meta = port.to_device(host, meta)
        fresh, fm = encode_snapshot(snap, device="cpu")
        assert _decisions(arr, meta) == _decisions(fresh, fm), cycle
        for pod in pending:  # bind most of the wave, delete a bound pod
            if rng.random() < 0.7:
                bound.append(dataclasses.replace(pod, node_name=nodes[int(rng.integers(0, len(nodes)))].name))
        if bound and rng.random() < 0.8:
            bound.pop(int(rng.integers(0, len(bound))))
    assert port.stats["delta"] >= 4, port.stats


def test_falls_back_on_new_vocab():
    nodes = cluster_nodes(8)
    port, jax_enc = DeltaEncoder("cpu"), JaxDeltaEncoder()
    snap1 = Snapshot(nodes=nodes, pending_pods=[template("a", 0), template("b", 1)])
    snap2 = Snapshot(nodes=nodes, pending_pods=[template("c", 2), mk_pod("d", node_selector={"disk": "ssd"})],
                     bound_pods=[dataclasses.replace(template("a", 0), node_name="n1")])
    for snap in (snap1, snap2):  # the second wave references a new label key
        got, gm = port.encode(snap)
        want, wm = jax_enc.encode(snap)
        assert_same_encoding(got, gm, want, wm)
        assert_same_encoding(got, gm, *JaxDeltaEncoder().encode(snap))  # == a fresh encode
    assert port.stats == jax_enc.stats == {"full": 2, "delta": 0, "verified": 0}


def test_falls_back_on_node_change():
    nodes = cluster_nodes(8)
    port, jax_enc = DeltaEncoder("cpu"), JaxDeltaEncoder()
    snap1 = Snapshot(nodes=list(nodes), pending_pods=[template("p0", 0)])
    nodes2 = list(nodes)
    nodes2[3] = mk_node("n3", labels={t.LABEL_ZONE: "z0"}, unschedulable=True)
    snap2 = Snapshot(nodes=nodes2, pending_pods=[template("p1", 0)])
    for snap in (snap1, snap2):
        assert_same_encoding(*port.encode(snap), *jax_enc.encode(snap))
    assert port.stats["full"] == jax_enc.stats["full"] == 2


def test_same_template_waves_take_the_fast_path():
    nodes = cluster_nodes(12)
    port, jax_enc = DeltaEncoder("cpu"), JaxDeltaEncoder()
    bound = []
    for cycle in range(4):
        pending = [template(f"w{cycle}-{i}", i % 4) for i in range(8)]
        snap = Snapshot(nodes=nodes, pending_pods=pending, bound_pods=list(bound))
        assert_same_encoding(*port.encode(snap), *JaxDeltaEncoder().encode(snap))
        jax_enc.encode(snap)
        for i, pod in enumerate(pending):
            bound.append(dataclasses.replace(pod, node_name=f"n{(cycle + i) % 12}"))
    assert port.stats == jax_enc.stats == {"full": 1, "delta": 3, "verified": 0}


def test_debug_verify_catches_inplace_mutation():
    nodes = cluster_nodes(6)
    enc = DeltaEncoder("cpu", debug_verify=True)
    pod = template("a", 0)
    enc.encode(Snapshot(nodes=nodes, pending_pods=[pod]))
    bound = dataclasses.replace(pod, node_name="n1")
    enc.encode(Snapshot(nodes=nodes, pending_pods=[template("b", 0)], bound_pods=[bound]))
    assert enc.stats["delta"] == 1 and enc.stats["verified"] == 1
    bound.requests = {t.CPU: bound.requests[t.CPU] * 10}  # in place: the `is` check cannot see it
    with pytest.raises(AssertionError, match="diverged from rebuild"):
        enc.encode(Snapshot(nodes=nodes, pending_pods=[template("c", 0)], bound_pods=[bound]))


def test_duplicate_bound_uid_rejected():
    p = dataclasses.replace(template("dup", 0), node_name="n0")
    q = dataclasses.replace(p, node_name="n1")
    q.uid = p.uid
    with pytest.raises(ValueError, match="duplicate bound pod uid"):
        DeltaEncoder("cpu").encode(Snapshot(nodes=cluster_nodes(3), pending_pods=[], bound_pods=[p, q]))


@pytest.mark.parametrize("feature", ["host-ports", "pod-affinity", "pvcs"])
def test_delta_bringing_a_refused_feature_raises(feature):
    """A bound pod arriving in a delta with a host port or an affinity term
    the vocabulary lacks falls back to a rebuild, as the JAX encoder does,
    and encodes as it; one bringing a claim (a PVC the snapshot holds, a
    new resource kind for the attach count) does the same."""
    nodes = cluster_nodes(6)
    enc, jax_enc = DeltaEncoder("cpu"), JaxDeltaEncoder()
    first = Snapshot(nodes=nodes, pending_pods=[template("a", 0)])
    enc.encode(first)
    jax_enc.encode(first)
    term = t.PodAffinityTerm(topology_key=t.LABEL_ZONE, label_selector=t.LabelSelector.of(app="web"))
    extra = {"host-ports": dict(host_ports=(("TCP", 80),)),
             "pod-affinity": dict(affinity=t.Affinity(required_pod_affinity=(term,))),
             "pvcs": dict(pvcs=("claim",))}[feature]
    bad = dataclasses.replace(mk_pod("b", node_name="n2"), **extra)
    pvc = t.PersistentVolumeClaim(name="claim", request=1, wait_for_first_consumer=True)
    snap = Snapshot(nodes=nodes, pending_pods=[template("c", 0)], bound_pods=[bad],
                    pvcs={pvc.key: pvc} if feature == "pvcs" else {})
    assert_same_encoding(*enc.encode(snap), *jax_enc.encode(snap))
    assert enc.stats == jax_enc.stats == {"full": 2, "delta": 0, "verified": 0}


def pairwise_template(name, kind):
    """Pods stamped from a template family with spread, (anti-)affinity,
    preferred terms and host ports."""
    zone = t.PodAffinityTerm(topology_key=t.LABEL_ZONE, label_selector=t.LabelSelector.of(app="web"))
    host = t.PodAffinityTerm(topology_key=t.LABEL_HOSTNAME, label_selector=t.LabelSelector.of(app="db"))
    if kind == 0:
        return mk_pod(name, cpu=250, labels={"app": "web"}, topology_spread=(t.TopologySpreadConstraint(
            max_skew=1, topology_key=t.LABEL_ZONE, label_selector=t.LabelSelector.of(app="web")),))
    if kind == 1:
        return mk_pod(name, cpu=100, labels={"app": "db"},
                      affinity=t.Affinity(required_pod_anti_affinity=(host,),
                                          preferred_pod_affinity=(t.WeightedPodAffinityTerm(20, zone),)))
    if kind == 2:
        return mk_pod(name, cpu=50, labels={"app": "web"}, affinity=t.Affinity(required_pod_affinity=(zone,)),
                      host_ports=(("TCP", 8080),))
    return mk_pod(name, cpu=75, labels={"app": "cache"},
                  affinity=t.Affinity(preferred_pod_anti_affinity=(t.WeightedPodAffinityTerm(5, host),)))


@pytest.mark.parametrize("seed", [0, 1])
def test_pairwise_churn_matches_jax_and_fresh_encodes(seed):
    """Binds and deletes of pods with pairwise terms and host ports move the
    per-domain counts and port occupancy as the JAX DeltaEncoder does, cycle
    for cycle; the kinds drawn change the term vocabulary, which rebuilds as
    the JAX encoder's does (the fallback counters are pinned to its)."""
    rng = np.random.default_rng(seed)
    nodes = cluster_nodes(20)
    bound = []
    port, jax_enc = DeltaEncoder("cpu"), JaxDeltaEncoder()
    serial = 0
    for cycle in range(6):
        kinds = [int(k) for k in rng.integers(0, 4 if cycle >= 3 else 2, int(rng.integers(4, 10)))]
        pending = [pairwise_template(f"q{serial + i}", k) for i, k in enumerate(kinds)]
        serial += len(pending)
        snap = Snapshot(nodes=nodes, pending_pods=pending, bound_pods=list(bound))
        host, meta = port.encode(snap)
        want, wm = jax_enc.encode(snap)
        assert_same_encoding(host, meta, want, wm)
        assert port.stats == jax_enc.stats, cycle
        arr, meta = port.to_device(host, meta)
        fresh, fm = encode_snapshot(snap, device="cpu")
        assert _decisions(arr, meta) == _decisions(fresh, fm), cycle
        for pod in pending:
            if rng.random() < 0.7:
                bound.append(dataclasses.replace(pod, node_name=nodes[int(rng.integers(0, len(nodes)))].name))
        if bound and rng.random() < 0.8:
            bound.pop(int(rng.integers(0, len(bound))))
    assert port.stats["full"] >= 2 and port.stats["delta"] >= 1, port.stats


@pytest.mark.parametrize("hpaw", [0.0, 10.0])
def test_hard_pod_affinity_weight_matches_jax(hpaw):
    """DeltaEncoder(hard_pod_affinity_weight=) scores the bound pods'
    required-affinity terms at that weight, and ScoreConfig's weight scores
    the scans' own commits at it, as the JAX package's encoder and scan do
    (after its tests/test_interpod_pref.py test_hard_pod_affinity_weight_
    configurable): the encodings are equal, and the per-pod and rounds
    scans decide as the JAX per-pod scan and the oracle."""
    from kubernetes_tpu.ops import schedule_batch as jax_schedule
    from kubernetes_tpu_torch.ops import assign

    rng = np.random.default_rng(11)
    nodes = cluster_nodes(18)
    bound = [dataclasses.replace(pairwise_template(f"b{i}", 2 if i % 2 == 0 else int(rng.integers(0, 4))),
                                 node_name=nodes[int(rng.integers(0, len(nodes)))].name) for i in range(10)]
    pending = [pairwise_template(f"q{i}", int(k)) for i, k in enumerate(rng.integers(0, 4, 32))]
    snap = Snapshot(nodes=nodes, pending_pods=pending, bound_pods=bound)
    port = DeltaEncoder("cpu", hard_pod_affinity_weight=hpaw)
    host, meta = port.encode(snap)
    want, wm = JaxDeltaEncoder(hard_pod_affinity_weight=hpaw).encode(snap)
    assert_same_encoding(host, meta, want, wm)
    arr, meta = port.to_device(host, meta)
    cfg = infer_score_config(arr, dataclasses.replace(DEFAULT_SCORE_CONFIG, hard_pod_affinity_weight=hpaw))
    jcfg = jax_infer(want, dataclasses.replace(JAX_DEFAULT, hard_pod_affinity_weight=hpaw))
    assert cfg.enable_interpod_score and jcfg.enable_interpod_score
    assert assign._rounds_capable(arr, cfg) and not assign._chunkable(arr, cfg)
    choices, used = assign.schedule_scan_plain(arr, cfg)
    jc, ju = (np.asarray(x) for x in jax_schedule(want, jcfg))
    np.testing.assert_array_equal(choices.numpy(), jc)
    np.testing.assert_array_equal(used.numpy(), ju)
    rc, ru, _, _ = assign.schedule_scan_rounds_plain(arr, cfg)
    assert torch.equal(rc, choices) and torch.equal(ru, used)
    placed = decode_choices(choices, meta)
    assert [(n, placed[n]) for n in meta.pod_names] == oracle_schedule(snap, jcfg)


@pytest.mark.parametrize("shape", [(3, 64), (5, 65), (2, 7, 100), (1, 1), (4, 0)])
def test_host_pack_unpack_match_jax_bytes(shape):
    dense = np.random.default_rng(sum(shape)).random(shape) < 0.5
    got = bitplane.np_pack_lastaxis(dense)
    want = jbit.np_pack_lastaxis(dense)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(bitplane.np_unpack_lastaxis(got, shape[-1]), dense)
    np.testing.assert_array_equal(bitplane.np_unpack_lastaxis(got, shape[-1]),
                                  jbit.np_unpack_lastaxis(want, shape[-1]))
    # the packed words are the device unpack's input: pack() gives the same bits
    np.testing.assert_array_equal(bitplane.pack(torch.from_numpy(dense)).numpy().view(np.uint32), got)


def test_wide_taint_vocabulary_travels_packed(monkeypatch):
    """80 distinct NoSchedule taints: node_taint_ns and pod_tol_ns, and the
    PreferNoSchedule planes beside them (node_taint_pref, pod_tol_pref), are
    80 wide, go to the device packed and come back equal; decisions equal
    the JAX package's encoder and the oracle's."""
    from kubernetes_tpu_torch.api import delta

    snap = tw.wide_taints(200, 400)
    packed = []
    real = DeltaEncoder._packed_put
    monkeypatch.setattr(DeltaEncoder, "_packed_put",
                        lambda self, a, *dev: packed.append(a.shape) or real(self, a, *dev))
    enc = DeltaEncoder("cpu")
    host, meta = enc.encode(snap)
    arr, meta = enc.to_device(host, meta)
    assert sorted(packed) == sorted([host.node_taint_ns.shape, host.pod_tol_ns.shape,
                                     host.node_taint_pref.shape, host.pod_tol_pref.shape])
    assert host.node_taint_ns.shape[1] == 80 and delta._packable(host.pod_tol_ns)
    for name in ClusterArrays.FIELDS:
        got = getattr(arr, name)
        got = got.view(torch.int16).numpy().view(np.uint16) if got.dtype == torch.bfloat16 else got.numpy()
        np.testing.assert_array_equal(got, getattr(host, name), err_msg=name)
    ja, jm = JaxDeltaEncoder().encode(snap)
    assert_same_encoding(host, meta, ja, jm)
    placed = _decisions(arr, meta)
    assert [(n, placed[n]) for n in meta.pod_names] == oracle_schedule(snap, jax_infer(ja, JAX_DEFAULT))


def test_unchanged_fields_keep_their_tensors_and_the_warm_cycle_patches():
    """bench.py's warm cycles in miniature: the same templates renamed, a few
    of the last wave's pods bound.  Every field but the usage comes back as
    the same tensor object, by identity or by equal value, and HoistCache
    keeps its static side and patches the dirty columns."""
    snap = tw.heterogeneous(60, 300)
    enc = DeltaEncoder("cpu")
    host1, meta1 = enc.encode(snap)
    arr1, meta1 = enc.to_device(host1, meta1)
    cfg = infer_score_config(host1, DEFAULT_SCORE_CONFIG)
    cache = HoistCache()
    cache.ensure(arr1, meta1, cfg, host=host1)
    assert cache.last["action"] == "static_rebuild"
    c1, _ = schedule_batch(arr1, cfg, device="cpu")
    wave = tw.mk_wave(snap, 2)
    placed = tw.place(snap.pending_pods[:10], tw.verdicts_of(c1, meta1))
    snap2 = type(snap)(nodes=snap.nodes, pending_pods=wave, bound_pods=placed)
    host2, meta2 = enc.encode(snap2)
    arr2, meta2 = enc.to_device(host2, meta2)
    assert enc.stats == {"full": 1, "delta": 1, "verified": 0}
    same = {n for n in ClusterArrays.FIELDS if getattr(arr2, n) is getattr(arr1, n)}
    assert same == set(ClusterArrays.FIELDS) - {"node_used"}
    inc = cache.ensure(arr2, meta2, cfg, host=host2)
    assert cache.last["action"] == "patch" and 0 < cache.last["patched_cols"] <= 10
    full = HoistCache().ensure(arr2, meta2, cfg)
    for a, b in zip(inc[:5], full[:5]):
        assert torch.equal(a, b)
    # after drop_device_buffers every field is placed anew, with equal values
    enc.drop_device_buffers()
    arr3, _ = enc.to_device(host2, meta2)
    for n in ClusterArrays.FIELDS:
        assert getattr(arr3, n) is not getattr(arr2, n) and torch.equal(getattr(arr3, n), getattr(arr2, n))


def test_spec_grouping_matches_jax():
    """SpecInterner / group_by_spec give the JAX package's unique specs and
    inverse index, on fresh pods and on a renamed wave that shares their
    field objects (the identity level of the interner)."""
    from kubernetes_tpu.api import snapshot as js
    from kubernetes_tpu_torch.api import snapshot as ts

    pods = tw.mixed().pending_pods
    for wave in (pods, tw.mk_wave(tw.mixed(), 2)):
        want_reps, want_inv = js.group_by_spec(wave)
        reps, inv = ts.group_by_spec(wave)
        assert [p.name for p in reps] == [p.name for p in want_reps]
        np.testing.assert_array_equal(inv, want_inv)
    interner = ts.SpecInterner()
    for wave in (pods, tw.mk_wave(tw.mixed(), 3)):
        reps, inv, keys = interner.group(wave)
        want_reps, want_inv, want_keys = js.SpecInterner().group(wave)
        assert [p.name for p in reps] == [p.name for p in want_reps] and keys == want_keys
        np.testing.assert_array_equal(inv, want_inv)
