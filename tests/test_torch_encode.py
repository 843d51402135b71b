"""The port's encoder against the JAX package's.

`basic`, `heterogeneous` and `spread_affinity` are built by each package's
own generator from the same seed (so this also holds the port's copies of
the generators to the originals); `mixed` and `all_stages` are the port's
snapshots, which the JAX encoder reads as they are.  Names, resources,
scales and the numeric fields must be equal; vocabulary-dependent fields
(labels, taints, terms) are compared through the static-feasibility masks
they produce; on the full-stage snapshots (pairwise terms and counts of
bound pods, host ports, preferred terms, images) every field is compared.
Tolerance: none.
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as jt
from kubernetes_tpu.api.snapshot import encode_snapshot as jax_encode
from kubernetes_tpu.bench import workloads as jw
from kubernetes_tpu.ops import filters as jf
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.api.snapshot import ClusterArrays, Snapshot, decode_choices, encode_snapshot
from kubernetes_tpu_torch.bench import workloads as tw
from kubernetes_tpu_torch.ops import filters as tf
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

CASES = {
    "basic-100x100": (lambda: jw.basic(100, 100), lambda: tw.basic(100, 100)),
    "heterogeneous-64x256": (lambda: jw.heterogeneous(64, 256), lambda: tw.heterogeneous(64, 256)),
    "mixed": (tw.mixed, tw.mixed),
    "mixed-seed5": (lambda: tw.mixed(48, 200, seed=5), lambda: tw.mixed(48, 200, seed=5)),
}
EXACT_FIELDS = ("node_valid", "node_alloc", "node_used", "node_unsched", "pod_valid",
                "pod_req", "pod_prio", "pod_nodename")


@pytest.fixture(scope="module", params=sorted(CASES))
def encoded(request):
    jsnap, tsnap = (f() for f in CASES[request.param])
    return jax_encode(jsnap), encode_snapshot(tsnap, device="cpu")


def test_meta_equal(encoded):
    (_, jm), (_, tm) = encoded
    assert tm.node_names == jm.node_names
    assert tm.pod_names == jm.pod_names
    assert tm.resources == jm.resources
    np.testing.assert_array_equal(tm.resource_scale, jm.resource_scale)
    np.testing.assert_array_equal(tm.pod_perm, jm.pod_perm)
    assert (tm.n_nodes, tm.n_pods) == (jm.n_nodes, jm.n_pods)


@pytest.mark.parametrize("name", EXACT_FIELDS)
def test_numeric_fields_equal(encoded, name):
    (ja, _), (ta, _) = encoded
    j = np.array(getattr(ja, name))
    t = getattr(ta, name)
    assert j.shape == tuple(t.shape)
    assert torch.equal(torch.from_numpy(j), t.to(torch.from_numpy(j).dtype))


def test_static_feasible_equal(encoded):
    """Vocabulary-dependent fields, held through what they decide."""
    (ja, _), (ta, _) = encoded
    assert torch.equal(torch.from_numpy(np.array(jf.static_feasible(ja))), tf.static_feasible(ta))


def test_evidence_flags_match_jax(encoded):
    """The evidence infer_score_config reads (PreferNoSchedule taints,
    preferred node-affinity terms) is the arrays themselves, equal to the
    JAX encoder's."""
    (ja, _), (ta, _) = encoded
    assert np.array_equal(ta.node_taint_pref.numpy(), np.asarray(ja.node_taint_pref))
    assert np.array_equal(ta.pod_pref_terms.numpy(), np.asarray(ja.pod_pref_terms))
    assert np.array_equal(ta.pod_pref_weights.numpy(), np.asarray(ja.pod_pref_weights))


def test_default_device_is_the_card(monkeypatch):
    """With no CUDA device, the default device raises; it never drops to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        encode_snapshot(tw.basic(4, 4))


def test_decode_choices():
    arr, meta = encode_snapshot(tw.basic(3, 5), device="cpu")
    choices = torch.tensor([2, -1, 0, 1, 2] + [-1] * (arr.P - 5), dtype=torch.int32)
    got = decode_choices(choices, meta)
    assert list(got) == meta.pod_names
    assert [got[n] for n in meta.pod_names] == ["node-2", None, "node-0", "node-1", "node-2"]


def _pod(**kw):
    return tt.Pod(name="p", requests={tt.CPU: 100}, **kw)


def _node(**kw):
    return tt.Node(name="n", allocatable={tt.CPU: 1000}, **kw)


def _gpu_slice():
    from kubernetes_tpu_torch.api.cluster import DraDevice, ResourceSlice

    return ResourceSlice(name="s", node_name="n", devices=(DraDevice("d0", attributes=(("type", "gpu"),)),))


def _gpu_class():
    from kubernetes_tpu_torch.api.cluster import DeviceClass, DeviceSelector

    return DeviceClass(name="gpu", selector=DeviceSelector(terms=(("type", "gpu"),)))


TERM = tt.PodAffinityTerm(topology_key=tt.LABEL_ZONE, label_selector=tt.LabelSelector.of(app="a"))
# features the port refused before the full stage set, the gangs and the
# volumes and claims were ported (a claim resolves against the snapshot's
# storage state: a WaitForFirstConsumer PVC, a ResourceSlice of its class)
PORTED = {
    "pvcs": lambda: Snapshot([_node()], [_pod(pvcs=("claim",))], pvcs={"default/claim": tt.PersistentVolumeClaim(
        name="claim", request=1, wait_for_first_consumer=True)}),
    "resource-claims": lambda: Snapshot([_node()], [_pod(resource_claims=(tt.ResourceClaimRef("gpu"),))],
                                        resource_slices=[_gpu_slice()], device_classes={"gpu": _gpu_class()}),
    "attach-limit": lambda: Snapshot([_node(volume_attach_limit=4)], [_pod()]),
    "pod-affinity": lambda: Snapshot([_node()], [_pod(affinity=tt.Affinity(required_pod_affinity=(TERM,)))]),
    "pod-anti-affinity": lambda: Snapshot([_node()], [_pod(affinity=tt.Affinity(required_pod_anti_affinity=(TERM,)))]),
    "preferred-pod-affinity": lambda: Snapshot([_node()], [_pod(affinity=tt.Affinity(
        preferred_pod_affinity=(tt.WeightedPodAffinityTerm(1, TERM),)))]),
    "topology-spread": lambda: Snapshot([_node()], [_pod(topology_spread=(
        tt.TopologySpreadConstraint(max_skew=1, topology_key=tt.LABEL_ZONE),))]),
    "host-ports": lambda: Snapshot([_node()], [_pod(host_ports=(("TCP", 80),))]),
    "bound-host-ports": lambda: Snapshot([_node()], [_pod()], [tt.Pod(
        name="b", node_name="n", host_ports=(("TCP", 80),))]),
    "images": lambda: Snapshot([_node(images={"img": 500 * 2**20})], [_pod(images=("img",))]),
    # gangs: a group without a PodGroup needs all its pods; a PodGroup whose
    # pods are absent leaves group_min at its one-slot default
    "pod-group": lambda: Snapshot([_node()], [_pod(pod_group="g")]),
    "pod-groups": lambda: Snapshot([_node()], [_pod()], pod_groups={"g": tt.PodGroup("g", 2)}),
}


def _assert_all_fields_equal(ta, ja):
    """Every ClusterArrays field equal to the JAX encoder's (node_labels is
    bool here, f32 there; image_score compared as bf16 bit patterns)."""
    for name in ClusterArrays.FIELDS:
        t = getattr(ta, name)
        j = np.asarray(getattr(ja, name))
        if name == "image_score":
            got, want = t.view(torch.int16).numpy().view(np.uint16), j.view(np.uint16)
        else:
            got, want = t.numpy(), j.astype(t.numpy().dtype)
        assert got.shape == want.shape, (name, got.shape, want.shape)
        assert np.array_equal(got, want), name


@pytest.mark.parametrize("case", sorted(PORTED))
def test_ported_features_encode_as_jax(case):
    _assert_all_fields_equal(encode_snapshot(PORTED[case](), device="cpu")[0], jax_encode(PORTED[case]())[0])


def _bound_pairwise():
    """Bound pods that carry anti-affinity, preferred (anti-)affinity and
    required affinity (the hardPodAffinityWeight half), host ports and
    images, beside a pending wave with spread and affinity terms."""
    snap = tw.all_stages(18, 40, seed=4)
    term = tt.PodAffinityTerm(topology_key=tt.LABEL_HOSTNAME, label_selector=tt.LabelSelector.of(app="web"))
    zterm = tt.PodAffinityTerm(topology_key=tt.LABEL_ZONE, label_selector=tt.LabelSelector.of(app="db"))
    aff = tt.Affinity(required_pod_anti_affinity=(term,), required_pod_affinity=(zterm,),
                      preferred_pod_affinity=(tt.WeightedPodAffinityTerm(30, zterm),),
                      preferred_pod_anti_affinity=(tt.WeightedPodAffinityTerm(7, term),))
    snap.bound_pods = [tt.Pod(name=f"b{i}", node_name=f"n{i % 18:03d}", labels={"app": ("web", "db")[i % 2]},
                              requests={tt.CPU: 100}, affinity=aff if i % 3 == 0 else None,
                              host_ports=(("TCP", 9100 + i % 2),) if i % 4 == 0 else (),
                              images=("registry/app:v1",)) for i in range(12)]
    return snap


FULL_CASES = {
    # each package's own generator from one seed: the snapshots are the same
    "spread-affinity": (lambda: jw.spread_affinity(90, 400, seed=2), lambda: tw.spread_affinity(90, 400, seed=2)),
    "all-stages": (lambda: tw.all_stages(48, 128), lambda: tw.all_stages(48, 128)),
    "bound-pairwise": (_bound_pairwise, _bound_pairwise),
}


@pytest.mark.parametrize("case", sorted(FULL_CASES))
def test_full_stage_fields_equal_jax(case):
    jsnap, tsnap = (f() for f in FULL_CASES[case])
    (ja, jm), (ta, tm) = jax_encode(jsnap), encode_snapshot(tsnap, device="cpu")
    assert tm.pod_names == jm.pod_names and tm.node_names == jm.node_names
    _assert_all_fields_equal(ta, ja)


def test_config3_encodes_at_full_size():
    """BASELINE config 3 itself: the shape the card runs (P=10240, N=6144,
    80 terms over two keys, 5003 domains, two matched-term slots)."""
    arr, meta = encode_snapshot(tw.spread_affinity(5000, 10000, seed=0), device="cpu")
    assert (arr.P, arr.N, arr.R) == (10240, 6144, 4)
    assert tuple(arr.term_counts0.shape) == (80, 5004) and arr.node_dom.shape[0] == 2
    assert arr.pod_match_terms.shape[1] == 2 and meta.n_pods == 10000


def test_jax_typed_snapshot_encodes_the_same():
    """The encoder reads the object model by attribute, so a snapshot built
    from the JAX package's types encodes exactly like the port's own."""
    ja, jm = encode_snapshot(jw.heterogeneous(16, 40), device="cpu")
    ta, tm = encode_snapshot(tw.heterogeneous(16, 40), device="cpu")
    assert jm.pod_names == tm.pod_names
    for name in EXACT_FIELDS:
        assert torch.equal(getattr(ja, name), getattr(ta, name))
    assert jt.CPU == tt.CPU
