"""The port's encoder against the JAX package's.

`basic` and `heterogeneous` are built by each package's own generator from
the same seed (so this also holds the port's copies of the generators to
the originals); `mixed` is the port's snapshot, which the JAX encoder reads
as it is.  Names, resources, scales and the numeric fields must be equal;
vocabulary-dependent fields (labels, taints, terms) are compared through
the static-feasibility masks they produce.  Tolerance: none.
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu.api import types as jt
from kubernetes_tpu.api.snapshot import encode_snapshot as jax_encode
from kubernetes_tpu.bench import workloads as jw
from kubernetes_tpu.ops import filters as jf
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.api.snapshot import Snapshot, decode_choices, encode_snapshot
from kubernetes_tpu_torch.bench import workloads as tw
from kubernetes_tpu_torch.ops import filters as tf

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
    (ja, _), (ta, _) = encoded
    assert ta.has_prefer_taints == bool(np.any(ja.node_taint_pref))
    assert ta.has_node_pref == bool(np.any(np.asarray(ja.pod_pref_terms) >= 0))


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


TERM = tt.PodAffinityTerm(topology_key=tt.LABEL_ZONE, label_selector=tt.LabelSelector.of(app="a"))
REFUSED = {
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
    "pvcs": lambda: Snapshot([_node()], [_pod(pvcs=("claim",))]),
    "resource-claims": lambda: Snapshot([_node()], [_pod(resource_claims=(tt.ResourceClaimRef("gpu"),))]),
    "attach-limit": lambda: Snapshot([_node(volume_attach_limit=4)], [_pod()]),
    "pod-group": lambda: Snapshot([_node()], [_pod(pod_group="g")]),
    "pod-groups": lambda: Snapshot([_node()], [_pod()], pod_groups={"g": tt.PodGroup("g", 2)}),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_unported_features_raise(case):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        encode_snapshot(REFUSED[case](), device="cpu")


def test_jax_typed_snapshot_encodes_the_same():
    """The encoder reads the object model by attribute, so a snapshot built
    from the JAX package's types encodes exactly like the port's own."""
    ja, jm = encode_snapshot(jw.heterogeneous(16, 40), device="cpu")
    ta, tm = encode_snapshot(tw.heterogeneous(16, 40), device="cpu")
    assert jm.pod_names == tm.pod_names
    for name in EXACT_FIELDS:
        assert torch.equal(getattr(ja, name), getattr(ta, name))
    assert jt.CPU == tt.CPU
