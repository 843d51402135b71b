"""Volumes and resource claims on the card: the card legs of
tests/test_torch_volumes.py, in a file that imports no JAX.

- ``DeltaEncoder("cuda").encode_device`` of a storage-carrying snapshot
  (SMOKE Config4S, heterogeneous_storage(500, 500); dra_small; a cluster
  with bound claim pods and attach limits) equals the CPU encode in every
  field;
- on SMOKE Config4S the per-pod, dense chunked and class-wave routes on
  the card (K1 + K2; K7 + K8; K3 + K4, K5 + K6) equal the plain routes on
  the CPU: choices, usage, ordinals and sweeps.

They skip without a card; on the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_volumes_card.py

Tolerance: none.
"""

import dataclasses

import pytest
import torch

from kubernetes_tpu_torch.api import types as t
from kubernetes_tpu_torch.api.delta import DeltaEncoder
from kubernetes_tpu_torch.bench import workloads as tw
from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, infer_score_config
from kubernetes_tpu_torch.ops.incremental import HoistCache
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SMOKE = (500, 500)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_volumes_card.py")
    return torch.device("cuda")


def _bound_claims():
    """heterogeneous_storage's small cousin with bound pods that hold claims
    (a static PV's zone, the attach count) and a device claim on a slice."""
    from kubernetes_tpu_torch.api.cluster import DeviceClass, DeviceSelector, DraDevice, ResourceSlice

    snap = tw.heterogeneous_storage(60, 120, seed=3)
    snap.resource_slices = [ResourceSlice(name="s", node_name="node-4", devices=tuple(
        DraDevice(f"d{k}", attributes=(("type", "gpu"),)) for k in range(3)))]
    snap.device_classes = {"gpu": DeviceClass(name="gpu", selector=DeviceSelector(terms=(("type", "gpu"),)))}
    claim = (t.ResourceClaimRef("gpu"),)
    snap.bound_pods = [dataclasses.replace(p, node_name=f"node-{i}", uid="",
                                           resource_claims=claim if i == 4 else p.resource_claims)
                       for i, p in enumerate(snap.pending_pods[:8])]
    snap.pending_pods = snap.pending_pods[8:]
    return snap


SNAPSHOTS = {
    "config4s-smoke": lambda: tw.heterogeneous_storage(*SMOKE),
    "dra-small": tw.dra_small,
    "bound-claims": _bound_claims,
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SNAPSHOTS))
def test_encode_device_on_the_card_equals_the_cpu_encode(card, case):
    snap = SNAPSHOTS[case]()
    got, gm = DeltaEncoder(card).encode_device(snap)
    want, wm = DeltaEncoder("cpu").encode_device(snap)
    assert gm.pod_names == wm.pod_names and gm.resources == wm.resources
    for name in type(got).FIELDS:
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["perpod", "dense", "waves"])
def test_card_routes_equal_the_plain_routes(card, route):
    snap = tw.heterogeneous_storage(*SMOKE)
    out = []
    for device in (card, "cpu"):
        arr, meta = DeltaEncoder(device).encode_device(snap)
        cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
        inc = HoistCache().ensure(arr, meta, cfg) if route == "waves" else None
        kw = {} if route == "waves" else dict(chunked=route == "dense")
        out.append([x.cpu() if torch.is_tensor(x) else x
                    for x in assign.schedule_batch_ordinals(arr, cfg, device=device, inc=inc, **kw)])
    for a, b in zip(*out):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b
