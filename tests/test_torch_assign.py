"""The port's schedule_batch on the CPU against the JAX package's
schedule_batch and the serial oracle, under all three fit strategies.

Two ways in: the port's own encoder, and the JAX encoder's arrays carried
across (from_jax_arrays), so a difference points at the encoder or at the
scan.  Choices and final node usage must be equal; the oracle's decoded
placements must be equal.  Tolerance: none.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

from helpers import random_cluster
from kubernetes_tpu.api.snapshot import encode_snapshot as jax_encode
from kubernetes_tpu.bench import workloads as jw
from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG as JAX_DEFAULT
from kubernetes_tpu.ops import infer_score_config as jax_infer
from kubernetes_tpu.ops import schedule_batch as jax_schedule
from kubernetes_tpu.oracle import oracle_schedule
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.api.snapshot import Snapshot, decode_choices, encode_snapshot
from kubernetes_tpu_torch.bench import workloads as tw
from kubernetes_tpu_torch.convert import from_jax_arrays
from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, infer_score_config, schedule_batch
from kubernetes_tpu_torch.ops.assign import schedule_scan_plain
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

STRATEGIES = {
    "least": ("LeastAllocated", ((0.0, 0.0), (100.0, 10.0))),
    "most": ("MostAllocated", ((0.0, 0.0), (100.0, 10.0))),
    "rtcr": ("RequestedToCapacityRatio", ((0.0, 10.0), (50.0, 2.0), (100.0, 0.0))),
}
SNAPSHOTS = {
    "mixed": tw.mixed,
    "mixed-seed7": lambda: tw.mixed(32, 180, seed=7),
    "heterogeneous": lambda: tw.heterogeneous(64, 256),
    "basic": lambda: tw.basic(100, 100),
    "random-selectors": lambda: random_cluster(
        random.Random(5), n_nodes=16, n_pods=60, with_taints=False, with_selectors=True),
}


def _cfgs(strategy):
    name, shape = STRATEGIES[strategy]
    return (dataclasses.replace(JAX_DEFAULT, fit_strategy=name, rtcr_shape=shape),
            dataclasses.replace(DEFAULT_SCORE_CONFIG, fit_strategy=name, rtcr_shape=shape))


@pytest.fixture(scope="module", params=sorted(SNAPSHOTS))
def snap(request):
    return SNAPSHOTS[request.param]()


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_port_encoder_matches_jax_and_oracle(snap, strategy):
    jcfg0, tcfg0 = _cfgs(strategy)
    ja, jm = jax_encode(snap)
    jcfg = jax_infer(ja, jcfg0)
    jc, ju = (np.array(x) for x in jax_schedule(ja, jcfg))
    arr, meta = encode_snapshot(snap, device="cpu")
    tc, tu = schedule_batch(arr, infer_score_config(arr, tcfg0), device="cpu")
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(tu.numpy(), ju)
    placed = decode_choices(tc, meta)
    assert [(name, placed[name]) for name in meta.pod_names] == oracle_schedule(snap, jcfg)


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_jax_arrays_carried_across_match_jax(snap, strategy):
    jcfg0, tcfg0 = _cfgs(strategy)
    ja, _ = jax_encode(snap)
    jc, ju = (np.array(x) for x in jax_schedule(ja, jax_infer(ja, jcfg0)))
    arr = from_jax_arrays({f.name: np.asarray(getattr(ja, f.name)) for f in dataclasses.fields(ja)}, "cpu")
    tc, tu = schedule_batch(arr, infer_score_config(arr, tcfg0), device="cpu")
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(tu.numpy(), ju)


def test_prefix_of_the_scan_is_a_scan():
    arr, _ = encode_snapshot(tw.mixed(), device="cpu")
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    full, _ = schedule_scan_plain(arr, cfg)
    pre, _ = schedule_scan_plain(arr.pod_prefix(40), cfg)
    assert torch.equal(pre, full[:40])


def test_ties_go_to_the_lowest_node_index():
    nodes = [tt.Node(name=f"n{i}", allocatable={tt.CPU: 1000, tt.MEMORY: 2**30}) for i in range(6)]
    pods = [tt.Pod(name=f"p{i}", requests={tt.CPU: 100, tt.MEMORY: 2**20}) for i in range(8)]
    arr, meta = encode_snapshot(Snapshot(nodes, pods), device="cpu")
    choices, _ = schedule_batch(arr, infer_score_config(arr, DEFAULT_SCORE_CONFIG), device="cpu")
    # identical empty nodes: each pod takes the lowest-index emptiest node
    assert choices[: meta.n_pods].tolist() == [0, 1, 2, 3, 4, 5, 0, 1]


def test_pairwise_snapshot_raises():
    """A pairwise snapshot no longer raises: the port's encoder and the JAX
    arrays carried across both give the JAX package's decisions; arrays that
    carry a pod group no longer raise either: the gang fields carry across."""
    snap = jw.spread_affinity(12, 40)
    ja, _ = jax_encode(snap)
    jc, ju = (np.array(x) for x in jax_schedule(ja, jax_infer(ja, JAX_DEFAULT)))
    fields = {f.name: np.asarray(getattr(ja, f.name)) for f in dataclasses.fields(ja)}
    for arr in (encode_snapshot(snap, device="cpu")[0], from_jax_arrays(fields, "cpu")):
        tc, tu = schedule_batch(arr, infer_score_config(arr, DEFAULT_SCORE_CONFIG), device="cpu")
        np.testing.assert_array_equal(tc.numpy(), jc)
        np.testing.assert_array_equal(tu.numpy(), ju)
    fields["pod_group"] = np.where(np.arange(len(fields["pod_group"])) < 3, 0, -1).astype(np.int32)
    fields["group_min"] = np.array([3], dtype=np.int32)
    carried = from_jax_arrays(fields, "cpu")
    np.testing.assert_array_equal(carried.pod_group.numpy(), fields["pod_group"])
    np.testing.assert_array_equal(carried.group_min.numpy(), fields["group_min"])


@pytest.mark.parametrize("flag", ["enable_pairwise", "enable_ports", "enable_taint_score",
                                  "enable_node_pref", "enable_image"])
def test_unported_stage_raises(flag):
    """No stage raises any more: a stage forced on where the snapshot has no
    evidence for it runs, and decides as the JAX package's does with the
    same stage forced on."""
    snap = tw.basic(4, 4)
    arr, _ = encode_snapshot(snap, device="cpu")
    cfg = dataclasses.replace(infer_score_config(arr, DEFAULT_SCORE_CONFIG), **{flag: True})
    tc, tu = schedule_batch(arr, cfg, device="cpu")
    ja, _ = jax_encode(snap)
    jcfg = dataclasses.replace(jax_infer(ja, JAX_DEFAULT), **{flag: True})
    jc, ju = (np.array(x) for x in jax_schedule(ja, jcfg))
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(tu.numpy(), ju)


def test_prefer_taints_enable_the_unported_taint_stage():
    """A PreferNoSchedule taint makes infer_score_config enable the taint
    score stage, as in the JAX package, and the stage now runs: the pod
    avoids the tainted node while another fits."""
    nodes = [tt.Node(name=f"n{i}", allocatable={tt.CPU: 1000},
                     taints=(tt.Taint("soft", "x", tt.PREFER_NO_SCHEDULE),) if i == 0 else ()) for i in range(2)]
    arr, meta = encode_snapshot(Snapshot(nodes, [tt.Pod(name="p", requests={tt.CPU: 1})]), device="cpu")
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    assert cfg.enable_taint_score
    choices, _ = schedule_batch(arr, cfg, device="cpu")
    assert decode_choices(choices, meta) == {"p": "n1"}


def test_default_device_raises_without_cuda(monkeypatch):
    arr, _ = encode_snapshot(tw.basic(4, 4), device="cpu")
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        schedule_batch(arr, cfg)
