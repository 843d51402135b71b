"""Gangs (all-or-nothing PodGroups, BASELINE config 5) in the port against
the JAX package and the serial oracle.

On the CPU, on tests/torch_gang_reference.py's gang draws (24 groups of 8
on 12 nodes, all placed; 16 groups of 16 on 3 nodes, five revoked), the JAX
side in a fresh process with KTPU_FORCE_CHUNKED=1:

- the encoder's pod_group / group_min and class index equal the JAX
  encoder's, and over a churn of waves (a group's minMember changed, a
  group added, a group without a PodGroup, groups gone) the port's
  DeltaEncoder follows the JAX DeltaEncoder field for field;
- ``schedule_with_gangs`` with ordinals, on the port's HoistCache class
  state (the class-wave route) and without it (the dense chunked route,
  chunked=True), equals the JAX host fixpoint's choices, usage, ordinals
  and summed sweeps; on the per-pod route (the CPU default) its decisions;
  every decision equals oracle_schedule_with_gangs';
- ``gang_fixpoint_device`` (its plain version) equals the JAX device
  fixpoint and the host fixpoint;
- ``gang_quorum_plain`` agrees with ``failed_groups`` and revokes the
  group of the earliest pod of a failed group.

The ``cuda`` legs import no JAX and skip without a card: kernel K13 ==
gang_quorum_plain on random groups, and the device loop (K7 + K8 + K13
queued G + 1 times, nothing read back between them) == the host fixpoint:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_gang.py

Tolerance: none.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_gang_reference as ref
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.api.delta import DeltaEncoder
from kubernetes_tpu_torch.api.snapshot import encode_snapshot
from kubernetes_tpu_torch.bench import workloads as tw
from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, gang, infer_score_config, kernels
from kubernetes_tpu_torch.ops.incremental import HoistCache
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parent.parent
NAMES = sorted(ref.SNAPSHOTS)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("gang") / "ref.npz"
    subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_gang_reference.py"), str(out)],
        env={**os.environ, **ref.PINNED, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT)},
        cwd=ROOT, check=True, timeout=900,
    )
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


def _snap(name):
    g, s, n, seed = ref.SNAPSHOTS[name]
    return tw.gang(g, s, n, seed=seed)


_PORT = {}


def port(name):
    if name not in _PORT:
        snap = _snap(name)
        arr, meta = encode_snapshot(snap, device="cpu")
        _PORT[name] = (snap, arr, meta, infer_score_config(arr, DEFAULT_SCORE_CONFIG))
    return _PORT[name]


def _oracle_equal(name, meta, choices):
    """The decisions equal oracle_schedule_with_gangs' on the JAX package's
    own copy of the same draw."""
    from kubernetes_tpu.bench import workloads as jw
    from kubernetes_tpu.oracle.reference import oracle_schedule_with_gangs

    g, s, n, seed = ref.SNAPSHOTS[name]
    got = [(meta.pod_names[k], meta.node_names[int(choices[k])] if choices[k] >= 0 else None)
           for k in range(meta.n_pods)]
    return got == oracle_schedule_with_gangs(jw.gang(g, s, n, seed=seed))


@pytest.mark.parametrize("name", NAMES)
def test_encoder_gang_fields_match_jax(name, jax_ref):
    _, arr, meta, cfg = port(name)
    np.testing.assert_array_equal(arr.pod_group.numpy(), jax_ref[f"{name}/pod_group"])
    np.testing.assert_array_equal(arr.group_min.numpy(), jax_ref[f"{name}/group_min"])
    np.testing.assert_array_equal(meta.pod_class, jax_ref[f"{name}/pod_class"])
    assert assign.fit_only(cfg, arr) and assign._chunkable(arr, cfg)


def _churn_waves():
    """A gang wave, then: a minMember changed, a group added, a group with
    no PodGroup (it needs all its pods), every group gone, the first wave
    again."""
    base = tw.gang(6, 4, 5, seed=2)
    groups = dict(base.pod_groups)
    extra = [tt.Pod(name=f"job-x-w{m}", labels={"job": "job-x"}, requests={tt.CPU: 700}, pod_group="job-x")
             for m in range(3)]
    loose = [tt.Pod(name=f"loose-w{m}", requests={tt.CPU: 300}, pod_group="loose") for m in range(2)]
    return [
        base,
        dataclasses.replace(base, pod_groups={**groups, "job-1": tt.PodGroup("job-1", 2)}),
        dataclasses.replace(base, pending_pods=base.pending_pods + extra,
                            pod_groups={**groups, "job-x": tt.PodGroup("job-x", 3)}),
        dataclasses.replace(base, pending_pods=base.pending_pods + loose),
        dataclasses.replace(base, pending_pods=[dataclasses.replace(p, pod_group="") for p in base.pending_pods],
                            pod_groups={}),
        base,
    ]


def test_delta_encoder_gang_fields_over_churn():
    from kubernetes_tpu.api import types as jt
    from kubernetes_tpu.api.delta import DeltaEncoder as JaxDeltaEncoder
    from kubernetes_tpu.api.snapshot import Snapshot as JaxSnapshot

    waves = _churn_waves()
    nodes = [jt.Node(name=n.name, allocatable=dict(n.allocatable), labels=dict(n.labels)) for n in waves[0].nodes]

    def to_jax(snap):  # the same node objects every wave, as the port's waves share theirs
        def pod(p):
            return jt.Pod(name=p.name, labels=dict(p.labels), requests=dict(p.requests), pod_group=p.pod_group,
                          priority=p.priority)
        return JaxSnapshot(nodes=nodes, pending_pods=[pod(p) for p in snap.pending_pods],
                           pod_groups={k: jt.PodGroup(v.name, v.min_member) for k, v in snap.pod_groups.items()})

    tenc, jenc = DeltaEncoder("cpu"), JaxDeltaEncoder()
    for snap in waves:
        ta, tm = tenc.encode(snap)
        ja, jm = jenc.encode(to_jax(snap))
        for field in ("pod_group", "group_min", "pod_valid", "pod_req"):
            np.testing.assert_array_equal(np.asarray(getattr(ta, field)), np.asarray(getattr(ja, field)),
                                          err_msg=field)
        np.testing.assert_array_equal(tm.pod_class, np.asarray(jm.pod_class))
    assert tenc.stats == jenc.stats and tenc.stats["delta"] == len(waves) - 1


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("mode", ["inc", "dense"])
def test_host_fixpoint_matches_jax_and_oracle(name, mode, jax_ref):
    _, arr, meta, cfg = port(name)
    if mode == "inc":
        inc = HoistCache().ensure(arr, meta, cfg)
        assert assign.inc_applicable(arr, cfg, inc) is inc
        assign.reset_trace_counts()
        c, u, o, s = gang.schedule_with_gangs(arr, cfg, with_ordinals=True, inc=inc, device="cpu")
        assert assign.TRACE_COUNTS["chunked_inc"] >= 1 and assign.TRACE_COUNTS["chunked"] == 0
    else:
        c, u, o, s = gang.schedule_with_gangs(arr, cfg, with_ordinals=True, device="cpu", chunked=True)
    np.testing.assert_array_equal(c.numpy(), jax_ref[f"{name}/{mode}_choices"])
    np.testing.assert_array_equal(u.numpy(), jax_ref[f"{name}/{mode}_used"])
    np.testing.assert_array_equal(o.numpy(), jax_ref[f"{name}/{mode}_ordinals"])
    assert s == int(jax_ref[f"{name}/{mode}_sweeps"])
    assert _oracle_equal(name, meta, c.numpy())


@pytest.mark.parametrize("name", NAMES)
def test_device_fixpoint_matches_jax(name, jax_ref):
    _, arr, meta, cfg = port(name)
    c, u = gang.gang_fixpoint_device(arr, cfg, device="cpu")
    np.testing.assert_array_equal(c.numpy(), jax_ref[f"{name}/device_choices"])
    np.testing.assert_array_equal(u.numpy(), jax_ref[f"{name}/device_used"])
    hc, hu = gang.schedule_with_gangs(arr, cfg, device="cpu")  # the per-pod route: decisions alike
    assert torch.equal(c, hc) and torch.equal(u, hu)


def _random_groups(seed, P=300, G=17):
    g = torch.Generator().manual_seed(seed)
    pod_group = torch.randint(-1, G, (P,), generator=g, dtype=torch.int32)
    pv = torch.rand(P, generator=g) < 0.9
    choices = torch.where(torch.rand(P, generator=g) < 0.7, torch.randint(0, 40, (P,), generator=g), -1)
    group_min = torch.randint(1, 20, (G,), generator=g, dtype=torch.int32)
    return choices.to(torch.int32), pod_group, pv, group_min


@pytest.mark.parametrize("seed", range(4))
def test_gang_quorum_plain_revokes_the_earliest_failed_group(seed):
    choices, pod_group, pv, group_min = _random_groups(seed)
    sched, present, bad, first, pv_next, done = gang.gang_quorum_plain(choices, pod_group, pv, group_min)
    want_bad = gang.failed_groups(choices.numpy(), pod_group.numpy(), group_min.numpy(), active=pv.numpy())
    np.testing.assert_array_equal(bad.numpy(), want_bad)
    assert done == (not want_bad.any())
    if done:
        assert int(first) == -1 and torch.equal(pv_next, pv)
        return
    in_bad = want_bad[np.maximum(pod_group.numpy(), 0)] & (pod_group.numpy() >= 0) & pv.numpy()
    f = int(np.flatnonzero(in_bad)[0])
    assert int(first) == f
    np.testing.assert_array_equal(pv_next.numpy(), pv.numpy() & (pod_group.numpy() != pod_group.numpy()[f]))


def _no_groups(arr):
    """The arrays with no PodGroup at all: G = 0 (the encoder pads to G = 1)."""
    return dataclasses.replace(arr, pod_group=torch.full_like(arr.pod_group, -1),
                               group_min=arr.group_min[:0].contiguous())


@pytest.mark.parametrize("n_pods", sorted(ref.NO_GROUPS.values()))
def test_device_fixpoint_without_groups_is_the_plain_step(jax_ref, n_pods):
    """G = 0: the plain batch step, as the JAX package's gang.py:136, and
    the JAX gang_fixpoint_device's choices and usage on the same batch."""
    arr, _ = encode_snapshot(tw.basic(24, n_pods, seed=n_pods), device="cpu")
    arr0 = _no_groups(arr)
    cfg = infer_score_config(arr0, DEFAULT_SCORE_CONFIG)
    stats = {}
    choices, used = gang.gang_fixpoint_device(arr0, cfg, device="cpu", stats=stats)
    want = assign.schedule_batch(arr0, cfg, device="cpu")
    assert torch.equal(choices, want[0]) and torch.equal(used, want[1]) and stats["iterations"] == 1
    np.testing.assert_array_equal(choices.numpy(), jax_ref[f"basic-{n_pods}/device_choices"])
    np.testing.assert_array_equal(used.numpy(), jax_ref[f"basic-{n_pods}/device_used"])


# ---------------------------------------------------------------------------
# on the card: K13 gang_quorum == plain, the device loop == the host fixpoint
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card: python -m pytest --noconftest "
                    "-m cuda tests/test_torch_gang.py")
    kernels.build(["packed_static_rows", "chunk_rounds_dense", "gang_quorum", "class_static_hoist",
                   "wave_commit", "chunk_rounds"])
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(6))
def test_gang_quorum_kernel_matches_plain(card, seed):
    choices, pod_group, pv, group_min = (x.to(card) for x in _random_groups(seed, P=5000, G=300 + seed))
    want = gang.gang_quorum_plain(choices, pod_group, pv, group_min)
    pv_k = pv.clone()
    sched, present, bad, first, done = kernels.gang_quorum(choices, pod_group, pv_k, group_min)
    assert torch.equal(sched, want[0]) and torch.equal(present, want[1]) and torch.equal(bad, want[2])
    assert torch.equal(first, want[3]) and torch.equal(pv_k, want[4]) and bool(done.item()) == want[5]
    # a set done word gates the launch: nothing moves
    pv_again = pv_k.clone()
    done.fill_(1)
    kernels.gang_quorum(choices, pod_group, pv_again, group_min, done=done)
    assert torch.equal(pv_again, pv_k) and int(done.item()) == 1


CARD_GANGS = {"gang-24x8": (24, 8, 12, 11), "gang-16x16-tight": (16, 16, 3, 1), "gang-48x64": (48, 64, 40, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_GANGS))
def test_device_loop_matches_host_fixpoint(card, name):
    g, s, n, seed = CARD_GANGS[name]
    arr, meta = encode_snapshot(tw.gang(g, s, n, seed=seed), device=card)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    inc = HoistCache().ensure(arr, meta, cfg)
    hc, hu, ho, hs = gang.schedule_with_gangs(arr, cfg, with_ordinals=True, inc=inc)
    kernels.reset_launches()
    dc, du = gang.gang_fixpoint_device(arr, cfg)
    G = arr.group_min.shape[0]
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {
        "packed_static_rows": G + 1, "chunk_rounds_dense": G + 1, "gang_quorum": G + 1}
    assert torch.equal(dc, hc) and torch.equal(du, hu)
    dense = gang.schedule_with_gangs(arr, cfg, with_ordinals=True)
    assert torch.equal(dense[0], hc) and torch.equal(dense[1], hu)


@pytest.mark.cuda
@pytest.mark.parametrize("n_pods", [50, 300])
def test_device_fixpoint_without_groups_on_the_card(card, n_pods):
    """G = 0 on the card: the plain step before any gang launch, on a
    chunkable batch (P = 512, the dense route) and on one that is not (P =
    64, the rounds route), which raised before."""
    arr, _ = encode_snapshot(tw.basic(24, n_pods, seed=n_pods), device=card)
    arr0 = _no_groups(arr)
    cfg = infer_score_config(arr0, DEFAULT_SCORE_CONFIG)
    kernels.reset_launches()
    choices, used = gang.gang_fixpoint_device(arr0, cfg)
    assert kernels.LAUNCHES["gang_quorum"] == 0
    want = assign.schedule_batch(arr0, cfg, device="cpu")
    assert torch.equal(choices.cpu(), want[0]) and torch.equal(used.cpu(), want[1])
