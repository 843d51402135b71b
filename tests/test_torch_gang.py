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
  fixpoint and the host fixpoint; off the dense route too
  (``chunked=True``, the JAX package's KTPU_FORCE_CHUNKED=1): on the
  port's contended batches (bench/workloads.py gang_contended: the rounds
  route with pairwise stages and fit-only at P = 64, the per-pod route at
  P = 8 fit-only and with the full stage set, each revoking groups) and on
  tests/test_gang.py's eight random draws (P = 8, 16, 32), each against
  the JAX device and host fixpoints;
- ``gang_quorum_plain`` agrees with ``failed_groups`` and revokes the
  group of the earliest pod of a failed group.

The ``cuda`` legs import no JAX and skip without a card: kernel K13 ==
gang_quorum_plain on random groups; every gated kernel (K1, K2, K11, K12)
== its plain version with ``done`` clear and writes nothing with it set;
and the device loop on every route (the dense route's K7 + K8 + K13, the
rounds route's K7 + K12 + K13, the per-pod routes' K1 + K2 + K13 and K7 +
K11 + K13, each queued G + 1 times, K10 once where a score plane is on,
nothing read back between them) == the host fixpoint and the plain loop:

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
import torch_gang_unpack_cases as qc
from torch_preempt_reference import to_port
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.api.delta import DeltaEncoder
from kubernetes_tpu_torch.api.snapshot import encode_snapshot
from kubernetes_tpu_torch.bench import workloads as tw
from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, bitplane, gang, infer_score_config, kernels
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


def _quorum_inputs(case):
    """A K13 input set: _random_groups(seed) for an int, else the named
    shape of tests/torch_gang_unpack_cases.py (more groups than a block's
    share, G = P, ragged P, a group across two blocks' slices, the first
    failing pod in the last slice, -1 groups and clear pv mixed in, config
    5's shape with and without a failing group, more groups than P, more
    than the cluster's shared memory holds)."""
    if isinstance(case, int):
        return _random_groups(case)
    return tuple(torch.from_numpy(x) for x in qc.quorum_case(case))


QUORUM_SHAPES = [0, 1, 2, 3, *qc.QUORUM_CASES]


@pytest.mark.parametrize("seed", QUORUM_SHAPES)
def test_gang_quorum_plain_revokes_the_earliest_failed_group(seed):
    """gang_quorum_plain == the port's failed_groups == the JAX package's
    failed_groups (its gang.py:33) and its revocation (gang.py:103-107:
    np.argmax over in_bad, the first pod's group leaves pod_valid)."""
    from kubernetes_tpu.ops.gang import failed_groups as jax_failed_groups

    choices, pod_group, pv, group_min = _quorum_inputs(seed)
    sched, present, bad, first, pv_next, done = gang.gang_quorum_plain(choices, pod_group, pv, group_min)
    want_bad = gang.failed_groups(choices.numpy(), pod_group.numpy(), group_min.numpy(), active=pv.numpy())
    np.testing.assert_array_equal(bad.numpy(), want_bad)
    assert done == (not want_bad.any())
    jbad, jfirst, jpv, jdone = qc.jax_rule(choices.numpy(), pod_group.numpy(), pv.numpy(), group_min.numpy(),
                                           jax_failed_groups)
    np.testing.assert_array_equal(bad.numpy(), jbad)
    assert done == jdone and int(first) == jfirst
    np.testing.assert_array_equal(pv_next.numpy(), jpv)
    if done:
        assert int(first) == -1 and torch.equal(pv_next, pv)
        return
    in_bad = want_bad[np.maximum(pod_group.numpy(), 0)] & (pod_group.numpy() >= 0) & pv.numpy()
    f = int(np.flatnonzero(in_bad)[0])
    assert int(first) == f
    np.testing.assert_array_equal(pv_next.numpy(), pv.numpy() & (pod_group.numpy() != pod_group.numpy()[f]))


@pytest.mark.parametrize("mode", ["card", "one-block", "16-blocks", "global-counters"])
@pytest.mark.parametrize("case", QUORUM_SHAPES)
def test_gang_quorum_replay_matches_plain_and_jax(case, mode):
    """K13's index logic (tests/torch_gang_unpack_cases.py replay_quorum:
    the pod slices, the group owners, the runs, the warp's combined last
    runs, the judgement, the revocation) == gang_quorum_plain == the JAX
    package's rule, at the cluster csrc/gang.cu chooses and at forced
    widths and counter places; every pod lies in one slice."""
    from kubernetes_tpu.ops.gang import failed_groups as jax_failed_groups

    choices, pod_group, pv, group_min = (x.numpy() for x in _quorum_inputs(case))
    P, G = pod_group.shape[0], group_min.shape[0]
    kc, gm, gs, chunk = qc.quorum_cluster(P, G)
    kc, gm = {"card": (kc, gm), "one-block": (1, 8 * G > qc.Q_SMEM_CAP), "16-blocks": (16, 8 * -(-G // 16) > qc.Q_SMEM_CAP),
              "global-counters": (kc, True)}[mode]
    r = qc.replay_quorum(choices, pod_group, pv, group_min, kc, gm)
    assert sum(hi - lo for lo, hi, _, _ in r["slices"]) == P
    want = gang.gang_quorum_plain(*(torch.from_numpy(x) for x in (choices, pod_group, pv, group_min)))
    for k, w in zip(("sched", "present", "bad"), want[:3]):
        np.testing.assert_array_equal(r[k], w.numpy(), err_msg=k)
    assert r["first"] == int(want[3]) and r["done"] == want[5]
    np.testing.assert_array_equal(r["pv"], want[4].numpy())
    jbad, jfirst, jpv, _ = qc.jax_rule(choices, pod_group, pv, group_min, jax_failed_groups)
    np.testing.assert_array_equal(r["bad"], jbad)
    assert r["first"] == jfirst
    np.testing.assert_array_equal(r["pv"], jpv)


def test_gang_quorum_cluster_choice():
    """csrc/gang.cu's cluster choice as the replay reads it: one unit of 4
    pods a thread up to 16 blocks (config 5: 16 blocks of 4096 pods, 63
    groups a block), more blocks where the counters need the shared memory,
    the global scratch past 16 blocks' worth, the widest cluster the card
    schedules below that; and the replay's constants are the source's."""
    assert qc.source_constants() == dict(Q_NT=qc.Q_NT, Q_UNIT=qc.Q_UNIT, Q_MAX_KC=qc.Q_MAX_KC,
                                         Q_SMEM_CAP=qc.Q_SMEM_CAP, U_NT=qc.U_NT, U_BATCH_HALVES=qc.U_BATCH_HALVES)
    assert qc.quorum_cluster(65536, 1000) == (16, False, 63, 4096)
    assert qc.quorum_cluster(3072, 48) == (1, False, 48, 3072)
    assert qc.quorum_cluster(7, 1) == (1, False, 1, 8)
    assert qc.quorum_cluster(4000, 40000)[:2] == (2, False)
    assert qc.quorum_cluster(9000, 470000)[:2] == (3, True)
    assert qc.quorum_cluster(65536, 1000, fits=lambda k: k <= 8) == (8, False, 125, 8192)
    assert kernels.QUORUM_CLUSTER == qc.Q_MAX_KC


@pytest.mark.parametrize("seed", range(3))
def test_iteration_count_after_the_loop(seed):
    """gang._iterations, the count the card loop queues after its
    iterations: 1 + the groups whose pods left pod_valid, whichever groups
    were revoked (on the card, chip_smoke's [gang-rounds] fails if the
    enqueue waits for the card)."""
    arr, _ = encode_snapshot(_snap("gang-16x16-tight"), device="cpu")
    G = arr.group_min.shape[0]
    revoked = torch.randperm(G, generator=torch.Generator().manual_seed(seed))[:seed * 2 + 1]
    pv = arr.pod_valid & ~torch.isin(arr.pod_group, revoked.to(arr.pod_group.dtype))
    assert int(gang._iterations(arr, pv)) == 1 + revoked.numel()
    assert int(gang._iterations(arr, arr.pod_valid)) == 1


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


_ROUTE_OF = {"rounds-pairwise": "rounds", "rounds-fit": "rounds", "perpod-fit": "perpod-fit",
             "perpod-full": "perpod-full"}


def _jax_equal(jax_ref, name, c, u, kind="device"):
    np.testing.assert_array_equal(c.numpy(), jax_ref[f"{name}/{kind}_choices"])
    np.testing.assert_array_equal(u.numpy(), jax_ref[f"{name}/{kind}_used"])


_SCALED = [*ref.CONTENDED, *(f"scale-{n}" for n in ref.AT_SCALE)]


def _contended(name):
    """gang_contended(name), or for "scale-<name>" the same batch pinned to
    a pool of config 3's 5000 nodes (gang_pinned)."""
    base = name.removeprefix("scale-")
    return base, (tw.gang_contended(base) if base == name else tw.gang_pinned(base))


@pytest.mark.parametrize("name", _SCALED)
def test_device_fixpoint_off_the_dense_route_matches_jax(name, jax_ref):
    """The plain device fixpoint on the rounds and per-pod routes (chunked=
    True routes as the JAX package's KTPU_FORCE_CHUNKED=1) == the JAX
    gang_fixpoint_device and host fixpoint, exactly; the batch revokes
    groups, so more than one iteration runs.  The scale- batches are the
    sidecar's wave sizes (P = 64 and 8) against 5000 nodes (N = 6144)."""
    base, snap = _contended(name)
    arr, _ = encode_snapshot(snap, device="cpu")
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    stats = {}
    c, u = gang.gang_fixpoint_device(arr, cfg, device="cpu", stats=stats, chunked=True)
    assert stats["route"] == _ROUTE_OF[base] and stats["iterations"] == tw.GANG_CONTENDED_WANT[base][1] > 1, stats
    assert assign.fit_only(cfg, arr) == ("fit" in base)
    assert arr.N == (6144 if base != name else 8), arr.N
    _jax_equal(jax_ref, name, c, u)
    _jax_equal(jax_ref, name, c, u, "host")
    hc, hu = gang.schedule_with_gangs(arr, cfg, device="cpu", chunked=True)
    assert torch.equal(c, hc) and torch.equal(u, hu)


@pytest.mark.parametrize("seed", sorted(ref.RANDOM.values()))
def test_device_fixpoint_matches_host_loop(seed, jax_ref):
    """tests/test_gang.py's eight random gang draws (P = 8, 16 or 32 after
    bucketing: the per-pod and rounds routes): the plain device fixpoint ==
    the JAX device fixpoint == the JAX host loop, and the port's per-pod
    route and host loop give the same."""
    name = f"random-{seed}"
    arr, _ = encode_snapshot(to_port(ref.random_gang(seed)), device="cpu")
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    stats = {}
    c, u = gang.gang_fixpoint_device(arr, cfg, device="cpu", stats=stats, chunked=True)
    assert stats["route"] == ("perpod-fit" if arr.P == 8 else "rounds"), (arr.P, stats)
    _jax_equal(jax_ref, name, c, u)
    _jax_equal(jax_ref, name, c, u, "host")
    pc, pu = gang.gang_fixpoint_device(arr, cfg, device="cpu", chunked=False)
    hc, hu = gang.schedule_with_gangs(arr, cfg, device="cpu", chunked=True)
    assert torch.equal(c, pc) and torch.equal(u, pu) and torch.equal(c, hc) and torch.equal(u, hu)


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


def _card_quorum_inputs(card, case):
    if isinstance(case, int):
        return tuple(x.to(card) for x in _random_groups(case, P=5000, G=300 + case))
    return tuple(x.to(card) for x in _quorum_inputs(case))


def _quorum_equal(got, want, pv_k):
    sched, present, bad, first, done = got
    assert torch.equal(sched, want[0]) and torch.equal(present, want[1]) and torch.equal(bad, want[2])
    assert torch.equal(first, want[3]) and torch.equal(pv_k, want[4]) and bool(done.item()) == want[5]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [*range(6), *qc.QUORUM_CASES])
def test_gang_quorum_kernel_matches_plain(card, seed):
    """K13 == gang_quorum_plain on random groups and on every named shape
    of tests/torch_gang_unpack_cases.py (more groups than a block's share,
    G = P, ragged P, a group across two blocks' slices, the first failing
    pod in the last slice, -1 groups and clear pv, config 5's shape with
    and without a failing group, the counters in the global scratch), at
    the cluster the replay predicts; a set done word writes nothing."""
    choices, pod_group, pv, group_min = _card_quorum_inputs(card, seed)
    want = gang.gang_quorum_plain(choices, pod_group, pv, group_min)
    pv_k = pv.clone()
    got = kernels.gang_quorum(choices, pod_group, pv_k, group_min)
    _quorum_equal(got, want, pv_k)
    assert kernels.LAST_CLUSTER["gang_quorum"] == qc.quorum_cluster(pv.shape[0], group_min.shape[0])[0]
    # a set done word gates the launch: nothing moves
    done = got[4]
    pv_again = pv_k.clone()
    before = [t.clone() for t in got[:4]]
    done.fill_(1)
    kernels.gang_quorum(choices, pod_group, pv_again, group_min, done=done,
                        out=kernels.QuorumOut(*got[:4], torch.empty((2, group_min.shape[0]), dtype=torch.int32,
                                                                    device=card)))
    assert torch.equal(pv_again, pv_k) and int(done.item()) == 1
    assert all(torch.equal(a, b) for a, b in zip(before, got[:4]))


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 5, 8, 16])
@pytest.mark.parametrize("case", ["config5-revoke", "groups-5000", "ragged-4999", "straddle"])
def test_gang_quorum_kernel_cluster_caps(card, case, cluster):
    """K13 capped at 1..16 blocks (fewer blocks: more units a thread, more
    groups a block) == plain."""
    choices, pod_group, pv, group_min = _card_quorum_inputs(card, case)
    want = gang.gang_quorum_plain(choices, pod_group, pv, group_min)
    pv_k = pv.clone()
    _quorum_equal(kernels.gang_quorum(choices, pod_group, pv_k, group_min, cluster=cluster), want, pv_k)
    assert 1 <= kernels.LAST_CLUSTER["gang_quorum"] <= cluster


@pytest.mark.cuda
def test_gang_quorum_out_reused(card):
    """The fixpoint's use: the same out buffers and done word over three
    calls (config 5's shape with groups G/2 and G-1 failing: the first
    call revokes G/2, the second G-1, the third finds none and sets done),
    each == plain on the previous pv, no tensor allocated by any call; a
    fourth, gated, writes nothing."""
    choices, pod_group, pv, group_min = _card_quorum_inputs(card, "config5-revoke")
    G = group_min.shape[0]
    out = kernels.gang_quorum_out(G, card)
    done = torch.zeros((1,), dtype=torch.int32, device=card)
    pv_k = pv.clone()
    kernels.gang_quorum(choices, pod_group, pv_k.clone(), group_min, done=torch.zeros_like(done), out=out)
    firsts = []
    for _ in range(3):
        want = gang.gang_quorum_plain(choices, pod_group, pv_k.clone(), group_min)
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        got = kernels.gang_quorum(choices, pod_group, pv_k, group_min, done=done, out=out)
        assert torch.cuda.memory_stats()["allocation.all.allocated"] == before
        _quorum_equal(got, want, pv_k)
        firsts.append(int(got[3]))
    assert firsts[2] == -1 and int(done.item()) == 1
    assert {int(pod_group[firsts[0]]), int(pod_group[firsts[1]])} == {G // 2, G - 1}
    before = [t.clone() for t in (out.sched, out.present, out.bad, out.first, pv_k)]
    kernels.gang_quorum(choices, pod_group, pv_k, group_min, done=done, out=out)
    assert all(torch.equal(a, b) for a, b in zip(before, (out.sched, out.present, out.bad, out.first, pv_k)))


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


# ---------------------------------------------------------------------------
# on the card: the gated kernels, and the device loop on every route
# ---------------------------------------------------------------------------

GATED_KERNELS = ["packed_static_rows", "chunk_rounds_dense", "gang_quorum", "static_feasible", "fit_scan",
                 "score_planes", "full_scan", "rounds"]


@pytest.fixture
def gcard():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card: python -m pytest --noconftest "
                    "-m cuda tests/test_torch_gang.py")
    kernels.build(GATED_KERNELS)
    return torch.device("cuda")


def _snapshot(card, snap):
    arr, _ = encode_snapshot(snap, device=card)
    return arr, infer_score_config(arr, DEFAULT_SCORE_CONFIG)


def _unchanged(before, after):
    return all(torch.equal(a, b) for a, b in zip(before, after))


@pytest.mark.cuda
def test_gated_per_pod_fit_kernels(gcard):
    """K1 static_feasible and K2 fit_scan: with `done` clear (and the gated
    mode's buffers) == their plain versions; with it set nothing is
    written."""
    from kubernetes_tpu_torch.ops import filters

    arr, cfg = _snapshot(gcard, tw.gang_contended("rounds-fit"))
    done = torch.zeros((1,), dtype=torch.int32, device=gcard)
    sf = torch.zeros((arr.P, arr.N), dtype=torch.bool, device=gcard)
    kernels.static_feasible(arr, done=done, out=sf)
    assert torch.equal(sf, filters.static_feasible_plain(arr))
    fo = kernels.fit_scan_out(arr, cfg)
    ck, uk, _ = kernels.fit_scan(sf, arr, cfg, done=done, out=fo)
    cp, up = assign.schedule_scan_plain(arr, cfg, sf=sf)
    assert torch.equal(ck, cp) and torch.equal(uk, up)
    assert torch.equal(kernels.fit_scan(sf, arr, cfg)[1], up)  # the ungated launch is unchanged
    done.fill_(1)
    before = (sf.clone(), fo.choices.clone(), fo.used_t.clone(), fo.n_scored.clone())
    kernels.static_feasible(dataclasses.replace(arr, pod_valid=torch.zeros_like(arr.pod_valid)), done=done, out=sf)
    kernels.fit_scan(sf, dataclasses.replace(arr, node_used=torch.zeros_like(arr.node_used)), cfg, done=done,
                     out=fo)
    assert _unchanged(before, (sf, fo.choices, fo.used_t, fo.n_scored))


@pytest.mark.cuda
@pytest.mark.parametrize("scan", ["full_scan", "rounds"])
def test_gated_full_stage_kernels(gcard, scan):
    """K11 full_scan and K12 rounds in the gated mode: with `done` clear ==
    their plain versions (choices, usage, ordinals, sweeps, the count
    state), twice over the same buffers (each launch copies its start
    state itself); with it set nothing is written."""
    arr, cfg = _snapshot(gcard, tw.gang_contended("rounds-pairwise"))
    sfs, eligs = kernels.packed_static_rows(arr, with_elig=True)
    planes = assign.score_planes(arr, cfg)
    done = torch.zeros((1,), dtype=torch.int32, device=gcard)
    so = kernels.scan_out(arr, assign.RCHUNK if scan == "rounds" else None)
    for _ in range(2):
        if scan == "rounds":
            kc, ku, ko, ks, kst = kernels.rounds(arr, cfg, sfs, eligs, planes, with_state=True, done=done, out=so)
            pc, pu, po, ps, pst = assign.schedule_scan_rounds_plain(arr, cfg, sfs, eligs, planes, with_state=True)
            assert torch.equal(ko, po) and int(ks[0]) == ps and int(ks[1]) == 0
        else:
            kc, ku, kst = kernels.full_scan(arr, cfg, sfs, eligs, planes, with_state=True, done=done, out=so)
            pc, pu, pst = assign.schedule_scan_plain(arr, cfg, sf=bitplane.unpack(sfs, arr.N), planes=planes,
                                                     with_state=True)
        assert torch.equal(kc, pc) and torch.equal(ku, pu)
        assert all(torch.equal(kst[k], pst[k]) for k in ("cnt", "anti", "pref", "total", "ports"))
    done.fill_(1)
    before = [so.choices.clone(), so.ordinals.clone(), so.scal.clone(), *(v.clone() for v in so.state.values())]
    gated = dataclasses.replace(arr, pod_valid=torch.zeros_like(arr.pod_valid))
    if scan == "rounds":
        kernels.rounds(gated, cfg, sfs, eligs, planes, done=done, out=so)
    else:
        kernels.full_scan(gated, cfg, sfs, eligs, planes, done=done, out=so)
    assert _unchanged(before, [so.choices, so.ordinals, so.scal, *so.state.values()])


def _route_kernels(route, arr, cfg):
    k10 = 1 if (cfg.enable_taint_score or cfg.enable_node_pref) else 0
    return {"dense": {"packed_static_rows": 1, "chunk_rounds_dense": 1},
            "rounds": {"packed_static_rows": 1, "rounds": 1},
            "perpod-fit": {"static_feasible": 1, "fit_scan": 1},
            "perpod-full": {"packed_static_rows": 1, "full_scan": 1}}[route], k10


def _loop_on_card(card, snap, chunked=None):
    """The device loop on the card, counted: exactly G + 1 launches of each
    of its route's kernels and of K13 (K10 once where a score plane is on),
    == the plain loop on the CPU over the same route and == the host
    fixpoint; returns the route."""
    arr, cfg = _snapshot(card, snap)
    G = arr.group_min.shape[0]
    kernels.reset_launches()
    stats = {}
    dc, du = gang.gang_fixpoint_device(arr, cfg, stats=stats, chunked=chunked)
    per_iter, k10 = _route_kernels(stats["route"], arr, cfg)
    want = {k: G + 1 for k in per_iter}
    want["gang_quorum"] = G + 1
    if k10:
        want["score_planes"] = k10
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == want
    cpu = arr.to(torch.device("cpu"))
    pstats = {}
    pc, pu = gang.gang_fixpoint_device(cpu, cfg, device="cpu", stats=pstats,
                                       chunked=True if chunked is None else chunked)
    assert pstats["route"] == stats["route"] and pstats["iterations"] == stats["iterations"]
    assert torch.equal(dc.cpu(), pc) and torch.equal(du.cpu(), pu)
    hc, hu = gang.schedule_with_gangs(arr, cfg, chunked=chunked)
    assert torch.equal(dc, hc) and torch.equal(du, hu)
    return stats["route"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", _SCALED)
def test_device_loop_on_every_route(gcard, name):
    base, snap = _contended(name)
    assert _loop_on_card(gcard, snap) == _ROUTE_OF[base]


@pytest.mark.cuda
@pytest.mark.parametrize("chunked,route", [(None, "rounds"), (False, "perpod-full")])
def test_device_loop_with_score_planes(gcard, chunked, route):
    """all_stages() in PodGroups of 64 (every optional stage on): K10 runs
    once before the loop, on the rounds and the per-pod route."""
    assert _loop_on_card(gcard, tw.grouped(tw.all_stages(), 64), chunked) == route
