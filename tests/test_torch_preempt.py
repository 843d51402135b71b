"""Batched preemption (ops/preempt.py, scheduler/preemption.py) and the
failure path (bench/preempt_bench.py) in the port against the JAX package.

On the CPU:

- ``preempt_eval_wave`` and ``preempt_eval`` (their plain versions) equal
  the JAX functions on all seven outputs, exactly: the JAX encoder's arrays
  of random clusters with taints, selectors and pods pinned by node name,
  carried across (convert.from_jax_arrays), random victim tables with V in
  {1, 2, 8}, K in {1, 3, 64} preemptors, mixed has_nom and vict_viol, and
  priorities that are negative, zero and near INT32_MAX (vsum wraps);
  and over R in {1, 5, 16} resources (the same clusters with their resource
  columns rebuilt) at V in {1, 8}, with nodes that hold no valid victim;
- ``failure_cycle`` with the port's BatchedPreemption equals the same
  sequence with the JAX one (tests/torch_preempt_reference.py) on the same
  snapshot, PDBs and carried nominations: every decision (node and victims),
  the nominations, wave_hits and single_hits; with waves of 64, waves of 2
  (several waves of one priority, K padded) and waves off (_WAVE = 0, every
  evaluation single).  The scenarios: the JAX test's dirty-node repair
  (tests/test_preemption_batched.py:129), random clusters with PDB-violating
  victims, two priorities, node selectors, taints and a pinned preemptor,
  and the same with preemptors outside the batched gate (host ports,
  spread, anti-affinity; or an anti-affinity bound pod), which take the CPU
  PostFilter (scheduler/plugins/cpu.py DefaultPreemption) against the JAX
  one;
- ``failure_cycle`` on build(50, 12) gives the JAX Scheduler's Preempted
  nominations and surviving fillers (BatchedPreemption on, the first run
  of the JAX preempt_bench.py's _parity_cross_check);
- a preemptor outside the gate is served by the CPU PostFilter (it raised
  NotImplementedError before the CPU PostFilter was ported).

The ``cuda`` legs import no JAX and skip without a card: kernel K15
preempt_eval (with K3's static words) == the plain version on the port's
own encodings, also over R in {1, 4, 5, 16}, V in {1, 2, 8, 3}, K in {1, 7,
64, 65} on 300 nodes (N not a multiple of K15's node tile) with edge_tables'
wrapping sums, and failure_cycle on the card == on the CPU:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_preempt.py

Tolerance: none.
"""

import dataclasses
import random

import numpy as np
import pytest
import torch

import torch_preempt_reference as ref
from kubernetes_tpu_torch.api.snapshot import encode_snapshot
from kubernetes_tpu_torch.bench import preempt_bench as pb
from kubernetes_tpu_torch.bench import workloads as tw
from kubernetes_tpu_torch.convert import from_jax_arrays
from kubernetes_tpu_torch.ops import kernels
from kubernetes_tpu_torch.ops import preempt as tpre
from kubernetes_tpu_torch.scheduler.preemption import BatchedPreemption
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

PRIOS = np.array([-(2**31), -7, 0, 3, 1000, 2**31 - 9, 2**31 - 1], dtype=np.int64)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's side (imported here, not at module level, so the
    cuda legs run where JAX is not installed)."""
    pytest.importorskip("jax")
    import helpers
    from kubernetes_tpu.api import types as jt
    from kubernetes_tpu.api.delta import DeltaEncoder
    from kubernetes_tpu.api.snapshot import Snapshot
    from kubernetes_tpu.ops import preempt as jpre
    from kubernetes_tpu.scheduler.preemption import BatchedPreemption as JBatchedPreemption

    return dict(t=jt, h=helpers, enc=DeltaEncoder, Snapshot=Snapshot, pre=jpre, bp=JBatchedPreemption)


def carry(ja):
    return from_jax_arrays({f.name: np.asarray(getattr(ja, f.name)) for f in dataclasses.fields(ja)}, "cpu")


def victim_tables(rng, alloc: np.ndarray, V: int):
    """Random (used_now, nom_extra, has_nom, vict_req, vict_prio, vict_viol,
    vict_valid) over the nodes of `alloc` (i32[N, R])."""
    N, R = alloc.shape
    cap = np.maximum(alloc.astype(np.int64), 1)
    used = ((0.75 + 0.25 * rng.random((N, R))) * cap).astype(np.int32)  # mostly full
    nom = np.where(rng.random((N, 1)) < 0.3, (rng.random((N, R)) * cap * 0.1).astype(np.int64), 0).astype(np.int32)
    has_nom = (nom.sum(axis=1) > 0) | (rng.random(N) < 0.05)
    vreq = (rng.random((N, V, R)) * cap[:, None, :] * 0.5).astype(np.int32)
    vreq[rng.random((N, V, R)) < 0.2] = 0
    prio = rng.choice(PRIOS, size=(N, V)).astype(np.int32)
    viol = rng.random((N, V)) < 0.3
    valid = rng.random((N, V)) < 0.8
    vreq[~valid] = 0
    return used, nom, has_nom, vreq, prio, viol, valid


def _random_cluster(jx, seed):
    rng = random.Random(seed)
    snap = jx["h"].random_cluster(rng, n_nodes=40, n_pods=24, with_taints=True, with_selectors=True)
    for i in range(0, len(snap.pending_pods), 7):  # pins: to a node, or to one that is missing
        snap.pending_pods[i].node_name = f"node-{rng.randrange(40)}" if i % 2 else "gone"
    return jx["enc"]().encode(snap)


CASES = [(0, 1, 1), (1, 1, 64), (2, 2, 3), (3, 2, 64), (4, 8, 1), (5, 8, 3), (6, 8, 64), (7, 2, 1), (8, 1, 3)]


@pytest.mark.parametrize("seed,V,K", CASES)
def test_preempt_eval_wave_matches_jax(jx, seed, V, K):
    ja, jm = _random_cluster(jx, seed)
    rng = np.random.default_rng(seed)
    ins = victim_tables(rng, np.asarray(ja.node_alloc), V)
    idxs = rng.choice(jm.n_pods, size=K, replace=K > jm.n_pods).astype(np.int32)
    want = [np.asarray(x) for x in jx["pre"].preempt_eval_wave(ja, idxs, *ins)]
    got = tpre.to_host(tpre.preempt_eval_wave(carry(ja), idxs, *ins))
    assert len(got) == len(want) == 7
    for name, g, w in zip(("cand", "nvio", "vmax", "vsum", "vcnt", "is_victim", "static_ok"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert want[0].any() and (want[4] > 0).any()  # the tables make real candidates
    one = [np.asarray(x) for x in jx["pre"].preempt_eval(ja, np.int32(idxs[0]), *ins)]
    for g, w in zip(tpre.to_host(tpre.preempt_eval(carry(ja), int(idxs[0]), *ins)), one):
        np.testing.assert_array_equal(g, w)


def with_resources(rng, alloc: np.ndarray, req: np.ndarray, R: int):
    """R resource columns built from the encoded ones: column r is column r
    mod R0 scaled by 1 + r // R0, with some requests zeroed (the fit test
    skips a zero request) -> (alloc i32[N, R], req i32[P, R])."""
    R0 = alloc.shape[1]
    cols = np.arange(R) % R0
    scale = 1 + np.arange(R) // R0
    a = (alloc[:, cols].astype(np.int64) * scale).clip(0, 2**31 - 1).astype(np.int32)
    q = (req[:, cols].astype(np.int64) * scale).clip(0, 2**31 - 1)
    q[rng.random(q.shape) < 0.15] = 0
    return np.ascontiguousarray(a), np.ascontiguousarray(q.astype(np.int32))


def edge_tables(rng, alloc: np.ndarray, V: int):
    """victim_tables with edges: the first quarter of the nodes holds no
    valid victim; on the upper half every valid victim fills its node (the
    usage is theirs), so each stays evicted wherever the preemptor fits and
    two priorities of 2**31 - 9 wrap the int32 sum."""
    used, nom, has_nom, vreq, prio, viol, valid = victim_tables(rng, alloc, V)
    N = alloc.shape[0]
    valid[: N // 4] = False
    vreq[~valid] = 0
    h = N // 2
    vreq[h:] = np.where(valid[h:, :, None], alloc[h:, None, :], 0)
    used[h:] = alloc[h:] * valid[h:].sum(axis=1, keepdims=True)
    prio[h:] = 2**31 - 9
    return used, nom, has_nom, vreq, prio, viol, valid


@pytest.mark.parametrize("V", [1, 8])
@pytest.mark.parametrize("R", [1, 5, 16])
def test_preempt_eval_wave_matches_jax_over_resources(jx, R, V):
    """The plain phases A-C == the JAX preempt_eval_wave at R resources:
    K = 64 preemptors, priorities whose sums wrap int32 (V = 8), nodes with
    no valid victim and nodes with nominated pods."""
    ja, jm = _random_cluster(jx, 20 + R + V)
    rng = np.random.default_rng(R * 10 + V)
    alloc, req = with_resources(rng, np.asarray(ja.node_alloc), np.asarray(ja.pod_req), R)
    ja = dataclasses.replace(ja, node_alloc=alloc, pod_req=req, node_used=np.zeros_like(alloc))
    ins = edge_tables(rng, alloc, V)
    used, nom, has_nom, vreq, prio, viol, valid = ins
    idxs = rng.choice(jm.n_pods, size=64, replace=True).astype(np.int32)
    want = [np.asarray(x) for x in jx["pre"].preempt_eval_wave(ja, idxs, *ins)]
    got = tpre.to_host(tpre.preempt_eval_wave(carry(ja), idxs, *ins))
    for name, g, w in zip(("cand", "nvio", "vmax", "vsum", "vcnt", "is_victim", "static_ok"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert has_nom.any() and want[0].any() and (want[4][:, : ja.N // 4] == 0).all()
    if V == 8:  # the victims' priority sums wrapped int32 somewhere
        wide = np.where(want[5], prio[None].astype(np.int64), 0).sum(axis=2)
        assert ((wide > 2**31 - 1) | (wide < -(2**31))).any()


def _dirty_repair(jx):
    """The JAX test's scenario (test_preemption_batched.py:129): two nodes,
    each full with one evictable pod, four same-priority preemptors."""
    h = jx["h"]
    nodes = [h.mk_node(f"n{i}", cpu=2000, pods=8) for i in range(2)]
    bound = [h.mk_pod(f"low{i}", cpu=1800, node_name=f"n{i}") for i in range(2)]
    pend = [h.mk_pod(f"hi{k}", cpu=1800, priority=50) for k in range(4)]
    return jx["Snapshot"](nodes=nodes, pending_pods=pend, bound_pods=bound), (), ()


def _random_scenario(jx, seed):
    """Random nodes full of priority 0 / 5 / -3 pods, a PDB over app=web,
    preemptors of priorities 10 and 50 with selectors and tolerations, one
    pinned, and a nomination carried from an earlier cycle."""
    t, h = jx["t"], jx["h"]
    rng = random.Random(seed)
    n = rng.randint(4, 9)
    nodes = [h.mk_node(f"n{i}", cpu=2000, pods=8, labels={"zone": f"z{i % 2}"},
                       taints=(t.Taint(key="ded", effect=t.NO_SCHEDULE),) if i % 4 == 3 else ())
             for i in range(n)]
    bound = [h.mk_pod(f"low{i}", cpu=rng.choice([300, 500, 800]), priority=rng.choice([0, 5, -3]),
                      node_name=f"n{rng.randrange(n)}", labels={"app": rng.choice(["web", "db"])})
             for i in range(rng.randint(8, 16))]
    pend = []
    for k in range(rng.randint(5, 9)):
        kw = {}
        if k % 3 == 1:
            kw["node_selector"] = {"zone": f"z{k % 2}"}
        if k % 4 == 2:
            kw["tolerations"] = (t.Toleration(key="ded", operator="Exists"),)
        pend.append(h.mk_pod(f"hi{k}", cpu=rng.choice([700, 1200, 1800]), priority=rng.choice([10, 50]), **kw))
    pend.append(h.mk_pod("pinned", cpu=1200, priority=50, node_name="n1"))
    pdbs = (t.PodDisruptionBudget(name="web-pdb", selector=t.LabelSelector.of(app="web"),
                                  disruptions_allowed=rng.choice([0, 1, 2])),)
    return jx["Snapshot"](nodes=nodes, pending_pods=pend, bound_pods=bound), pdbs, (("hi0", f"n{n - 1}"),)


def _outside_gate(jx, seed):
    """The random scenario with preemptors the batched gate refuses (host
    ports, a topology-spread constraint, a required pod anti-affinity term)
    mixed in: they take the CPU PostFilter, and each CPU eviction rebuilds
    BatchedPreemption for the pods after it; with seed 4 a bound pod holds
    an anti-affinity term, so every preemptor takes the CPU PostFilter
    until that pod is evicted."""
    t, h = jx["t"], jx["h"]
    snap, pdbs, nominated = _random_scenario(jx, seed)
    term = t.PodAffinityTerm(topology_key="zone", label_selector=t.LabelSelector.of(app="db"))
    pend = list(snap.pending_pods)
    for k, p in enumerate(pend[:-1]):
        if k % 3 == 0:
            pend[k] = dataclasses.replace(p, host_ports=(("TCP", 8080 + k % 2),))
        elif k % 3 == 1 and k % 2:
            pend[k] = dataclasses.replace(p, topology_spread=(t.TopologySpreadConstraint(
                max_skew=1, topology_key="zone", when_unsatisfiable=t.DO_NOT_SCHEDULE,
                label_selector=t.LabelSelector.of(app="web")),), labels={"app": "web"})
        elif k % 3 == 2:
            pend[k] = dataclasses.replace(p, affinity=t.Affinity(required_pod_anti_affinity=(term,)))
    bound = list(snap.bound_pods)
    if seed == 4:
        bound[0] = dataclasses.replace(bound[0], affinity=t.Affinity(required_pod_anti_affinity=(term,)))
    return jx["Snapshot"](nodes=snap.nodes, pending_pods=pend, bound_pods=bound), pdbs, nominated


SCENARIOS = {"dirty-repair": _dirty_repair, **{f"random-{s}": (lambda jx, s=s: _random_scenario(jx, s))
                                               for s in (1, 2, 3, 5, 8)},
             **{f"outside-gate-{s}": (lambda jx, s=s: _outside_gate(jx, s)) for s in (1, 2, 4)}}


@pytest.mark.parametrize("wave", [64, 2, 0])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_failure_cycle_matches_jax_batched_preemption(jx, monkeypatch, name, wave):
    monkeypatch.setattr(BatchedPreemption, "_WAVE", wave)
    monkeypatch.setattr(jx["bp"], "_WAVE", wave)
    snap, pdbs, nominated = SCENARIOS[name](jx)
    want = ref.jax_failure_cycle(snap, pdbs, nominated)
    got = pb.failure_cycle(ref.to_port(snap), device="cpu", pdbs=ref.to_port(pdbs), nominated=nominated)
    for key in ("failed", "messages", "dominant", "records", "decisions", "nominated", "wave_hits", "single_hits"):
        assert got[key] == want[key], key
    assert want["decisions"], "no preemption happened"
    if name.startswith("outside-gate"):  # some preemption through the CPU PostFilter
        outside = {p.name for p in snap.pending_pods if p.host_ports or p.topology_spread or p.affinity}
        assert outside & {d[0] for d in got["decisions"]} or name == "outside-gate-4"
        assert got["times"]["cpu_postfilter_s"] > 0
    elif wave == 0:
        assert got["wave_hits"] == 0 and got["single_hits"] > 0
    else:
        assert got["wave_hits"] > 0
    if name == "dirty-repair":  # two preempt; the later two see the nominations
        assert len(got["decisions"]) == 2


def test_failure_cycle_matches_jax_scheduler(jx):
    """build(50, 12): the port's failure_cycle against the JAX Scheduler
    with BatchedPreemption on, run until idle (the first run of the JAX
    preempt_bench.py's _parity_cross_check), and against the JAX sequence."""
    from kubernetes_tpu.bench.preempt_bench import build as jbuild
    from kubernetes_tpu.scheduler import Scheduler, SchedulerConfiguration

    store = jbuild(50, 12)
    sched = Scheduler(store, SchedulerConfiguration(mode="tpu"))
    sched.run_until_idle()
    preempted = sorted((e.pod, e.node) for e in sched.events.by_reason("Preempted"))
    fillers = sorted(p.name for p in store.list_pods() if p.labels.get("app") == "filler")
    snap = pb.build(50, 12)
    got = pb.failure_cycle(snap, device="cpu")
    assert sorted((f"default/{p}", n) for p, n, _ in got["decisions"]) == preempted
    gone = {v for _, _, vs in got["decisions"] for v in vs}
    assert sorted(p.name for p in snap.bound_pods if p.name not in gone) == fillers
    assert len(got["failed"]) == 12 and len(got["nominated"]) == 12 and len(fillers) == 88
    want = ref.jax_failure_cycle(ref.jax_snapshot(50, 12))
    assert pb.decisions_digest(got["decisions"]) == pb.decisions_digest(want["decisions"])
    assert got["messages"] == want["messages"]


@pytest.mark.parametrize("wave", [64, 0])
def test_wave_probe_records_every_evaluation(monkeypatch, wave):
    """WaveProbe sees each device evaluation of a failure cycle from
    outside BatchedPreemption, keeps inputs that reproduce the outputs, and
    puts back what it wrapped."""
    monkeypatch.setattr(BatchedPreemption, "_WAVE", wave)
    wrapped = (tpre.preempt_eval_wave, tpre.to_host, kernels.preempt_eval, BatchedPreemption._build_wave)
    with pb.WaveProbe(keep=True) as probe:
        got = pb.failure_cycle(pb.build(50, 12), device="cpu")
    assert (tpre.preempt_eval_wave, tpre.to_host, kernels.preempt_eval, BatchedPreemption._build_wave) == wrapped
    waves = [c for c in probe.calls if c["build_s"] is not None]
    assert len(waves) == (len(probe.calls) if wave else 0)
    assert sum(c["k"] for c in waves) == got["wave_hits"]
    assert len(probe.calls) - len(waves) == got["single_hits"]
    for c in probe.calls:
        assert c["kernel_ms"] is None and c["launch_s"] >= 0 and c["read_s"] >= 0
        arr, idxs, *ins = c["inputs"]
        assert c["kp"] == idxs.size and c["kp"] & (c["kp"] - 1) == 0 and c["k"] <= c["kp"]
        idx = torch.from_numpy(idxs)
        want = tpre.preempt_eval_plain(arr, idx, tpre.static_rows_plain(arr, idx),
                                       *(torch.from_numpy(np.ascontiguousarray(x)) for x in ins))
        if len(c["outputs"]) == 6:
            want = [x[0] for x in want[:6]]
        for h, w in zip(c["outputs"], want):
            np.testing.assert_array_equal(h, w.numpy())


def test_failure_cycle_refuses_pods_outside_the_gate(jx):
    """BatchedPreemption's gate refuses a preemptor with host ports (its
    pairwise/ports terms are outside the batched evaluator), and the
    failure cycle then serves it through the CPU PostFilter
    (DefaultPreemption), as the JAX scheduler's failure loop does, with the
    decisions of the JAX sequence."""
    snap = pb.build(6, 2)
    snap.pending_pods[1] = dataclasses.replace(snap.pending_pods[1], host_ports=(("TCP", 80),))
    got = pb.failure_cycle(snap, device="cpu")
    jsnap = ref.jax_snapshot(6, 2)
    jsnap.pending_pods[1] = dataclasses.replace(jsnap.pending_pods[1], host_ports=(("TCP", 80),))
    want = ref.jax_failure_cycle(jsnap)
    assert got["decisions"] == want["decisions"] and got["nominated"] == want["nominated"]
    assert got["outside_gate"] == ["hi-1"]  # the gate refused it
    assert [d[0] for d in got["decisions"]] == ["hi-0", "hi-1"]  # hi-1 through the CPU PostFilter
    assert got["times"]["cpu_postfilter_s"] > 0


def test_build_matches_the_jax_build(jx):
    snap, jsnap = pb.build(7, 3), ref.to_port(ref.jax_snapshot(7, 3))
    assert snap == jsnap


# ---------------------------------------------------------------------------
# on the card: K15 preempt_eval == plain, failure_cycle on the card == CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card: python -m pytest --noconftest "
                    "-m cuda tests/test_torch_preempt.py")
    kernels.build(["preempt_eval", "class_static_hoist", "explain_counts", "packed_static_rows",
                   "chunk_rounds_dense"])
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed,V,K", [(0, 1, 1), (1, 2, 7), (2, 8, 64), (3, 2, 64)])
def test_kernel_matches_plain(card, seed, V, K):
    arr, meta = encode_snapshot(tw.mixed(40, 160, seed=seed), device=card)
    rng = np.random.default_rng(seed)
    ins = victim_tables(rng, arr.node_alloc.cpu().numpy(), V)
    idxs = rng.choice(meta.n_pods, size=K).astype(np.int32)
    kernels.reset_launches()
    got = tpre.preempt_eval_wave(arr, idxs, *ins)
    assert kernels.LAUNCHES["preempt_eval"] == 1 and kernels.LAUNCHES["class_static_hoist"] == 1
    idx = torch.from_numpy(idxs).to(card)
    dev_ins = [torch.from_numpy(np.ascontiguousarray(x)).to(card) for x in ins]
    want = tpre.preempt_eval_plain(arr, idx, tpre.static_rows_plain(arr, idx), *dev_ins)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    host = tpre.to_host(got)
    for h, w in zip(host, want):
        np.testing.assert_array_equal(h, w.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("V", [1, 2, 8, 3])
@pytest.mark.parametrize("R", [1, 4, 5, 16])
def test_kernel_matches_plain_over_the_grid(card, R, V):
    """K15 over resource counts (one kernel instantiation each), victim
    slot counts (one is_victim store a (k, n) for V = 1, 2, 8; bytes for
    V = 3), preemptor counts around its slice of 8, and 300 nodes (N a
    partial node tile)."""
    arr, meta = encode_snapshot(tw.mixed(300, 160, seed=R * 10 + V), device=card)
    rng = np.random.default_rng(R * 10 + V)
    alloc, req = with_resources(rng, arr.node_alloc[:300].cpu().numpy(), arr.pod_req.cpu().numpy(), R)
    nodes = {f.name: getattr(arr, f.name)[:300].contiguous() for f in dataclasses.fields(arr)
             if f.name.startswith("node_")}  # the encoder pads N to 384: cut the pad nodes
    arr = dataclasses.replace(arr, **{**nodes, "node_alloc": torch.from_numpy(alloc).to(card),
                                      "pod_req": torch.from_numpy(req).to(card),
                                      "node_used": torch.zeros((300, R), dtype=torch.int32, device=card)})
    assert arr.N == 300
    ins = edge_tables(rng, alloc, V)
    dev_ins = [torch.from_numpy(np.ascontiguousarray(x)).to(card) for x in ins]
    cands = wraps = 0
    for K in (1, 7, 64, 65):
        idxs = rng.choice(meta.n_pods, size=K).astype(np.int32)
        got = tpre.preempt_eval_wave(arr, idxs, *ins)
        idx = torch.from_numpy(idxs).to(card)
        want = tpre.preempt_eval_plain(arr, idx, tpre.static_rows_plain(arr, idx), *dev_ins)
        for name, g, w in zip(("cand", "nvio", "vmax", "vsum", "vcnt", "is_victim", "static_ok"), got, want):
            assert torch.equal(g, w), (K, name)
        cands += int(want[0].sum())
        wide = torch.where(want[5], dev_ins[4][None].long(), 0).sum(dim=2)
        wraps += int(((wide > 2**31 - 1) | (wide < -(2**31))).sum())
    assert cands > 0 and (wraps > 0) == (V > 1)


@pytest.mark.cuda
def test_failure_cycle_on_the_card(card):
    snap = pb.build(300, 80)
    kernels.reset_launches()
    with pb.WaveProbe() as probe:
        got = pb.failure_cycle(snap, device=card)
    launched = {k for k, v in kernels.LAUNCHES.items() if v}
    assert {"explain_counts", "preempt_eval", "class_static_hoist"} <= launched
    want = pb.failure_cycle(pb.build(300, 80), device="cpu")
    for key in ("failed", "messages", "decisions", "nominated", "wave_hits", "single_hits"):
        assert got[key] == want[key], key
    assert len(probe.calls) == kernels.LAUNCHES["preempt_eval"]
    assert all(c["kernel_ms"] is not None for c in probe.calls)
