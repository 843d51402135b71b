"""The rounds scan's round loop (kernel K12's function) on batches that
stress it, against the JAX package's.

Cases (tests/torch_rounds_contended_reference.py): all 16 pods of a chunk
ranking one node first; every score tied; N not a multiple of 32; N below
the 32 entries of a top list; a normalisation extreme at a picked column
(the repair's hazard); pods colliding on a host port; chunks holding
invalid pods; non-integer preferred inter-pod weights beside
hardPodAffinityWeight on one term (the commit's add order); two repair
iterations a round.  On the CPU the port's ``schedule_scan_rounds_plain``,
dense and on the port's HoistCache class state (``inc=``), must equal the
JAX package's ``schedule_scan_rounds`` (and its ``inc=`` form where the JAX
gate admits its class state) run in a fresh process with
KTPU_FORCE_CHUNKED=1, KTPU_RCHUNK=16 and KTPU_REPAIR_ITERS pinned, in
choices, final usage, commit ordinals, sweeps and the count planes the
route leaves (cnt, anti, pref, total_t: the JAX route's absorb replayed
from its own ordinals).  Both sides read the JAX encoder's arrays
(convert.from_jax_arrays), with the case's patch applied.  Tolerance:
none (f32 planes compared as bit patterns).

On a node mesh (ROADMAP C4: the shard mode's commit order) every case also
runs through the port's ``sharded_schedule_scan_rounds_plain`` on 2 and 3
CPU shards (3: nl not a multiple of 32), dense and on ``HoistCache(mesh=)``
class state, held to the same JAX results (usage on the padded axis, the
pad rows zero; the count planes' real columns).

The ``cuda`` legs hold kernel K12 -- dense, class-row and gated (``done``
set: nothing written) -- to the plain scan on the same inputs, and K12's
shard mode (``kernels.rounds_shard``, dense and class rows) on 2, 3 and 5
shards of the card to the plain sharded scan on CPU shards, every count
plane and the ports included; ``frac-weights`` there pins C4.  The cases
are encoded by the port's encoder (cut back to the case's own nodes); the
legs import no JAX and skip without a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_rounds_contended.py
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_rounds_contended_reference as ref
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parent.parent
CASES = sorted(ref.CASES)
PLANES = ("cnt", "anti", "pref", "total")
MESH_S = [2, 3]  # CPU shards: 3 leaves nl off a multiple of 32
CARD_MESH_S = [2, 3, 5]
MODES = ["dense", "class-rows"]


@pytest.fixture(scope="module")
def jax_rounds(tmp_path_factory):
    """The JAX side, one fresh process per repair-iteration count, run at once."""
    d = tmp_path_factory.mktemp("jax_rounds_contended")
    procs = {}
    for iters in sorted({case[3] for case in ref.CASES.values()}):
        env = {**os.environ, **ref.PINNED, "KTPU_REPAIR_ITERS": str(iters), "JAX_PLATFORMS": "cpu",
               "PYTHONPATH": str(ROOT)}
        path = d / f"iters{iters}.npz"
        procs[path] = subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "torch_rounds_contended_reference.py"), str(path)],
            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    res = {}
    for path, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
        res.update(np.load(path))
    return res


_ARR = {}


def _arrays(name):
    """(the port's CPU arrays of the JAX encoder's output with the case's
    patch, the port's metadata, the score config, the repair iterations)."""
    if name not in _ARR:
        from kubernetes_tpu.api.delta import DeltaEncoder
        from kubernetes_tpu_torch.convert import from_jax_arrays, from_jax_meta
        from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, infer_score_config

        _, over, _, iters = ref.CASES[name]
        ja, jm = DeltaEncoder(bucket=False).encode(ref.snapshot(name))
        fields = ref.patched(name, {f.name: np.asarray(getattr(ja, f.name)) for f in dataclasses.fields(ja)})
        arr = from_jax_arrays(fields, "cpu")
        cfg = infer_score_config(arr, dataclasses.replace(DEFAULT_SCORE_CONFIG, **over))
        _ARR[name] = (arr, from_jax_meta(jm), cfg, iters)
    return _ARR[name]


def bits(x: torch.Tensor) -> np.ndarray:
    return (x.view(torch.int32) if x.dtype == torch.float32 else x).numpy()


def test_cases_stress_what_they_name():
    from kubernetes_tpu_torch.ops import assign

    arr, _, cfg, _ = _arrays("odd-n")
    assert arr.N == 45
    arr, _, cfg, _ = _arrays("n-below-zr")
    assert arr.N < 32 and cfg.enable_pairwise
    arr, _, cfg, _ = _arrays("port-collision")
    assert cfg.enable_ports
    arr, _, cfg, _ = _arrays("extreme")
    assert cfg.enable_node_pref
    arr, _, _, _ = _arrays("invalid-pods")
    assert all(0 < int(v) < assign.RCHUNK for v in arr.pod_valid.view(-1, assign.RCHUNK).sum(dim=1))
    arr, _, cfg, _ = _arrays("frac-weights")
    w = arr.pod_pref_aff_w[arr.pod_pref_aff_w != 0]
    assert cfg.enable_interpod_score and cfg.hard_pod_affinity_weight == 1.3 and bool((w != w.round()).all())
    assert _arrays("repair-twice")[3] == 2
    # the large empty node (node 0) is every pod's first pick: the first pod
    # of a chunk, which the round commits as speculated, lands there
    arr, _, cfg, iters = _arrays("one-argmax")
    c, _, o, _ = assign.schedule_scan_rounds_plain(arr, cfg, repair_iters=iters)
    assert int(c[0]) == 0 and int(c[assign.RCHUNK]) == 0


@pytest.mark.parametrize("name", CASES)
def test_rounds_scan_matches_jax(jax_rounds, name):
    from kubernetes_tpu_torch.ops import assign

    arr, _, cfg, iters = _arrays(name)
    assert assign._rounds_capable(arr, cfg) and not assign._chunkable(arr, cfg)
    c, u, o, s, st = assign.schedule_scan_rounds_plain(arr, cfg, repair_iters=iters, with_state=True)
    np.testing.assert_array_equal(c.numpy(), jax_rounds[f"{name}/choices"])
    np.testing.assert_array_equal(u.numpy(), jax_rounds[f"{name}/used"])
    np.testing.assert_array_equal(o.numpy(), jax_rounds[f"{name}/ordinals"])
    assert s == int(jax_rounds[f"{name}/sweeps"])
    for k in PLANES:
        np.testing.assert_array_equal(bits(st[k]), jax_rounds[f"{name}/{k}"].view(np.int32), err_msg=k)


@pytest.mark.parametrize("name", CASES)
def test_rounds_scan_on_class_state_matches_jax(jax_rounds, name):
    from kubernetes_tpu_torch.ops import assign
    from kubernetes_tpu_torch.ops.incremental import HoistCache

    arr, meta, cfg, iters = _arrays(name)
    inc = assign.inc_applicable(arr, cfg, HoistCache().ensure(arr, meta, cfg))
    assert (inc is not None) == bool(jax_rounds[f"{name}/inc_applied"])
    if inc is None:
        return
    c, u, o, s, st = assign.schedule_scan_rounds_plain(arr, cfg, repair_iters=iters, inc=inc, with_state=True)
    np.testing.assert_array_equal(c.numpy(), jax_rounds[f"{name}/inc_choices"])
    np.testing.assert_array_equal(u.numpy(), jax_rounds[f"{name}/inc_used"])
    np.testing.assert_array_equal(o.numpy(), jax_rounds[f"{name}/inc_ordinals"])
    assert s == int(jax_rounds[f"{name}/inc_sweeps"])
    for k in PLANES:  # the class mode leaves the dense route's state
        np.testing.assert_array_equal(bits(st[k]), jax_rounds[f"{name}/{k}"].view(np.int32), err_msg=k)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("s", MESH_S)
@pytest.mark.parametrize("name", CASES)
def test_sharded_rounds_scan_matches_jax(jax_rounds, name, s, mode):
    """The plain sharded rounds scan on s CPU shards == the JAX rounds route
    on one device, bit for bit (the JAX sharded program computes the same:
    test_torch_mesh_steps holds the two to each other)."""
    from kubernetes_tpu_torch.ops.incremental import HoistCache
    from kubernetes_tpu_torch.parallel import mesh as tm
    from kubernetes_tpu_torch.parallel import sharded

    arr, meta, cfg, iters = _arrays(name)
    m = tm.make_mesh(s, devices="cpu")
    sa = tm.shard_arrays(arr, m)
    inc, pre = None, ""
    if mode == "class-rows":
        inc = sharded.inc_applicable(sa, cfg, HoistCache(mesh=m).ensure(arr, meta, cfg))
        assert (inc is not None) == bool(jax_rounds[f"{name}/inc_applied"])
        if inc is None:
            return
        pre = "inc_"
    c, u, o, sw, st = sharded.sharded_schedule_scan_rounds_plain(sa, cfg, repair_iters=iters, inc=inc,
                                                                  with_state=True)
    N = arr.N
    assert sa.N == s * sa.nl >= N
    np.testing.assert_array_equal(c.numpy(), jax_rounds[f"{name}/{pre}choices"])
    np.testing.assert_array_equal(u[:N].numpy(), jax_rounds[f"{name}/{pre}used"])
    assert not u[N:].any()
    np.testing.assert_array_equal(o.numpy(), jax_rounds[f"{name}/{pre}ordinals"])
    assert sw == int(jax_rounds[f"{name}/{pre}sweeps"])
    for k in PLANES:  # the class mode leaves the dense route's state
        got = st[k] if k == "total" else st[k][:, :N]
        np.testing.assert_array_equal(bits(got.contiguous()), jax_rounds[f"{name}/{k}"].view(np.int32), err_msg=k)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_rounds_contended.py")
    return torch.device("cuda")


port_inputs = ref.port_arrays  # the case through the port's encoder, on `device`


def _same(got, want) -> None:
    from kubernetes_tpu_torch.ops import kernels

    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a.cpu(), b)
    assert kernels.read_sweeps(got[3]) == want[3]
    for k in PLANES:
        assert torch.equal(got[4][k].cpu().view(torch.int32), want[4][k].view(torch.int32)), k


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dense", "class-rows"])
@pytest.mark.parametrize("name", CASES)
def test_rounds_kernel_matches_plain(card, name, mode):
    from kubernetes_tpu_torch.ops import assign, kernels
    from kubernetes_tpu_torch.ops.incremental import HoistCache

    cpu, meta, cfg, iters = port_inputs(name, "cpu")
    d, _, _, _ = port_inputs(name, card)
    if mode == "dense":
        sfs, eligs = assign.packed_static_rows_plain(cpu, with_elig=True)
        planes = assign.score_planes(cpu, cfg)
        want = assign.schedule_scan_rounds_plain(cpu, cfg, sfs, eligs, planes, repair_iters=iters, with_state=True)
        got = kernels.rounds(d, cfg, sfs.to(card), eligs.to(card),
                             tuple(None if x is None else x.to(card) for x in planes), repair_iters=iters,
                             with_state=True)
    else:
        inc_cpu = assign.inc_applicable(cpu, cfg, HoistCache().ensure(cpu, meta, cfg))
        inc = assign.inc_applicable(d, cfg, HoistCache().ensure(d, meta, cfg))
        assert (inc is None) == (inc_cpu is None)
        if inc is None:
            return
        want = assign.schedule_scan_rounds_plain(cpu, cfg, repair_iters=iters, inc=inc_cpu, with_state=True)
        got = kernels.rounds(d, cfg, repair_iters=iters, inc=inc, with_state=True)
    _same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_rounds_kernel_gated_mode(card, name):
    """`done` clear: the plain scan's result; `done` set: nothing written."""
    from kubernetes_tpu_torch.ops import assign, kernels

    cpu, _, cfg, iters = port_inputs(name, "cpu")
    d, _, _, _ = port_inputs(name, card)
    sfs, eligs = assign.packed_static_rows_plain(cpu, with_elig=True)
    planes = assign.score_planes(cpu, cfg)
    want = assign.schedule_scan_rounds_plain(cpu, cfg, sfs, eligs, planes, repair_iters=iters, with_state=True)
    out = kernels.scan_out(d, assign.RCHUNK)
    done = torch.zeros((1,), dtype=torch.int32, device=card)
    args = (d, cfg, sfs.to(card), eligs.to(card), tuple(None if x is None else x.to(card) for x in planes))
    _same(kernels.rounds(*args, repair_iters=iters, with_state=True, done=done, out=out), want)
    before = [x.clone() for x in (out.choices, out.ordinals, out.scal, *out.state.values())]
    done.fill_(1)
    kernels.rounds(*args, repair_iters=iters, done=done, out=out)
    after = (out.choices, out.ordinals, out.scal, *out.state.values())
    assert all(torch.equal(a, b) for a, b in zip(before, after))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("s", CARD_MESH_S)
@pytest.mark.parametrize("name", CASES)
def test_rounds_shard_kernel_matches_plain(card, name, s, mode):
    """K12's shard mode on s shards of the card == the plain sharded scan on
    s CPU shards: choices, the replicated usage, ordinals, sweeps, every
    count plane (pref included: frac-weights is C4's pin) and the ports."""
    from kubernetes_tpu_torch.ops import assign, kernels
    from kubernetes_tpu_torch.ops.incremental import HoistCache
    from kubernetes_tpu_torch.parallel import mesh as tm
    from kubernetes_tpu_torch.parallel import sharded

    cpu, meta, cfg, iters = port_inputs(name, "cpu")
    d, _, _, _ = port_inputs(name, card)
    mc, md = tm.make_mesh(s, devices="cpu"), tm.make_mesh(s)
    sc, sd = tm.shard_arrays(cpu, mc), tm.shard_arrays(d, md)
    if mode == "dense":
        rows = [assign.packed_static_rows_plain(sh, with_elig=True, base=mc.base(j, sc.N))
                for j, sh in enumerate(sc.shards)]
        sfs, eligs = [r[0] for r in rows], [r[1] for r in rows]
        planes = [assign.score_planes(sh, cfg) for sh in sc.shards]
        want = sharded.sharded_schedule_scan_rounds_plain(sc, cfg, sfs, eligs, planes, repair_iters=iters,
                                                          with_state=True)
        kernels.reset_launches()
        got = kernels.rounds_shard(sd, cfg, [x.to(card) for x in sfs], [x.to(card) for x in eligs],
                                   [tuple(None if x is None else x.to(card) for x in pl) for pl in planes],
                                   repair_iters=iters, with_state=True)
    else:
        inc_c = sharded.inc_applicable(sc, cfg, HoistCache(mesh=mc).ensure(cpu, meta, cfg))
        inc_d = sharded.inc_applicable(sd, cfg, HoistCache(mesh=md).ensure(d, meta, cfg))
        assert (inc_c is None) == (inc_d is None)
        if inc_d is None:
            return
        want = sharded.sharded_schedule_scan_rounds_plain(sc, cfg, repair_iters=iters, inc=inc_c, with_state=True)
        kernels.reset_launches()
        got = kernels.rounds_shard(sd, cfg, inc=inc_d, repair_iters=iters, with_state=True)
    assert kernels.LAUNCHES["rounds_shard"] == 1
    _same(got, want)
    assert torch.equal(got[4]["ports"].cpu(), want[4]["ports"])
