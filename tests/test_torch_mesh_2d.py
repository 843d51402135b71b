"""The pods x nodes grid of the port (parallel/mesh.py GridMesh, GridArrays,
pad_pods; ops/assign.py pod_unshard; parallel/sharded.py on a grid;
DeltaEncoder(mesh=grid), HoistCache(mesh=grid), PipelinedBatchLoop(mesh=grid))
against the JAX package's 2-D programs and single-device route, and against
the port's 1-D mesh and one device.

On the CPU, for the grids (2, 4), (2, 2) and (3, 2):

- every route -- the chunked route dense and on class state (the class
  waves), the rounds route dense and on class rows, the per-pod scan -- on
  tests/torch_sharded_reference.py's GRID_SNAPSHOTS (heterogeneous(48, 256),
  test_sharded_routed.py's rounds snapshot, spread_affinity(25, 64) with
  pins in every node shard, test_mesh_2d.py's 51-pod snapshot; pod counts
  of 256 and 64 that 3 rows do not divide, 51 that 2 rows do not): choices,
  usage on the padded node axis, ordinals and sweeps == the JAX 2-D program
  (a shard_map of pod_unshard and the route's kernel, built by the
  reference script in a fresh process with 8 virtual devices, ~50 s,
  started when the module starts); choices and usage == the JAX single
  device (KTPU_FORCE_CHUNKED=1), the port on one device and on the 1-D
  mesh of the grid's node columns, and ordinals and sweeps too where the
  padded pod axis keeps the route (on 3 rows a 256- or 64-pod batch pads
  to 258 or 66 pods and takes the per-pod scan, in both packages);
- pad_pods == the JAX pad_pods field for field; the request grammar and
  make_mesh(shape=) == the JAX package's axis counts; a grid position's
  device; shard_hbm_estimate's pod terms;
- DeltaEncoder(mesh=grid): pod-axis fields resident per pod row, node-axis
  fields per node column, a warm delta re-places only changed blocks;
  HoistCache(mesh=grid) over churn == the one-device HoistCache's actions,
  with the class index one padded block per pod row; PipelinedBatchLoop on
  (2, 4) == run_serial == the JAX loop; gangs on a grid == one device.

The ``cuda`` leg imports no JAX and skips without a card: every route on
the (2, 4) and (3, 2) grids of the card == the 1-D mesh == one device.

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_mesh_2d.py

Tolerance: none (bit-identical).
"""

import dataclasses
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_sharded_reference as ref
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.api.delta import DeltaEncoder
from kubernetes_tpu_torch.api.snapshot import Snapshot, encode_snapshot
from kubernetes_tpu_torch.bench import workloads as tw
from kubernetes_tpu_torch.convert import from_jax_arrays, from_jax_meta
from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, infer_score_config
from kubernetes_tpu_torch.ops.assign import TRACE_COUNTS, dispatch, finish
from kubernetes_tpu_torch.ops.incremental import HoistCache
from kubernetes_tpu_torch.parallel import mesh as tm
from kubernetes_tpu_torch.parallel.partition_rules import NODE_AXIS_FIELDS, POD_AXIS_FIELDS
from kubernetes_tpu_torch.parallel.pipeline import PipelinedBatchLoop, run_serial
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parent.parent
ROUTE = {"chunked": "sharded_chunked", "rounds": "sharded_rounds", "scan": "sharded_plain"}


def _grid(shape):
    return tm.make_mesh(shape=shape, devices="cpu")


# ---------------------------------------------------------------------------
# the JAX side, computed in a fresh process while the port-only tests run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def _jax_proc(tmp_path_factory):
    if importlib.util.find_spec("jax") is None:  # the card's machine: the cuda leg needs no JAX
        yield None
        return
    out = tmp_path_factory.mktemp("grid") / "ref.npz"
    log = out.with_suffix(".log").open("w+")
    env = {**os.environ, **ref.PINNED, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_sharded_reference.py"), "--grid", str(out)],
                            env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)
    yield proc, out, log
    if proc.poll() is None:
        proc.kill()
        proc.wait()
    log.close()


@pytest.fixture(scope="module")
def jax_ref(_jax_proc):
    assert _jax_proc is not None, "JAX is not installed"
    proc, out, log = _jax_proc
    rc = proc.wait(timeout=900)
    log.seek(0)
    assert rc == 0, log.read()[-4000:]
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


_ENC = {}


def encoded(name):
    """The JAX encoder's arrays and class index of GRID_SNAPSHOTS[name]
    (bucket off), on the port's side, with the port's single-device steps."""
    if name not in _ENC:
        from kubernetes_tpu.api.delta import DeltaEncoder as JaxEncoder

        ja, jm = JaxEncoder(bucket=False).encode(ref.grid_snapshot(name))
        arr = from_jax_arrays({f.name: np.asarray(getattr(ja, f.name)) for f in dataclasses.fields(ja)}, "cpu")
        meta = from_jax_meta(jm)
        cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
        single = {"dense": finish(dispatch(arr, cfg, "cpu", chunked=True))}
        if name in ref.GRID_WITH_INC:
            single["inc"] = finish(dispatch(arr, cfg, "cpu", inc=HoistCache().ensure(arr, meta, cfg)))
        _ENC[name] = (arr, meta, cfg, single)
    return _ENC[name]


_CASES = [(name, mode, shape) for name in ref.GRID_SNAPSHOTS
          for mode in (("dense", "inc") if name in ref.GRID_WITH_INC else ("dense",)) for shape in ref.GRIDS]


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------

def test_make_mesh_grid_positions():
    g = tm.make_mesh(shape=(2, 4), devices=["cpu"] * 3)
    assert isinstance(g, tm.GridMesh) and g.shape == (2, 4) and g.size == 8 and g.nodes == 4
    assert [d for row in g.rows for d in row.devices] == [torch.device("cpu")] * 8
    assert repr(g) == "GridMesh(2x4 on 1 device)" and repr(g.rows[0]) == "NodeMesh(4 shards on 1 device)"
    assert tm.mesh_axis_shards(g) == (2, 4) and g.pl(51) == 26 and g.nl(27) == 7
    one = tm.make_mesh(shape=(1, 4), devices="cpu")
    assert isinstance(one, tm.NodeMesh) and one.size == 4
    with pytest.raises(ValueError):
        tm.make_mesh(shape=(2, 0), devices="cpu")
    est = tm.shard_hbm_estimate(51200, 20480, 4, n_res=5, u_classes=101, pod_shards=2)
    assert est["pod_rows"] == (4 * 5 + 18) * 25600 and est["pod_gather"] == 2 * est["pod_rows"]
    assert est["total"] == sum(v for k, v in est.items() if k != "total")
    assert "pod_rows" not in tm.shard_hbm_estimate(51200, 20480, 4)


def test_grid_request_grammar(monkeypatch):
    """KTPU_MESH=PxN and the KTPU_MESH_PODS / KTPU_MESH_NODES pair build the
    grid; its axis counts == the JAX package's mesh_from_env over its 8
    CPU devices."""
    from kubernetes_tpu.parallel.mesh import mesh_axis_shards as jax_axis_shards
    from kubernetes_tpu.parallel.mesh import mesh_from_env as jax_mesh_from_env

    cases = [("2x4", None, None, (2, 4)), (None, "2", "4", (2, 4)), ("8", "2", None, (2, 4)),
             ("2x2", None, None, (2, 2)), ("3x2", None, None, (3, 2)), (None, "2", None, (2, 1)),
             ("1x4", None, None, (1, 4)), ("4", None, None, (1, 4))]
    for m, p, n, want in cases:
        for k, v in (("KTPU_MESH", m), ("KTPU_MESH_PODS", p), ("KTPU_MESH_NODES", n)):
            if v is None:
                monkeypatch.delenv(k, raising=False)
            else:
                monkeypatch.setenv(k, v)
        got = tm.mesh_from_env(devices="cpu")
        assert tm.mesh_axis_shards(got) == want == jax_axis_shards(jax_mesh_from_env()), (m, p, n)
        assert isinstance(got, tm.GridMesh) == (want[0] > 1)


def test_pad_pods_matches_jax():
    from kubernetes_tpu.api.snapshot import encode_snapshot as jencode
    from kubernetes_tpu.parallel.mesh import pad_pods as jpad

    snap = ref.grid_snapshot("pad")
    ja, _ = jencode(snap, bucket=False)
    arr = from_jax_arrays({f.name: np.asarray(getattr(ja, f.name)) for f in dataclasses.fields(ja)}, "cpu")
    assert arr.P == 51
    same, p0 = tm.pad_pods(arr, 3)
    assert same is arr and p0 == 51
    for k in (2, 5):
        padded, p0 = tm.pad_pods(arr, k)
        jp, jp0 = jpad(ja, k)
        assert p0 == jp0 == 51 and padded.P == -(-51 // k) * k
        assert not padded.pod_valid[51:].any() and not padded.pod_req[51:].any()
        for f in dataclasses.fields(ja):
            want = np.asarray(getattr(jp, f.name))
            got = getattr(padded, f.name)
            if got.dtype == torch.bfloat16:
                got, want = got.view(torch.int16).numpy().view(np.uint16), want.view(np.uint16)
            np.testing.assert_array_equal(np.asarray(got), want, err_msg=f.name)
    # the numpy form (the encoder's) pads the same fields
    host = tm.pad_pod_field("m_pend", np.ones((3, 51), np.float32), 1)
    assert host.shape == (3, 52) and not host[:, 51].any()
    assert tm.pad_pod_field("node_alloc", arr.node_alloc, 1) is arr.node_alloc


def test_pod_axis_table_matches_jax():
    from kubernetes_tpu.parallel.partition_rules import pod_axis_fields

    assert POD_AXIS_FIELDS == pod_axis_fields()


def test_grid_arrays_and_pod_unshard():
    """grid_arrays gives position (r, s) pod row r's and node column s's
    blocks; pod_unshard gathers the rows back: shard s of the row == the
    1-D placement's shard s, field for field."""
    arr, _, _, _ = encoded("sa")
    g = _grid((3, 2))
    ga = tm.grid_arrays(arr, g)
    assert (ga.P, ga.pl, ga.N, ga.nl) == (66, 22, 26, 13)
    for r in range(3):
        for s in range(2):
            c = ga.cells[r][s]
            assert c.P == 22 and c.N == 13 and c.m_pend.shape[1] == 22
            assert torch.equal(c.pod_req[: max(0, 64 - 22 * r)], arr.pod_req[22 * r:22 * (r + 1)])
            assert c.node_alloc is ga.cells[0][s].node_alloc  # a node block once per device
    assert not ga.cells[2][0].pod_valid[20:].any()
    sa, _ = assign.pod_unshard(ga)
    one = tm.shard_arrays(tm.pad_pods(arr, 3)[0], g.rows[0])
    assert sa.mesh == g.rows[0] and sa.P == 66
    for a, b in zip(sa.shards, one.shards):
        for f in a.FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f


# ---------------------------------------------------------------------------
# every route on the grid against the JAX 2-D program, JAX and the port on
# one device, and the port's 1-D mesh (the reference process has had the
# port-only tests' time to run)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,mode,shape", _CASES, ids=[f"{n}-{m}-{p}x{q}" for n, m, (p, q) in _CASES])
def test_grid_route_matches_jax_2d_and_one_device(name, mode, shape, jax_ref):
    arr, meta, cfg, single = encoded(name)
    N, n_pods = arr.N, arr.P
    key = f"{name}/g{shape[0]}x{shape[1]}/{mode}"
    route = str(jax_ref[f"{key}/route"])
    for field, got in zip(("choices", "used", "ordinals"), single[mode][:3]):
        np.testing.assert_array_equal(got.numpy(), jax_ref[f"{name}/single/{mode}/{field}"], err_msg=field)
    assert single[mode].sweeps == int(jax_ref[f"{name}/single/{mode}/sweeps"])
    g = _grid(shape)
    inc = HoistCache(mesh=g).ensure(arr, meta, cfg) if mode == "inc" else None
    assign.reset_trace_counts()
    step = finish(dispatch(arr, cfg, "cpu", inc=inc, mesh=g))
    routes = {k for k, v in TRACE_COUNTS.items() if v}
    inc_route = {"chunked": "sharded_chunked_inc", "rounds": "sharded_rounds_inc"}.get(route)
    assert ROUTE[route] in routes or (mode == "inc" and inc_route in routes), (route, routes)
    # == the JAX 2-D program, all four outputs
    assert step.choices.shape[0] == n_pods and step.used.shape[0] == g.nl(N) * shape[1]
    np.testing.assert_array_equal(step.choices.numpy(), jax_ref[f"{key}/choices"])
    np.testing.assert_array_equal(step.used.numpy(), jax_ref[f"{key}/used"])
    np.testing.assert_array_equal(step.ordinals.numpy(), jax_ref[f"{key}/ordinals"])
    assert step.sweeps == int(jax_ref[f"{key}/sweeps"])
    # == one device and the 1-D mesh of the grid's node columns
    m1 = tm.make_mesh(shape[1], devices="cpu")
    inc1 = HoistCache(mesh=m1).ensure(arr, meta, cfg) if mode == "inc" else None
    flat = finish(dispatch(arr, cfg, "cpu", inc=inc1, mesh=m1))
    one_route = "chunked" if assign._chunkable(arr, cfg) else "rounds" if assign._rounds_capable(arr, cfg) else "scan"
    for other in (single[mode], flat):
        assert torch.equal(step.choices, other.choices)
        assert torch.equal(step.used[:N], other.used[:N]) and not step.used[N:].any()
        if route == one_route:  # the ordinals of the same route; its sweeps unless the pod axis was padded
            assert torch.equal(step.ordinals, other.ordinals)
            assert (step.sweeps == other.sweeps) == (n_pods % shape[0] == 0)


# ---------------------------------------------------------------------------
# the encoder, the class cache, the pipeline and gangs on the grid
# ---------------------------------------------------------------------------

def test_delta_encoder_on_grid_keeps_pod_rows_resident():
    snap = tw.heterogeneous(40, 200)
    g = _grid((3, 2))
    enc = DeltaEncoder(device="cpu", mesh=g)
    host, meta = enc.encode(snap)
    a1, _ = enc.to_device(host, meta)
    assert isinstance(a1, tm.GridArrays) and a1.mesh == g
    assert a1.P == 3 * -(-host.P // 3) and a1.N == 2 * -(-host.N // 2)
    one, _ = encode_snapshot(snap, device="cpu")
    ref_ga = tm.grid_arrays(one, g)
    for r in range(3):
        for s in range(2):
            for f in one.FIELDS:
                assert torch.equal(getattr(a1.cells[r][s], f), getattr(ref_ga.cells[r][s], f)), (r, s, f)
    dev = torch.device("cpu")
    assert {k[2] for k in enc._dev if k[0] == "pod_req"} == {0, 1, 2}
    assert {k[1] for k in enc._dev if k[0] == "node_alloc"} == {0, 1}
    used = host.node_used.copy()
    used[-1] += 1  # node column 1's rows only
    a2, _ = enc.to_device(dataclasses.replace(host, node_used=used), meta)
    assert a2.cells[0][0].node_used is a1.cells[0][0].node_used
    assert a2.cells[0][1].node_used is not a1.cells[0][1].node_used
    assert all(a2.cells[r][s].pod_req is a1.cells[r][s].pod_req for r in range(3) for s in range(2))
    assert enc._dev[("pod_req", "pods", 1, dev)][2] is a1.cells[1][0].pod_req
    cfg = infer_score_config(host, DEFAULT_SCORE_CONFIG)
    want = finish(dispatch(one, cfg, "cpu", chunked=True))
    got = finish(dispatch(a1, cfg, "cpu"))
    assert torch.equal(got.choices[:meta.n_pods], want.choices[:meta.n_pods])


def _churn(arr):
    used = arr.node_used.clone()
    req = arr.pod_req[0]
    out = [used]
    most = [n for n in range(arr.N) if n % 4]
    for rows in ([1, 2, 30], [arr.N - 2], [], most, [arr.N - 1]):
        used = used.clone()
        if rows:
            used[rows] += req
        out.append(used)
    return out


@pytest.mark.parametrize("shape", ref.GRIDS)
def test_hoist_cache_on_grid_over_churn(shape):
    arr, meta, cfg, _ = encoded("het")
    g = _grid(shape)
    one, grid = HoistCache(), HoistCache(mesh=g)
    for used in _churn(arr):
        a = dataclasses.replace(arr, node_used=used)
        want = one.ensure(a, meta, cfg)
        got = grid.ensure(a, meta, cfg)
        assert isinstance(got.cls, tuple) and len(got.cls) == shape[0]
        pl = g.pl(arr.P)
        assert all(c.shape == (pl,) for c in got.cls)
        sa, full = assign.pod_unshard(tm.grid_arrays(a, g), got)
        assert torch.equal(full.cls[:arr.P], want.cls) and not full.cls[arr.P:].any()
        assert all(torch.equal(x.cls, full.cls) for x in full.shards)
        assert torch.equal(got.req_u, want.req_u)
        if got.base_u is not None:
            assert torch.equal(got.base_u[:, :arr.N].view(torch.int32), want.base_u.view(torch.int32))
    assert [h["action"] for h in grid.history] == [h["action"] for h in one.history]
    assert [h["action"] for h in grid.history] == ["static_rebuild", "patch", "patch", "hit", "full", "patch"]


def _wave(types, seed):
    """test_torch_mesh.py's waves: 10 nodes of random cpu, 128 pods."""
    gi = 1024**3
    rng = np.random.default_rng(seed)
    nodes = [types.Node(name=f"w{seed}-n{i}", allocatable={types.CPU: int(rng.integers(2000, 8000)),
                                                            types.MEMORY: 8 * gi, types.PODS: 110})
             for i in range(10)]
    pods = [types.Pod(name=f"w{seed}-p{j}", requests={types.CPU: int(rng.integers(100, 1500)),
                                                       types.MEMORY: 128 * 1024**2})
            for j in range(128)]
    return nodes, pods


def test_pipelined_loop_on_grid_matches_serial():
    from kubernetes_tpu.api import types as jt
    from kubernetes_tpu.api.snapshot import Snapshot as JaxSnapshot
    from kubernetes_tpu.parallel.pipeline import run_serial as jax_serial

    waves = [Snapshot(*_wave(tt, s)) for s in range(4)]
    oracle = list(run_serial(waves, device="cpu"))
    assert oracle == list(jax_serial([JaxSnapshot(*_wave(jt, s)) for s in range(4)]))
    g = _grid((2, 4))
    loop = PipelinedBatchLoop(depth=1, device="cpu", mesh=g)
    assign.reset_trace_counts()
    assert list(loop.run(waves)) == oracle
    assert TRACE_COUNTS["sharded_chunked_inc"] == 4
    assert loop.enc.mesh == g and loop.hoist.mesh == g
    # pod-axis fields resident per pod row, node-axis fields per node column
    dev = torch.device("cpu")
    for name in POD_AXIS_FIELDS:
        blocks = [loop.enc._dev[(name, "pods", r, dev)][2] for r in range(2)]
        assert blocks[0] is not blocks[1] and {b.shape[POD_AXIS_FIELDS[name][0]] for b in blocks} == {64}
    for name in NODE_AXIS_FIELDS:
        assert len({id(loop.enc._dev[(name, s, dev)][2]) for s in range(4)}) == 4


def test_gangs_on_grid_match_one_device():
    from kubernetes_tpu_torch.ops.gang import schedule_with_gangs

    arr, _ = encode_snapshot(tw.gang(16, 8, 1, seed=1), device="cpu")
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    want = schedule_with_gangs(arr, cfg, with_ordinals=True, device="cpu", chunked=True)
    for shape in ((2, 2), (3, 2), (2, 1)):  # (2, 1): a pod row of one node shard
        got = schedule_with_gangs(arr, cfg, with_ordinals=True, device="cpu", mesh=_grid(shape))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1][:arr.N], want[1])
        if arr.P % shape[0] == 0:
            assert torch.equal(got[2], want[2]) and got[3] == want[3]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 4), (3, 2)])
@pytest.mark.parametrize("kind", ["dense", "waves", "rounds", "rounds_inc", "perpod"])
def test_grid_on_card(kind, shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_mesh_2d.py")
    snap = tw.heterogeneous(265, 1024) if kind in ("dense", "waves") else tw.spread_affinity(25, 64, seed=3)
    arr, meta = encode_snapshot(snap)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    knobs = {"chunked": False} if kind == "perpod" else {}
    g, m1 = tm.make_mesh(shape=shape), tm.make_mesh(shape[1])
    incs = [None, None, None]
    if kind in ("waves", "rounds_inc"):
        incs = [HoistCache(mesh=m).ensure(arr, meta, cfg) for m in (None, m1, g)]
    want = finish(dispatch(arr, cfg, inc=incs[0], **knobs))
    flat = finish(dispatch(arr, cfg, inc=incs[1], mesh=m1, **knobs))
    got = finish(dispatch(arr, cfg, inc=incs[2], mesh=g, **knobs))
    N = arr.N
    for other in (want, flat):
        assert torch.equal(got.choices, other.choices) and torch.equal(got.used[:N], other.used[:N])
        if arr.P % shape[0] == 0:
            assert torch.equal(got.ordinals, other.ordinals) and got.sweeps == other.sweeps
