"""The node mesh of the port (parallel/mesh.py, collectives.py, sharded.py;
the per-shard packed blocks of ops/bitplane.py; HoistCache(mesh=),
DeltaEncoder(mesh=), PipelinedBatchLoop(mesh=)) against the JAX package and
against the port on one device.

On the CPU:

- the per-shard block primitives (pack_blocks, unpack_blocks, test_cols,
  set_cols, assign_cols) equal the JAX package's ops/bitplane.py for
  s in {1, 2, 3, 8} and nl in {5, 32, 37, 64}, on seeded numpy bools (the
  JAX set_cols packs its new bits flat, so it is defined only where the
  flat and tiled layouts coincide, s == 1 or nl % 32 == 0; elsewhere the
  port's is held to the dense scatter); stitch_planes_plain gives the flat
  layout;
- parse_mesh_request, mesh_from_env and pad_nodes equal the JAX package's
  (the cases of test_mesh_2d.py and test_sharded_routed.py), and the node
  axis table equals the JAX package's node_axis_fields; meshreq imports with
  torch and JAX blocked;
- the sharded chunked route (dispatch with mesh=), dense and on class state,
  for S in {2, 3, 8}, on a cluster S divides (264 nodes) and one none of
  them divides (265), with nodeName pins in every shard: choices, the first
  N rows of usage (the pad rows zero), ordinals and sweeps equal the port's
  single-device route and the JAX single-device route (KTPU_FORCE_CHUNKED=1,
  in a fresh process: tests/torch_mesh_reference.py), and the route counts
  are the sharded ones;
- HoistCache(mesh=) over warm churn: the action history and the stitched
  planes equal the single-device HoistCache's, and each dirty column is
  patched by the shard that owns it;
- PipelinedBatchLoop(mesh=) equals run_serial and the JAX loop's verdicts,
  with every node-axis field resident per shard; a warm delta re-places
  only the changed shard.

The rounds and per-pod routes on the mesh, and what the mesh still
refuses, are tests/test_torch_mesh_steps.py's.

The ``cuda`` legs import no JAX and skip without a card: K17 stitch_planes
== its plain version; K3, K4 and K7 launched per shard with the shard's
base == their plain per-shard versions; the sharded route on the card ==
the single-device route on the card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_mesh.py

Tolerance: none (bit-identical).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_mesh_reference as ref
from kubernetes_tpu_torch.api import types as tt
from kubernetes_tpu_torch.api.delta import DeltaEncoder
from kubernetes_tpu_torch.api.snapshot import Snapshot, encode_snapshot
from kubernetes_tpu_torch.bench import workloads as tw
from kubernetes_tpu_torch.convert import from_jax_arrays, from_jax_meta
from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, bitplane, incremental, infer_score_config
from kubernetes_tpu_torch.ops.assign import TRACE_COUNTS, dispatch, finish
from kubernetes_tpu_torch.ops.incremental import HoistCache
from kubernetes_tpu_torch.parallel import collectives, mesh as tm
from kubernetes_tpu_torch.parallel.partition_rules import NODE_AXIS_FIELDS
from kubernetes_tpu_torch.parallel.pipeline import PipelinedBatchLoop, run_serial
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parent.parent
BLOCK_S = [1, 2, 3, 8]
BLOCK_NL = [5, 32, 37, 64]
MESH_S = [2, 3, 8]
_NODE_FIELDS = ("node_valid", "node_alloc", "node_used", "node_labels", "node_taint_ns", "node_dom")


def _bools(seed, shape, p=0.4):
    return np.random.default_rng(seed).random(shape) < p


def _cpu_mesh(s):
    return tm.make_mesh(s, devices="cpu")


# ---------------------------------------------------------------------------
# per-shard packed blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nl", BLOCK_NL)
@pytest.mark.parametrize("s", BLOCK_S)
def test_pack_blocks_matches_jax(s, nl):
    import jax.numpy as jnp

    from kubernetes_tpu.ops import bitplane as jb

    x = _bools(s * 100 + nl, (3, s * nl))
    w = bitplane.pack_blocks(torch.from_numpy(x), s)
    jw = jb.pack_blocks(jnp.asarray(x), s)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw).view(np.int32))
    assert w.shape[-1] == s * bitplane.words_for(nl)
    np.testing.assert_array_equal(bitplane.unpack_blocks(w, nl).numpy(), np.asarray(jb.unpack_blocks(jw, nl)))
    np.testing.assert_array_equal(bitplane.unpack_blocks(w, nl).numpy(), x)
    cols = np.random.default_rng(nl).integers(0, s * nl, 40).astype(np.int32)
    got = bitplane.test_cols(w, torch.from_numpy(cols), nl).numpy()
    np.testing.assert_array_equal(got, np.asarray(jb.test_cols(jw, jnp.asarray(cols), nl)))
    np.testing.assert_array_equal(got, x[:, cols])
    # the flat layout of the same bits
    np.testing.assert_array_equal(bitplane.stitch_planes_plain(w, nl).numpy(), bitplane.pack(torch.from_numpy(x)).numpy())


@pytest.mark.parametrize("nl", BLOCK_NL)
@pytest.mark.parametrize("s", BLOCK_S)
def test_set_and_assign_cols_match_jax(s, nl):
    import jax.numpy as jnp

    from kubernetes_tpu.ops import bitplane as jb

    n = s * nl
    rng = np.random.default_rng(7 * s + nl)
    x = _bools(nl + s, (2, n))
    w = bitplane.pack_blocks(torch.from_numpy(x), s)
    jw = jb.pack_blocks(jnp.asarray(x), s)
    # duplicates and the sentinel n among the columns
    cols = np.concatenate([rng.integers(0, n, 9), [n, n], rng.integers(0, n, 1).repeat(2)]).astype(np.int32)
    on = rng.random(len(cols)) < 0.5
    got = bitplane.set_cols(w, torch.from_numpy(cols), torch.from_numpy(on), nl)
    dense = x.copy()
    for c, o in zip(cols, on):
        if o and c < n:
            dense[:, c] = True
    np.testing.assert_array_equal(bitplane.unpack_blocks(got, nl).numpy(), dense)
    np.testing.assert_array_equal(got.numpy(), bitplane.pack_blocks(torch.from_numpy(dense), s).numpy())
    if s == 1 or nl % 32 == 0:  # where the JAX set_cols' flat pack is the tiled layout
        want = jb.set_cols(jw, jnp.asarray(cols), jnp.asarray(on), nl)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).view(np.int32))
    # assignment: unique real columns, duplicates with equal values, sentinels
    real = rng.choice(n, size=min(n, 6), replace=False).astype(np.int32)
    acols = np.concatenate([real, real[:1], [n, n]]).astype(np.int32)
    vals = _bools(3 * nl + s, (2, len(real)))
    aon = np.concatenate([vals, vals[:, :1], np.zeros((2, 2), bool)], axis=1)
    got = bitplane.assign_cols(w, torch.from_numpy(acols), torch.from_numpy(aon), nl)
    want = jb.assign_cols(jw, jnp.asarray(acols), jnp.asarray(aon), nl)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).view(np.int32))
    dense = x.copy()
    dense[:, real] = vals
    np.testing.assert_array_equal(bitplane.unpack_blocks(got, nl).numpy(), dense)


# ---------------------------------------------------------------------------
# the request grammar, the mesh, padding
# ---------------------------------------------------------------------------

_GRAMMAR = [
    ((None, None, None), None), (("8", None, None), 8), (("2x4", None, None), (2, 4)),
    (("1x4", None, None), 4), ((None, "2", "4"), (2, 4)), (("8", "2", None), (2, 4)),
    ((None, "2", None), (2, 1)), ((None, "1", None), None), (("8", "1", None), 8),
    (("2x4", "1", None), (2, 4)), (("1", None, None), None), (("0", None, None), None),
]


def _set_env(monkeypatch, m, p, n):
    for k, v in (("KTPU_MESH", m), ("KTPU_MESH_PODS", p), ("KTPU_MESH_NODES", n)):
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)


def test_parse_mesh_request_grammar(monkeypatch):
    """test_mesh_2d.py's cases, against the JAX function too."""
    from kubernetes_tpu import meshreq as jm

    from kubernetes_tpu_torch import meshreq

    for (m, p, n), want in _GRAMMAR:
        _set_env(monkeypatch, m, p, n)
        assert meshreq.parse_mesh_request() == want == jm.parse_mesh_request(), (m, p, n)
    for req in (None, 8, (2, 4)):
        assert meshreq.mesh_request_devices(req) == jm.mesh_request_devices(req)
    for m, p in [("banana", None), ("-3", None), ("2x4x2", None), ("8", "3"), ("3x0", None)]:
        _set_env(monkeypatch, m, p, None)
        with pytest.raises(ValueError) as ours:
            meshreq.parse_mesh_request()
        with pytest.raises(ValueError) as theirs:
            jm.parse_mesh_request()
        assert str(ours.value) == str(theirs.value)


def test_meshreq_imports_no_backend():
    code = ("import sys\nfor m in ('torch', 'jax', 'jaxlib', 'numpy', 'kubernetes_tpu'):\n    sys.modules[m] = None\n"
            "from kubernetes_tpu_torch.meshreq import parse_mesh_request\nprint(parse_mesh_request('2x4'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "(2, 4)"


def test_mesh_from_env_validates_and_clamps(monkeypatch):
    """test_sharded_routed.py's cases: unset / 1 -> None, garbage raises; a
    request beyond the device count builds the shards asked for (the JAX
    package clamps to its devices, one shard each; the port's shards share
    devices), without a warning; a 2-D request builds the pods x nodes grid
    (tests/test_torch_mesh_2d.py holds it to the JAX package's)."""
    for k in ("KTPU_MESH", "KTPU_MESH_PODS", "KTPU_MESH_NODES"):
        monkeypatch.delenv(k, raising=False)
    assert tm.mesh_from_env(devices="cpu") is None
    monkeypatch.setenv("KTPU_MESH", "1")
    assert tm.mesh_from_env(devices="cpu") is None
    for bad in ("banana", "-3"):
        monkeypatch.setenv("KTPU_MESH", bad)
        with pytest.raises(ValueError, match="KTPU_MESH"):
            tm.mesh_from_env(devices="cpu")
    monkeypatch.setenv("KTPU_MESH", "4")
    m = tm.mesh_from_env(devices="cpu")
    assert m.size == 4 and repr(m) == "NodeMesh(4 shards on 1 device)"
    monkeypatch.setenv("KTPU_MESH", "16")
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        m = tm.mesh_from_env(devices="cpu")
    assert m.size == 16 and repr(m) == "NodeMesh(16 shards on 1 device)"
    monkeypatch.setenv("KTPU_MESH", "2x4")
    m = tm.mesh_from_env(devices="cpu")
    assert isinstance(m, tm.GridMesh) and m.shape == (2, 4)
    # the shard counts of the JAX package's mesh over its 8 CPU devices, up
    # to its device count
    from kubernetes_tpu.parallel.mesh import mesh_from_env as jax_mesh_from_env

    for raw in ("2", "3", "8"):
        monkeypatch.setenv("KTPU_MESH", raw)
        assert tm.mesh_from_env(devices="cpu").size == int(jax_mesh_from_env().size), raw


def test_make_mesh_places_shards_and_refuses():
    m = tm.make_mesh(3, devices="cpu")
    assert m.size == 3 and m.nl(20480) == 6827 and m.base(2, 20480) == 2 * 6827
    assert tm.make_mesh(devices=["cpu", "cpu"]).size == 2
    assert tm.mesh_axis_shards(m) == (1, 3) and tm.mesh_axis_shards(None) == (1, 1)
    assert tm.make_mesh(shape=(2, 4), devices="cpu").shape == (2, 4)
    assert tm.make_mesh(shape=(1, 4), devices="cpu").size == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices='cpu'"):
            tm.make_mesh(4)  # the cards by default; never a quiet CPU mesh
    est = tm.shard_hbm_estimate(51200, 20480, 4, n_res=5, u_classes=101)
    assert est["static_rows"] == 4 * 51200 * 160 and est["total"] == sum(v for k, v in est.items() if k != "total")


def test_node_axis_table_matches_jax():
    from kubernetes_tpu.parallel.partition_rules import node_axis_fields

    assert NODE_AXIS_FIELDS == node_axis_fields()


def test_pad_nodes_semantics():
    """test_sharded_routed.py's case, and field for field the JAX pad_nodes
    of the same arrays."""
    import random

    from helpers import random_cluster
    from kubernetes_tpu.api.snapshot import encode_snapshot as jencode
    from kubernetes_tpu.parallel.mesh import pad_nodes as jpad

    snap = random_cluster(random.Random(10), n_nodes=27, n_pods=48, with_taints=True, with_selectors=True,
                          with_pairwise=True)
    ja, _ = jencode(snap, bucket=False)
    arr = from_jax_arrays({f.name: np.asarray(getattr(ja, f.name)) for f in dataclasses.fields(ja)}, "cpu")
    assert arr.N == 27
    same, n0 = tm.pad_nodes(arr, 1)
    assert same is arr and n0 == 27
    padded, n0 = tm.pad_nodes(arr, 8)
    assert n0 == 27 and padded.N == 32
    assert not padded.node_valid[27:].any() and not padded.node_alloc[27:].any()
    d_sentinel = arr.term_counts0.shape[1] - 1
    assert (padded.node_dom[:, 27:] == d_sentinel).all()
    jp, _ = jpad(ja, 8)
    for f in dataclasses.fields(ja):
        want = np.asarray(getattr(jp, f.name))
        got = getattr(padded, f.name)
        if got.dtype == torch.bfloat16:
            got = got.view(torch.int16).numpy().view(np.uint16)
            want = want.view(np.uint16)
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=f.name)


def test_commit_view_holds_only_what_the_commit_reads():
    """The commit's view of arrays on 3 shards: usage and capacity gathered
    whole (pad rows zero), every other node-axis field cut to zero nodes, so
    a reader of one fails on its shape; the pod-axis fields whole."""
    arr, _ = encode_snapshot(tw.heterogeneous(10, 128, seed=3), device="cpu")
    sa = tm.shard_arrays(arr, _cpu_mesh(3))
    cv = sa.commit_view()
    n = arr.N
    assert cv.N == sa.N == 3 * -(-n // 3)
    assert torch.equal(cv.node_alloc[:n], arr.node_alloc) and not cv.node_alloc[n:].any()
    assert torch.equal(cv.node_used[:n], arr.node_used) and not cv.node_used[n:].any()
    for name, (axis, _) in NODE_AXIS_FIELDS.items():
        if name not in ("node_alloc", "node_used"):
            assert getattr(cv, name).shape[axis] == 0, name
    assert torch.equal(cv.pod_req, arr.pod_req) and torch.equal(cv.pod_valid, arr.pod_valid)
    with pytest.raises(RuntimeError):
        cv.node_valid[None, :] & torch.ones((cv.P, cv.N), dtype=torch.bool)


def test_collectives():
    devs = ["cpu"] * 3
    blocks = [torch.arange(6).reshape(2, 3) + 10 * j for j in range(3)]
    g = collectives.all_gather_nodes(blocks, 1, "cpu")
    assert torch.equal(g, torch.cat(blocks, 1))
    r = collectives.ppermute(blocks, [(j, (j - 1) % 3) for j in range(3)], devs)
    assert all(torch.equal(r[(j - 1) % 3], blocks[j]) for j in range(3))
    half = collectives.ppermute(blocks, [(0, 1)], devs)
    assert torch.equal(half[1], blocks[0]) and not half[0].any() and not half[2].any()
    x = torch.arange(6 * 9).reshape(6, 9)
    a2a = collectives.all_to_all(list(x.split(2, 0)), 1, 0, devs)
    assert all(torch.equal(b, x[:, 3 * j:3 * j + 3]) for j, b in enumerate(a2a))


# ---------------------------------------------------------------------------
# the sharded chunked route
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh") / "ref.npz"
    subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_mesh_reference.py"), str(out)],
        env={**os.environ, **ref.PINNED, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT)},
        cwd=ROOT, check=True, timeout=900,
    )
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


_CARRIED = {}


def carried(name):
    """The JAX encoder's arrays and class index of snapshot `name` (bucket
    off), on the port's side, with the port's single-device steps."""
    if name not in _CARRIED:
        from kubernetes_tpu.api import types as jt
        from kubernetes_tpu.api.delta import DeltaEncoder as JaxEncoder
        from kubernetes_tpu.bench import workloads as jw

        n, p = ref.SNAPSHOTS[name]
        ja, jm = JaxEncoder(bucket=False).encode(ref.pinned(jt, jw, n, p))
        arr = from_jax_arrays({f.name: np.asarray(getattr(ja, f.name)) for f in dataclasses.fields(ja)}, "cpu")
        meta = from_jax_meta(jm)
        cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
        assert arr.N == n and arr.P == p and assign._chunkable(arr, cfg)
        single = {"dense": finish(dispatch(arr, cfg, "cpu", chunked=True)),
                  "inc": finish(dispatch(arr, cfg, "cpu", inc=HoistCache().ensure(arr, meta, cfg)))}
        _CARRIED[name] = (arr, meta, cfg, single)
    return _CARRIED[name]


def _pins(meta):
    """(device row, pinned node id or -1 for the missing node) of every pinned pod."""
    out = []
    for k, node in enumerate(ref.PIN_NODES):
        row = meta.pod_names.index(f"pod-{1 + 11 * k}")
        name = f"node-{node}"
        out.append((row, meta.node_names.index(name) if name in meta.node_names else -1))
    return out


@pytest.mark.parametrize("s", MESH_S)
@pytest.mark.parametrize("mode", ["dense", "inc"])
@pytest.mark.parametrize("name", sorted(ref.SNAPSHOTS))
def test_sharded_route_matches_single_device_and_jax(name, mode, s, jax_ref):
    arr, meta, cfg, single = carried(name)
    N = arr.N
    for field, got in zip(("choices", "used", "ordinals"), single[mode][:3]):
        np.testing.assert_array_equal(got.numpy(), jax_ref[f"{name}/{mode}/{field}"], err_msg=field)
    assert single[mode].sweeps == int(jax_ref[f"{name}/{mode}/sweeps"])
    m = _cpu_mesh(s)
    assert (N % s == 0) == (name == "divisible")
    assign.reset_trace_counts()
    if mode == "inc":
        inc = HoistCache(mesh=m).ensure(arr, meta, cfg)
        assert inc.base_u.shape[1] == m.nl(N) * s
        step = finish(dispatch(arr, cfg, "cpu", inc=inc, mesh=m))
    else:
        step = finish(dispatch(arr, cfg, "cpu", mesh=m))
    assert {k: v for k, v in TRACE_COUNTS.items() if v} == (
        {"sharded_chunked_inc": 1, "class_waves": 1} if mode == "inc" else {"sharded_chunked": 1})
    assert torch.equal(step.choices, single[mode].choices)
    assert step.used.shape[0] == m.nl(N) * s
    assert torch.equal(step.used[:N], single[mode].used) and not step.used[N:].any()
    assert torch.equal(step.ordinals, single[mode].ordinals) and step.sweeps == single[mode].sweeps
    # a pinned pod in every shard, each placed on its pin (the missing node: unplaced)
    nl = m.nl(N)
    pins = _pins(meta)
    assert {node // nl for _, node in pins if node >= 0} == set(range(s))
    for row, node in pins:
        assert int(step.choices[row]) == node


def _churn(arr, meta):
    """Cycles of usage for the HoistCache: start, a few nodes in two shards,
    one node of the last shard, nothing, three in four nodes (a full hoist:
    at least half the nodes, padded or not, as the JAX package counts them),
    the last node only."""
    used = arr.node_used.clone()
    req = arr.pod_req[0]
    out = [used]
    most = [n for n in range(arr.N) if n % 4]
    for rows in ([1, 2, 100, 101, 150], [arr.N - 2], [], most, [arr.N - 1]):
        used = used.clone()
        if rows:
            used[rows] += req
        out.append(used)
    return out


@pytest.mark.parametrize("s", MESH_S)
@pytest.mark.parametrize("name", sorted(ref.SNAPSHOTS))
def test_hoist_cache_on_mesh_over_churn(name, s):
    arr, meta, cfg, _ = carried(name)
    N = arr.N
    m = _cpu_mesh(s)
    nl = m.nl(N)
    one, sharded = HoistCache(), HoistCache(mesh=m)
    prev = None
    for used in _churn(arr, meta):
        a = dataclasses.replace(arr, node_used=used)
        want = one.ensure(a, meta, cfg)
        got = sharded.ensure(a, meta, cfg)
        assert got.stat_u.shape == (want.stat_u.shape[0], bitplane.words_for(nl * s))
        for plane in ("stat_u", "fit_u"):
            g = bitplane.unpack(getattr(got, plane), nl * s)
            assert torch.equal(g[:, :N], bitplane.unpack(getattr(want, plane), N)), plane
            assert not g[:, N:].any()
        assert torch.equal(got.base_u[:, :N].view(torch.int32), want.base_u.view(torch.int32))
        assert torch.equal(got.req_u, want.req_u) and torch.equal(got.cls, want.cls)
        if sharded.last["action"] == "patch":
            dirty = np.flatnonzero((used != prev).any(dim=1).numpy())
            for j in range(s):
                own = dirty[(dirty >= j * nl) & (dirty < (j + 1) * nl)] - j * nl
                np.testing.assert_array_equal(np.sort(sharded.shard_cols[j]), own)
        prev = used
    actions = [h["action"] for h in sharded.history]
    assert actions == [h["action"] for h in one.history]
    assert actions == ["static_rebuild", "patch", "patch", "hit", "full", "patch"]


# ---------------------------------------------------------------------------
# the encoder and the pipeline on the mesh
# ---------------------------------------------------------------------------

def _wave(types, seed):
    """test_sharded_routed.py's waves with 128 pods each (a multiple of the
    chunked route's 128, the only route the mesh runs): 10 nodes of random
    cpu, pods of random cpu requests."""
    gi = 1024**3
    rng = np.random.default_rng(seed)
    nodes = [types.Node(name=f"w{seed}-n{i}", allocatable={types.CPU: int(rng.integers(2000, 8000)),
                                                            types.MEMORY: 8 * gi, types.PODS: 110})
             for i in range(10)]
    pods = [types.Pod(name=f"w{seed}-p{j}", requests={types.CPU: int(rng.integers(100, 1500)),
                                                       types.MEMORY: 128 * 1024**2})
            for j in range(128)]
    return nodes, pods


def test_pipelined_loop_with_mesh_matches_serial():
    from kubernetes_tpu.api import types as jt
    from kubernetes_tpu.api.snapshot import Snapshot as JaxSnapshot
    from kubernetes_tpu.parallel.pipeline import run_serial as jax_serial

    waves = [Snapshot(*_wave(tt, s)) for s in range(4)]
    oracle = list(run_serial(waves, device="cpu"))
    want = list(jax_serial([JaxSnapshot(*_wave(jt, s)) for s in range(4)]))
    assert oracle == want
    m = _cpu_mesh(3)
    loop = PipelinedBatchLoop(depth=1, device="cpu", mesh=m)
    assign.reset_trace_counts()
    got = list(loop.run(waves))
    assert got == oracle
    assert TRACE_COUNTS["sharded_chunked_inc"] == 4
    assert loop.enc.mesh == m and loop.hoist.mesh == m
    # every node-axis field is resident per shard, one tensor each
    for name in NODE_AXIS_FIELDS:
        ents = [loop.enc._dev[(name, j)] for j in range(3)]
        assert len({id(e[2]) for e in ents}) == 3
        axis = NODE_AXIS_FIELDS[name][0]
        assert {e[2].shape[axis] for e in ents} == {m.nl(16)}


def test_delta_encoder_on_mesh_replaces_only_changed_shards():
    snap = tw.heterogeneous(40, 200)
    m = _cpu_mesh(3)
    enc = DeltaEncoder(device="cpu", mesh=m)
    host, meta = enc.encode(snap)
    a1, _ = enc.to_device(host, meta)
    assert a1.N == 66 and a1.nl == 22 and a1.P == host.P
    one, _ = encode_snapshot(snap, device="cpu")
    for name in _NODE_FIELDS:
        assert torch.equal(a1.gather(name)[:one.N] if name != "node_dom" else a1.gather(name)[:, :one.N],
                           getattr(one, name)), name
    assert not a1.gather("node_valid")[one.N:].any()
    used = host.node_used.copy()
    used[45] += 1  # shard 2's rows only
    a2, _ = enc.to_device(dataclasses.replace(host, node_used=used), meta)
    assert a2.shards[0].node_used is a1.shards[0].node_used and a2.shards[1].node_used is a1.shards[1].node_used
    assert a2.shards[2].node_used is not a1.shards[2].node_used
    assert all(getattr(a2.shards[j], f) is getattr(a1.shards[j], f) for j in range(3)
               for f in ("node_alloc", "node_labels", "pod_req"))
    enc.set_mesh(_cpu_mesh(2))
    assert not enc._dev
    assert enc.to_device(host, meta)[0].nl == 32


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_mesh.py")
    from kubernetes_tpu_torch.ops import kernels

    kernels.build(["stitch_planes", "packed_static_rows", "class_usage_hoist"])
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 7, 4097])
@pytest.mark.parametrize("nl", [1, 5, 31, 32, 33, 37, 5120, 6827])
@pytest.mark.parametrize("s", range(1, 9))
def test_stitch_planes_kernel(card, s, nl, rows):
    """K17 == plain == the flat packing of the same bits, over every shard
    count up to MAX_SHARDS; on words whose block tails are set too, == plain
    (which reads only each block's nl bits); one launch a call."""
    from kubernetes_tpu_torch.ops import kernels

    gen = torch.Generator(device=card).manual_seed(s * 100003 + nl * 11 + rows)
    x = torch.rand((rows, s * nl), generator=gen, device=card) < 0.4
    w = bitplane.pack_blocks(x, s)
    kernels.reset_launches()
    got = kernels.stitch_planes(w, nl)
    assert kernels.LAUNCHES["stitch_planes"] == 1
    assert torch.equal(got, bitplane.stitch_planes_plain(w, nl))
    assert torch.equal(got, bitplane.pack(x))
    junk = torch.randint(-2**31, 2**31, w.shape, generator=gen, device=card, dtype=torch.int64).to(torch.int32)
    assert torch.equal(kernels.stitch_planes(junk, nl), bitplane.stitch_planes_plain(junk, nl))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [2, 3])
def test_shard_hoists_kernels(card, s):
    """K7, K3 and K4 launched on a shard's rows with its base == their
    plain versions on the same rows, pins in every shard included."""
    from kubernetes_tpu_torch.ops import kernels

    n, p = ref.SNAPSHOTS["padded"]
    arr, meta = encode_snapshot(ref.pinned(tt, tw, n, p), device=card)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    m = tm.make_mesh(s)
    sa = tm.shard_arrays(arr, m)
    r_u = torch.as_tensor(meta.class_first_pod, device=card)
    req_u = arr.pod_req[r_u].contiguous()
    for j, sh in enumerate(sa.shards):
        base = m.base(j, sa.N)
        assert torch.equal(kernels.packed_static_rows(sh, base=base), assign.packed_static_rows_plain(sh, base=base))
        stat_k = kernels.class_static_hoist(sh, r_u, base=base)
        stat_p = incremental._static_hoist_plain(incremental.class_view(sh, r_u), base=base)[0]
        assert torch.equal(stat_k, stat_p)
        bk, fk = kernels.class_usage_hoist(req_u, sh.node_used, sh.node_alloc, cfg)
        bp, fp = incremental._usage_hoist_plain(req_u, sh.node_used, sh.node_alloc, cfg)
        assert torch.equal(bk.view(torch.int32), bp.view(torch.int32)) and torch.equal(fk, fp)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [2, 3, 4])
@pytest.mark.parametrize("mode", ["dense", "inc"])
def test_sharded_route_on_card(card, mode, s):
    n, p = ref.SNAPSHOTS["padded"]
    arr, meta = encode_snapshot(ref.pinned(tt, tw, n, 1024), device=card)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    m = tm.make_mesh(s)
    if mode == "inc":
        want = finish(dispatch(arr, cfg, inc=HoistCache().ensure(arr, meta, cfg)))
        got = finish(dispatch(arr, cfg, inc=HoistCache(mesh=m).ensure(arr, meta, cfg), mesh=m))
    else:
        want = finish(dispatch(arr, cfg))
        got = finish(dispatch(arr, cfg, mesh=m))
    N = arr.N
    assert torch.equal(got.choices, want.choices) and torch.equal(got.used[:N], want.used)
    assert not got.used[N:].any()
    assert torch.equal(got.ordinals, want.ordinals) and got.sweeps == want.sweeps
