"""The per-step collectives of the node mesh (parallel/sharded.py, the
helpers of ops/assign.py and parallel/collectives.py, the spread pmin of
ops/pairwise.py, HoistCache(mesh=)'s per-shard class planes, gangs and the
pipeline on the mesh) against the JAX package's sharded programs and
against the port on one device.

On the CPU:

- pmax / pmin / psum combine in shard order and leave the result on every
  shard's device;
- _rmax, _rmin, _gather_cols (f32 with +-inf, and bool), _gather_at_nodes,
  _global_top_k and the spread step with its pmin (a shard with no eligible
  node included) over per-shard blocks == the JAX package's functions
  under shard_map, for S in {2, 4, 8} and nl in {5, 40} (under and over the
  speculation's Zr = 32), ties across shard boundaries included;
- the sharded per-pod scan (fit-only: basic; full stage set:
  spread_affinity), the sharded rounds route dense and on class state, for
  S in {2, 3, 8} on 24 nodes (every S divides) and 25 (none does), with
  nodeName pins in every shard that holds a real node: choices, usage (the
  pad rows zero), ordinals and sweeps == the port on one device, the route
  counts are the sharded ones; the port on one device == the JAX single
  device, and the port on the mesh == the JAX sharded programs (the
  shard_map tests/torch_sharded_reference.py builds, in a fresh process
  with 8 virtual devices; ~55 s, started when the module starts, while the
  port-only tests run);
- HoistCache(mesh=) on an all-stages (pairwise) config over warm churn: the
  one-device action history; each shard's elig_u, traw_u, naraw_u, img_u,
  stat_u, fit_u and base_u == its columns of the one-device planes; dirty
  columns patched by their owners only; the class-state rounds step ==
  one device;
- schedule_with_gangs(mesh=) through the chunked route (gang(16, 8, 1))
  and the rounds route (gang_pinned's rounds batches at N=6144) == the
  port's one-device host fixpoint == the JAX host fixpoint;
- PipelinedBatchLoop(mesh=) over config-3-shaped warm waves
  (spread_affinity(24, 64), the rounds route on class state) == run_serial
  == the one-device loop;
- the refusals that stay: a gated shard-mode launch, more shards or
  blocks than a card holds, shards spread over several ranks.

The ``cuda`` legs import no JAX and skip without a card: K1 with its base
== plain with pins in every shard; K2, K11 and K12 (dense and class-row) in
shard mode == their plain sharded versions == the one-device kernels for
S in {2, 3, 4, 8}; an oversize S is refused; a one-shard mesh launches the
one-device kernels:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_mesh_steps.py

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
from kubernetes_tpu_torch.api.snapshot import Snapshot, encode_snapshot
from kubernetes_tpu_torch.bench import workloads as tw
from kubernetes_tpu_torch.convert import from_jax_arrays, from_jax_meta
from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, bitplane, gang, infer_score_config, kernels, pairwise
from kubernetes_tpu_torch.ops.assign import TRACE_COUNTS, dispatch, finish
from kubernetes_tpu_torch.ops.incremental import HoistCache
from kubernetes_tpu_torch.parallel import collectives, mesh as tm
from kubernetes_tpu_torch.parallel.pipeline import PipelinedBatchLoop, run_serial
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parent.parent
MESH_S = [2, 3, 8]
KINDS = ("scan", "rounds", "inc")
ROUTE = {"scan": "sharded_plain", "rounds": "sharded_rounds", "inc": "sharded_rounds_inc"}


def _cpu_mesh(s):
    return tm.make_mesh(s, devices="cpu")


# ---------------------------------------------------------------------------
# the JAX side, computed in a fresh process while the port-only tests run
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", autouse=True)
def _jax_proc(tmp_path_factory):
    if importlib.util.find_spec("jax") is None:  # the card's machine: the cuda legs need no JAX
        yield None
        return
    out = tmp_path_factory.mktemp("steps") / "ref.npz"
    log = out.with_suffix(".log").open("w+")
    env = {**os.environ, **ref.PINNED, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT)}
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_sharded_reference.py"), str(out)],
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


# ---------------------------------------------------------------------------
# the port's arrays (the JAX encoder's, N as given) and results
# ---------------------------------------------------------------------------

_ENC = {}
_RES = {}


def encoded(name):
    """SNAPSHOTS[name] encoded by the JAX DeltaEncoder(bucket=False), as the
    port's arrays and meta, with its config."""
    if name not in _ENC:
        from kubernetes_tpu.api.delta import DeltaEncoder as JaxEncoder
        from kubernetes_tpu.bench import workloads as jw

        gen, n, p = ref.SNAPSHOTS[name]
        ja, jm = JaxEncoder(bucket=False).encode(ref.pinned(jw, gen, n, p))
        arr = from_jax_arrays({f.name: np.asarray(getattr(ja, f.name)) for f in dataclasses.fields(ja)}, "cpu")
        _ENC[name] = (arr, from_jax_meta(jm), infer_score_config(arr, DEFAULT_SCORE_CONFIG))
    return _ENC[name]


def _kinds(name):
    return KINDS if name in ref.WITH_INC else KINDS[:2]


def results(name, s):
    """{kind: Step} of the port on one device (s = 1) or on a CPU mesh of s
    shards, each route counted on its own."""
    key = (name, s)
    if key not in _RES:
        arr, meta, cfg = encoded(name)
        m = _cpu_mesh(s) if s > 1 else None
        out = {}
        for kind in _kinds(name):
            inc = None
            if kind == "inc":
                inc = HoistCache(mesh=m).ensure(arr, meta, cfg)
            assign.reset_trace_counts()
            out[kind] = finish(dispatch(arr, cfg, "cpu", inc=inc, mesh=m, chunked=kind != "scan"))
            route = ROUTE[kind] if s > 1 else {"scan": "plain", "rounds": "rounds", "inc": "rounds_inc"}[kind]
            assert {k: v for k, v in TRACE_COUNTS.items() if v} == {route: 1}, (kind, s)
        _RES[key] = out
    return _RES[key]


def _pins(meta):
    """(row, pinned node id or -1 for the missing node) of every pinned pod."""
    out = []
    for k, node in enumerate(ref.PIN_NODES):
        row = meta.pod_names.index(f"pod-{1 + 5 * k}")
        name = f"node-{node}"
        out.append((row, meta.node_names.index(name) if name in meta.node_names else -1))
    return out


# ---------------------------------------------------------------------------
# the collectives and helpers
# ---------------------------------------------------------------------------

def test_collectives_combine_in_shard_order():
    rng = np.random.default_rng(0)
    parts = [torch.from_numpy(rng.integers(-5, 5, (3, 4)).astype(np.float32)) for _ in range(3)]
    stacked = torch.stack(parts)
    for fn, want in ((collectives.pmax, stacked.max(0).values), (collectives.pmin, stacked.min(0).values),
                     (collectives.psum, parts[0] + parts[1] + parts[2])):
        out = fn(parts)
        assert len(out) == 3 and all(torch.equal(o, want) for o in out)
    one = [torch.tensor([[1.0, 3.0, float("inf")]])]
    assert torch.equal(assign._rmax(one)[0], one[0].max(dim=-1).values)
    assert torch.equal(assign._rmin(one)[0], one[0].min(dim=-1).values)


# ---------------------------------------------------------------------------
# the sharded per-pod and rounds scans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", MESH_S)
@pytest.mark.parametrize("name", sorted(ref.SNAPSHOTS))
def test_sharded_scans_match_single_device(name, s):
    arr, meta, cfg = encoded(name)
    N = arr.N
    assert (N % s == 0) == (N == 24)
    one, got = results(name, 1), results(name, s)
    m = _cpu_mesh(s)
    nl = m.nl(N)
    for kind in _kinds(name):
        g, w = got[kind], one[kind]
        assert torch.equal(g.choices, w.choices), kind
        assert g.used.shape[0] == nl * s and torch.equal(g.used[:N], w.used) and not g.used[N:].any(), kind
        assert torch.equal(g.ordinals, w.ordinals) and g.sweeps == w.sweeps, kind
    # a pinned pod in every shard that holds a real node; each lands on its
    # pin or nowhere
    pins = _pins(meta)
    assert {node // nl for _, node in pins if node >= 0} == {j for j in range(s) if j * nl < N}
    for row, node in pins:
        assert int(got["scan"].choices[row]) in (node, -1)
    assert any(int(got["scan"].choices[row]) == node >= 0 for row, node in pins)


def test_sharded_schedule_batch_is_the_per_pod_scan():
    from kubernetes_tpu_torch.parallel import sharded_schedule_batch

    arr, _, cfg = encoded("sa-25")
    assign.reset_trace_counts()
    c, u = sharded_schedule_batch(arr, cfg, _cpu_mesh(3), device="cpu")
    assert TRACE_COUNTS["sharded_plain"] == 1
    assert torch.equal(c, results("sa-25", 1)["scan"].choices) and torch.equal(u[:arr.N], results("sa-25", 1)["scan"].used)


# ---------------------------------------------------------------------------
# HoistCache(mesh=) with the rounds route's class planes
# ---------------------------------------------------------------------------

def _churn(arr):
    """Usage cycles: start, a few nodes in three shards, one node, nothing,
    three in four nodes (a full hoist), the last real node."""
    used = arr.node_used.clone()
    req = arr.pod_req[0]
    out = [used]
    for rows in ([1, 2, 12, 20], [arr.N - 2], [], [n for n in range(arr.N) if n % 4], [arr.N - 1]):
        used = used.clone()
        if rows:
            used[rows] += req
        out.append(used)
    return out


@pytest.mark.parametrize("s", [3, 4])
def test_hoist_cache_rounds_planes_on_mesh_over_churn(s):
    arr, meta = encode_snapshot(tw.all_stages(30, 64), device="cpu")  # N = 32 (3 shards: padded to 33)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    assert cfg.enable_pairwise and cfg.enable_taint_score and cfg.enable_node_pref and assign._image_on(arr, cfg)
    N = arr.N
    m = _cpu_mesh(s)
    nl = m.nl(N)
    one, sharded = HoistCache(), HoistCache(mesh=m)
    prev = None
    for used in _churn(arr):
        a = dataclasses.replace(arr, node_used=used)
        want = one.ensure(a, meta, cfg)
        got = sharded.ensure(a, meta, cfg)
        assert got.stat_u is None and len(got.shards) == s  # the rounds route reads the shards' planes
        for j, sh in enumerate(got.shards):
            lo, hi = j * nl, min((j + 1) * nl, N)
            w = hi - lo
            for plane in ("stat_u", "fit_u", "elig_u"):
                g = bitplane.unpack(getattr(sh, plane), nl)
                assert torch.equal(g[:, :w], bitplane.unpack(getattr(want, plane), N)[:, lo:hi]), (plane, j)
                assert not g[:, w:].any(), (plane, j)
            for plane in ("base_u", "traw_u", "naraw_u", "img_u"):
                g, wp = getattr(sh, plane), getattr(want, plane)
                assert torch.equal(g[:, :w].contiguous().view(torch.int16 if g.dtype == torch.bfloat16 else torch.int32),
                                   wp[:, lo:hi].contiguous().view(torch.int16 if g.dtype == torch.bfloat16
                                                                  else torch.int32)), (plane, j)
        if sharded.last["action"] == "patch":
            dirty = np.flatnonzero((used != prev).any(dim=1).numpy())
            for j in range(s):
                own = dirty[(dirty >= j * nl) & (dirty < (j + 1) * nl)] - j * nl
                np.testing.assert_array_equal(np.sort(sharded.shard_cols[j]), own)
        prev = used
    actions = [h["action"] for h in sharded.history]
    assert actions == [h["action"] for h in one.history]
    assert actions == ["static_rebuild", "patch", "patch", "hit", "full", "patch"]
    # the class-state rounds step on the last cycle's planes
    want = finish(dispatch(a, cfg, "cpu", inc=one.ensure(a, meta, cfg)))
    got = finish(dispatch(a, cfg, "cpu", inc=sharded.ensure(a, meta, cfg), mesh=m))
    assert torch.equal(got.choices, want.choices) and torch.equal(got.used[:N], want.used)
    assert torch.equal(got.ordinals, want.ordinals) and got.sweeps == want.sweeps


# ---------------------------------------------------------------------------
# the pipeline on the mesh
# ---------------------------------------------------------------------------

def test_pipelined_loop_on_mesh_config3_warm():
    from kubernetes_tpu_torch.api.delta import DeltaEncoder
    from kubernetes_tpu_torch.ops import schedule_batch

    snap = tw.spread_affinity(24, 64, seed=0)
    runs = {}
    for mesh in (None, _cpu_mesh(3)):
        enc = DeltaEncoder("cpu")
        arr, meta = enc.encode_device(snap)
        c, _ = schedule_batch(arr, infer_score_config(arr, DEFAULT_SCORE_CONFIG), device="cpu")
        loop = PipelinedBatchLoop(encoder=enc, depth=1, device="cpu", mesh=mesh)
        subs = []

        def submit(sn, loop=loop, subs=subs):
            subs.append(sn)
            return loop.submit(sn)

        assign.reset_trace_counts()
        _, fetched, _, _ = tw.warm_waves(snap, tw.verdicts_of(c, meta), submit, loop.drain, Snapshot)
        runs[mesh is None] = (fetched, [h["action"] for h in loop.hoist.history], dict(TRACE_COUNTS), subs)
    (f1, a1, t1, _), (fm, am, tm_, subs) = runs[True], runs[False]
    assert fm == f1 and am == a1
    assert t1["rounds_inc"] == 6 and tm_["sharded_rounds_inc"] == 6
    assert list(run_serial(subs, device="cpu")) == [fm[w] for w in range(2, 8)]


# ---------------------------------------------------------------------------
# what the mesh still refuses
# ---------------------------------------------------------------------------

def test_inc_node_axis_table_matches_jax():
    """Every class plane HoistCache(mesh=) cuts per shard sits on the node
    axis the JAX package's rule table gives its inc.* row."""
    from kubernetes_tpu.parallel.partition_rules import NODE_AXIS, spec_for

    from kubernetes_tpu_torch.parallel.partition_rules import INC_NODE_AXIS

    want = {k: tuple(spec_for(f"inc.{k}")).index(NODE_AXIS) for k in
            ("stat_u", "base_u", "fit_u", "elig_u", "traw_u", "naraw_u", "img_u")}
    assert INC_NODE_AXIS == want


def test_mesh_refusals_that_stay():
    with pytest.raises(NotImplementedError, match="A12"):
        kernels.shard_grid_check(kernels.MAX_SHARDS + 1, kernels.MAX_SHARDS + 1, 132)
    with pytest.raises(NotImplementedError, match="A12"):
        kernels.shard_grid_check(8, 16 * 9, 132)  # C * S past the card's SMs
    kernels.shard_grid_check(8, 16 * 8, 132)  # 128 blocks fit 132 SMs
    arr, _, cfg = encoded("sa-24")
    sa = tm.shard_arrays(arr, _cpu_mesh(2))
    done = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="A12"):
        kernels.rounds_shard(sa, cfg, done=done)
    with pytest.raises(NotImplementedError, match="A12"):
        kernels.full_scan_shard(sa, cfg, None, None, None, done=done)
    with pytest.raises(NotImplementedError, match="A12"):
        kernels.fit_scan_shard(None, sa, cfg, done=done)
    # without the gate, CPU tensors are refused: a shard mode launches or raises
    with pytest.raises(ValueError, match="CUDA"):
        kernels.rounds_shard(sa, cfg)
    # shards on several ranks: the shard modes exchange within one process only
    from kubernetes_tpu_torch.parallel.collectives import RankSpan

    spread = dataclasses.replace(sa, mesh=tm.NodeMesh(sa.mesh.devices, RankSpan(0, 2, "gloo")))
    for launch in (lambda: kernels.rounds_shard(spread, cfg),
                   lambda: kernels.full_scan_shard(spread, cfg, None, None, None),
                   lambda: kernels.fit_scan_shard(None, spread, cfg)):
        with pytest.raises(NotImplementedError, match="ranks.*A12"):
            launch()


# ---------------------------------------------------------------------------
# against the JAX package (the reference process has had the port-only
# tests' time to run)
# ---------------------------------------------------------------------------

def _split(x, s):
    return list(torch.from_numpy(np.ascontiguousarray(x)).chunk(s, dim=-1))


@pytest.mark.parametrize("nl", ref.HELPER_NL)
@pytest.mark.parametrize("s", ref.HELPER_S)
def test_helpers_match_jax(s, nl, jax_ref):
    inp = ref.helper_inputs(s, nl)
    want = {k.rsplit("/", 1)[1]: v for k, v in jax_ref.items() if k.startswith(f"helpers/s{s}-nl{nl}/")}
    x = _split(inp["x"], s)
    cols = torch.from_numpy(inp["cols"])
    np.testing.assert_array_equal(assign._rmax(x)[0].numpy(), want["rmax"])
    np.testing.assert_array_equal(assign._rmin(x)[0].numpy(), want["rmin"])
    np.testing.assert_array_equal(assign._gather_cols(x, cols, nl)[0].numpy(), want["gcols"])
    gb = assign._gather_cols(_split(inp["b"], s), cols, nl)[0]
    assert gb.dtype == torch.bool
    np.testing.assert_array_equal(gb.numpy(), want["gcols_bool"])
    gat = assign._gather_at_nodes(_split(inp["dom"], s), torch.from_numpy(inp["rows"]), cols, nl)[0]
    np.testing.assert_array_equal(gat.numpy(), want["gat"])
    k = min(32, s * nl)
    tv, ti = (v[0] for v in assign._global_top_k(x, k))
    np.testing.assert_array_equal(tv.numpy(), want["topv"])
    np.testing.assert_array_equal(ti.numpy(), want["topi"])
    # the same as top_k of the whole row (lowest index on ties)
    wv, wi = assign.top_k(torch.from_numpy(inp["x"]), k)
    assert torch.equal(tv, wv) and torch.equal(ti, wi)
    # the spread step: shard 1 has no eligible node, its local min is inf
    cnt, hk, elig = _split(inp["cnt"], s), _split(inp["has_key"], s), _split(inp["elig"], s)
    terms, skew, hard = (torch.from_numpy(inp[k]) for k in ("terms", "skew", "hard"))
    local = [pairwise.spread_min(c, h, terms, e) for c, h, e in zip(cnt, hk, elig)]
    assert torch.isinf(local[1]).all()
    mm = collectives.pmin(local)
    got = [pairwise.spread_step(c, h, terms, skew, hard, e, min_match=m) for c, h, e, m in zip(cnt, hk, elig, mm)]
    np.testing.assert_array_equal(torch.cat([g[0] for g in got]).numpy(), want["spread_ok"])
    np.testing.assert_array_equal(torch.cat([g[1] for g in got]).numpy(), want["spread_raw"])
    whole = pairwise.spread_step(*(torch.from_numpy(inp[k]) for k in ("cnt", "has_key", "terms", "skew", "hard",
                                                                     "elig")))
    np.testing.assert_array_equal(whole[0].numpy(), want["spread_ok"])


@pytest.mark.parametrize("name", sorted(ref.SNAPSHOTS))
def test_sharded_scans_match_jax(name, jax_ref):
    arr, _, _ = encoded(name)
    for kind in _kinds(name):
        w = results(name, 1)[kind]
        pre = f"{name}/single/{kind}/"
        np.testing.assert_array_equal(w.choices.numpy(), jax_ref[pre + "choices"])
        np.testing.assert_array_equal(w.used.numpy(), jax_ref[pre + "used"])
        if kind != "scan":
            np.testing.assert_array_equal(w.ordinals.numpy(), jax_ref[pre + "ordinals"])
            assert w.sweeps == int(jax_ref[pre + "sweeps"])
    for s, n in ref.MESH:
        if n != arr.N:
            continue
        for kind in _kinds(name):
            g = results(name, s)[kind]
            pre = f"{name}/s{s}/{kind}/"
            np.testing.assert_array_equal(g.choices.numpy(), jax_ref[pre + "choices"], err_msg=pre)
            np.testing.assert_array_equal(g.used.numpy(), jax_ref[pre + "used"], err_msg=pre)
            if kind != "scan":
                np.testing.assert_array_equal(g.ordinals.numpy(), jax_ref[pre + "ordinals"], err_msg=pre)
                assert g.sweeps == int(jax_ref[pre + "sweeps"]), pre


def _gang_arrays(name):
    if name == "gang-16x8":
        return encode_snapshot(tw.gang(16, 8, 1, seed=1), device="cpu")[0]
    return encode_snapshot(tw.gang_pinned(name), device="cpu")[0]


@pytest.mark.parametrize("name", ref.GANGS)
def test_gangs_on_mesh_match_one_device_and_jax(name, jax_ref):
    arr = _gang_arrays(name)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    route = "sharded_chunked" if assign._chunkable(arr, cfg) else "sharded_rounds"
    assert (route == "sharded_chunked") == (name == "gang-16x8")
    want = gang.schedule_with_gangs(arr, cfg, with_ordinals=True, device="cpu", chunked=True)
    for field, w in zip(("choices", "used", "ordinals"), want):
        np.testing.assert_array_equal(w.numpy(), jax_ref[f"gang/{name}/{field}"], err_msg=field)
    assert want[3] == int(jax_ref[f"gang/{name}/sweeps"])
    assign.reset_trace_counts()
    got = gang.schedule_with_gangs(arr, cfg, with_ordinals=True, device="cpu", mesh=_cpu_mesh(3))
    assert TRACE_COUNTS[route] >= 2 and sum(TRACE_COUNTS.values()) == TRACE_COUNTS[route]  # iterations
    assert torch.equal(got[0], want[0]) and torch.equal(got[1][:arr.N], want[1]) and not got[1][arr.N:].any()
    assert torch.equal(got[2], want[2]) and got[3] == want[3]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_mesh_steps.py")
    kernels.build(["static_feasible", "fit_scan", "full_scan", "rounds", "packed_static_rows", "score_planes",
                   "class_usage_hoist"])
    return torch.device("cuda")


def _card_arrays(card, gen, n, p):
    """The port's own encode of ref.pinned (N bucketed: 32 for n = 24, 25)."""
    arr, meta = encode_snapshot(ref.pinned(tw, gen, n, p), device=card)
    return arr, meta, infer_score_config(arr, DEFAULT_SCORE_CONFIG)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [2, 3, 8])
def test_static_feasible_base_kernel(card, s):
    from kubernetes_tpu_torch.ops import filters

    arr, _, _ = _card_arrays(card, "spread_affinity", 25, 64)
    sa = tm.shard_arrays(arr, tm.make_mesh(s))
    for j, sh in enumerate(sa.shards):
        b = sa.mesh.base(j, sa.N)
        assert torch.equal(kernels.static_feasible(sh, base=b), filters.static_feasible_plain(sh, base=b))


@pytest.mark.cuda
@pytest.mark.parametrize("s", [2, 3, 4, 8])
@pytest.mark.parametrize("gen", ["spread_affinity", "basic", "all_stages"])
def test_shard_mode_kernels(card, gen, s):
    """K2 / K11 and K12 (dense and class-row) in shard mode == their plain
    sharded versions == the one-device kernels; all_stages launches K10 per
    shard and reads each shard's image columns."""
    from kubernetes_tpu_torch.parallel import sharded

    arr, meta, cfg = _card_arrays(card, gen, 25, 64)
    m = tm.make_mesh(s)
    sa = tm.shard_arrays(arr, m)
    N = arr.N
    kernels.reset_launches()
    perpod = finish(dispatch(sa, cfg, mesh=m, chunked=False))
    key = "fit_scan_shard" if assign.fit_only(cfg, arr) else "full_scan_shard"
    assert kernels.LAUNCHES[key] == 1
    plain_c, plain_u = sharded.sharded_schedule_scan_plain(sa, cfg)
    one = finish(dispatch(arr, cfg, chunked=False))
    assert torch.equal(perpod.choices, plain_c) and torch.equal(perpod.used, plain_u)
    assert torch.equal(perpod.choices, one.choices) and torch.equal(perpod.used[:N], one.used)
    kernels.reset_launches()
    got = finish(dispatch(sa, cfg, mesh=m))
    assert kernels.LAUNCHES["rounds_shard"] == 1
    want = sharded.sharded_schedule_scan_rounds_plain(sa, cfg)
    one = finish(dispatch(arr, cfg))
    for g, w, o in zip(got[:3], want[:3], one[:3]):
        assert torch.equal(g, w) and torch.equal(g[:o.shape[0]], o)
    assert got.sweeps == want[3] == one.sweeps
    if gen != "basic":  # basic's pods are all distinct: no class state
        inc = HoistCache(mesh=m).ensure(arr, meta, cfg)
        kernels.reset_launches()
        gi = finish(dispatch(arr, cfg, inc=inc, mesh=m))
        assert kernels.LAUNCHES["rounds_shard"] == 1
        wi = sharded.sharded_schedule_scan_rounds_plain(sa, cfg, inc=inc)
        for g, w in zip(gi[:3], wi[:3]):
            assert torch.equal(g, w)
        assert torch.equal(gi.choices, got.choices) and gi.sweeps == wi[3]


@pytest.mark.cuda
def test_oversize_and_one_shard(card):
    arr, _, cfg = _card_arrays(card, "spread_affinity", 25, 64)
    with pytest.raises(NotImplementedError, match="A12"):
        dispatch(arr, cfg, mesh=tm.make_mesh(kernels.MAX_SHARDS + 1))
    kernels.reset_launches()
    got = finish(dispatch(arr, cfg, mesh=tm.make_mesh(1)))
    assert kernels.LAUNCHES["rounds"] == 1 and kernels.LAUNCHES["rounds_shard"] == 0
    assert torch.equal(got.choices, finish(dispatch(arr, cfg)).choices)
