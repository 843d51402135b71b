"""KTPU_SCORE_DTYPE in the port (ops/bitplane.py), held to the JAX package.

Both packages read the knob once, at import, so every comparison runs each
side in a fresh process with the knob pinned
(tests/torch_score_dtype_reference.py, beside KTPU_RCHUNK=16,
KTPU_REPAIR_ITERS=1, KTPU_FORCE_CHUNKED=1):

- ROADMAP C5's case through both Schedulers in mode="tpu" (the port's on the
  CPU): node-b under bf16, node-a under f32, as the JAX oracle binds it;
- a random_cluster sweep under f32 (8 seeds; preferred node-affinity sums
  past 256 and image scores off the bf16 lattice): the per-pod, rounds and
  class-state routes' choices, usage, ordinals and sweeps and the native
  engine's choices and usage equal the JAX package's; the raw planes (the
  plain score-plane producers, the encoder's image_score, native/static_np)
  equal the JAX planes bit for bit;
- any other value raises ValueError with the JAX package's message.

The card legs (marked ``cuda``; ``python -m pytest --noconftest -m cuda
tests/test_torch_score_dtype.py`` on the card) switch the port to f32 in
their own process (bitplane.SCORE_DTYPE, which every storage helper reads at
call time) and hold K10's f32 build and K11 and K12 reading f32 planes (the
dense and class-row modes) to their plain versions.
"""

import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_score_dtype_reference as ref
from kubernetes_tpu_torch.api.snapshot import encode_snapshot
from kubernetes_tpu_torch.bench import workloads as tw
from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, bitplane, infer_score_config, kernels
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parent.parent
SIDES = [("jax", "f32"), ("port", "f32"), ("jax", "bf16"), ("port", "bf16")]


def run_side(side: str, dtype: str, out: Path) -> dict:
    subprocess.run([sys.executable, str(ROOT / "tests" / "torch_score_dtype_reference.py"), side, str(out)],
                   env={**os.environ, **ref.PINNED, "KTPU_SCORE_DTYPE": dtype, "JAX_PLATFORMS": "cpu",
                        "PYTHONPATH": str(ROOT)},
                   cwd=ROOT, check=True, timeout=900)
    with np.load(out) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    d = tmp_path_factory.mktemp("score_dtype")
    with ThreadPoolExecutor(len(SIDES)) as ex:
        futs = {sd: ex.submit(run_side, *sd, d / f"{sd[0]}-{sd[1]}.npz") for sd in SIDES}
        return {sd: f.result() for sd, f in futs.items()}


@pytest.mark.parametrize("dtype,want", [("bf16", "node-b"), ("f32", "node-a")])
def test_c5_case_binds_as_the_jax_package(sides, dtype, want):
    jax, port = sides[("jax", dtype)], sides[("port", dtype)]
    assert str(jax["c5/oracle"]) == str(jax["c5/bound"]) == want
    assert str(port["c5/bound"]) == want


def _same(port, jax, seed, names):
    for name in names:
        key = f"s{seed}/{name}"
        np.testing.assert_array_equal(port[key], jax[key], err_msg=key)


@pytest.mark.parametrize("seed", ref.SEEDS)
def test_f32_sweep_routes_match_jax(sides, seed):
    port, jax = sides[("port", "f32")], sides[("jax", "f32")]
    _same(port, jax, seed, ("choices", "used", "rounds_choices", "rounds_used", "ordinals", "sweeps", "inc_applied"))
    if bool(jax[f"s{seed}/inc_applied"]):
        _same(port, jax, seed, ("inc_choices", "inc_used", "inc_ordinals", "inc_sweeps"))


@pytest.mark.parametrize("seed", ref.SEEDS)
def test_f32_sweep_native_matches_jax(sides, seed):
    _same(sides[("port", "f32")], sides[("jax", "f32")], seed, ("native_choices", "native_used"))


@pytest.mark.parametrize("seed", ref.SEEDS)
def test_f32_planes_match_jax_bitwise(sides, seed):
    """The raw planes equal the JAX package's bit for bit, under f32 (f32
    values) and under bf16."""
    port, jax = sides[("port", "f32")], sides[("jax", "f32")]
    names = ("traw", "naraw", "image_score", "np_traw", "np_naraw")
    _same(port, jax, seed, names)
    _same(sides[("port", "bf16")], sides[("jax", "bf16")], seed, names)


def test_f32_moves_the_planes_off_the_bf16_lattice(sides):
    f32, b16 = sides[("port", "f32")], sides[("port", "bf16")]
    for name in ("naraw", "image_score"):
        assert any(not np.array_equal(f32[f"s{s}/{name}"], b16[f"s{s}/{name}"]) for s in ref.SEEDS), name


def test_the_card_runs_the_same_case():
    """bench/workloads.py score_dtype_case (what chip_smoke.py binds on the
    card) encodes to the arrays of this module's C5 case."""
    from kubernetes_tpu.api.snapshot import Snapshot
    from kubernetes_tpu_torch.convert import from_jax_objects

    nodes, pod = ref.c5_objects()
    want, wmeta = encode_snapshot(from_jax_objects(Snapshot(nodes=nodes, pending_pods=[pod])), device="cpu")
    got, gmeta = encode_snapshot(tw.score_dtype_case(), device="cpu")
    assert gmeta.node_names == wmeta.node_names == ["node-b", "node-a"]
    for f in type(got).FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.mark.parametrize("value", ["f16", "fp32", "BF16"])
def test_invalid_score_dtype_raises(value):
    code = "import kubernetes_tpu_torch.ops.bitplane"
    r = subprocess.run([sys.executable, "-c", code], env={**os.environ, "KTPU_SCORE_DTYPE": value,
                                                            "PYTHONPATH": str(ROOT)},
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert f"ValueError: KTPU_SCORE_DTYPE must be 'bf16' or 'f32', got {value!r}" in r.stderr


# ---------------------------------------------------------------------------
# the card: K10's f32 build, K11 and K12 on f32 planes, == plain
# ---------------------------------------------------------------------------

@pytest.fixture
def card_f32(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card: python -m pytest --noconftest "
                    "-m cuda tests/test_torch_score_dtype.py")
    monkeypatch.setattr(bitplane, "SCORE_DTYPE", "f32")
    kernels.build(["packed_static_rows", "score_planes_f32", "full_scan", "rounds", "class_static_hoist",
                   "class_usage_hoist"])
    return torch.device("cuda")


CARD_SNAPSHOTS = {
    "all-stages": lambda: tw.all_stages(24, 256),
    "all-stages-tight": lambda: tw.all_stages(40, 512, seed=7),
    "config3-small": lambda: tw.spread_affinity(300, 1000, seed=1),
}


def _bits32(x: torch.Tensor) -> torch.Tensor:
    assert x.dtype == torch.float32
    return x.view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,P,N,T,PW", [(0, 300, 997, 5, 3), (1, 64, 2048, 70, 1), (2, 513, 4099, 33, 6),
                                          (3, 10240, 6144, 5, 3)])
def test_score_planes_f32_kernel_matches_plain(card_f32, seed, P, N, T, PW):
    from kubernetes_tpu_torch.bench.score_explain import random_score_arrays

    arr = random_score_arrays(seed, P, N, T, PW, 11, 3, 40, device="cuda")
    before = dict(kernels.LAUNCHES)
    traw, naraw = kernels.score_planes(arr)
    assert kernels.LAUNCHES["score_planes_f32"] == before["score_planes_f32"] + 1
    assert kernels.LAUNCHES["score_planes"] == before["score_planes"]
    traw_p, naraw_p = assign.score_planes_plain(arr)
    assert torch.equal(_bits32(traw), _bits32(traw_p)) and torch.equal(_bits32(naraw), _bits32(naraw_p))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_SNAPSHOTS))
def test_full_scan_and_rounds_on_f32_planes_match_plain(card_f32, name):
    arr, _ = encode_snapshot(CARD_SNAPSHOTS[name](), device=card_f32)
    assert arr.image_score.dtype == torch.float32
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    sfs, eligs = kernels.packed_static_rows(arr, with_elig=True)
    planes = assign.score_planes(arr, cfg)
    assert all(p is None or p.dtype == torch.float32 for p in planes)
    kc, ku = kernels.full_scan(arr, cfg, sfs, eligs, planes)
    pc, pu = assign.schedule_scan_plain(arr, cfg, sf=bitplane.unpack(sfs, arr.N), planes=planes)
    assert torch.equal(kc, pc) and torch.equal(ku, pu)
    rc, ru, ro, rs = kernels.rounds(arr, cfg, sfs, eligs, planes)
    qc, qu, qo, qs = assign.schedule_scan_rounds_plain(arr, cfg, sfs, eligs, planes)
    assert torch.equal(rc, qc) and torch.equal(ru, qu) and torch.equal(ro, qo) and kernels.read_sweeps(rs) == qs


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CARD_SNAPSHOTS))
def test_rounds_class_rows_on_f32_planes_match_plain(card_f32, name):
    """HoistCache on the card (K3, K10's f32 build over the class view, K4)
    -> K12 in class-row mode on the f32 class planes == the plain class
    mode == K12 dense on the pods' f32 planes."""
    from kubernetes_tpu_torch.ops.incremental import HoistCache

    arr, meta = encode_snapshot(CARD_SNAPSHOTS[name](), device=card_f32)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    inc = assign.inc_applicable(arr, cfg, HoistCache().ensure(arr, meta, cfg))
    assert inc is not None
    assert all(p is None or p.dtype == torch.float32 for p in (inc.traw_u, inc.naraw_u, inc.img_u))
    kc, ku, ko, ks = kernels.rounds(arr, cfg, inc=inc)
    pc, pu, po, ps = assign.schedule_scan_rounds_plain(arr, cfg, inc=inc)
    sfs, eligs = kernels.packed_static_rows(arr, with_elig=True)
    dc, du, do, ds = kernels.rounds(arr, cfg, sfs, eligs, assign.score_planes(arr, cfg))
    assert torch.equal(kc, pc) and torch.equal(ku, pu) and torch.equal(ko, po)
    assert kernels.read_sweeps(ks) == ps == kernels.read_sweeps(ds)
    assert torch.equal(kc, dc) and torch.equal(ku, du) and torch.equal(ko, do)
