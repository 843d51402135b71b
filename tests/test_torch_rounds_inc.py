"""The rounds route's class state: the class planes, the HoistCache over
churn and the warm loop on a config-3-shaped stream, against the JAX
package.

- ``_static_hoist_plain`` with every plane wanted equals the JAX package's
  ``_static_hoist(want_elig, want_traw, want_naraw)`` on the same class view
  (the JAX encoder's arrays carried across): the packed static and
  eligibility planes as bit patterns, the bf16 taint and node-affinity
  planes as bit patterns;
- over a churn of cycles on an all-stages snapshot (usage moved, a wave
  that replaces only ``node_taint_pref``, then only ``pod_tol_pref``, then
  only the image scores, nothing, usage again) the port's HoistCache takes
  the JAX HoistCache's actions (a ``static_rebuild`` for each replaced
  static field), keeps its stats and holds the same planes, img_u included;
- bench.py's warm waves 2..7 (kubernetes_tpu_torch/bench/workloads.py
  warm_waves) over ``spread_affinity(200, 512)`` through the port's
  PipelinedBatchLoop at depth 1 and depth 0 — the rounds route on class
  state — give the JAX loop's verdicts wave by wave and its HoistCache
  history (the JAX side in a fresh process with KTPU_FORCE_CHUNKED=1:
  ``tests/torch_north_star_digest.py --leg config3-warm 200 512``).

The ``cuda`` leg (K3 with the eligibility words and K10 over the class
view == the plain planes) imports no JAX and skips without a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_rounds_inc.py

Tolerance: none.
"""

import dataclasses
import json
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kubernetes_tpu_torch.api.snapshot import Snapshot, encode_snapshot
from kubernetes_tpu_torch.bench import workloads as tw
from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, incremental, infer_score_config, kernels
from kubernetes_tpu_torch.ops.incremental import HoistCache, class_view
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parent.parent


def _random_pairwise():
    from helpers import random_cluster  # the JAX package's types: imported by the CPU legs only

    return random_cluster(random.Random(31), n_nodes=30, n_pods=120, with_taints=True, with_selectors=True,
                          with_pairwise=True)


PLANES = {
    "all-stages": lambda: tw.all_stages(24, 256),
    "spread-affinity": lambda: tw.spread_affinity(40, 160, seed=3),
    "random-pairwise": _random_pairwise,
}


def _bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().view(np.int32) if t.dtype == torch.float32 else t.numpy()


def _jbits(x) -> np.ndarray:
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.uint16)
    return x.view(np.int32) if x.dtype in (np.float32, np.uint32) else x


def _carry(ja, jm):
    from kubernetes_tpu_torch.convert import from_jax_arrays, from_jax_meta

    return from_jax_arrays({f.name: np.asarray(getattr(ja, f.name)) for f in dataclasses.fields(ja)}, "cpu"), \
        from_jax_meta(jm)


@pytest.mark.parametrize("name", sorted(PLANES))
def test_class_planes_match_jax(name):
    from kubernetes_tpu.api.delta import DeltaEncoder
    from kubernetes_tpu.ops import incremental as jinc

    ja, jm = DeltaEncoder().encode(PLANES[name]())
    arr, _ = _carry(ja, jm)
    r_u = np.asarray(jm.class_first_pod)
    want = jinc._static_hoist(jinc.class_view(ja, r_u), True, True, True)
    got = incremental._static_hoist_plain(class_view(arr, torch.from_numpy(r_u)), True, True, True)
    for g, w, plane in zip(got, want, ("stat", "elig", "traw", "naraw")):
        np.testing.assert_array_equal(_bits(g), _jbits(w), err_msg=plane)
    # the image rows are a gather
    np.testing.assert_array_equal(_bits(class_view(arr, torch.from_numpy(r_u)).image_score),
                                  _jbits(jinc.class_view(ja, r_u).image_score))


def test_hoist_cache_churn_with_every_plane_matches_jax():
    """Each static field the class planes read rebuilds them: a wave that
    replaces only node_taint_pref is a static_rebuild, never a hit on a
    stale taint plane (the JAX package's whole static key)."""
    from kubernetes_tpu.api.delta import DeltaEncoder
    from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG as JAX_DEFAULT
    from kubernetes_tpu.ops import incremental as jinc
    from kubernetes_tpu.ops import infer_score_config as jax_infer

    ja, jm = DeltaEncoder().encode(tw.all_stages(24, 256))
    arr, meta = _carry(ja, jm)
    jcfg = jax_infer(ja, JAX_DEFAULT)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    assert all((cfg.enable_pairwise, cfg.enable_taint_score, cfg.enable_node_pref, cfg.enable_image))
    jcache, tcache = jinc.HoistCache(), HoistCache()
    rng = np.random.default_rng(5)

    def bump(j, t, k):
        u = np.array(j.node_used)
        u[rng.permutation(ja.N)[:k]] += 1
        return dataclasses.replace(j, node_used=u), dataclasses.replace(t, node_used=torch.from_numpy(u))

    def replace(field):
        def step(j, t):
            return (dataclasses.replace(j, **{field: np.array(getattr(j, field))}),
                    dataclasses.replace(t, **{field: getattr(t, field).clone()}))
        return step

    cycles = [
        lambda j, t: (j, t),  # cold: static rebuild
        lambda j, t: bump(j, t, 3),
        replace("node_taint_pref"),
        replace("pod_tol_pref"),
        replace("image_score"),
        lambda j, t: (j, t),
        lambda j, t: bump(j, t, 2),
    ]
    actions = []
    for step in cycles:
        ja, arr = step(ja, arr)
        jstate = jcache.ensure(ja, jm, jcfg)
        tstate = tcache.ensure(arr, meta, cfg)
        assert tcache.last == jcache.last and tcache.stats == jcache.stats
        for plane in ("stat_u", "elig_u", "traw_u", "naraw_u", "img_u", "base_u", "fit_u", "req_u", "cls"):
            np.testing.assert_array_equal(_bits(getattr(tstate, plane)), _jbits(getattr(jstate, plane)),
                                          err_msg=plane)
        actions.append(tcache.last["action"])
    assert actions == ["static_rebuild", "patch", "static_rebuild", "static_rebuild", "static_rebuild", "hit",
                       "patch"]


WARM = (200, 512)  # spread_affinity(n_nodes, n_pods): a config-3-shaped warm stream


@pytest.fixture(scope="module")
def jax_config3_warm():
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "KTPU_FORCE_CHUNKED": "1", "KTPU_MEMWATCH": "0"}
    proc = subprocess.run([sys.executable, str(ROOT / "tests" / "torch_north_star_digest.py"), "--leg",
                           "config3-warm", *map(str, WARM)], env=env, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("config3-warm-json: ")][0]
    return json.loads(line[len("config3-warm-json: "):])


@pytest.mark.parametrize("depth", [1, 0])
def test_config3_warm_loop_matches_jax(jax_config3_warm, depth):
    from kubernetes_tpu_torch.api.delta import DeltaEncoder
    from kubernetes_tpu_torch.ops import assign, schedule_batch
    from kubernetes_tpu_torch.parallel.pipeline import PipelinedBatchLoop

    snap = tw.spread_affinity(*WARM, seed=0)
    enc = DeltaEncoder("cpu")
    arr, meta = enc.encode_device(snap)
    c, _ = schedule_batch(arr, infer_score_config(arr, DEFAULT_SCORE_CONFIG), device="cpu")
    loop = PipelinedBatchLoop(encoder=enc, depth=depth, device="cpu")
    assign.reset_trace_counts()
    waves, fetched, walls, _ = tw.warm_waves(snap, tw.verdicts_of(c, meta), loop.submit, loop.drain, Snapshot)
    assert {str(w): v for w, v in fetched.items() if w >= 2} == jax_config3_warm["verdicts"]
    assert [h["action"] for h in loop.hoist.history] == jax_config3_warm["actions"]
    assert enc.stats == jax_config3_warm["stats"]
    assert assign.TRACE_COUNTS["rounds_inc"] == 6 and len(walls) == 6


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["all-stages", "spread-affinity"])
def test_class_plane_kernels_match_plain(name):
    """K3 with the eligibility words and K10 over the class view's rows ==
    _static_hoist_plain on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card: python -m pytest --noconftest "
                    "-m cuda tests/test_torch_rounds_inc.py")
    snap = {"all-stages": lambda: tw.all_stages(24, 256), "spread-affinity": PLANES["spread-affinity"]}[name]()
    arr, meta = encode_snapshot(snap, device="cuda")
    r_u = torch.as_tensor(meta.class_first_pod, device="cuda")
    kernels.reset_launches()
    got = incremental.static_hoist(arr, r_u, True, True, True)
    assert kernels.LAUNCHES["class_static_hoist"] == 1 and kernels.LAUNCHES["score_planes"] == 1
    want = incremental._static_hoist_plain(class_view(arr, r_u), True, True, True)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int16) if g.dtype == torch.bfloat16 else g,
                           w.view(torch.int16) if w.dtype == torch.bfloat16 else w)
    assert torch.equal(kernels.class_static_hoist(arr, r_u), got[0])
