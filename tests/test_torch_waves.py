"""The port's class-wave route on the CPU against the JAX package's.

- ``wave_commit_plain`` equals the JAX package's ``_wave_commit_stage`` on
  all seven outputs (run in-process: it is called directly, with its
  default knobs);
- the route (``schedule_batch_ordinals`` with ``inc``) equals the JAX
  package's ``schedule_batch_ordinals_routed`` under
  ``KTPU_FORCE_CHUNKED=1`` in choices, final usage, commit ordinals and the
  sweep count: with the waves on, with ``KTPU_CLASS_WAVES=0``, and with
  two-entry lists in 64-pod blocks, where the wave's block budget runs out
  and stage B carries the rest.  The JAX side runs in fresh processes
  (tests/torch_waves_reference.py): its knobs are read at import;
- decoded choices equal the serial oracle's.

Both sides read the JAX encoder's arrays and class index
(convert.from_jax_arrays / from_jax_meta).  Tolerance: none.
"""

import dataclasses
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_waves_reference as ref
from kubernetes_tpu.api.delta import DeltaEncoder
from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG as JAX_DEFAULT
from kubernetes_tpu.ops import assign as jassign
from kubernetes_tpu.ops import bitplane as jbit
from kubernetes_tpu.ops import infer_score_config as jax_infer
from kubernetes_tpu.ops.incremental import HoistCache as JaxHoistCache
from kubernetes_tpu.ops.scores import balanced_allocation as jbal
from kubernetes_tpu.ops.scores import fit_score as jfit
from kubernetes_tpu.oracle import oracle_schedule
from kubernetes_tpu_torch.api.snapshot import decode_choices
from kubernetes_tpu_torch.convert import from_jax_arrays, from_jax_meta
from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, infer_score_config
from kubernetes_tpu_torch.ops.incremental import HoistCache

ROOT = Path(__file__).resolve().parent.parent
ALL = sorted({(leg, name) for leg, (_, names, _) in ref.LEGS.items() for name in names})


def _encode(name):
    """JAX encode -> (snap, JAX arrays, JAX meta, port arrays, port meta)."""
    snap = ref.snapshot(name)
    ja, jm = DeltaEncoder().encode(snap)
    arr = from_jax_arrays({f.name: np.asarray(getattr(ja, f.name)) for f in dataclasses.fields(ja)}, "cpu")
    return snap, ja, jm, arr, from_jax_meta(jm)


@pytest.fixture(scope="module")
def jax_route(tmp_path_factory):
    """Every leg's JAX results, the legs' processes run side by side."""
    out = tmp_path_factory.mktemp("jax_route")

    def run(leg):
        env = {**os.environ, "JAX_PLATFORMS": "cpu", **ref.LEGS[leg][0]}
        for k in ("KTPU_FORCE_CHUNKED", "KTPU_CLASS_WAVES", "KTPU_WAVE_K", "KTPU_WAVE_BLOCK"):
            if k not in ref.LEGS[leg][0]:
                env.pop(k, None)
        path = out / f"{leg}.npz"
        proc = subprocess.run([sys.executable, str(ROOT / "tests" / "torch_waves_reference.py"), leg, str(path)],
                              env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-4000:]
        return leg, dict(np.load(path))

    with ThreadPoolExecutor(len(ref.LEGS)) as pool:
        return dict(pool.map(run, ref.LEGS))


@pytest.mark.parametrize("leg,name", ALL)
def test_route_matches_jax(jax_route, leg, name):
    """Choices, usage, ordinals and sweeps equal the JAX route's."""
    _, _, _, arr, meta = _encode(name)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    inc = HoistCache().ensure(arr, meta, cfg)
    assert inc is not None
    c, u, o, s = assign.schedule_batch_ordinals(arr, cfg, device="cpu", inc=inc, **ref.LEGS[leg][2])
    want = jax_route[leg]
    np.testing.assert_array_equal(c.numpy(), want[f"{name}/choices"])
    np.testing.assert_array_equal(u.numpy(), want[f"{name}/used"])
    np.testing.assert_array_equal(o.numpy(), want[f"{name}/ordinals"])
    assert s == int(want[f"{name}/sweeps"])


def test_truncated_leg_leaves_work_to_stage_b():
    """The truncated leg really exercises stage B after a partial wave."""
    _, _, _, arr, meta = _encode("basic-truncated")
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    inc = HoistCache().ensure(arr, meta, cfg)
    t0u = assign.t0u_prologue(inc, arr.N)
    wave = assign.wave_commit_plain(inc.cls, arr.pod_valid, arr.pod_req, arr.node_used, t0u, inc.stat_u,
                                    arr.node_alloc, inc.req_u, cfg, wave_k=2, wave_block=64)
    committed, n_blocks = wave[0], wave[5]
    assert committed.any() and not committed.all()
    assert n_blocks == (arr.P // 64 + 1) * 8 + 32  # the budget ran out


@pytest.mark.parametrize("name", ["random", "interference", "heterogeneous", "mixed"])
def test_route_matches_oracle(name):
    snap, ja, _, arr, meta = _encode(name)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    inc = HoistCache().ensure(arr, meta, cfg)
    c, _ = assign.schedule_batch(arr, cfg, device="cpu", inc=inc)
    placed = decode_choices(c, meta)
    want = oracle_schedule(snap, jax_infer(ja, JAX_DEFAULT))
    assert [(n, placed[n]) for n in meta.pod_names] == want


def _jax_wave(ja, jinc, jcfg):
    res = jcfg.score_resources

    def score_flat(requested, alloc):
        return jcfg.fit_weight * jfit(requested, alloc, jcfg) + jcfg.balanced_weight * jbal(requested, alloc, res)

    t0u = jnp.where(jbit.unpack(jinc.stat_u & jinc.fit_u, ja.N), jinc.base_u, -jnp.inf)
    f = jax.jit(lambda c, pv, pr, ui, t0, st, na, ru:
                jassign._wave_commit_stage(c, pv, pr, ui, t0, st, na, ru, score_flat))
    return f(jinc.cls, ja.pod_valid, ja.pod_req, ja.node_used, t0u, jinc.stat_u, ja.node_alloc, jinc.req_u)


@pytest.mark.parametrize("name", ["random", "interference", "heterogeneous", "mixed"])
def test_wave_commit_plain_matches_jax(name):
    """All seven outputs of the wave stage, t0u as f32 bits."""
    _, ja, jm, arr, meta = _encode(name)
    jcfg = jax_infer(ja, JAX_DEFAULT)
    jinc = JaxHoistCache().ensure(ja, jm, jcfg)
    want = _jax_wave(ja, jinc, jcfg)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    inc = HoistCache().ensure(arr, meta, cfg)
    t0u = assign.t0u_prologue(inc, arr.N)
    np.testing.assert_array_equal(
        t0u.numpy().view(np.int32),
        np.asarray(jnp.where(jbit.unpack(jinc.stat_u & jinc.fit_u, ja.N), jinc.base_u, -jnp.inf)).view(np.int32))
    got = assign.wave_commit_plain(inc.cls, arr.pod_valid, arr.pod_req, arr.node_used, t0u, inc.stat_u,
                                   arr.node_alloc, inc.req_u, cfg)
    for g, w in zip(got[:5], want[:5]):
        w = np.asarray(w)
        g = g.numpy()
        if w.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w)
    assert (got[5], got[6]) == (int(want[5]), int(want[6]))
    if name == "interference":
        assert got[6] > 0  # the fallback stacked: epochs were refreshed


def test_second_call_leaves_inc_unchanged():
    _, _, _, arr, meta = _encode("interference")
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    inc = HoistCache().ensure(arr, meta, cfg)
    before = [t.clone() for t in (inc.cls, inc.req_u, inc.stat_u, inc.base_u, inc.fit_u)]
    used0 = arr.node_used.clone()
    first = assign.schedule_batch_ordinals(arr, cfg, device="cpu", inc=inc)
    second = assign.schedule_batch_ordinals(arr, cfg, device="cpu", inc=inc)
    for a, b in zip(first[:3], second[:3]):
        assert torch.equal(a, b)
    assert first[3] == second[3]
    for t, b in zip((inc.cls, inc.req_u, inc.stat_u, inc.base_u, inc.fit_u), before):
        assert torch.equal(t, b)
    assert torch.equal(arr.node_used, used0)


def test_route_counts_and_fallback_to_the_per_pod_route():
    _, _, _, arr, meta = _encode("random")
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    inc = HoistCache().ensure(arr, meta, cfg)
    assign.reset_trace_counts()
    assign.schedule_batch(arr, cfg, device="cpu", inc=inc)
    assert assign.TRACE_COUNTS == {"plain": 0, "chunked": 0, "chunked_inc": 1, "class_waves": 1}
    assign.schedule_batch(arr, cfg, device="cpu", inc=inc, class_waves=False)
    assert assign.TRACE_COUNTS == {"plain": 0, "chunked": 0, "chunked_inc": 2, "class_waves": 1}
    # class state that does not fit the arrays: the per-pod route
    assert assign.inc_applicable(arr.pod_prefix(64), cfg, inc) is None
    c, u, o, s = assign.schedule_batch_ordinals(arr, cfg, device="cpu")
    assert assign.TRACE_COUNTS["plain"] == 1
    assert s == arr.P and torch.equal(o, torch.arange(arr.P, dtype=torch.int32))
