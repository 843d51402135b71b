"""The port's PipelinedBatchLoop and run_serial on the CPU (after
tests/test_pipeline.py and tests/test_pipeline_parity.py).

- bench.py's warm cycles (kubernetes_tpu_torch/bench/workloads.py
  warm_waves: renamed waves, wave w binding wave w-2's placements) give the
  same verdicts at depth 1 and depth 0, and the same as the JAX package's
  run_serial order (its PipelinedBatchLoop at depth 0) on the same stream,
  with the same HoistCache actions and encoder stats;
- independent streams: empty, one wave, wave order kept, run_serial ==
  the depth-1 loop;
- no step writes a tensor it was given (contents before and after);
- a round-cap status left by a step raises where the step is fetched;
- on the CPU a step has ended when dispatch returns: overlap_fraction is
  0.0 at both depths; without a card the default device raises.
Tolerance: none.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from helpers import mk_node, mk_pod
from kubernetes_tpu_torch.api.delta import DeltaEncoder
from kubernetes_tpu_torch.api.snapshot import Snapshot
from kubernetes_tpu_torch.bench import workloads as tw
from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, infer_score_config, schedule_batch
from kubernetes_tpu_torch.parallel import pipeline
from kubernetes_tpu_torch.parallel.pipeline import PipelinedBatchLoop, run_serial
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parent.parent


def _port_warm(snap, depth):
    enc = DeltaEncoder("cpu")
    arr, meta = enc.encode_device(snap)
    c, _ = schedule_batch(arr, infer_score_config(arr, DEFAULT_SCORE_CONFIG), device="cpu")
    loop = PipelinedBatchLoop(encoder=enc, depth=depth, device="cpu")
    waves, fetched, walls, _ = tw.warm_waves(snap, tw.verdicts_of(c, meta), loop.submit, loop.drain, Snapshot)
    return loop, enc, waves, fetched, walls


WARM = (150, 700)  # heterogeneous(n_nodes, n_pods) of the warm stream


@pytest.fixture(scope="module")
def jax_warm():
    """The JAX package's run_serial order over the same warm stream, in a
    fresh process with KTPU_FORCE_CHUNKED=1 (the JAX package routes the
    class state only on chunked routes, and reads the knob at trace time)."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "KTPU_FORCE_CHUNKED": "1", "KTPU_MEMWATCH": "0"}
    env.pop("KTPU_CLASS_WAVES", None)
    proc = subprocess.run([sys.executable, str(ROOT / "tests" / "torch_north_star_digest.py"), "--leg", "warm",
                           *map(str, WARM)], env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("warm-json: ")][0]
    return json.loads(line[len("warm-json: "):])


@pytest.mark.parametrize("depth", [1, 0])
def test_warm_waves_match_jax_run_serial(jax_warm, depth):
    loop, enc, waves, fetched, walls = _port_warm(tw.heterogeneous(*WARM), depth)
    assert {str(w): v for w, v in fetched.items() if w >= 2} == jax_warm["verdicts"]
    assert [h["action"] for h in loop.hoist.history] == jax_warm["actions"]
    assert enc.stats == jax_warm["stats"] and enc.stats["delta"] >= 3
    assert len(walls) == 6 and loop.stats["waves"] == 6
    assert loop.overlap_fraction() == 0.0


def test_depths_agree_on_a_churn_feedback_stream():
    """A capacity-coupled stream through the lag-1 dataflow: the verdicts,
    wave by wave, are the same at depth 1 and depth 0."""
    nodes = [mk_node(f"n{i}", cpu=1000 + 500 * (i % 4)) for i in range(8)]

    def stream(loop):
        wave_pods, fetched, out = {}, {}, []
        for w in range(6):
            bound = tw.place(wave_pods[w - 2], fetched[w - 2]) if w - 2 in fetched else []
            wave_pods[w] = [mk_pod(f"w{w}-p{j}", cpu=200 + 60 * ((w + j) % 7)) for j in range(40)]
            v = loop.submit(Snapshot(nodes=nodes, pending_pods=wave_pods[w], bound_pods=bound))
            if v is not None:
                fetched[w - 1] = v
                out.append(v)
        fetched[5] = loop.drain()
        out.append(fetched[5])
        return out

    deep = stream(PipelinedBatchLoop(depth=1, device="cpu"))
    serial = stream(PipelinedBatchLoop(depth=0, device="cpu"))
    assert deep == serial and len(deep) == 6
    assert any(v is None for w in deep for v in w.values())  # capacity ran out somewhere


def _wave(seed, n_nodes=12, n_pods=24):
    rng = np.random.default_rng(seed)
    nodes = [mk_node(f"w{seed}-n{i}", cpu=int(rng.integers(2000, 8000))) for i in range(n_nodes)]
    pods = [mk_pod(f"w{seed}-p{j}", cpu=int(rng.integers(100, 1500))) for j in range(n_pods)]
    return Snapshot(nodes=nodes, pending_pods=pods)


def test_independent_waves_in_order_and_serial_parity():
    waves = [_wave(s) for s in range(5)]
    deep = list(PipelinedBatchLoop(depth=1, device="cpu").run(waves))
    assert deep == list(run_serial(waves, device="cpu"))
    assert len(deep) == 5
    for s, verdicts in enumerate(deep):
        assert all(name.startswith(f"w{s}-") for name in verdicts)
        assert sum(1 for v in verdicts.values() if v) > 0


def test_empty_and_single_wave_streams():
    assert list(PipelinedBatchLoop(depth=1, device="cpu").run([])) == []
    [only] = list(PipelinedBatchLoop(depth=1, device="cpu").run([_wave(7)]))
    assert only == list(run_serial([_wave(7)], device="cpu"))[0]
    loop = PipelinedBatchLoop(depth=1, device="cpu")
    assert loop.drain() is None and loop.overlap_fraction() == 0.0


def test_steps_never_write_their_inputs(monkeypatch):
    """Every tensor a step reads (the arrays and the class state) holds the
    same values after the step and after the next cycle's encode."""
    seen = []
    real = pipeline.dispatch

    def spy(arr, cfg, device=None, inc=None, **kw):
        ins = list(arr.tensors().values()) + ([x for x in inc[:5]] if inc is not None else [])
        seen.append([(x, x.clone()) for x in ins])
        return real(arr, cfg, device=device, inc=inc, **kw)

    monkeypatch.setattr(pipeline, "dispatch", spy)
    loop, *_ = _port_warm(tw.heterogeneous(80, 400), depth=1)
    assert len(seen) == 6 and any(h["action"] == "patch" or h["action"] == "hit" for h in loop.hoist.history)
    for ins in seen:
        for x, copy in ins:
            assert torch.equal(x, copy)


@pytest.mark.parametrize("depth", [1, 0])
def test_round_cap_raises_where_the_step_is_fetched(monkeypatch, depth):
    """A step whose (sweeps, status) pair reports the round cap raises when
    its choices are fetched, at either depth; it never passes as unscheduled
    pods."""
    real = pipeline.dispatch
    calls = []

    def capped(arr, cfg, device=None, inc=None, **kw):
        step = real(arr, cfg, device=device, inc=inc, **kw)
        calls.append(1)
        if len(calls) == 2:  # the second wave's kernel hit its cap
            return step._replace(sweeps=torch.tensor([7, 1], dtype=torch.int32))
        return step

    monkeypatch.setattr(pipeline, "dispatch", capped)
    loop = PipelinedBatchLoop(depth=depth, device="cpu")
    assert loop.submit(_wave(0)) is None
    first = loop.submit(_wave(1))
    assert first is not None and all(n.startswith("w0-") for n in first)
    with pytest.raises(RuntimeError, match="round cap"):
        loop.submit(_wave(2))


def test_finish_reads_the_status_pair():
    step = assign.Step(torch.zeros(4, dtype=torch.int32), torch.zeros((2, 1), dtype=torch.int32),
                       torch.zeros(4, dtype=torch.int32), torch.tensor([3, 0], dtype=torch.int32))
    assert assign.finish(step).sweeps == 3
    with pytest.raises(RuntimeError, match="round cap"):
        assign.finish(step._replace(sweeps=torch.tensor([3, 1], dtype=torch.int32)))


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        PipelinedBatchLoop()
    with pytest.raises(RuntimeError, match="CUDA"):
        list(run_serial([_wave(0)]))
