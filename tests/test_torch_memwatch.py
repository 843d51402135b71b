"""The port's device-memory ledger (kubernetes_tpu_torch/scheduler/memwatch.py)
and the size model it sizes the census with (parallel/partition_rules.py),
held to the JAX package's.

- The leak sentinel's verdicts on the same sample sequences equal the JAX
  sentinel's (JAX tests/test_memwatch.py:232-290).
- ``field_bytes`` equals the JAX function for every qualname of the JAX
  model, under KTPU_SCORE_DTYPE=bf16 and f32 (both packages in a fresh
  process each), save the two fields the port keeps as bool (node_labels,
  sel_mask: a quarter of the JAX f32 bytes); the axes each field shards on
  are the JAX table's; and the model sizes every tensor the port's encoder
  and HoistCache hold, byte for byte.
- The census of the port's encoder, HoistCache and IncState is matched at
  two sizes and returns to baseline after invalidate / drop (:164-201).
- On the CPU the measured side is recorded as unavailable, never passed
  (:119-133).
- The kill switch, the gauges, the Scheduler's cycle-boundary samples and
  the flight record's memory block, with the stats source stubbed
  (:426-511).
- On the card (``cuda``): a retained buffer the census does not hold trips
  the sentinel (:290), and a class-wave loop stays clean.  The module
  imports no JAX at the top (the card's machine has none): the JAX
  package is imported inside the CPU tests that read it.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from kubernetes_tpu_torch.api.delta import DeltaEncoder
from kubernetes_tpu_torch.bench import workloads
from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, infer_score_config
from kubernetes_tpu_torch.ops.incremental import HoistCache
from kubernetes_tpu_torch.parallel.pipeline import PipelinedBatchLoop
from kubernetes_tpu_torch.scheduler import memwatch as mw
from kubernetes_tpu_torch.scheduler.metrics import Metrics
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = {"jax": "kubernetes_tpu", "port": "kubernetes_tpu_torch"}
BOOL_IN_PORT = ("arr.node_labels", "arr.sel_mask")


# ---- the leak sentinel ----

SENTINEL_CASES = [
    (1000, 3, 512, (0, 2000, 4000, 6000)),
    (1000, 3, 512, (0, 5000, 4000, 9000)),
    (10_000, 3, 512, (0, 200, 400, 600)),
    (10, 3, 512, (0, 50_000)),
    (10, 3, 8, tuple(i * 100 for i in range(1000))),
    (mw.SENTINEL_SLACK_BYTES, mw.SENTINEL_MIN_SAMPLES, mw.SENTINEL_WINDOW, (0, 1 << 17, 1 << 18, 3 << 17, 1 << 19)),
    (mw.SENTINEL_SLACK_BYTES, mw.SENTINEL_MIN_SAMPLES, mw.SENTINEL_WINDOW, (-5, -5, -5, -5)),
]


@pytest.mark.parametrize("case", range(len(SENTINEL_CASES)))
def test_sentinel_verdicts_equal_jax(case):
    from kubernetes_tpu.scheduler import memwatch as jmw

    slack, mins, window, samples = SENTINEL_CASES[case]
    out = []
    for mod in (mw, jmw):
        s = mod.LeakSentinel(slack_bytes=slack, min_samples=mins, window=window)
        for v in samples:
            s.observe(v)
        out.append(s.verdict())
    assert out[0] == out[1]
    assert (mw.SENTINEL_SLACK_BYTES, mw.SENTINEL_MIN_SAMPLES, mw.SENTINEL_WINDOW) == (
        jmw.SENTINEL_SLACK_BYTES, jmw.SENTINEL_MIN_SAMPLES, jmw.SENTINEL_WINDOW)


# ---- the size model, both packages, both score dtypes ----

_MODEL_PROG = r"""
import json
from kubernetes_tpu.parallel import partition_rules as J
from kubernetes_tpu_torch.parallel import partition_rules as T
envs = [None, {"P": 37, "N": 29, "U": 5, "R": 6, "T2": 3}, {"P": 51200, "N": 20480, "U": 101, "R": 5}]
out = {"jax": {}, "port": {}, "axes": {}, "bits": [list(J._plane_bits()), list(T._plane_bits())]}
for q in J.FIELD_DIMS:
    for side, m in (("jax", J), ("port", T)):
        out[side][q] = [m.field_bytes(q, e, n, p) for e in envs for n in (1, 3, 8) for p in (1, 2)]
    out["axes"][q] = [[J.sharded_on_nodes(q), J.sharded_on_pods(q)], [T.sharded_on_nodes(q), T.sharded_on_pods(q)]]
out["fields"] = [[J.node_axis_fields(), J.pod_axis_fields()], [T.node_axis_fields(), T.pod_axis_fields()]]
out["resident"] = [[m.resident_input_bytes(1000, 300, s, 5, 4, u, img, ps) for s in (1, 4) for u in (None, 17)
                    for img in (False, True) for ps in (1, 2)] for m in (J, T)]
out["only_port"] = sorted(set(T.FIELD_DIMS) - set(J.FIELD_DIMS))
from kubernetes_tpu_torch.api.snapshot import encode_snapshot
from kubernetes_tpu_torch.bench.workloads import all_stages
from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, infer_score_config
from kubernetes_tpu_torch.ops.incremental import HoistCache
from kubernetes_tpu_torch.scheduler.memwatch import model_bytes_for
arr, meta = encode_snapshot(all_stages(24, 128), device="cpu")
inc = HoistCache().ensure(arr, meta, infer_score_config(arr, DEFAULT_SCORE_CONFIG))
ts = [(f"arr.{f}", getattr(arr, f)) for f in arr.FIELDS] + [(f"inc.{f}", getattr(inc, f)) for f in inc._fields]
out["tensors"] = {q: [model_bytes_for(q, tuple(t.shape)), t.numel() * t.element_size(), str(t.dtype)]
                  for q, t in ts if hasattr(t, "shape")}
print(json.dumps(out, default=lambda x: list(x)))
"""


@pytest.fixture(scope="module", params=["bf16", "f32"])
def model(request):
    r = subprocess.run([sys.executable, "-c", _MODEL_PROG], capture_output=True, text=True, timeout=300, cwd=ROOT,
                       env={**os.environ, "KTPU_SCORE_DTYPE": request.param, "JAX_PLATFORMS": "cpu",
                            "PYTHONPATH": str(ROOT)})
    assert r.returncode == 0, r.stderr[-3000:]
    return request.param, json.loads(r.stdout.strip().splitlines()[-1])


def test_field_bytes_equals_jax_for_every_qualname(model):
    dtype, out = model
    assert out["bits"][0] == out["bits"][1] == [1, 16 if dtype == "bf16" else 32]
    for q, want in out["jax"].items():
        got = out["port"][q]
        if q in BOOL_IN_PORT:
            assert [4 * g for g in got] == want, q
        else:
            assert got == want, q
    assert out["only_port"] == ["hoist.r_u"]


def test_model_sizes_the_port_tensors_under_the_knob(model):
    """Every ClusterArrays field and IncState plane of an all-stages
    snapshot, encoded under the knob, is the model's bytes (the score
    planes bf16 or f32)."""
    dtype, out = model
    for q, (want, got, dt) in out["tensors"].items():
        assert want == got, (q, dt)
    score = "torch.bfloat16" if dtype == "bf16" else "torch.float32"
    assert out["tensors"]["arr.image_score"][2] == out["tensors"]["inc.traw_u"][2] == score


def test_sharded_axes_equal_jax(model):
    _, out = model
    for q, (j, t) in out["axes"].items():
        assert j == t, q
    (jn, jp), (tn, tp) = out["fields"]
    assert {k: [v[0], v[1]] for k, v in jn.items()} == {k: [v[0], v[1]] for k, v in tn.items()}
    assert {k: v[0] for k, v in jp.items()} == {k: v[0] for k, v in tp.items()}


def test_resident_input_bytes_differ_by_the_bool_planes_only(model):
    _, out = model
    jr, tr = out["resident"]
    assert all(t < j for t, j in zip(tr, jr))  # the bool label planes
    assert len(set(j - t for t, j in zip(tr, jr))) <= 8  # a function of N and L only


def _encoded(n_nodes=16, n_pods=120, snap=None):
    snap = snap or workloads.heterogeneous(n_nodes, n_pods, seed=5)
    enc = DeltaEncoder("cpu")
    host, meta = enc.encode(snap)
    arr, meta = enc.to_device(host, meta)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    return enc, arr, meta, cfg


def test_model_sizes_every_port_tensor():
    """Every ClusterArrays field (all stages on: images, pairwise, ports)
    and every IncState plane, at its own shape, is the model's bytes."""
    enc, arr, meta, cfg = _encoded(snap=workloads.all_stages(24, 128))
    for f in type(arr).FIELDS:
        t = getattr(arr, f)
        assert mw.model_bytes_for(f"arr.{f}", tuple(t.shape)) == t.numel() * t.element_size(), f
    inc = HoistCache().ensure(arr, meta, cfg)
    for name in inc._fields:
        t = getattr(inc, name)
        if isinstance(t, torch.Tensor):
            assert mw.model_bytes_for(f"inc.{name}", tuple(t.shape)) == t.numel() * t.element_size(), name
    assert mw.model_bytes_for("arr.pod_req", (7, 4)) == 7 * 4 * 4
    assert mw.model_bytes_for("not.a.field", (3,)) is None and mw.model_bytes_for("arr.pod_req", (3,)) is None
    assert mw._census_entry("arr.pod_req", torch.zeros((7, 4), dtype=torch.int32))["matched"]
    assert not mw._census_entry("arr.pod_req", torch.zeros((7, 4), dtype=torch.int8))["matched"]


# ---- the census ----

@pytest.mark.parametrize("size", [(16, 120), (40, 700)])
def test_census_covers_encoder_hoist_and_inc_without_double_count(size):
    enc, arr, meta, cfg = _encoded(*size)
    cache = HoistCache()
    inc = cache.ensure(arr, meta, cfg)
    assert inc is not None
    c_all = mw.census_buffers(encoder=enc, hoist=cache, inc=inc)
    c_no_inc = mw.census_buffers(encoder=enc, hoist=cache)
    assert c_all["n_buffers"] == c_no_inc["n_buffers"] + 1  # inc.req_u: made per call, not resident
    assert c_all["matched"] is True and c_no_inc["matched"] is True
    assert c_all["resident_bytes"] > 0 and c_all["model_bytes"] == c_all["resident_bytes"]
    qualnames = {e["qualname"] for e in c_all["entries"]}
    assert {"arr.pod_req", "inc.base_u", "inc.stat_u", "inc.fit_u", "inc.cls", "hoist.r_u"} <= qualnames


@pytest.mark.parametrize("shape", [3, (2, 2)])
def test_census_on_a_mesh_is_matched(shape):
    """On a node mesh (and a pods x nodes grid) of CPU positions every
    shard's resident block and class plane is its own tensor: each sized
    at its shape by the model (the JAX :164 use_mesh case)."""
    from kubernetes_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(shape, devices="cpu") if isinstance(shape, int) else make_mesh(shape=shape, devices="cpu")
    snap = workloads.heterogeneous(16, 120, seed=5)
    enc = DeltaEncoder("cpu", mesh=mesh)
    arr, meta = enc.encode_device(snap)
    cfg = infer_score_config(enc.encode(snap)[0], DEFAULT_SCORE_CONFIG)
    cache = HoistCache(mesh=mesh)
    inc = cache.ensure(arr, meta, cfg)
    c = mw.census_buffers(encoder=enc, hoist=cache, inc=inc)
    assert c["matched"] is True, [e for e in c["entries"] if not e["matched"]][:3]
    assert sum(e["qualname"] == "arr.node_alloc" for e in c["entries"]) > 1  # a block a shard
    cache.invalidate()
    enc.drop_device_buffers()
    assert mw.census_buffers(encoder=enc, hoist=cache)["n_buffers"] == 0


def test_census_returns_to_baseline_on_invalidate_and_drop():
    enc, arr, meta, cfg = _encoded()
    cache = HoistCache()
    cache.ensure(arr, meta, cfg)
    assert mw.census_buffers(encoder=enc, hoist=cache)["resident_bytes"] > 0
    cache.invalidate()
    enc.drop_device_buffers()
    after = mw.census_buffers(encoder=enc, hoist=cache)
    assert after["resident_bytes"] == 0 and after["n_buffers"] == 0


# ---- the measured side on the CPU: recorded, not passed ----

def test_memory_stats_unavailable_recorded_not_passed():
    stats = mw.device_memory_stats()
    assert stats["available"] is False and stats["bytes_in_use"] == 0
    assert all(d["available"] is False for d in stats["devices"])
    live = mw.live_device_bytes()
    assert live == {"bytes": 0, "arrays": 0, "available": False}
    enc, arr, meta, cfg = _encoded()
    ledger = mw.DeviceMemoryLedger()
    s = ledger.cycle_sample(encoder=enc, label="cycle")
    assert s["memory_stats_available"] is False and s["live_available"] is False and s["unaccounted_bytes"] is None
    summ = ledger.summary()
    assert summ["memwatch"]["source"] == "unavailable" and summ["hbm_peak_bytes"] == 0
    assert summ["memwatch"]["sentinel"]["samples"] == []  # never fed a number it does not have
    assert summ["hbm_resident_bytes"] > 0 and summ["memwatch"]["census_matched"]


def test_device_memory_stats_graceful_on_statless_devices(monkeypatch):
    class _NoStats:
        type = "cuda"

        def __str__(self):
            return "FakeDevice(nostats)"

    def boom(d):
        raise RuntimeError("no stats on this device")

    monkeypatch.setattr(mw, "_devices", lambda: [_NoStats(), _NoStats()])
    monkeypatch.setattr(mw, "_memory_stats", boom)
    stats = mw.device_memory_stats()
    assert stats["available"] is False and stats["bytes_in_use"] == 0
    assert all(d["available"] is False for d in stats["devices"])


class _Source:
    """A stubbed measured source: one card whose allocator holds `live`
    bytes and peaked at `peak`."""

    def __init__(self, monkeypatch, live=1 << 20):
        self.live, self.peak = live, live
        monkeypatch.setattr(mw, "device_metered", lambda d: True)
        monkeypatch.setattr(mw, "_devices", lambda: [torch.device("cuda", 0)])
        monkeypatch.setattr(mw, "_memory_stats", lambda d: {"allocated_bytes.all.current": self.live,
                                                            "allocated_bytes.all.peak": self.peak})
        monkeypatch.setattr(mw, "live_device_bytes",
                            lambda: {"bytes": self.live, "arrays": 3, "available": True})

    def grow(self, n):
        self.live += n
        self.peak = max(self.peak, self.live)


def test_ledger_with_a_stubbed_source_feeds_the_sentinel(monkeypatch):
    src = _Source(monkeypatch)
    ledger = mw.DeviceMemoryLedger()
    ledger.baseline()
    for i in range(4):
        src.grow(1 << 19)  # 512 KiB a cycle, outside every census
        ledger.cycle_sample(label=f"cycle{i}")
    v = ledger.sentinel.verdict()
    assert v["leaking"] is True and v["growth_bytes"] > mw.SENTINEL_SLACK_BYTES
    assert ledger.source() == "memory_stats" and ledger.hbm_peak_bytes() == src.peak
    clean = mw.DeviceMemoryLedger()
    clean.baseline()
    for i in range(4):
        clean.cycle_sample(label=f"cycle{i}")
    assert clean.sentinel.verdict()["leaking"] is False


def test_ledger_accumulates_unmatched_entries_across_samples():
    ledger = mw.DeviceMemoryLedger()

    class _Enc:  # a one-entry resident table with a drifted dtype
        _dev = {"pod_req": (None, None, torch.zeros((7, 4), dtype=torch.int8))}

    ledger.cycle_sample(encoder=_Enc(), label="cold")
    ledger.cycle_sample(encoder=None, label="warm")
    assert ledger.census_matched is False and "arr.pod_req" in ledger.census_unmatched


# ---- switches, gauges, the Scheduler, the flight record ----

def test_memwatch_kill_switch_and_override(monkeypatch):
    monkeypatch.setenv("KTPU_MEMWATCH", "0")
    assert not mw.memwatch_enabled()
    assert PipelinedBatchLoop(device="cpu").memwatch is None
    assert PipelinedBatchLoop(device="cpu", memwatch=True).memwatch is not None
    monkeypatch.delenv("KTPU_MEMWATCH")
    assert mw.memwatch_enabled()
    assert PipelinedBatchLoop(device="cpu").memwatch is not None
    assert PipelinedBatchLoop(device="cpu", memwatch=False).memwatch is None


def test_loop_samples_every_wave_and_stays_clean(monkeypatch):
    src = _Source(monkeypatch)
    snap = workloads.heterogeneous(30, 256, seed=1)
    enc = DeltaEncoder("cpu")
    loop = PipelinedBatchLoop(encoder=enc, depth=1, device="cpu", metrics=Metrics())
    for s in range(3):
        loop.submit(workloads.heterogeneous(30, 256, seed=s))
    loop.drain()
    summ = loop.memwatch.summary()
    assert summ["memwatch"]["samples"] == 3 and summ["memwatch"]["census_matched"] is True
    assert summ["memwatch"]["sentinel"]["leaking"] is False
    assert summ["hbm_peak_bytes"] == src.peak and summ["hbm_resident_bytes"] > 0
    del snap


def test_cycle_sample_stamps_device_hbm_gauge_family(monkeypatch):
    _Source(monkeypatch)
    metrics = Metrics()
    enc, arr, meta, cfg = _encoded()
    ledger = mw.DeviceMemoryLedger(metrics=metrics)
    ledger.cycle_sample(encoder=enc, label="cycle")
    _c, gauges, _h = metrics.snapshot()
    assert gauges["device_hbm_resident_bytes"] > 0
    for name in ("device_hbm_in_use_bytes", "device_hbm_peak_bytes", "device_hbm_unaccounted_bytes"):
        assert name in gauges
    assert "device_hbm_resident_bytes" in metrics.expose_text()


def test_per_shard_hbm_estimate_from_census():
    from kubernetes_tpu_torch.parallel.mesh import shard_hbm_estimate

    enc, arr, meta, cfg = _encoded()
    ledger = mw.DeviceMemoryLedger()
    ledger.cycle_sample(encoder=enc)
    assert ledger.per_shard_hbm_estimate() == shard_hbm_estimate(arr.P, arr.N, 1, n_res=arr.R)["total"]
    cache = HoistCache()
    inc = cache.ensure(arr, meta, cfg)
    ledger.cycle_sample(encoder=enc, hoist=cache)
    want = shard_hbm_estimate(arr.P, arr.N, 1, n_res=arr.R, u_classes=inc.req_u.shape[0])["total"]
    assert ledger.per_shard_hbm_estimate() == want
    assert mw.DeviceMemoryLedger().per_shard_hbm_estimate() is None


def test_flight_record_memory_block_renders_as_jax(monkeypatch):
    from kubernetes_tpu.scheduler import memwatch as jmw
    from kubernetes_tpu_torch.scheduler.flightrecorder import FlightRecorder, render_flight

    _Source(monkeypatch)
    ledger = mw.DeviceMemoryLedger()
    ledger.cycle_sample(label="cycle")
    block = ledger.memory_block()
    jblock = jmw.DeviceMemoryLedger().memory_block()
    assert set(block) == set(jblock) == {"in_use", "peak", "resident", "unaccounted", "source"}
    rec = FlightRecorder(directory=None, capacity=4)
    rec.record(profile="default", pods=3, scheduled=2, failed=1, verdict_crc="cafecafe", mem=block)
    text = render_flight({"version": 1, "reason": "test", "capacity": 4, "records": rec.records()})
    assert "hbm[in_use=" in text and "src=memory_stats" in text


def test_scheduler_samples_memory_at_cycle_boundaries(monkeypatch, tmp_path):
    """The Scheduler on a metered device (the stubbed source) arms the
    ledger, samples both cycle boundaries, stamps the gauges and writes the
    memory block into each flight record; on the CPU it arms none."""
    from helpers import mk_node, mk_pod
    from kubernetes_tpu_torch.convert import from_jax_objects
    from kubernetes_tpu_torch.scheduler import ClusterStore, Scheduler, SchedulerConfiguration

    def run(ckpt):
        store = ClusterStore()
        for i in range(4):
            store.add_node(from_jax_objects(mk_node(f"n{i}", cpu=4000)))
        sched = Scheduler(store, SchedulerConfiguration(mode="tpu"), device="cpu", checkpoint_dir=ckpt)
        for j in range(6):
            store.add_pod(from_jax_objects(mk_pod(f"p{j}", cpu=500)))
        sched.run_until_idle()
        return sched

    monkeypatch.delenv("KTPU_MESH", raising=False)
    assert run(None)._memwatch is None  # the CPU: nothing to meter
    _Source(monkeypatch)
    sched = run(str(tmp_path))
    assert sched._memwatch is not None and sched._memwatch.samples >= 2
    _c, gauges, _h = sched.metrics.snapshot()
    assert "device_hbm_resident_bytes" in gauges
    assert sched._memwatch.sentinel.verdict()["leaking"] is False and sched._memwatch.census_matched
    recs = sched._flight.records()
    assert recs and all(set(r["mem"]) == {"in_use", "peak", "resident", "unaccounted", "source"} for r in recs)


def test_flight_cli_reads_a_dump(tmp_path):
    from kubernetes_tpu_torch.scheduler.flightrecorder import FlightRecorder

    rec = FlightRecorder(directory=str(tmp_path), capacity=4)
    rec.record(profile="default", pods=3, scheduled=2, failed=1, verdict_crc="cafecafe",
               mem={"in_use": 1, "peak": 2, "resident": 3, "unaccounted": 0, "source": "memory_stats"})
    path = rec.dump("test")
    outs = {}
    for name, root in PACKAGES.items():
        r = subprocess.run([sys.executable, "-m", f"{root}.analysis", "--flight", path], capture_output=True,
                           text=True, timeout=300, cwd=ROOT, env={**os.environ, "JAX_PLATFORMS": "cpu"})
        outs[name] = (r.returncode, r.stdout)
    assert outs["port"] == outs["jax"] and outs["port"][0] == 0 and "hbm[in_use=1" in outs["port"][1]
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    for args in (["--flight", str(bad)], ["--flight", str(tmp_path / "missing.json")], ["--device"], []):
        r = subprocess.run([sys.executable, "-m", "kubernetes_tpu_torch.analysis", *args], capture_output=True,
                           text=True, timeout=120, cwd=ROOT)
        assert r.returncode == 2, (args, r.stderr)
    assert "A13, part 2" in r.stderr


# ---- the card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card: python -m pytest --noconftest "
                    "-m cuda tests/test_torch_memwatch.py")
    from kubernetes_tpu_torch.ops import kernels

    kernels.build()
    return torch.device("cuda")


@pytest.mark.cuda
def test_ledger_catches_a_real_retained_buffer_leak(card):
    ledger = mw.DeviceMemoryLedger()
    ledger.baseline()
    retained = []
    for i in range(3):
        retained.append(torch.zeros((1 << 17,), dtype=torch.float32, device=card))  # 512 KiB a cycle
        torch.cuda.synchronize()
        ledger.cycle_sample(label=f"cycle{i}")
    v = ledger.sentinel.verdict()
    assert v["leaking"] is True and v["growth_bytes"] > mw.SENTINEL_SLACK_BYTES
    assert ledger.source() == "memory_stats" and ledger.memory_stats_available
    del retained


@pytest.mark.cuda
def test_class_wave_loop_on_the_card_is_clean(card):
    enc = DeltaEncoder(card)
    loop = PipelinedBatchLoop(encoder=enc, depth=1)
    for s in range(5):
        loop.submit(workloads.heterogeneous(60, 512, seed=s))
    loop.drain()
    torch.cuda.synchronize()
    summ = loop.memwatch.summary()
    assert summ["memwatch"]["census_matched"] and not summ["memwatch"]["sentinel"]["leaking"]
    stats = mw.device_memory_stats()
    assert stats["available"] and stats["peak_bytes_in_use"] >= stats["bytes_in_use"] >= summ["hbm_resident_bytes"]
