"""The port's pipelined loop under kill.* and pipeline.step chaos, its
restart driver and its flight recorder, against the JAX package's, on the
CPU (after tests/test_storm_streaming.py, tests/test_pipeline.py and
tests/test_chaos.py).

Each case runs once per package, each under its own chaos injector with
the same plan (installed and uninstalled around the case); the port's
loop on device="cpu".  Held equal, exactly:

- run_stream_restartable at every streaming kill point (kill.submit,
  kill.dispatch, kill.collect, kill.drain) x depth 0 / 1: the verdicts of
  every wave (and the chaos-free run_serial's), the restart count, the
  chaos report, the HA series, and the stream WAL each side leaves (every
  wave committed once, under the same crc); a seeded storm over the
  streaming family; a replay that diverges from its committed record
  raises; a kill on every incarnation exhausts max_restarts;
- FaultPlan.from_seed's goldens (the streaming sites did not reshuffle a
  seed);
- PipelinedRunner == run_serial, wave order kept, empty and single
  streams;
- pipeline.step error / nan on a wave: the serial replay's verdicts,
  stats["recovered"] == 1, the fault and recovery spans and counters; a
  host.stall changes nothing;
- flightrecorder.fingerprint on the same dicts and arrays; a dump's JSON
  (the times and trace ids aside), its context and its rendering; the
  Scheduler's dump on a kill.
Tolerance: none.
"""

import json
import os

import numpy as np
import pytest

from helpers import mk_node, mk_pod
from torch_scheduler_sides import Side
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

pytest.importorskip("jax")

SIDES = ("jax", "port")


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    sides = [Side(n) for n in SIDES]
    for x in sides:
        x.chaos.uninstall()
    yield
    for x in sides:
        x.chaos.uninstall()


class Pkg:
    """One package's streaming entry points; the port's on the CPU."""

    def __init__(self, name: str):
        self.name = name
        self.side = Side(name)
        self.chaos = self.side.chaos
        if name == "jax":
            from kubernetes_tpu.api.snapshot import Snapshot
            from kubernetes_tpu.parallel import pipeline
            from kubernetes_tpu.scheduler import flightrecorder
            from kubernetes_tpu.scheduler.checkpoint import CheckpointManager
            from kubernetes_tpu.scheduler.metrics import Metrics
            from kubernetes_tpu.scheduler.tracing import TraceCollector, Tracer

            self.dev = {}
        else:
            from kubernetes_tpu_torch.api.snapshot import Snapshot
            from kubernetes_tpu_torch.parallel import pipeline
            from kubernetes_tpu_torch.scheduler import flightrecorder
            from kubernetes_tpu_torch.scheduler.checkpoint import CheckpointManager
            from kubernetes_tpu_torch.scheduler.metrics import Metrics
            from kubernetes_tpu_torch.scheduler.tracing import TraceCollector, Tracer

            self.dev = {"device": "cpu"}
        self.Snapshot, self.pipeline, self.flight = Snapshot, pipeline, flightrecorder
        self.CheckpointManager, self.Metrics = CheckpointManager, Metrics
        self.TraceCollector, self.Tracer = TraceCollector, Tracer

    def wave(self, seed: int, n_nodes: int = 6, n_pods: int = 12):
        """test_storm_streaming.py's _wave, carried into this package."""
        rng = np.random.default_rng(seed)
        nodes = [mk_node(f"w{seed}-n{i}", cpu=int(rng.integers(2000, 8000))) for i in range(n_nodes)]
        pods = [mk_pod(f"w{seed}-p{j}", cpu=int(rng.integers(100, 1500))) for j in range(n_pods)]
        return self.Snapshot(nodes=[self.side.conv(n) for n in nodes], pending_pods=[self.side.conv(p) for p in pods])

    def loop(self, **kw):
        return self.pipeline.PipelinedBatchLoop(**self.dev, **kw)

    def serial(self, waves):
        return list(self.pipeline.run_serial(waves, **self.dev))


def fault_series(m) -> dict:
    return {name: sorted(m.labeled_counter_series(name).items())
            for name in ("framework_fault_injected_total", "framework_fault_recovery_total")}


def stream_kill(x: Pkg, site: str, at: int, depth: int, tmp_path):
    waves = [x.wave(s) for s in range(4)]
    oracle = x.serial(waves)
    ckpt = x.CheckpointManager(str(tmp_path / x.name))
    metrics, loops = x.Metrics(), []

    def make(commit, wal):
        loops.append(x.loop(depth=depth, commit=commit, wal=wal))
        return loops[-1]

    with x.chaos.chaos_plan(x.chaos.FaultPlan.parse(f"{site}:kill@{at}")):
        inj = x.chaos.active()
        got, restarts = x.pipeline.run_stream_restartable(waves, make, checkpoint=ckpt, metrics=metrics)
        rep = inj.report()
    _p50, p99, n = metrics.hists["failover_duration_seconds"].stats()
    assert got == oracle and n == restarts and p99 > 0
    # no pipeline.step fault here: no wave was replayed on the dense route
    assert [lp.stats["recovered"] for lp in loops] == [0] * (restarts + 1)
    with open(tmp_path / x.name / "stream_wal.json") as f:
        wal = json.load(f)["data"]
    return got, restarts, rep, metrics.counters["scheduler_restarts_total"], wal, \
        sorted(x.pipeline.load_stream_wal(ckpt))


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("site", Side("port").chaos.STREAM_KILL_SITES)
def test_stream_kill_exactly_once_matches_jax(site, depth, tmp_path):
    """kill -9 at each streaming kill point: the replacement loop replays
    exactly the uncommitted suffix.  drain() runs once an incarnation, so
    only its first call can fire; the others fire on a later wave."""
    at = 0 if site == "kill.drain" else 2
    want, got = (stream_kill(Pkg(n), site, at, depth, tmp_path) for n in SIDES)
    assert got == want
    verdicts, restarts, rep, n_restarts, wal, ledger = got
    assert restarts >= 1 and n_restarts == restarts
    assert rep[f'framework_fault_injected_total{{action="kill",site="{site}"}}'] >= 1
    assert rep[f'framework_fault_recovery_total{{action="stream_restart",site="{site}"}}'] >= 1
    assert ledger == [0, 1, 2, 3] and sorted(wal["committed"]) == ["0", "1", "2", "3"]


def storm(x: Pkg, tmp_path):
    waves = [x.wave(s) for s in range(5)]
    oracle = x.serial(waves)
    plan = x.chaos.FaultPlan.from_seed(1, sites=x.chaos.STREAM_KILL_SITES, n_faults=6, horizon=6)
    assert all(f.site in x.chaos.STREAM_KILL_SITES and f.action == "kill" for f in plan.faults)
    ckpt = x.CheckpointManager(str(tmp_path / x.name))
    with x.chaos.chaos_plan(plan):
        got, restarts = x.pipeline.run_stream_restartable(
            waves, lambda commit, wal: x.loop(depth=1, commit=commit, wal=wal), checkpoint=ckpt)
    assert got == oracle
    return got, restarts, plan.describe(), x.pipeline.load_stream_wal(ckpt)


def test_stream_seeded_kill_storm_matches_jax(tmp_path):
    want, got = (storm(Pkg(n), tmp_path) for n in SIDES)
    assert got == want and got[1] >= 2


def test_stream_wal_replay_divergence_is_fatal(tmp_path):
    for name in SIDES:
        x = Pkg(name)
        ckpt = x.CheckpointManager(str(tmp_path / name))
        ckpt.save(x.pipeline.STREAM_WAL, {"committed": {"0": "not-the-real-crc"}, "inflight": {}})
        with pytest.raises(RuntimeError, match="refusing to double-publish"):
            x.pipeline.run_stream_restartable(
                [x.wave(0)], lambda commit, wal: x.loop(depth=0, commit=commit, wal=wal), checkpoint=ckpt)


def test_stream_restart_budget_is_bounded():
    for name in SIDES:
        x = Pkg(name)
        with x.chaos.chaos_plan(x.chaos.FaultPlan.parse(";".join("kill.submit:kill@%d" % k for k in range(8)))):
            with pytest.raises(x.chaos.ProcessKilled):
                x.pipeline.run_stream_restartable(
                    [x.wave(0)], lambda commit, wal: x.loop(depth=0, commit=commit, wal=wal), max_restarts=3)
            assert x.chaos.active().counts["kill.submit"] == 4


def test_seeded_storm_goldens_are_stable():
    for name in SIDES:
        c = Side(name).chaos
        assert c.FaultPlan.from_seed(0).describe() == (
            "seed=0 kubelet.sync:crash@6;sidecar.rpc:hang@7:0.0291;"
            "scheduler.step:nan@7;pipeline.step:error@8;sidecar.health:error@2;"
            "kubelet.sync:crash@9;kubelet.sync:crash@8;host.stall:stall@11:0.0128"
        )
        assert c.FaultPlan.from_seed(7).describe() == (
            "seed=7 pipeline.step:error@6;host.stall:stall@8:0.0068;"
            "sidecar.rpc:hang@8:0.0196;sidecar.health:error@1;"
            "scheduler.step:nan@1;sidecar.health:error@8;scheduler.step:error@9;"
            "sidecar.rpc:error@10"
        )
        for seed in range(8):
            assert not any(f.site in c.ALL_KILL_SITES for f in c.FaultPlan.from_seed(seed).faults)


# --- PipelinedRunner (tests/test_pipeline.py) ---
def runner(x: Pkg):
    waves = [x.wave(s, n_nodes=12, n_pods=24) for s in range(5)]
    r = x.pipeline.PipelinedRunner(**x.dev)
    got = list(r.run(waves))
    assert got == x.serial(waves) and r.last_loop.stats["waves"] == 5
    for s, verdicts in enumerate(got):
        assert all(name.startswith(f"w{s}-") for name in verdicts)
        assert sum(1 for v in verdicts.values() if v) > 0
    empty = list(x.pipeline.PipelinedRunner(**x.dev).run([]))
    [only] = list(x.pipeline.PipelinedRunner(**x.dev).run([x.wave(7)]))
    return got, empty, dict(only)


def test_pipelined_runner_matches_jax():
    want, got = (runner(Pkg(n)) for n in SIDES)
    assert got == want and got[1] == []


def test_pipelined_runner_exported():
    from kubernetes_tpu_torch.parallel import PipelinedBatchLoop, PipelinedRunner, run_serial

    assert PipelinedRunner.__module__ == PipelinedBatchLoop.__module__ == run_serial.__module__


# --- pipeline.step chaos: mid-wave death -> the serial replay (tests/test_chaos.py) ---
def wave_death(x: Pkg, action: str, depth: int):
    waves = [x.wave(s, n_nodes=8, n_pods=16) for s in range(4)]
    oracle = x.serial(waves)
    col = x.TraceCollector()
    metrics = x.Metrics()
    with x.chaos.chaos_plan(x.chaos.FaultPlan.single("pipeline.step", action, at=1)):
        loop = x.loop(depth=depth, tracer=x.Tracer(col, component="pipeline"), metrics=metrics)
        got = list(loop.run(waves))
    assert got == oracle  # the same placements, fault or no fault
    assert col.spans(name="fault_injected") and col.spans(name="recovery")
    return got, loop.stats["recovered"], fault_series(metrics), len(col.spans(name="device.step")), \
        metrics.hists["pipeline_cycle_seconds"].count, metrics.hists["pod_scheduling_sli_duration_seconds"].count


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("action", ["error", "nan"])
def test_pipeline_wave_death_recovers_matches_jax(action, depth):
    want, got = (wave_death(Pkg(n), action, depth) for n in SIDES)
    assert got == want and got[1] == 1


def stall(x: Pkg):
    waves = [x.wave(s, n_nodes=8, n_pods=16) for s in range(3)]
    metrics = x.Metrics()
    with x.chaos.chaos_plan(x.chaos.FaultPlan.single("host.stall", "stall", at=0, count=2, param=0.01),
                            metrics=metrics):
        got = list(x.loop(depth=1).run(waves))
    assert got == x.serial(waves)
    return got, fault_series(metrics)


def test_pipeline_host_stall_changes_nothing_but_wall():
    want, got = (stall(Pkg(n)) for n in SIDES)
    assert got == want


def commit_exception(x: Pkg):
    """An exception from the caller's commit callback mid-wave does not leak
    the dispatched wave: run()'s teardown drain still commits it."""
    waves = [x.wave(s, n_nodes=8, n_pods=16) for s in range(2)]
    committed = []
    state = {"boomed": False}

    def commit(v):
        if not state["boomed"]:
            state["boomed"] = True
            raise RuntimeError("commit boom")
        committed.append(v)

    loop = x.loop(depth=1, commit=commit)
    with pytest.raises(RuntimeError, match="commit boom"):
        list(loop.run(waves))
    assert loop._inflight is None
    return committed


def test_commit_exception_still_drains_inflight_wave():
    want, got = (commit_exception(Pkg(n)) for n in SIDES)
    assert got == want and len(got) == 1


# --- the flight recorder ---
def test_fingerprint_matches_jax():
    from kubernetes_tpu.scheduler.flightrecorder import fingerprint as jfp
    from kubernetes_tpu_torch.scheduler.flightrecorder import fingerprint as pfp

    rng = np.random.default_rng(3)
    cases = [
        {}, {"a": "n0", "b": None, "c": "n2"}, {f"default/p{i}": f"n{i % 7}" for i in range(500)},
        np.arange(37, dtype=np.int32), rng.integers(-1, 9, size=(5, 11)).astype(np.int64),
        rng.random(64).astype(np.float32), np.zeros(0, dtype=np.int32), ["x", 1, 2.5], (1, "a"), "plain", 12345,
    ]
    for obj in cases:
        assert pfp(obj) == jfp(obj), obj


def dump(x: Pkg, tmp_path):
    rec = x.flight.FlightRecorder(directory=str(tmp_path / x.name), capacity=3)
    rec.annotate(trace_crc="abc123", scenario="rollout", trace_offset=7, v_now=1.75)
    rec.annotate(trace_offset=9)  # the cursor advances; the later value wins
    for k in range(5):  # the ring keeps the last 3
        rec.record(profile="batch", pods=3 + k, scheduled=3, failed=k % 2, verdict_crc=x.flight.fingerprint({"k": k}),
                   classes=2, class_crc="00ff00ff", dirty_cols=k, trace_id="t" * 32,
                   diagnosis=[{"rep_row": 0, "pods": 2, "counts": {"Insufficient cpu": 2, "taint": 1}}])
    path = rec.dump(reason="kill.post_checkpoint")
    doc = x.flight.load_flight(path)
    text = x.flight.render_flight(doc)
    raw = json.load(open(path))
    assert raw.pop("dumped_wall") > 0
    with pytest.raises(ValueError):
        x.flight.load_flight(str(tmp_path / "absent.json"))
    return raw, text, os.path.basename(path), x.flight.FlightRecorder().dump() is None


def test_flight_dump_matches_jax(tmp_path):
    want, got = (dump(Pkg(n), tmp_path) for n in SIDES)
    assert got == want
    raw, text, _, _ = got
    assert raw["context"]["trace_offset"] == 9 and [r["seq"] for r in raw["records"]] == [3, 4, 5]
    assert "trace_crc=abc123" in text and "trace_offset=9" in text


def scheduler_dump(x: Side, tmp_path, monkeypatch):
    """A Scheduler armed with a checkpoint dir records a decision per cycle
    and dumps the ring when a kill fells it: the same records as JAX's, the
    times, trace ids and the SLI phase values aside (KTPU_MEMWATCH=0: the
    JAX records' memory block has no counterpart in the port, ROADMAP A13)."""
    monkeypatch.setenv("KTPU_CHECKPOINT_DIR", str(tmp_path / x.name))
    monkeypatch.setenv("KTPU_MEMWATCH", "0")
    store, sched = x.cluster(nodes=[mk_node(f"n{i}", cpu=3000, pods=16) for i in range(3)])
    for i in range(6):
        store.add_pod(mk_pod(f"a{i}", cpu=250))
    sched.run_until_idle()
    with x.chaos.chaos_plan(x.chaos.FaultPlan.parse("kill.post_checkpoint:kill@2")):
        for i in range(4):
            store.add_pod(mk_pod(f"b{i}", cpu=250))
        with pytest.raises(x.chaos.ProcessKilled):
            sched.run_until_idle()
    doc = json.load(open(tmp_path / x.name / "flight.json"))
    doc.pop("dumped_wall")
    for r in doc["records"]:
        r.pop("ts"), r.pop("trace_id")
        if "sli_phases" in r:
            r["sli_phases"] = (r["sli_phases"]["pods"], sorted(r["sli_phases"]["mean_ms"]))
    return doc


def test_scheduler_flight_dump_on_kill_matches_jax(tmp_path, monkeypatch):
    want, got = (scheduler_dump(Side(n), tmp_path, monkeypatch) for n in SIDES)
    assert got == want
    assert got["reason"] == "kill.post_checkpoint" and [r["scheduled"] for r in got["records"]] == [6]
