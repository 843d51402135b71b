"""Pipelined batch-scheduling cycles — host/device overlap; the port of the
JAX package's ``parallel/pipeline.py`` (its loop core).

A step is dispatched to the card without a host synchronisation
(ops/assign.py — dispatch), so the pipeline is ordinary control flow:

    loop = PipelinedBatchLoop()
    prev = loop.submit(wave_1)          # None (nothing in flight yet)
    prev = loop.submit(wave_2)          # wave_1's verdicts; wave_2 runs
    ...
    last = loop.drain()                 # the final wave's verdicts

``submit(wave_i)`` delta-encodes wave i (api/delta.py — DeltaEncoder),
brings the resident class state up to date (ops/incremental.py —
HoistCache) and dispatches step i WHILE step i-1 still runs, then waits
only for step i-1: an event recorded after step i-1 and the copies of its
choices and status into pinned host memory.  Depth 0 is the serial oracle
with the same dataflow: it collects the previous step before encoding and
waits for the new step inside ``submit``.

DEPENDENT wave streams (bench.py's warm cycles) feed verdicts back with a
one-wave lag: wave i+1 binds the placements of wave i-1, the newest FETCHED
wave, because wave i is still deciding.  Both depths run that dataflow, so
their decisions are identical.

Buffers.  JAX donates a wave's input buffers to its step and transfers
every wave fresh; torch has no donation, so the loop passes nothing of
that kind (no ``donate`` argument).  Its counterpart here is the
encoder's rule: every field that changed is copied into a NEW device
tensor, from pinned staging on a copy stream that the compute stream waits
on, an unchanged field is the resident tensor of the cycle before, and no
step, hoist or copy ever writes a tensor a step in flight reads.  So two
generations live on the card at once and neither disturbs the other.

``mesh`` (parallel/mesh.py -- a NodeMesh, or a pods x nodes GridMesh): the
loop's encoder and HoistCache take it, and each step runs sharded on the
route dispatch picks (parallel/sharded.py; config 3's warm waves: the
rounds route on class state; on a grid the pod rows are gathered at the
step's entry), the JAX package's PipelinedBatchLoop(mesh=) (its
pipeline.py:78-88).

``overlap_fraction()`` is the share of host pipeline work (encode and
decode) that ran while a dispatched step was still running on the card,
probed with the step's event (``query()``): 0.0 at depth 0, and 0.0 on the
CPU, where a step has ended when dispatch returns.

The restart half, as in the JAX package: ``commit`` is called with each
wave's verdicts as soon as they are decoded (inside the window of the step
just dispatched); ``wal`` with the in-flight wave's membership record
before each dispatch; the streaming kill points kill.submit, kill.dispatch
(the step issued, nothing fetched), kill.mid_step and kill.collect
(verdicts decoded, not committed) and kill.drain end the loop as a
SIGKILL would; a ``pipeline.step`` fault (a fetch that raises, or poisoned
verdicts) is answered by ``_recover_wave``: the wave re-encoded from host
state and its route re-run synchronously without class state, and
``PoisonedWave`` if the replay is still poisoned.  ``tracer`` takes the
encode / device.step / decode / commit spans, ``metrics`` the cycle time,
the overlap fraction and the wave's SLI and its phases.
``run_stream_restartable`` drives a wave list across kills: each kill is
answered by a fresh loop that replays exactly the waves its commit ledger
(the stream WAL in a CheckpointManager) has not recorded.
``PipelinedRunner`` is the runner facade over the loop.  The memory ledger
is ROADMAP A13.  The Scheduler's batch cycle (scheduler/scheduler.py)
keeps its own commit overlap: a cycle's deferred binds are published
while the next cycle's step runs.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Iterator, Optional, Tuple

import torch

from .. import chaos
from ..api.delta import DeltaEncoder
from ..ops import DEFAULT_SCORE_CONFIG, infer_score_config
from ..ops.assign import Step, dispatch, finish, inc_route_applies
from ..ops.incremental import HoistCache
from ..ops.scores import ScoreConfig

Verdicts = Dict[str, Optional[str]]


class PipelinedBatchLoop:
    """Depth-1 double-buffered encode -> dispatch -> collect loop over waves,
    on the encoder's device (the card unless the caller passes
    device="cpu").  depth=0 is the serial oracle."""

    def __init__(
        self,
        encoder: Optional[DeltaEncoder] = None,
        base_config: ScoreConfig = DEFAULT_SCORE_CONFIG,
        depth: int = 1,
        device=None,
        mesh=None,
        commit: Optional[Callable[[Verdicts], None]] = None,
        wal: Optional[Callable[[Dict], None]] = None,
        tracer=None,
        metrics=None,
    ):
        # the encoder scores the bound pods' hard affinity terms at the weight
        # the kernels read from base_config
        self.enc = encoder or DeltaEncoder(device, hard_pod_affinity_weight=base_config.hard_pod_affinity_weight)
        self.device = self.enc.device
        self.base_config = base_config
        self.depth = depth
        self.commit = commit
        # the stream wave WAL hook (run_stream_restartable): called at every
        # dispatch with the in-flight wave's membership record, BEFORE the
        # kill.dispatch death point
        self.wal = wal
        self.tracer = tracer
        self.metrics = metrics
        # the wave-uniform SLI phases (scheduler/metrics.py SLI_PHASES): the
        # loop has no queue, so queue_wait is 0, wave_wait the encode /
        # dispatch window, device_kernel dispatch -> fetch, bind the decode
        # and the commit
        self._phase_hists = None
        if metrics is not None:
            from ..scheduler.metrics import SLI_PHASES

            self._phase_hists = {ph: metrics.labeled_hist("pod_sli_phase_duration_seconds", phase=ph)
                                 for ph in SLI_PHASES}
        # the mesh of the sharded step (parallel/sharded.py): the encoder
        # keeps each node-axis field resident per shard (on a grid each
        # pod-axis field per pod row too), and the class state is hoisted
        # per shard and stitched once per cycle; an encoder already on a
        # mesh keeps it
        if mesh is not None:
            self.enc.set_mesh(mesh)
        self.mesh = self.enc.mesh
        # the resident class state, across cycles
        self.hoist = HoistCache(mesh=self.mesh)
        # (step, meta, choices on the host, sweeps on the host, done event,
        # class-state span attributes, t_arrival (the encode's start),
        # t_dispatch, snapshot) of the dispatched wave
        self._inflight = None
        self._wave = 0
        # per-kind host seconds: [total, overlapped with a step in flight]
        self.host_seconds: Dict[str, list] = {"encode": [0.0, 0.0], "commit": [0.0, 0.0], "decode": [0.0, 0.0]}
        # where the host time goes, summed over waves: the encode phase split
        # into the host encode, the device placement, the class-state update
        # and the dispatch; the waits for a step; the decode
        self.phase_seconds: Dict[str, float] = dict.fromkeys(
            ("encode", "to_device", "hoist", "dispatch", "wait", "decode"), 0.0)
        self.stats: Dict[str, float] = {"waves": 0, "recovered": 0}

    def _kill(self, site: str) -> None:
        """An enumerated process-death point of the streaming loop: a kill
        latches chaos.killed() before the ProcessKilled unwinds, so run()'s
        teardown drain does nothing a SIGKILL'd process couldn't; a fresh
        loop (run_stream_restartable) recovers."""
        if chaos.enabled():
            chaos.poke(site, tracer=self.tracer, metrics=self.metrics)

    # -- accounting --
    def _span(self, name: str, start: float, end: float, **attrs) -> None:
        if self.tracer is not None and self.tracer.enabled:
            self.tracer.record_span(name, start=start, end=end, **attrs)

    @staticmethod
    def _step_running(probe) -> Optional[bool]:
        """Whether the step behind the event `probe` is still running; None
        when there is nothing to observe (no probe: the CPU, or no step)."""
        if probe is None:
            return None
        return not probe.query()

    def _overlap_credit(self, probe, running_at_start) -> float:
        """The share of a host phase credited as hidden under the step in
        flight, by what is observable: still running at the phase's end ->
        1.0; already done at its start -> 0.0; done in between -> 0.5 (the
        error is at most half the phase)."""
        if running_at_start is None or not running_at_start:
            return 0.0
        return 1.0 if self._step_running(probe) else 0.5

    def _host_phase(self, kind: str, dt: float, credit: float) -> None:
        tot = self.host_seconds[kind]
        tot[0] += dt
        tot[1] += dt * credit

    def overlap_fraction(self) -> float:
        """The share of host pipeline work (encode + commit + decode) that
        ran while a dispatched step was still running."""
        total = sum(x[0] for x in self.host_seconds.values())
        hidden = sum(x[1] for x in self.host_seconds.values())
        return (hidden / total) if total > 0 else 0.0

    # -- the pipeline --
    def _dispatch(self, snap):
        probe = self._inflight[4] if self._inflight is not None else None
        running0 = self._step_running(probe)
        if chaos.enabled():
            # slow-host stall: encode-path latency only
            chaos.poke("host.stall", tracer=self.tracer, metrics=self.metrics)
        ph = self.phase_seconds
        t0 = time.perf_counter()
        host, meta = self.enc.encode(snap)
        cfg = infer_score_config(host, self.base_config)
        ta = time.perf_counter()
        arr, meta = self.enc.to_device(host, meta)
        tb = time.perf_counter()
        inc = self.hoist.ensure(arr, meta, cfg, host=host) if inc_route_applies(arr, cfg) else None
        tc = time.perf_counter()
        if self.wal is not None:
            # durable-then-die: the wave's record lands before the dispatch
            # and its kill point
            self.wal({"wave": self._wave, "pods": [p.name for p in snap.pending_pods]})
        step = dispatch(arr, cfg, device=self.device, inc=inc, mesh=self.mesh)
        done = None
        ch_host, sw_host = step.choices, step.sweeps
        if self.device.type == "cuda":
            # the choices and the status come back by copies queued right
            # after the step; the event marks both, so the collect waits for
            # this step alone, never for the one dispatched after it
            ch_host = torch.empty(step.choices.shape, dtype=step.choices.dtype, pin_memory=True)
            ch_host.copy_(step.choices, non_blocking=True)
            if isinstance(step.sweeps, torch.Tensor):
                sw_host = torch.empty(step.sweeps.shape, dtype=step.sweeps.dtype, pin_memory=True)
                sw_host.copy_(step.sweeps, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
        # kill.dispatch: the step issued, nothing fetched or committed — the
        # whole wave replays on the restarted loop
        self._kill("kill.dispatch")
        t1 = time.perf_counter()
        for k, dt in (("encode", ta - t0), ("to_device", tb - ta), ("hoist", tc - tb), ("dispatch", t1 - tc)):
            ph[k] += dt
        credit = self._overlap_credit(probe, running0)
        self._host_phase("encode", t1 - t0, credit)
        self._span("encode_overlap", t0, t1, component="pipeline", wave=self._wave, overlapped=credit > 0,
                   overlap_credit=credit)
        from ..scheduler.tracing import incremental_attrs

        return step, meta, ch_host, sw_host, done, incremental_attrs(self.hoist), t0

    def _recover_wave(self, snap, err: BaseException, t0: float):
        """Serial replay of a wave that died mid-flight (the fetch raised,
        or its verdicts were poisoned): re-encode from host state and re-run
        the wave's route synchronously, without class state.  The encoder
        and the route are deterministic, so the replay's verdicts are the
        ones the fault killed; a replay still poisoned raises PoisonedWave."""
        host, meta = self.enc.encode(snap)
        cfg = infer_score_config(host, self.base_config)
        arr, meta = self.enc.to_device(host, meta)
        ch = finish(dispatch(arr, cfg, device=self.device, mesh=self.mesh)).choices.cpu().numpy()
        if chaos.poisoned_verdicts(ch, len(meta.node_names)):
            raise chaos.PoisonedWave(f"wave {self._wave - 1}: serial replay still poisoned") from err
        self.stats["recovered"] += 1
        chaos.record_recovery("pipeline.step", "serial_replay", tracer=self.tracer, metrics=self.metrics, start=t0,
                              wave=self._wave - 1, error=type(err).__name__)
        return ch, meta

    def _collect(self) -> Optional[Verdicts]:
        if self._inflight is None:
            return None
        step, meta, ch_host, sw_host, done, inc_attrs, t_arrival, t_dispatch, snap = self._inflight
        self._inflight = None
        tw = time.perf_counter()
        try:
            if chaos.enabled():
                # kill.mid_step: death with the step still in flight (a
                # BaseException: the recovery below cannot catch it)
                chaos.poke("kill.mid_step", tracer=self.tracer, metrics=self.metrics)
            fault = chaos.poke("pipeline.step", tracer=self.tracer, metrics=self.metrics) if chaos.enabled() else None
            if done is not None:
                done.synchronize()  # the sync point: this step and its copies
            ch = ch_host.numpy()
            if fault is not None and fault.action == "nan":
                ch = chaos.poison(ch)
            if chaos.poisoned_verdicts(ch, len(meta.node_names)):
                raise chaos.PoisonedWave(f"wave {self._wave - 1}")
        except Exception as e:  # noqa: BLE001 — any mid-wave death recovers
            ch, meta = self._recover_wave(snap, e, tw)
        else:
            # the round-cap status is read where the choices are fetched: it
            # raises, never passes as unscheduled pods (not a transient fault)
            finish(Step(step.choices, step.used, step.ordinals, sw_host))
        self.phase_seconds["wait"] += time.perf_counter() - tw
        t1 = time.perf_counter()
        from ..scheduler.tracing import mesh_attrs

        self._span("device.step", t_dispatch, t1, component="pipeline", wave=self._wave - 1,
                   **mesh_attrs(self.mesh), **inc_attrs)
        # the decode overlaps only the NEXT step, dispatched before this
        # collect when pipelining
        probe = self._pending_event
        d_run0 = self._step_running(probe)
        names, nodes = meta.pod_names, meta.node_names
        verdicts = {names[k]: (nodes[int(ch[k])] if ch[k] >= 0 else None) for k in range(meta.n_pods)}
        t2 = time.perf_counter()
        self.phase_seconds["decode"] += t2 - t1
        credit = self._overlap_credit(probe, d_run0)
        self._host_phase("decode", t2 - t1, credit)
        self._span("decode_overlap", t1, t2, component="pipeline", wave=self._wave - 1, overlapped=credit > 0,
                   overlap_credit=credit)
        # kill.collect: verdicts decoded but NOT committed; the restart
        # driver replays the wave
        self._kill("kill.collect")
        if self.commit is not None:
            c_run0 = self._step_running(probe)
            t3 = time.perf_counter()
            self.commit(verdicts)
            t4 = time.perf_counter()
            ccredit = self._overlap_credit(probe, c_run0)
            self._host_phase("commit", t4 - t3, ccredit)
            self._span("commit_overlap", t3, t4, component="pipeline", wave=self._wave - 1,
                       overlapped=ccredit > 0, overlap_credit=ccredit, pods=len(verdicts))
        self.stats["waves"] += 1
        if self.metrics is not None:
            self.metrics.observe("pipeline_cycle_seconds", t2 - t_dispatch)
            # the wave's arrival -> bind SLI: one sample per bound pod at
            # the instant its verdict became consumable, identical within
            # a wave (no queue), so one bucket bump covers the wave
            n_bound = sum(1 for v in verdicts.values() if v is not None)
            if n_bound:
                t_end = time.perf_counter()
                self.metrics.hist("pod_scheduling_sli_duration_seconds").observe(t_end - t_arrival, n=n_bound)
                self._phase_hists["queue_wait"].observe(0.0, n=n_bound)
                self._phase_hists["wave_wait"].observe(max(0.0, t_dispatch - t_arrival), n=n_bound)
                self._phase_hists["device_kernel"].observe(max(0.0, t1 - t_dispatch), n=n_bound)
                self._phase_hists["bind"].observe(max(0.0, t_end - t1), n=n_bound)
        return verdicts

    # the event of the step dispatched after the one being collected (None
    # outside that window): the overlap probe of the decode
    _pending_event = None

    def submit(self, snap) -> Optional[Verdicts]:
        """Encode and dispatch `snap`; return the PREVIOUS wave's verdicts
        (None on the first call).  depth=0 collects BEFORE encoding and waits
        for the new step before returning."""
        # kill.submit: the wave accepted, nothing dispatched
        self._kill("kill.submit")
        if self.depth == 0:
            prev = self._collect()
            nxt = self._dispatch(snap)
            t_dispatch = time.perf_counter()
            if nxt[4] is not None:
                nxt[4].synchronize()
            self.phase_seconds["wait"] += time.perf_counter() - t_dispatch
            self._inflight = (*nxt, t_dispatch, snap)
            self._wave += 1
            return prev
        nxt = self._dispatch(snap)
        t_dispatch = time.perf_counter()
        self._pending_event = nxt[4]
        try:
            prev = self._collect()
        finally:
            # the dispatched wave is tracked even when the collect raises, so
            # a later drain() still fetches it
            self._pending_event = None
            self._inflight = (*nxt, t_dispatch, snap)
            self._wave += 1
        return prev

    def drain(self) -> Optional[Verdicts]:
        """Fetch the final in-flight wave's verdicts (None if none)."""
        # kill.drain: death at the stream's end with the final wave in flight
        self._kill("kill.drain")
        out = self._collect()
        if self.metrics is not None:
            self.metrics.observe("pipeline_overlap_fraction", self.overlap_fraction())
        return out

    def run(self, snapshots: Iterable) -> Iterator[Verdicts]:
        """Yield one verdict dict per snapshot, in order: the streaming form
        for INDEPENDENT waves."""
        try:
            for snap in snapshots:
                prev = self.submit(snap)
                if prev is not None:
                    yield prev
            last = self.drain()
            if last is not None:
                yield last
        finally:
            if self._inflight is not None and not chaos.killed():
                # abandoned mid-stream: fetch the last wave so its commit
                # runs and nothing stays in flight; teardown must not mask
                # the caller's exception.  Not on a kill: a SIGKILL'd
                # process gets no teardown
                try:
                    self.drain()
                    chaos.record_recovery("pipeline.step", "abort_drain", tracer=self.tracer, metrics=self.metrics)
                except Exception:  # noqa: BLE001
                    pass


class PipelinedRunner:
    """The runner facade over PipelinedBatchLoop for independent snapshot
    streams:

    >>> runner = PipelinedRunner(device="cpu")
    >>> for verdicts in runner.run(snapshots):
    ...     apply(verdicts)  # {pod_name: node_name | None}
    """

    def __init__(self, base_config: ScoreConfig = DEFAULT_SCORE_CONFIG, device=None):
        self.base_config = base_config
        self.device = device
        self.last_loop: Optional[PipelinedBatchLoop] = None

    def run(self, snapshots: Iterable) -> Iterator[Verdicts]:
        self.last_loop = PipelinedBatchLoop(base_config=self.base_config, depth=1, device=self.device)
        return self.last_loop.run(snapshots)


def run_serial(snapshots: Iterable, base_config: ScoreConfig = DEFAULT_SCORE_CONFIG,
               device=None) -> Iterator[Verdicts]:
    """The unpipelined oracle for the same stream: encode -> run -> wait, one
    snapshot at a time (the same dataflow as depth 1)."""
    return PipelinedBatchLoop(base_config=base_config, depth=0, device=device).run(snapshots)


# --- the streaming crash-restart driver (chaos kill.* over wave streams) ---
STREAM_WAL = "stream_wal"


def load_stream_wal(checkpoint) -> Dict[int, str]:
    """The committed-wave ledger from the stream wave WAL: {wave index ->
    verdict crc}.  Empty when unarmed, absent, or corrupt (load() already
    quarantined and counted corruption; the floor is a full replay, never
    a wrong one)."""
    if checkpoint is None:
        return {}
    doc = checkpoint.load(STREAM_WAL)
    if not doc:
        return {}
    return {int(k): str(v) for k, v in (doc.get("committed") or {}).items()}


def run_stream_restartable(waves, make_loop: Callable[..., PipelinedBatchLoop], checkpoint=None, metrics=None,
                           max_restarts: int = 16) -> Tuple[list, int]:
    """Drive a stream of waves to completion across kill.* chaos: every
    ProcessKilled is answered by a FRESH loop (the dead one's device state
    is unreadable by contract) replaying exactly the waves the commit
    ledger has not recorded.

    Exactly-once publication: each wave's verdicts land in the results
    ledger (the apiserver side, which survives the death) atomically with a
    crc append to the stream wave WAL, and commits arrive in submit order,
    so a kill leaves a committed prefix and an uncommitted suffix; the next
    incarnation replays only the suffix.  A replayed wave whose crc differs
    from its committed record raises (a double-publication hazard).

    make_loop(commit, wal) -> PipelinedBatchLoop: the caller sets depth,
    device and tracing and MUST pass both callbacks on.  checkpoint
    (CheckpointManager or None) makes the ledger durable.  Blackouts (kill
    -> replacement loop ready) observe into `failover_duration_seconds`,
    restarts into `scheduler_restarts_total`.  Returns (verdicts per wave,
    in order; #restarts)."""
    from ..scheduler.flightrecorder import fingerprint

    waves = list(waves)
    committed: Dict[int, str] = load_stream_wal(checkpoint)
    results: Dict[int, Verdicts] = {}
    inflight: Dict[str, object] = {}
    restarts = 0
    t_dead: Optional[float] = None

    def _persist() -> None:
        if checkpoint is not None:
            checkpoint.save(STREAM_WAL, {"committed": {str(k): v for k, v in committed.items()},
                                         "inflight": dict(inflight)})

    while True:
        todo = [k for k in range(len(waves)) if k not in results]
        if not todo:
            return [results[k] for k in range(len(waves))], restarts
        order = list(todo)  # commits arrive in submit order

        def commit(verdicts: Verdicts, _order=order) -> None:
            k = _order.pop(0)
            crc = fingerprint({u: verdicts[u] for u in sorted(verdicts)})
            prior = committed.get(k)
            if prior is not None and prior != crc:
                raise RuntimeError(f"stream wave {k} replay diverged from its committed record: {prior} != {crc} "
                                   "— refusing to double-publish")
            results[k] = verdicts
            committed[k] = crc
            _persist()

        def wal(rec: Dict, _order=order) -> None:
            inflight.clear()
            inflight.update(rec)
            # the global wave index the next commit lands on (the loop's
            # own `wave` field is its local ordinal)
            inflight["stream_wave"] = _order[0] if _order else -1
            _persist()

        loop = make_loop(commit, wal if checkpoint is not None else None)
        if t_dead is not None:
            # the replacement loop is ready: the stream's takeover blackout
            blackout = time.perf_counter() - t_dead
            t_dead = None
            if metrics is not None:
                metrics.observe("failover_duration_seconds", blackout)
        try:
            for k in todo:
                loop.submit(waves[k])
            loop.drain()
        except chaos.ProcessKilled as e:
            restarts += 1
            if restarts > max_restarts:
                raise
            t_dead = time.perf_counter()
            chaos.revive()  # the latch belongs to the dead loop
            if metrics is not None:
                metrics.inc("scheduler_restarts_total")
            chaos.record_recovery(e.fault.site, "stream_restart", tracer=loop.tracer, metrics=metrics,
                                  committed_waves=len(results))


__all__ = ["PipelinedBatchLoop", "PipelinedRunner", "STREAM_WAL", "Verdicts", "load_stream_wal", "run_serial",
           "run_stream_restartable"]
