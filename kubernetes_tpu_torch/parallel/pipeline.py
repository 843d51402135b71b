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

Not ported here: the commit callback, the chaos kill points and wave
recovery, the stream WAL, tracer spans, metrics and the memory ledger,
``PipelinedRunner`` and ``run_stream_restartable`` (ROADMAP.md queue A13,
A14).  The Scheduler's batch cycle (scheduler/scheduler.py) keeps its own
commit overlap: a cycle's deferred binds are published while the next
cycle's step runs.
"""

from __future__ import annotations

import time
from typing import Dict, Iterable, Iterator, Optional

import torch

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
    ):
        self.enc = encoder or DeltaEncoder(device)
        self.device = self.enc.device
        self.base_config = base_config
        self.depth = depth
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
        # t_dispatch, snapshot) of the dispatched wave
        self._inflight = None
        self._wave = 0
        # per-kind host seconds: [total, overlapped with a step in flight]
        self.host_seconds: Dict[str, list] = {"encode": [0.0, 0.0], "decode": [0.0, 0.0]}
        # where the host time goes, summed over waves: the encode phase split
        # into the host encode, the device placement, the class-state update
        # and the dispatch; the waits for a step; the decode
        self.phase_seconds: Dict[str, float] = dict.fromkeys(
            ("encode", "to_device", "hoist", "dispatch", "wait", "decode"), 0.0)
        self.stats: Dict[str, float] = {"waves": 0}

    # -- accounting --
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
        """The share of host pipeline work (encode + decode) that ran while a
        dispatched step was still running."""
        total = sum(x[0] for x in self.host_seconds.values())
        hidden = sum(x[1] for x in self.host_seconds.values())
        return (hidden / total) if total > 0 else 0.0

    # -- the pipeline --
    def _dispatch(self, snap):
        probe = self._inflight[4] if self._inflight is not None else None
        running0 = self._step_running(probe)
        ph = self.phase_seconds
        t0 = time.perf_counter()
        host, meta = self.enc.encode(snap)
        cfg = infer_score_config(host, self.base_config)
        ta = time.perf_counter()
        arr, meta = self.enc.to_device(host, meta)
        tb = time.perf_counter()
        inc = self.hoist.ensure(arr, meta, cfg, host=host) if inc_route_applies(arr, cfg) else None
        tc = time.perf_counter()
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
        t1 = time.perf_counter()
        for k, dt in (("encode", ta - t0), ("to_device", tb - ta), ("hoist", tc - tb), ("dispatch", t1 - tc)):
            ph[k] += dt
        self._host_phase("encode", t1 - t0, self._overlap_credit(probe, running0))
        return step, meta, ch_host, sw_host, done

    def _collect(self) -> Optional[Verdicts]:
        if self._inflight is None:
            return None
        step, meta, ch_host, sw_host, done, _, _ = self._inflight
        self._inflight = None
        tw = time.perf_counter()
        if done is not None:
            done.synchronize()  # the sync point: this step and its copies
        self.phase_seconds["wait"] += time.perf_counter() - tw
        # the round-cap status is read where the choices are fetched: it
        # raises, never passes as unscheduled pods
        finish(Step(step.choices, step.used, step.ordinals, sw_host))
        ch = ch_host.numpy()
        t1 = time.perf_counter()
        # the decode overlaps only the NEXT step, dispatched before this
        # collect when pipelining
        probe = self._pending_event
        d_run0 = self._step_running(probe)
        names, nodes = meta.pod_names, meta.node_names
        verdicts = {names[k]: (nodes[int(ch[k])] if ch[k] >= 0 else None) for k in range(meta.n_pods)}
        t2 = time.perf_counter()
        self.phase_seconds["decode"] += t2 - t1
        self._host_phase("decode", t2 - t1, self._overlap_credit(probe, d_run0))
        self.stats["waves"] += 1
        return verdicts

    # the event of the step dispatched after the one being collected (None
    # outside that window): the overlap probe of the decode
    _pending_event = None

    def submit(self, snap) -> Optional[Verdicts]:
        """Encode and dispatch `snap`; return the PREVIOUS wave's verdicts
        (None on the first call).  depth=0 collects BEFORE encoding and waits
        for the new step before returning."""
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
        return self._collect()

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
            if self._inflight is not None:
                # abandoned mid-stream: fetch the last wave so nothing stays
                # in flight; teardown must not mask the caller's exception
                try:
                    self.drain()
                except Exception:  # noqa: BLE001
                    pass


def run_serial(snapshots: Iterable, base_config: ScoreConfig = DEFAULT_SCORE_CONFIG,
               device=None) -> Iterator[Verdicts]:
    """The unpipelined oracle for the same stream: encode -> run -> wait, one
    snapshot at a time (the same dataflow as depth 1)."""
    return PipelinedBatchLoop(base_config=base_config, depth=0, device=device).run(snapshots)


__all__ = ["PipelinedBatchLoop", "Verdicts", "run_serial"]
