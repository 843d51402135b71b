"""TPUScore gRPC sidecar, server side — the port of the JAX package's
``runtime/sidecar.py`` onto the card.

The process that owns the card: it receives activeQ + NodeInfo snapshots
over gRPC, runs the batched filter/score/commit kernels and answers with
binding verdicts.  Single-writer by construction: device work is
serialized through one lock; session bookkeeping lives under a separate
fast lock so control-plane answers (not_ready / resync_required) never
wait on the card.

The session/delta protocol (tpuscore.proto, shared with the JAX package
byte for byte): a session-holding client ships the cluster once, then per
cycle only the spec-interned pending wave and the bound-pod diff.  Each
session owns a resident ``api/delta.py — DeltaEncoder``, so the encode is
incremental (``encode_pregrouped``: the wave is encoded from its spec reps
without one pod object per pending pod).  Crash-only: the server may drop
any session at any time and answer resync_required; the client re-sends
the full snapshot.  A cold session above the warm-up threshold answers
not_ready once and warms in the background (encode, the kernels' build,
one run); /readyz reflects that state.

``_Engine.run_session`` holds the device lock over the host encode and the
DISPATCH only (``ops.assign.dispatch``, or the gang device fixpoint's
``ops.gang.gang_dispatch``), which read nothing back; the round-cap status
and the choices are read outside the lock, so wave k+1's decode and encode
overlap wave k's kernels.

``grpc``, the protobuf module and ``convert``'s wire functions are imported
by the wire classes and functions only: ``_Engine`` and ``_Session`` import
without grpc or protobuf installed.  Service stubs are hand-wired with
grpc.method_handlers_generic_handler, as in the JAX package.

    python -m kubernetes_tpu_torch.runtime.sidecar --listen 127.0.0.1:50151 [--device cpu]
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..analysis.lockcheck import make_lock
from ..api import types as t
from ..device import resolve_device
from .convert import clone_pod

SERVICE = "tpuscore.TPUScore"


class _Session:
    """Per-client resident cluster state + encoder (single-writer: mutated
    only under _Engine._state_lock)."""

    def __init__(self, hpaw: float, device=None):
        from ..api.delta import DeltaEncoder

        self.enc = DeltaEncoder(device, hard_pod_affinity_weight=hpaw)
        self.hpaw = hpaw
        self.nodes: List[t.Node] = []
        self.bound: Dict[str, t.Pod] = {}
        # uid -> the wave pod's spec REP (no per-pod objects exist on the
        # session path; bind copies clone from the rep with clone_pod)
        self.last_wave: Dict[str, t.Pod] = {}
        # uid -> node NAME assigned by the previous response: the referent
        # of the delta's bind_prev_assignment compression
        self.last_assign: Dict[str, str] = {}
        # serialized spec bytes -> decoded rep Pod (convert.wave_parts_from_
        # proto): keeps rep OBJECTS stable across waves so the resident
        # encoder's identity-level interning hits
        self.rep_cache: Dict[bytes, t.Pod] = {}
        self.pod_groups: Dict[str, t.PodGroup] = {}
        self.epoch = 0
        self.ready = False
        self.warming = False
        # wholesale-bind clones built in the background right after a
        # response ships (exact: derived from last_assign + last_wave, both
        # frozen at response time); the next delta's bind_prev_assignment
        # consumes them off its critical path
        self.prebind: Optional[Dict[str, t.Pod]] = None
        self.prebind_epoch = -1
        self.prebind_done = threading.Event()


class _ResyncRequired(Exception):
    pass


class _Engine:
    """The scheduling engine the server fronts, on `device` (the card
    unless the caller passes device="cpu").

    warmup_threshold: wave x nodes size above which a COLD session (no run
    yet at that coarse shape) answers not_ready and warms in the background
    instead of blowing the client's deadline; smaller problems run inline.
    `warmed` is set each time a background warm-up ends."""

    # LRU-evicted: each session pins its cluster objects, a resident
    # DeltaEncoder and its device tensors; the cap is the bound
    MAX_SESSIONS = 4

    def __init__(self, warmup_threshold: int = 4_000_000, device=None):
        from ..scheduler.metrics import Metrics

        self.device = resolve_device(device)
        self._lock = make_lock("_Engine._lock")  # device owner
        self._state_lock = make_lock("_Engine._state_lock")  # session bookkeeping
        self._sessions: Dict[str, _Session] = {}  # insertion == LRU order
        self.warmup_threshold = warmup_threshold
        # coarse (P bucket, N bucket, gang) shapes that have run: the kernels
        # of their routes are built and loaded
        self._compiled: set = set()
        self.warmed = threading.Event()
        # per-phase latency histograms (decode / encode / dispatch / step),
        # served over HealthServer /metrics
        self.metrics = Metrics()
        if self.device.type == "cuda":
            self._load_kernels()

    def _load_kernels(self) -> None:
        """Build the kernels and load every route's modules now, on a batch
        of 128 pods in one group on one node (ops/gang.py load_kernels): a
        module that loads lazily inside run_session would wait for the
        card's running work while the device lock is held."""
        from ..api.delta import DeltaEncoder
        from ..api.snapshot import Snapshot
        from ..ops import kernels
        from ..ops.gang import load_kernels
        from ..ops.scores import DEFAULT_SCORE_CONFIG, infer_score_config

        kernels.build()
        node = t.Node(name="n0", allocatable={t.CPU: 1000, t.MEMORY: 1 << 30, t.PODS: 110})
        pods = [t.Pod(name=f"p{i}", requests={t.CPU: 1}, pod_group="g") for i in range(128)]
        snap = Snapshot(nodes=[node], pending_pods=pods, pod_groups={"g": t.PodGroup(name="g", min_member=1)})
        arr, _ = DeltaEncoder(self.device).encode_device(snap)
        load_kernels(arr, infer_score_config(arr, DEFAULT_SCORE_CONFIG))
        torch.cuda.synchronize(self.device)

    def _cfg(self, host, hpaw: float):
        from ..ops.scores import DEFAULT_SCORE_CONFIG, infer_score_config

        return infer_score_config(host, dataclasses.replace(DEFAULT_SCORE_CONFIG, hard_pod_affinity_weight=hpaw))

    # --- the stateless path ---
    def schedule(self, snap, gang: bool, hard_pod_affinity_weight: float = 1.0):
        """One full snapshot -> (choices i64 numpy [P], meta); gangs through
        the host fixpoint, as the JAX package's stateless path."""
        from ..api.delta import DeltaEncoder
        from ..ops.assign import schedule_batch
        from ..ops.gang import schedule_with_gangs

        with self._lock:  # single writer on the device
            # the weight applies in both stages: pre-bound pods at encode
            # time, batch-committed pods through the kernel config
            enc = DeltaEncoder(self.device, hard_pod_affinity_weight=hard_pod_affinity_weight)
            host, meta = enc.encode(snap)
            cfg = self._cfg(host, hard_pod_affinity_weight)
            arr, meta = enc.to_device(host, meta)
            if gang:
                choices = schedule_with_gangs(arr, cfg, device=self.device)[0]
            else:
                choices = schedule_batch(arr, cfg, device=self.device)[0]
            return choices.cpu().numpy().astype(np.int64), meta

    # --- the session path ---
    def apply_request(self, request):
        """Update (or create) the session's cluster state from the request.
        -> (session, wave (uids, reps, inv), view (bound pods, pod groups)).
        Raises _ResyncRequired on any gap."""
        from .convert import node_from_proto, pod_from_proto, wave_parts_from_proto

        hpaw = request.hard_pod_affinity_weight if request.HasField("hard_pod_affinity_weight") else 1.0
        with self._state_lock:
            sess0 = self._sessions.get(request.session_id)
            rep_cache = sess0.rep_cache if sess0 is not None else {}
        # decode outside the lock; rep_cache is only touched by this
        # session's requests (one client), and a full sync carries it into
        # the fresh session so resyncs keep rep objects identity-stable
        wave = wave_parts_from_proto(request.wave, rep_cache)
        # wait for this session's prebind OUTSIDE the state lock: other
        # sessions' RPCs and /readyz never queue behind one session's
        # background clone build
        if (sess0 is not None and request.HasField("delta") and request.delta.bind_prev_assignment
                and sess0.prebind_epoch == request.delta.base_epoch):
            sess0.prebind_done.wait(timeout=30.0)
        with self._state_lock:
            sess = self._sessions.get(request.session_id)
            if sess is not None:  # refresh the LRU position
                self._sessions.pop(request.session_id)
                self._sessions[request.session_id] = sess
            if request.HasField("delta"):
                d = request.delta
                if sess is None or sess.epoch != d.base_epoch or sess.hpaw != hpaw:
                    raise _ResyncRequired()
                if d.bind_prev_assignment:
                    # the client echoes our previous assignment: bind it
                    # wholesale minus the exception list, preferring the
                    # clones precomputed in the background
                    exc = set(d.bind_prev_except)
                    pre = None
                    if sess.prebind_epoch == d.base_epoch and sess.prebind_done.is_set():
                        pre = sess.prebind
                    if pre is not None:
                        self.metrics.inc("sidecar_prebind_hits")
                        for uid, p in pre.items():
                            if uid not in exc:
                                sess.bound[uid] = p
                    else:
                        for uid, node in sess.last_assign.items():
                            if uid in exc:
                                continue
                            rep = sess.last_wave.get(uid)
                            if rep is None:
                                raise _ResyncRequired()
                            sess.bound[uid] = clone_pod(rep, uid, uid, node)
                for b in d.binds:
                    rep = sess.last_wave.get(b.pod_uid)
                    if rep is None:
                        raise _ResyncRequired()
                    # the bound copy shares the rep's field objects, so the
                    # encoder's bind-absorb `is` checks hold
                    sess.bound[b.pod_uid] = clone_pod(rep, b.pod_uid, b.pod_uid, b.node)
                for uid in d.deleted_uids:
                    sess.bound.pop(uid, None)
                for msg in d.added_bound:
                    p = pod_from_proto(msg)
                    sess.bound[p.uid] = p
            else:
                # a full sync (re)builds the session; LRU-evict beyond the cap
                sess = _Session(hpaw, self.device)
                sess.rep_cache = rep_cache
                self._sessions[request.session_id] = sess
                while len(self._sessions) > self.MAX_SESSIONS:
                    del self._sessions[next(iter(self._sessions))]
                sess.nodes = [node_from_proto(n) for n in request.snapshot.nodes]
                sess.bound = {p.uid: p for p in (pod_from_proto(m) for m in request.snapshot.bound_pods)}
            sess.pod_groups = {g.name: t.PodGroup(name=g.name, min_member=g.min_member)
                               for g in request.snapshot.pod_groups}
            uids, reps, inv = wave
            sess.last_wave = dict(zip(uids, (reps[i] for i in inv.tolist())))
            sess.epoch = request.epoch
            # the encode inputs, captured UNDER the state lock: the warm-up
            # thread and run_session never iterate sess.bound while a later
            # RPC's delta mutates it
            view = (list(sess.bound.values()), dict(sess.pod_groups))
            return sess, wave, view

    def coarse_shape_parts(self, sess: _Session, wave, gang: bool):
        from ..api.snapshot import _bucket

        uids, _reps, _inv = wave
        return (_bucket(len(uids)), _bucket(len(sess.nodes)), gang)

    def run_session(self, sess: _Session, wave, gang: bool, view=None):
        """One wave: encode -> dispatch under the device lock -> read back
        outside it.  -> (choices i64 numpy [P] in the meta's pod order,
        meta).  Gang waves take the device fixpoint (ops/gang.py
        gang_dispatch: G + 1 queued iterations, no host read between them)."""
        from ..ops.assign import dispatch, finish
        from ..ops.gang import gang_dispatch, gang_finish

        uids, reps, inv = wave
        if view is None:  # direct callers outside an RPC
            with self._state_lock:
                view = (list(sess.bound.values()), dict(sess.pod_groups))
        bound, groups = view
        with self._lock:
            t0 = time.perf_counter()
            host, meta = sess.enc.encode_pregrouped(sess.nodes, bound, groups, uids, reps, inv)
            cfg = self._cfg(host, sess.hpaw)  # on the host arrays: no device read
            arr, meta = sess.enc.to_device(host, meta)
            t1 = time.perf_counter()
            self.metrics.observe("sidecar_encode_seconds", t1 - t0)
            if gang:
                step = gang_dispatch(arr, cfg, self.device)
            else:
                step = dispatch(arr, cfg, self.device)
            t2 = time.perf_counter()
            self.metrics.observe("sidecar_dispatch_seconds", t2 - t1)
            self._compiled.add(self.coarse_shape_parts(sess, wave, gang))
        # the blocking reads, outside the device lock: the round-cap status,
        # then the choices
        choices = gang_finish(step)[0] if gang else finish(step).choices
        out = choices.cpu().numpy().astype(np.int64)
        self.metrics.observe("sidecar_step_seconds", time.perf_counter() - t2)
        return out, meta

    def warmup(self, sess: _Session, wave, gang: bool, view=None) -> None:
        """Background: encode + build + run once, then mark ready.  The
        results are discarded (the client took its fallback for this
        cycle); what survives is the built kernels and the session's
        resident encoder state.  A FAILED warm-up drops the session
        (crash-only): the client's next request resyncs."""
        try:
            self.run_session(sess, wave, gang, view)
        except Exception:  # noqa: BLE001 — crash-only containment
            with self._state_lock:
                sess.warming = False
                for sid, s in list(self._sessions.items()):
                    if s is sess:
                        del self._sessions[sid]
            self.warmed.set()
            return
        with self._state_lock:
            sess.warming = False
            sess.ready = True
        self.warmed.set()

    @property
    def ready(self) -> bool:
        with self._state_lock:
            return all(s.ready for s in self._sessions.values())


def _parent_ctx(context):
    """The client-stamped span context from the gRPC metadata
    (_trace_metadata of client.py, as of the JAX package's client) -> a
    SpanContext or None;
    with it the server-side schedule span joins the client's trace."""
    from ..scheduler.tracing import SpanContext

    try:
        md = {k: v for k, v in (context.invocation_metadata() or ())}
    except Exception:  # noqa: BLE001 — tests pass bare mocks
        return None
    tid, sid = md.get("ktpu-trace-id"), md.get("ktpu-span-id")
    if tid and sid:
        return SpanContext(tid, sid)
    return None


class TPUScoreServer:
    # full snapshots at north-star scale exceed gRPC's 4 MB default
    MAX_MSG = 256 * 1024 * 1024

    def __init__(self, address: str = "127.0.0.1:0", engine: Optional[_Engine] = None, collector=None):
        from concurrent import futures

        import grpc

        from ..scheduler.tracing import Tracer
        from . import tpuscore_pb2 as pb

        self.engine = engine or _Engine()
        # span tracing: the default process collector unless injected
        self.tracer = Tracer(collector, component="sidecar")
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=4),
            options=[("grpc.max_receive_message_length", self.MAX_MSG),
                     ("grpc.max_send_message_length", self.MAX_MSG)],
        )
        handlers = {
            "Schedule": grpc.unary_unary_rpc_method_handler(
                self._schedule, request_deserializer=pb.ScheduleRequest.FromString,
                response_serializer=pb.ScheduleResponse.SerializeToString),
            "Health": grpc.unary_unary_rpc_method_handler(
                self._health, request_deserializer=pb.HealthRequest.FromString,
                response_serializer=pb.HealthResponse.SerializeToString),
        }
        self._server.add_generic_rpc_handlers((grpc.method_handlers_generic_handler(SERVICE, handlers),))
        self.port = self._server.add_insecure_port(address)

    # --- RPCs ---
    def _schedule(self, request, context):
        """The Schedule RPC, traced under the CLIENT's span context when the
        request metadata carries one."""
        if not self.tracer.enabled:
            return self._schedule_inner(request, context)
        with self.tracer.span("sidecar.schedule", parent=_parent_ctx(context),
                              session=request.session_id or "stateless",
                              pods=len(request.wave.uids) or len(request.snapshot.pending_pods)):
            return self._schedule_inner(request, context)

    def _schedule_inner(self, request, context):
        from . import tpuscore_pb2 as pb

        t0 = time.perf_counter()
        if not request.session_id:
            return self._schedule_stateless(request, t0)
        try:
            sess, wave, view = self.engine.apply_request(request)
        except _ResyncRequired:
            return pb.ScheduleResponse(resync_required=True)
        eng = self.engine
        m = eng.metrics
        m.observe("sidecar_decode_seconds", time.perf_counter() - t0)
        with eng._state_lock:
            m.set("sidecar_sessions_resident", len(eng._sessions))
        if not sess.ready:
            small = len(wave[0]) * max(1, len(sess.nodes)) < eng.warmup_threshold
            spawn = False
            with eng._state_lock:  # check-then-act atomic across the RPC pool
                if small or eng.coarse_shape_parts(sess, wave, request.gang) in eng._compiled:
                    sess.ready = True  # affordable, or already paid: serve now
                elif not sess.warming:
                    sess.warming = True
                    spawn = True
            if spawn:
                threading.Thread(target=eng.warmup, args=(sess, wave, request.gang, view), daemon=True).start()
            if not sess.ready:
                return pb.ScheduleResponse(not_ready=True, epoch=sess.epoch)
        choices, meta = eng.run_session(sess, wave, request.gang, view)
        # aligned-array verdicts: node index per wave pod in REQUEST order
        # (meta.pod_perm maps device order -> request order; node indices are
        # the session's node-list order == the client's own node list)
        resp = pb.ScheduleResponse(epoch=sess.epoch)
        out = np.full(meta.n_pods, -1, dtype=np.int64)
        out[meta.pod_perm] = choices[: meta.n_pods]
        resp.assignment.extend(out.tolist())
        # what we just assigned: the next delta may bind it by reference
        # (bind_prev_assignment); built outside the state lock
        node_names = [nd.name for nd in sess.nodes]
        last_assign = {uid: node_names[int(c)] for uid, c in zip(wave[0], out.tolist()) if c >= 0}
        # the wholesale-bind clones, built in the background: the worker
        # holds its own references (last_assign / last_wave are only ever
        # rebound by later requests), so a racing next request sees either
        # a completed exact precompute for this epoch or clones inline
        ev = threading.Event()
        state_lock = eng._state_lock
        with state_lock:
            sess.last_assign = last_assign
            sess.prebind = None
            sess.prebind_done = ev
            sess.prebind_epoch = sess.epoch
        wave_map = sess.last_wave

        def _prebind(assign=last_assign, wave_map=wave_map, ev=ev, sess=sess, lock=state_lock):
            try:
                pre: Optional[Dict[str, t.Pod]] = {}
                for uid, node in assign.items():
                    rep = wave_map.get(uid)
                    if rep is None:
                        pre = None  # a missing rep: the inline path raises resync
                        break
                    pre[uid] = clone_pod(rep, uid, uid, node)
                with lock:
                    if sess.prebind_done is ev:  # not superseded
                        sess.prebind = pre
            finally:
                # set even on failure: a waiter falls back to the inline path
                ev.set()

        threading.Thread(target=_prebind, daemon=True).start()
        resp.elapsed_ms = (time.perf_counter() - t0) * 1e3
        m.observe("sidecar_schedule_seconds", time.perf_counter() - t0)
        return resp

    def _schedule_stateless(self, request, t0):
        from . import tpuscore_pb2 as pb
        from .convert import snapshot_from_proto, wave_from_proto

        snap = snapshot_from_proto(request.snapshot)
        if request.wave.uids or request.wave.specs:
            snap.pending_pods = wave_from_proto(request.wave)
        uid_of = {p.name: p.uid for p in snap.pending_pods}
        hpaw = request.hard_pod_affinity_weight if request.HasField("hard_pod_affinity_weight") else 1.0
        choices, meta = self.engine.schedule(snap, request.gang, hpaw)
        resp = pb.ScheduleResponse()
        self._fill_verdicts(resp, choices, meta, uid_of)
        resp.elapsed_ms = (time.perf_counter() - t0) * 1e3
        return resp

    @staticmethod
    def _fill_verdicts(resp, choices, meta, uid_of) -> None:
        from . import tpuscore_pb2 as pb

        for k in range(meta.n_pods):
            c = int(choices[k])
            resp.verdicts.append(pb.Verdict(pod_uid=uid_of[meta.pod_names[k]],
                                            node=meta.node_names[c] if c >= 0 else "", scheduled=c >= 0))

    def _health(self, request, context):
        from . import tpuscore_pb2 as pb

        dev = self.engine.device
        return pb.HealthResponse(ok=True, platform=dev.type,
                                 device_count=torch.cuda.device_count() if dev.type == "cuda" else 1,
                                 ready=self.engine.ready)

    # --- lifecycle ---
    def start(self) -> int:
        self._server.start()
        return self.port

    def stop(self, grace: float = 0.5) -> None:
        self._server.stop(grace)


class HealthServer:
    """component-base health + metrics + zpages endpoints: /healthz /readyz
    /livez, Prometheus-text /metrics, /statusz (component + uptime) and
    /flagz (effective configuration)."""

    def __init__(self, address: str = "127.0.0.1:0", metrics=None, ready_check=None,
                 component: str = "tpuscore-sidecar", flags=None):
        import http.server

        self.metrics = metrics
        self.ready_check = ready_check or (lambda: True)
        self.component = component
        self.flags = dict(flags or {})
        self._started_at = time.time()
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                if self.path in ("/healthz", "/livez"):
                    body, code = b"ok", 200
                elif self.path == "/readyz":
                    body, code = (b"ok", 200) if outer.ready_check() else (b"not ready", 503)
                elif self.path == "/metrics":
                    body, code = outer._render_metrics().encode(), 200
                elif self.path == "/statusz":
                    up = time.time() - outer._started_at
                    body = (f"{outer.component}\nstatus: {'ok' if outer.ready_check() else 'not ready'}\n"
                            f"uptime_seconds: {up:.1f}\n").encode()
                    code = 200
                elif self.path == "/flagz":
                    body = "".join(f"{k}={v}\n" for k, v in sorted(outer.flags.items())).encode() or b"(no flags)\n"
                    code = 200
                else:
                    body, code = b"not found", 404
                self.send_response(code)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        host, _, port = address.partition(":")
        self._httpd = http.server.HTTPServer((host, int(port or 0)), Handler)
        self.port = self._httpd.server_port
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)

    def _render_metrics(self) -> str:
        # the full registry in Prometheus text format (scheduler/metrics.py
        # Metrics.expose_text)
        return "\n" if self.metrics is None else self.metrics.expose_text()

    def start(self) -> int:
        self._thread.start()
        return self.port

    def stop(self) -> None:
        self._httpd.shutdown()


def main() -> None:  # pragma: no cover - manual entry point
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--listen", default="127.0.0.1:50151")
    ap.add_argument("--device", default=None, help="the engine's device (default: the card; cpu: the plain path)")
    ap.add_argument("--health-port", type=int, default=0, help="serve /healthz /readyz /livez /metrics (0 = off)")
    args = ap.parse_args()
    srv = TPUScoreServer(args.listen, engine=_Engine(device=args.device))
    port = srv.start()
    if args.health_port:
        hs = HealthServer(f"127.0.0.1:{args.health_port}", metrics=srv.engine.metrics,
                          ready_check=lambda: srv.engine.ready)
        print(f"health endpoints on port {hs.start()}")
    print(f"tpuscore sidecar listening on port {port}")
    threading.Event().wait()


if __name__ == "__main__":
    main()
