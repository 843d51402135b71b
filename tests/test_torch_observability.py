"""The port's tracing exporters, cycle attribution, sub-phase scopes and
torch.profiler attribution, held to the JAX package's.

- The same spans fed to both packages' TraceCollector give the same
  ``chrome_trace`` (span and trace ids masked), ``tree_text`` and
  ``attribute_spans`` report (JAX tests/test_tracing.py:105, :185 and
  tests/test_observability.py:344-457); a traced cluster (store, apiserver,
  Scheduler, kubelet) exports the same tree in both packages, durations
  masked.
- The measured table's functions on the JAX fixture profile (JAX
  tests/test_costmodel.py:33, :205, :226, :245): the same table, merged
  spans and nested rendering.
- ``device_trace`` of the port's plain warm loop on the CPU loads back, and
  every CPU op inside a declared scope is owned by that scope; the scopes
  are where ops/scopes.py says.
- ``KTPU_NAMED_SCOPES=0`` changes no decision and no route (JAX
  tests/test_costmodel.py:349).
"""

import importlib
import json
import re
from types import SimpleNamespace

import pytest
import torch

from helpers import mk_node, mk_pod
from kubernetes_tpu_torch.api.delta import DeltaEncoder
from kubernetes_tpu_torch.api.snapshot import Snapshot
from kubernetes_tpu_torch.bench import profiling, workloads
from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, infer_score_config, scopes
from kubernetes_tpu_torch.parallel.pipeline import PipelinedBatchLoop
from kubernetes_tpu_torch.scheduler import attribution, tracing
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

PACKAGES = {"jax": "kubernetes_tpu", "port": "kubernetes_tpu_torch"}


def pkg(name: str) -> SimpleNamespace:
    root = PACKAGES[name]
    return SimpleNamespace(tracing=importlib.import_module(f"{root}.scheduler.tracing"),
                           attribution=importlib.import_module(f"{root}.scheduler.attribution"))


# ---------------------------------------------------------------------------
# the same spans in both packages
# ---------------------------------------------------------------------------

# (name, component, start, end, parent index or None, attributes, events)
SPAN_CASES = {
    "pipelined": [
        ("device.step", "pipeline", 0.0, 1.0, None, {"wave": 0}, []),
        ("encode_overlap", "pipeline", 0.1, 0.4, None, {}, []),
        ("commit_overlap", "pipeline", 1.0, 1.2, None, {}, []),
        ("device.step", "pipeline", 1.5, 2.5, None, {"wave": 1}, []),
        ("hoist.update", "pipeline", 1.25, 1.35, None, {"action": "patch"}, []),
    ],
    "scheduler-tree": [
        ("batch.cycle", "scheduler", 10.0, 12.0, None, {"pods": 3}, [(10.5, "wave", {"n": 3})]),
        ("batch.encode", "scheduler", 10.0, 10.5, 0, {}, []),
        ("hoist.update", "scheduler", 10.4, 10.5, 1, {"action": "full"}, []),
        ("batch.kernel", "scheduler", 10.5, 11.0, 0, {"route": "class_waves"}, [(10.75, "launch", {})]),
        ("batch.commit", "scheduler", 11.0, 11.9, 0, {}, []),
        ("bind", "scheduler", 11.1, 11.2, 4, {"pod": "default/p0"}, []),
        ("queue.wait", "queue", 9.0, 10.0, None, {}, []),
        ("kubelet.sync", "kubelet", 12.5, 12.6, 5, {}, []),
    ],
    "unattributed-gaps": [
        ("batch.cycle", "scheduler", 0.0, 0.3, None, {}, []),
        ("batch.kernel", "scheduler", 0.05, 0.1, 0, {}, []),
        ("batch.cycle", "scheduler", 1.0, 1.5, None, {}, []),
        ("apiserver.request", "apiserver", 0.4, 0.8, None, {}, []),
        ("decode_overlap", "pipeline", 1.2, 1.3, 2, {}, []),
    ],
}


def build(p, case, capacity=None):
    tr = p.tracing
    col = tr.TraceCollector() if capacity is None else tr.TraceCollector(capacity=capacity)
    made = []
    for name, comp, t0, t1, parent, attrs, events in SPAN_CASES[case]:
        par = made[parent] if parent is not None else None
        sp = tr.Span(name, component=comp, trace_id=par.trace_id if par else "",
                     parent_id=par.span_id if par else "", start=t0, attributes=dict(attrs) or None)
        for ts, en, ea in events:
            sp.events.append((ts, en, dict(ea)))
        sp.finish(t1)
        col.add(sp)
        made.append(sp)
    return col


def masked(obj, ids=None):
    """`obj` with every span / trace id replaced by its first-seen index."""
    ids = {} if ids is None else ids
    text = json.dumps(obj, sort_keys=True) if not isinstance(obj, str) else obj
    return re.sub(r"\b[0-9a-f]{16}\b", lambda m: f"id{ids.setdefault(m.group(0), len(ids))}", text)


@pytest.mark.parametrize("case", sorted(SPAN_CASES))
def test_same_spans_same_chrome_trace_and_tree(case):
    cols = {name: build(pkg(name), case) for name in PACKAGES}
    assert masked(cols["port"].chrome_trace()) == masked(cols["jax"].chrome_trace())
    assert masked(cols["port"].tree_text()) == masked(cols["jax"].tree_text())
    assert [s.duration_s for s in cols["port"].spans()] == [s.duration_s for s in cols["jax"].spans()]


@pytest.mark.parametrize("case", sorted(SPAN_CASES))
def test_same_spans_same_attribution(case):
    reps = {}
    for name in PACKAGES:
        p = pkg(name)
        col = build(p, case)
        rep = p.attribution.attribute_spans(col)
        reps[name] = (rep, p.attribution.render_attribution(rep))
    assert reps["port"][0] == reps["jax"][0]
    assert reps["port"][1] == reps["jax"][1]
    assert sum(d["fraction"] for d in reps["port"][0]["phases"].values()) == pytest.approx(1.0, abs=0.01)


def test_dropped_spans_flag_the_export_and_the_report():
    """The ring wraps: the export's otherData and the report say so (JAX
    tests/test_observability.py:440), in both packages alike."""
    out = {}
    for name in PACKAGES:
        p = pkg(name)
        col = p.tracing.TraceCollector(capacity=4)
        tr = p.tracing.Tracer(col, component="t")
        for i in range(10):
            with tr.span(f"s{i}"):
                pass
        doc = col.chrome_trace()
        rep = p.attribution.attribute_spans(col)
        out[name] = (col.spans_dropped, doc["otherData"], rep["complete"])
        col.clear()
        assert col.spans_dropped == 0 and col.spans() == [] and col.traces() == {}
    assert out["port"] == out["jax"] == (6, {"spans_dropped": 6, "spans_exported": 4, "capacity": 4}, False)


def test_span_events_and_duration():
    for name in PACKAGES:
        tr = pkg(name).tracing
        sp = tr.Span("x", start=1.0)
        sp.add_event("mark", k=1)
        assert sp.events[0][1:] == ("mark", {"k": 1})
        sp.finish(3.5)
        assert sp.duration_s == 2.5


def _traced_cluster(name: str, mode: str):
    """The JAX tests/test_tracing.py:28 cluster (store + apiserver +
    Scheduler + one kubelet on one collector) in package `name`, web-0
    scheduled and synced."""
    from torch_scheduler_sides import Side

    side = Side(name)
    root = PACKAGES[name]
    S = side.S
    apisrv = importlib.import_module(f"{root}.scheduler.apiserver")
    kubelet = importlib.import_module(f"{root}.scheduler.kubelet")
    leases = importlib.import_module(f"{root}.scheduler.leases")
    klog = importlib.import_module(f"{root}.scheduler.klog")
    tr = importlib.import_module(f"{root}.scheduler.tracing")
    col = tr.TraceCollector()
    clock = side.FakeClock()
    store = S.ClusterStore()
    store.add_node(side.conv(mk_node("n0", cpu=4000)))
    sched = side.scheduler(store, side.cfg(mode), logger=klog.Logger(verbosity=4), collector=col)
    api = apisrv.APIServer(store, tracer=tr.Tracer(col, component="apiserver"))
    api.authn.add_token("admin", "admin", groups=("system:masters",))
    kl = kubelet.HollowKubelet(store, leases.LeaseStore(clock=clock), "n0", clock=clock,
                               tracer=tr.Tracer(col, component="kubelet"))
    api.handle("admin", "create", "Pod", obj=side.conv(mk_pod("web-0", cpu=1000)))
    sched.run_until_idle()
    kl.tick()
    return store, col


def _shape(col):
    """The export with its clock-valued fields masked: names, components,
    pids, tids, parentage, attributes."""
    doc = json.loads(masked(col.chrome_trace()))
    for e in doc["traceEvents"]:
        for k in ("ts", "dur"):
            e.pop(k, None)
    tree = re.sub(r"\d+\.\d{3}ms", "Tms", masked(col.tree_text()))
    return doc["traceEvents"], tree


@pytest.mark.parametrize("mode", ["cpu", "tpu"])
def test_traced_cluster_exports_the_jax_trees(mode):
    """JAX tests/test_tracing.py:105 (the Perfetto export's contract) and the
    same tree in both packages, one connected pod trace across the
    apiserver, queue, scheduler and kubelet."""
    (pstore, pcol), (jstore, jcol) = (_traced_cluster(n, mode) for n in ("port", "jax"))
    assert pstore.pods["default/web-0"].node_name == jstore.pods["default/web-0"].node_name == "n0"
    pev, ptree = _shape(pcol)
    jev, jtree = _shape(jcol)
    key = lambda e: (e.get("name"), e.get("ph"), e.get("pid"), json.dumps(e.get("args", {}), sort_keys=True))
    assert sorted(map(key, pev)) == sorted(map(key, jev))
    assert sorted(ptree.splitlines()) == sorted(jtree.splitlines())
    # the export's field contract (JAX test_chrome_trace_export_roundtrips)
    data = json.loads(json.dumps(pcol.chrome_trace()))
    complete = [e for e in data["traceEvents"] if e["ph"] == "X"]
    spans = [s for s in pcol.spans() if s.end is not None]
    assert len(complete) == len(spans)
    pid_names = {e["pid"]: e["args"]["name"] for e in data["traceEvents"] if e["ph"] == "M"}
    by_id = {s.span_id: s for s in spans}
    for e in complete:
        s = by_id[e["args"]["span_id"]]
        assert pid_names[e["pid"]] == s.component and e["ts"] >= 0 and e["dur"] >= 0
        assert e["dur"] == pytest.approx(s.duration_s * 1e6, abs=0.5)
    ctx = pcol.pod_context("default/web-0")
    assert len({e["tid"] for e in complete if e["args"]["trace_id"] == ctx.trace_id}) == 1


def test_scheduler_cycle_attribution_anchors_on_batch_cycle():
    """JAX tests/test_observability.py:430 on the port's Scheduler."""
    from torch_scheduler_sides import Side

    side = Side("port")
    col = tracing.TraceCollector()
    store, sched = side.cluster("tpu", nodes=[mk_node(f"n{i}", cpu=4000) for i in range(4)], collector=col)
    for i in range(40):
        store.add_pod(mk_pod(f"p{i}", cpu=50))
    sched.run_until_idle()
    rep = attribution.attribute_spans(col)
    assert rep["n_cycles"] >= 1 and rep["cycles"][0]["anchor"] == "batch.cycle"
    ph = {p: d["seconds"] for p, d in rep["phases"].items()}
    assert ph["device_kernel"] > 0 and (ph["host_encode"] > 0 or ph["bind_commit"] > 0)
    assert ph["hoist_update"] > 0  # the HoistCache's hoist.update span
    assert sum(d["fraction"] for d in rep["phases"].values()) == pytest.approx(1.0, abs=0.01)


# ---------------------------------------------------------------------------
# the measured table
# ---------------------------------------------------------------------------

def test_subphase_vocabulary_is_the_jax_one():
    from kubernetes_tpu.ops import scopes as jscopes

    assert scopes.SUBPHASES == jscopes.SUBPHASES
    with pytest.raises(ValueError):
        scopes.subphase("not_a_phase")
    for path in ("jit(f)/jit(main)/round_loop/repair/mul", "jit(f)/hoist/dot_general", "a/transpose/b", "",
                 "hoist/commit_batch"):
        assert scopes.subphase_of(path) == jscopes.subphase_of(path)


def _jax_fixture(tmp_path):
    import test_costmodel as jc
    from kubernetes_tpu.bench.profiling import parse_hlo_dumps

    hlo_dir, events = jc._fake_profile(tmp_path)
    return events, parse_hlo_dumps(hlo_dir)


def test_subphase_table_equals_jax_on_the_fixture(tmp_path):
    from kubernetes_tpu.bench import profiling as jprof

    events, op_map = _jax_fixture(tmp_path)
    want = jprof.subphase_table(events, op_map)
    got = profiling.subphase_table(events, op_map)
    assert got == want
    assert profiling.render_subphases(got) == jprof.render_subphases(want)
    assert profiling.subphase_table([], op_map)["incomplete"]


def test_merge_profile_spans_equals_jax(tmp_path):
    from kubernetes_tpu.bench import profiling as jprof

    events, op_map = _jax_fixture(tmp_path)
    out = {}
    for name, prof in (("port", profiling), ("jax", jprof)):
        tr = pkg(name).tracing
        col = tr.TraceCollector()
        anchor = tr.Span("device.step", component="pipeline", start=100.0)
        anchor.finish(101.0)
        col.add(anchor)
        n = prof.merge_profile_spans(col, [dict(e) for e in events], op_map)
        kids = sorted((s.name, s.start, s.end, s.parent_id == anchor.span_id, tuple(sorted(s.attributes.items())))
                      for s in col.spans() if s is not anchor)
        out[name] = (n, kids)
    assert out["port"] == out["jax"] and out["port"][0] == 3


def test_attribution_nests_device_subphases_as_jax():
    table = {"subphases": {"repair": {"seconds": 0.9, "fraction": 0.9}, "hoist": {"seconds": 0.1, "fraction": 0.1}},
             "round_loop_fraction": 0.9, "dominant": "round_loop", "n_ops": 2, "kernel_modules": ["jit_kernel"],
             "total_s": 1.0, "incomplete": False}
    texts = []
    for name in ("port", "jax"):
        p = pkg(name)
        sp = p.tracing.Span("device.step", start=0.0)
        sp.finish(1.0)
        rep = p.attribution.attribute_spans([sp], spans_dropped=0, device_subphases=table)
        texts.append(p.attribution.render_attribution(rep))
    assert texts[0] == texts[1] and "  . repair" in texts[0]


# ---------------------------------------------------------------------------
# device_trace of the plain warm loop, and KTPU_NAMED_SCOPES
# ---------------------------------------------------------------------------

def _warm_loop(tracer=None, memwatch=None):
    snap = workloads.heterogeneous(60, 256, seed=3)
    enc = DeltaEncoder("cpu")
    arr, meta = enc.encode_device(snap)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    choices, _ = assign.schedule_batch(arr, cfg, device="cpu", chunked=True)
    loop = PipelinedBatchLoop(encoder=enc, depth=1, device="cpu", tracer=tracer, memwatch=memwatch)
    assign.reset_trace_counts()
    first = workloads.verdicts_of(choices.numpy(), meta)
    return loop, lambda: workloads.warm_waves(snap, first, loop.submit, loop.drain, Snapshot, last=4)


@pytest.fixture(scope="module")
def traced_warm_loop(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("device_trace"))
    col = tracing.TraceCollector()
    loop, run = _warm_loop(tracing.Tracer(col, component="pipeline"))
    with tracing.device_trace(d):
        waves, fetched, _, _ = run()
    return d, col, loop, fetched


def test_device_trace_of_the_plain_warm_loop_loads_back(traced_warm_loop):
    d, col, loop, fetched = traced_warm_loop
    events = profiling.load_profile_events(d)
    assert events and all(e["module"] == "cpu" for e in events)
    table = profiling.subphase_table(events)
    assert not table["incomplete"]
    assert {"hoist", "commit_batch", "round_loop"} <= set(table["subphases"])
    assert sum(d_["fraction"] for d_ in table["subphases"].values()) == pytest.approx(1.0, abs=0.01)
    assert {s.name for s in col.spans()} >= {"hoist.update", "device.step", "encode_overlap"}
    # the merged export nests the profiled ops under the loop's steps
    assert profiling.merge_profile_spans(col, events, max_spans=64) == 64


def test_every_op_inside_a_declared_scope_maps_to_it(traced_warm_loop):
    d = traced_warm_loop[0]
    events = profiling.load_profile_events(d)
    ranges = profiling.scope_ranges(d)
    assert {r["name"] for r in ranges} >= {"hoist", "commit_batch", "round_loop"}
    by_tid = {}
    for r in ranges:
        by_tid.setdefault(r["tid"], []).append(r)
    inside = 0
    for e in events:
        t0, t1 = e["ts_us"], e["ts_us"] + e["dur_us"]
        enc = [r for r in by_tid.get(e["tid"], []) if r["ts_us"] <= t0 and t1 <= r["ts_us"] + r["dur_us"]]
        owner = max(enc, key=lambda r: r["ts_us"])["name"] if enc else ""
        assert scopes.subphase_of(e["path"]) == owner, (e, owner)
        inside += bool(owner)
    assert inside > 0


def test_named_scopes_off_changes_no_decision(monkeypatch):
    """KTPU_NAMED_SCOPES=0 against the default on the warm loop and the
    per-pod, rounds and dense routes: the same choices, usage, ordinals,
    sweeps and routes; with scopes off no declared range is recorded."""
    outs = {}
    for flag in ("1", "0"):
        monkeypatch.setenv("KTPU_NAMED_SCOPES", flag)
        loop, run = _warm_loop()
        _, fetched, _, _ = run()
        routes = dict(assign.TRACE_COUNTS)
        res = {"warm": fetched, "routes": routes, "actions": [h["action"] for h in loop.hoist.history]}
        for name, snap in (("rounds", workloads.all_stages(24, 128)), ("dense", workloads.heterogeneous(30, 256))):
            arr, _ = DeltaEncoder("cpu").encode_device(snap)
            cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
            res[name] = [x.tolist() if isinstance(x, torch.Tensor) else x
                         for x in assign.schedule_batch_ordinals(arr, cfg, device="cpu", chunked=True)]
            res[name + "-perpod"] = [x.tolist() for x in assign.schedule_batch(arr, cfg, device="cpu", chunked=False)]
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            arr, _ = DeltaEncoder("cpu").encode_device(workloads.heterogeneous(30, 256))
            assign.schedule_batch(arr, infer_score_config(arr, DEFAULT_SCORE_CONFIG), device="cpu", chunked=True)
        res["ranges"] = sorted({e.name for e in prof.events() if e.name in scopes.SUBPHASES})
        outs[flag] = res
    assert outs["1"]["ranges"] and outs["0"]["ranges"] == []
    for k in outs["1"]:
        if k != "ranges":
            assert outs["1"][k] == outs["0"][k], k
