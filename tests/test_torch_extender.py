"""The port's HTTP extender client (kubernetes_tpu_torch/scheduler/
extender.py HTTPExtender, post_json) and its place in the Scheduler's
per-pod cycle (Filter, Prioritize, the binder), against the JAX package's,
on the CPU.

- One parity case for every test of the JAX package's
  test_extender_events.py: tests/torch_mirror.py runs the test in both
  packages (each against a toy extender of its own on the loopback) and
  holds the recordings equal, exactly: every store at the end (the
  bindings, the Event objects with their counts) and every request.
- The same objects through both Schedulers (tests/torch_scheduler_sides.py:
  the JAX-built nodes and pods, carried into the port's store by
  convert.from_jax_objects) with one loopback extender that filters,
  prioritizes, binds and answers ProcessPreemption, the requests it saw
  logged per side: bindings, events, queue pools, counters and the
  extender's request log held equal.
"""

import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

from helpers import mk_node, mk_pod
from torch_mirror import cases, run_both
from torch_scheduler_sides import both, observe
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)


@pytest.mark.parametrize("case", cases("test_extender_events"))
def test_port_matches_jax(case, tmp_path):
    want, got = run_both(case, tmp_path)
    assert got == want


class _Extender(BaseHTTPRequestHandler):
    """Bans nodes whose index is divisible by 3, scores a node by its index
    modulo 4, binds (refusing pods named *-refuse), and keeps every
    preemption candidate; logs (verb, pod, nodes) per request."""

    log: list = []

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        verb = self.path.rsplit("/", 1)[-1]
        pod = body.get("pod", {}).get("name") or body.get("podName", "")
        names = body.get("nodenames") or sorted(body.get("nodeNameToVictims") or {})
        _Extender.log.append((verb, pod, tuple(names), body.get("node", "")))
        idx = lambda n: int(n.rsplit("-", 1)[1])  # noqa: E731
        if verb == "filter":
            out = {"nodenames": [n for n in names if idx(n) % 3], "error": "",
                   "failedNodes": {n: "index % 3 == 0" for n in names if not idx(n) % 3}}
        elif verb == "prioritize":
            out = [{"host": n, "score": idx(n) % 4} for n in names]
        elif verb == "bind":
            out = {"error": "refused" if body["podName"].endswith("-refuse") else ""}
        else:
            out = {"nodeNameToMetaVictims": body.get("nodeNameToMetaVictims", {})}
        data = json.dumps(out).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *a):
        pass


@pytest.fixture(scope="module")
def extender_url():
    srv = HTTPServer(("127.0.0.1", 0), _Extender)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_port}"
    srv.shutdown()


@pytest.mark.parametrize("verbs", ["filter", "filter+prioritize", "filter+prioritize+bind", "all+preempt"])
def test_scheduler_with_loopback_extender_matches_jax(extender_url, verbs):
    import importlib

    def case(x):
        ext = importlib.import_module(x.S.__name__ + ".extender")
        kw = {"filter_verb": "filter"}
        if "prioritize" in verbs or verbs.startswith("all"):
            kw["prioritize_verb"] = "prioritize"
        if "bind" in verbs or verbs.startswith("all"):
            kw["bind_verb"] = "bind"
        if "preempt" in verbs:
            kw["preempt_verb"] = "preempt"
        cfg = x.cfg("cpu", extenders=(ext.ExtenderConfig(url_prefix=extender_url, **kw),))
        nodes = [mk_node(f"node-{i}", cpu=2000, pods=4) for i in range(8)]
        store, sched = x.cluster("cpu", nodes=nodes, config=cfg)
        _Extender.log.clear()
        for i in range(14):
            store.add_pod(mk_pod(f"p-{i:02d}" + ("-refuse" if i == 5 else ""), cpu=500, priority=i % 3))
        sched.run_until_idle()
        # a high-priority pod that fits nowhere: the PostFilter's preemption
        # (with the extender's ProcessPreemption when it supports it)
        store.add_pod(mk_pod("urgent", cpu=1500, priority=100))
        sched.run_until_idle()
        return {**observe(store, sched), "extender": list(_Extender.log)}

    want, got = both(case)
    assert got == want
    assert any(n for _, n, _ in want["pods"]) and want["extender"]
    assert not any(n in ("node-0", "node-3", "node-6") for _, n, _ in want["pods"])
