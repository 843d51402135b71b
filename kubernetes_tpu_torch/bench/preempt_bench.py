"""The failure half of one scheduling cycle at the JAX package's preemption
benchmark size (its bench/preempt_bench.py: "~1k failed pods x 20k nodes").

``build(n_nodes, n_pre)`` is the JAX ``build``'s cluster as a Snapshot: every
node full with two 2000m priority-0 fillers (bound pods), and ``n_pre``
pending 2000m priority-100 preemptors that can only schedule by evicting.
``build(20000, 1000)`` is 20000 nodes, 40000 bound pods, 1000 preemptors.

``failure_cycle(snap, device)`` runs what the JAX scheduler runs after the
batch step (its scheduler.py:1443 _diagnose_failed, then the batched branch
of its failure loop, :1569-1690):

1. encode with DeltaEncoder;
2. the batch step on the device's default route (on the card the dense
   chunked route, K7 + K8);
3. the failed rows in device row order (activeQ order);
4. diagnose_failed at post-cycle usage (cycle-start node_used plus the
   requests of the pods this cycle placed): K14 on the card;
5. BatchedPreemption over the post-bind snapshot, a store stub (``pdbs``
   and the bound pods) and a queue stub (``nominated``), then prefetch of
   the failed pods whose priority is above the lowest bound priority;
6. per failed pod in order: inside BatchedPreemption's gate, evaluate
   (waves of K15 on the card), the evictions, apply_eviction,
   note_nomination_cleared, the nomination; outside it (pairwise terms,
   host ports, claims), the CPU PostFilter (scheduler/plugins/cpu.py —
   DefaultPreemption) over a what-if state of the current bound pods, and
   after a CPU eviction a fresh BatchedPreemption for the rest, as the
   scheduler's failure loop does.

    python -m kubernetes_tpu_torch.bench.preempt_bench [n_nodes] [n_preemptors]

runs it on the card and prints one JSON line (counts, the decisions digest,
the time split).  ``WaveProbe`` records each device evaluation of a run
from outside BatchedPreemption, for that split and for checks.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import sys
import time
from collections import Counter
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..api import types as t
from ..api.delta import DeltaEncoder
from ..api.snapshot import Snapshot
from ..device import resolve_device
from ..ops import DEFAULT_SCORE_CONFIG, infer_score_config, schedule_batch
from ..ops import kernels
from ..ops import preempt as ops_preempt
from ..ops.explain import diagnose_failed
from ..scheduler.preemption import BatchedPreemption


def build(n_nodes: int, n_pre: int) -> Snapshot:
    nodes = [
        t.Node(name=f"node-{i}", allocatable={t.CPU: 4000, t.MEMORY: 16 << 30, t.PODS: 16},
               labels={t.LABEL_ZONE: f"zone-{i % 9}"})
        for i in range(n_nodes)
    ]
    # two 2000m low-priority pods per node: a 2000m preemptor schedules by
    # evicting exactly one of them
    fillers = [
        t.Pod(name=f"low-{i}-{j}", requests={t.CPU: 2000, t.MEMORY: 4 << 30}, priority=0,
              node_name=f"node-{i}", labels={"app": "filler"})
        for i in range(n_nodes) for j in range(2)
    ]
    pre = [
        t.Pod(name=f"hi-{k}", requests={t.CPU: 2000, t.MEMORY: 2 << 30}, priority=100, labels={"app": "hi"})
        for k in range(n_pre)
    ]
    return Snapshot(nodes=nodes, pending_pods=pre, bound_pods=fillers)


class PdbStore:
    """The store as the failure loop reads it: ``pdbs`` (key -> PDB) and
    the bound ``pods`` (uid -> pod), which ``delete_pod`` evicts from."""

    def __init__(self, pdbs=(), pods=()):
        self.pdbs = {p.key: p for p in pdbs}
        self.pods: Dict[str, t.Pod] = {p.uid: p for p in pods}

    def delete_pod(self, uid: str) -> None:
        self.pods.pop(uid, None)


class NominationQueue:
    """The queue as the failure loop reads it: ``nominated`` (uid -> (pod,
    node name))."""

    def __init__(self):
        self.nominated: Dict[str, Tuple[t.Pod, str]] = {}

    def nominated_pods_for_node(self, node_name: str) -> List[t.Pod]:
        return [p for p, n in self.nominated.values() if n == node_name]


def cpu_postfilter(store, queue):
    """The CPU PostFilter of the default profile over `store` and `queue`:
    a Framework of default_plugins whose DefaultPreemption filters through
    the same framework -> a callable (snap, pod) -> (node or None, victim
    names), snap being the resolved snapshot of the current bound pods."""
    from ..api.volumes import resolve_snapshot
    from ..scheduler.cache import node_infos
    from ..scheduler.framework import CycleState, Framework
    from ..scheduler.plugins.cpu import default_plugins
    from ..scheduler.state import ScaledState

    fw = Framework(default_plugins(store, filter_fn=lambda st, sn, p, info: fw.run_filters(st, sn, p, info),
                                   nominated_fn=queue.nominated_pods_for_node))

    def run(snap, pod):
        snap = resolve_snapshot(snap)
        state = CycleState()
        state.data["scaled"] = ScaledState(snap, node_infos(snap))
        before = dict(store.pods)
        node, st = fw.run_post_filters(state, snap, pod, {})
        if not (st.ok and node):
            return None, []
        return node, [q.name for uid, q in before.items() if uid not in store.pods]

    return run


def decisions_digest(decisions) -> str:
    """sha256 of the [preemptor, node, sorted victims] list as compact JSON."""
    rows = [[p, n, sorted(v)] for p, n, v in decisions]
    return hashlib.sha256(json.dumps(rows, separators=(",", ":")).encode()).hexdigest()


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class WaveProbe:
    """While active, records every device evaluation BatchedPreemption
    makes (a wave, or a single preemptor as a wave of one): it wraps
    ``ops.preempt.preempt_eval_wave`` and ``to_host``, which the class looks
    up at call time, ``kernels.preempt_eval`` and
    ``BatchedPreemption._build_wave``.  Each record in ``calls`` holds the
    preemptors ``k`` and the padded ``kp``, the host seconds of the launch
    (``launch_s``), of the read back, which waits for the card (``read_s``),
    and, for a wave, of its whole build (``build_s``: the victim tables, the
    usage and nominated arrays, launch and read); on the card ``kernel_ms``,
    K15's milliseconds by CUDA events.  With ``keep`` a record also holds
    the call's arrays and copies of its other inputs (``inputs``; the victim
    tables change in place after a wave) and its host outputs
    (``outputs``), to hold them against the plain version after the run."""

    def __init__(self, keep: bool = False):
        self.keep = keep
        self.calls: List[dict] = []
        self._saved = []

    def __enter__(self) -> "WaveProbe":
        wave, host, k15 = ops_preempt.preempt_eval_wave, ops_preempt.to_host, kernels.preempt_eval
        build = BatchedPreemption._build_wave
        calls, keep = self.calls, self.keep

        def probe_wave(arr, pod_idxs, *ins):
            idxs = np.asarray(pod_idxs)
            rec = {"k": int(idxs.size - np.count_nonzero(idxs[1:] == idxs[0])), "kp": int(idxs.size),
                   "kernel_ms": None, "build_s": None}
            if keep:
                rec["inputs"] = (arr, idxs.copy(), *(np.array(x, copy=True) for x in ins))
            calls.append(rec)
            t0 = time.perf_counter()
            out = wave(arr, pod_idxs, *ins)
            rec["launch_s"] = time.perf_counter() - t0
            return out

        def probe_host(out):
            t0 = time.perf_counter()
            res = host(out)
            calls[-1]["read_s"] = time.perf_counter() - t0
            if keep:
                calls[-1]["outputs"] = res
            return res

        def probe_k15(*args):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            with torch.cuda.device(args[0].device):
                ev[0].record()
                out = k15(*args)
                ev[1].record()
            calls[-1]["kernel_events"] = ev
            return out

        def probe_build(bp, first):
            t0 = time.perf_counter()
            build(bp, first)
            calls[-1]["build_s"] = time.perf_counter() - t0

        self._saved = [(ops_preempt, "preempt_eval_wave", wave), (ops_preempt, "to_host", host),
                       (kernels, "preempt_eval", k15), (BatchedPreemption, "_build_wave", build)]
        ops_preempt.preempt_eval_wave, ops_preempt.to_host = probe_wave, probe_host
        kernels.preempt_eval, BatchedPreemption._build_wave = probe_k15, probe_build
        return self

    def __exit__(self, *exc) -> None:
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)
        for rec in self.calls:
            ev = rec.pop("kernel_events", None)
            if ev is not None:
                ev[1].synchronize()
                rec["kernel_ms"] = ev[0].elapsed_time(ev[1])


def failure_cycle(snap: Snapshot, device=None, pdbs=(), nominated=()) -> dict:
    """Steps 1-6 of the module docstring -> {"failed": the failed pods'
    names in row order, "messages" / "dominant": name -> diagnosis message /
    dominant reason, "records": the per-class diagnosis records,
    "decisions": [(preemptor, node, victim names)] in evaluation order,
    "nominated": uid -> node, "outside_gate": the preemptors that
    BatchedPreemption's gate refused, which the CPU PostFilter served, in
    order, "wave_hits", "single_hits" (summed over the
    BatchedPreemption instances of the loop), "times": host seconds of each
    step, with the failure loop's split into evaluate, apply_eviction and
    the CPU PostFilter}.  `pdbs` go to the store stub; `nominated` lists
    (pending pod name, node) nominations carried from an earlier cycle into
    the queue stub."""
    dev = resolve_device(device)
    times: Dict[str, float] = {}
    t0 = time.perf_counter()
    arr, meta = DeltaEncoder(dev).encode_device(snap)
    _sync(dev)
    t1 = time.perf_counter()
    times["encode_s"] = t1 - t0
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    choices, _ = schedule_batch(arr, cfg, dev)
    c = choices.cpu().numpy()
    t2 = time.perf_counter()
    times["step_s"] = t2 - t1

    n = meta.n_pods
    pods = [snap.pending_pods[int(meta.pod_perm[k])] for k in range(n)]
    rows = [k for k in range(n) if c[k] < 0]
    placed = [k for k in range(n) if c[k] >= 0]
    # post-cycle usage: cycle-start usage plus this cycle's placements
    used = arr.node_used.cpu().numpy().copy()
    if placed:
        req = arr.pod_req.cpu().numpy()
        np.add.at(used, c[placed], req[placed])
    messages, dominant, records = diagnose_failed(arr, meta, rows, used)
    t3 = time.perf_counter()
    times["explain_s"] = t3 - t2

    bound = list(snap.bound_pods) + [
        dataclasses.replace(pods[k], node_name=meta.node_names[int(c[k])]) for k in placed
    ]
    store, queue = PdbStore(pdbs, bound), NominationQueue()
    by_name = {p.name: p for p in snap.pending_pods}
    for name, node in nominated:
        queue.nominated[by_name[name].uid] = (by_name[name], node)
    failed = [pods[k] for k in rows]
    cpu = None  # the CPU PostFilter, built when a pod first falls outside the gate
    wave_hits = single_hits = 0

    def rebuild(suffix):
        """The bound view, its priorities and a BatchedPreemption over it,
        prefetching the preemptors of `suffix`."""
        bp = BatchedPreemption(arr, meta, Snapshot(nodes=snap.nodes, bound_pods=list(store.pods.values())),
                               store, queue)
        prios = Counter(q.priority for q in store.pods.values())
        low = min(prios) if prios else None
        if low is not None:
            bp.prefetch([q for q in suffix if q.priority > low])
        return bp, prios, low

    batched, bound_prios, min_bound = rebuild(failed)
    t4 = time.perf_counter()
    times["setup_s"] = t4 - t3
    decisions: List[Tuple[str, str, List[str]]] = []
    outside_gate: List[str] = []
    evaluate_s = evict_s = cpu_s = 0.0
    for pod_i, pod in enumerate(failed):
        if batched is None:
            # the scheduler's failure loop after a CPU-path eviction: the
            # bound view and BatchedPreemption are rebuilt for the rest
            batched, bound_prios, min_bound = rebuild(failed[pod_i:])
        if min_bound is None or pod.priority <= min_bound:
            batched.note_nomination_cleared(pod)
            queue.nominated.pop(pod.uid, None)
            continue
        if not batched.applicable(pod):
            outside_gate.append(pod.name)
            e0 = time.perf_counter()
            cpu = cpu or cpu_postfilter(store, queue)
            node_name, victims = cpu(Snapshot(nodes=snap.nodes, bound_pods=list(store.pods.values())), pod)
            cpu_s += time.perf_counter() - e0
            if node_name is None:
                batched.note_nomination_cleared(pod)
                queue.nominated.pop(pod.uid, None)
                continue
            queue.nominated[pod.uid] = (pod, node_name)
            decisions.append((pod.name, node_name, victims))
            # evicted outside BatchedPreemption's ledger: rebuild it
            wave_hits, single_hits = wave_hits + batched.wave_hits, single_hits + batched.single_hits
            batched = None
            continue
        e0 = time.perf_counter()
        res = batched.evaluate(pod)
        e1 = time.perf_counter()
        evaluate_s += e1 - e0
        if res is None:
            batched.note_nomination_cleared(pod)
            queue.nominated.pop(pod.uid, None)
            continue
        node_name, victims = res
        for q in victims:
            store.delete_pod(q.uid)
            bound_prios[q.priority] -= 1
            if bound_prios[q.priority] <= 0:
                del bound_prios[q.priority]
        min_bound = min(bound_prios) if bound_prios else None
        batched.apply_eviction(node_name, victims)
        evict_s += time.perf_counter() - e1
        # a nomination carried from an earlier cycle moves off its old node
        batched.note_nomination_cleared(pod)
        queue.nominated[pod.uid] = (pod, node_name)
        decisions.append((pod.name, node_name, [q.name for q in victims]))
    times.update(loop_s=time.perf_counter() - t4, evaluate_s=evaluate_s, evict_s=evict_s, cpu_postfilter_s=cpu_s)
    return {
        "failed": [p.name for p in failed],
        "messages": {pods[r].name: m for r, m in messages.items()},
        "dominant": {pods[r].name: d for r, d in dominant.items()},
        "records": records,
        "decisions": decisions,
        "nominated": {uid: node for uid, (_, node) in queue.nominated.items()},
        "outside_gate": outside_gate,
        "wave_hits": wave_hits + (batched.wave_hits if batched is not None else 0),
        "single_hits": single_hits + (batched.single_hits if batched is not None else 0),
        "times": times,
    }


def main() -> None:
    n_nodes = int(sys.argv[1]) if len(sys.argv) > 1 else 20_000
    n_pre = int(sys.argv[2]) if len(sys.argv) > 2 else 1_000
    t0 = time.perf_counter()
    snap = build(n_nodes, n_pre)
    setup_s = time.perf_counter() - t0
    with WaveProbe() as probe:
        r = failure_cycle(snap)
    calls = probe.calls
    print(json.dumps({
        "n_nodes": n_nodes, "n_preemptors": n_pre, "device": torch.cuda.get_device_name(0),
        "build_s": setup_s, "failed": len(r["failed"]), "nominated": len(r["nominated"]),
        "victims": sum(len(v) for _, _, v in r["decisions"]), "decisions_sha256": decisions_digest(r["decisions"]),
        "device_evaluations": len(calls), "wave_hits": r["wave_hits"], "single_hits": r["single_hits"],
        "times": r["times"], "wave_build_s": sum(c["build_s"] or 0.0 for c in calls),
        "kernel_ms": [c["kernel_ms"] for c in calls],
    }))


if __name__ == "__main__":
    main()
