"""The JAX package's side of the failure path, for the port's preemption tests
and the digest legs.

``jax_snapshot(n_nodes, n_pre)`` is the JAX package's
bench/preempt_bench.py build(n_nodes, n_pre) store as a JAX Snapshot (nodes,
bound fillers and pending preemptors in the store's insertion order, as the
port's build lists them).  ``jax_failure_cycle(snap)`` runs the sequence of
kubernetes_tpu_torch/bench/preempt_bench.py's failure_cycle with the JAX
package's modules: DeltaEncoder, schedule_batch, diagnose_failed at
post-cycle usage, BatchedPreemption with a store stub and a queue stub,
prefetch, then per failed pod in row order evaluate, apply_eviction,
note_nomination_cleared and the nomination, or for a pod outside the
batched gate the JAX CPU PostFilter (DefaultPreemption) and a fresh
BatchedPreemption after its eviction; `nominated` lists (pending pod name,
node) nominations carried from an earlier cycle.  Its dict has the same keys as
the port's (failed, messages, dominant, decisions, nominated, wave_hits,
single_hits).  ``to_port`` rebuilds JAX-typed objects (nodes, pods, PDBs,
snapshots) as the port's types, field for field.  The store and queue
stubs are the port's (plain holders of ``pdbs`` and ``nominated``).
"""

import dataclasses
from collections import Counter

import numpy as np


def to_port(obj):
    """A JAX-typed Node / Pod / PDB / Snapshot (or a container of them) as
    the port's types (the port's convert.from_jax_objects)."""
    from kubernetes_tpu_torch.convert import from_jax_objects

    return from_jax_objects(obj)


def jax_snapshot(n_nodes: int, n_pre: int):
    from kubernetes_tpu.api.snapshot import Snapshot
    from kubernetes_tpu.bench.preempt_bench import build

    store = build(n_nodes, n_pre)
    pods = list(store.pods.values())
    return Snapshot(nodes=list(store.nodes.values()), pending_pods=[p for p in pods if not p.node_name],
                    bound_pods=[p for p in pods if p.node_name])


def jax_cpu_postfilter(store, queue):
    """The JAX package's CPU PostFilter (its plugins/cpu.py DefaultPreemption
    in a default-plugins Framework) over the port's store and queue stubs ->
    (snap, pod) -> (node or None, victim names): the JAX scheduler's CPU
    branch of the failure loop (scheduler.py:1685-1714)."""
    from kubernetes_tpu.api.volumes import resolve_snapshot
    from kubernetes_tpu.scheduler.cache import SchedulerCache
    from kubernetes_tpu.scheduler.framework import CycleState, Framework
    from kubernetes_tpu.scheduler.plugins.cpu import default_plugins
    from kubernetes_tpu.scheduler.state import ScaledState

    fw = Framework(default_plugins(store, filter_fn=lambda st, sn, p, info: fw.run_filters(st, sn, p, info),
                                   nominated_fn=queue.nominated_pods_for_node))

    def run(snap, pod):
        snap = resolve_snapshot(snap)
        state = CycleState()
        state.data["scaled"] = ScaledState(snap, SchedulerCache.node_infos(None, snap))
        before = dict(store.pods)
        node, st = fw.run_post_filters(state, snap, pod, {})
        if not (st.ok and node):
            return None, []
        return node, [q.name for uid, q in before.items() if uid not in store.pods]

    return run


def run_loop(make_batched, store, queue, failed, nodes):
    """The JAX scheduler's failure loop (scheduler.py:1569-1714) over
    `failed` -> (decisions, wave_hits, single_hits): the batched branch for
    pods inside the gate, the CPU PostFilter for the rest, and after a CPU
    eviction a fresh BatchedPreemption (`make_batched(bound snapshot)`)."""
    from kubernetes_tpu.api.snapshot import Snapshot

    cpu = jax_cpu_postfilter(store, queue)
    decisions = []
    hits = [0, 0]
    batched = None
    for i, pod in enumerate(failed):
        if batched is None:
            bound = Snapshot(nodes=nodes, bound_pods=list(store.pods.values()))
            batched = make_batched(bound)
            bound_prios = Counter(q.priority for q in bound.bound_pods)
            min_bound = min(bound_prios) if bound_prios else None
            if min_bound is not None:
                batched.prefetch([q for q in failed[i:] if q.priority > min_bound])
        if min_bound is None or pod.priority <= min_bound:
            batched.note_nomination_cleared(pod)
            queue.nominated.pop(pod.uid, None)
            continue
        if not batched.applicable(pod):
            node_name, victims = cpu(Snapshot(nodes=nodes, bound_pods=list(store.pods.values())), pod)
            if node_name is None:
                batched.note_nomination_cleared(pod)
                queue.nominated.pop(pod.uid, None)
                continue
            queue.nominated[pod.uid] = (pod, node_name)
            decisions.append((pod.name, node_name, victims))
            hits = [hits[0] + batched.wave_hits, hits[1] + batched.single_hits]
            batched = None
            continue
        res = batched.evaluate(pod)
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
        batched.note_nomination_cleared(pod)
        queue.nominated[pod.uid] = (pod, node_name)
        decisions.append((pod.name, node_name, [q.name for q in victims]))
    if batched is not None:
        hits = [hits[0] + batched.wave_hits, hits[1] + batched.single_hits]
    return decisions, hits[0], hits[1]


def jax_failure_cycle(snap, pdbs=(), nominated=()):
    from kubernetes_tpu.api.delta import DeltaEncoder
    from kubernetes_tpu.api.snapshot import Snapshot
    from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG, infer_score_config, schedule_batch
    from kubernetes_tpu.ops.explain import diagnose_failed
    from kubernetes_tpu.scheduler.preemption import BatchedPreemption
    from kubernetes_tpu_torch.bench.preempt_bench import NominationQueue, PdbStore

    arr, meta = DeltaEncoder().encode(snap)
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    choices, _ = schedule_batch(arr, cfg)
    c = np.asarray(choices)
    n = meta.n_pods
    pods = [snap.pending_pods[int(meta.pod_perm[k])] for k in range(n)]
    rows = [k for k in range(n) if c[k] < 0]
    placed = [k for k in range(n) if c[k] >= 0]
    used = np.array(arr.node_used, copy=True)
    if placed:
        np.add.at(used, c[placed], np.asarray(arr.pod_req)[placed])
    messages, dominant, records = diagnose_failed(arr, meta, rows, used)
    bound = list(snap.bound_pods) + [
        dataclasses.replace(pods[k], node_name=meta.node_names[int(c[k])]) for k in placed
    ]
    store, queue = PdbStore(pdbs, bound), NominationQueue()
    by_name = {p.name: p for p in snap.pending_pods}
    for name, node in nominated:
        queue.nominated[by_name[name].uid] = (by_name[name], node)
    failed = [pods[k] for k in rows]
    decisions, wave_hits, single_hits = run_loop(lambda b: BatchedPreemption(arr, meta, b, store, queue), store,
                                                 queue, failed, snap.nodes)
    return {
        "failed": [p.name for p in failed],
        "messages": {pods[r].name: m for r, m in messages.items()},
        "dominant": {pods[r].name: d for r, d in dominant.items()},
        "records": records,
        "decisions": decisions,
        "nominated": {uid: node for uid, (_, node) in queue.nominated.items()},
        "wave_hits": wave_hits,
        "single_hits": single_hits,
    }
