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
note_nomination_cleared and the nomination; `nominated` lists (pending
pod name, node) nominations carried from an earlier cycle.  Its dict has the same keys as
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
    the port's types: the port's fields, the same values."""
    from kubernetes_tpu_torch.api import snapshot as tsnap
    from kubernetes_tpu_torch.api import types as tt

    if isinstance(obj, (list, tuple)):
        return type(obj)(to_port(x) for x in obj)
    if isinstance(obj, dict):
        return {k: to_port(x) for k, x in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = getattr(tt, type(obj).__name__, None) or getattr(tsnap, type(obj).__name__)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{f.name: to_port(getattr(obj, f.name)) for f in dataclasses.fields(obj) if f.name in names})
    return obj


def jax_snapshot(n_nodes: int, n_pre: int):
    from kubernetes_tpu.api.snapshot import Snapshot
    from kubernetes_tpu.bench.preempt_bench import build

    store = build(n_nodes, n_pre)
    pods = list(store.pods.values())
    return Snapshot(nodes=list(store.nodes.values()), pending_pods=[p for p in pods if not p.node_name],
                    bound_pods=[p for p in pods if p.node_name])


def run_loop(batched, queue, failed, bound_prios):
    """The batched branch of the JAX scheduler's failure loop
    (scheduler.py:1569-1690) over `failed` -> decisions."""
    min_bound = min(bound_prios) if bound_prios else None
    if min_bound is not None:
        batched.prefetch([q for q in failed if q.priority > min_bound])
    decisions = []
    for pod in failed:
        if min_bound is None or pod.priority <= min_bound:
            batched.note_nomination_cleared(pod)
            queue.nominated.pop(pod.uid, None)
            continue
        assert batched.applicable(pod), pod.name
        res = batched.evaluate(pod)
        if res is None:
            batched.note_nomination_cleared(pod)
            queue.nominated.pop(pod.uid, None)
            continue
        node_name, victims = res
        for q in victims:
            bound_prios[q.priority] -= 1
            if bound_prios[q.priority] <= 0:
                del bound_prios[q.priority]
        min_bound = min(bound_prios) if bound_prios else None
        batched.apply_eviction(node_name, victims)
        batched.note_nomination_cleared(pod)
        queue.nominated[pod.uid] = (pod, node_name)
        decisions.append((pod.name, node_name, [q.name for q in victims]))
    return decisions


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
    store, queue = PdbStore(pdbs), NominationQueue()
    by_name = {p.name: p for p in snap.pending_pods}
    for name, node in nominated:
        queue.nominated[by_name[name].uid] = (by_name[name], node)
    batched = BatchedPreemption(arr, meta, Snapshot(nodes=snap.nodes, bound_pods=bound), store, queue)
    failed = [pods[k] for k in rows]
    decisions = run_loop(batched, queue, failed, Counter(q.priority for q in bound))
    return {
        "failed": [p.name for p in failed],
        "messages": {pods[r].name: m for r, m in messages.items()},
        "dominant": {pods[r].name: d for r, d in dominant.items()},
        "records": records,
        "decisions": decisions,
        "nominated": {uid: node for uid, (_, node) in queue.nominated.items()},
        "wave_hits": batched.wave_hits,
        "single_hits": batched.single_hits,
    }
