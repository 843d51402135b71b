"""ScaledState — the shared per-cycle view the CPU plugins read.

Bundles what the reference splits between the cache snapshot (NodeInfo list)
and per-plugin PreFilter state: the resource axis, int32-exact rescaled
alloc/used matrices (identical scaling to the encoder and the oracle, so all
three paths agree bit-for-bit), the existing-pod ledger, and a node-selection
cache.  Supports temporary node simulation for preemption's what-if filtering
(framework/preemption/preemption.go — SelectVictimsOnNode's AddPod/RemovePod).

The port's copy of the JAX package's ``scheduler/state.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..api import types as t
from ..api.snapshot import Snapshot, _resource_axis, _scale_for, pod_effective_requests
from .framework import NodeInfo


class ScaledState:
    def __init__(self, snap: Snapshot, infos: List[NodeInfo]):
        self.infos = infos
        self.nodes = [ni.node for ni in infos]
        self.index: Dict[str, int] = {ni.node.name: i for i, ni in enumerate(infos)}
        self.resources = _resource_axis(snap)
        R, N = len(self.resources), len(infos)
        self.score_idx = [self.resources.index(t.CPU), self.resources.index(t.MEMORY)]

        alloc_raw = np.zeros((N, R), dtype=np.int64)
        for i, nd in enumerate(self.nodes):
            for j, r in enumerate(self.resources):
                from ..api.snapshot import _DEFAULT_POD_LIMIT

                alloc_raw[i, j] = nd.allocatable.get(
                    r, _DEFAULT_POD_LIMIT if r == t.PODS else 0
                )
        req_raw = {
            p.uid: np.array(pod_effective_requests(p, self.resources), dtype=np.int64)
            for p in snap.pending_pods
        }
        used_raw = np.zeros((N, R), dtype=np.int64)
        for i, ni in enumerate(infos):
            for q in ni.pods:
                used_raw[i] += np.array(
                    pod_effective_requests(q, self.resources), dtype=np.int64
                )
        self.scale = np.ones(R, dtype=np.int64)
        for j in range(R):
            vals = (
                [int(x) for x in alloc_raw[:, j]]
                + [int(v[j]) for v in req_raw.values()]
                + [int(x) for x in used_raw[:, j]]
            )
            self.scale[j] = _scale_for(vals)
        self.alloc = alloc_raw // self.scale
        self.used = -(-used_raw // self.scale)
        self._req: Dict[str, np.ndarray] = {
            uid: -(-v // self.scale) for uid, v in req_raw.items()
        }
        self.existing: List[Tuple[t.Pod, int]] = [
            (q, i) for i, ni in enumerate(infos) for q in ni.pods
        ]
        self._sel_cache: Dict[str, List[bool]] = {}
        self._sim_stack: Dict[int, Tuple[np.ndarray, List[Tuple[t.Pod, int]], NodeInfo]] = {}

    def req_of(self, pod: t.Pod) -> np.ndarray:
        r = self._req.get(pod.uid)
        if r is None:
            raw = np.array(pod_effective_requests(pod, self.resources), dtype=np.int64)
            r = -(-raw // self.scale)
            self._req[pod.uid] = r
        return r

    def node_ok_sel(self, pod: t.Pod) -> List[bool]:
        from ..oracle.reference import _node_selection_ok

        sel = self._sel_cache.get(pod.uid)
        if sel is None:
            sel = [_node_selection_ok(pod, nd) for nd in self.nodes]
            self._sel_cache[pod.uid] = sel
        return sel

    # --- commit (assume) ---
    def add_pod(self, pod: t.Pod, i: int) -> None:
        self.used[i] += self.req_of(pod)
        self.existing.append((pod, i))
        self.infos[i].add_pod(pod, self.resources)

    def remove_pod(self, pod: t.Pod, i: int) -> None:
        self.used[i] -= self.req_of(pod)
        self.existing = [(q, n) for q, n in self.existing if q.uid != pod.uid]
        self.infos[i].remove_pod(pod, self.resources)

    # --- preemption what-if simulation ---
    def push_sim(self, i: int, sim: NodeInfo) -> None:
        self._sim_stack[i] = (self.used[i].copy(), list(self.existing), self.infos[i])
        self.infos[i] = sim
        self.refresh_sim(i, sim)

    def refresh_sim(self, i: int, sim: NodeInfo) -> None:
        u = np.zeros(len(self.resources), dtype=np.int64)
        for q in sim.pods:
            u += self.req_of(q)
        self.used[i] = u
        self.existing = [(q, n) for q, n in self.existing if n != i] + [
            (q, i) for q in sim.pods
        ]

    def pop_sim(self, i: int) -> None:
        used, existing, info = self._sim_stack.pop(i)
        self.used[i] = used
        self.existing = existing
        self.infos[i] = info
