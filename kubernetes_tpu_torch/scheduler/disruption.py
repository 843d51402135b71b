"""Disruption controller — maintains PodDisruptionBudget status.

Analog of pkg/controller/disruption (type DisruptionController, sync →
trySync → updatePdbStatus): for each PDB, count the pods its selector
matches, the healthy subset, resolve min_available/max_unavailable into a
desired-healthy count, and publish disruptions_allowed — the number the
preemption evaluator (and the reference's Eviction API) is allowed to consume.

"Healthy" here = bound (has a nodeName) and, when the pod phase machinery is
in play (kubelet.py), phase Running — the reference's
pod.status.conditions[Ready] check reduced to the harness's lifecycle surface.

The port's copy of the JAX package's ``scheduler/disruption.py``, the same semantics with its imports
re-pointed at the port; tests/test_torch_*.py hold the two equal.
"""

from __future__ import annotations

from typing import List

from ..api import types as t
from .store import ClusterStore


def _is_healthy(pod: t.Pod) -> bool:
    if not pod.node_name:
        return False
    phase = getattr(pod, "phase", "")
    return phase in ("", "Running")


class DisruptionController:
    """Level-triggered reconcile over all PDBs (the workqueue collapsed to a
    full pass per tick, as every controller in this harness does)."""

    def __init__(self, store: ClusterStore):
        self.store = store

    def tick(self) -> List[t.PodDisruptionBudget]:
        """Reconcile every PDB's status; returns the updated objects."""
        out: List[t.PodDisruptionBudget] = []
        for pdb in self.store.list_pdbs():
            matching = [p for p in self.store.list_pods() if pdb.matches(p)]
            expected = len(matching)
            healthy = sum(1 for p in matching if _is_healthy(p))
            if pdb.min_available is not None:
                desired = min(pdb.min_available, expected)
            elif pdb.max_unavailable is not None:
                desired = max(0, expected - pdb.max_unavailable)
            else:
                desired = expected  # no budget field: nothing may be disrupted
            allowed = max(0, healthy - desired)
            if (
                pdb.disruptions_allowed == allowed
                and pdb.current_healthy == healthy
                and pdb.desired_healthy == desired
                and pdb.expected_pods == expected
            ):
                out.append(pdb)
                continue
            import copy

            pdb2 = copy.copy(pdb)
            pdb2.disruptions_allowed = allowed
            pdb2.current_healthy = healthy
            pdb2.desired_healthy = desired
            pdb2.expected_pods = expected
            self.store.update_pdb(pdb2)
            out.append(pdb2)
        return out
