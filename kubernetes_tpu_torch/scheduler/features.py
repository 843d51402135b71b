"""Feature gates (component-base/featuregate — pkg/features/kube_features.go).

A small typed registry: each gate has a maturity stage and a default; config
can flip non-GA gates.  Call sites check features.enabled("X").

The port's copy of the JAX package's ``scheduler/features.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

ALPHA, BETA, GA = "Alpha", "Beta", "GA"


@dataclass(frozen=True)
class Gate:
    name: str
    stage: str
    default: bool


_GATES: Dict[str, Gate] = {
    g.name: g
    for g in [
        Gate("TPUScore", BETA, True),  # batched TPU offload path
        Gate("GangScheduling", BETA, True),  # all-or-nothing PodGroups
        Gate("DefaultPreemption", GA, True),
        # device-vectorized victim search on the batch path (ops/preempt.py);
        # off -> every failed pod takes the CPU PostFilter evaluator
        Gate("BatchedPreemption", BETA, True),
        Gate("SchedulingGates", GA, True),
        Gate("NodeInclusionPolicy", ALPHA, False),  # spread honors taints (future)
        Gate("MatchLabelKeys", ALPHA, False),  # spread matchLabelKeys (future)
    ]
}


class FeatureGates:
    def __init__(self, overrides: Tuple[Tuple[str, bool], ...] = ()):
        self._enabled = {name: g.default for name, g in _GATES.items()}
        for name, val in overrides:
            if name not in _GATES:
                raise ValueError(f"unknown feature gate {name!r}")
            if _GATES[name].stage == GA and not val:
                raise ValueError(f"cannot disable GA gate {name}")
            self._enabled[name] = val

    def enabled(self, name: str) -> bool:
        return self._enabled[name]


DEFAULT_FEATURE_GATES = FeatureGates()
