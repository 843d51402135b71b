"""HTTP scheduler extender — the reference's out-of-process extension
protocol, kept wire-compatible.

reference: pkg/scheduler/extender.go — type HTTPExtender (Filter /
Prioritize / Bind over JSON HTTP POST) with config shape
pkg/scheduler/apis/config/types.go — type Extender (urlPrefix, filterVerb,
prioritizeVerb, weight, bindVerb, ignorable).

The gRPC TPUScore sidecar (runtime/) is this framework's *batched*
replacement; this client exists for drop-in compatibility with existing
one-pod-per-call extenders.  Wire shapes:

  POST {urlPrefix}/{filterVerb}    ExtenderArgs{pod, nodenames}
       -> ExtenderFilterResult{nodenames, failedNodes, error}
  POST {urlPrefix}/{prioritizeVerb} ExtenderArgs
       -> HostPriorityList [{host, score}]   (score 0..10, scaled by weight)
  POST {urlPrefix}/{bindVerb}      ExtenderBindingArgs{podName, podNamespace,
       podUID, node} -> ExtenderBindingResult{error}

The port's copy of the JAX package's ``scheduler/extender.py``, the same semantics with its imports
re-pointed at the port; tests/test_torch_*.py hold the two equal.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..api import types as t
from ..api.serialize import to_manifest

# reference: extenderv1.MaxExtenderPriority
MAX_EXTENDER_PRIORITY = 10.0


class ExtenderError(Exception):
    """Transport/protocol failure from a non-ignorable extender: the pod's
    scheduling attempt fails and it re-queues (extender.go — IsIgnorable)."""


def post_json(url: str, payload: dict, timeout_s: float) -> dict:
    """One JSON POST -> decoded JSON response.  Shared wire helper for the
    extender and admission-webhook clients; raises the urllib/OS/ValueError
    family for the caller's failure policy to classify."""
    req = urllib.request.Request(
        url,
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout_s) as resp:
        return json.loads(resp.read().decode())


@dataclass(frozen=True)
class ExtenderConfig:
    """apis/config — type Extender (the fields this client honors)."""

    url_prefix: str
    filter_verb: str = ""
    prioritize_verb: str = ""
    bind_verb: str = ""
    # supportsPreemption: when set, DefaultPreemption offers this extender
    # its candidate victim map (extender.go — ProcessPreemption)
    preempt_verb: str = ""
    weight: float = 1.0
    ignorable: bool = False
    timeout_s: float = 5.0


class HTTPExtender:
    def __init__(self, cfg: ExtenderConfig):
        self.cfg = cfg

    def _post(self, verb: str, payload: dict) -> dict:
        url = f"{self.cfg.url_prefix.rstrip('/')}/{verb}"
        return post_json(url, payload, self.cfg.timeout_s)

    # ------------------------------------------------------------- filter
    def filter(
        self, pod: t.Pod, node_names: List[str]
    ) -> Tuple[List[str], Dict[str, str]]:
        """-> (feasible node names, failed {node: reason}).  Raises
        ExtenderError on transport failure (caller applies `ignorable`)."""
        if not self.cfg.filter_verb:
            return node_names, {}
        try:
            out = self._post(
                self.cfg.filter_verb,
                {"pod": to_manifest(pod), "nodenames": list(node_names)},
            )
        except (urllib.error.URLError, OSError, ValueError) as e:
            raise ExtenderError(f"{self.cfg.url_prefix}: {e}") from e
        if out.get("error"):
            raise ExtenderError(out["error"])
        return list(out.get("nodenames") or []), dict(out.get("failedNodes") or {})

    # ---------------------------------------------------------- prioritize
    def prioritize(self, pod: t.Pod, node_names: List[str]) -> Dict[str, float]:
        """-> {node: weighted score}.  A failing prioritize call zeroes the
        extender's contribution (extender.go — Prioritize errors are fatal
        only for non-ignorable extenders; we mirror the filter contract)."""
        if not self.cfg.prioritize_verb:
            return {}
        try:
            out = self._post(
                self.cfg.prioritize_verb,
                {"pod": to_manifest(pod), "nodenames": list(node_names)},
            )
        except (urllib.error.URLError, OSError, ValueError) as e:
            raise ExtenderError(f"{self.cfg.url_prefix}: {e}") from e
        return {
            h["host"]: float(h["score"]) * self.cfg.weight
            for h in out
            if isinstance(h, dict) and "host" in h
        }

    # ---------------------------------------------------------- preemption
    def process_preemption(
        self, pod: t.Pod, node_to_victims: Dict[str, List[t.Pod]]
    ) -> Dict[str, List[t.Pod]]:
        """extender.go — ProcessPreemption: offer the candidate victim map;
        the extender returns the surviving subset (it may drop whole nodes
        or trim a node's victim list).  Wire shape is the reference's
        ExtenderPreemptionArgs / nodeNameToMetaVictims (victims by uid).
        Raises ExtenderError on transport failure (caller applies
        `ignorable`)."""
        if not self.cfg.preempt_verb:
            return node_to_victims
        try:
            out = self._post(
                self.cfg.preempt_verb,
                {
                    "pod": to_manifest(pod),
                    "nodeNameToMetaVictims": {
                        node: {"pods": [{"uid": q.uid} for q in victims]}
                        for node, victims in node_to_victims.items()
                    },
                },
            )
        except (urllib.error.URLError, OSError, ValueError) as e:
            raise ExtenderError(f"{self.cfg.url_prefix}: {e}") from e
        if out.get("error"):
            raise ExtenderError(out["error"])
        result: Dict[str, List[t.Pod]] = {}
        for node, meta in (out.get("nodeNameToMetaVictims") or {}).items():
            orig = node_to_victims.get(node)
            if orig is None:
                continue  # an extender cannot invent candidate nodes
            # ... nor move victims between nodes: only THIS node's own
            # candidates resolve (the reference's convertToVictims rejects
            # unknown uids the same way)
            own = {q.uid: q for q in orig}
            kept = [
                own[m["uid"]]
                for m in (meta or {}).get("pods", [])
                if m.get("uid") in own
            ]
            if kept:
                result[node] = kept
        return result

    # ---------------------------------------------------------------- bind
    def bind(self, pod: t.Pod, node_name: str) -> Optional[str]:
        """-> error string or None.  Only called when bind_verb is set; the
        extender performs the binding POST itself in the reference."""
        try:
            out = self._post(
                self.cfg.bind_verb,
                {
                    "podName": pod.name,
                    "podNamespace": pod.namespace,
                    "podUID": pod.uid,
                    "node": node_name,
                },
            )
        except (urllib.error.URLError, OSError, ValueError) as e:
            return str(e)
        return out.get("error") or None
