"""Service networking: EndpointSlice controller + kube-proxy analog.

reference:
  pkg/controller/endpointslice — reconcile EndpointSlices for each Service
  from the pods its selector matches (ready = Running with an IP), slices
  capped at maxEndpointsPerSlice (default 100), owned by the Service (GC'd
  with it).
  pkg/proxy — the proxier pattern: watch Service/EndpointSlice, rebuild the
  kernel ruleset in one syncProxyRules pass.  Here the "kernel ruleset" is an
  in-memory VIP table: (clusterIP, port) -> ordered backend list; lookup()
  plays the iptables -j DNAT chain walk with random backend choice and
  ClientIP session affinity (the two balancing modes iptables mode supports).

The port's copy of the JAX package's ``scheduler/network.py``, the same semantics with its imports
re-pointed at the port; tests/test_torch_*.py hold the two equal.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

from ..api import cluster as c
from ..api import types as t
from .store import ClusterStore

MAX_ENDPOINTS_PER_SLICE = 100


class EndpointSliceController:
    """pkg/controller/endpointslice — endpoint_slice_controller.go:
    syncService per tick; full reconcile (level-triggered, same trade as the
    other controllers here)."""

    def __init__(self, store: ClusterStore):
        self.store = store

    def _endpoints_for(self, svc: c.Service) -> List[c.Endpoint]:
        eps = []
        for pod in self.store.list_pods():
            if not svc.selects(pod):
                continue
            if not pod.node_name:
                continue  # unscheduled pods are never endpoints
            # serving readiness = Running AND the Ready condition the
            # kubelet's prober maintains (False while a readiness probe has
            # not yet passed, or after failure_threshold failures)
            ready = pod.phase in ("", t.PHASE_RUNNING) and pod.ready
            if pod.phase in (t.PHASE_SUCCEEDED, t.PHASE_FAILED):
                continue
            address = pod.pod_ip or f"?:{pod.uid}"  # IP pending -> not ready
            if not pod.pod_ip:
                ready = False
            eps.append(
                c.Endpoint(address=address, pod_uid=pod.uid,
                           node_name=pod.node_name, ready=ready)
            )
        eps.sort(key=lambda e: e.address)
        return eps

    def sync_service(self, svc: c.Service) -> None:
        want = self._endpoints_for(svc)
        # chunk into slices of MAX_ENDPOINTS_PER_SLICE
        chunks = [
            tuple(want[i : i + MAX_ENDPOINTS_PER_SLICE])
            for i in range(0, len(want), MAX_ENDPOINTS_PER_SLICE)
        ] or [()]
        existing = {
            s.name: s
            for s in self.store.list_objects("EndpointSlice", svc.namespace)
            if s.service_name == svc.name
        }
        owner = (t.OwnerReference(kind="Service", name=svc.name, uid=svc.uid),)
        wanted_names = {f"{svc.name}-{i}" for i in range(len(chunks))}
        for i, chunk in enumerate(chunks):
            name = f"{svc.name}-{i}"
            current = existing.get(name)
            desired = c.EndpointSlice(
                name=name, namespace=svc.namespace, service_name=svc.name,
                endpoints=chunk, ports=svc.ports, owner_references=owner,
            )
            if current is None:
                self.store.add_object("EndpointSlice", desired)
            elif current.endpoints != chunk or current.ports != svc.ports:
                desired.uid = current.uid
                self.store.update_object("EndpointSlice", desired)
        # delete by name-set membership (a positional sort would misfire past
        # 10 slices: "web-10" < "web-2" lexicographically)
        for s in existing.values():
            if s.name not in wanted_names:
                self.store.delete_object("EndpointSlice", s.key)

    def tick(self) -> None:
        services = self.store.list_objects("Service")
        names = {(s.namespace, s.name) for s in services}
        for svc in services:
            self.sync_service(svc)
        # slices for deleted services (when GC hasn't collected them yet)
        for s in self.store.list_objects("EndpointSlice"):
            if s.service_name and (s.namespace, s.service_name) not in names:
                self.store.delete_object("EndpointSlice", s.key)


@dataclass(frozen=True)
class Rule:
    """One VIP:port service entry in the synced "ruleset"."""

    cluster_ip: str
    port: int
    protocol: str
    session_affinity: str
    backends: Tuple[Tuple[str, int], ...]  # (pod ip, target port), ready only


class Proxier:
    """pkg/proxy/iptables/proxier.go — syncProxyRules reduced to its
    semantics: full rebuild of the VIP table from the watched state, then
    O(1) lookups with per-service probability-chain (random) balancing and
    ClientIP affinity stickiness."""

    def __init__(self, store: ClusterStore, seed: int = 0):
        self.store = store
        self.rules: Dict[Tuple[str, int], Rule] = {}
        self._rng = random.Random(seed)
        self._affinity: Dict[Tuple[str, str, int], Tuple[str, int]] = {}
        self.sync_count = 0

    def sync(self) -> None:
        """One syncProxyRules pass."""
        rules: Dict[Tuple[str, int], Rule] = {}
        slices_by_svc: Dict[Tuple[str, str], List[c.EndpointSlice]] = {}
        for s in self.store.list_objects("EndpointSlice"):
            slices_by_svc.setdefault((s.namespace, s.service_name), []).append(s)
        for svc in self.store.list_objects("Service"):
            if not svc.cluster_ip:
                continue
            eps: List[c.Endpoint] = []
            for s in slices_by_svc.get((svc.namespace, svc.name), []):
                eps.extend(e for e in s.endpoints if e.ready)
            eps.sort(key=lambda e: e.address)
            for port in svc.ports:
                rules[(svc.cluster_ip, port.port)] = Rule(
                    cluster_ip=svc.cluster_ip,
                    port=port.port,
                    protocol=port.protocol,
                    session_affinity=svc.session_affinity,
                    backends=tuple((e.address, port.backend_port) for e in eps),
                )
        self.rules = rules
        # drop affinity entries whose backend vanished (conntrack cleanup)
        self._affinity = {
            k: v
            for k, v in self._affinity.items()
            if any(v in r.backends for r in rules.values())
        }
        self.sync_count += 1

    def lookup(self, client_ip: str, vip: str, port: int) -> Optional[Tuple[str, int]]:
        """Route one connection: -> (pod ip, port) or None (REJECT: no
        endpoints — iptables' -j REJECT for empty services)."""
        rule = self.rules.get((vip, port))
        if rule is None or not rule.backends:
            return None
        if rule.session_affinity == "ClientIP":
            key = (client_ip, vip, port)
            prev = self._affinity.get(key)
            if prev is not None and prev in rule.backends:
                return prev
            chosen = self._rng.choice(rule.backends)
            self._affinity[key] = chosen
            return chosen
        return self._rng.choice(rule.backends)
