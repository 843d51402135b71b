"""Admission chain — mutating plugins, then validating plugins.

reference: staging/src/k8s.io/apiserver/pkg/admission (the chain the
apiserver's createHandler runs between decode and storage: mutation first,
validation second) plus the in-tree plugins the scheduling path depends on:

  NamespaceLifecycle   plugin/pkg/admission/namespace/lifecycle — reject
                       creates into missing/terminating namespaces
  LimitRanger          plugin/pkg/admission/limitranger — default container
                       requests from LimitRange.defaultRequest; enforce max
  Priority             plugin/pkg/admission/priority — resolve
                       priorityClassName -> spec.priority; reject unknown
                       classes; apply the global default
  ResourceQuota        plugin/pkg/admission/resourcequota — reject writes
                       that would push aggregate namespace usage over hard
                       caps (pods count + summed requests)

Validating-policy analog (ValidatingAdmissionPolicy / CEL): `PolicyPlugin`
holds named predicates over (attributes) — the expression language is a
Python callable instead of CEL, same shape: match constraints + validation
that must hold (apiserver/pkg/admission/plugin/policy/validating).

The port's copy of the JAX package's ``scheduler/admission.py``, the same semantics with its imports
re-pointed at the port; tests/test_torch_*.py hold the two equal.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, replace
from typing import Callable, Dict, List, Optional, Tuple

from ..api import cluster as c
from ..api import types as t
from .store import ClusterStore


class AdmissionDenied(Exception):
    """A validating (or mutating) plugin rejected the request — the Status
    Failure the reference returns as HTTP 4xx."""


@dataclass
class Attributes:
    """admission.Attributes — what every plugin sees."""

    verb: str  # create | update | delete
    kind: str  # Pod | Node | Service | ...
    namespace: str
    obj: object
    user: Optional[c.UserInfo] = None


class AdmissionPlugin:
    name = "plugin"

    def admit(self, attrs: Attributes) -> None:
        """Mutating pass — may replace attrs.obj."""

    def validate(self, attrs: Attributes) -> None:
        """Validating pass — raise AdmissionDenied to reject."""


class NamespaceLifecycle(AdmissionPlugin):
    name = "NamespaceLifecycle"
    _exempt = ("default", "kube-system")

    def __init__(self, store: ClusterStore):
        self.store = store

    def validate(self, attrs: Attributes) -> None:
        if attrs.verb != "create" or not attrs.namespace:
            return
        if attrs.kind == "Namespace":
            return
        ns = self.store.get_object("Namespace", attrs.namespace)
        if ns is None:
            if attrs.namespace in self._exempt:
                return  # implicit system namespaces
            raise AdmissionDenied(f"namespace {attrs.namespace!r} not found")
        if ns.phase == "Terminating":
            raise AdmissionDenied(
                f"namespace {attrs.namespace!r} is terminating: new objects forbidden"
            )


class LimitRanger(AdmissionPlugin):
    name = "LimitRanger"

    def __init__(self, store: ClusterStore):
        self.store = store

    def _ranges(self, namespace: str) -> List[c.LimitRange]:
        return self.store.list_objects("LimitRange", namespace)

    def admit(self, attrs: Attributes) -> None:
        if attrs.kind != "Pod" or attrs.verb != "create":
            return
        pod: t.Pod = attrs.obj  # type: ignore[assignment]
        for lr in self._ranges(attrs.namespace):
            missing = {
                r: v for r, v in lr.default_request.items() if r not in pod.requests
            }
            if missing:
                pod = copy.copy(pod)
                pod.requests = {**pod.requests, **missing}
                attrs.obj = pod

    def validate(self, attrs: Attributes) -> None:
        if attrs.kind != "Pod" or attrs.verb != "create":
            return
        pod: t.Pod = attrs.obj  # type: ignore[assignment]
        for lr in self._ranges(attrs.namespace):
            for r, cap in lr.max_per_pod.items():
                if pod.requests.get(r, 0) > cap:
                    raise AdmissionDenied(
                        f"maximum {r} usage per Pod is {cap}, but request is "
                        f"{pod.requests[r]} (limitrange {lr.name})"
                    )


class PriorityAdmission(AdmissionPlugin):
    name = "Priority"

    def __init__(self, store: ClusterStore):
        self.store = store

    def admit(self, attrs: Attributes) -> None:
        if attrs.kind != "Pod" or attrs.verb != "create":
            return
        pod: t.Pod = attrs.obj  # type: ignore[assignment]
        if pod.priority_class_name:
            pc = self.store.get_object("PriorityClass", pod.priority_class_name)
            if pc is None:
                raise AdmissionDenied(
                    f"no PriorityClass with name {pod.priority_class_name} was found"
                )
            value = pc.value
        elif pod.priority != 0:
            # the reference rejects user-supplied spec.priority: only this
            # admission plugin may compute it (plugin/pkg/admission/priority)
            raise AdmissionDenied(
                "the integer value of priority must not be provided in pod spec; "
                "priority admission controller computes it from priorityClassName"
            )
        else:
            default = next(
                (
                    pc
                    for pc in self.store.list_objects("PriorityClass")
                    if pc.global_default
                ),
                None,
            )
            if default is None:
                return
            value = default.value
        if pod.priority != value:
            pod = copy.copy(pod)
            pod.priority = value
            attrs.obj = pod


class ResourceQuotaAdmission(AdmissionPlugin):
    name = "ResourceQuota"

    def __init__(self, store: ClusterStore):
        self.store = store

    def _usage(self, namespace: str) -> Dict[str, int]:
        used: Dict[str, int] = {"pods": 0}
        for pod in self.store.list_pods():
            if pod.namespace != namespace or pod.phase in (
                t.PHASE_SUCCEEDED,
                t.PHASE_FAILED,
            ):
                continue
            used["pods"] += 1
            for r, v in pod.requests.items():
                used[r] = used.get(r, 0) + v
        return used

    def validate(self, attrs: Attributes) -> None:
        if attrs.kind != "Pod" or attrs.verb != "create":
            return
        pod: t.Pod = attrs.obj  # type: ignore[assignment]
        quotas = self.store.list_objects("ResourceQuota", attrs.namespace)
        if not quotas:
            return
        used = self._usage(attrs.namespace)
        for q in quotas:
            for r, hard in q.hard.items():
                delta = 1 if r == "pods" else pod.requests.get(r, 0)
                if used.get(r, 0) + delta > hard:
                    raise AdmissionDenied(
                        f"exceeded quota: {q.name}, requested: {r}={delta}, "
                        f"used: {r}={used.get(r, 0)}, limited: {r}={hard}"
                    )
        # all quotas passed: record status through the store (locked write +
        # watch event — the quota controller's updateQuota role)
        for q in quotas:
            new_used = {r: used.get(r, 0) for r in q.hard}
            if new_used != q.used:
                self.store.update_object("ResourceQuota", replace(q, used=new_used))


@dataclass(frozen=True)
class ValidatingPolicy:
    """ValidatingAdmissionPolicy-lite: match by kind, check must hold."""

    name: str
    check: Callable[[Attributes], bool]
    message: str = "policy denied"
    kinds: Tuple[str, ...] = ("*",)


class PolicyPlugin(AdmissionPlugin):
    """apiserver/pkg/admission/plugin/policy/validating — the CEL policy
    evaluator with the expression language swapped for Python callables."""

    name = "ValidatingAdmissionPolicy"

    def __init__(self) -> None:
        self.policies: List[ValidatingPolicy] = []

    def add(self, policy: ValidatingPolicy) -> None:
        self.policies.append(policy)

    def validate(self, attrs: Attributes) -> None:
        for p in self.policies:
            if "*" not in p.kinds and attrs.kind not in p.kinds:
                continue
            if not p.check(attrs):
                raise AdmissionDenied(f"{p.name}: {p.message}")


@dataclass(frozen=True)
class WebhookConfig:
    """admissionregistration.k8s.io — Mutating/ValidatingWebhookConfiguration
    reduced to one webhook: target URL, rule match (kinds/verbs), and
    failurePolicy.  Wire shape is AdmissionReview-like JSON:

      POST url  {"request": {"operation", "kind", "namespace", "object"}}
        -> {"response": {"allowed": bool, "message": str, "object": manifest?}}

    Mutating webhooks return the full mutated object instead of a JSONPatch
    (documented reduction; reinvocationPolicy is likewise not modeled)."""

    url: str
    mutating: bool = False
    kinds: Tuple[str, ...] = ()  # empty = every kind
    verbs: Tuple[str, ...] = ("create", "update")
    failure_policy: str = "Fail"  # Fail | Ignore
    timeout_s: float = 5.0


class Webhook(AdmissionPlugin):
    """apiserver/pkg/admission/plugin/webhook — the HTTP boundary member of
    the chain (mutating/{mutating,validating} dispatchers)."""

    def __init__(self, cfg: WebhookConfig):
        self.cfg = cfg
        self.name = f"webhook[{cfg.url}]"

    def _matches(self, attrs: Attributes) -> bool:
        if attrs.verb not in self.cfg.verbs:
            return False
        return not self.cfg.kinds or attrs.kind in self.cfg.kinds

    def _call(self, attrs: Attributes) -> dict:
        import urllib.error

        from ..api.serialize import to_manifest
        from .extender import post_json

        payload = {
            "request": {
                "operation": attrs.verb.upper(),
                "kind": attrs.kind,
                "namespace": attrs.namespace,
                "object": to_manifest(attrs.obj),
            }
        }
        try:
            resp = post_json(self.cfg.url, payload, self.cfg.timeout_s).get("response")
        except (urllib.error.URLError, OSError, ValueError) as e:
            if self.cfg.failure_policy == "Ignore":
                return {"allowed": True}
            raise AdmissionDenied(f"{self.name}: {e}") from e
        if not isinstance(resp, dict):
            # missing/garbage envelope is a webhook FAILURE (fail-open under
            # Ignore), not a deny verdict
            if self.cfg.failure_policy == "Ignore":
                return {"allowed": True}
            raise AdmissionDenied(f"{self.name}: malformed AdmissionReview response")
        return resp

    def admit(self, attrs: Attributes) -> None:
        if not self.cfg.mutating or not self._matches(attrs):
            return
        resp = self._call(attrs)
        if not resp.get("allowed", False):
            raise AdmissionDenied(f"{self.name}: {resp.get('message', 'denied')}")
        if resp.get("object") is not None:
            from ..api.serialize import DecodeError, from_manifest

            try:
                attrs.obj = from_manifest(resp["object"])
            except DecodeError as e:
                # a webhook returning a malformed object is a webhook failure
                # like any other: classified by failurePolicy
                if self.cfg.failure_policy != "Ignore":
                    raise AdmissionDenied(f"{self.name}: bad mutated object: {e}") from e

    def validate(self, attrs: Attributes) -> None:
        if self.cfg.mutating or not self._matches(attrs):
            return
        resp = self._call(attrs)
        if not resp.get("allowed", False):
            raise AdmissionDenied(f"{self.name}: {resp.get('message', 'denied')}")


class AdmissionChain:
    """admission.NewChainHandler — all mutating admits, then all validates."""

    def __init__(self, plugins: List[AdmissionPlugin]):
        self.plugins = plugins

    @staticmethod
    def default(
        store: ClusterStore,
        policies: Optional[PolicyPlugin] = None,
        webhooks: Tuple[WebhookConfig, ...] = (),
    ) -> "AdmissionChain":
        plugins: List[AdmissionPlugin] = [
            NamespaceLifecycle(store),
            LimitRanger(store),
            PriorityAdmission(store),
            ResourceQuotaAdmission(store),
        ]
        if policies is not None:
            plugins.append(policies)
        # webhooks after in-tree plugins: mutating webhooks see in-tree
        # defaults applied; validating webhooks run in the validate pass
        plugins.extend(Webhook(w) for w in webhooks)
        return AdmissionChain(plugins)

    def run(self, attrs: Attributes) -> object:
        """-> the (possibly mutated) object; raises AdmissionDenied."""
        for p in self.plugins:
            p.admit(attrs)
        for p in self.plugins:
            p.validate(attrs)
        return attrs.obj
