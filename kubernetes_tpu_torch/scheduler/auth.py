"""Authentication + RBAC authorization — the apiserver security layers.

reference: staging/src/k8s.io/apiserver/pkg/authentication (token authenticator
chain) and plugin/pkg/auth/authorizer/rbac/rbac.go — func (r *RBACAuthorizer)
Authorize: resolve the user's Roles through bindings, allow iff any PolicyRule
covers (verb, resource, name) in the request's namespace.  ClusterRoles bound
by ClusterRoleBindings grant cluster-wide; Roles (or ClusterRoles referenced by
a RoleBinding) grant within the binding's namespace.

The port's copy of the JAX package's ``scheduler/auth.py``, the same semantics with its imports
re-pointed at the port; tests/test_torch_*.py hold the two equal.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

from ..api import cluster as c
from .store import ClusterStore

SYSTEM_MASTERS = "system:masters"  # the always-allowed group (reference: rbac.go)


class TokenAuthenticator:
    """Static token table — the authenticator chain reduced to its bearer-token
    member (apiserver/pkg/authentication/token/tokenfile)."""

    def __init__(self) -> None:
        self._tokens: Dict[str, c.UserInfo] = {}

    def add_token(self, token: str, user: str, groups: Iterable[str] = ()) -> None:
        self._tokens[token] = c.UserInfo(name=user, groups=tuple(groups))

    def remove_token(self, token: str) -> None:
        """Credential revocation (the tokens_controller deletes the token
        Secret when its ServiceAccount goes away)."""
        self._tokens.pop(token, None)

    def authenticate(self, token: Optional[str]) -> Optional[c.UserInfo]:
        """-> UserInfo, or None (unauthenticated => request rejected upstream)."""
        if token is None:
            return None
        return self._tokens.get(token)


def _rule_allows(rule: c.PolicyRule, verb: str, resource: str, name: str) -> bool:
    # rbac/v1 helpers — VerbMatches/ResourceMatches/ResourceNameMatches
    if "*" not in rule.verbs and verb not in rule.verbs:
        return False
    if "*" not in rule.resources and resource not in rule.resources:
        return False
    if rule.resource_names and name not in rule.resource_names:
        return False
    return True


class RBACAuthorizer:
    def __init__(self, store: ClusterStore):
        self.store = store

    def _subject_matches(self, sub: c.Subject, user: c.UserInfo) -> bool:
        if sub.kind == "User":
            return sub.name == user.name
        if sub.kind == "Group":
            return sub.name in user.groups
        if sub.kind == "ServiceAccount":
            # Subject.name carries "namespace:name" (rbac/v1 splits these
            # into two fields; folded here) — serviceaccount MakeUsername
            return user.name == f"system:serviceaccount:{sub.name}"
        return False

    def _roles_for(self, user: c.UserInfo, namespace: str):
        """Yield (role, scope_namespace) pairs the user holds for requests in
        `namespace` — the VisitRulesFor walk."""
        roles: Dict[str, c.Role] = self.store.objects["Role"]  # type: ignore[assignment]
        bindings = self.store.list_objects("RoleBinding")
        for rb in bindings:  # type: ignore[assignment]
            if not any(self._subject_matches(s, user) for s in rb.subjects):
                continue
            # ClusterRoleBinding (namespace "") grants everywhere; RoleBinding
            # grants only inside its own namespace
            if rb.namespace and rb.namespace != namespace:
                continue
            role_key = (
                f"{rb.role_namespace}/{rb.role_name}"
                if rb.role_namespace
                else rb.role_name
            )
            role = roles.get(role_key)
            if role is not None:
                yield role

    def authorize(
        self, user: c.UserInfo, verb: str, resource: str, namespace: str = "", name: str = ""
    ) -> bool:
        if SYSTEM_MASTERS in user.groups:
            return True
        for role in self._roles_for(user, namespace):
            for rule in role.rules:
                if _rule_allows(rule, verb, resource, name):
                    return True
        return False


def bind_cluster_role(
    store: ClusterStore,
    binding_name: str,
    role_name: str,
    subjects: Iterable[Tuple[str, str]],
) -> None:
    """Convenience: create a ClusterRoleBinding to the ClusterRole role_name."""
    store.add_object(
        "RoleBinding",
        c.RoleBinding(
            name=binding_name,
            namespace="",
            role_name=role_name,
            role_namespace="",
            subjects=tuple(c.Subject(kind=k, name=n) for k, n in subjects),
        ),
    )
