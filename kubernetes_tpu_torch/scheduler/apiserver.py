"""APIServer facade — the generic server's handler chain, in-process.

reference: staging/src/k8s.io/apiserver/pkg/server/config.go —
DefaultBuildHandlerChain: panic-recovery -> timeout -> authentication ->
audit -> Priority&Fairness -> authorization -> admission -> registry store.
This facade reproduces that order over the in-process ClusterStore: each
`handle()` call is one API request.  Components that want the unfiltered
fast path (the scheduler's own binding loop, the harness) keep talking to
ClusterStore directly — the reference's loopback client is similarly exempted
from APF (the "exempt" priority level).

Also owns the Service ClusterIP allocator (the core/v1 Service REST strategy's
ipallocator — pkg/registry/core/service/ipallocator).

The port's copy of the JAX package's ``scheduler/apiserver.py``, the same semantics with its imports
re-pointed at the port; tests/test_torch_*.py hold the two equal.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

from ..api import cluster as c
from ..api import types as t
from .admission import AdmissionChain, AdmissionDenied, Attributes, PolicyPlugin
from .auth import RBACAuthorizer, TokenAuthenticator
from .flowcontrol import APFController, Request, RequestRejected
from .store import ClusterStore


class Unauthenticated(Exception):
    """HTTP 401."""


class Forbidden(Exception):
    """HTTP 403."""


# kind -> RBAC resource name (lowercased plural, the RESTMapper's job)
_RESOURCES = {
    "Pod": "pods",
    "Node": "nodes",
    "PDB": "poddisruptionbudgets",
    "Service": "services",
    "EndpointSlice": "endpointslices",
    "Namespace": "namespaces",
    "ReplicaSet": "replicasets",
    "Deployment": "deployments",
    "Job": "jobs",
    "StatefulSet": "statefulsets",
    "DaemonSet": "daemonsets",
    "CronJob": "cronjobs",
    "PriorityClass": "priorityclasses",
    "ResourceQuota": "resourcequotas",
    "LimitRange": "limitranges",
    "HorizontalPodAutoscaler": "horizontalpodautoscalers",
    "Role": "roles",
    "RoleBinding": "rolebindings",
    "Lease": "leases",
    "PV": "persistentvolumes",
    "PVC": "persistentvolumeclaims",
    "StorageClass": "storageclasses",
    "DeviceClass": "deviceclasses",
}


def resource_of(kind: str) -> str:
    return _RESOURCES.get(kind, kind.lower() + "s")


@dataclass
class AuditEvent:
    """audit/v1 — the fields that matter for the log (apiserver/pkg/audit)."""

    user: str
    verb: str
    resource: str
    namespace: str
    name: str
    allowed: bool
    reason: str = ""


class ClusterIPAllocator:
    """pkg/registry/core/service/ipallocator — sequential allocator over a
    /16 service CIDR with reuse of freed addresses."""

    def __init__(self, prefix: str = "10.96"):
        self.prefix = prefix
        self._next = 1
        self._free: List[int] = []
        self._used: set = set()

    def allocate(self) -> str:
        if self._free:
            n = self._free.pop()
        else:
            n = self._next
            self._next += 1
        self._used.add(n)
        return f"{self.prefix}.{n >> 8 & 0xFF}.{n & 0xFF}"

    def release(self, ip: str) -> None:
        parts = ip.split(".")
        n = (int(parts[2]) << 8) | int(parts[3])
        if n in self._used:
            self._used.discard(n)
            self._free.append(n)


class MetricsServer:
    """The /metrics exposition route — a minimal HTTP server over the
    in-process registry (staging/src/k8s.io/component-base/metrics/legacyregistry
    served through the generic server's /metrics handler).  `render` is a
    zero-arg callable returning the Prometheus text body
    (Metrics.expose_text), re-evaluated per scrape; /healthz answers 200 ok
    so probes can target the same port.  port=0 binds an ephemeral port
    (returned by start())."""

    def __init__(self, render, host: str = "127.0.0.1", port: int = 0):
        import http.server
        import threading

        srv_render = render

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                if self.path.split("?", 1)[0] == "/metrics":
                    body = srv_render().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8",
                    )
                elif self.path == "/healthz":
                    body = b"ok"
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                else:
                    body = b"not found"
                    self.send_response(404)
                    self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # pragma: no cover — quiet scrapes
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_port
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="metrics-exposition",
        )

    def start(self) -> int:
        self._thread.start()
        return self.port

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


class APIServer:
    def __init__(
        self,
        store: ClusterStore,
        authenticator: Optional[TokenAuthenticator] = None,
        policies: Optional[PolicyPlugin] = None,
        webhooks: tuple = (),
        total_concurrency: int = 600,
        queue_wait_s: float = 5.0,
        tracer=None,
        metrics=None,
    ):
        from .tracing import Tracer

        self.store = store
        self.queue_wait_s = queue_wait_s
        # each handle() call is one traced request (the reference wraps the
        # handler chain in an otelhttp span the same way); a created Pod
        # inherits the request span as its trace root, so the pod's queue /
        # scheduling / kubelet spans all join one tree
        self.tracer = tracer or Tracer(component="apiserver")
        self.authn = authenticator or TokenAuthenticator()
        self.authz = RBACAuthorizer(store)
        self.apf = APFController(store, total_concurrency=total_concurrency)
        self.admission = AdmissionChain.default(store, policies, webhooks)
        self.audit_log: List[AuditEvent] = []
        self.ips = ClusterIPAllocator()
        # the registry the /metrics route serves (scheduler/metrics.py —
        # usually the scheduler's own Metrics, injected so one scrape
        # covers the whole control plane); lazily created when absent so
        # metrics_text() always renders valid exposition
        from .metrics import Metrics

        self.metrics = metrics if metrics is not None else Metrics()
        self._metrics_server: Optional[MetricsServer] = None
        from .crd import CRDRegistry

        # apiextensions: dynamic kinds with per-version structural schemas
        self.crds = CRDRegistry(store)

    # -- the /metrics route --
    def metrics_text(self) -> str:
        """The Prometheus text body GET /metrics serves — the full registry
        (counters, gauges, labeled series, streaming-histogram buckets)."""
        return self.metrics.expose_text()

    def serve_metrics(self, port: int = 0, host: str = "127.0.0.1") -> int:
        """Start (idempotently) the HTTP exposition server for this
        apiserver's registry; returns the bound port.  KTPU_METRICS=<port>
        is the env-knob spelling harness/bench runs use."""
        if self._metrics_server is None:
            self._metrics_server = MetricsServer(
                self.metrics_text, host=host, port=port
            )
            self._metrics_server.start()
        return self._metrics_server.port

    def stop_metrics(self) -> None:
        if self._metrics_server is not None:
            self._metrics_server.stop()
            self._metrics_server = None

    # -- the handler chain --
    def handle(
        self,
        token: Optional[str],
        verb: str,
        kind: str,
        obj: object = None,
        namespace: str = "",
        name: str = "",
        impersonate_user: Optional[str] = None,
    ):
        """One request through the full chain.  Returns the stored object for
        writes / the object (list) for reads."""
        if not self.tracer.enabled:
            return self._handle(token, verb, kind, obj, namespace, name,
                                impersonate_user)
        with self.tracer.span(
            "apiserver.request", parent=None, verb=verb, kind=kind
        ) as sp:
            out = self._handle(token, verb, kind, obj, namespace, name,
                               impersonate_user)
            if verb == "create" and kind == "Pod" and sp is not None:
                uid = getattr(out, "uid", "")
                if uid:
                    # the request span becomes the pod's trace root: queue,
                    # scheduler and kubelet spans chain under it
                    sp.attributes["pod"] = uid
                    self.tracer.collector.attach_pod(uid, sp.context)
            return out

    def _handle(
        self,
        token: Optional[str],
        verb: str,
        kind: str,
        obj: object = None,
        namespace: str = "",
        name: str = "",
        impersonate_user: Optional[str] = None,
    ):
        resource = resource_of(kind)
        ns = namespace or getattr(obj, "namespace", "") or ""
        nm = name or getattr(obj, "name", "") or ""

        # authentication
        user = self.authn.authenticate(token)
        if user is None:
            self._audit("anonymous", verb, resource, ns, nm, False, "unauthenticated")
            raise Unauthenticated("invalid or missing bearer token")

        # impersonation (the Impersonate-User header; chain position matches
        # DefaultBuildHandlerChain: after authn, before audit/authz): the
        # AUTHENTICATED user needs the `impersonate` verb on `users`, then
        # the request proceeds as — and is audited as — the impersonated user
        if impersonate_user is not None:
            from ..api import cluster as c

            if not self.authz.authorize(user, "impersonate", "users", "", impersonate_user):
                self._audit(user.name, verb, resource, ns, nm, False,
                            f"cannot impersonate {impersonate_user!r}")
                raise Forbidden(
                    f'user "{user.name}" cannot impersonate user "{impersonate_user}"'
                )
            user = c.UserInfo(name=impersonate_user, groups=())

        # priority & fairness: classify + fair-queue; in this synchronous
        # facade the request must come out of dispatch() before proceeding
        # (exempt levels release immediately and never queue)
        req = Request(user=user.name, verb=verb, resource=resource, namespace=ns)
        self.apf.admit(req)  # raises RequestRejected (429) when queues overflow
        deadline = time.monotonic() + self.queue_wait_s
        while not req.released:
            self.apf.dispatch()
            if req.released:
                break
            if time.monotonic() > deadline:
                self.apf.cancel(req)  # dequeue (or return a late-released seat)
                raise RequestRejected(
                    f"request from {user.name!r} timed out waiting for a seat "
                    f"at level {req.level!r}"
                )
            time.sleep(0.001)  # seats held by concurrent callers

        try:
            # authorization
            if not self.authz.authorize(user, verb, resource, ns, nm):
                self._audit(user.name, verb, resource, ns, nm, False, "forbidden")
                raise Forbidden(
                    f'user "{user.name}" cannot {verb} resource "{resource}"'
                    + (f' in namespace "{ns}"' if ns else "")
                )

            # admission (writes only), then the registry
            if verb in ("create", "update"):
                attrs = Attributes(verb=verb, kind=kind, namespace=ns, obj=obj,
                                   user=user)
                obj = self.admission.run(attrs)  # raises AdmissionDenied (400)
                out = self._write(verb, kind, obj)
            elif verb == "delete":
                self._delete(kind, ns, nm)
                out = None
            elif verb == "list":
                out = self._list(kind, ns or None)
            elif verb == "get":
                out = self._get(kind, ns, nm)
            else:
                raise ValueError(f"unsupported verb {verb!r}")
            self._audit(user.name, verb, resource, ns, nm, True)
            return out
        finally:
            self.apf.finish(req)

    # -- registry dispatch --
    def _write(self, verb: str, kind: str, obj):
        if kind == "Pod":
            (self.store.add_pod if verb == "create" else self.store.update_pod)(obj)
        elif kind == "Node":
            (self.store.add_node if verb == "create" else self.store.update_node)(obj)
        elif kind == "PDB":
            (self.store.add_pdb if verb == "create" else self.store.update_pdb)(obj)
        elif kind == "PV":
            (self.store.add_pv if verb == "create" else self.store.update_pv)(obj)
        elif kind == "PVC":
            (self.store.add_pvc if verb == "create" else self.store.update_pvc)(obj)
        else:
            from .crd import CRDInvalid, CRValidationError

            if kind == "CustomResourceDefinition":
                if verb != "create":
                    raise ValueError("CRD updates not supported; delete + recreate")
                try:
                    return self.crds.create(obj)
                except CRDInvalid as e:
                    raise AdmissionDenied(str(e)) from e
            if self.crds.definition_for(kind) is not None:
                # custom kind: served-version check + structural-schema
                # validation + storage-version conversion
                # (customresource_handler.go — the validation admission)
                try:
                    obj = self.crds.admit(obj)
                except CRValidationError as e:
                    raise AdmissionDenied(str(e)) from e
            if kind == "Service" and verb == "create" and not obj.cluster_ip:
                obj.cluster_ip = self.ips.allocate()
            (self.store.add_object if verb == "create" else self.store.update_object)(
                kind, obj
            )
        return obj

    def _find_pod(self, ns: str, name: str):
        """Pods are stored by uid; API identity is namespace/name.  Try the
        defaulted-uid fast path, then scan (the registry's name index)."""
        p = self.store.pods.get(f"{ns}/{name}")
        if p is not None and p.namespace == ns and p.name == name:
            return p
        for p in self.store.list_pods():
            if p.namespace == ns and p.name == name:
                return p
        return None

    def _delete(self, kind: str, ns: str, name: str) -> None:
        key = f"{ns}/{name}" if ns else name
        if kind == "Pod":
            p = self._find_pod(ns, name)
            if p is not None:
                self.store.delete_pod(p.uid)
        elif kind == "Node":
            self.store.delete_node(name)
        elif kind == "PDB":
            self.store.delete_pdb(key)
        elif kind == "PV":
            self.store.delete_pv(name)
        elif kind == "PVC":
            self.store.delete_pvc(key)
        else:
            if kind == "CustomResourceDefinition":
                self.crds.delete(name)
                return
            if kind == "Service":
                svc = self.store.get_object("Service", key)
                if svc is not None and svc.cluster_ip:
                    self.ips.release(svc.cluster_ip)
            self.store.delete_object(kind, key)

    def _get(self, kind: str, ns: str, name: str):
        if kind == "Pod":
            return self._find_pod(ns, name)
        if kind == "Node":
            return self.store.nodes.get(name)
        if kind == "PDB":
            return self.store.pdbs.get(f"{ns}/{name}")
        if kind == "PV":
            return self.store.pvs.get(name)
        if kind == "PVC":
            return self.store.pvcs.get(f"{ns}/{name}")
        return self.store.get_object(kind, f"{ns}/{name}" if ns else name)

    def _list(self, kind: str, ns: Optional[str]):
        if kind == "Pod":
            return [p for p in self.store.list_pods()
                    if ns is None or p.namespace == ns]
        if kind == "Node":
            return self.store.list_nodes()
        if kind == "PDB":
            return [p for p in self.store.list_pdbs()
                    if ns is None or p.namespace == ns]
        if kind == "PV":
            return self.store.list_pvs()
        if kind == "PVC":
            return [p for p in self.store.list_pvcs()
                    if ns is None or p.namespace == ns]
        return self.store.list_objects(kind, ns)

    def _audit(self, user: str, verb: str, resource: str, ns: str, name: str,
               allowed: bool, reason: str = "") -> None:
        self.audit_log.append(
            AuditEvent(user, verb, resource, ns, name, allowed, reason)
        )
