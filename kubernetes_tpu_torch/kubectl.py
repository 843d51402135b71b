"""kubectl analog — the CLI/UX layer (SURVEY.md §1 layer 9).

reference: staging/src/k8s.io/kubectl/pkg/cmd/ — each verb is a cobra command
built on client-go.  Here each verb is a method on `Kubectl`, built on the
in-process APIServer facade (the full handler chain: authn → APF → RBAC →
admission → registry), so CLI requests are subject to the same security and
fair-queuing path as any other client.  `main()` wires a standalone in-process
cluster from manifest files for demo use; tests and the harness construct
`Kubectl` directly around a live cluster.

Implemented verbs (reference file in kubectl/pkg/cmd/<verb>/):
get, describe, apply, create, delete, scale, label, taint, cordon, uncordon,
drain (PDB-respecting eviction — the Eviction subresource's check), top,
rollout status, api-resources, auth can-i, events, version.

The port's copy of the JAX package's ``kubectl.py``, the same semantics with its imports
re-pointed at the port; tests/test_torch_*.py hold the two equal.
"""

from __future__ import annotations

import copy
import io
import shlex
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from .api import cluster as c
from .api import serialize as ser
from .api import types as t
from .scheduler.apiserver import APIServer, resource_of
from .scheduler.disruption import DisruptionController
from .scheduler.events import EventRecorder
from .scheduler.store import ClusterStore


class KubectlError(Exception):
    """Command failure; message is the user-facing error line."""


# word (plural/singular/shortname) -> store kind
_KIND_WORDS: Dict[str, str] = {}


def _register_words(kind: str, *words: str) -> None:
    for w in words:
        _KIND_WORDS[w.lower()] = kind


_register_words("Pod", "pod", "pods", "po")
_register_words("Node", "node", "nodes", "no")
_register_words("PDB", "poddisruptionbudget", "poddisruptionbudgets", "pdb", "pdbs")
_register_words("ReplicaSet", "replicaset", "replicasets", "rs")
_register_words("Deployment", "deployment", "deployments", "deploy")
_register_words("Job", "job", "jobs")
_register_words("StatefulSet", "statefulset", "statefulsets", "sts")
_register_words("DaemonSet", "daemonset", "daemonsets", "ds")
_register_words("CronJob", "cronjob", "cronjobs", "cj")
_register_words("Service", "service", "services", "svc")
_register_words("EndpointSlice", "endpointslice", "endpointslices", "eps")
_register_words("Namespace", "namespace", "namespaces", "ns")
_register_words("PriorityClass", "priorityclass", "priorityclasses", "pc")
_register_words("ResourceQuota", "resourcequota", "resourcequotas", "quota")
_register_words("LimitRange", "limitrange", "limitranges", "limits")
_register_words(
    "HorizontalPodAutoscaler", "horizontalpodautoscaler", "horizontalpodautoscalers", "hpa"
)
_register_words("Role", "role", "roles", "clusterrole", "clusterroles")
_register_words("RoleBinding", "rolebinding", "rolebindings",
                "clusterrolebinding", "clusterrolebindings")
_register_words("CustomResourceDefinition", "customresourcedefinition",
                "customresourcedefinitions", "crd", "crds")
_register_words("PV", "persistentvolume", "persistentvolumes", "pv")
_register_words("PVC", "persistentvolumeclaim", "persistentvolumeclaims", "pvc")
_register_words("StorageClass", "storageclass", "storageclasses", "sc")
_register_words("ResourceSlice", "resourceslice", "resourceslices")
_register_words("DeviceClass", "deviceclass", "deviceclasses")
_register_words("ResourceClaim", "resourceclaim", "resourceclaims")
_register_words("CertificateSigningRequest", "certificatesigningrequest",
                "certificatesigningrequests", "csr", "csrs")
_register_words("Event", "event", "events", "ev")
_register_words("FlowSchema", "flowschema", "flowschemas")
_register_words("PriorityLevelConfiguration", "prioritylevelconfiguration",
                "prioritylevelconfigurations")

# serializer kind -> store kind where they differ
_STORE_KIND = {
    "PodDisruptionBudget": "PDB",
    "PersistentVolume": "PV",
    "PersistentVolumeClaim": "PVC",
}
# kinds with no namespace column
_CLUSTER_SCOPED = {"Node", "Namespace", "PriorityClass", "PV", "StorageClass",
                   "ResourceSlice", "DeviceClass", "FlowSchema",
                   "PriorityLevelConfiguration", "CustomResourceDefinition",
                   "CertificateSigningRequest"}


def _singular(resource: str) -> str:
    """storageclasses -> storageclass, pods -> pod (the kubectl name printer)."""
    if resource.endswith("classes"):
        return resource[:-2]
    return resource[:-1] if resource.endswith("s") else resource


def resolve_kind(word: str, api=None) -> str:
    k = _KIND_WORDS.get(word.lower())
    if k is None and api is not None:
        # dynamic discovery: established CustomResourceDefinitions serve their
        # plural / kind / full name as resource words (the reference's
        # RESTMapper consults discovery the same way)
        crds = getattr(api, "crds", None)
        if crds is not None:
            w = word.lower()
            for crd in crds._by_kind.values():
                if w in (crd.plural.lower(), crd.kind.lower(), crd.name.lower()):
                    return crd.kind
    if k is None:
        raise KubectlError(f'the server doesn\'t have a resource type "{word}"')
    return k


def _store_kind(obj: object) -> str:
    kind = ser.kind_of(obj)
    return _STORE_KIND.get(kind, kind)


def _fmt_table(headers: Sequence[str], rows: Sequence[Sequence[str]]) -> str:
    if not rows:
        return "No resources found.\n"
    cols = [headers, *[[str(v) for v in r] for r in rows]]
    widths = [max(len(r[i]) for r in cols) for i in range(len(headers))]
    lines = [
        "   ".join(v.ljust(w) for v, w in zip(r, widths)).rstrip() for r in cols
    ]
    return "\n".join(lines) + "\n"


def _parse_flags(argv: List[str]) -> Tuple[List[str], Dict[str, object]]:
    """Split positional words from the small flag set kubectl verbs share."""
    pos: List[str] = []
    flags: Dict[str, object] = {}
    i = 0
    value_flags = {"-n": "namespace", "--namespace": "namespace",
                   "-o": "output", "--output": "output",
                   "-f": "filename", "--filename": "filename",
                   "-l": "selector", "--selector": "selector",
                   "--replicas": "replicas"}
    bool_flags = {"-A": "all_namespaces", "--all-namespaces": "all_namespaces",
                  "--force": "force", "--overwrite": "overwrite",
                  "--disable-eviction": "disable_eviction",
                  "--ignore-daemonsets": "ignore_daemonsets"}
    while i < len(argv):
        a = argv[i]
        if "=" in a and a.split("=", 1)[0] in value_flags:
            k, v = a.split("=", 1)
            flags[value_flags[k]] = v
        elif a in value_flags:
            if i + 1 >= len(argv):
                raise KubectlError(f"flag {a} needs a value")
            flags[value_flags[a]] = argv[i + 1]
            i += 1
        elif a in bool_flags:
            flags[bool_flags[a]] = True
        else:
            pos.append(a)
        i += 1
    return pos, flags


class Kubectl:
    def __init__(
        self,
        api: APIServer,
        token: str,
        recorder: Optional[EventRecorder] = None,
    ):
        self.api = api
        self.token = token
        self.recorder = recorder

    # ------------------------------------------------------------- dispatch
    def run(self, command) -> str:
        """Run one command (string or argv list) → its stdout text.
        Raises KubectlError with the user-facing message on failure."""
        argv = shlex.split(command) if isinstance(command, str) else list(command)
        if not argv:
            raise KubectlError("no command given")
        verb, rest = argv[0], argv[1:]
        handler = getattr(self, f"_cmd_{verb.replace('-', '_')}", None)
        if handler is None:
            raise KubectlError(f'unknown command "{verb}"')
        pos, flags = _parse_flags(rest)
        return handler(pos, flags)

    # ------------------------------------------------------------- helpers
    def _handle(self, verb: str, kind: str, obj=None, namespace="", name=""):
        from .scheduler.admission import AdmissionDenied
        from .scheduler.apiserver import Forbidden, Unauthenticated
        from .scheduler.flowcontrol import RequestRejected

        try:
            return self.api.handle(self.token, verb, kind, obj,
                                   namespace=namespace, name=name)
        except (Unauthenticated, Forbidden, AdmissionDenied, RequestRejected) as e:
            raise KubectlError(f"Error from server: {e}") from None

    def _ns(self, flags) -> Optional[str]:
        if flags.get("all_namespaces"):
            return None
        return flags.get("namespace", "default")

    def _get_required(self, kind: str, ns: str, name: str):
        obj = self._handle("get", kind, namespace=ns if kind not in _CLUSTER_SCOPED else "",
                           name=name)
        if obj is None:
            nsmsg = f' in namespace "{ns}"' if kind not in _CLUSTER_SCOPED else ""
            raise KubectlError(
                f'Error from server (NotFound): {resource_of(kind)} "{name}" not found{nsmsg}'
            )
        return obj

    # ------------------------------------------------------------------ get
    def _cmd_get(self, pos, flags):
        if not pos:
            raise KubectlError("get needs a resource type")
        kind = resolve_kind(pos[0], self.api)
        ns = self._ns(flags) if kind not in _CLUSTER_SCOPED else None
        if len(pos) > 1:
            objs = [self._get_required(kind, ns or "default", pos[1])]
        else:
            objs = list(self._handle("list", kind, namespace=ns or ""))
            if ns is not None and kind not in _CLUSTER_SCOPED:
                objs = [o for o in objs if getattr(o, "namespace", ns) == ns]
        sel = flags.get("selector")
        if sel:
            # key=value equality and bare-key existence terms, comma-ANDed
            def _matches(o) -> bool:
                labels = getattr(o, "labels", {})
                for term in sel.split(","):
                    if "=" in term:
                        k, v = term.split("=", 1)
                        if labels.get(k) != v:
                            return False
                    elif term not in labels:
                        return False
                return True

            objs = [o for o in objs if _matches(o)]
        out = flags.get("output", "")
        if out == "yaml":
            return ser.dump_yaml(objs if len(objs) != 1 else objs[0])
        if out == "json":
            import json

            docs = [ser.to_manifest(o) for o in objs]
            return json.dumps(docs[0] if len(docs) == 1 else
                              {"kind": "List", "items": docs}, indent=2) + "\n"
        if out == "name":
            return "".join(
                f"{_singular(resource_of(kind))}"
                f"/{o.name}\n" for o in objs)
        return self._table(kind, objs, wide=out == "wide")

    def _table(self, kind: str, objs, wide: bool = False) -> str:
        rows = []
        if kind == "Pod":
            headers = ["NAME", "STATUS", "NODE", "PRIORITY"]
            if wide:
                headers += ["IP", "NOMINATED"]
            for p in objs:
                status = p.phase or ("Running" if p.node_name else "Pending")
                r = [p.name, status, p.node_name or "<none>", p.priority]
                if wide:
                    r += [p.pod_ip or "<none>", p.nominated_node_name or "<none>"]
                rows.append(r)
            return _fmt_table(headers, rows)
        if kind == "Node":
            headers = ["NAME", "STATUS", "TAINTS", "CPU", "MEMORY"]
            for n in objs:
                status = "Ready,SchedulingDisabled" if n.unschedulable else "Ready"
                rows.append([n.name, status, len(n.taints),
                             n.allocatable.get("cpu", 0), n.allocatable.get("memory", 0)])
            return _fmt_table(headers, rows)
        if kind in ("ReplicaSet", "StatefulSet"):
            return _fmt_table(
                ["NAME", "DESIRED", "READY"],
                [[o.name, o.replicas, o.ready_replicas] for o in objs])
        if kind == "Deployment":
            store = self.api.store
            for d in objs:
                ready = sum(
                    rs.ready_replicas for rs in store.list_objects("ReplicaSet")
                    if any(ref.uid == d.uid for ref in rs.owner_references))
                rows.append([d.name, f"{ready}/{d.replicas}"])
            return _fmt_table(["NAME", "READY"], rows)
        if kind == "Job":
            return _fmt_table(
                ["NAME", "COMPLETIONS", "ACTIVE"],
                [[j.name, f"{j.succeeded}/{j.completions}", j.active] for j in objs])
        if kind == "Service":
            return _fmt_table(
                ["NAME", "CLUSTER-IP", "PORTS"],
                [[s.name, s.cluster_ip or "<none>",
                  ",".join(f"{p.port}/{p.protocol}" for p in s.ports) or "<none>"]
                 for s in objs])
        if kind == "PDB":
            return _fmt_table(
                ["NAME", "MIN-AVAILABLE", "MAX-UNAVAILABLE", "ALLOWED"],
                [[p.name,
                  p.min_available if p.min_available is not None else "N/A",
                  p.max_unavailable if p.max_unavailable is not None else "N/A",
                  p.disruptions_allowed] for p in objs])
        if kind == "PV":
            return _fmt_table(
                ["NAME", "CAPACITY", "STORAGECLASS", "CLAIM"],
                [[v.name, v.capacity, v.storage_class or "<none>",
                  v.claim_ref or "<unbound>"] for v in objs])
        if kind == "PVC":
            return _fmt_table(
                ["NAME", "STATUS", "VOLUME", "STORAGECLASS"],
                [[v.name, "Bound" if v.volume_name else "Pending",
                  v.volume_name or "<none>", v.storage_class or "<none>"] for v in objs])
        if kind == "Event":
            return _fmt_table(
                ["LAST SEEN", "COUNT", "REASON", "OBJECT", "NODE", "MESSAGE"],
                [[f"{e.last_seen:.0f}", e.count, e.reason, e.involved_object,
                  e.node or "", e.message]
                 for e in sorted(objs, key=lambda e: e.last_seen)])
        # generic fallback: NAME (+NAMESPACE)
        if kind in _CLUSTER_SCOPED:
            return _fmt_table(["NAME"], [[o.name] for o in objs])
        return _fmt_table(["NAMESPACE", "NAME"],
                          [[getattr(o, "namespace", ""), o.name] for o in objs])

    # ------------------------------------------------------------- describe
    def _cmd_describe(self, pos, flags):
        if len(pos) < 2:
            raise KubectlError("describe needs a resource type and a name")
        kind = resolve_kind(pos[0], self.api)
        ns = self._ns(flags) or "default"
        obj = self._get_required(kind, ns, pos[1])
        buf = io.StringIO()
        buf.write(f"Name:         {obj.name}\n")
        if kind not in _CLUSTER_SCOPED:
            buf.write(f"Namespace:    {getattr(obj, 'namespace', '')}\n")
        labels = getattr(obj, "labels", None)
        if labels is not None:
            buf.write("Labels:       "
                      + (",".join(f"{k}={v}" for k, v in sorted(labels.items()))
                         or "<none>") + "\n")
        body = ser.to_plain(obj)
        for skip in ("name", "namespace", "labels", "uid"):
            body.pop(skip, None)
        import yaml as _yaml

        if body:
            buf.write(_yaml.safe_dump(body, sort_keys=False, default_flow_style=None))
        if kind == "Pod" and self.recorder is not None:
            evs = [e for e in self.recorder.events if e.pod == obj.uid]
            if evs:
                buf.write("Events:\n")
                for e in evs[-10:]:
                    # reason + node + message (the diagnosis plane's
                    # "0/N nodes are available: …" lands here — the
                    # `kubectl describe pod` surface operators grep)
                    detail = "\t".join(x for x in (e.node, e.message) if x)
                    buf.write(f"  {e.reason}\t{detail}\n")
        return buf.getvalue()

    # --------------------------------------------------------- apply/create
    def _load_filename(self, flags) -> list:
        fn = flags.get("filename")
        if not fn:
            raise KubectlError("must specify -f")
        if fn == "-":
            text = sys.stdin.read()
        else:
            try:
                with open(fn) as fh:
                    text = fh.read()
            except OSError as e:
                raise KubectlError(str(e)) from None
        try:
            return ser.load_manifests(text)
        except (ser.DecodeError, ValueError) as e:
            raise KubectlError(f"error decoding {fn}: {e}") from None

    def _cmd_apply(self, pos, flags):
        lines = []
        for obj in self._load_filename(flags):
            kind = _store_kind(obj)
            ns = getattr(obj, "namespace", "")
            existing = self._handle("get", kind, namespace=ns, name=obj.name)
            verb = "update" if existing is not None else "create"
            self._handle(verb, kind, obj)
            what = "configured" if verb == "update" else "created"
            lines.append(f"{_singular(resource_of(kind))}/{obj.name} {what}\n")
        return "".join(lines)

    def _cmd_create(self, pos, flags):
        lines = []
        for obj in self._load_filename(flags):
            kind = _store_kind(obj)
            ns = getattr(obj, "namespace", "")
            if self._handle("get", kind, namespace=ns, name=obj.name) is not None:
                raise KubectlError(
                    f'Error from server (AlreadyExists): {resource_of(kind)} '
                    f'"{obj.name}" already exists')
            self._handle("create", kind, obj)
            lines.append(f"{_singular(resource_of(kind))}/{obj.name} created\n")
        return "".join(lines)

    # --------------------------------------------------------------- delete
    def _cmd_delete(self, pos, flags):
        targets: List[Tuple[str, str, str]] = []  # (kind, ns, name)
        if flags.get("filename"):
            for obj in self._load_filename(flags):
                targets.append((_store_kind(obj), getattr(obj, "namespace", ""), obj.name))
        else:
            if len(pos) < 2:
                raise KubectlError("delete needs a resource type and a name")
            kind = resolve_kind(pos[0], self.api)
            ns = (self._ns(flags) or "default") if kind not in _CLUSTER_SCOPED else ""
            targets.extend((kind, ns, name) for name in pos[1:])
        lines = []
        for kind, ns, name in targets:
            self._get_required(kind, ns, name)
            self._handle("delete", kind, namespace=ns, name=name)
            lines.append(f'{_singular(resource_of(kind))} "{name}" deleted\n')
        return "".join(lines)

    # ---------------------------------------------------------------- scale
    def _cmd_scale(self, pos, flags):
        if "replicas" not in flags:
            raise KubectlError("scale needs --replicas=N")
        n = int(flags["replicas"])  # type: ignore[arg-type]
        if not pos:
            raise KubectlError("scale needs a resource (kind/name)")
        if "/" in pos[0]:
            kw, name = pos[0].split("/", 1)
        elif len(pos) >= 2:
            kw, name = pos[0], pos[1]
        else:
            raise KubectlError("scale needs a resource (kind/name)")
        kind = resolve_kind(kw, self.api)
        if kind not in ("Deployment", "ReplicaSet", "StatefulSet"):
            raise KubectlError(f"cannot scale {resource_of(kind)}")
        ns = self._ns(flags) or "default"
        obj = copy.copy(self._get_required(kind, ns, name))
        obj.replicas = n
        self._handle("update", kind, obj)
        return f"{_singular(resource_of(kind))}/{name} scaled\n"

    # ------------------------------------------------------ cordon / uncordon
    def _set_unschedulable(self, name: str, value: bool) -> str:
        node = copy.copy(self._get_required("Node", "", name))
        already = node.unschedulable == value
        if not already:
            node.unschedulable = value
            self._handle("update", "Node", node)
        verb = "cordoned" if value else "uncordoned"
        return f"node/{name} {'already ' if already else ''}{verb}\n"

    def _cmd_cordon(self, pos, flags):
        if not pos:
            raise KubectlError("cordon needs a node name")
        return self._set_unschedulable(pos[0], True)

    def _cmd_uncordon(self, pos, flags):
        if not pos:
            raise KubectlError("uncordon needs a node name")
        return self._set_unschedulable(pos[0], False)

    # ---------------------------------------------------------------- drain
    def _cmd_drain(self, pos, flags):
        """cordon + evict all non-DaemonSet pods, honoring PDBs — the
        Eviction subresource's disruptions_allowed check (reference:
        pkg/registry/core/pod/storage/eviction.go)."""
        if not pos:
            raise KubectlError("drain needs a node name")
        name = pos[0]
        out = [self._set_unschedulable(name, True)]
        store = self.api.store
        # fresh PDB status before charging evictions
        DisruptionController(store).tick()
        budgets = {p.key: copy.copy(p) for p in store.list_pdbs()}
        for pod in store.list_pods():
            if pod.node_name != name:
                continue
            if any(ref.kind == "DaemonSet" for ref in pod.owner_references):
                if flags.get("ignore_daemonsets"):
                    continue
                raise KubectlError(
                    f"cannot delete DaemonSet-managed pod {pod.name} "
                    "(use --ignore-daemonsets)")
            if not flags.get("disable_eviction"):
                blocking = [p for p in budgets.values() if p.matches(pod)]
                if any(b.disruptions_allowed <= 0 for b in blocking):
                    raise KubectlError(
                        f"Cannot evict pod {pod.name}: violates PodDisruptionBudget "
                        + ",".join(b.name for b in blocking
                                   if b.disruptions_allowed <= 0))
                for b in blocking:
                    b.disruptions_allowed -= 1
                    store.update_pdb(b)
            self._handle("delete", "Pod", namespace=pod.namespace, name=pod.name)
            out.append(f'pod "{pod.name}" evicted\n')
        out.append(f"node/{name} drained\n")
        return "".join(out)

    # ---------------------------------------------------------------- taint
    def _cmd_taint(self, pos, flags):
        if len(pos) < 3 or resolve_kind(pos[0], self.api) != "Node":
            raise KubectlError("usage: taint nodes <name> key=value:Effect | key[:Effect]-")
        name = pos[1]
        node = copy.copy(self._get_required("Node", "", name))
        taints = list(node.taints)
        for spec in pos[2:]:
            if spec.endswith("-"):  # removal
                body = spec[:-1]
                key, _, effect = body.partition(":")
                key = key.split("=", 1)[0]
                taints = [tn for tn in taints
                          if not (tn.key == key and (not effect or tn.effect == effect))]
            else:
                kv, _, effect = spec.partition(":")
                if not effect:
                    raise KubectlError(f"invalid taint spec {spec!r} (need key[=value]:Effect)")
                key, _, value = kv.partition("=")
                taints = [tn for tn in taints
                          if not (tn.key == key and tn.effect == effect)]
                taints.append(t.Taint(key=key, value=value, effect=effect))
        node.taints = tuple(taints)
        self._handle("update", "Node", node)
        return f"node/{name} tainted\n"

    # ---------------------------------------------------------------- label
    def _cmd_label(self, pos, flags):
        if len(pos) < 3:
            raise KubectlError("usage: label <kind> <name> key=value | key-")
        kind = resolve_kind(pos[0], self.api)
        ns = (self._ns(flags) or "default") if kind not in _CLUSTER_SCOPED else ""
        obj = copy.copy(self._get_required(kind, ns, pos[1]))
        if not hasattr(obj, "labels"):
            raise KubectlError(f"{resource_of(kind)} have no labels")
        labels = dict(obj.labels)
        for spec in pos[2:]:
            if spec.endswith("-"):
                labels.pop(spec[:-1], None)
            else:
                if "=" not in spec:
                    raise KubectlError(f"invalid label spec {spec!r}")
                k, v = spec.split("=", 1)
                if k in labels and labels[k] != v and not flags.get("overwrite"):
                    raise KubectlError(
                        f"'{k}' already has a value ({labels[k]}); use --overwrite")
                labels[k] = v
        obj.labels = labels
        self._handle("update", kind, obj)
        return f"{_singular(resource_of(kind))}/{pos[1]} labeled\n"

    # ------------------------------------------------------------------ top
    def _cmd_top(self, pos, flags):
        """`top nodes` / `top pods` from the scheduling surface: requested
        resources (there is no metrics-server; requests are the deterministic
        analog the scheduler itself reasons about)."""
        if not pos:
            raise KubectlError("top needs `nodes` or `pods`")
        what = resolve_kind(pos[0], self.api)
        store = self.api.store
        if what == "Node":
            used: Dict[str, Dict[str, int]] = {}
            for p in store.list_pods():
                if p.node_name:
                    u = used.setdefault(p.node_name, {})
                    for r, q in p.requests.items():
                        u[r] = u.get(r, 0) + q
            rows = []
            for n in sorted(store.list_nodes(), key=lambda n: n.name):
                u = used.get(n.name, {})
                cpu, mem = u.get("cpu", 0), u.get("memory", 0)
                ca, ma = n.allocatable.get("cpu", 0), n.allocatable.get("memory", 0)
                rows.append([
                    n.name, cpu, f"{100 * cpu // ca if ca else 0}%",
                    mem, f"{100 * mem // ma if ma else 0}%",
                ])
            return _fmt_table(["NAME", "CPU(req)", "CPU%", "MEMORY(req)", "MEMORY%"], rows)
        if what == "Pod":
            ns = self._ns(flags)
            rows = [[p.name, p.requests.get("cpu", 0), p.requests.get("memory", 0)]
                    for p in sorted(store.list_pods(), key=lambda p: p.name)
                    if ns is None or p.namespace == ns]
            return _fmt_table(["NAME", "CPU(req)", "MEMORY(req)"], rows)
        raise KubectlError("top supports `nodes` and `pods`")

    # -------------------------------------------------------------- rollout
    def _cmd_rollout(self, pos, flags):
        if len(pos) < 2 or pos[0] != "status":
            raise KubectlError("usage: rollout status deployment/<name>")
        if "/" in pos[1]:
            kw, name = pos[1].split("/", 1)
        elif len(pos) >= 3:
            kw, name = pos[1], pos[2]
        else:
            raise KubectlError("usage: rollout status deployment/<name>")
        if resolve_kind(kw, self.api) != "Deployment":
            raise KubectlError("rollout status supports deployments")
        ns = self._ns(flags) or "default"
        d = self._get_required("Deployment", ns, name)
        store = self.api.store
        owned = [rs for rs in store.list_objects("ReplicaSet")
                 if any(ref.uid == d.uid for ref in rs.owner_references)]
        ready = sum(rs.ready_replicas for rs in owned)
        if ready >= d.replicas and all(
            rs.ready_replicas >= rs.replicas for rs in owned
        ):
            return f'deployment "{name}" successfully rolled out\n'
        return (f"Waiting for deployment {name!r} rollout to finish: "
                f"{ready} of {d.replicas} updated replicas are available...\n")

    # -------------------------------------------------------- api-resources
    def _cmd_api_resources(self, pos, flags):
        shortnames: Dict[str, List[str]] = {}
        for w, k in _KIND_WORDS.items():
            if len(w) <= 6 and w != resource_of(k) and not w.endswith("s"):
                shortnames.setdefault(k, []).append(w)
        rows = []
        for kind in sorted(set(_KIND_WORDS.values())):
            rows.append([resource_of(kind), ",".join(sorted(shortnames.get(kind, []))),
                         "false" if kind in _CLUSTER_SCOPED else "true", kind])
        return _fmt_table(["NAME", "SHORTNAMES", "NAMESPACED", "KIND"], rows)

    # ------------------------------------------------------------ auth can-i
    def _cmd_auth(self, pos, flags):
        if len(pos) < 3 or pos[0] != "can-i":
            raise KubectlError("usage: auth can-i <verb> <resource>")
        user = self.api.authn.authenticate(self.token)
        if user is None:
            raise KubectlError("Error from server: invalid or missing bearer token")
        verb, res = pos[1], pos[2]
        try:
            res = resource_of(resolve_kind(res, self.api))
        except KubectlError:
            pass  # raw resource word
        ns = flags.get("namespace", "")
        ok = self.api.authz.authorize(user, verb, res, ns, "")
        return ("yes" if ok else "no") + "\n"

    # ---------------------------------------------------------------- events
    def _cmd_events(self, pos, flags):
        # Event API objects first (what the scheduler's recorder publishes);
        # a raw recorder is the fallback for recorder-only wiring
        ns = self._ns(flags)
        objs = list(self._handle("list", "Event", namespace=ns or ""))
        if ns is not None:
            objs = [e for e in objs if e.namespace == ns]
        if objs:
            return self._table("Event", objs)
        if self._handle("list", "Event") or self.recorder is None:
            # Event objects exist, just none in the requested namespace —
            # the raw recorder has no namespace filter, don't dump it all
            return "No events.\n"
        rows = [[e.reason, e.pod, e.node or "", e.message]
                for e in self.recorder.events[-200:]]
        return _fmt_table(["REASON", "OBJECT", "NODE", "MESSAGE"], rows)

    def _cmd_version(self, pos, flags):
        from . import __version__

        return f"kubernetes_tpu_torch kubectl {__version__}\n"


# --------------------------------------------------------------- standalone


def make_admin_kubectl(store: Optional[ClusterStore] = None,
                       recorder: Optional[EventRecorder] = None) -> Kubectl:
    """An APIServer + admin token + Kubectl around a (new or given) store —
    the "kubeconfig with cluster-admin" of the in-process world."""
    from .scheduler.auth import TokenAuthenticator

    store = store or ClusterStore()
    authn = TokenAuthenticator()
    authn.add_token("admin-token", "admin", groups=("system:masters",))
    api = APIServer(store, authenticator=authn)
    return Kubectl(api, "admin-token", recorder=recorder)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    manifests = None
    if argv[:1] == ["--manifests"]:
        manifests = argv[1]
        argv = argv[2:]
    kc = make_admin_kubectl()
    if manifests:
        with open(manifests) as fh:
            for obj in ser.load_manifests(fh.read()):
                kc.api.handle(kc.token, "create", _store_kind(obj), obj)
    try:
        sys.stdout.write(kc.run(argv))
        return 0
    except KubectlError as e:
        sys.stderr.write(f"error: {e}\n")
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
