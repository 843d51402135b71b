"""Manifest codec — typed objects ↔ plain dicts ↔ YAML/JSON.

The apimachinery serializer analog (reference:
staging/src/k8s.io/apimachinery/pkg/runtime/serializer/ — the universal
decoder resolves a document's `kind` through the Scheme to a typed object;
encoding round-trips it back).  This framework's Scheme is the KINDS registry
below: one entry per API kind, mapping to the dataclass that models it.

Differences from the reference, by design:
- single version (no conversion webbing — there is one hub type per kind);
- field names are this framework's snake_case scheduling-surface names, not
  the reference's nested spec/status JSON (api/types.py documents the
  reduction);
- decoding is strict (unknown fields are errors), like the reference's
  `strictDecodingError`.

Tuple-of-pairs fields (e.g. Pod.node_selector, LabelSelector.match_labels)
additionally accept YAML mappings for hand-written manifests:
`node_selector: {disk: ssd}` ≡ `node_selector: [[disk, ssd]]`.

The port's copy of the JAX package's ``api/serialize.py``, the same semantics with its imports
re-pointed at the port; tests/test_torch_*.py hold the two equal.  PyYAML
is imported only inside dump_yaml / load_yaml: the JSON path (load_json,
load_manifests on a JSON file, dump_json) needs no YAML parser.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple, Union, get_args, get_origin, get_type_hints

from . import cluster as c
from . import types as t

# The Scheme: kind name -> dataclass.  (reference: runtime.Scheme — AddKnownTypes)
KINDS: Dict[str, type] = {
    "Pod": t.Pod,
    "Node": t.Node,
    "PodDisruptionBudget": t.PodDisruptionBudget,
    "PodGroup": t.PodGroup,
    "PersistentVolume": t.PersistentVolume,
    "PersistentVolumeClaim": t.PersistentVolumeClaim,
    "ReplicaSet": t.ReplicaSet,
    "Deployment": t.Deployment,
    "Job": t.Job,
    "Service": c.Service,
    "EndpointSlice": c.EndpointSlice,
    "Namespace": c.Namespace,
    "PriorityClass": c.PriorityClass,
    "ResourceQuota": c.ResourceQuota,
    "LimitRange": c.LimitRange,
    "StatefulSet": c.StatefulSet,
    "DaemonSet": c.DaemonSet,
    "CronJob": c.CronJob,
    "HorizontalPodAutoscaler": c.HorizontalPodAutoscaler,
    "Role": c.Role,
    "RoleBinding": c.RoleBinding,
    "FlowSchema": c.FlowSchema,
    "PriorityLevelConfiguration": c.PriorityLevelConfiguration,
    "StorageClass": c.StorageClass,
    "ResourceSlice": c.ResourceSlice,
    "DeviceClass": c.DeviceClass,
    "ResourceClaim": c.ResourceClaim,
    "CertificateSigningRequest": c.CertificateSigningRequest,
    "Event": c.ClusterEvent,
    "ServiceAccount": c.ServiceAccount,
}


def _register_crd_kinds() -> None:
    """CustomResourceDefinition joins the Scheme lazily (scheduler.crd imports
    api modules; a top-level import here would be circular)."""
    from ..scheduler.crd import CustomResourceDefinition

    KINDS.setdefault("CustomResourceDefinition", CustomResourceDefinition)
    _CLASS_TO_KIND.setdefault(CustomResourceDefinition, "CustomResourceDefinition")



# aliases accepted on decode (the store's table name for PodDisruptionBudget)
_KIND_ALIASES = {"PDB": "PodDisruptionBudget"}

_CLASS_TO_KIND: Dict[type, str] = {cls: k for k, cls in KINDS.items()}


class DecodeError(ValueError):
    """Strict-decoding failure (unknown kind/field, wrong shape)."""


def kind_of(obj: object) -> str:
    k = _CLASS_TO_KIND.get(type(obj))
    if k is None:
        # dynamic kinds (CustomResource instances, the CRD object itself)
        # carry their kind on the object — the unstructured path
        k = getattr(obj, "kind", None)
        if isinstance(k, str) and k:
            return k
        raise DecodeError(f"{type(obj).__name__} is not a registered kind")
    return k


# ------------------------------------------------------------------- encoding


def to_plain(obj):
    """Dataclass → JSON-able plain value, omitting default-valued fields
    (the reference's `omitempty` behavior)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out = {}
        for f in dataclasses.fields(obj):
            val = getattr(obj, f.name)
            if f.default is not dataclasses.MISSING and val == f.default:
                continue
            if (
                f.default_factory is not dataclasses.MISSING  # type: ignore[misc]
                and val == f.default_factory()  # type: ignore[misc]
            ):
                continue
            out[f.name] = to_plain(val)
        return out
    if isinstance(obj, (list, tuple)):
        return [to_plain(v) for v in obj]
    if isinstance(obj, dict):
        return {k: to_plain(v) for k, v in obj.items()}
    return obj


def to_manifest(obj) -> dict:
    return {"kind": kind_of(obj), **to_plain(obj)}


def dump_yaml(objs) -> str:
    """One or many objects → (multi-document) YAML manifest."""
    import yaml

    if dataclasses.is_dataclass(objs) and not isinstance(objs, type):
        objs = [objs]
    return yaml.safe_dump_all(
        [to_manifest(o) for o in objs], sort_keys=False, default_flow_style=None
    )


def dump_json(obj) -> str:
    return json.dumps(to_manifest(obj), indent=2)


# ------------------------------------------------------------------- decoding


def _is_pair_tuple(tp) -> bool:
    """Tuple[Tuple[str, X], ...] — the tuple-of-pairs shape that may be
    written as a mapping in manifests."""
    args = get_args(tp)
    if len(args) != 2 or args[1] is not Ellipsis:
        return False
    inner = get_args(args[0])
    return get_origin(args[0]) in (tuple, Tuple) and len(inner) == 2


def _coerce(tp, val, path: str):
    if val is None:
        return None
    origin = get_origin(tp)
    if origin is Union:  # Optional[X]
        inner = [a for a in get_args(tp) if a is not type(None)]
        return _coerce(inner[0], val, path)
    if dataclasses.is_dataclass(tp):
        if isinstance(val, tp):
            return val
        if not isinstance(val, dict):
            raise DecodeError(f"{path}: expected mapping for {tp.__name__}")
        return from_plain(tp, val, path)
    if origin in (tuple, Tuple):
        args = get_args(tp)
        if isinstance(val, dict):
            if not _is_pair_tuple(tp):
                raise DecodeError(f"{path}: mapping not allowed here")
            return tuple(sorted((str(k), _coerce(get_args(args[0])[1], v, path))
                                for k, v in val.items()))
        if not isinstance(val, (list, tuple)):
            raise DecodeError(f"{path}: expected sequence")
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_coerce(args[0], v, f"{path}[{i}]")
                         for i, v in enumerate(val))
        if len(args) != len(val):
            raise DecodeError(f"{path}: expected {len(args)} items, got {len(val)}")
        return tuple(_coerce(a, v, f"{path}[{i}]")
                     for i, (a, v) in enumerate(zip(args, val)))
    if origin is dict:
        args = get_args(tp)
        if not args:  # bare Dict: free-form mapping (CRD structural schemas)
            if not isinstance(val, dict):
                raise DecodeError(f"{path}: expected mapping")
            return dict(val)
        kt, vt = args
        if not isinstance(val, dict):
            raise DecodeError(f"{path}: expected mapping")
        return {_coerce(kt, k, path): _coerce(vt, v, f"{path}.{k}")
                for k, v in val.items()}
    if tp is float and isinstance(val, int):
        return float(val)
    return val


def from_plain(cls: type, data: dict, path: str = ""):
    """Plain dict → dataclass instance; strict about unknown fields."""
    path = path or cls.__name__
    hints = get_type_hints(cls)
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - names
    if unknown:
        raise DecodeError(f"{path}: unknown field(s) {sorted(unknown)}")
    kwargs = {k: _coerce(hints[k], v, f"{path}.{k}") for k, v in data.items()}
    try:
        return cls(**kwargs)
    except TypeError as e:  # missing required field
        raise DecodeError(f"{path}: {e}") from None


def from_manifest(doc: dict):
    _register_crd_kinds()
    doc = dict(doc)
    api_version = doc.pop("apiVersion", None)  # single-version scheme
    kind = doc.pop("kind", None)
    if not kind:
        raise DecodeError("manifest document has no `kind`")
    kind = _KIND_ALIASES.get(kind, kind)
    if kind == "CustomResourceDefinition" and "names" in doc:
        # the manifest's top-level `kind` is the TYPE discriminator; the
        # CRD's target kind/plural ride in the reference's names block
        # (apiextensions/v1 — CustomResourceDefinitionNames)
        names = dict(doc.pop("names") or {})
        doc.setdefault("kind", names.get("kind", ""))
        doc.setdefault("plural", names.get("plural", ""))
    cls = KINDS.get(kind)
    if cls is None:
        # group-qualified apiVersion + unregistered kind = a custom resource:
        # decode unstructured (apiextensions' Unstructured path); the server
        # validates spec against the CRD's structural schema on write
        if isinstance(api_version, str) and "/" in api_version:
            from ..scheduler.crd import CustomResource

            unknown = set(doc) - {"name", "namespace", "labels", "spec"}
            if unknown:
                raise DecodeError(
                    f"unknown field(s) {sorted(unknown)} on custom kind {kind!r}"
                )
            return CustomResource(
                api_version=api_version,
                kind=kind,
                name=doc.get("name", ""),
                namespace=doc.get("namespace", "default"),
                labels=dict(doc.get("labels") or {}),
                spec=dict(doc.get("spec") or {}),
            )
        raise DecodeError(f"unknown kind {kind!r}")
    return from_plain(cls, doc)


def load_yaml(text: str) -> list:
    """Multi-document YAML manifest → typed objects.  A document of kind
    `List` (or bearing `items`) is flattened, like the reference's v1.List."""
    import yaml

    return _decode_docs(yaml.safe_load_all(text))


def load_json(text: str) -> list:
    """A JSON manifest (one document, or a list of them) → typed objects,
    flattened as load_yaml flattens; needs no YAML parser."""
    doc = json.loads(text)
    return _decode_docs(doc if isinstance(doc, list) else [doc])


def load_manifests(text: str) -> list:
    """A manifest file's text → typed objects: JSON (its first character
    `{` or `[`) without PyYAML, any other text as YAML."""
    if text.lstrip()[:1] in ("{", "["):
        return load_json(text)
    return load_yaml(text)


def _decode_docs(docs) -> list:
    out = []
    for doc in docs:
        if doc is None:
            continue
        if isinstance(doc, dict) and (doc.get("kind") == "List" or "items" in doc):
            out.extend(from_manifest(d) for d in doc.get("items", []))
        else:
            out.append(from_manifest(doc))
    return out
