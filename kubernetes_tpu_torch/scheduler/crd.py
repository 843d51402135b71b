"""CustomResourceDefinition machinery — the apiextensions-apiserver analog.

reference: staging/src/k8s.io/apiextensions-apiserver — a CRD object
(customresourcedefinitions.apiextensions.k8s.io) declares group/names/scope
plus a list of VERSIONS, each with a structural OpenAPI v3 schema and
served/storage flags; established CRDs get REST storage wired into the same
generic registry the built-ins use (pkg/apiserver/customresource_handler.go),
every write is validated against the version's structural schema
(pkg/apiserver/validation), and objects persist at the single storage version
(conversion strategy None = field-preserving apiVersion rewrite).

Here: `CRDRegistry` owns the definitions, validates custom objects on
create/update through the APIServer's admission phase, rejects unserved
versions, and rewrites api_version to the storage version — on top of
store.register_kind's dynamic tables (the shared generic-registry layer).

The port's copy of the JAX package's ``scheduler/crd.py``, the same semantics with its imports
re-pointed at the port; tests/test_torch_*.py hold the two equal.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


class CRDInvalid(Exception):
    """Definition rejected at create time (apiextensions validation)."""


class CRValidationError(Exception):
    """Custom object rejected by the version's structural schema."""


@dataclass(frozen=True)
class CRDVersion:
    """apiextensions/v1 — CustomResourceDefinitionVersion (reduced)."""

    name: str  # e.g. "v1alpha1"
    served: bool = True
    storage: bool = False
    # reduced structural OpenAPI v3: {"type": "object", "properties": {...},
    # "required": [...]}; nested properties/items/enum/minimum/maximum/
    # pattern-free subset
    schema: Optional[Dict] = None


@dataclass
class CustomResourceDefinition:
    """apiextensions/v1 — CustomResourceDefinition (scheduling-framework
    surface: names, scope, versions; no webhook conversion — strategy None)."""

    group: str
    kind: str
    plural: str
    versions: Tuple[CRDVersion, ...] = ()
    scope: str = "Namespaced"  # or "Cluster"
    namespace: str = ""  # cluster-scoped object itself
    established: bool = False  # status condition, set on successful create

    @property
    def name(self) -> str:
        return f"{self.plural}.{self.group}"

    @property
    def key(self) -> str:
        return self.name

    def storage_version(self) -> str:
        return next(v.name for v in self.versions if v.storage)

    def version(self, name: str) -> Optional[CRDVersion]:
        return next((v for v in self.versions if v.name == name), None)


@dataclass
class CustomResource:
    """A dynamic object instance (unstructured.Unstructured reduced):
    identity + free-form spec dict, validated by the CRD's schema."""

    api_version: str  # "group/version"
    kind: str
    name: str
    namespace: str = "default"
    labels: Dict[str, str] = field(default_factory=dict)
    spec: Dict = field(default_factory=dict)

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}" if self.namespace else self.name


_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "boolean": bool,
    # integer checked specially (bool is an int subclass); number accepts both
}


def validate_schema_value(schema: Dict, value, path: str = "spec") -> List[str]:
    """Structural-schema validation (the pkg/apiserver/validation subset):
    type, properties, required, items, enum, minimum/maximum.  Returns a list
    of error strings (empty = valid)."""
    errs: List[str] = []
    ty = schema.get("type")
    if ty == "integer":
        if not isinstance(value, int) or isinstance(value, bool):
            return [f"{path}: expected integer, got {type(value).__name__}"]
    elif ty == "number":
        if not isinstance(value, (int, float)) or isinstance(value, bool):
            return [f"{path}: expected number, got {type(value).__name__}"]
    elif ty in _TYPES:
        if not isinstance(value, _TYPES[ty]):
            return [f"{path}: expected {ty}, got {type(value).__name__}"]
    if "enum" in schema and value not in schema["enum"]:
        errs.append(f"{path}: {value!r} not in enum {schema['enum']}")
    if "minimum" in schema and isinstance(value, (int, float)) and value < schema["minimum"]:
        errs.append(f"{path}: {value} < minimum {schema['minimum']}")
    if "maximum" in schema and isinstance(value, (int, float)) and value > schema["maximum"]:
        errs.append(f"{path}: {value} > maximum {schema['maximum']}")
    if ty == "object" and isinstance(value, dict):
        props = schema.get("properties", {})
        for req in schema.get("required", ()):
            if req not in value:
                errs.append(f"{path}.{req}: required field missing")
        for k, v in value.items():
            sub = props.get(k)
            if sub is None:
                # structural schemas prune unknown fields unless
                # x-kubernetes-preserve-unknown-fields; we REJECT (strictest)
                if not schema.get("x-kubernetes-preserve-unknown-fields"):
                    errs.append(f"{path}.{k}: unknown field")
            else:
                errs.extend(validate_schema_value(sub, v, f"{path}.{k}"))
    if ty == "array" and isinstance(value, list) and "items" in schema:
        for i, v in enumerate(value):
            errs.extend(validate_schema_value(schema["items"], v, f"{path}[{i}]"))
    return errs


class CRDRegistry:
    """Owns definitions; the APIServer consults it on every write to a
    registered custom kind (the customresource_handler analog)."""

    KIND = "CustomResourceDefinition"

    def __init__(self, store):
        self.store = store
        store.register_kind(self.KIND)
        self._by_kind: Dict[str, CustomResourceDefinition] = {}

    # -- definition lifecycle --
    def create(self, crd: CustomResourceDefinition) -> CustomResourceDefinition:
        if not crd.versions:
            raise CRDInvalid("at least one version required")
        storages = [v for v in crd.versions if v.storage]
        if len(storages) != 1:
            raise CRDInvalid("exactly one storage version required")
        if not any(v.served for v in crd.versions):
            raise CRDInvalid("at least one served version required")
        names = {v.name for v in crd.versions}
        if len(names) != len(crd.versions):
            raise CRDInvalid("duplicate version names")
        from .store import BUILTIN_KINDS

        reserved = {"Node", "Pod", "PDB", "PV", "PVC", self.KIND, *BUILTIN_KINDS}
        if crd.kind in reserved or not crd.kind:
            raise CRDInvalid(f"kind {crd.kind!r} conflicts with a built-in")
        existing = self._by_kind.get(crd.kind)
        if existing is not None and existing.name != crd.name:
            raise CRDInvalid(f"kind {crd.kind!r} already owned by {existing.name}")
        self.store.register_kind(crd.kind)
        crd.established = True  # Established condition: storage is wired
        self.store.add_object(self.KIND, crd)
        self._by_kind[crd.kind] = crd
        return crd

    def delete(self, name: str) -> None:
        """Dropping a CRD deletes its instances (the reference's CR garbage
        collection on CRD deletion) — the dynamic table stays registered but
        empty (tables are cheap; kind re-creation re-establishes)."""
        crd = next((c for c in self._by_kind.values() if c.name == name), None)
        if crd is None:
            return
        for obj in list(self.store.list_objects(crd.kind)):
            self.store.delete_object(crd.kind, obj.key)
        self.store.delete_object(self.KIND, name)
        del self._by_kind[crd.kind]

    def definition_for(self, kind: str) -> Optional[CustomResourceDefinition]:
        return self._by_kind.get(kind)

    # -- custom-object admission --
    def admit(self, obj: CustomResource) -> CustomResource:
        """Validate a custom object write: version must be served, spec must
        pass that version's structural schema; the stored copy carries the
        STORAGE version (conversion strategy None — field passthrough)."""
        crd = self._by_kind.get(obj.kind)
        if crd is None:
            raise CRValidationError(f"no CustomResourceDefinition for kind {obj.kind!r}")
        _, _, vname = obj.api_version.partition("/")
        ver = crd.version(vname or obj.api_version)
        if ver is None:
            raise CRValidationError(
                f"unknown version {obj.api_version!r} for {crd.name}"
            )
        if not ver.served:
            raise CRValidationError(f"version {ver.name} of {crd.name} is not served")
        if ver.schema is not None:
            errs = validate_schema_value(ver.schema, obj.spec)
            if errs:
                raise CRValidationError("; ".join(errs))
        storage = crd.storage_version()
        if (vname or obj.api_version) != storage:
            obj.api_version = f"{crd.group}/{storage}"
        return obj
