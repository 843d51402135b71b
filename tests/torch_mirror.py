"""Run a test of the JAX package's control plane in both packages and record
what each side saw (tests/test_torch_apiserver.py, _controllers.py,
_kubelet.py, _kubectl.py and _extender.py).

A case is one test function of a JAX test module (tests/test_apiserver.py,
test_controllers.py, ...).  ``run_both(case, tmp_path)`` runs it twice in
this process:

- the JAX side: the module's source as it is, in a private module;
- the port's side: the same source with every ``kubernetes_tpu`` import
  re-pointed at ``kubernetes_tpu_torch``, and ``helpers`` (tests/helpers.py,
  whose builders make the JAX package's objects) replaced by its builders
  with their objects carried across by convert.from_jax_objects.  An
  entry point given no device (the Scheduler's batch cycle, an encoder,
  schedule_batch) runs on the CPU, as if given device="cpu", as
  tests/torch_scheduler_sides.py's port side runs them.

Each run must pass the test's own assertions.  Meanwhile a recorder notes,
in order, every APIServer.handle (the verb, the kind, and the returned
objects or the raised error's class and message: 401 / 403 / APF
rejections / admission denials), every Kubectl.run (its output text or
error), every AdmissionChain.run and every RBACAuthorizer.authorize, and at
the end it dumps every ClusterStore the test made (each table, the
dedicated ones too: nodes, pods by namespace/name, PDBs, PVs and PVCs;
every object field by field, and the resource version).  ``run_both`` returns the
two recordings; the tests hold them equal, exactly.

Fields that hold wall-clock time are left out of the dumps, an instant a
component stamps from its clock is compared as stamped or not, a loopback
server's port is read as PORT, each side's temporary directory as TMP,
and tracing ids are never read.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import importlib
import inspect
import re
import sys
import types
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent

_WALL_FIELDS = frozenset({"ts", "timestamp", "wall", "saved_wall"})
# instants a component stamps from its clock (the real one unless a test
# passes a FakeClock): compared as stamped or not
_CLOCK_FIELDS = frozenset({"first_seen", "last_seen", "created_at", "finished_at", "completion_time",
                           "last_schedule_time", "renew_time"})
# each side's loopback servers listen on ports of their own
_LOOPBACK = re.compile(r"127\.0\.0\.1:\d+")
_TMP: list = []  # the running side's temporary directory, read as TMP


def cases(*modules: str):
    """pytest params (one per test function of each JAX test module, in
    file order), with ids 'module::test'."""
    out = []
    for name in modules:
        src = (TESTS / f"{name}.py").read_text()
        for fn in re.findall(r"^def (test_\w+)\(", src, re.M):
            out.append(pytest.param((name, fn), id=f"{name}::{fn}"))
    return out


def _port_helpers():
    """tests/helpers.py with every builder's objects carried into the port."""
    import helpers
    from kubernetes_tpu_torch.convert import from_jax_objects

    mod = types.ModuleType("_port_helpers")
    for k, v in vars(helpers).items():
        if inspect.isfunction(v) and v.__module__ == helpers.__name__:
            mod.__dict__[k] = (lambda f: lambda *a, **kw: from_jax_objects(f(*a, **kw)))(v)
        else:
            mod.__dict__[k] = v
    return mod


_LOADED: dict = {}


def load(name: str, side: str, subst: tuple = ()):
    """The JAX test module `name` as a private module of `side`, with each
    (old, new) of `subst` replaced in its source first."""
    key = (name, side, subst)
    if key not in _LOADED:
        src = (TESTS / f"{name}.py").read_text()
        for old, new in subst:
            assert old in src, old
            src = src.replace(old, new)
        if side == "port":
            src = re.sub(r"\bkubernetes_tpu\b(?!_torch)", "kubernetes_tpu_torch", src)
            src = re.sub(r"^from helpers import", "from _port_helpers import", src, flags=re.M)
        mod = types.ModuleType(f"_mirror_{side}_{name}_{len(_LOADED)}")
        mod.__file__ = str(TESTS / f"{name}.py")
        if side == "port" and "_port_helpers" not in sys.modules:
            sys.modules["_port_helpers"] = _port_helpers()
        sys.modules[mod.__name__] = mod  # dataclasses defined in a test look their module up
        exec(compile(src, mod.__file__, "exec"), mod.__dict__)
        _LOADED[key] = mod
    return _LOADED[key]


def canon(x):
    """A comparable value: dataclasses field by field (with their class
    name), containers element by element, exceptions as (class, message),
    enums by value, arrays and tensors element by element.  Any other type
    raises, so that no value is compared by its type alone."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {
            f.name: (getattr(x, f.name) > 0) if f.name in _CLOCK_FIELDS else canon(getattr(x, f.name))
            for f in dataclasses.fields(x) if f.name not in _WALL_FIELDS})
    if isinstance(x, dict):
        return {str(k): canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [canon(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted(repr(canon(v)) for v in x)
    if isinstance(x, BaseException):
        return ("raised", type(x).__name__, canon(str(x)))
    if isinstance(x, str):
        return _LOOPBACK.sub("127.0.0.1:PORT", x.replace(_TMP[0], "TMP") if _TMP else x)
    if isinstance(x, enum.Enum):
        return (type(x).__name__, canon(x.value))
    if x is None or isinstance(x, (int, float, bool)):
        return x
    if callable(getattr(x, "tolist", None)) and hasattr(x, "shape"):
        return (type(x).__name__, list(x.shape), x.tolist())  # numpy / jax arrays, torch tensors
    raise TypeError(f"canon: no comparison for {type(x).__module__}.{type(x).__qualname__}")


class Recorder:
    def __init__(self):
        self.calls: list = []
        self.stores: list = []

    def wrap(self, stack, cls, name, label, args_of):
        orig = getattr(cls, name)
        rec = self

        def wrapped(self_, *a, **kw):
            try:
                out = orig(self_, *a, **kw)
            except BaseException as e:  # noqa: BLE001  (recorded, then re-raised)
                rec.calls.append((label, args_of(a, kw), canon(e)))
                raise
            rec.calls.append((label, args_of(a, kw), canon(out)))
            return out

        setattr(cls, name, wrapped)
        stack.callback(setattr, cls, name, orig)

    def dump(self):
        out = []
        for s in self.stores:
            with s._lock:
                tables = {k: {key: canon(obj) for key, obj in sorted(tbl.items())}
                          for k, tbl in sorted(s.objects.items())}
                # the dedicated tables; pods by namespace/name, not uid
                pods = {f"{p.namespace}/{p.name}": p for p in s.pods.values()}
                assert len(pods) == len(s.pods), "two pods share a namespace/name"
                for k, tbl in (("Node", s.nodes), ("Pod", pods), ("PDB", s.pdbs), ("PV", s.pvs),
                               ("PVC", s.pvcs)):
                    tables[k] = {key: canon(obj) for key, obj in sorted(tbl.items())}
            out.append({"rv": s._rv, "tables": tables})
        return out


@contextlib.contextmanager
def recording(side: str):
    pkg = "kubernetes_tpu" if side == "jax" else "kubernetes_tpu_torch"
    store_mod = importlib.import_module(f"{pkg}.scheduler.store")
    api_mod = importlib.import_module(f"{pkg}.scheduler.apiserver")
    adm_mod = importlib.import_module(f"{pkg}.scheduler.admission")
    auth_mod = importlib.import_module(f"{pkg}.scheduler.auth")
    kubectl_mod = importlib.import_module(f"{pkg}.kubectl")
    rec = Recorder()
    with contextlib.ExitStack() as stack:
        init = store_mod.ClusterStore.__init__

        def store_init(self_, *a, **kw):
            init(self_, *a, **kw)
            rec.stores.append(self_)

        store_mod.ClusterStore.__init__ = store_init
        stack.callback(setattr, store_mod.ClusterStore, "__init__", init)
        rec.wrap(stack, api_mod.APIServer, "handle", "handle", lambda a, kw: (canon(a), canon(kw)))
        rec.wrap(stack, kubectl_mod.Kubectl, "run", "kubectl", lambda a, kw: canon(a[0]) if a else None)
        rec.wrap(stack, adm_mod.AdmissionChain, "run", "admit", lambda a, kw: canon(a[0].kind))
        rec.wrap(stack, auth_mod.RBACAuthorizer, "authorize", "authorize", lambda a, kw: (canon(a), canon(kw)))
        if side == "port":
            # no card here: an entry point given no device runs on the CPU
            dev_mod = importlib.import_module(f"{pkg}.device")
            resolve = dev_mod.resolve_device

            def on_cpu(device=None):
                return resolve("cpu" if device is None else device)

            def swap(old, new):
                for mod in [m for k, m in sys.modules.items() if k.startswith(pkg + ".") and m is not None]:
                    if getattr(mod, "resolve_device", None) is old:
                        setattr(mod, "resolve_device", new)

            for name in ("ops", "api.delta", "scheduler.scheduler", "parallel.sharded"):
                importlib.import_module(f"{pkg}.{name}")
            swap(resolve, on_cpu)
            stack.callback(swap, on_cpu, resolve)  # modules imported meanwhile too
        yield rec


def _raw(fx):
    """The function under a pytest fixture definition."""
    for attr in ("_get_wrapped_function", "__pytest_wrapped__", "__wrapped__"):
        v = getattr(fx, attr, None)
        if callable(v) and attr == "_get_wrapped_function":
            return v()
        if v is not None:
            return getattr(v, "obj", v)
    return fx


def _resolve(mod, name, stack, tmp):
    if name == "tmp_path":
        tmp.mkdir(parents=True, exist_ok=True)
        return tmp
    fn = _raw(getattr(mod, name))
    kw = {p: _resolve(mod, p, stack, tmp / p) for p in inspect.signature(fn).parameters}
    out = fn(**kw)
    if inspect.isgenerator(out):
        value = next(out)
        stack.callback(lambda g=out: next(g, None))
        return value
    return out


def run(case, side: str, tmp_path: Path, subst: tuple = (), **params):
    """Run the case on `side`; its recording."""
    name, fn_name = case
    mod = load(name, side, subst)
    fn = getattr(mod, fn_name)
    root = tmp_path / side
    _TMP[:] = [str(root)]
    try:
        with recording(side) as rec, contextlib.ExitStack() as stack:
            kw = {p: params[p] if p in params else _resolve(mod, p, stack, root / p)
                  for p in inspect.signature(fn).parameters}
            fn(**kw)
            return {"calls": rec.calls, "stores": rec.dump()}
    finally:
        _TMP.clear()


def run_both(case, tmp_path: Path, port_subst: tuple = (), **params):
    """(the JAX side's recording, the port's); `port_subst` edits the port's
    source only, where the two packages' APIs differ."""
    return run(case, "jax", tmp_path, **params), run(case, "port", tmp_path, port_subst, **params)
