"""The port's SpecInterner on its C path (native/interner.c via
native/pyintern.py) against its Python loop and against the JAX package's
native interner, on the CPU.

- successive waves (template-shared field objects, distinct objects of
  equal value, a warm repeat, after a table clear, empty): reps (as
  positions in the wave), inv and rep_keys equal across the C path, the
  Python loop and the JAX interner;
- the clear policy: the C table and the spec-key registry drop together
  when they outgrow twice the wave, as the Python loop's table does;
- the two latches: three batches in a row with forced misses (a profile
  field outside the instance dict) hand the interner to the Python loop,
  a clean batch resets the streak; three batches in a row that leave
  provisional entries (the slow path raising) do the same; the JAX
  interner latches on the same calls;
- a failed build of either host library raises with the compiler's
  output (a broken copy of the source in a scratch directory); processes
  that build one library at once all load a whole one;
- the Pod the C pass reads: a plain dataclass with the 13 profile fields
  interner.c names in its instance dict;
- the C table's pins on pods are released when a DeltaEncoder or a
  TPUScoreClient is dropped.

Tolerance: none.
"""

import dataclasses
import gc
import os
import random
import re
import subprocess
import sys
import weakref
from pathlib import Path

import pytest

from kubernetes_tpu_torch import native
from kubernetes_tpu_torch.api import types as pt
from kubernetes_tpu_torch.api.snapshot import SpecInterner, _identity_key, group_by_spec
from kubernetes_tpu_torch.native import pyintern
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jt():
    pytest.importorskip("jax")
    from kubernetes_tpu.api import snapshot as jsnap
    from kubernetes_tpu.api import types as jtypes
    from kubernetes_tpu.native import pyintern as jpyintern

    if jpyintern.load() is None:
        pytest.fail("the JAX package's native interner did not build")
    return jtypes, jsnap


def _templates(types, n=12):
    return [
        types.Pod(
            name=f"tmpl{i}",
            requests={"cpu": 100 * (i + 1), "memory": 1 << (10 + i % 4)},
            labels={"app": f"a{i % 5}"},
            priority=i % 3,
            tolerations=((types.Toleration(key="k", operator="Exists"),) if i % 2 else ()),
        )
        for i in range(n)
    ]


def _waves(types, seed=5):
    """test_snapshot.py::test_interner_native_matches_python's waves, built
    with `types` (the JAX package's or the port's)."""
    rng = random.Random(seed)
    templates = _templates(types)
    w1 = [dataclasses.replace(rng.choice(templates), name=f"p{j}", uid="") for j in range(300)]
    w2 = [types.Pod(name=f"q{j}", requests=dict(rng.choice(templates).requests), labels={"app": f"a{j % 5}"},
                    priority=j % 3) for j in range(300)]
    return [w1, w2, w1[:100] + w2[:50], "clear", w1, [], w2[::-1] + w1[::3]]


def _canon(pods, out):
    """(reps as positions in `pods`, inv, repr of rep_keys): comparable
    across packages (dataclass reprs name only the class)."""
    pos = {id(p): i for i, p in enumerate(pods)}
    reps, inv, keys = out
    return [pos[id(r)] for r in reps], inv.tolist(), repr(keys)


def test_c_path_matches_python_loop_and_jax(jt):
    jtypes, jsnap = jt
    c, py = SpecInterner(), SpecInterner(native=False)
    assert c.path == "c" and py.path == "python"
    jn = jsnap.SpecInterner()
    assert jn._lib is not None
    for pw, jw in zip(_waves(pt), _waves(jtypes)):
        if pw == "clear":
            c._lib.interner_clear(c._h)
            jn._lib.interner_clear(jn._h)
            continue
        got, plain, want = c.group(pw), py.group(pw), jn.group(jw)
        assert [id(r) for r in got[0]] == [id(r) for r in plain[0]]
        assert got[1].tolist() == plain[1].tolist() and got[2] == plain[2]
        assert _canon(pw, got) == _canon(jw, want)
    assert c.path == "c"


def test_group_by_spec_is_the_interner():
    pods = _waves(pt)[0]
    reps, inv = group_by_spec(pods)
    want = SpecInterner(native=False).group(pods)
    assert [id(r) for r in reps] == [id(r) for r in want[0]] and inv.tolist() == want[1].tolist()


def test_clear_policy_drops_table_and_registry_together(jt):
    jtypes, jsnap = jt
    big = [pt.Pod(name=f"d{j}", requests={"cpu": j + 1}) for j in range(2100)]
    jbig = [jtypes.Pod(name=f"d{j}", requests={"cpu": j + 1}) for j in range(2100)]
    small, jsmall = _waves(pt)[0][:10], _waves(jtypes)[0][:10]
    c, py, jn = SpecInterner(), SpecInterner(native=False), jsnap.SpecInterner()
    for k, (pw, jw) in enumerate(((big, jbig), (small, jsmall), (big[:5] + small, jbig[:5] + jsmall))):
        got, plain, want = c.group(pw), py.group(pw), jn.group(jw)
        assert [id(r) for r in got[0]] == [id(r) for r in plain[0]] and got[2] == plain[2]
        assert got[1].tolist() == plain[1].tolist()
        assert _canon(pw, got) == _canon(jw, want)
        assert int(c._lib.interner_count(c._h)) == int(jn._lib.interner_count(jn._h))
        assert len(c._key_by_kid) == len(jn._key_by_kid)
        if k == 1:
            # the 2100-spec table outgrew 2 * (10 + 1024): both levels
            # restarted, holding only this wave's specs
            assert len(c._key_by_kid) == len(got[0]) and len(py._keys) == int(c._lib.interner_count(c._h))


def _unstable(types, name):
    """A pod whose pod_group is read through the class (not its instance
    dict): an identity-unstable profile, a forced miss in C."""
    p = types.Pod(name=name, requests={"cpu": 100})
    del p.__dict__["pod_group"]
    return p


def test_forced_latch(jt):
    jtypes, jsnap = jt
    c, py, jn = SpecInterner(), SpecInterner(native=False), jsnap.SpecInterner()
    stable, jstable = _waves(pt)[0][:40], _waves(jtypes)[0][:40]
    script = ["forced", "forced", "clean", "forced", "forced", "forced", "clean"]
    paths = []
    for k, kind in enumerate(script):
        pw, jw = list(stable), list(jstable)
        if kind == "forced":
            pw.append(_unstable(pt, f"u{k}"))
            jw.append(_unstable(jtypes, f"u{k}"))
        got, plain, want = c.group(pw), py.group(pw), jn.group(jw)
        assert [id(r) for r in got[0]] == [id(r) for r in plain[0]] and got[2] == plain[2]
        assert _canon(pw, got) == _canon(jw, want)
        assert (c.path == "python") == (jn._lib is None)
        paths.append(c.path)
    # the clean batch reset the first streak; the second latched on its third
    assert paths == ["c"] * 5 + ["python"] * 2


def _bad(types, name):
    """A pod whose spec key cannot be computed (unsortable requests): the
    slow path raises between the C lookup and the insert."""
    return types.Pod(name=name, requests={1: 2, "cpu": 3})


@pytest.mark.parametrize("script,final", [
    (["bad", "good", "good", "bad", "good"], "c"),
    (["bad", "bad", "bad", "bad", "good"], "python"),
])
def test_provisional_latch(jt, script, final):
    jtypes, jsnap = jt
    c, py, jn = SpecInterner(), SpecInterner(native=False), jsnap.SpecInterner()
    stable, jstable = _waves(pt)[0][:40], _waves(jtypes)[0][:40]
    for k, kind in enumerate(script):
        pw, jw = list(stable), list(jstable)
        if kind == "bad":
            pw.insert(7, _bad(pt, f"b{k}"))
            jw.insert(7, _bad(jtypes, f"b{k}"))
            for side in (c, py, jn):
                with pytest.raises(TypeError):
                    side.group(pw if side is not jn else jw)
        else:
            got, plain, want = c.group(pw), py.group(pw), jn.group(jw)
            assert [id(r) for r in got[0]] == [id(r) for r in plain[0]] and got[2] == plain[2]
            assert _canon(pw, got) == _canon(jw, want)
        assert (c.path == "python") == (jn._lib is None)
    assert c.path == final


def test_pod_profile_fields_live_in_the_instance_dict():
    """interner.c reads the 13 fields of _identity_key from the pod's
    __dict__: the port's Pod is a plain dataclass (no slots) holding them
    there."""
    src = (ROOT / "kubernetes_tpu_torch" / "native" / "interner.c").read_text()
    block = re.search(r"FIELD_NAMES\[NFIELDS\] = \{(.*?)\};", src, re.S).group(1)
    names = re.findall(r'"(\w+)"', block)
    assert len(names) == int(re.search(r"#define NFIELDS (\d+)", src).group(1)) == 13
    pod = pt.Pod(name="p", requests={"cpu": 1})
    assert not hasattr(pt.Pod, "__slots__") and dataclasses.is_dataclass(pt.Pod)
    assert set(names) <= set(vars(pod))
    # the same fields, in the order _identity_key reads them (by identity,
    # or by value for the four scalar ones)
    marks = {n: object() for n in names}
    vars(pod).update(marks)
    key = _identity_key(pod)
    assert len(key) == 13 and all(key[i] in (id(marks[n]), marks[n]) for i, n in enumerate(names))


def _broken_copy(src: Path, tmp_path: Path) -> Path:
    bad = tmp_path / src.name
    bad.write_text(src.read_text() + "\nthis is not C;\n")
    return bad


def test_failed_interner_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(pyintern, "SRC", _broken_copy(pyintern.SRC, tmp_path))
    monkeypatch.setattr(pyintern, "_lib", None)
    with pytest.raises(RuntimeError, match=r"gcc failed for interner\.c \(exit \d+\):\n.*error"):
        SpecInterner()
    assert pyintern._lib is None
    assert not list((tmp_path / "build").glob("*"))  # nothing half-written is left


def test_failed_engine_build_raises(monkeypatch, tmp_path):
    from kubernetes_tpu_torch.api.delta import DeltaEncoder
    from kubernetes_tpu_torch.bench.workloads import mixed
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, infer_score_config

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "ENGINE_SRC", _broken_copy(native.ENGINE_SRC, tmp_path))
    monkeypatch.setattr(native, "_lib", None)
    host, _ = DeltaEncoder("cpu").encode(mixed())
    with pytest.raises(RuntimeError, match=r"g\+\+ failed for scheduler\.cpp \(exit \d+\):\n.*error"):
        native.schedule_batch_native(host, infer_score_config(host, DEFAULT_SCORE_CONFIG))
    assert native._lib is None


_BUILD_ONE = r"""
import sys
from pathlib import Path
from kubernetes_tpu_torch import native
from kubernetes_tpu_torch.api.snapshot import SpecInterner
native.BUILD_DIR = Path(sys.argv[1])
native.build()
pods = SpecInterner().group([])
print("ok")
"""


def test_concurrent_builds_publish_whole_libraries(tmp_path):
    """Four processes build both libraries into one empty directory at once:
    each loads a whole library, and one file of each is left, no temporary."""
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ONE, str(tmp_path)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    assert all(o[0].strip() == "ok" for o in outs)
    names = sorted(f.name for f in tmp_path.iterdir())
    assert len(names) == 2 and all(n.endswith(".so") and not n.startswith(".") for n in names), names
    assert {n.split("-")[0] for n in names} == {"libinterner", "libscheduler"}


def _pin_check(group_fn, holder_ref):
    pods = _waves(pt)[0][:50]
    refs = [weakref.ref(p) for p in pods]
    group_fn(pods)
    del pods
    gc.collect()
    assert any(r() is not None for r in refs)  # the C table pins them while the holder lives
    holder_ref[0] = None
    gc.collect()
    assert all(r() is None for r in refs)


def test_encoder_drop_releases_pins():
    from kubernetes_tpu_torch.api.delta import DeltaEncoder

    holder = [DeltaEncoder("cpu")]
    assert holder[0]._interner.path == "c"
    _pin_check(lambda pods: holder[0]._interner.group(pods), holder)


def test_client_drop_releases_pins():
    pytest.importorskip("grpc")
    from kubernetes_tpu_torch.runtime.client import TPUScoreClient

    holder = [TPUScoreClient("127.0.0.1:1")]
    assert holder[0]._interner.path == "c"
    _pin_check(lambda pods: holder[0]._interner.group(pods), holder)


def test_interner_drop_releases_pins():
    holder = [SpecInterner()]
    _pin_check(lambda pods: holder[0].group(pods), holder)
