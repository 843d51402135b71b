"""Standing rules of the PyTorch/CUDA port.

- kubernetes_tpu_torch imports no JAX and nothing of the JAX package: a
  subprocess imports every module of it with both blocked (a subprocess,
  because tests/conftest.py imports jax into every test process), and a
  source scan finds neither named in an import;
- the sidecar's engine needs neither grpc nor protobuf: a second
  subprocess blocks both (and JAX) and imports runtime.sidecar's _Engine
  and _Session and runtime.convert's clone_pod, then runs a small session
  on the CPU;
- the kernel wrappers never fall back: a CPU tensor is refused, and a
  failed build raises;
- each phase tool's PHASES tuple names the PH_* enum of its kernel's
  source, in order (a source scan: the counters are indexed by the enum).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "kubernetes_tpu_torch"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "kubernetes_tpu"):
    sys.modules[name] = None  # any import of them now raises ImportError
import kubernetes_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(kubernetes_tpu_torch.__path__, "kubernetes_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
# the encoder, the pipeline of the warm loop, the failure path, the
# sidecar (its wire, metrics, tracing and lock checker), the node mesh
# (its request grammar, padding, collectives, sharded step and ring layer)
# the Scheduler (its store, queue, cache, CPU plugins with the oracle's
# helpers, and the harness that measures it), the host-side native code
# (the C++ engine's loader, its static stage, the C interner's loader) and
# the crash restart (checkpoint, flight recorder, leases) are among them
assert {"kubernetes_tpu_torch.api.delta", "kubernetes_tpu_torch.parallel.pipeline",
        "kubernetes_tpu_torch.ops.explain", "kubernetes_tpu_torch.ops.preempt",
        "kubernetes_tpu_torch.scheduler.preemption", "kubernetes_tpu_torch.bench.preempt_bench",
        "kubernetes_tpu_torch.runtime.sidecar", "kubernetes_tpu_torch.runtime.convert",
        "kubernetes_tpu_torch.runtime.tpuscore_pb2", "kubernetes_tpu_torch.scheduler.metrics",
        "kubernetes_tpu_torch.scheduler.tracing", "kubernetes_tpu_torch.analysis.lockcheck",
        "kubernetes_tpu_torch.meshreq", "kubernetes_tpu_torch.parallel.mesh",
        "kubernetes_tpu_torch.parallel.partition_rules", "kubernetes_tpu_torch.parallel.collectives",
        "kubernetes_tpu_torch.parallel.sharded", "kubernetes_tpu_torch.parallel.ring",
        "kubernetes_tpu_torch.scheduler.scheduler", "kubernetes_tpu_torch.scheduler.store",
        "kubernetes_tpu_torch.scheduler.queue", "kubernetes_tpu_torch.scheduler.cache",
        "kubernetes_tpu_torch.scheduler.plugins.cpu", "kubernetes_tpu_torch.oracle.reference",
        "kubernetes_tpu_torch.bench.harness", "kubernetes_tpu_torch.native",
        "kubernetes_tpu_torch.native.static_np", "kubernetes_tpu_torch.native.pyintern",
        "kubernetes_tpu_torch.scheduler.checkpoint", "kubernetes_tpu_torch.scheduler.flightrecorder",
        "kubernetes_tpu_torch.scheduler.leases"} <= set(mods), mods
leaked = sorted(k for k, v in sys.modules.items()
                if v is not None and (k.split(".")[0] in ("jax", "jaxlib", "kubernetes_tpu")))
assert not leaked, leaked
print(len(mods))
"""


def test_port_imports_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 10  # every module of the package was imported


_NO_WIRE = r"""
import sys
for name in ("jax", "jaxlib", "kubernetes_tpu", "grpc", "google.protobuf"):
    sys.modules[name] = None  # any import of them now raises ImportError
from kubernetes_tpu_torch.runtime.sidecar import _Engine, _Session
from kubernetes_tpu_torch.runtime.convert import clone_pod
from kubernetes_tpu_torch.api.snapshot import SpecInterner
from kubernetes_tpu_torch.bench.workloads import gang_contended, session_waves
for gang in (False, True):
    res = session_waves(_Engine(device="cpu"), lambda: _Session(1.0, "cpu"), clone_pod, SpecInterner(),
                        gang_contended("perpod-fit"), gang, waves=2)
    assert len(res) == 2 and res[0]["scheduled"] == (3 if gang else 4), (gang, res)
leaked = sorted(k for k, v in sys.modules.items()
                if v is not None and (k.split(".")[0] == "grpc" or k.startswith("google.protobuf")))
assert not leaked, leaked
print("ok")
"""


def test_sidecar_engine_imports_without_grpc_or_protobuf():
    out = subprocess.run(
        [sys.executable, "-c", _NO_WIRE], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _sources():
    return sorted(p for p in PKG.rglob("*") if p.suffix in (".py", ".cu", ".cuh", ".h", ".c", ".cpp", ".proto"))


@pytest.mark.parametrize("pattern", [
    r"^\s*(import|from)\s+jax(lib)?\b",
    r"kubernetes_tpu(?!_torch)",
])
def test_source_names_no_jax_package(pattern):
    rx = re.compile(pattern, re.M)
    hits = [f"{p.relative_to(ROOT)}:{m.group(0)!r}" for p in _sources()
            for m in rx.finditer(p.read_text())]
    assert not hits, hits


def test_kernel_wrappers_refuse_cpu_tensors():
    from kubernetes_tpu_torch.bench.workloads import mixed
    from kubernetes_tpu_torch.api.snapshot import encode_snapshot
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, infer_score_config, kernels

    arr, _ = encode_snapshot(mixed(), device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.static_feasible(arr)
    sf = torch.ones((arr.P, arr.N), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fit_scan(sf, arr, infer_score_config(arr, DEFAULT_SCORE_CONFIG))
    reps = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.explain_counts(arr, arr.node_used, reps, reps.bool())
    words = torch.zeros((1, -(-arr.N // 32)), dtype=torch.int32)
    vict = torch.zeros((arr.N, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.preempt_eval(words, arr.pod_req, reps[:1].int(), arr.node_alloc, arr.node_used, arr.node_used,
                             arr.node_valid, vict[:, :, None].expand(-1, -1, arr.R).contiguous(), vict,
                             vict.bool(), vict.bool())


def test_failed_build_raises(monkeypatch, tmp_path):
    """A build that fails raises with the compiler's output; nothing falls back."""
    from kubernetes_tpu_torch.ops import kernels

    monkeypatch.setattr(kernels, "_FNS", {})
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernels, "_nvcc", lambda: "false")  # a compiler that always fails
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernels.build()
    assert not kernels._FNS


def test_reset_launches():
    from kubernetes_tpu_torch.ops import kernels

    kernels.LAUNCHES["fit_scan"] += 3
    kernels.reset_launches()
    assert set(kernels.LAUNCHES) == set(kernels.SOURCES)
    assert all(n == 0 for n in kernels.LAUNCHES.values())


@pytest.mark.parametrize("kernel", ["class_static_hoist", "class_usage_hoist", "wave_commit", "chunk_rounds",
                                    "packed_static_rows", "chunk_rounds_dense", "unpack_planes", "score_planes",
                                    "full_scan", "rounds", "gang_quorum", "ring_match", "stitch_planes"])
def test_class_wave_wrappers_refuse_cpu_tensors(kernel):
    """The class-wave, dense-route and transfer kernels' wrappers launch or
    raise: CPU tensors are refused before any build, never handed to a plain
    version."""
    from kubernetes_tpu_torch.api.snapshot import encode_snapshot
    from kubernetes_tpu_torch.bench.workloads import mixed
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, infer_score_config, kernels
    from kubernetes_tpu_torch.ops.incremental import HoistCache

    arr, meta = encode_snapshot(mixed(), device="cpu")
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    inc = HoistCache().ensure(arr, meta, cfg)
    calls = {
        "class_static_hoist": lambda: kernels.class_static_hoist(arr, torch.as_tensor(meta.class_first_pod)),
        "class_usage_hoist": lambda: kernels.class_usage_hoist(inc.req_u, arr.node_used, arr.node_alloc, cfg),
        "wave_commit": lambda: kernels.wave_commit(arr, inc, cfg),
        "chunk_rounds": lambda: kernels.chunk_rounds(arr, inc, cfg, arr.node_used, None, None),
        "packed_static_rows": lambda: kernels.packed_static_rows(arr),
        "chunk_rounds_dense": lambda: kernels.chunk_rounds_dense(
            arr, cfg, torch.zeros((arr.P, -(-arr.N // 32)), dtype=torch.int32)),
        "unpack_planes": lambda: kernels.unpack_planes(torch.zeros((3, 2), dtype=torch.int32), 64),
        "score_planes": lambda: kernels.score_planes(arr),
        "full_scan": lambda: kernels.full_scan(arr, cfg, *words, (None, None)),
        "rounds": lambda: kernels.rounds(arr, cfg, *words, (None, None)),
        "gang_quorum": lambda: kernels.gang_quorum(arr.pod_req[:, 0].contiguous(), arr.pod_group, arr.pod_valid,
                                                   arr.group_min),
        "ring_match": lambda: kernels.ring_match(arr.sel_mask.float(), arr.sel_kind, arr.node_labels.float()),
        "stitch_planes": lambda: kernels.stitch_planes(torch.zeros((3, 4), dtype=torch.int32), 37),
    }
    words = [torch.zeros((arr.P, -(-arr.N // 32)), dtype=torch.int32)] * 2
    with pytest.raises(ValueError, match="CUDA"):
        calls[kernel]()


@pytest.mark.parametrize("kernel", ["static_feasible", "fit_scan", "fit_scan_out", "scan_out", "full_scan",
                                    "rounds"])
def test_gated_wrappers_refuse_cpu_tensors(kernel):
    """The gated mode of the gang fixpoint's device loop (a `done` word and
    persistent `out` buffers) launches or raises the same way."""
    from kubernetes_tpu_torch.api.snapshot import encode_snapshot
    from kubernetes_tpu_torch.bench.workloads import gang_contended
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, infer_score_config, kernels

    arr, _ = encode_snapshot(gang_contended("rounds-pairwise"), device="cpu")
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    done = torch.zeros((1,), dtype=torch.int32)
    words = [torch.zeros((arr.P, -(-arr.N // 32)), dtype=torch.int32)] * 2
    calls = {
        "static_feasible": lambda: kernels.static_feasible(arr, done=done),
        "fit_scan": lambda: kernels.fit_scan(torch.ones((arr.P, arr.N), dtype=torch.bool), arr, cfg, done=done),
        "fit_scan_out": lambda: kernels.fit_scan_out(arr, cfg),
        "scan_out": lambda: kernels.scan_out(arr, 16),
        "full_scan": lambda: kernels.full_scan(arr, cfg, *words, (None, None), done=done),
        "rounds": lambda: kernels.rounds(arr, cfg, *words, (None, None), done=done),
    }
    with pytest.raises(ValueError, match="CUDA"):
        calls[kernel]()


def test_wrappers_refuse_a_tensor_off_the_launch_device():
    """Every wrapper launches on the device of its arrays (under
    torch.cuda.device(dev), on that device's current stream), and refuses
    a tensor on another card before the launch; arrays all on a second card
    pass the check whatever PyTorch's current device is."""
    from types import SimpleNamespace

    from kubernetes_tpu_torch.ops import kernels

    def tensor(dev):
        return SimpleNamespace(device=torch.device(dev), dtype=torch.int32, shape=(4,), is_contiguous=lambda: True)

    with pytest.raises(ValueError, match="expected cuda:0"):
        kernels._check(tensor("cuda:1"), "x", torch.int32, (4,), torch.device("cuda:0"))
    with pytest.raises(ValueError, match="expected cuda:1"):
        kernels._check(tensor("cuda:0"), "x", torch.int32, (4,), torch.device("cuda:1"))
    kernels._check(tensor("cuda:1"), "x", torch.int32, (4,), torch.device("cuda:1"))
    kernels._check(tensor("cuda:0"), "x", torch.int32, (4,), torch.device("cuda:0"))


@pytest.mark.parametrize("tool,source", [("dense_phases", "chunk_rounds_dense.cu"),
                                         ("wave_phases", "wave_commit.cu"), ("rounds_phases", "rounds.cu")])
def test_phase_tools_name_their_kernel_enum(tool, source):
    import importlib

    mod = importlib.import_module(f"kubernetes_tpu_torch.bench.{tool}")
    enum = re.search(r"enum\s*\{([^}]*)\}", (PKG / "csrc" / source).read_text()).group(1)
    names = [n.strip() for n in enum.split(",") if n.strip()]
    assert names[-1] == "PH_N"
    assert [f"PH_{name.upper()}" for name, _ in mod.PHASES] == names[:-1]


def test_rounds_phases_names_every_barrier_site():
    """bench/rounds_phases.py reads the grid barriers' log by the BS_* enum
    of csrc/rounds.cu and says what each site waits for."""
    from kubernetes_tpu_torch.bench import rounds_phases

    sites = rounds_phases.site_names((PKG / "csrc" / "rounds.cu").read_text())
    assert sites and sites == tuple(rounds_phases.SITE_WAITS)
