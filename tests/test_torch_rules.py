"""Standing rules of the PyTorch/CUDA port.

- kubernetes_tpu_torch imports no JAX and nothing of the JAX package: a
  subprocess imports every module of it with both blocked (a subprocess,
  because tests/conftest.py imports jax into every test process), and a
  source scan finds neither named in an import;
- the kernel wrappers never fall back: a CPU tensor is refused, and a
  failed build raises.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

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
# the encoder and the pipeline of the warm loop are among them
assert {"kubernetes_tpu_torch.api.delta", "kubernetes_tpu_torch.parallel.pipeline"} <= set(mods), mods
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


def _sources():
    return sorted(p for p in PKG.rglob("*") if p.suffix in (".py", ".cu", ".cuh", ".h"))


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
                                    "packed_static_rows", "chunk_rounds_dense", "unpack_planes"])
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
    }
    with pytest.raises(ValueError, match="CUDA"):
        calls[kernel]()
