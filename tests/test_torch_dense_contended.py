"""The dense chunked route's round loop (kernel K8's function) on inputs
that stress it, against the JAX package's.

Cases (tests/torch_dense_contended_reference.py): all 128 pods of a chunk
ranking one node first; every score tied; N not a multiple of 32; P == C;
a chunk of invalid pods between valid ones; a MostAllocated chunk in
which every round commits one pod, so it takes C rounds, the round cap.
On the CPU the port's dense route (``schedule_batch_ordinals(...,
chunked=True)``, the plain round loop) must equal the JAX package's
``schedule_batch_ordinals_routed`` under ``KTPU_FORCE_CHUNKED=1`` (run in a
fresh process) in choices, final usage, commit ordinals and sweeps.  On the
card (the ``cuda`` legs) kernel K8 must equal the plain scan on the same
inputs, with its round-cap status clear.  Both sides read the JAX
encoder's arrays (convert.from_jax_arrays).  Tolerance: none.

The card legs:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_dense_contended.py
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dense_contended_reference as ref
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

ROOT = Path(__file__).resolve().parent.parent
CASES = sorted(ref.CASES)


def _arrays(name):
    """The JAX encoder's arrays of a case, as the port's CPU arrays, and the
    case's score config."""
    from kubernetes_tpu.api.delta import DeltaEncoder
    from kubernetes_tpu_torch.convert import from_jax_arrays
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, infer_score_config

    _, enc_kw, over = ref.CASES[name]
    ja, _ = DeltaEncoder(**enc_kw).encode(ref.snapshot(name))
    arr = from_jax_arrays({f.name: np.asarray(getattr(ja, f.name)) for f in dataclasses.fields(ja)}, "cpu")
    return arr, infer_score_config(arr, dataclasses.replace(DEFAULT_SCORE_CONFIG, **over))


@pytest.fixture(scope="module")
def jax_dense(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_dense_contended") / "dense.npz"
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "KTPU_FORCE_CHUNKED": "1"}
    proc = subprocess.run([sys.executable, str(ROOT / "tests" / "torch_dense_contended_reference.py"), str(path)],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


def test_cases_stress_what_they_name():
    """Each case has the shape its name says (checked on the port's plain
    run, which the JAX comparison below holds to the JAX route)."""
    from kubernetes_tpu_torch.ops import assign

    shapes = {}
    for name in CASES:
        arr, cfg = _arrays(name)
        c, _, o, s = assign.schedule_batch_ordinals(arr, cfg, device="cpu", chunked=True)
        shapes[name] = (arr, c, o, s)
    arr, c, _, s = shapes["one-best-node"]
    assert arr.P == 128 and bool((c == 0).all())
    arr, c, _, _ = shapes["ties"]
    assert arr.N % 32 and len(set(c.tolist())) == arr.N
    assert shapes["odd-n"][0].N == 45
    assert shapes["p-eq-c"][0].P == assign.CHUNK
    arr, c, _, _ = shapes["invalid-chunk"]
    assert arr.pod_valid.view(-1, assign.CHUNK).sum(dim=1).tolist() == [128, 0, 128]
    assert bool((c[128:256] == -1).all())
    arr, c, o, s = shapes["round-cap"]
    assert arr.P == assign.CHUNK and s == assign.CHUNK and sorted(o.tolist()) == list(range(assign.CHUNK))


@pytest.mark.parametrize("name", CASES)
def test_dense_round_loop_matches_jax(jax_dense, name):
    from kubernetes_tpu_torch.ops import assign

    arr, cfg = _arrays(name)
    assign.reset_trace_counts()
    c, u, o, s = assign.schedule_batch_ordinals(arr, cfg, device="cpu", chunked=True)
    assert assign.TRACE_COUNTS["chunked"] == 1
    np.testing.assert_array_equal(c.numpy(), jax_dense[f"{name}/choices"])
    np.testing.assert_array_equal(u.numpy(), jax_dense[f"{name}/used"])
    np.testing.assert_array_equal(o.numpy(), jax_dense[f"{name}/ordinals"])
    assert s == int(jax_dense[f"{name}/sweeps"])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card: python -m pytest --noconftest -m cuda "
                    "tests/test_torch_dense_contended.py")
    return torch.device("cuda")


def _port_inputs(name, dev):
    """The case through the port's encoder (no JAX on the card's machine),
    cut back from its bucketed shape to the case's own N and P: the node
    fields, the pod rows and the packed static words (the padding nodes'
    bits are 0) -> (arrays for the dense scan, sfs, cfg)."""
    import types

    from kubernetes_tpu_torch.api.snapshot import encode_snapshot
    from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, infer_score_config

    snap = ref.snapshot(name, "kubernetes_tpu_torch")
    arr, _ = encode_snapshot(snap, device="cpu")
    cfg = infer_score_config(arr, dataclasses.replace(DEFAULT_SCORE_CONFIG, **ref.CASES[name][2]))
    n, p = len(snap.nodes), len(snap.pending_pods)
    sfs = assign.packed_static_rows_plain(arr)[:p, : -(-n // 32)].contiguous().to(dev)
    cut = types.SimpleNamespace(P=p, N=n, R=arr.R, pod_req=arr.pod_req[:p], pod_valid=arr.pod_valid[:p],
                                node_alloc=arr.node_alloc[:n], node_used=arr.node_used[:n])
    for f in ("pod_req", "pod_valid", "node_alloc", "node_used"):
        setattr(cut, f, getattr(cut, f).contiguous().to(dev))
    cut.device = sfs.device
    return cut, sfs, cfg


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_dense_kernel_matches_plain(card, name):
    from kubernetes_tpu_torch.ops import assign, kernels

    cpu, sfs_cpu, cfg = _port_inputs(name, "cpu")
    want = assign.schedule_scan_chunked_dense_plain(cpu, cfg, sfs_cpu)
    d, sfs, _ = _port_inputs(name, card)
    got = kernels.chunk_rounds_dense(d, cfg, sfs)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(got[2].cpu(), want[2])
    assert kernels.read_sweeps(got[3]) == want[3]
