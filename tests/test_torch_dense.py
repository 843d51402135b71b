"""The port's dense chunked route on the CPU against the JAX package's.

- ``filters.static_feasible_rows`` equals the JAX function, both outputs,
  on row blocks of snapshots with node selectors and affinity, taints and
  tolerations, nodeName pins (one to a missing node) and invalid (gated and
  padding) pods;
- the packed static plane (``assign.packed_static_rows_plain``, the plain
  version of kernel K7) equals the JAX package's ``np_pack_lastaxis`` of its
  dense static mask, as uint32 words;
- the dense route (``schedule_batch_ordinals(..., chunked=True)``, no class
  state) equals the JAX package's ``schedule_batch_ordinals_routed`` under
  ``KTPU_FORCE_CHUNKED=1`` with no class state, in choices, final usage,
  commit ordinals and the sweep count (the JAX side in a fresh process,
  tests/torch_waves_reference.py's dense leg), and its decisions equal the
  serial oracle's.

Both sides read the JAX encoder's arrays (convert.from_jax_arrays).
Tolerance: none.
"""

import dataclasses
import os
import random
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_waves_reference as ref
from helpers import random_cluster
from kubernetes_tpu.api.delta import DeltaEncoder
from kubernetes_tpu.bench import workloads as jw
from kubernetes_tpu.ops import DEFAULT_SCORE_CONFIG as JAX_DEFAULT
from kubernetes_tpu.ops import bitplane as jbit
from kubernetes_tpu.ops import filters as jf
from kubernetes_tpu.ops import infer_score_config as jax_infer
from kubernetes_tpu.oracle import oracle_schedule
from kubernetes_tpu_torch.api.snapshot import decode_choices
from kubernetes_tpu_torch.bench import workloads as tw
from kubernetes_tpu_torch.convert import from_jax_arrays
from kubernetes_tpu_torch.ops import DEFAULT_SCORE_CONFIG, assign, filters, infer_score_config

ROOT = Path(__file__).resolve().parent.parent
SNAPSHOTS = {
    "mixed": tw.mixed,  # selectors, affinity, pins (one missing), taints, a gate
    "selectors": lambda: random_cluster(random.Random(5), n_nodes=40, n_pods=200, with_selectors=True),
    "taints": lambda: random_cluster(random.Random(9), n_nodes=70, n_pods=150, with_taints=True),
    "heterogeneous": lambda: jw.heterogeneous(45, 400),
}
# row blocks: whole chunks, a block straddling real and padding rows, one row
BLOCKS = {"first-chunk": (0, 128), "padding": (100, 256), "one-row": (7, 8)}


def _carry(snap):
    ja, jm = DeltaEncoder().encode(snap)
    arr = from_jax_arrays({f.name: np.asarray(getattr(ja, f.name)) for f in dataclasses.fields(ja)}, "cpu")
    return ja, jm, arr


@pytest.fixture(scope="module", params=sorted(SNAPSHOTS))
def carried(request):
    return _carry(SNAPSHOTS[request.param]())


@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_static_feasible_rows_matches_jax(carried, block):
    ja, _, arr = carried
    lo, hi = BLOCKS[block]
    hi = min(hi, arr.P)
    jtm = jf.term_match(ja.sel_mask, ja.sel_kind, ja.node_labels)
    nodes = np.arange(ja.N, dtype=np.int32)
    want = jf.static_feasible_rows(jtm, ja.node_valid, ja.node_taint_ns, nodes, ja.pod_terms[lo:hi],
                                   ja.pod_has_sel[lo:hi], ja.pod_tol_ns[lo:hi], ja.pod_nodename[lo:hi],
                                   ja.pod_valid[lo:hi])
    tm = filters.term_match(arr.sel_mask, arr.sel_kind, arr.node_labels)
    got = filters.static_feasible_rows(tm, arr.node_valid, arr.node_taint_ns, torch.from_numpy(nodes),
                                       arr.pod_terms[lo:hi], arr.pod_has_sel[lo:hi], arr.pod_tol_ns[lo:hi],
                                       arr.pod_nodename[lo:hi], arr.pod_valid[lo:hi])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # and the same bits as the whole-batch mask
    assert torch.equal(got[0], filters.static_feasible_plain(arr)[lo:hi])


def test_packed_static_plane_matches_jax_bytes(carried):
    ja, _, arr = carried
    want = jbit.np_pack_lastaxis(np.asarray(jf.static_feasible(ja)))
    got = assign.packed_static_rows_plain(arr)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_invalid_pods_have_empty_rows():
    _, _, arr = _carry(tw.mixed())
    sfs = assign.packed_static_rows_plain(arr)
    assert not (~arr.pod_valid).all() and (sfs[~arr.pod_valid] == 0).all()


@pytest.fixture(scope="module")
def jax_dense(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_dense") / "dense.npz"
    env = {**os.environ, "JAX_PLATFORMS": "cpu", **ref.DENSE[0]}
    for k in ("KTPU_CLASS_WAVES", "KTPU_WAVE_K", "KTPU_WAVE_BLOCK"):
        env.pop(k, None)
    proc = subprocess.run([sys.executable, str(ROOT / "tests" / "torch_waves_reference.py"), "dense", str(path)],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


@pytest.mark.parametrize("name", ref.DENSE[1])
def test_dense_route_matches_jax(jax_dense, name):
    """Choices, usage, ordinals and sweeps equal the JAX dense route's."""
    ja, _ = DeltaEncoder().encode(ref.snapshot(name))
    arr = from_jax_arrays({f.name: np.asarray(getattr(ja, f.name)) for f in dataclasses.fields(ja)}, "cpu")
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    assign.reset_trace_counts()
    c, u, o, s = assign.schedule_batch_ordinals(arr, cfg, device="cpu", chunked=True)
    assert assign.TRACE_COUNTS["chunked"] == 1 and assign.TRACE_COUNTS["plain"] == 0
    np.testing.assert_array_equal(c.numpy(), jax_dense[f"{name}/choices"])
    np.testing.assert_array_equal(u.numpy(), jax_dense[f"{name}/used"])
    np.testing.assert_array_equal(o.numpy(), jax_dense[f"{name}/ordinals"])
    assert s == int(jax_dense[f"{name}/sweeps"])


@pytest.mark.parametrize("name", ["random", "interference", "mixed"])
def test_dense_route_matches_oracle(name):
    snap = ref.snapshot(name)
    ja, jm = DeltaEncoder().encode(snap)
    arr = from_jax_arrays({f.name: np.asarray(getattr(ja, f.name)) for f in dataclasses.fields(ja)}, "cpu")
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    c, _ = assign.schedule_batch(arr, cfg, device="cpu", chunked=True)
    placed = decode_choices(c, jm)
    assert [(n, placed[n]) for n in jm.pod_names] == oracle_schedule(snap, jax_infer(ja, JAX_DEFAULT))


def test_routing():
    """On the CPU the per-pod route stays the default (the JAX package's
    routing without KTPU_FORCE_CHUNKED); chunked=True takes the dense route;
    a batch that is not a multiple of the chunk takes the per-pod route."""
    _, _, arr = _carry(tw.mixed())
    cfg = infer_score_config(arr, DEFAULT_SCORE_CONFIG)
    assign.reset_trace_counts()
    c1, u1, o1, s1 = assign.schedule_batch_ordinals(arr, cfg, device="cpu")
    assert assign.TRACE_COUNTS == {"plain": 1, "chunked": 0, "chunked_inc": 0, "class_waves": 0}
    assert s1 == arr.P and torch.equal(o1, torch.arange(arr.P, dtype=torch.int32))
    c2, u2, o2, s2 = assign.schedule_batch_ordinals(arr, cfg, device="cpu", chunked=True)
    assert assign.TRACE_COUNTS["chunked"] == 1
    assert torch.equal(c1, c2) and torch.equal(u1, u2) and s2 < arr.P
    small = arr.pod_prefix(64)
    assign.schedule_batch(small, cfg, device="cpu", chunked=True)
    assert assign.TRACE_COUNTS["plain"] == 2 and assign.TRACE_COUNTS["chunked"] == 1
