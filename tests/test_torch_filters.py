"""The port's filters against the JAX package's, on JAX-encoded arrays.

Each snapshot is encoded by the JAX package; its ClusterArrays fields are
carried across with kubernetes_tpu_torch.convert.from_jax_arrays, so these
tests hold the port's filters to the JAX ones on identical inputs whatever
the port's own encoder does.  Tolerance: none (torch.equal on bool masks).
"""

import dataclasses
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import random_cluster
from kubernetes_tpu.api.snapshot import encode_snapshot as jax_encode
from kubernetes_tpu.ops import filters as jf
from kubernetes_tpu_torch.bench.workloads import heterogeneous, mixed
from kubernetes_tpu_torch.convert import from_jax_arrays
from kubernetes_tpu_torch.ops import filters as tf
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SNAPSHOTS = {
    "mixed": lambda: mixed(),
    "mixed-seed3": lambda: mixed(n_nodes=56, n_pods=300, seed=3),
    "heterogeneous": lambda: heterogeneous(64, 256),
    "random-taints-selectors": lambda: random_cluster(
        random.Random(11), n_nodes=24, n_pods=80, with_taints=True, with_selectors=True),
}


@pytest.fixture(scope="module", params=sorted(SNAPSHOTS))
def pair(request):
    """(JAX ClusterArrays, the port's ClusterArrays carried across, on the CPU)."""
    ja, _ = jax_encode(SNAPSHOTS[request.param]())
    fields = {f.name: np.asarray(getattr(ja, f.name)) for f in dataclasses.fields(ja)}
    return ja, from_jax_arrays(fields, "cpu")


def _eq(j, t: torch.Tensor) -> None:
    j = np.array(j)
    assert j.shape == tuple(t.shape)
    assert torch.equal(torch.from_numpy(j), t)


def test_term_match(pair):
    ja, ta = pair
    _eq(jf.term_match(ja.sel_mask, ja.sel_kind, ja.node_labels),
        tf.term_match(ta.sel_mask, ta.sel_kind, ta.node_labels))


def test_node_selection_ok_from(pair):
    ja, ta = pair
    jtm = jf.term_match(ja.sel_mask, ja.sel_kind, ja.node_labels)
    ttm = tf.term_match(ta.sel_mask, ta.sel_kind, ta.node_labels)
    _eq(jf.node_selection_ok_from(jtm, ja), tf.node_selection_ok_from(ttm, ta))


def test_taints_ok(pair):
    ja, ta = pair
    _eq(jf.taints_ok(ja), tf.taints_ok(ta))


def test_nodename_ok(pair):
    ja, ta = pair
    _eq(jf.nodename_ok(ja), tf.nodename_ok(ta))


def test_static_feasible(pair):
    ja, ta = pair
    j = jf.static_feasible(ja)
    _eq(j, tf.static_feasible_plain(ta))
    _eq(j, tf.static_feasible(ta))  # the dispatching wrapper, CPU tensors


def test_fit_ok_rows(pair):
    """fit_ok for every pod row against the encoded usage."""
    ja, ta = pair
    for p in range(ja.P):
        _eq(jf.fit_ok(ja.pod_req[p], ja.node_used, ja.node_alloc),
            tf.fit_ok(ta.pod_req[p], ta.node_used, ta.node_alloc))


@pytest.mark.parametrize("seed", [0, 1])
def test_fit_ok_near_int32_max(seed):
    """The subtraction form cannot overflow: used + req would wrap here."""
    rng = np.random.default_rng(seed)
    n, r = 2048, 5
    alloc = rng.integers(0, 2**31 - 1, size=(n, r), dtype=np.int64).astype(np.int32)
    used = (alloc * rng.random((n, r))).astype(np.int32)
    req = rng.integers(0, 2**31 - 1, size=(r,), dtype=np.int64).astype(np.int32)
    req[rng.random(r) < 0.3] = 0
    j = jf.fit_ok(jnp.asarray(req), jnp.asarray(used), jnp.asarray(alloc))
    t = tf.fit_ok(torch.from_numpy(req), torch.from_numpy(used), torch.from_numpy(alloc))
    _eq(j, t)
