"""The port's bit-plane primitives (kubernetes_tpu_torch/ops/bitplane.py)
against the JAX package's ops/bitplane.py, on seeded numpy bools.

Words are compared as bit patterns (the port keeps them in int32, the JAX
package in uint32); tail bits past n must be zero.  Tolerance: none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import bitplane as jb
from kubernetes_tpu_torch.ops import bitplane as tb

SIZES = [1, 31, 32, 33, 100]


def _bools(seed, shape, p=0.4):
    return np.random.default_rng(seed).random(shape) < p


def _words(jax_words):
    return np.asarray(jax_words).view(np.int32)


@pytest.mark.parametrize("n", SIZES)
def test_pack_unpack(n):
    x = _bools(n, (3, 5, n))
    w = tb.pack(torch.from_numpy(x))
    np.testing.assert_array_equal(w.numpy(), _words(jb.pack(jnp.asarray(x))))
    assert w.shape[-1] == tb.words_for(n) == jb.words_for(n)
    tail = tb.words_for(n) * 32 - n
    if tail:
        assert not ((w[..., -1].to(torch.int64) & 0xFFFFFFFF) >> (32 - tail)).any()
    np.testing.assert_array_equal(tb.unpack(w, n).numpy(), x)
    np.testing.assert_array_equal(tb.unpack_blocks(tb.pack_blocks(torch.from_numpy(x)), n).numpy(), x)


@pytest.mark.parametrize("n", SIZES)
def test_test_cols_popcount_any(n):
    x = _bools(100 + n, (4, n))
    w_t = tb.pack(torch.from_numpy(x))
    w_j = jb.pack(jnp.asarray(x))
    cols = np.random.default_rng(n).integers(0, n, 2 * n + 3).astype(np.int32)
    np.testing.assert_array_equal(
        tb.test_cols(w_t, torch.from_numpy(cols), n).numpy(), np.asarray(jb.test_cols(w_j, jnp.asarray(cols), n)))
    np.testing.assert_array_equal(tb.popcount(w_t).numpy(), np.asarray(jb.popcount(w_j)))
    np.testing.assert_array_equal(tb.any_bits(w_t).numpy(), np.asarray(jb.any_bits(w_j)))
    np.testing.assert_array_equal(tb.popcount(w_t).numpy(), x.sum(axis=1))


@pytest.mark.parametrize("n", SIZES)
def test_set_cols_duplicates_and_sentinel(n):
    x = _bools(200 + n, (n,), p=0.2)
    rng = np.random.default_rng(300 + n)
    cols = rng.integers(0, n + 1, 3 * n + 4).astype(np.int32)  # n: the dropped sentinel
    cols[1] = cols[0]  # a duplicate
    on = rng.random(cols.shape[0]) < 0.6
    got = tb.set_cols(tb.pack(torch.from_numpy(x)), torch.from_numpy(cols), torch.from_numpy(on), n)
    want = jb.set_cols(jb.pack(jnp.asarray(x)), jnp.asarray(cols), jnp.asarray(on), n)
    np.testing.assert_array_equal(got.numpy(), _words(want))


@pytest.mark.parametrize("n", SIZES)
def test_assign_cols_duplicates_and_sentinel(n):
    """Mixed set/clear column assignment on a [U, W] plane; duplicate real
    columns carry equal values, sentinel columns (== n) any value."""
    U = 3
    x = _bools(400 + n, (U, n), p=0.5)
    rng = np.random.default_rng(500 + n)
    real = rng.permutation(n)[: max(1, n // 2)].astype(np.int32)
    dup = real[:2]
    cols = np.concatenate([real, dup, np.full(5, n, np.int32)])  # duplicates, sentinels
    on = rng.random((U, cols.shape[0])) < 0.5
    on[:, len(real):len(real) + len(dup)] = on[:, :len(dup)]
    got = tb.assign_cols(tb.pack(torch.from_numpy(x)), torch.from_numpy(cols), torch.from_numpy(on), n)
    want = jb.assign_cols(jb.pack(jnp.asarray(x)), jnp.asarray(cols), jnp.asarray(on), n)
    np.testing.assert_array_equal(got.numpy(), _words(want))
    dense = x.copy()
    dense[:, real] = on[:, : len(real)]
    np.testing.assert_array_equal(tb.unpack(got, n).numpy(), dense)


def test_multi_block_layout_refused():
    w = tb.pack(torch.ones((2, 64), dtype=torch.bool))
    with pytest.raises(NotImplementedError, match="A12"):
        tb.pack_blocks(torch.ones((2, 64), dtype=torch.bool), s=2)
    with pytest.raises(NotImplementedError, match="A12"):
        tb.unpack_blocks(w, 32)
