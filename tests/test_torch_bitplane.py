"""The port's bit-plane primitives (kubernetes_tpu_torch/ops/bitplane.py)
against the JAX package's ops/bitplane.py, on seeded numpy bools.

Words are compared as bit patterns (the port keeps them in int32, the JAX
package in uint32); tail bits past n must be zero.  Kernel K9's index
logic and stores (tests/torch_gang_unpack_cases.py replay_unpack) are held
to the JAX unpack at the widths it treats apart.  Tolerance: none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import bitplane as jb
from kubernetes_tpu_torch.ops import bitplane as tb
import torch_gang_unpack_cases as qc
from torch_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SIZES = [1, 31, 32, 33, 64, 80, 96, 100, 1000]


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
    """The per-shard block layout was refused before the node mesh was
    ported; now each block of 32 bits packs and unpacks on its own."""
    x = torch.ones((2, 64), dtype=torch.bool)
    x[1, 40] = False
    w = tb.pack_blocks(x, s=2)
    np.testing.assert_array_equal(w.numpy(), tb.pack(x).numpy())  # 32-bit blocks: the flat layout
    np.testing.assert_array_equal(tb.unpack_blocks(w, 32).numpy(), x.numpy())
    w5 = tb.pack_blocks(x[:, :10], s=2)  # two blocks of 5 bits, one word each
    assert w5.shape == (2, 2) and int(w5[0, 0]) == 31 and int(w5[0, 1]) == 31
    np.testing.assert_array_equal(tb.unpack_blocks(w5, 5).numpy(), x[:, :10].numpy())


@pytest.mark.parametrize("base", [0, 5, "batches"])
@pytest.mark.parametrize("shape", [(0, 80), (1, 7), (1, 80), (3, 31), (3, 32), (3, 33), (5, 64), (6, 80), (2, 7, 96),
                                   (4, 100), (3, 1000), (2, 2048), (37, 65)])
def test_unpack_planes_replay(shape, base):
    """K9 (csrc/unpack_planes.cu) replayed: every byte of [..., n] written
    once, none past a row's n, == the JAX unpack and the port's plain one;
    with the output 16-aligned and n % 16 == 0 every store is one 16-byte
    store, otherwise the 4-byte stores are 4-aligned (replay_unpack asserts
    it).  `base`: the output's byte address mod 16; "batches": rows in
    y-batches of 4."""
    n = shape[-1]
    x = _bools(sum(shape), shape)
    w = tb.pack(torch.from_numpy(x))
    rows = w.reshape(-1, w.shape[-1]).numpy()
    if base == "batches":  # the grid's y axis: row batches of at most 4 words' halves
        r = qc.replay_unpack(rows, n, 0, batch_halves=8 * rows.shape[1])
        assert x.size == 0 or r["grid"][1] == -(-rows.shape[0] // 4)
        base = 0
    else:
        r = qc.replay_unpack(rows, n, base)
    assert (r["writes"] == 1).all()
    got = r["out"].reshape(shape)
    np.testing.assert_array_equal(got, x)
    np.testing.assert_array_equal(got, tb.unpack(w, n).numpy())
    if x.size:  # the JAX unpack reshapes by its element count
        np.testing.assert_array_equal(got, np.asarray(jb.unpack(jnp.asarray(w.numpy().view(np.uint32)), n)))
    if base == 0 and n % 16 == 0 and x.size:
        assert r["stores"][4] == r["stores"][1] == 0 and r["stores"][16] == x.size // 16
