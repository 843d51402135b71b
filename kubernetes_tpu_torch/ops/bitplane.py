"""Bit-packed mask planes — the port of the JAX package's ``ops/bitplane.py``
(the default packed layout, single device).

A bool mask ``[..., n]`` packs along its last axis into ``W = ceil(n / 32)``
words: bit ``j`` of word ``k`` holds element ``k*32 + j`` (little-endian bits
in little-endian words), and the tail bits past ``n`` in the last word are
always zero, so popcount and any-reductions need no tail mask.

Words are stored as ``torch.int32`` BIT PATTERNS, not ``torch.uint32``:
torch 2.11/2.13 implement no shift (``lshift_cpu``) and no popcount for
uint32 on the CPU, while every int32 bitwise op is there.  Word ``0x80000000``
is the int32 ``-2**31``; ``(w >> b) & 1`` reads bit ``b`` correctly despite
the arithmetic right shift, and the CUDA kernels read the same memory as
``uint32_t``.  ``np.asarray(jax_words).view(np.int32)`` is the JAX plane in
this form.

These are the plain versions.  On the card the kernels (csrc/) inline the
same word layout as ``__device__`` code: a warp ballot packs 32 nodes into
one word, a bit test is ``(w >> (n & 31)) & 1``.

``np_pack_lastaxis`` / ``np_unpack_lastaxis`` are the host (numpy) side:
the encoder packs a wide bool field before its host-to-device copy and
kernel K9 ``unpack_planes`` (csrc/unpack_planes.cu) unpacks it on the card
(api/delta.py — DeltaEncoder._packed_put).  They give uint32 words, the
JAX package's bytes.

Only one block of ``nl == n`` bits per row (one device) is ported; the
per-shard block layout (``pack_blocks`` / ``unpack_blocks`` with s > 1)
comes with the multi-GPU slice, and the wrappers below refuse s > 1.
"""

from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32
_MASK32 = (1 << 32) - 1


def words_for(n: int) -> int:
    """Words per `n` mask bits: ceil(n / 32)."""
    return -(-int(n) // WORD_BITS)


def _to_i32(x64: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the int32 with the same low 32 bits."""
    return torch.where(x64 >= 2**31, x64 - 2**32, x64).to(torch.int32)


def _bits(n: int, device) -> torch.Tensor:
    return torch.arange(WORD_BITS, dtype=torch.int64, device=device)


def pack(x: torch.Tensor) -> torch.Tensor:
    """bool [..., n] -> int32 words [..., words_for(n)]; tail bits zero."""
    n = x.shape[-1]
    w = words_for(n)
    pad = w * WORD_BITS - n
    if pad:
        x = torch.cat([x, torch.zeros(x.shape[:-1] + (pad,), dtype=torch.bool, device=x.device)], dim=-1)
    b = x.reshape(x.shape[:-1] + (w, WORD_BITS)).to(torch.int64)
    return _to_i32((b << _bits(n, x.device)).sum(dim=-1))


def unpack(w: torch.Tensor, n: int) -> torch.Tensor:
    """int32 words [..., words_for(n)] -> bool [..., n] (the pack inverse)."""
    bits = (w[..., None].to(torch.int64) >> _bits(n, w.device)) & 1
    return bits.reshape(w.shape[:-1] + (-1,))[..., :n].to(torch.bool)


def _single_block(s: int) -> None:
    if s != 1:
        raise NotImplementedError(
            "per-shard packed blocks (s > 1) are not ported to kubernetes_tpu_torch yet "
            "(ROADMAP.md queue A12)"
        )


def pack_blocks(x: torch.Tensor, s: int = 1) -> torch.Tensor:
    """pack() in `s` per-shard blocks; one device: s == 1 is plain pack()."""
    _single_block(s)
    return pack(x)


def unpack_blocks(w: torch.Tensor, nl: int) -> torch.Tensor:
    """unpack() of a plane of per-shard blocks of `nl` bits; one device:
    the plane is one block."""
    _single_block(w.shape[-1] // words_for(nl))
    return unpack(w, nl)


def test_cols(w: torch.Tensor, cols: torch.Tensor, nl: int) -> torch.Tensor:
    """Bit test at node ids `cols` (in [0, nl)): bool with shape
    w.shape[:-1] + cols.shape, the packed ``dense[..., cols]``."""
    _single_block(w.shape[-1] // words_for(nl))
    cols = cols.to(torch.int64)
    word = torch.div(cols, WORD_BITS, rounding_mode="floor")
    bit = cols % WORD_BITS
    return ((w[..., word] >> bit.to(torch.int32)) & 1).to(torch.bool)


test_cols.__test__ = False  # a library function, not a pytest test


def popcount(w: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Set-bit count along `axis` (int32), exact because tail bits are zero."""
    x = w.to(torch.int64) & _MASK32
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = (x * 0x01010101 & _MASK32) >> 24
    return x.sum(dim=axis).to(torch.int32)


def any_bits(w: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Any bit set along `axis`: the packed ``dense.any(axis)``."""
    return (w != 0).any(dim=axis)


def set_cols(w: torch.Tensor, cols: torch.Tensor, on: torch.Tensor, nl: int) -> torch.Tensor:
    """Set bit ``cols[i]`` where ``on[i]`` (OR semantics: duplicate columns are
    fine); ids == n are dropped, as in the JAX version's scatter."""
    n = (w.shape[-1] // words_for(nl)) * nl
    _single_block(w.shape[-1] // words_for(nl))
    dense = torch.zeros(w.shape[:-1] + (n + 1,), dtype=torch.bool, device=w.device)
    tgt = torch.where(on, cols.to(torch.int64), n)
    dense[..., tgt] = True
    return w | pack(dense[..., :n])


def assign_cols(w: torch.Tensor, cols: torch.Tensor, on: torch.Tensor, nl: int) -> torch.Tensor:
    """Column ASSIGNMENT: bit ``cols[i]`` := ``on[..., i]``.  Ids == n are
    dropped (the kernels' sentinel); duplicate columns must carry equal
    values.  ``(w & ~touched) | new`` over packed touched/new word masks."""
    n = (w.shape[-1] // words_for(nl)) * nl
    _single_block(w.shape[-1] // words_for(nl))
    tgt = torch.clamp(cols.to(torch.int64), 0, n)
    touched = torch.zeros((n + 1,), dtype=torch.bool, device=w.device)
    touched[tgt] = True
    newbits = torch.zeros(w.shape[:-1] + (n + 1,), dtype=torch.bool, device=w.device)
    # duplicates carry equal values, so which write lands is immaterial
    newbits[..., tgt] = on
    tw = pack(touched[:n])
    nw = pack(newbits[..., :n])
    return (w & ~tw) | nw


def unpack_planes(w: torch.Tensor, n: int) -> torch.Tensor:
    """unpack() on w's device: the plain version for CPU tensors, kernel K9
    unpack_planes for CUDA tensors."""
    if w.device.type == "cpu":
        return unpack(w, n)
    from . import kernels

    return kernels.unpack_planes(w, n)


# ---------------------------------------------------------------------------
# host side (numpy): the encoder's transfer packing
# ---------------------------------------------------------------------------

def np_pack_lastaxis(a: np.ndarray) -> np.ndarray:
    """bool [..., n] -> uint32 [..., words_for(n)], the layout of pack()
    (little-endian bits in little-endian words: packbits with
    bitorder='little', then a uint8 -> uint32 view on a little-endian
    host)."""
    a = np.ascontiguousarray(a, dtype=np.bool_)
    n = a.shape[-1]
    w = words_for(n)
    pad = w * WORD_BITS - n
    if pad:
        a = np.concatenate([a, np.zeros(a.shape[:-1] + (pad,), dtype=np.bool_)], axis=-1)
    return np.ascontiguousarray(np.packbits(a, axis=-1, bitorder="little")).view(np.uint32)


def np_unpack_lastaxis(w: np.ndarray, n: int) -> np.ndarray:
    """uint32 [..., words] -> bool [..., n] (np_pack_lastaxis inverse)."""
    w = np.ascontiguousarray(w, dtype=np.uint32)
    bits = np.unpackbits(w.view(np.uint8), axis=-1, bitorder="little")
    return bits[..., :n].astype(np.bool_)
