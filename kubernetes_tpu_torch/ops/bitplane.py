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

Per-shard blocks (the node mesh, parallel/mesh.py): a plane of S shards'
rows is stored TILED, ``S * words(nl)`` words per row, shard s's block
``[s * Wl, (s + 1) * Wl)`` the packed form of its own ``nl`` nodes with
its own zero tail bits -- the layout of the JAX package's tiled all_gather
of packed planes.  ``pack_blocks`` / ``unpack_blocks`` / ``test_cols`` /
``set_cols`` / ``assign_cols`` take it (``nl`` is the block width; one
block is the plain layout), and ``stitch_planes`` turns it into the flat
layout of ``S * nl`` bits (kernel K17, csrc/stitch_planes.cu, on the card),
which the commit kernels read.

Raw score planes (traw / naraw / image_score) are stored as bf16 and upcast
to f32 before every reduction; ``KTPU_SCORE_DTYPE=f32`` (read once at
import; anything else raises, as in the JAX package) stores them as f32
instead, and the host mirrors (``quantize_scores_np``, ``bf16_round_np``)
follow, so the encoder, the oracle's helpers and the native engine stay on
the kernels' lattice.  The JAX package also reads a persisted autotune
winner for the knob (ops/tuning.py); the port reads the environment only
until that module is ported (ROADMAP.md A14).
"""

from __future__ import annotations

import os

import numpy as np
import torch

# the raw score planes' storage (the JAX package's bitplane.py:48-52)
SCORE_DTYPE: str = os.environ.get("KTPU_SCORE_DTYPE", "") or "bf16"
if SCORE_DTYPE not in ("bf16", "f32"):
    raise ValueError(f"KTPU_SCORE_DTYPE must be 'bf16' or 'f32', got {SCORE_DTYPE!r}")

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
    return bits.reshape(w.shape[:-1] + (w.shape[-1] * WORD_BITS,))[..., :n].to(torch.bool)  # 0 rows too


def pack_blocks(x: torch.Tensor, s: int = 1) -> torch.Tensor:
    """bool [..., S*nl] -> int32 words [..., S*words(nl)] packed in per-shard
    blocks: each of the `s` equal slices of the last axis packs on its own
    (the JAX package's bitplane.py:100).  s == 1 is pack()."""
    if s == 1:
        return pack(x)
    n = x.shape[-1] // s
    return pack(x.reshape(x.shape[:-1] + (s, n))).reshape(x.shape[:-1] + (s * words_for(n),))


def unpack_blocks(w: torch.Tensor, nl: int) -> torch.Tensor:
    """int32 words [..., S*words(nl)] in per-shard blocks of `nl` bits ->
    bool [..., S*nl]; each block unpacks on its own, so its tail bits never
    reach the dense view (the JAX package's bitplane.py:113).  One block is
    unpack(w, nl)."""
    wl = words_for(nl)
    s = w.shape[-1] // wl
    if s == 1:
        return unpack(w, nl)
    return unpack(w.reshape(w.shape[:-1] + (s, wl)), nl).reshape(w.shape[:-1] + (s * nl,))


def test_cols(w: torch.Tensor, cols: torch.Tensor, nl: int) -> torch.Tensor:
    """Bit test at GLOBAL node ids `cols` in [0, S*nl) of a plane of blocks
    of `nl` bits: bool with shape w.shape[:-1] + cols.shape, the packed
    ``dense[..., cols]`` (the JAX package's bitplane.py:127; with one block
    the shard term vanishes)."""
    cols = cols.to(torch.int64)
    s = torch.div(cols, nl, rounding_mode="floor")
    loc = cols - s * nl
    word = s * words_for(nl) + torch.div(loc, WORD_BITS, rounding_mode="floor")
    bit = loc % WORD_BITS
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
    """Set bit ``cols[i]`` (global ids) where ``on[i]`` on a plane of blocks
    of `nl` bits (OR semantics: duplicate columns are fine); ids == S*nl
    are dropped, as in the JAX version's scatter (bitplane.py:161).  The
    new bits pack per block, so block tail bits stay zero."""
    s = w.shape[-1] // words_for(nl)
    n = s * nl
    dense = torch.zeros(w.shape[:-1] + (n + 1,), dtype=torch.bool, device=w.device)
    tgt = torch.where(on, cols.to(torch.int64), n)
    dense[..., tgt] = True
    return w | pack_blocks(dense[..., :n], s)


def assign_cols(w: torch.Tensor, cols: torch.Tensor, on: torch.Tensor, nl: int) -> torch.Tensor:
    """Column ASSIGNMENT: bit ``cols[i]`` := ``on[..., i]`` on a plane of
    blocks of `nl` bits (the JAX package's bitplane.py:175).  Ids == S*nl
    are dropped (the kernels' sentinel); duplicate columns must carry equal
    values.  ``(w & ~touched) | new`` over touched/new word masks packed per
    block."""
    s = w.shape[-1] // words_for(nl)
    n = s * nl
    tgt = torch.clamp(cols.to(torch.int64), 0, n)
    touched = torch.zeros((n + 1,), dtype=torch.bool, device=w.device)
    touched[tgt] = True
    newbits = torch.zeros(w.shape[:-1] + (n + 1,), dtype=torch.bool, device=w.device)
    # duplicates carry equal values, so which write lands is immaterial
    newbits[..., tgt] = on
    tw = pack_blocks(touched[:n], s)
    nw = pack_blocks(newbits[..., :n], s)
    return (w & ~tw) | nw


def stitch_planes_plain(w: torch.Tensor, nl: int) -> torch.Tensor:
    """Tiled blocks of `nl` bits [..., S*words(nl)] -> the flat layout
    [..., words(S*nl)]: the plain version of kernel K17 stitch_planes."""
    return pack(unpack_blocks(w, nl))


def stitch_planes(w: torch.Tensor, nl: int) -> torch.Tensor:
    """stitch_planes_plain on w's device: the plain version for CPU tensors,
    kernel K17 (csrc/stitch_planes.cu) for CUDA tensors."""
    from .scopes import subphase

    with subphase("hoist"):
        if w.device.type == "cpu":
            return stitch_planes_plain(w, nl)
        from . import kernels

        return kernels.stitch_planes(w, nl)


def unpack_planes(w: torch.Tensor, n: int) -> torch.Tensor:
    """unpack() on w's device: the plain version for CPU tensors, kernel K9
    unpack_planes for CUDA tensors."""
    from .scopes import subphase

    with subphase("hoist"):
        if w.device.type == "cpu":
            return unpack(w, n)
        from . import kernels

        return kernels.unpack_planes(w, n)


# ---------------------------------------------------------------------------
# score storage: bf16 (or f32 under KTPU_SCORE_DTYPE=f32), accumulated in
# f32 (the JAX package's bitplane.py:209-251)
# ---------------------------------------------------------------------------

def score_store_dtype() -> torch.dtype:
    """The dtype raw score planes (traw / naraw / image_score and their
    class rows) are STORED in: bf16 unless KTPU_SCORE_DTYPE=f32.  Consumers
    upcast to f32 before any reduction."""
    return torch.bfloat16 if SCORE_DTYPE == "bf16" else torch.float32


def quantize_scores(x: torch.Tensor) -> torch.Tensor:
    """A computed f32 raw score plane onto the storage lattice (bf16: round
    to nearest even, as XLA's f32 -> bf16 convert; f32: unchanged)."""
    return x.to(score_store_dtype())


def np_score_dtype() -> np.dtype:
    """The host storage dtype of a raw score plane: bf16 as its uint16 bit
    patterns (numpy has no bf16 type without ml_dtypes), else f32."""
    return np.dtype(np.uint16) if SCORE_DTYPE == "bf16" else np.dtype(np.float32)


def quantize_scores_np(x) -> np.ndarray:
    """Host mirror of quantize_scores: f32 values -> their bf16 bit patterns
    as uint16 (the rounding is torch's, the same round to nearest even), or
    the f32 values themselves under KTPU_SCORE_DTYPE=f32.  ``scores_of_np``
    turns either into a tensor of the storage dtype."""
    x = np.asarray(x, dtype=np.float32)
    if SCORE_DTYPE != "bf16":
        return x
    t = torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16).reshape(x.shape)


def bf16_of_np(bits: np.ndarray) -> torch.Tensor:
    """uint16 bf16 bit patterns (quantize_scores_np, or an ml_dtypes bf16
    array viewed as uint16) -> a CPU bf16 tensor."""
    bits = np.asarray(bits)
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16).copy()).view(torch.bfloat16).reshape(bits.shape)


def scores_of_np(a: np.ndarray) -> torch.Tensor:
    """A host score plane -> a CPU tensor of the storage dtype: a 2-byte
    array is bf16 (uint16 bit patterns or ml_dtypes bf16), anything else
    f32 values, quantized onto the storage lattice."""
    a = np.asarray(a)
    t = bf16_of_np(a) if a.dtype.itemsize == 2 else torch.from_numpy(np.array(a, dtype=np.float32))
    return t.to(score_store_dtype())


def score_values_np(a) -> np.ndarray:
    """A host score plane's f32 values: uint16 bf16 bit patterns widened
    (astype(float32) would read them as integers), anything else as f32."""
    a = np.asarray(a)
    if a.dtype == np.uint16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a.astype(np.float32)


def bf16_round_np(x):
    """f32 -> storage lattice -> f32 (what a value reads as once stored):
    the rounding the oracle and the native mirror apply to every raw score
    they compute.  Identity under KTPU_SCORE_DTYPE=f32."""
    if SCORE_DTYPE != "bf16":
        return np.float32(x) if np.isscalar(x) else np.asarray(x, np.float32)
    out = bf16_of_np(quantize_scores_np(x)).to(torch.float32).numpy()
    return np.float32(out) if out.ndim == 0 else out


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
