"""Bit utilities: the numpy encode-side helpers, and the one rule set for
32-bit words held in torch tensors.

numpy side (copied from the JAX package's ``core/bits.py``): effective bit
width, masks, the vectorized bit-stream writer and reader, and the unary
and bit-array helpers used by the encoders and ``decode_np`` oracles.

torch side: uint32 words are stored as **int32 bit patterns**.
``torch.uint32`` lacks ``>>``, ``+`` and ``scatter_add_`` on the CPU, so every
word tensor in the port is ``torch.int32`` and arithmetic that needs unsigned
semantics widens to int64 first:

* right shifts are logical: :func:`u32` widens to int64 in [0, 2**32), so a
  following ``>>`` shifts in zeros;
* prefix sums run in int64 and are masked to 32 bits (:func:`cumsum_u32`),
  which reproduces the reference's ``cumsum(..., dtype=uint32)`` wrap;
* bitmap word indices are computed unsigned (in int64) before the
  ``cand_words - 1`` clamp (:func:`word_index`);
* a bit-field read (:func:`gather_bits`) guards the ``bit == 0`` case (a
  shift by 32 is undefined in torch and in CUDA) and builds the mask of a
  32-bit field in int64.

Bit order convention (everywhere): LSB-first within a 32-bit word, words in
increasing index order.
"""

from __future__ import annotations

import numpy as np
import torch

U32_MASK = 0xFFFFFFFF

# --------------------------------------------------------------------------- #
# numpy (encode side)
# --------------------------------------------------------------------------- #


def ebw_np(x: np.ndarray) -> np.ndarray:
    """Effective bit width: minimum bits to represent x in binary. ebw(0) = 0."""
    x = np.asarray(x, dtype=np.uint64)
    # log2(x+1) is exact at powers of two in float64, and x+1 <= 2**32 is exact.
    return np.ceil(np.log2(x.astype(np.float64) + 1.0)).astype(np.int32)


def mask_np(bw) -> np.ndarray:
    """All-ones mask of bw bits as uint32 (bw may be an array; bw=32 handled)."""
    bw = np.asarray(bw, dtype=np.uint64)
    return ((np.uint64(1) << bw) - np.uint64(1)).astype(np.uint32)


def pack_bits_np(values: np.ndarray, lengths: np.ndarray) -> tuple[np.ndarray, int]:
    """Concatenate variable-length codes into a uint32 word stream.

    values[i] (< 2**lengths[i], lengths[i] <= 64) is written at bit offset
    cumsum(lengths)[i-1].  Returns (words: uint32[ceil(total/32)], total_bits).
    """
    values = np.asarray(values, dtype=np.uint64)
    lengths = np.asarray(lengths, dtype=np.int64)
    if values.size == 0:
        return np.zeros(0, dtype=np.uint32), 0
    if lengths.max(initial=0) > 64:
        raise ValueError("pack_bits_np supports codes up to 64 bits")
    ends = np.cumsum(lengths)
    total = int(ends[-1])
    offs = ends - lengths
    nw64 = total // 64 + 2  # slack word for the hi-part scatter
    buf = np.zeros(nw64, dtype=np.uint64)
    word = (offs >> 6).astype(np.int64)
    bit = (offs & 63).astype(np.uint64)
    np.bitwise_or.at(buf, word, values << bit)
    hi = np.where(bit == 0, np.uint64(0), values >> (np.uint64(64) - bit))
    np.bitwise_or.at(buf, word + 1, hi)
    words = buf.view(np.uint32)  # little-endian host assumed (x86/ARM)
    return words[: (total + 31) // 32].copy(), total


def gather_bits_np(words: np.ndarray, offs: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Read lengths[i] (<= 32) bits at bit offset offs[i] from a uint32 stream."""
    words = np.asarray(words, dtype=np.uint32)
    offs = np.asarray(offs, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.uint64)
    w = np.concatenate([words, np.zeros(2, dtype=np.uint32)])
    word = offs >> 5
    bit = (offs & 31).astype(np.uint64)
    lo = w[word].astype(np.uint64)
    hi = w[word + 1].astype(np.uint64)
    v = ((lo | (hi << np.uint64(32))) >> bit)
    msk = np.where(lengths >= 64, ~np.uint64(0), (np.uint64(1) << lengths) - np.uint64(1))
    return (v & msk).astype(np.uint32)


def unary_stream_np(counts: np.ndarray) -> tuple[np.ndarray, int]:
    """Encode counts[i] >= 1 as (counts[i]-1) one-bits + one zero-bit, LSB-first.

    Returns (words uint32, total_bits): the stream is all-ones with zeros at
    positions cumsum(counts)-1.
    """
    counts = np.asarray(counts, dtype=np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.uint32), 0
    nw = (total + 31) // 32
    bits = np.ones(nw * 32, dtype=np.uint8)
    zpos = np.cumsum(counts) - 1
    bits[zpos] = 0
    bits[total:] = 0  # pad with zeros past the end
    words = np.packbits(bits.reshape(-1, 32)[:, ::-1], axis=1, bitorder="big")
    words = words[:, ::-1].copy().view(np.uint32).reshape(-1)
    return words, total


def unary_decode_np(words: np.ndarray, total_bits: int, n: int) -> np.ndarray:
    """Decode the first n unary counts from a stream produced by unary_stream_np."""
    words = np.asarray(words, dtype=np.uint32)
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")[:total_bits]
    zpos = np.flatnonzero(bits == 0)[:n]
    prev = np.concatenate([[-1], zpos[:-1]])
    return (zpos - prev).astype(np.int64)


def bits_to_words_np(bits: np.ndarray) -> np.ndarray:
    """uint8 bit array (LSB-first stream order) -> uint32 words."""
    pad = (-len(bits)) % 32
    if pad:
        bits = np.concatenate([bits, np.zeros(pad, dtype=np.uint8)])
    by = np.packbits(bits, bitorder="little")
    padb = (-len(by)) % 4
    if padb:
        by = np.concatenate([by, np.zeros(padb, dtype=np.uint8)])
    return by.view(np.uint32)


def words_to_bits_np(words: np.ndarray, total_bits: int) -> np.ndarray:
    return np.unpackbits(np.asarray(words, np.uint32).view(np.uint8), bitorder="little")[:total_bits]


# --------------------------------------------------------------------------- #
# torch words (int32 bit patterns)
# --------------------------------------------------------------------------- #


def from_np(a: np.ndarray, device=None) -> torch.Tensor:
    """numpy uint32 (or any 32-bit int) array -> int32 bit-pattern tensor."""
    a = np.ascontiguousarray(a)
    if a.dtype.itemsize != 4 or a.dtype.kind not in "iu":
        a = a.astype(np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(device)


def const(a: np.ndarray, device, dtype=torch.int64) -> torch.Tensor:
    """A codec's constant table on ``device`` with no host sync: on the
    card, a pinned host copy queued asynchronously (a pageable copy would
    wait for the card)."""
    t = torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def to_np(t: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern tensor (or int64 in [0, 2**32)) -> numpy uint32."""
    t = t.detach()
    if t.dtype == torch.int64:
        t = i32(t)
    return t.cpu().numpy().view(np.uint32)


def u32(t: torch.Tensor) -> torch.Tensor:
    """Words as int64 values in [0, 2**32): shifts right are then logical."""
    return t.to(torch.int64) & U32_MASK


def i32(t: torch.Tensor) -> torch.Tensor:
    """int64 values -> their low 32 bits as an int32 bit pattern (mod 2**32)."""
    t = t & U32_MASK
    return (t - ((t >> 31) << 32)).to(torch.int32)


def cumsum_u32(t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inclusive prefix sum mod 2**32 (int64 result in [0, 2**32))."""
    return torch.cumsum(u32(t), dim=dim) & U32_MASK


def word_index(ids: torch.Tensor, cand_words: int) -> torch.Tensor:
    """Bitmap word of each docid, unsigned, clamped to ``cand_words - 1``."""
    return torch.clamp(u32(ids) >> 5, max=cand_words - 1)


def ebw(x: torch.Tensor) -> torch.Tensor:
    """Effective bit width of int32 bit-pattern words, ``32 - clz``, so
    ``ebw(0) == 0``: the binary exponent of the word's unsigned value as a
    float64, exact for every 32-bit word."""
    return torch.frexp(u32(x).to(torch.float64)).exponent.to(torch.int32)


def mask(bw: torch.Tensor) -> torch.Tensor:
    """All-ones masks of ``bw`` (0..32) bits, int64 (``bw == 32`` gives
    2**32 - 1)."""
    return (torch.ones_like(bw, dtype=torch.int64) << bw.to(torch.int64)) - 1


def gather_bits(words: torch.Tensor, offs: torch.Tensor,
                bws: torch.Tensor) -> torch.Tensor:
    """Read ``bws`` (<= 32) bits at bit offsets ``offs`` from int32 word
    streams: the counterpart of the JAX package's ``gather_bits_jnp``.

    words: (W,) or (P, W) int32 bit patterns with >= 1 slack word past the
        last offset read; a 2-D ``words`` is read row by row, with ``offs``
        of shape (P, N).
    offs, bws: integer tensors of one shape.
    Returns int64 values in [0, 2**32).
    """
    offs = offs.to(torch.int64)
    word = offs >> 5
    bit = offs & 31
    w = u32(words)
    if w.dim() == 1:
        lo, hi = w[word], w[word + 1]
    else:
        lo, hi = torch.gather(w, 1, word), torch.gather(w, 1, word + 1)
    # lo >> bit | hi << (32 - bit), in two 32-bit halves; the hi half is 0
    # where bit == 0 (a shift by 32)
    hi_part = torch.where(bit == 0, 0, (hi << (32 - bit)) & U32_MASK)
    return ((lo >> bit) | hi_part) & mask(bws)
