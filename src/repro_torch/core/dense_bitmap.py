"""Dense posting blocks as raw 128-word bitmaps.

Past a density threshold a sorted docid block is intersected fastest as an
uncompressed bitmap: word-parallel AND/probe, no unpack, no prefix-sum.  The
index build decides per block (:func:`eligible`); everything downstream
discovers the choice through the registry.

Wire format (one :class:`~repro_torch.core.encoded.Encoded` per block):

* ``fmt == "bitmap"``: ``data`` is exactly :data:`WINDOW_WORDS` uint32 words,
  bit ``p`` set iff the block contains ``base + p`` where ``base`` is the
  block's first prefix-sum (``control[1]``).
* ``fmt == "raw"``: verbatim uint32 values, the fallback that keeps the codec
  total over arbitrary streams.

Counterpart of the JAX package's ``core/dense_bitmap.py``;
``decode_arena_block`` is batched over ``(P, width)`` tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .bits import i32, u32
from .encoded import Encoded

WINDOW_WORDS = 128                       # bitmap window: 128 uint32 words
WINDOW_BITS = WINDOW_WORDS * 32          # = 4096 docid positions
DENSE_GAP = 8                            # density cutoff: span <= DENSE_GAP * n
ARENA_BLOCK = 512                        # = codec.ARENA_BLOCK (codec imports us)

NAME = "dense_bitmap"


def eligible(ids: np.ndarray) -> bool:
    """Build-time density decision for one posting block's docids.

    Besides the density cutoff, the block must fit a 128-word window whose
    first word is rounded down to a 4-word phase (``w0 = (ids[0] >> 5) & ~3``).
    """
    n = len(ids)
    if n == 0:
        return False
    span = int(ids[-1]) - int(ids[0]) + 1
    w_last = int(ids[-1]) >> 5
    w0 = (int(ids[0]) >> 5) & ~3
    return span <= DENSE_GAP * n and w_last - w0 <= WINDOW_WORDS - 1


def is_bitmap(enc: Encoded) -> bool:
    """True iff this block is stored word-parallel servable (bitmap format)."""
    return enc.meta.get("fmt") == "bitmap" and enc.n > 0


def encode(vals: np.ndarray) -> Encoded:
    vals = np.ascontiguousarray(vals, dtype=np.uint32)
    n = int(vals.size)
    pos = np.cumsum(vals, dtype=np.uint64)
    fits = (n > 0 and int(pos[-1] - pos[0]) < WINDOW_BITS
            and (n == 1 or int(vals[1:].min()) >= 1))
    if fits:
        rel = (pos - pos[0]).astype(np.int64)
        bits = np.zeros(WINDOW_BITS, np.uint8)
        bits[rel] = 1
        data = np.packbits(bits, bitorder="little").view(np.uint32).copy()
        control = np.array([1, vals[0]], np.uint32)
        return Encoded(NAME, n, control, data, control_bits=64,
                       data_bits=WINDOW_BITS, meta={"fmt": "bitmap"})
    control = np.array([0, 0], np.uint32)
    return Encoded(NAME, n, control, vals.copy(), control_bits=64,
                   data_bits=32 * n, meta={"fmt": "raw"})


def decode_np(enc: Encoded) -> np.ndarray:
    if enc.meta.get("fmt") != "bitmap":
        return np.asarray(enc.data[:enc.n], np.uint32).copy()
    bits = np.unpackbits(np.asarray(enc.data, np.uint32).view(np.uint8),
                         bitorder="little")
    rel = np.flatnonzero(bits)
    if rel.size != enc.n:
        raise ValueError(f"bitmap block holds {rel.size} bits, n={enc.n}")
    pos = rel.astype(np.uint64) + np.uint64(enc.control[1])
    return np.diff(pos, prepend=np.uint64(0)).astype(np.uint32)


def block_positions(enc: Encoded) -> np.ndarray:
    """Bit positions relative to ``base`` for a bitmap-format block."""
    bits = np.unpackbits(np.asarray(enc.data, np.uint32).view(np.uint8),
                         bitorder="little")
    return np.flatnonzero(bits)


def decode_arena_block(ctrl, data, ctrl_len, data_len, n_valid):
    """Fixed-shape decode of P blocks at once (both formats).

    ``ctrl = [fmt, base]`` per row; bitmap rows recover the value stream by
    ranking set bits with a prefix sum and scattering bit positions into
    posting order, raw rows are an identity copy.  Both branches are computed
    and selected per row.
    """
    dev = data.device
    p = data.shape[0]
    fmt = ctrl[:, 0:1]
    base = u32(ctrl[:, 1])
    words = u32(data[:, :WINDOW_WORDS])
    bits = (words[:, :, None] >> torch.arange(32, device=dev)) & 1
    bits = bits.reshape(p, WINDOW_BITS)
    rank = torch.cumsum(bits, dim=1) - 1
    # raw rows read garbage as bits: ranks past the block drop into the pad
    scat = torch.where((bits == 1) & (rank < ARENA_BLOCK), rank, ARENA_BLOCK)
    posv = torch.arange(WINDOW_BITS, device=dev).expand(p, -1)
    pos = torch.zeros(p, ARENA_BLOCK + 1, dtype=torch.int64, device=dev)
    pos.scatter_add_(1, scat, torch.where(bits == 1, posv, 0))
    pos = pos[:, :ARENA_BLOCK]
    prev = torch.cat([torch.zeros(p, 1, dtype=torch.int64, device=dev),
                      pos[:, :-1]], dim=1)
    gaps_bm = pos - prev
    gaps_bm[:, 0] += base
    gaps_raw = u32(data[:, :ARENA_BLOCK])
    out = torch.where(fmt == 1, gaps_bm, gaps_raw)
    idx = torch.arange(ARENA_BLOCK, device=dev)
    return i32(torch.where(idx[None, :] < n_valid.to(torch.int64)[:, None],
                           out, 0))
