"""Shared machinery for the frame-based Group codecs (paper §6).

A frame codec assigns one bit width to a *run of quadruples*; after expanding
per-frame headers to a per-quad bit-width array, packing/unpacking is identical
for Group-AFOR, Group-PFD, (SIMD-)BP128 and Group-PackedBinary: four vertical
component bitstreams, values of bw[q] bits at offset cumsum(bw)[q-1].

Counterpart of the JAX package's ``core/frames.py``: ``pack_data``,
``unpack_data_np`` and ``quads_of`` are its numpy code; :func:`unpack_data`
(the vectorized unpack, batched over leading axes) and
:func:`unpack_data_scalar` (one quadruple a step) are the torch forms of its
``unpack_data_jnp`` and ``unpack_data_scalar_jnp``.
"""

from __future__ import annotations

import numpy as np
import torch

from .bits import (U32_MASK, from_np, gather_bits_np, i32, mask, mask_np,
                   pack_bits_np, u32)
from .layout import to_vertical_np


def pack_data(v: np.ndarray, bw: np.ndarray) -> tuple[np.ndarray, int]:
    """Pack (Q, 4) ints with bw[q] bits per value into a (W, 4) word array."""
    bw = np.asarray(bw, dtype=np.int64)
    msk = mask_np(bw).astype(np.uint64)
    cols, total = [], 0
    for c in range(4):
        w, total = pack_bits_np(v[:, c].astype(np.uint64) & msk, bw)
        cols.append(w)
    if total == 0:
        return np.zeros((0, 4), np.uint32), 0
    return np.stack(cols, axis=1), total


def unpack_data_np(data: np.ndarray, bw: np.ndarray, n: int) -> np.ndarray:
    bw = np.asarray(bw, dtype=np.int64)
    ends = np.cumsum(bw)
    offs = ends - bw
    out = np.stack([gather_bits_np(data[:, c], offs, bw) for c in range(4)], axis=1)
    return out.reshape(-1)[:n]


def unpack_data(data: torch.Tensor, bw: torch.Tensor, n: int) -> torch.Tensor:
    """Vectorized unpack of the four component streams.

    data: (..., W + 1, 4) int32 words with >= 1 slack row past the last
        value's word; bw: (..., Q) per-quad bit widths (0..32), the same
        leading axes.  Returns (..., n) int32 words (n <= 4 * Q).
    """
    bw = bw.to(torch.int64)
    offs = torch.cumsum(bw, dim=-1) - bw
    word = (offs >> 5).unsqueeze(-1).expand(*offs.shape, 4)
    bit = (offs & 31).unsqueeze(-1)
    d = u32(data)
    lo = torch.gather(d, -2, word)
    hi = torch.gather(d, -2, word + 1)
    val = (lo >> bit) | torch.where(bit == 0, 0, (hi << (32 - bit)) & U32_MASK)
    val = val & mask(bw).unsqueeze(-1)
    return i32(val.reshape(*val.shape[:-2], -1)[..., :n])


def unpack_data_scalar(data: torch.Tensor, bw: torch.Tensor, n: int,
                       q: int) -> torch.Tensor:
    """Scalar unpack: one quadruple per loop step (the paper's non-SIMD
    decode).  The bit position is carried on the device, so the loop never
    waits for the card.  data: (W + 1, 4) int32, bw: (>= q,) widths."""
    d = u32(data)
    bws = bw[:q].to(torch.int64)
    pos = torch.zeros(1, dtype=torch.int64, device=data.device)
    out = []
    for j in range(q):
        bwq = bws[j:j + 1]
        w = pos >> 5
        b = pos & 31
        lo = torch.index_select(d, 0, w)[0]
        hi = torch.where(b == 0, 0,
                         (torch.index_select(d, 0, w + 1)[0] << (32 - b))
                         & U32_MASK)
        out.append(((lo >> b) | hi) & mask(bwq))
        pos = pos + bwq
    if not out:
        return torch.zeros(0, dtype=torch.int32, device=data.device)
    return i32(torch.cat(out)[:n])


def quads_of(x: np.ndarray) -> np.ndarray:
    return to_vertical_np(np.asarray(x, np.uint32), 4)


def words_of(enc_data: np.ndarray, device, slack_rows: int = 1) -> torch.Tensor:
    """An encoded block's (W, 4) data words with ``slack_rows`` zero rows
    appended, as an int32 tensor on ``device`` (the ``torch_args`` layout)."""
    data = np.asarray(enc_data, np.uint32).reshape(-1, 4)
    return from_np(np.concatenate([data, np.zeros((slack_rows, 4), np.uint32)]),
                   device)
