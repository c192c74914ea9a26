"""Torch oracles for the stream kernels, written as the JAX package's
``kernels/ref.py`` writes them: a loop over the 32 rows of a frame, and a
flat cumsum.  They share no code with the plain versions beside the kernels
(``bitpack``, ``quadmax``, ``scan_add``, ``unpack_delta``), so each checks
the other.

Layout: a frame is 4096 integers as a (32, 128) tile, linear stream order
``i = 4096 f + 128 r + l``.  A frame packed at bit width bw occupies exactly
(bw, 128) words: lane l packs its 32 values LSB-first into bw words.  Words
are int32 bit patterns (``core/bits.py``); any device.
"""

from __future__ import annotations

import torch

from ..core.bits import U32_MASK, i32, u32

FRAME_ROWS = 32
LANES = 128
FRAME_INTS = FRAME_ROWS * LANES


def _mask(bw: int) -> int:
    return 0xFFFFFFFF if bw >= 32 else (1 << bw) - 1


def pack_frames_ref(x, bw: int):
    """(F*32, 128) -> (F*bw, 128) packed at bw bits/value."""
    f = x.shape[0] // FRAME_ROWS
    x = u32(x).reshape(f, FRAME_ROWS, LANES)
    out = torch.zeros((f, bw, LANES), dtype=torch.int64, device=x.device)
    m = _mask(bw)
    for r in range(FRAME_ROWS):
        v = x[:, r, :] & m
        start = r * bw
        w, off = start // 32, start % 32
        out[:, w, :] |= (v << off) & U32_MASK
        if off + bw > 32:
            out[:, w + 1, :] |= v >> (32 - off)
    return i32(out).reshape(f * bw, LANES)


def unpack_frames_ref(packed, bw: int):
    """(F*bw, 128) -> (F*32, 128)."""
    f = packed.shape[0] // bw
    p = u32(packed).reshape(f, bw, LANES)
    out = torch.zeros((f, FRAME_ROWS, LANES), dtype=torch.int64,
                      device=packed.device)
    m = _mask(bw)
    for r in range(FRAME_ROWS):
        start = r * bw
        w, off = start // 32, start % 32
        v = p[:, w, :] >> off
        if off + bw > 32:
            v = v | ((p[:, w + 1, :] << (32 - off)) & U32_MASK)
        out[:, r, :] = v & m
    return i32(out).reshape(f * FRAME_ROWS, LANES)


def frame_or_ref(x):
    """(F*32, 128) -> (F, 128) per-frame per-lane OR (pseudo-max, §4.4)."""
    f = x.shape[0] // FRAME_ROWS
    x = x.reshape(f, FRAME_ROWS, LANES)
    out = x[:, 0, :]
    for r in range(1, FRAME_ROWS):
        out = out | x[:, r, :]
    return out


def prefix_sum_ref(x):
    """Inclusive prefix sum over the linear stream order of (R, 128) blocks."""
    return i32(torch.cumsum(u32(x).reshape(-1), 0)).reshape(x.shape)


def unpack_delta_ref(packed, bw: int):
    """Fused bit-unpack + d-gap prefix sum (decode gaps -> docids)."""
    return prefix_sum_ref(unpack_frames_ref(packed, bw))
