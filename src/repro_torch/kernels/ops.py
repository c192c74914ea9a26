"""Stream-level entry points of the stream codec: encoder and decoder over
flat word streams, on the stream kernels.

Counterpart of the JAX package's ``kernels/ops.py``.  Streams are flat
tensors of uint32 words held as int32 bit patterns (``core/bits.py``); other
integer dtypes are taken as values in [0, 2**32).  The wrappers do the
pad-to-frame plumbing around the kernels:

  select_bw           B9 (frame_or), then the cross-lane OR and bit length
  pack_stream         B7a
  unpack_stream       B7b
  prefix_sum          B8
  unpack_delta_stream B6 (the fused decode; unpack + prefix_sum is the
                      two-pass one)

What the reference computes in ``jnp`` around its kernels stays plain torch
here, on the tensor's device: the padding, the cross-lane OR fold of
``select_bw`` and its bit length.  A CPU stream runs every kernel's plain
version; a CUDA stream launches the kernels.
"""

from __future__ import annotations

import torch

from ..core.bits import i32, u32
from . import bitpack, quadmax, scan_add, unpack_delta
from .bitpack import FRAME_INTS, FRAME_ROWS, LANES


def _words(x):
    x = x.reshape(-1)
    return x if x.dtype == torch.int32 else i32(x.to(torch.int64))


def pad_to_frames(x):
    """Flat (n,) -> (F*32, 128) row-major tiles (linear order preserved;
    at least one frame, zero-padded, starting on a 16-byte boundary)."""
    x = _words(x)
    n = x.shape[0]
    f = max(1, -(-n // FRAME_INTS))
    pad = f * FRAME_INTS - n
    if pad:
        x = torch.cat([x, x.new_zeros(pad)])
    elif x.data_ptr() % 16:        # B8 loads uint4: a copy of its own
        x = x.clone()
    return x.reshape(f * FRAME_ROWS, LANES)


def pack_stream(x, bw: int):
    """Pack a flat word stream at fixed bit width bw -> (F*bw, 128) words."""
    return bitpack.pack_frames(pad_to_frames(x), bw)


def unpack_stream(packed, bw: int, n: int):
    """(F*bw, 128) packed words -> the first ``n`` values, flat."""
    return bitpack.unpack_frames(packed, bw).reshape(-1)[:n]


def bit_length(x):
    """Bit length (32 - clz) of each word, exact: a five-step binary search
    on logical shifts (a float log2 rounds above 2**24)."""
    v = u32(x)
    n = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        big = (v >> s) != 0
        n = n + torch.where(big, s, 0)
        v = torch.where(big, v >> s, v)
    return n + (v != 0).to(v.dtype)


def select_bw(x):
    """Per-frame bit width from the OR pseudo-max (paper §4.4 on the
    (32, 128) tiles): (F,) int32, at least 1."""
    t = quadmax.frame_or(pad_to_frames(x))                  # (F, 128)
    w = LANES
    while w > 1:                                   # cross-lane OR, log-step
        t = t[:, : w // 2] | t[:, w // 2: w]
        w //= 2
    return torch.clamp(bit_length(t[:, 0]), min=1).to(torch.int32)


def prefix_sum(x):
    """Inclusive prefix sum mod 2**32 of a flat word stream (d-gap
    decode)."""
    n = x.reshape(-1).shape[0]
    return scan_add.prefix_sum_blocks(pad_to_frames(x)).reshape(-1)[:n]


def unpack_delta_stream(packed, bw: int, n: int):
    """Fused unpack + prefix sum: packed gaps -> the first ``n`` docids."""
    return unpack_delta.unpack_delta_frames(packed, bw).reshape(-1)[:n]
