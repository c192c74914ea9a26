"""Inclusive prefix sum of (R, 128) words in row-major order (kernel B8 of
the port; d-gap decode, paper §2.1.1).

Counterpart of the JAX package's ``kernels/scan_add.py``.  Reconstructing
docids from d-gaps is a prefix sum; sums wrap mod 2**32 (docids < 2**32).

:func:`prefix_sum_blocks` is kernel B8 (``csrc/stream.cu``), replacing the
Pallas kernel ``prefix_sum_blocks`` (body ``_scan_kernel``).  The TPU grid
ran in order and carried the running sum in SMEM from block to block; a
CUDA grid has no order.  The kernel is a single-pass scan with decoupled
look-back: one grid launch, after one memset of its scratch (a status word
per 64-row tile and the ticket that hands tiles out in launch order).  Each
tile scans its 8192 words in registers, publishes its sum, and adds the
sums its predecessors published.  What bounds it on the H100 is bytes:
512 B read and 512 B written per row, and it reads and writes each word
once.  No pass is ``torch.cumsum``.  The tensor must start on a 16-byte
boundary (uint4 loads); the tiles of ``ops.pad_to_frames`` do.  A CPU
tensor runs the plain version; a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.bits import U32_MASK, cumsum_u32, i32
from . import count_launch, cuda_build
from .bitpack import check_aligned, check_tiles

TILE_ROWS = 64          # rows a block of the kernel scans (SCAN_TILE / 128)
# x, out, scratch, scratch words, rows, stream
_SCAN_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]


def prefix_sum_blocks(x):
    """(R, 128) int32 words -> inclusive prefix sum mod 2**32 in linear
    row-major order."""
    rows = check_tiles(x, "x")
    if not x.is_cuda:
        return prefix_sum_blocks_plain(x)
    check_aligned(x, "x")
    out = torch.empty_like(x)
    if rows:
        # one status word per tile, then the ticket
        scratch = torch.empty(-(-rows // TILE_ROWS) + 1, dtype=torch.int64,
                              device=x.device)
        fn = cuda_build.function("stream", "repro_prefix_sum", _SCAN_ARGS)
        with torch.cuda.device(x.device):
            err = fn(x.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                     scratch.numel(), rows, cuda_build.stream_ptr(x))
        cuda_build.check(err, "stream", f"repro_prefix_sum(rows={rows})")
        count_launch("B8", rows=rows)
    return out


def prefix_sum_blocks_plain(x):
    """Plain torch version of :func:`prefix_sum_blocks`, the Pallas body's
    two levels: a scan along each row's lanes, plus the exclusive prefix of
    the row totals."""
    c = cumsum_u32(x, dim=1)
    tot = c[:, -1]
    pref = (cumsum_u32(tot) - tot) & U32_MASK
    return i32(c + pref[:, None])

