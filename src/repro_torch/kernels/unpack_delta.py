"""Fused bit-unpack + d-gap prefix sum (kernel B6 of the port).

Counterpart of the JAX package's ``kernels/unpack_delta.py``.  The two-pass
decode unpacks gaps to memory (B7b) and scans them (B8); the fused decode
reads the packed words, unpacks in registers, scans and writes docids, with
no gap array in device memory.

:func:`unpack_delta_frames` is kernel B6 (``csrc/stream.cu``), replacing the
Pallas kernel ``unpack_delta_frames`` (body ``_unpack_delta_kernel``), whose
carry sat in SMEM across a grid that ran in order.  On the card it is
reduce-then-scan in three launches: per frame, unpack and sum its 4096 gaps
in registers (writing no gaps); one block's exclusive scan of the frame
totals; per frame, unpack again, scan in linear order ``4096 f + 128 r + l``
and add its carry.  Sums wrap mod 2**32.  What bounds it on the H100 is
bytes: the packed words (read twice, 512 bw B per frame) and 16 KB of docids
written per frame.  A CPU tensor runs the plain version; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import count_launch, cuda_build
from .bitpack import (FRAME_ROWS, LANES, check_bw, check_tiles,
                      unpack_frames_plain)
from .scan_add import prefix_sum_blocks_plain

_DELTA_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                       ctypes.c_void_p]


def unpack_delta_frames(packed, bw: int):
    """(F*bw, 128) packed gaps -> (F*32, 128) docids (inclusive prefix sum
    of the gaps mod 2**32, in linear order)."""
    bw = check_bw(bw)
    f = check_tiles(packed, "packed", bw)
    if not packed.is_cuda:
        return unpack_delta_frames_plain(packed, bw)
    out = torch.empty((f * FRAME_ROWS, LANES), dtype=torch.int32,
                      device=packed.device)
    if f:
        totals = torch.empty(f, dtype=torch.int32, device=packed.device)
        fn = cuda_build.function("stream", "repro_unpack_delta", _DELTA_ARGS)
        with torch.cuda.device(packed.device):
            err = fn(packed.data_ptr(), out.data_ptr(), totals.data_ptr(), f,
                     bw, cuda_build.stream_ptr(packed))
        cuda_build.check(err, "stream",
                         f"repro_unpack_delta(frames={f}, bw={bw})")
        count_launch("B6", frames=f, bw=bw)
    return out


def unpack_delta_frames_plain(packed, bw: int):
    """Plain torch version of :func:`unpack_delta_frames`: the plain unpack,
    then the plain scan."""
    return prefix_sum_blocks_plain(unpack_frames_plain(packed, bw))
