"""Per-frame pseudo-max by OR reduction (kernel B9 of the port; paper §4.4).

Counterpart of the JAX package's ``kernels/quadmax.py``.  The paper
replaces the 4-way compare-max with a logical OR, which has the same
effective bit width and no comparisons.  :func:`frame_or` ORs each (32, 128)
frame over its rows into one (1, 128) row; ``ops.select_bw`` folds the 128
lanes.

:func:`frame_or` is kernel B9 (``csrc/stream.cu``), replacing the Pallas
kernel ``frame_or`` (body ``_frame_or_kernel``): one 128-thread block per
frame, one thread per lane ORs its 32 rows.  What bounds it on the H100 is
bytes: 16 KB read and 512 B written per frame.  A CPU tensor runs the plain
version; a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import count_launch, cuda_build
from .bitpack import FRAME_ROWS, LANES, check_tiles

_OR_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_void_p]


def frame_or(x):
    """(F*32, 128) int32 words -> (F, 128): the OR over each frame's rows."""
    f = check_tiles(x, "x", FRAME_ROWS)
    if not x.is_cuda:
        return frame_or_plain(x)
    out = torch.empty((f, LANES), dtype=torch.int32, device=x.device)
    if f:
        fn = cuda_build.function("stream", "repro_frame_or", _OR_ARGS)
        with torch.cuda.device(x.device):
            err = fn(x.data_ptr(), out.data_ptr(), f,
                     cuda_build.stream_ptr(x))
        cuda_build.check(err, "stream", f"repro_frame_or(frames={f})")
        count_launch("B9", frames=f)
    return out


def frame_or_plain(x):
    """Plain torch version of :func:`frame_or`: five halving folds of the
    32 rows (torch has no OR reduction)."""
    t = x.reshape(-1, FRAME_ROWS, LANES)
    while t.shape[1] > 1:
        h = t.shape[1] // 2
        t = t[:, :h] | t[:, h:]
    return t[:, 0].contiguous()
