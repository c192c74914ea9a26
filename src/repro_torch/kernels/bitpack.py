"""Fixed-bit-width pack/unpack over the wide vertical layout (kernels B7a
and B7b of the port), and the lane geometry every stream kernel shares.

Counterpart of the JAX package's ``kernels/bitpack.py``.  A frame of 4096
integers is a (32, 128) tile: 128 lanes, 32 slots per lane, stream element
``4096 f + 128 r + l`` at row ``32 f + r``, lane ``l``.  Packing at bit width
``bw`` (1..32) emits exactly (bw, 128) words per frame: each lane squeezes
its 32 values, masked to ``bw`` bits, LSB-first into ``bw`` words.

* :func:`pack_frames`: kernel B7a (``csrc/stream.cu``), replacing the Pallas
  kernel ``pack_frames`` (body ``_pack_kernel``).
* :func:`unpack_frames`: kernel B7b (``csrc/stream.cu``), replacing
  ``unpack_frames`` (body ``_unpack_kernel``).

On the card one 128-thread block serves one frame, one thread per lane, with
``bw`` a template argument so every shift is a constant (the TPU form closed
over it at trace time); the TPU's ``frames_per_block`` VMEM tiling is not
carried over.  What bounds both on the H100 is bytes: 16 KB of values and
512 bw bytes of packed words per frame.  A wrapper given CPU tensors runs the
plain version; given CUDA tensors it launches the kernel or raises.  Words
are int32 bit patterns (``core/bits.py``).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.bits import U32_MASK, i32, u32
from . import count_launch, cuda_build

FRAME_ROWS = 32
LANES = 128
FRAME_INTS = FRAME_ROWS * LANES

_FRAMES_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_void_p]


def _mask(bw: int) -> int:
    """All-ones mask of ``bw`` bits (bw <= 32) as a Python int."""
    return 0xFFFFFFFF if bw >= 32 else (1 << bw) - 1


def check_tiles(t, name: str, rows_of: int = 1) -> int:
    """Check a kernel's word tensor: int32, contiguous, (R, 128) with R a
    multiple of ``rows_of``.  Returns R // rows_of."""
    if not isinstance(t, torch.Tensor) or t.dtype != torch.int32:
        raise TypeError(f"{name} must be an int32 tensor, got "
                        f"{getattr(t, 'dtype', type(t))}")
    if t.dim() != 2 or t.shape[1] != LANES or t.shape[0] % rows_of:
        raise ValueError(f"{name} must be (k * {rows_of}, {LANES}); got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.shape[0] // rows_of


def check_aligned(t, name: str) -> None:
    """Check that a kernel's word tensor starts on a 16-byte boundary, as
    the kernels that load and store it as uint4 need."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary (its "
                         f"data_ptr is {t.data_ptr():#x}); pass a copy")


def check_bw(bw) -> int:
    if not 1 <= int(bw) <= 32 or int(bw) != bw:
        raise ValueError(f"bit width must be an int in 1..32, got {bw!r}")
    return int(bw)


def frames_launch(symbol: str, kernel: str, src, out, frames: int, bw: int):
    """Launch one of ``csrc/stream.cu``'s per-frame kernels that take
    (src, out, frames, bw) and count it."""
    if frames:
        fn = cuda_build.function("stream", symbol, _FRAMES_ARGS)
        with torch.cuda.device(src.device):
            err = fn(src.data_ptr(), out.data_ptr(), frames, bw,
                     cuda_build.stream_ptr(src))
        cuda_build.check(err, "stream", f"{symbol}(frames={frames}, bw={bw})")
        count_launch(kernel, frames=frames, bw=bw)
    return out


def pack_frames(x, bw: int):
    """(F*32, 128) int32 words -> (F*bw, 128) packed at ``bw`` bits a value
    (values wider than ``bw`` are masked, as the reference masks them)."""
    bw = check_bw(bw)
    f = check_tiles(x, "x", FRAME_ROWS)
    if not x.is_cuda:
        return pack_frames_plain(x, bw)
    out = torch.empty((f * bw, LANES), dtype=torch.int32, device=x.device)
    return frames_launch("repro_pack_frames", "B7a", x, out, f, bw)


def unpack_frames(packed, bw: int):
    """(F*bw, 128) packed words -> (F*32, 128) int32 values."""
    bw = check_bw(bw)
    f = check_tiles(packed, "packed", bw)
    if not packed.is_cuda:
        return unpack_frames_plain(packed, bw)
    out = torch.empty((f * FRAME_ROWS, LANES), dtype=torch.int32,
                      device=packed.device)
    return frames_launch("repro_unpack_frames", "B7b", packed, out, f, bw)


def _field_geometry(bw: int, device):
    """Per row r of a frame: its first packed word r*bw >> 5 and bit offset
    r*bw & 31."""
    start = torch.arange(FRAME_ROWS, device=device) * bw
    return start >> 5, start & 31


def pack_frames_plain(x, bw: int):
    """Plain torch version of :func:`pack_frames`, all rows at once: each
    value's low part lands in word ``r*bw >> 5`` and the part past bit 32 in
    the next word; the parts' bits are disjoint, so an add is their OR."""
    f = x.shape[0] // FRAME_ROWS
    v = u32(x).reshape(f, FRAME_ROWS, LANES) & _mask(bw)
    word, off = _field_geometry(bw, x.device)
    off = off[None, :, None]
    out = torch.zeros((f, bw + 1, LANES), dtype=torch.int64, device=x.device)
    out.index_add_(1, word, (v << off) & U32_MASK)
    out.index_add_(1, word + 1, v >> (32 - off))
    return i32(out[:, :bw]).reshape(f * bw, LANES)


def unpack_frames_plain(packed, bw: int):
    """Plain torch version of :func:`unpack_frames`: gathers each row's two
    candidate words (a zero word past the last) and joins the high word's
    low ``off`` bits above the low word's high ``32 - off``, in 64 bits."""
    f = packed.shape[0] // bw
    p = torch.cat([u32(packed).reshape(f, bw, LANES),
                   torch.zeros((f, 1, LANES), dtype=torch.int64,
                               device=packed.device)], dim=1)
    word, off = _field_geometry(bw, packed.device)
    off = off[None, :, None]
    hi = (p[:, word + 1] & ((1 << off) - 1)) << (32 - off)
    v = (p[:, word] >> off) | hi
    return i32(v & _mask(bw)).reshape(f * FRAME_ROWS, LANES)
