"""Group-PFD's whole-list decode: kernel PFD of the port, and its plain
version.

The JAX package has no Pallas site here: its ``decode_jax_vec`` is jnp
ops, and :func:`decode_list_plain` is the same three phases in torch
(``core/group_pfd.py``'s ``bw_quads``, ``frames.unpack_data``, and
``apply_exceptions``, the patch), some 120 small ops a list, each in its
``decode_list/`` span.  :func:`decode_list`
launches ``csrc/group_pfd.cu`` instead: the frame-offset scan, the unpack
and the patch of one list in one grid launch, a block of 1024 threads per
256 frames, a warp a frame (the design is in the source's header).  What
bounds it on the H100 is bytes, the encoded list read once and 4 B an
integer written, and for short lists the latency of a warp's loads; what
bounds a decode of many short lists is this wrapper's host time, so it
does one allocation (two for a list of more than one tile, whose
look-back needs status words) and one ``ctypes`` call.

Takes the tensors of ``core/group_pfd.py`` ``torch_args``: ``control``
one int32 a header byte, ``data`` the (W + 1, 4) int32 words with one
slack row, ``exceptions`` the exception stream with two slack words; ``n``
integers, ``q`` = ceil(n / 4) quadruples.  Returns ``n`` int32 words.  A
CPU tensor runs the plain version; a CUDA tensor launches the kernel or
raises.  Shared by ``group_pfd`` and ``group_optpfd`` (one format).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.frames import unpack_data
from ..core.group_pfd import FRAME_QUADS, apply_exceptions, bw_quads
from ..obs.trace import codec_tracer
from . import count_launch, cuda_build
from .bitpack import check_aligned

TILE_FRAMES = 256                 # frames a block of the kernel decodes
# control, data, exceptions, out, scratch; scratch words, n, q, control /
# data / exception lengths; device, stream
_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 6 + [ctypes.c_int,
                                                           ctypes.c_void_p]


def check_list_args(control, data, exceptions) -> int:
    """Validate what the kernel takes: int32, contiguous, one device,
    ``data`` (W + 1, 4) on a 16-byte boundary.  Returns the device's index.
    One expression on the path that passes, since it runs once a list."""
    d = data.get_device()
    if (control.dtype == data.dtype == exceptions.dtype == torch.int32
            and control.is_contiguous() and data.is_contiguous()
            and exceptions.is_contiguous() and control.get_device() == d
            and exceptions.get_device() == d and data.dim() == 2
            and data.shape[1] == 4 and data.data_ptr() % 16 == 0):
        return d
    for name, t in (("control", control), ("data", data),
                    ("exceptions", exceptions)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor, got "
                             f"{t.dtype}")
        if t.device != data.device:
            raise ValueError(f"{name} on {t.device}, data on {data.device}")
    if data.dim() != 2 or data.shape[1] != 4:
        raise ValueError(f"data must be (W + 1, 4), got {tuple(data.shape)}")
    check_aligned(data, "data")
    raise AssertionError("unreachable: every refused case raised above")


def decode_list(control, data, exceptions, n: int, q: int, total_exc: int):
    """One Group-PFD list, whole: on the card one launch of kernel PFD
    (none for ``n == 0``), on the CPU :func:`decode_list_plain`."""
    if not data.is_cuda:
        return decode_list_plain(control, data, exceptions, n, q, total_exc)
    dev = check_list_args(control, data, exceptions)
    out = torch.empty(n, dtype=torch.int32, device=data.device)
    if n == 0:
        return out
    frames = -(-q // FRAME_QUADS)
    tiles = -(-frames // TILE_FRAMES)
    # the look-back's status words, one a tile, then the ticket
    scratch = (torch.empty(tiles + 1, dtype=torch.int64, device=data.device)
               if tiles > 1 else None)
    fn = cuda_build.function("group_pfd", "repro_pfd_decode", _ARGS)
    err = fn(control.data_ptr(), data.data_ptr(), exceptions.data_ptr(),
             out.data_ptr(), None if scratch is None else scratch.data_ptr(),
             0 if scratch is None else tiles + 1, n, q, control.shape[0],
             data.shape[0], exceptions.shape[0], dev,
             cuda_build.stream_ptr(data))
    if err:
        cuda_build.check(err, "group_pfd", f"pfd_decode(n={n}, q={q})")
    count_launch("PFD", n=n, frames=frames, exc=total_exc)
    return out


# --------------------------------------------------------------------------- #
# the plain version
# --------------------------------------------------------------------------- #


def decode_list_plain(control, data, exceptions, n: int, q: int,
                      total_exc: int):
    """Plain torch version of :func:`decode_list` (any device), its three
    phases each in a ``decode_list/`` span (under the codec layer's
    ``decode_list/<codec>``)."""
    tracer = codec_tracer()
    with tracer.span("decode_list/widths", lane="device"):
        widths = bw_quads(control, q)
    with tracer.span("decode_list/unpack", lane="device"):
        out = unpack_data(data, widths, n)
    with tracer.span("decode_list/patch", lane="device"):
        return apply_exceptions(out, control, exceptions, n, total_exc)
