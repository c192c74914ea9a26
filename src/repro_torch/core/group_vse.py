"""Group-VSEncoding (paper §6.1): VSEncoding wrapped in the Group approach.

VSEncoding partitions via dynamic programming over a richer frame-length set
than AFOR; the Group version multiplies lengths by 4 (quadruples) and runs the
DP on the quad max array.  Frame lengths (in quadruples): {1, 2, 4, 8, 12,
16, 32, 64}.  Header: 1 byte/frame = 3-bit length code | 5-bit bit width
(bw <= 32 fits).  Data: 4-way vertical component streams, same unpack
machinery as the other frame codecs.

Counterpart of the JAX package's ``core/group_vse.py``: ``encode`` and
``decode_np`` are its numpy code; ``torch_args`` / ``decode_torch_vec`` /
``decode_torch_scalar`` the torch forms of its JAX decoders, and
``decode_arena_block`` its device-arena decode, batched over ``(P, width)``
tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .bits import const, ebw_np
from .encoded import Encoded
from .frames import (pack_data, quads_of, unpack_data, unpack_data_np,
                     unpack_data_scalar, words_of)
from .layout import quadmax_np

SIZES_Q = np.array([1, 2, 4, 8, 12, 16, 32, 64])   # frame sizes in quadruples
HEADER_BITS = 8

# device-arena geometry: one 512-posting index block is at most ARENA_Q
# quadruples; the DP may emit frames as small as one quad
ARENA_Q = 128
ARENA_F = ARENA_Q


@functools.cache
def _sizes(device) -> torch.Tensor:
    """SIZES_Q on ``device``, made once per device (no copy per call)."""
    return const(SIZES_Q, device)


def _partition(e: np.ndarray):
    """DP over quad positions; steps = SIZES_Q: the reference's loop, run on
    plain Python ints (the window maxima taken as lists once), which gives
    the same partition several times faster on long lists."""
    q = len(e)
    sizes_q = [int(s) for s in SIZES_Q]
    # window maxima per size: max over [i, i+s) for every i that fits
    maxes = []
    for s in sizes_q:
        if s > q:
            break
        maxes.append(np.lib.stride_tricks.sliding_window_view(e, s)
                     .max(axis=1).tolist())
    dp = [0] * (q + 1)
    choice = [0] * q
    for i in range(q - 1, -1, -1):
        best, ch = None, 0
        for si, m in enumerate(maxes):
            s = sizes_q[si]
            if i + s > q:             # size 1 always fits; larger ones may not
                break
            cost = HEADER_BITS + 4 * s * max(m[i], 1) + dp[i + s]
            if best is None or cost < best:
                best, ch = cost, si
        dp[i] = best
        choice[i] = ch
    sizes, bws = [], []
    i = 0
    while i < q:
        s = sizes_q[choice[i]]
        m = int(e[i:min(i + s, q)].max(initial=0))
        sizes.append(s)
        bws.append(max(m, 1))
        i += s
    return np.asarray(sizes, np.int32), np.asarray(bws, np.int32)


def encode(x: np.ndarray) -> Encoded:
    x = np.asarray(x, dtype=np.uint32)
    n = len(x)
    if n == 0:
        return Encoded("group_vse", 0, np.zeros(0, np.uint8), np.zeros(0, np.uint32),
                       header_bits=32, meta={"Q": 0})
    v = quads_of(x)
    e = ebw_np(quadmax_np(x, 4, pseudo=True))
    sizes, bws = _partition(e)
    q = len(e)
    bw_quads = np.repeat(bws, sizes)[:q]
    data, dbits = pack_data(v, bw_quads)
    size_code = np.searchsorted(SIZES_Q, sizes).astype(np.uint8)
    control = np.stack([size_code, bws.astype(np.uint8)], axis=1).reshape(-1)
    return Encoded(
        "group_vse", n, control, data.reshape(-1),
        control_bits=len(sizes) * 16, data_bits=dbits * 4, header_bits=32,
        meta={"Q": q},
    )


def _headers(control: np.ndarray):
    c = control.reshape(-1, 2)
    return SIZES_Q[c[:, 0].astype(np.int64)].astype(np.int64), c[:, 1].astype(np.int32)


def decode_np(enc: Encoded) -> np.ndarray:
    if enc.n == 0:
        return np.zeros(0, np.uint32)
    sizes, bws = _headers(enc.control)
    bw_quads = np.repeat(bws, sizes)[: enc.meta["Q"]]
    return unpack_data_np(enc.data.reshape(-1, 4), bw_quads, enc.n)


# --------------------------------------------------------------------------- #
# torch decoders
# --------------------------------------------------------------------------- #


def torch_args(enc: Encoded, device="cuda") -> dict:
    """``decode_torch_vec`` / ``decode_torch_scalar`` keyword arguments, the
    tensors on ``device``.  ``frame_q`` is the frames' total quads: the
    exact size of the repeat."""
    control = np.asarray(enc.control).astype(np.int32)
    return {
        "control": torch.as_tensor(control, device=device),
        "data": words_of(enc.data, device),
        "n": enc.n,
        "q": enc.meta["Q"],
        "frame_q": int(_headers(control)[0].sum()),
    }


def _bw_quads(control: torch.Tensor, q: int, frame_q: int) -> torch.Tensor:
    c = control.reshape(-1, 2)
    sizes = _sizes(control.device)[c[:, 0].to(torch.int64).clamp(0, 7)]
    return torch.repeat_interleave(c[:, 1], sizes, output_size=frame_q)[:q]


def decode_torch_vec(control, data, n: int, q: int, frame_q: int):
    return unpack_data(data, _bw_quads(control, q, frame_q), n)


def decode_torch_scalar(control, data, n: int, q: int, frame_q: int):
    return unpack_data_scalar(data, _bw_quads(control, q, frame_q), n, q)


def decode_arena_block(ctrl, data, ctrl_len, data_len, n_valid):
    """Fixed-shape decode of P blocks at once for the device arena.

    ctrl:  (P, 2 * ARENA_F) int32 header bytes, interleaved (size code, bw)
           per frame; bytes >= ``ctrl_len`` are arena slack, masked out.
    data:  (P, 4 * (W + 2)) int32 words gathered from the data arena.
    ctrl_len, data_len, n_valid: (P,) word / integer counts of each block.
    Returns (P, 4 * ARENA_Q) int32 words, zero beyond ``n_valid``.
    """
    dev = ctrl.device
    p = ctrl.shape[0]
    c = ctrl.to(torch.int64).reshape(p, -1, 2)
    fmax = c.shape[1]
    f_valid = (torch.arange(fmax, device=dev)[None, :]
               < (ctrl_len.to(torch.int64) >> 1)[:, None])
    sizes = torch.where(f_valid, _sizes(dev)[c[:, :, 0].clamp(0, 7)], 0)
    bws = c[:, :, 1]
    starts = torch.cumsum(sizes, dim=1) - sizes
    # valid frames are >= 1 quad, so their starts are strictly increasing;
    # every dropped mark lands in the spare last column
    marks = torch.zeros(p, ARENA_Q + 1, dtype=torch.int64, device=dev)
    marks.scatter_add_(1, torch.where(f_valid, starts, ARENA_Q).clamp(max=ARENA_Q),
                       torch.ones_like(starts))
    fid = torch.clamp(torch.cumsum(marks[:, :ARENA_Q], dim=1) - 1, 0, fmax - 1)
    q = torch.arange(ARENA_Q, device=dev)
    n_valid = n_valid.to(torch.int64)[:, None]
    q_len = (n_valid + 3) >> 2
    bw_quads = torch.where(q[None, :] < q_len, torch.gather(bws, 1, fid), 0)
    out = unpack_data(data.reshape(p, -1, 4), bw_quads, 4 * ARENA_Q)
    i = torch.arange(4 * ARENA_Q, device=dev)
    return torch.where(i[None, :] < n_valid, out, 0)
