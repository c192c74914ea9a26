"""Group-AFOR (paper §6.1): adaptive frames over the quad max array.

Frame sizes {32, 64, 128} integers = {8, 16, 32} quadruples.  The optimal
partition minimizes total bits via dynamic programming on the quad max array
(boundaries land on 8-quad blocks because all sizes are multiples of 8).
Header: 1 byte per frame = 2-bit size code + 6-bit bit width.

Counterpart of the JAX package's ``core/group_afor.py``: ``encode`` and
``decode_np`` are its numpy code; ``torch_args`` / ``decode_torch_vec`` /
``decode_torch_scalar`` the torch forms of its JAX decoders, and
``decode_arena_block`` its device-arena decode, batched over ``(P, width)``
tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .bits import ebw_np
from .encoded import Encoded
from .frames import (pack_data, quads_of, unpack_data, unpack_data_np,
                     unpack_data_scalar, words_of)
from .layout import quadmax_np

SIZES_Q = np.array([8, 16, 32])          # frame sizes in quadruples
HEADER_BITS = 8

# device-arena geometry: one 512-posting index block is at most ARENA_Q
# quadruples, partitioned into frames of >= SIZES_Q.min() quads each
ARENA_Q = 128
ARENA_F = ARENA_Q // 8


def _partition(qm_ebw: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """DP partition -> (sizes_in_quads, bw) per frame."""
    q = len(qm_ebw)
    nb = (q + 7) // 8
    e = np.concatenate([qm_ebw, np.zeros(nb * 8 - q, np.int32)])
    bmax1 = e.reshape(-1, 8).max(axis=1)                       # max over 1 block
    bmax2 = np.maximum(bmax1[:-1], bmax1[1:]) if nb > 1 else np.zeros(0, np.int32)
    bmax4 = (np.maximum(bmax2[:-2], bmax2[2:]) if nb > 3 else np.zeros(0, np.int32))
    bmax1 = np.maximum(bmax1, 1)  # a frame of all zeros still needs bw >= 1
    dp = np.zeros(nb + 1, dtype=np.int64)
    choice = np.zeros(nb, dtype=np.int8)
    for i in range(nb - 1, -1, -1):
        best = HEADER_BITS + 32 * 1 * int(bmax1[i]) + dp[i + 1]
        ch = 0
        if i + 2 <= nb:
            c = HEADER_BITS + 32 * 2 * int(max(bmax2[i], 1)) + dp[i + 2]
            if c < best:
                best, ch = c, 1
        if i + 4 <= nb:
            c = HEADER_BITS + 32 * 4 * int(max(bmax4[i], 1)) + dp[i + 4]
            if c < best:
                best, ch = c, 2
        dp[i] = best
        choice[i] = ch
    sizes, bws = [], []
    i = 0
    while i < nb:
        ch = int(choice[i])
        nblocks = (1, 2, 4)[ch]
        sizes.append(nblocks * 8)
        if ch == 0:
            bws.append(int(bmax1[i]))
        elif ch == 1:
            bws.append(int(max(bmax2[i], 1)))
        else:
            bws.append(int(max(bmax4[i], 1)))
        i += nblocks
    return np.asarray(sizes, np.int32), np.asarray(bws, np.int32)


def encode(x: np.ndarray) -> Encoded:
    x = np.asarray(x, dtype=np.uint32)
    n = len(x)
    if n == 0:
        return Encoded("group_afor", 0, np.zeros(0, np.uint8), np.zeros(0, np.uint32),
                       header_bits=32, meta={"Q": 0})
    v = quads_of(x)
    qm = quadmax_np(x, 4, pseudo=True)
    e = ebw_np(qm)
    sizes, bws = _partition(e)
    q = len(qm)
    bw_quads = np.repeat(bws, sizes)[:q]  # DP padded to 8-quad blocks; trim
    # tail frame may extend past Q; packing uses only the first Q quads
    data, dbits = pack_data(v, bw_quads)
    size_code = np.searchsorted(SIZES_Q, sizes).astype(np.uint8)
    control = (size_code | (bws.astype(np.uint8) << 2))
    return Encoded(
        "group_afor", n, control, data.reshape(-1),
        control_bits=len(control) * 8, data_bits=dbits * 4, header_bits=32,
        meta={"Q": q, "sizes": sizes, "bws": bws},
    )


def decode_np(enc: Encoded) -> np.ndarray:
    if enc.n == 0:
        return np.zeros(0, np.uint32)
    q = enc.meta["Q"]
    sizes = (enc.control & 3).astype(np.int64)
    sizes = SIZES_Q[sizes]
    bws = (enc.control >> 2).astype(np.int32)
    bw_quads = np.repeat(bws, sizes)[:q]
    return unpack_data_np(enc.data.reshape(-1, 4), bw_quads, enc.n)


# --------------------------------------------------------------------------- #
# torch decoders
# --------------------------------------------------------------------------- #


def torch_args(enc: Encoded, device="cuda") -> dict:
    """``decode_torch_vec`` / ``decode_torch_scalar`` keyword arguments, the
    tensors on ``device``.  ``frame_q`` is the frames' total quads (the
    tail frame may reach past ``q``): the exact size of the repeat."""
    control = np.asarray(enc.control).astype(np.int32)
    return {
        "control": torch.as_tensor(control, device=device),
        "data": words_of(enc.data, device),
        "n": enc.n,
        "q": enc.meta["Q"],
        "frame_q": int(SIZES_Q[control & 3].sum()),
    }


def _bw_quads(control: torch.Tensor, q: int, frame_q: int) -> torch.Tensor:
    sizes = (8 << (control & 3)).clamp(max=32)   # SIZES_Q[code]
    return torch.repeat_interleave(control >> 2, sizes,
                                   output_size=frame_q)[:q]


def decode_torch_vec(control, data, n: int, q: int, frame_q: int):
    return unpack_data(data, _bw_quads(control, q, frame_q), n)


def decode_torch_scalar(control, data, n: int, q: int, frame_q: int):
    return unpack_data_scalar(data, _bw_quads(control, q, frame_q), n, q)


def decode_arena_block(ctrl, data, ctrl_len, data_len, n_valid):
    """Fixed-shape decode of P blocks at once for the device arena.

    ctrl:  (P, ARENA_F) int32 frame headers (2-bit size code | 6-bit bw);
           columns >= ``ctrl_len`` are arena slack and are masked out.
    data:  (P, 4 * (W + 2)) int32 words gathered from the data arena
           (trailing slack rows feed only bw=0 quads / masked reads).
    ctrl_len, data_len, n_valid: (P,) word / integer counts of each block.
    Returns (P, 4 * ARENA_Q) int32 words, zero beyond ``n_valid``.
    """
    dev = ctrl.device
    p, fmax = ctrl.shape
    c = ctrl.to(torch.int64)
    f_valid = (torch.arange(fmax, device=dev)[None, :]
               < ctrl_len.to(torch.int64)[:, None])
    sizes = torch.where(f_valid, (8 << (c & 3)).clamp(max=32), 0)
    bws = c >> 2
    starts = torch.cumsum(sizes, dim=1) - sizes
    # per-quad frame id via boundary marks (the group_simple arena idiom):
    # frames are >= 8 quads so valid starts are strictly increasing; every
    # dropped mark lands in the spare last column
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
