"""Stream VByte (Lemire, Kurz & Rupp 2018): byte-aligned codec with a
*separated* control stream, the index's fast path for short posting lists:

  control[i // 4] bits 2*(i%4) .. 2*(i%4)+1  =  nbytes(x[i]) - 1   (1..4 bytes)
  data = concat(little-endian payload bytes of each x[i])

Counterpart of the JAX package's ``core/stream_vbyte.py``: ``encode`` and
``decode_np`` are its numpy code; ``torch_args`` / ``decode_torch_vec`` (all
byte lengths at once, one gather per byte slot) / ``decode_torch_scalar`` (one
integer a step) are the torch forms of its JAX decoders, and
``decode_arena_block`` is the device-arena decode in torch, batched over
``(P, width)`` tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .bits import ebw_np, from_np, i32
from .encoded import Encoded

NAME = "stream_vbyte"


def encode(x: np.ndarray) -> Encoded:
    x = np.asarray(x, dtype=np.uint32)
    n = len(x)
    if n == 0:
        return Encoded(NAME, 0, np.zeros(0, np.uint8), np.zeros(0, np.uint8),
                       header_bits=32)
    nb = np.maximum(1, -(-ebw_np(x) // 8)).astype(np.int64)        # 1..4 bytes
    pad = (-n) % 4
    codes = np.concatenate([nb - 1, np.zeros(pad, np.int64)]).reshape(-1, 4)
    control = (codes[:, 0] | (codes[:, 1] << 2) | (codes[:, 2] << 4)
               | (codes[:, 3] << 6)).astype(np.uint8)
    ends = np.cumsum(nb)
    total = int(ends[-1])
    starts = ends - nb
    data = np.zeros(total, np.uint8)
    for j in range(4):
        sel = nb > j
        data[starts[sel] + j] = (x[sel].astype(np.uint64) >> np.uint64(8 * j)).astype(np.uint8)
    return Encoded(NAME, n, control, data, control_bits=len(control) * 8,
                   data_bits=total * 8, header_bits=32)


def decode_np(enc: Encoded) -> np.ndarray:
    n = enc.n
    if n == 0:
        return np.zeros(0, np.uint32)
    ctrl = enc.control
    codes = np.stack([(ctrl >> (2 * c)) & 3 for c in range(4)], axis=1)
    nb = codes.astype(np.int64).reshape(-1)[:n] + 1
    ends = np.cumsum(nb)
    starts = ends - nb
    by = np.concatenate([enc.data, np.zeros(4, np.uint8)])
    vals = np.zeros(n, np.uint64)
    for j in range(4):
        sel = nb > j
        vals[sel] |= by[starts[sel] + j].astype(np.uint64) << np.uint64(8 * j)
    return vals.astype(np.uint32)


def torch_args(enc: Encoded, device="cuda") -> dict:
    """``decode_torch_vec`` / ``decode_torch_scalar`` keyword arguments: the
    byte streams widened to one word a byte on ``device``, with slack so
    the quadruple gather never reads past the end."""
    control = np.concatenate([enc.control, np.zeros(1, np.uint8)]).astype(np.uint32)
    data = np.concatenate([enc.data, np.zeros(4, np.uint8)]).astype(np.uint32)
    return {"control": from_np(control, device), "data": from_np(data, device),
            "n": enc.n}


def decode_torch_vec(control: torch.Tensor, data: torch.Tensor,
                     n: int) -> torch.Tensor:
    """SIMD-style decode: all byte-lengths at once, one gather per byte slot."""
    dev = data.device
    i = torch.arange(n, device=dev)
    code = (control.to(torch.int64)[i >> 2] >> ((i & 3) * 2)) & 3
    nb = code + 1
    starts = torch.cumsum(nb, 0) - nb
    by = data.to(torch.int64)
    val = torch.zeros(n, dtype=torch.int64, device=dev)
    for j in range(4):
        val = val | torch.where(j < nb, by[starts + j] << (8 * j), 0)
    return i32(val)


def decode_torch_scalar(control: torch.Tensor, data: torch.Tensor,
                        n: int) -> torch.Tensor:
    """Sequential decode: one integer per loop step, the byte position
    carried on the device."""
    dev = data.device
    ctrl = control.to(torch.int64)
    by = data.to(torch.int64)
    pos = torch.zeros(1, dtype=torch.int64, device=dev)
    out = []
    for i in range(n):
        nb = ((ctrl[i >> 2:(i >> 2) + 1] >> ((i & 3) * 2)) & 3) + 1
        val = torch.index_select(by, 0, pos)
        for j in range(1, 4):
            val = val | torch.where(nb > j, torch.index_select(by, 0, pos + j)
                                    << (8 * j), 0)
        out.append(val)
        pos = pos + nb
    if not out:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    return i32(torch.cat(out))


def decode_arena_block(control: torch.Tensor, data: torch.Tensor,
                       ctrl_len: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """Fixed-shape decode of P blocks at once for the device arena.

    control: (P, C_MAX) int32, one control byte per entry (entries past
             ``ctrl_len`` are arena slack; every read they feed is masked).
    data:    (P, D_MAX) int32, one payload byte per entry, with >= 3 entries
             of slack past the worst-case block.
    Returns (P, 4 * C_MAX) int32 words, zero beyond ``n_valid``.
    """
    dev = control.device
    nmax = 4 * control.shape[1]
    i = torch.arange(nmax, device=dev)
    ctrl = control.to(torch.int64) & 0xFF
    code = (ctrl[:, i >> 2] >> ((i & 3) * 2)[None, :]) & 3
    live = i[None, :] < n_valid.to(torch.int64)[:, None]
    # invalid lanes consume 0 payload bytes so every valid lane's byte offset
    # is unaffected by slack
    nb = torch.where(live, code + 1, 0)
    starts = torch.cumsum(nb, dim=1) - nb
    by = data.to(torch.int64) & 0xFF
    val = torch.zeros_like(starts)
    for j in range(4):
        byte = torch.gather(by, 1, starts + j)
        val = val | torch.where(nb > j, byte << (8 * j), 0)
    return i32(torch.where(live, val, 0))
