"""(SIMD-)BP128 and Group-PackedBinary as special cases of the approach (§6.3).

BP128: fixed frames of 128 integers (32 quadruples), one 8-bit bw header per
frame, 4-way vertical layout.  Group-PackedBinary: same with 512-integer
frames (the paper's PackedBinary experimental setting).

Counterpart of the JAX package's ``core/bp128.py``: ``encode``,
``encode_packed_binary`` and ``decode_np`` are its numpy code;
``torch_args`` / ``decode_torch_vec`` / ``decode_torch_scalar`` are the torch
forms of its ``jax_args`` / ``decode_jax_vec`` / ``decode_jax_scalar``, and
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


def encode(x: np.ndarray, frame_quads: int = 32, name: str = "bp128") -> Encoded:
    x = np.asarray(x, dtype=np.uint32)
    n = len(x)
    if n == 0:
        return Encoded(name, 0, np.zeros(0, np.uint8), np.zeros(0, np.uint32),
                       header_bits=32, meta={"Q": 0, "frame_quads": frame_quads})
    v = quads_of(x)
    qm = quadmax_np(x, 4, pseudo=True)
    e = ebw_np(qm)
    q = len(qm)
    nf = (q + frame_quads - 1) // frame_quads
    epad = np.concatenate([e, np.zeros(nf * frame_quads - q, np.int32)])
    bws = np.maximum(epad.reshape(nf, frame_quads).max(axis=1), 1).astype(np.int32)
    bw_quads = np.repeat(bws, frame_quads)[:q]
    data, dbits = pack_data(v, bw_quads)
    return Encoded(
        name, n, bws.astype(np.uint8), data.reshape(-1),
        control_bits=nf * 8, data_bits=dbits * 4, header_bits=32,
        meta={"Q": q, "frame_quads": frame_quads},
    )


def encode_packed_binary(x: np.ndarray) -> Encoded:
    return encode(x, frame_quads=128, name="g_packed_binary")


def decode_np(enc: Encoded) -> np.ndarray:
    if enc.n == 0:
        return np.zeros(0, np.uint32)
    q = enc.meta["Q"]
    bw_quads = np.repeat(enc.control.astype(np.int32), enc.meta["frame_quads"])[:q]
    return unpack_data_np(enc.data.reshape(-1, 4), bw_quads, enc.n)


# --------------------------------------------------------------------------- #
# torch decoders
# --------------------------------------------------------------------------- #


def torch_args(enc: Encoded, device="cuda") -> dict:
    """``decode_torch_vec`` / ``decode_torch_scalar`` keyword arguments, the
    tensors on ``device`` (data with one slack row)."""
    return {
        "control": torch.as_tensor(enc.control.astype(np.int32), device=device),
        "data": words_of(enc.data, device),
        "n": enc.n,
        "q": enc.meta["Q"],
        "frame_quads": enc.meta["frame_quads"],
    }


def _bw_quads(control: torch.Tensor, q: int, frame_quads: int) -> torch.Tensor:
    return control.repeat_interleave(frame_quads)[:q]


def decode_torch_vec(control, data, n: int, q: int, frame_quads: int):
    return unpack_data(data, _bw_quads(control, q, frame_quads), n)


def decode_torch_scalar(control, data, n: int, q: int, frame_quads: int):
    return unpack_data_scalar(data, _bw_quads(control, q, frame_quads), n, q)


def decode_arena_block(control: torch.Tensor, data: torch.Tensor,
                       n_valid: torch.Tensor, frame_quads: int) -> torch.Tensor:
    """Fixed-shape decode of P blocks at once for the device arena.

    control: (P, C_MAX) int32 per-frame bit widths (columns >= a block's
             frame count are arena slack; they are masked to bw=0 below).
    data:    (P, W_MAX + 2, 4) int32 words gathered from the data arena
             (slack rows feed only bw=0 quads or bits above a value's mask).
    n_valid: (P,) integer count of each block.
    Returns (P, 4 * C_MAX * frame_quads) int32 words, zero beyond ``n_valid``.
    """
    dev = control.device
    qmax = control.shape[1] * frame_quads
    q = torch.arange(qmax, device=dev)
    n_valid = n_valid.to(torch.int64)[:, None]
    q_len = (n_valid + 3) >> 2
    bw_quads = torch.where(q[None, :] < q_len,
                           control.to(torch.int64)[:, q // frame_quads], 0)
    out = unpack_data(data, bw_quads, 4 * qmax)
    i = torch.arange(4 * qmax, device=dev)
    return torch.where(i[None, :] < n_valid, out, 0)
