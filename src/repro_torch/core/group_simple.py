"""Group-Simple (paper §4): word-aligned codec with separated control/data areas.

Encoding format (Fig. 2):
  * control area — one 4-bit selector per 128-bit data vector, two per byte.
  * data area    — 128-bit vectors = 4 x uint32 components, 4-way vertical
    layout: quadruple k of a vector puts its 4 integers at bit offset k*BW of
    components 0..3.

Ten patterns (Table III): (NUM, BW) with NUM integers per component, BW bits
each.  Pattern selection (Algorithm 1) runs on the quad max array.

Counterpart of the JAX package's ``core/group_simple.py``: ``encode`` and
``decode_np`` are its numpy code; ``torch_args`` / ``decode_torch_vec`` /
``decode_torch_vec_scatter`` / ``decode_torch_scalar`` are the torch forms
of its ``jax_args`` / ``decode_jax_vec`` / ``decode_jax_vec_scatter`` /
``decode_jax_scalar``, and ``decode_arena_block`` is the
device-arena decode in torch, batched as explicit ``(P, width)`` tensors
where the reference maps one block at a time under ``vmap``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .bits import const, ebw_np, from_np, i32, mask_np, pack_bits_np, u32
from .encoded import Encoded
from .layout import quadmax_np, to_vertical_np

NUM = np.array([32, 16, 10, 8, 6, 5, 4, 3, 2, 1], dtype=np.int32)
BW = np.array([1, 2, 3, 4, 5, 6, 8, 10, 16, 32], dtype=np.int32)
MASKS = mask_np(BW)


@functools.cache
def _tables(device) -> tuple:
    """(NUM, BW, MASKS) as int64 tensors on ``device``, made once per
    device (no copy per call)."""
    return tuple(const(a, device) for a in (NUM, BW, MASKS))


# --------------------------------------------------------------------------- #
# encoding (host / numpy)
# --------------------------------------------------------------------------- #


def select_patterns(quadmax: np.ndarray) -> np.ndarray:
    """Algorithm 1 on the quad max array -> array of selectors.

    The reference's greedy walk, with its per-position decision computed
    for every position at once: at quad j the walk takes the first pattern
    s whose bit width fits the next min(NUM[s], q - j) quads.  Only the
    pointer chase over the chosen positions stays sequential."""
    e = ebw_np(quadmax)
    q = len(e)
    pos = np.arange(q)
    fits = e[None, :] <= BW[:, None]                       # (10, q)
    # first non-fitting quad at or after j, per pattern (q when none)
    nxt = np.where(fits, q, pos[None, :])
    nxt = np.minimum.accumulate(nxt[:, ::-1], axis=1)[:, ::-1]
    need = np.minimum(NUM[:, None], q - pos[None, :])
    choice = np.argmax(nxt - pos[None, :] >= need, axis=0)  # BW=32 always fits
    step = need[choice, pos]
    choice, step = choice.tolist(), step.tolist()
    sels = []
    j = 0
    while j < q:
        sels.append(choice[j])
        j += step[j]
    return np.asarray(sels, dtype=np.uint8)


def encode(x: np.ndarray) -> Encoded:
    x = np.asarray(x, dtype=np.uint32)
    n = len(x)
    if n == 0:
        return Encoded("group_simple", 0, np.zeros(0, np.uint32), np.zeros(0, np.uint32), header_bits=32)
    v = to_vertical_np(x, 4)                      # (Q, 4)
    qm = quadmax_np(x, 4, pseudo=True)
    sels = select_patterns(qm)
    p = len(sels)
    num, bw = NUM[sels], BW[sels]
    starts = np.concatenate([[0], np.cumsum(num)[:-1]])  # quad offset per vector
    qlen = len(qm)
    # every vector's 32 slots at once: slot k of vector i holds quad
    # starts[i] + k at bit offset k * BW, for k < NUM (all others are 0)
    k = np.arange(32)
    idx = starts[:, None] + k[None, :]                          # (P, 32)
    valid = (k[None, :] < num[:, None]) & (idx < qlen)
    vals = v[np.minimum(idx, qlen - 1)].astype(np.uint64)       # (P, 32, 4)
    vals &= MASKS[sels].astype(np.uint64)[:, None, None]
    vals[~valid] = 0
    shifts = np.where(valid, k[None, :] * bw[:, None], 0).astype(np.uint64)
    data = np.bitwise_or.reduce(vals << shifts[:, :, None], axis=1)
    data = data.astype(np.uint32)
    control, cbits = pack_bits_np(sels.astype(np.uint64), np.full(p, 4, np.int64))
    return Encoded(
        "group_simple", n, control, data.reshape(-1),
        control_bits=cbits, data_bits=int(data.size) * 32, header_bits=32,
        meta={"sels": sels, "n_vectors": p},
    )


# --------------------------------------------------------------------------- #
# numpy oracle decode
# --------------------------------------------------------------------------- #


def decode_np(enc: Encoded) -> np.ndarray:
    """The reference's per-pattern decode, with every vector's 32 slots
    unpacked at once: slot k of vector i is quad ``starts[i] + k`` for
    k < NUM, so the valid slots in row-major order are the quads in order."""
    if enc.n == 0:
        return np.zeros(0, np.uint32)
    sels = np.asarray(enc.meta["sels"], np.intp)
    data = enc.data.reshape(len(sels), 4).astype(np.uint64)
    num = NUM[sels]
    k = np.arange(32)
    valid = k[None, :] < num[:, None]                           # (P, 32)
    shifts = np.where(valid, k[None, :] * BW[sels][:, None], 0)
    vals = (data[:, None, :] >> shifts.astype(np.uint64)[:, :, None]) \
        & MASKS[sels].astype(np.uint64)[:, None, None]          # (P, 32, 4)
    return vals[valid].astype(np.uint32).reshape(-1)[: enc.n]


# --------------------------------------------------------------------------- #
# torch decoders
# --------------------------------------------------------------------------- #


def torch_args(enc: Encoded, device="cuda") -> dict:
    """``decode_torch_vec`` / ``decode_torch_scalar`` keyword arguments, the
    tensors on ``device``."""
    return {"sels": torch.as_tensor(enc.meta["sels"].astype(np.int64),
                                    device=device),
            "data": from_np(np.asarray(enc.data, np.uint32).reshape(-1, 4),
                            device),
            "n": enc.n}


def decode_torch_vec(sels: torch.Tensor, data: torch.Tensor,
                     n: int) -> torch.Tensor:
    """SIMD-Group-Simple decode, gather formulation: every output integer
    locates its (vector, slot, component) and extracts with one
    shift+mask."""
    dev = data.device
    num_t, bw_t, mask_t = _tables(dev)
    sels = sels.to(torch.int64)
    num = num_t[sels]
    ends = torch.cumsum(4 * num, 0)
    starts = ends - 4 * num
    i = torch.arange(n, device=dev)
    # segment id via boundary marks + cumsum; marks past n land in the
    # spare last slot
    marks = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    marks.scatter_add_(0, starts.clamp(max=n), torch.ones_like(starts))
    p = torch.cumsum(marks[:n], 0) - 1
    sel = sels[p]
    local = i - starts[p]
    word = u32(data.reshape(-1))[p * 4 + (local & 3)]
    return i32((word >> ((local >> 2) * bw_t[sel])) & mask_t[sel])


def decode_torch_vec_scatter(sels: torch.Tensor, data: torch.Tensor,
                             n: int) -> torch.Tensor:
    """The original scatter formulation: every vector's 32 slots unpacked
    at once, the valid ones scattered to their output positions."""
    dev = data.device
    num_t, bw_t, mask_t = _tables(dev)
    sels = sels.to(torch.int64)
    p = sels.shape[0]
    num = num_t[sels]                                            # (P,)
    offs = 4 * (torch.cumsum(num, 0) - num)                      # (P,)
    slot = torch.arange(32, device=dev)
    shifts = torch.clamp(slot[None, :] * bw_t[sels][:, None], max=31)  # (P, 32)
    vals = (u32(data)[:, None, :] >> shifts[:, :, None]) \
        & mask_t[sels][:, None, None]                            # (P, 32, 4)
    idx = offs[:, None, None] + 4 * slot[None, :, None] \
        + torch.arange(4, device=dev)[None, None, :]
    valid = (slot[None, :] < num[:, None])[:, :, None].expand(p, 32, 4)
    # invalid and out-of-range slots land in the spare slot n, cut below
    idx = torch.where(valid & (idx < n), idx, n)
    out = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    out.scatter_(0, idx.reshape(-1), vals.reshape(-1))
    return i32(out[:n])


def decode_torch_scalar(sels: torch.Tensor, data: torch.Tensor,
                        n: int) -> torch.Tensor:
    """Paper-faithful scalar decode: one 128-bit vector per loop step, its
    pattern's slots written at the running offset (the selector is read on
    the device, so the loop never waits for the card)."""
    dev = data.device
    num_t, bw_t, mask_t = _tables(dev)
    d = u32(data)
    k = torch.arange(32, device=dev)
    out = torch.zeros(n + 128, dtype=torch.int64, device=dev)
    off = torch.zeros(1, dtype=torch.int64, device=dev)
    for j in range(sels.shape[0]):
        sel = sels[j:j + 1].to(torch.int64)
        num, bw = num_t[sel], bw_t[sel]
        vals = (d[j][None, :] >> torch.clamp(k * bw, max=31)[:, None]) \
            & mask_t[sel]
        buf = torch.where(k[:, None] < num, vals, 0).reshape(-1)
        out.index_copy_(0, off + torch.arange(128, device=dev), buf)
        off = off + 4 * num
    return i32(out[:n])


# --------------------------------------------------------------------------- #
# torch arena decode
# --------------------------------------------------------------------------- #


def decode_arena_block(sels: torch.Tensor, data: torch.Tensor,
                       p_len: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """Fixed-shape decode of P blocks at once for the device arena
    (``repro_torch.index.device``): the reference's gather formulation with
    the block axis written out.

    sels: (P, P_MAX) int32 selectors (columns >= p_len are arena slack).
    data: (P, P_MAX, 4) int32 words gathered from the data arena.
    p_len, n_valid: (P,) vector / integer counts of each block.
    Returns (P, 4 * P_MAX) int32 words, zero beyond ``n_valid``.
    """
    dev = sels.device
    p, pmax = sels.shape
    nmax = 4 * pmax
    num_t, bw_t, mask_t = _tables(dev)
    sels = sels.to(torch.int64).clamp(0, 9)       # slack may hold anything
    valid_p = (torch.arange(pmax, device=dev)[None, :]
               < p_len.to(torch.int64)[:, None])
    num = torch.where(valid_p, num_t[sels], 0)
    ends = torch.cumsum(4 * num, dim=1)
    starts = ends - 4 * num
    i = torch.arange(nmax, device=dev)
    marks = torch.zeros(p, nmax + 1, dtype=torch.int64, device=dev)
    marks.scatter_add_(1, torch.where(valid_p, starts, nmax),
                       torch.ones_like(starts))
    pos = torch.clamp(torch.cumsum(marks[:, :nmax], dim=1) - 1, 0, pmax - 1)
    sel = torch.gather(sels, 1, pos)
    local = i[None, :] - torch.gather(starts, 1, pos)
    k = local >> 2
    c = local & 3
    bw = bw_t[sel]
    word = torch.gather(u32(data.reshape(p, -1)), 1, pos * 4 + c)
    # lanes past the decoded tail alias the last vector with a huge `local`;
    # the shift is clipped to stay defined and the value is masked out below
    vals = (word >> torch.clamp(k * bw, max=31)) & mask_t[sel]
    return i32(torch.where(i[None, :] < n_valid.to(torch.int64)[:, None],
                           vals, 0))
