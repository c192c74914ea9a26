"""Group-PFD (paper §6.2): PForDelta wrapped in the Group approach.

Frames of 128 integers (32 quadruples).  Per frame the bit width b is the
smallest width such that at most zeta (=10%, the paper's setting) of the quad
max entries exceed b.  Exceptions are detected on the quad max array first and
then refined to individual integers (§6.2 Step 3).  All slots store the low b
bits; exceptional integers are re-written from the exception area, which
stores (8-bit frame-local position, value) pairs with the most economical
value width w in {8, 16, 32} per frame (Zhang et al. 2008).

Header: 2 bytes/frame = bw (6 bits) | wcode (2 bits), n_exceptions (8 bits).

Counterpart of the JAX package's ``core/group_pfd.py``: ``encode`` and
``decode_np`` are its numpy code; ``torch_args`` / ``decode_torch_vec`` /
``decode_torch_scalar`` the torch forms of its JAX decoders (the whole-list
decode is kernel PFD on the card, ``kernels/pfd_decode.py``), and
``decode_arena_block`` its device-arena decode with the vectorized patch,
batched over ``(P, width)`` tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .bits import const, ebw_np, from_np, gather_bits, gather_bits_np, i32, pack_bits_np
from .encoded import Encoded
from .frames import (pack_data, quads_of, unpack_data, unpack_data_np,
                     unpack_data_scalar, words_of)
from .layout import quadmax_np

FRAME_QUADS = 32
FRAME_INTS = 128
ZETA = 0.10
W_CHOICES = np.array([8, 16, 32], np.int32)

# device-arena geometry: one 512-posting index block is at most ARENA_Q quads
# = ARENA_F fixed frames; every one of its <= 512 integers may be an
# exception, and an exception costs at most 8 + 32 bits in the patch stream
ARENA_Q = 128
ARENA_F = ARENA_Q // FRAME_QUADS
ARENA_EXC = 4 * ARENA_Q
ARENA_EXC_WORDS = ARENA_EXC * (8 + 32) // 32


@functools.cache
def _w_choices(device) -> torch.Tensor:
    """W_CHOICES on ``device``, made once per device (no copy per call)."""
    return const(W_CHOICES, device)


def encode(x: np.ndarray, zeta: float = ZETA, opt: bool = False) -> Encoded:
    """opt=False: paper-faithful zeta rule on the quad max array (§6.2 Step 2).

    opt=True (beyond-paper, OptPFD-flavoured): per frame, pick the bit width
    minimizing 128*b + n_exc(b)*(8+w) directly — immune to the quad-level
    exception-rate inflation of the 4-way grouping on heavy-tailed data.
    """
    name = "group_optpfd" if opt else "group_pfd"
    x = np.asarray(x, dtype=np.uint32)
    n = len(x)
    if n == 0:
        return Encoded(name, 0, np.zeros(0, np.uint8), np.zeros(0, np.uint32),
                       exceptions=np.zeros(0, np.uint32), header_bits=32,
                       meta={"Q": 0, "n_exc": np.zeros(0, np.int32)})
    v = quads_of(x)
    q = len(v)
    e = ebw_np(quadmax_np(x, 4, pseudo=True))
    nf = (q + FRAME_QUADS - 1) // FRAME_QUADS
    xpad = np.concatenate([x, np.zeros(q * 4 - n, np.uint32)])
    e_int = ebw_np(xpad)
    if opt:
        ei = e_int.copy()
        ei[n:] = 0
        epad_i = np.concatenate([ei, np.zeros(nf * FRAME_INTS - q * 4, np.int32)]).reshape(nf, FRAME_INTS)
        hist = np.stack([(epad_i == b).sum(axis=1) for b in range(33)], axis=1)  # (nf, 33)
        nexc_at = hist[:, ::-1].cumsum(axis=1)[:, ::-1]          # nexc_at[:, b] = count(e >= b)
        maxe = epad_i.max(axis=1)
        w = W_CHOICES[np.minimum(np.searchsorted(W_CHOICES, np.maximum(maxe, 1)), 2)]
        bcand = np.arange(1, 33)
        # count(e > b) = nexc_at[:, b+1]; b=32 has no exceptions
        nexc_b = np.concatenate([nexc_at[:, 2:], np.zeros((nf, 1), np.int64)], axis=1)
        cost = FRAME_INTS * bcand[None, :] + nexc_b * (8 + w[:, None])
        bws = bcand[np.argmin(cost, axis=1)].astype(np.int32)
    else:
        epad = np.concatenate([e, np.zeros(nf * FRAME_QUADS - q, np.int32)]).reshape(nf, FRAME_QUADS)
        k = int(np.ceil((1.0 - zeta) * FRAME_QUADS)) - 1
        bws = np.maximum(np.partition(epad, k, axis=1)[:, k], 1).astype(np.int32)
    b_int = np.repeat(bws, FRAME_INTS)[: q * 4]
    exc_mask = e_int > b_int
    exc_mask[n:] = False
    exc_idx = np.flatnonzero(exc_mask)
    exc_frame = exc_idx // FRAME_INTS
    n_exc = np.bincount(exc_frame, minlength=nf).astype(np.int32)
    if n_exc.max(initial=0) > 255:
        raise ValueError("frame exception overflow")

    # most economical exception width per frame
    wcodes = np.zeros(nf, np.int32)
    if len(exc_idx):
        maxe = np.zeros(nf, np.int32)
        np.maximum.at(maxe, exc_frame, e_int[exc_idx])
        wcodes = np.searchsorted(W_CHOICES, np.maximum(maxe, 1), side="left")
        wcodes = np.minimum(wcodes, 2)
    ws = W_CHOICES[wcodes]

    # exception stream: per frame, n_exc 8-bit positions then n_exc w-bit
    # values (the reference's per-frame loop, placed by one scatter: the
    # exceptions are already in frame order)
    tot = len(exc_idx)
    if tot:
        start = np.cumsum(n_exc) - n_exc                 # exceptions before f
        rank = np.arange(tot) - start[exc_frame]
        slot_pos = 2 * start[exc_frame] + rank
        slot_val = slot_pos + n_exc[exc_frame]
        codes = np.zeros(2 * tot, np.uint64)
        lens = np.zeros(2 * tot, np.int64)
        codes[slot_pos] = exc_idx % FRAME_INTS
        codes[slot_val] = xpad[exc_idx]
        lens[slot_pos] = 8
        lens[slot_val] = ws[exc_frame]
        exc_words, exc_bits = pack_bits_np(codes, lens)
    else:
        exc_words, exc_bits = np.zeros(0, np.uint32), 0

    bw_quads = np.repeat(bws, FRAME_QUADS)[:q]
    data, dbits = pack_data(v, bw_quads)
    control = np.stack([(bws.astype(np.uint8) | (wcodes.astype(np.uint8) << 6)),
                        n_exc.astype(np.uint8)], axis=1).reshape(-1)
    return Encoded(
        name, n, control, data.reshape(-1),
        control_bits=nf * 16, data_bits=dbits * 4,
        exceptions=exc_words, exception_bits=exc_bits, header_bits=32,
        meta={"Q": q, "bws": bws, "n_exc": n_exc, "ws": ws},
    )


def _headers(control: np.ndarray):
    c = control.reshape(-1, 2)
    bws = (c[:, 0] & 63).astype(np.int32)
    wcodes = (c[:, 0] >> 6).astype(np.int32)
    n_exc = c[:, 1].astype(np.int32)
    return bws, W_CHOICES[wcodes], n_exc


def decode_np(enc: Encoded) -> np.ndarray:
    if enc.n == 0:
        return np.zeros(0, np.uint32)
    q = enc.meta["Q"]
    bws, ws, n_exc = _headers(enc.control)
    bw_quads = np.repeat(bws, FRAME_QUADS)[:q]
    out = unpack_data_np(enc.data.reshape(-1, 4), bw_quads, enc.n).copy()
    tot = int(n_exc.sum())
    if tot:
        frame_bits = n_exc * (8 + ws)
        base = np.cumsum(frame_bits) - frame_bits
        fid = np.repeat(np.arange(len(n_exc)), n_exc)
        j = np.arange(tot) - np.repeat(np.cumsum(n_exc) - n_exc, n_exc)
        pos_off = base[fid] + j * 8
        val_off = base[fid] + n_exc[fid] * 8 + j * ws[fid]
        pos = gather_bits_np(enc.exceptions, pos_off, np.full(tot, 8))
        vals = gather_bits_np(enc.exceptions, val_off, ws[fid])
        g = fid * FRAME_INTS + pos
        out[g[g < enc.n]] = vals[g < enc.n]
    return out


# --------------------------------------------------------------------------- #
# torch decoders
# --------------------------------------------------------------------------- #


def torch_args(enc: Encoded, device="cuda") -> dict:
    """``decode_torch_vec`` / ``decode_torch_scalar`` keyword arguments, the
    tensors on ``device`` (data with one slack row, the exception stream
    with two slack words)."""
    exc = np.concatenate([enc.exceptions, np.zeros(2, np.uint32)])
    return {
        "control": torch.as_tensor(enc.control.astype(np.int32), device=device),
        "data": words_of(enc.data, device),
        "exceptions": from_np(exc, device),
        "n": enc.n,
        "q": enc.meta["Q"],
        "total_exc": int(enc.meta["n_exc"].sum()),
    }


def bw_quads(control: torch.Tensor, q: int) -> torch.Tensor:
    """Each quadruple's bit width, from its frame's header."""
    bws = control.reshape(-1, 2)[:, 0] & 63
    return bws.repeat_interleave(FRAME_QUADS)[:q]


def apply_exceptions(out, control, exceptions, n: int, total_exc: int):
    """Patch the ``total_exc`` exceptions into ``out`` (int32 words), one
    lane an exception; ``repeat_interleave`` is given its output size, so
    the card is never asked for it."""
    if total_exc == 0:
        return out
    dev = out.device
    c = control.to(torch.int64).reshape(-1, 2)
    ws = _w_choices(dev)[(c[:, 0] >> 6).clamp(max=2)]
    n_exc = c[:, 1]
    frame_bits = n_exc * (8 + ws)
    base = torch.cumsum(frame_bits, 0) - frame_bits
    nf = c.shape[0]
    fid = torch.repeat_interleave(torch.arange(nf, device=dev), n_exc,
                                  output_size=total_exc)
    seg_start = torch.repeat_interleave(torch.cumsum(n_exc, 0) - n_exc, n_exc,
                                        output_size=total_exc)
    j = torch.arange(total_exc, device=dev) - seg_start
    pos_off = base[fid] + j * 8
    val_off = base[fid] + n_exc[fid] * 8 + j * ws[fid]
    pos = gather_bits(exceptions, pos_off, torch.full_like(pos_off, 8))
    vals = gather_bits(exceptions, val_off, ws[fid])
    g = fid * FRAME_INTS + pos
    # dropped lanes (past n) land in the spare last slot
    buf = torch.cat([out, out.new_zeros(1)])
    buf[torch.where(g < n, g, n)] = i32(vals)
    return buf[:n]


@functools.cache
def _kernel_wrapper():
    """``kernels/pfd_decode.py``, imported at the first decode: it imports
    this module's format helpers above."""
    from ..kernels import pfd_decode
    return pfd_decode


def decode_torch_vec(control, data, exceptions, n: int, q: int,
                     total_exc: int):
    """The whole list: one launch of kernel PFD on a CUDA tensor, its plain
    version (three ``decode_list/`` phase spans) on a CPU tensor
    (``kernels/pfd_decode.py``)."""
    return _kernel_wrapper().decode_list(control, data, exceptions, n, q,
                                         total_exc)


def decode_torch_scalar(control, data, exceptions, n: int, q: int,
                        total_exc: int):
    out = unpack_data_scalar(data, bw_quads(control, q), n, q)
    return apply_exceptions(out, control, exceptions, n, total_exc)


def decode_arena_block(ctrl, data, exc, ctrl_len, data_len, exc_len, n_valid):
    """Fixed-shape decode + vectorized exception patch of P blocks at once
    for the device arena; the patch never leaves the device.

    ctrl: (P, 2 * ARENA_F) int32 header bytes, interleaved (bw | wcode << 6,
          n_exc) per 128-integer frame; bytes >= ``ctrl_len`` are slack.
    data: (P, 4 * (W + 2)) int32 words gathered from the data arena.
    exc:  (P, ARENA_EXC_WORDS + 2) int32 patch-stream words; per frame,
          ``n_exc`` 8-bit positions then ``n_exc`` w-bit values.
    ctrl_len, data_len, exc_len, n_valid: (P,) word / integer counts.
    Returns (P, 4 * ARENA_Q) int32 words, zero beyond ``n_valid``.

    Shared by ``group_pfd`` and ``group_optpfd`` (identical block format).
    """
    dev = ctrl.device
    p = ctrl.shape[0]
    c = ctrl.to(torch.int64).reshape(p, -1, 2)
    fmax = c.shape[1]
    f_valid = (torch.arange(fmax, device=dev)[None, :]
               < (ctrl_len.to(torch.int64) >> 1)[:, None])
    bws = torch.where(f_valid, c[:, :, 0] & 63, 0)
    ws = _w_choices(dev)[(c[:, :, 0] >> 6).clamp(0, 2)]
    n_exc = torch.where(f_valid, c[:, :, 1], 0)
    q = torch.arange(ARENA_Q, device=dev)
    n_valid = n_valid.to(torch.int64)[:, None]
    q_len = (n_valid + 3) >> 2
    bw_quads = torch.where(q[None, :] < q_len,
                           bws[:, torch.clamp(q >> 5, max=fmax - 1)], 0)
    out = unpack_data(data.reshape(p, -1, 4), bw_quads, 4 * ARENA_Q)
    # vectorized patch: one fixed lane per potential exception slot, masked
    # past the block's total (the bit layout of apply_exceptions)
    frame_bits = n_exc * (8 + ws)
    base = torch.cumsum(frame_bits, dim=1) - frame_bits
    cum = torch.cumsum(n_exc, dim=1)
    j = torch.arange(ARENA_EXC, device=dev).expand(p, ARENA_EXC).contiguous()
    fid = torch.clamp(torch.searchsorted(cum, j, right=True), max=fmax - 1)
    n_fid = torch.gather(n_exc, 1, fid)
    base_fid = torch.gather(base, 1, fid)
    ws_fid = torch.gather(ws, 1, fid)
    jj = j - (torch.gather(cum, 1, fid) - n_fid)
    pos = gather_bits(exc, base_fid + jj * 8, torch.full_like(jj, 8))
    vals = gather_bits(exc, base_fid + n_fid * 8 + jj * ws_fid, ws_fid)
    g = fid * FRAME_INTS + pos
    # dropped lanes all land in the spare last column, and no valid slot is
    # written twice (an exception's position is unique in its frame)
    g = torch.where((j < cum[:, -1:]) & (g < n_valid), g, 4 * ARENA_Q)
    buf = torch.cat([out, out.new_zeros(p, 1)], dim=1)
    buf.scatter_(1, g, i32(vals))
    i = torch.arange(4 * ARENA_Q, device=dev)
    return torch.where(i[None, :] < n_valid, buf[:, :4 * ARENA_Q], 0)
