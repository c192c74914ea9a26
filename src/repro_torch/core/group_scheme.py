"""Group-Scheme family (paper §5): CG x LD generalization of Elias Gamma / GVB.

A variant is "CG-LD" with compression granularity CG in {1,2,4,8} bits and
length descriptor LD in {B (binary), CU (complete unary), IU (incomplete
unary, CG in {4,8} only)}.  "1-CU" is k-Gamma (k=4).

Per quadruple q: nunits[q] = max(1, ceil(ebw(quadmax[q]) / CG)); the four
integers are packed with bw = nunits*CG bits each into the four vertical
component bitstreams of the data area (values may cross word boundaries —
Fig. 4).  The control area stores the length descriptors:

  * B  — nunits-1 in a fixed-width field, alignment per Fig. 5:
         CG=1: 3 x 5-bit fields per 16 bits; CG=2: 2 x 4-bit per byte;
         CG=4: 2 x 3-bit per byte; CG=8: 4 x 2-bit per byte.
  * CU — unary (nunits-1 ones + a zero), continuous across bytes.
  * IU — unary, never crossing a byte; a byte's trailing ones are padding.

Counterpart of the JAX package's ``core/group_scheme.py``: ``encode`` and
``decode_np`` are its numpy code; ``torch_args`` / ``decode_torch_vec``
(packed LD decode by zero-position arithmetic or the 256-entry lookup
tables, paper §5.3.1, then one gather-shift-mask for all quadruples, §5.3.2)
/ ``decode_torch_scalar`` (one quadruple a step, TZCNT-style unary reads,
§5.4) the torch forms of its JAX decoders, and ``decode_arena_block`` its
device-arena decode, batched over ``(P, width)`` tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .bits import (U32_MASK, const, ebw_np, from_np, gather_bits, gather_bits_np, i32, mask,
                   mask_np, pack_bits_np, u32, unary_stream_np,
                   words_to_bits_np)
from .encoded import Encoded
from .frames import unpack_data, words_of
from .layout import quadmax_np, to_vertical_np

CGS = (1, 2, 4, 8)
# binary-LD layout per CG: (quads per group, field bits, group bits)
B_LAYOUT = {1: (3, 5, 16), 2: (2, 4, 8), 4: (2, 3, 8), 8: (4, 2, 8)}
VARIANTS = tuple(f"{cg}-B" for cg in CGS) + tuple(f"{cg}-CU" for cg in CGS) + ("4-IU", "8-IU")


def _split(variant: str) -> tuple[int, str]:
    cg, ld = variant.split("-")
    return int(cg), ld


# --------------------------------------------------------------------------- #
# incomplete-unary lookup tables (paper §5.3.1): decode a whole control byte
# --------------------------------------------------------------------------- #


def _build_iu_tables() -> tuple[np.ndarray, np.ndarray]:
    count = np.zeros(256, np.int32)
    lds = np.zeros((256, 8), np.int32)
    for b in range(256):
        k, pos = 0, 0
        run = 0
        while pos < 8:
            if (b >> pos) & 1:
                run += 1
            else:
                lds[b, k] = run + 1
                k += 1
                run = 0
            pos += 1
        count[b] = k  # trailing ones (run > 0 at exit) are padding
    return count, lds


IU_COUNT_NP, IU_LDS_NP = _build_iu_tables()


@functools.cache
def _iu_tables(device) -> tuple[torch.Tensor, torch.Tensor]:
    """The IU lookup tables on ``device``, made once per device."""
    return const(IU_COUNT_NP, device), const(IU_LDS_NP, device)


# --------------------------------------------------------------------------- #
# encoding (host / numpy)
# --------------------------------------------------------------------------- #


def _nunits(x: np.ndarray, cg: int) -> np.ndarray:
    qm = quadmax_np(x, 4, pseudo=True)
    e = ebw_np(qm)
    return np.maximum(1, -(-e // cg)).astype(np.int64)


def _encode_control(nunits: np.ndarray, cg: int, ld: str) -> tuple[np.ndarray, int, dict]:
    if ld == "B":
        gsz, fb, gb = B_LAYOUT[cg]
        q = len(nunits)
        pad = (-q) % gsz
        f = np.concatenate([nunits - 1, np.zeros(pad, np.int64)]).reshape(-1, gsz)
        group_vals = np.zeros(len(f), np.uint64)
        for i in range(gsz):
            group_vals |= f[:, i].astype(np.uint64) << np.uint64(i * fb)
        words, bits = pack_bits_np(group_vals, np.full(len(f), gb, np.int64))
        return words, bits, {}
    if ld == "CU":
        words, bits = unary_stream_np(nunits)
        return words, bits, {}
    # IU: greedy byte fill, codes never cross bytes
    out_bytes = []
    cur, used = 0, 0
    for u in nunits:
        u = int(u)
        if used + u > 8:
            cur |= ((1 << (8 - used)) - 1) << used  # pad remainder with ones
            out_bytes.append(cur)
            cur, used = 0, 0
        cur |= ((1 << (u - 1)) - 1) << used          # u-1 ones then an implicit 0
        used += u
        if used == 8:
            out_bytes.append(cur)
            cur, used = 0, 0
    if used:
        cur |= ((1 << (8 - used)) - 1) << used
        out_bytes.append(cur)
    by = np.asarray(out_bytes, dtype=np.uint8)
    padb = (-len(by)) % 4
    words = np.concatenate([by, np.zeros(padb, np.uint8)]).view(np.uint32)
    return words, len(by) * 8, {"n_control_bytes": len(by)}


def encode(x: np.ndarray, variant: str) -> Encoded:
    if variant not in VARIANTS:
        raise ValueError(f"unknown Group-Scheme variant {variant!r}")
    cg, ld = _split(variant)
    x = np.asarray(x, dtype=np.uint32)
    n = len(x)
    name = f"group_scheme_{variant}"
    if n == 0:
        return Encoded(name, 0, np.zeros(0, np.uint32), np.zeros(0, np.uint32),
                       header_bits=32, meta={"variant": variant, "Q": 0})
    v = to_vertical_np(x, 4)                       # (Q, 4)
    nunits = _nunits(x, cg)                        # (Q,)
    bw = (nunits * cg).astype(np.int64)
    control, cbits, cmeta = _encode_control(nunits, cg, ld)
    msk = mask_np(bw).astype(np.uint64)
    cols = []
    for c in range(4):
        w, dbits = pack_bits_np(v[:, c].astype(np.uint64) & msk, bw)
        cols.append(w)
    data = np.stack(cols, axis=1)                  # (W, 4)
    meta = {"variant": variant, "Q": len(nunits), "nunits": nunits, **cmeta}
    return Encoded(name, n, control, data.reshape(-1),
                   control_bits=cbits, data_bits=int(bw.sum()) * 4,
                   header_bits=32, meta=meta)


# --------------------------------------------------------------------------- #
# numpy oracle decode
# --------------------------------------------------------------------------- #


def _decode_control_np(enc: Encoded) -> np.ndarray:
    cg, ld = _split(enc.meta["variant"])
    q = enc.meta["Q"]
    control = enc.control
    if ld == "B":
        gsz, fb, gb = B_LAYOUT[cg]
        idx = np.arange(q)
        offs = (idx // gsz) * gb + (idx % gsz) * fb
        return gather_bits_np(control, offs, np.full(q, fb)) + 1
    if ld == "CU":
        bits = words_to_bits_np(control, enc.control_bits)
        zpos = np.flatnonzero(bits == 0)[:q]
        prev = np.concatenate([[-1], zpos[:-1]])
        return (zpos - prev).astype(np.int64)
    by = control.view(np.uint8)[: enc.meta["n_control_bytes"]]
    counts = IU_COUNT_NP[by]
    lds = IU_LDS_NP[by]
    out = np.zeros(q, np.int64)
    base = np.cumsum(counts) - counts
    for s in range(8):
        sel = s < counts
        tgt = base[sel] + s
        keep = tgt < q
        out[tgt[keep]] = lds[sel, s][keep]
    return out


def decode_np(enc: Encoded) -> np.ndarray:
    cg, _ = _split(enc.meta["variant"])
    q = enc.meta["Q"]
    if q == 0:
        return np.zeros(0, np.uint32)
    nunits = _decode_control_np(enc)
    bw = nunits * cg
    ends = np.cumsum(bw)
    offs = ends - bw
    data = enc.data.reshape(-1, 4)
    out = np.stack([gather_bits_np(data[:, c], offs, bw) for c in range(4)], axis=1)
    return out.reshape(-1)[: enc.n]


# --------------------------------------------------------------------------- #
# torch decoders
# --------------------------------------------------------------------------- #


def torch_args(enc: Encoded, device="cuda") -> dict:
    """``decode_torch_vec`` / ``decode_torch_scalar`` keyword arguments, the
    tensors on ``device`` (data with one slack row, control with two slack
    words)."""
    control = np.concatenate([np.asarray(enc.control, np.uint32),
                              np.zeros(2, np.uint32)])
    return {
        "control": from_np(control, device),
        "data": words_of(enc.data, device),
        "n": enc.n,
        "q": enc.meta["Q"],
        "variant": enc.meta["variant"],
        "n_control_bytes": enc.meta.get("n_control_bytes", 0),
    }


def _control_bits(control: torch.Tensor) -> torch.Tensor:
    """(..., C) int32 words -> (..., 32 * C) bits, LSB-first."""
    sh = torch.arange(32, device=control.device)
    bits = (u32(control).unsqueeze(-1) >> sh) & 1
    return bits.reshape(*control.shape[:-1], -1)


def _control_bytes(control: torch.Tensor) -> torch.Tensor:
    """(C,) int32 words -> (4 * C,) bytes, little-endian (the words' byte
    view)."""
    sh = torch.arange(0, 32, 8, device=control.device)
    return ((u32(control)[:, None] >> sh) & 0xFF).reshape(-1)


def _zero_positions(bits: torch.Tensor, q: int) -> torch.Tensor:
    """Per row of ``bits``, the positions of its first ``q`` zero bits
    (scatter by zero rank; ranks >= q land in the spare last column, the
    only column written twice)."""
    zcum = torch.cumsum(1 - bits, dim=-1)
    j = torch.arange(bits.shape[-1], device=bits.device).expand_as(bits)
    idx = torch.where(bits == 0, zcum - 1, q).clamp(max=q)
    zpos = torch.zeros(*bits.shape[:-1], q + 1, dtype=torch.int64,
                       device=bits.device)
    return zpos.scatter_(-1, idx, j)[..., :q]


def _iu_nunits(by: torch.Tensor, counts: torch.Tensor, q: int) -> torch.Tensor:
    """IU lengths from control bytes ``by`` (..., B) and their descriptor
    counts (..., B), each byte's descriptors scattered at its running
    offset; slots >= q land in the spare last column."""
    lds = _iu_tables(by.device)[1][by]                          # (..., B, 8)
    base = torch.cumsum(counts, dim=-1) - counts
    s = torch.arange(8, device=by.device)
    idx = torch.where(s < counts.unsqueeze(-1), base.unsqueeze(-1) + s, q)
    idx = idx.clamp(max=q).reshape(*by.shape[:-1], -1)
    out = torch.zeros(*by.shape[:-1], q + 1, dtype=torch.int64,
                      device=by.device)
    return out.scatter_(-1, idx, lds.reshape(*by.shape[:-1], -1))[..., :q]


def _decode_nunits_vec(control: torch.Tensor, q: int, variant: str,
                       n_control_bytes: int) -> torch.Tensor:
    cg, ld = _split(variant)
    dev = control.device
    if ld == "B":
        gsz, fb, gb = B_LAYOUT[cg]
        idx = torch.arange(q, device=dev)
        offs = (idx // gsz) * gb + (idx % gsz) * fb
        return gather_bits(control, offs, torch.full_like(offs, fb)) + 1
    if ld == "CU":
        zpos = _zero_positions(_control_bits(control), q)
        prev = torch.cat([zpos.new_full((1,), -1), zpos[:-1]])
        return zpos - prev
    # IU: packed decode via the 256-entry LUT (paper §5.3.1)
    by = _control_bytes(control)[:n_control_bytes]
    return _iu_nunits(by, _iu_tables(dev)[0][by], q)


def decode_torch_vec(control, data, n: int, q: int, variant: str,
                     n_control_bytes: int = 0):
    """SIMD-Group-Scheme decode: packed LD decode + one vectorized unpack."""
    cg, _ = _split(variant)
    nunits = _decode_nunits_vec(control, q, variant, n_control_bytes)
    return unpack_data(data, nunits * cg, n)


def _lowest_zero(x: torch.Tensor) -> torch.Tensor:
    """Index of the lowest 0-bit of 32-bit ``x`` (int64 in [0, 2**32)); -1
    where there is none, as ``31 - clz(0)``."""
    y = ~x & U32_MASK
    low = (y & -y).to(torch.float64)                  # 2**k: exact in float64
    return torch.frexp(low).exponent.to(torch.int64) - 1


def decode_torch_scalar(control, data, n: int, q: int, variant: str,
                        n_control_bytes: int = 0):
    """Paper-faithful scalar decode: one quadruple per loop step.  Unary LDs
    are read with the TZCNT-style bit trick (paper §5.4): the number of
    units is 1 + the index of the lowest zero bit of a 32-bit window.  Both
    positions are carried on the device, so the loop never waits for the
    card."""
    cg, ld = _split(variant)
    dev = data.device
    c = u32(control)
    d = u32(data)

    def read_window(pos):
        w = pos >> 5
        b = pos & 31
        lo = torch.index_select(c, 0, w) >> b
        hi = torch.where(b == 0, 0,
                         (torch.index_select(c, 0, w + 1) << (32 - b))
                         & U32_MASK)
        return lo | hi

    if ld == "B":
        gsz, fb, gb = B_LAYOUT[cg]

        def read_ld(qidx, ldpos):
            off = torch.full((1,), (qidx // gsz) * gb + (qidx % gsz) * fb,
                             dtype=torch.int64, device=dev)
            return (read_window(off) & ((1 << fb) - 1)) + 1, ldpos
    elif ld == "CU":

        def read_ld(qidx, ldpos):
            u = _lowest_zero(read_window(ldpos)) + 1
            return u, ldpos + u
    else:  # IU

        def read_ld(qidx, ldpos):
            rem = 8 - (ldpos & 7)
            win = read_window(ldpos) & mask(rem)
            is_pad = win == mask(rem)                    # all ones -> padding
            ldpos = torch.where(is_pad, (ldpos >> 3) * 8 + 8, ldpos)
            u = _lowest_zero(read_window(ldpos)) + 1
            return u, ldpos + u

    datapos = torch.zeros(1, dtype=torch.int64, device=dev)
    ldpos = torch.zeros(1, dtype=torch.int64, device=dev)
    out = []
    for qidx in range(q):
        u, ldpos = read_ld(qidx, ldpos)
        bw = u * cg
        w = datapos >> 5
        b = datapos & 31
        lo = torch.index_select(d, 0, w)[0]
        hi = torch.where(b == 0, 0,
                         (torch.index_select(d, 0, w + 1)[0] << (32 - b))
                         & U32_MASK)
        out.append(((lo >> b) | hi) & mask(bw))
        datapos = datapos + bw
    if not out:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    return i32(torch.cat(out)[:n])


# --------------------------------------------------------------------------- #
# fixed-shape arena decode (device work-lists)
# --------------------------------------------------------------------------- #


def arena_ctrl_width(variant: str, qmax: int = 128) -> int:
    """Padded control words (B/CU) or control bytes (IU) for a ``qmax``-quad
    block, including gather slack — the ``ctrl_width`` of this variant's
    declared :class:`repro_torch.core.codec.ArenaLayout`."""
    cg, ld = _split(variant)
    if ld == "B":
        gsz, _, gb = B_LAYOUT[cg]
        return -(-(-(-qmax // gsz) * gb) // 32) + 2
    if ld == "CU":
        return -(-qmax * (-(-32 // cg)) // 32) + 1
    return qmax                     # IU: one entry per byte, <= 1 byte per quad


def arena_block_ctrl(enc: Encoded) -> np.ndarray:
    """One encoded block's control stream in arena form: packed uint32 words
    for B/CU, one byte per uint32 entry for IU (byte-addressed LUT decode)."""
    _, ld = _split(enc.meta["variant"])
    if ld == "IU":
        by = enc.control.view(np.uint8)[: enc.meta["n_control_bytes"]]
        return by.astype(np.uint32)
    return np.asarray(enc.control, np.uint32)


def _arena_nunits(control: torch.Tensor, ctrl_len: torch.Tensor, qmax: int,
                  cg: int, ld: str) -> torch.Tensor:
    """(P, qmax) per-quad unit counts from padded control slices.  Slack past
    a block's own control words may hold the *next* block's stream; every
    lane it could pollute sits at a quad index >= the block's own quad count
    and is masked by the bw=0 clamp in ``decode_arena_block``."""
    dev = control.device
    p = control.shape[0]
    if ld == "B":
        gsz, fb, gb = B_LAYOUT[cg]
        idx = torch.arange(qmax, device=dev)
        offs = ((idx // gsz) * gb + (idx % gsz) * fb).expand(p, qmax)
        return gather_bits(control, offs, torch.full_like(offs, fb)) + 1
    if ld == "CU":
        # the block's own stream holds its quads' zeros first, so slots
        # below the block's quad count are written only by genuine zeros
        zpos = _zero_positions(_control_bits(control), qmax)
        prev = torch.cat([zpos.new_full((p, 1), -1), zpos[:, :-1]], dim=1)
        return zpos - prev
    # IU: byte-at-a-time LUT decode; ctrl_len masks slack bytes entirely
    by = control.to(torch.int64) & 0xFF
    live = (torch.arange(by.shape[1], device=dev)[None, :]
            < ctrl_len.to(torch.int64)[:, None])
    counts = torch.where(live, _iu_tables(dev)[0][by], 0)
    return _iu_nunits(by, counts, qmax)


def decode_arena_block(control: torch.Tensor, data: torch.Tensor,
                       ctrl_len: torch.Tensor, n_valid: torch.Tensor,
                       *, variant: str) -> torch.Tensor:
    """Fixed-shape decode of P blocks at once for the device arena: the
    ``decode_torch_vec`` formulation with padded shapes and per-row
    lengths.

    control: (P, ctrl_width) int32 slices of the control arena (see
             ``arena_block_ctrl`` for the per-LD layout).
    data:    (P, 4 * (qmax + 2)) int32, read as (qmax + 2, 4) component
             words with 2 rows of gather slack.
    ctrl_len: (P,) control lengths (bytes for IU, words otherwise).
    n_valid:  (P,) integer count of each block.
    Returns (P, 4 * qmax) int32 words, zero beyond ``n_valid``.
    """
    cg, ld = _split(variant)
    dev = control.device
    p = control.shape[0]
    dataw = data.reshape(p, -1, 4)
    qmax = dataw.shape[1] - 2
    q = torch.arange(qmax, device=dev)
    n_valid = n_valid.to(torch.int64)[:, None]
    q_len = (n_valid + 3) >> 2
    nunits = _arena_nunits(control, ctrl_len, qmax, cg, ld)
    # quads past the block consume 0 data bits, so valid quads' offsets are
    # unaffected by whatever the slack lanes decoded
    bw = torch.where(q[None, :] < q_len, nunits * cg, 0)
    out = unpack_data(dataw, bw, 4 * qmax)
    i = torch.arange(4 * qmax, device=dev)
    return torch.where(i[None, :] < n_valid, out, 0)
