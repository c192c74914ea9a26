"""Scalar (non-Group) baseline codecs from the paper's comparison set (§2, §7).

All are host-side numpy implementations with exact bit accounting: VarByte,
GVB(-Binary), G8IU, G8CU, Simple-9, Simple-16, Rice, Elias Gamma, PForDelta,
AFOR, PackedBinary.  They serve the compression-ratio tables (Table VIII/IX/XI)
and as scalar decode-speed baselines; they declare no device arena.

A copy of the JAX package's ``core/scalar.py`` (numpy only): the port keeps
its own, so that it imports nothing of that package.
"""

from __future__ import annotations

import numpy as np

from .bits import ebw_np, gather_bits_np, mask_np, pack_bits_np, words_to_bits_np
from .encoded import Encoded

# --------------------------------------------------------------------------- #
# Variable Byte
# --------------------------------------------------------------------------- #


def vb_encode(x: np.ndarray) -> Encoded:
    x = np.asarray(x, dtype=np.uint32)
    n = len(x)
    nb = np.maximum(1, -(-ebw_np(x) // 7)).astype(np.int64)      # bytes per int
    ends = np.cumsum(nb)
    total = int(ends[-1]) if n else 0
    out = np.zeros(total, np.uint8)
    starts = ends - nb
    for j in range(5):
        sel = nb > j
        idx = starts[sel] + j
        byte = ((x[sel].astype(np.uint64) >> np.uint64(7 * j)) & np.uint64(0x7F)).astype(np.uint8)
        last = (j == nb[sel] - 1)
        out[idx] = byte | (last.astype(np.uint8) << 7)           # high bit marks last byte
    return Encoded("varbyte", n, np.zeros(0, np.uint8), out.view(np.uint8),
                   data_bits=total * 8, header_bits=32)


def vb_decode(enc: Encoded) -> np.ndarray:
    by = enc.data
    if enc.n == 0:
        return np.zeros(0, np.uint32)
    ends = np.flatnonzero(by & 0x80)[: enc.n]
    starts = np.concatenate([[0], ends[:-1] + 1])
    j = np.arange(len(by)) - np.repeat(starts, ends - starts + 1)
    contrib = ((by & 0x7F).astype(np.uint64)) << (7 * j).astype(np.uint64)
    return np.add.reduceat(contrib, starts).astype(np.uint32)


# --------------------------------------------------------------------------- #
# Group Variable Byte (binary descriptors) — Dean 2009
# --------------------------------------------------------------------------- #


def gvb_encode(x: np.ndarray) -> Encoded:
    x = np.asarray(x, dtype=np.uint32)
    n = len(x)
    pad = (-n) % 4
    xp = np.concatenate([x, np.zeros(pad, np.uint32)])
    nb = np.maximum(1, -(-ebw_np(xp) // 8)).astype(np.int64)     # 1..4 bytes
    groups = nb.reshape(-1, 4)
    control = (groups[:, 0] - 1) | ((groups[:, 1] - 1) << 2) | ((groups[:, 2] - 1) << 4) | ((groups[:, 3] - 1) << 6)
    ends = np.cumsum(nb)
    total = int(ends[-1]) if len(xp) else 0
    data = np.zeros(total, np.uint8)
    starts = ends - nb
    for j in range(4):
        sel = nb > j
        data[starts[sel] + j] = (xp[sel].astype(np.uint64) >> np.uint64(8 * j)).astype(np.uint8)
    return Encoded("gvb", n, control.astype(np.uint8), data,
                   control_bits=len(control) * 8, data_bits=total * 8, header_bits=32,
                   meta={"pad": pad})


def gvb_decode(enc: Encoded) -> np.ndarray:
    ctrl = enc.control
    nb = np.stack([(ctrl >> (2 * c)) & 3 for c in range(4)], axis=1).astype(np.int64).reshape(-1) + 1
    ends = np.cumsum(nb)
    starts = ends - nb
    by = np.concatenate([enc.data, np.zeros(4, np.uint8)])
    vals = np.zeros(len(nb), np.uint64)
    for j in range(4):
        sel = nb > j
        vals[sel] |= by[starts[sel] + j].astype(np.uint64) << np.uint64(8 * j)
    return vals.astype(np.uint32)[: enc.n]


# --------------------------------------------------------------------------- #
# G8IU / G8CU (unary descriptors, 8-byte data areas) — Stepanov et al. 2011
# --------------------------------------------------------------------------- #


def g8iu_encode(x: np.ndarray) -> Encoded:
    x = np.asarray(x, dtype=np.uint32)
    n = len(x)
    nb = np.maximum(1, -(-ebw_np(x) // 8)).astype(np.int64)
    blocks = []  # (control byte, 8 data bytes)
    i = 0
    while i < n:
        used, ctrl, data = 0, 0, np.zeros(8, np.uint8)
        cbit = 0
        while i < n and used + nb[i] <= 8:
            L = int(nb[i])
            for j in range(L):
                data[used + j] = (int(x[i]) >> (8 * j)) & 0xFF
            ctrl |= ((1 << (L - 1)) - 1) << cbit                 # (L-1) ones + implicit 0
            cbit += L
            used += L
            i += 1
        ctrl |= ((1 << (8 - cbit)) - 1) << cbit                  # pad descriptors with ones
        blocks.append((ctrl, data))
    control = np.asarray([b[0] for b in blocks], np.uint8)
    data = np.concatenate([b[1] for b in blocks]) if blocks else np.zeros(0, np.uint8)
    bits = len(blocks) * 9 * 8
    return Encoded("g8iu", n, control, data, control_bits=len(blocks) * 8,
                   data_bits=len(blocks) * 64, header_bits=32)


def g8iu_decode(enc: Encoded) -> np.ndarray:
    out = np.zeros(enc.n, np.uint32)
    k = 0
    for bi in range(len(enc.control)):
        ctrl = int(enc.control[bi])
        data = enc.data[bi * 8:(bi + 1) * 8]
        pos = 0
        run = 0
        start = 0
        for bit in range(8):
            if (ctrl >> bit) & 1:
                run += 1
            else:
                L = run + 1
                v = 0
                for j in range(L):
                    v |= int(data[start + j]) << (8 * j)
                if k < enc.n:
                    out[k] = v
                k += 1
                start += L
                run = 0
    return out


def g8cu_encode(x: np.ndarray) -> Encoded:
    """G8CU: integers may span 8-byte areas; control bit c=1 means 'byte
    continues the current integer' (complete unary across control bytes)."""
    x = np.asarray(x, dtype=np.uint32)
    n = len(x)
    nb = np.maximum(1, -(-ebw_np(x) // 8)).astype(np.int64)
    total = int(nb.sum())
    data = np.zeros(total, np.uint8)
    ends = np.cumsum(nb)
    starts = ends - nb
    for j in range(4):
        sel = nb > j
        data[starts[sel] + j] = (x[sel].astype(np.uint64) >> np.uint64(8 * j)).astype(np.uint8)
    # continuation bit per data byte: 1 unless byte is the last of its int
    cont = np.ones(total, np.uint8)
    cont[ends - 1] = 0
    nareas = (total + 7) // 8
    contp = np.concatenate([cont, np.ones(nareas * 8 - total, np.uint8)])  # pad=1 (ignored)
    control = np.packbits(contp.reshape(-1, 8)[:, ::-1], axis=1).reshape(-1)  # LSB-first per byte
    datap = np.concatenate([data, np.zeros(nareas * 8 - total, np.uint8)])
    return Encoded("g8cu", n, control, datap, control_bits=nareas * 8,
                   data_bits=nareas * 64, header_bits=32, meta={"total": total})


def g8cu_decode(enc: Encoded) -> np.ndarray:
    total = enc.meta["total"]
    cont = np.unpackbits(enc.control, bitorder="little")[:total]
    ends = np.flatnonzero(cont == 0)[: enc.n]
    starts = np.concatenate([[0], ends[:-1] + 1])
    nb = ends - starts + 1
    vals = np.zeros(len(ends), np.uint64)
    by = np.concatenate([enc.data, np.zeros(4, np.uint8)])
    for j in range(4):
        sel = nb > j
        vals[sel] |= by[starts[sel] + j].astype(np.uint64) << np.uint64(8 * j)
    return vals.astype(np.uint32)[: enc.n]


# --------------------------------------------------------------------------- #
# Simple-9 / Simple-16 (Anh & Moffat; Zhang et al.)
# --------------------------------------------------------------------------- #

S9 = [(28, 1), (14, 2), (9, 3), (7, 4), (5, 5), (4, 7), (3, 9), (2, 14), (1, 28)]
# selector -> list of (count, bits), sum(count*bits) <= 28
S16 = [
    [(28, 1)], [(7, 2), (14, 1)], [(7, 1), (7, 2), (7, 1)], [(14, 1), (7, 2)],
    [(14, 2)], [(1, 4), (8, 3)], [(1, 3), (4, 4), (3, 3)], [(7, 4)],
    [(4, 5), (2, 4)], [(2, 4), (4, 5)], [(3, 6), (2, 5)], [(2, 5), (3, 6)],
    [(4, 7)], [(1, 10), (2, 9)], [(2, 14)], [(1, 28)],
]


def _runlen_leq(e: np.ndarray, b: int) -> np.ndarray:
    fits = e <= b
    q = len(fits)
    fp = np.flatnonzero(~fits)
    if len(fp) == 0:
        return q - np.arange(q)
    nxt = np.searchsorted(fp, np.arange(q))
    nxtf = np.where(nxt < len(fp), fp[np.minimum(nxt, len(fp) - 1)], q)
    return nxtf - np.arange(q)


def simple9_encode(x: np.ndarray) -> Encoded:
    x = np.asarray(x, dtype=np.uint32)
    n = len(x)
    e = ebw_np(x)
    if n and e.max() > 28:
        raise ValueError("Simple-9 supports at most 28-bit values (paper §4.1.2)")
    runs = {b: _runlen_leq(e, b) for _, b in S9}
    words, sels = [], []
    i = 0
    while i < n:
        for s, (cnt, b) in enumerate(S9):
            take = min(cnt, n - i)
            if runs[b][i] >= take and take == min(cnt, n - i) and (take == cnt or i + take == n):
                w = np.uint64(s) << np.uint64(28)
                for k in range(take):
                    w |= np.uint64(x[i + k]) << np.uint64(k * b)
                words.append(np.uint32(w & np.uint64(0xFFFFFFFF)))
                sels.append(s)
                i += take
                break
    data = np.asarray(words, np.uint32)
    return Encoded("simple9", n, np.zeros(0, np.uint8), data,
                   data_bits=len(data) * 32, header_bits=32, meta={"table": "S9"})


def simple9_decode(enc: Encoded) -> np.ndarray:
    data = enc.data
    sels = (data >> 28).astype(np.int64)
    counts = np.asarray([c for c, _ in S9])[sels]
    starts = np.cumsum(counts) - counts
    total = int(starts[-1] + counts[-1]) if len(data) else 0
    out = np.zeros(total, np.uint32)
    for s, (cnt, b) in enumerate(S9):
        rows = np.flatnonzero(sels == s)
        if not len(rows):
            continue
        vals = (data[rows][:, None].astype(np.uint64) >> (np.arange(cnt) * b).astype(np.uint64)[None, :]) & np.uint64(mask_np(b))
        idx = starts[rows][:, None] + np.arange(cnt)[None, :]
        keep = idx < total
        out[idx[keep]] = vals.astype(np.uint32)[keep]
    return out[: enc.n]


def simple16_encode(x: np.ndarray) -> Encoded:
    x = np.asarray(x, dtype=np.uint32)
    n = len(x)
    e = ebw_np(x).astype(np.int64)
    if n and e.max() > 28:
        raise ValueError("Simple-16 supports at most 28-bit values")
    # per-selector per-slot widths
    widths = []
    for spec in S16:
        w = []
        for cnt, b in spec:
            w += [b] * cnt
        widths.append(np.asarray(w, np.int64))
    words, sels = [], []
    i = 0
    while i < n:
        for s, w in enumerate(widths):
            take = min(len(w), n - i)
            if not np.all(e[i:i + take] <= w[:take]):
                continue
            word = np.uint64(s) << np.uint64(28)
            off = 0
            for k in range(take):
                word |= np.uint64(x[i + k]) << np.uint64(off)
                off += int(w[k])
            words.append(np.uint32(word & np.uint64(0xFFFFFFFF)))
            sels.append(s)
            i += take
            break
        else:
            raise AssertionError("no simple16 selector fits")
    data = np.asarray(words, np.uint32)
    return Encoded("simple16", n, np.zeros(0, np.uint8), data,
                   data_bits=len(data) * 32, header_bits=32)


def simple16_decode(enc: Encoded) -> np.ndarray:
    data = enc.data
    sels = (data >> 28).astype(np.int64)
    widths = []
    for spec in S16:
        w = []
        for cnt, b in spec:
            w += [b] * cnt
        widths.append(w)
    counts = np.asarray([len(w) for w in widths])[sels]
    starts = np.cumsum(counts) - counts
    total = int(starts[-1] + counts[-1]) if len(data) else 0
    out = np.zeros(total, np.uint32)
    for s, w in enumerate(widths):
        rows = np.flatnonzero(sels == s)
        if not len(rows):
            continue
        offs = np.cumsum([0] + w[:-1])
        for k, (o, b) in enumerate(zip(offs, w)):
            idx = starts[rows] + k
            keep = idx < total
            out[idx[keep]] = ((data[rows].astype(np.uint64) >> np.uint64(o)) & np.uint64(mask_np(b))).astype(np.uint32)[keep]
    return out[: enc.n]


# --------------------------------------------------------------------------- #
# Rice / Elias Gamma (bit-aligned)
# --------------------------------------------------------------------------- #


def _unary_binary_encode(q: np.ndarray, extra_vals: np.ndarray, extra_bits: np.ndarray):
    """Per code: q ones, a zero, then extra_bits low bits of extra_vals."""
    q = q.astype(np.int64)
    full_chunks = q // 32
    vals, lens = [], []
    # expand: per code, full_chunks 32-one words, then remainder+terminator+extra
    reps = full_chunks
    order = np.repeat(np.arange(len(q)), reps + 1)               # chunk rows per code
    is_last = np.concatenate([[True] if r == 0 else [False] * r + [True] for r in reps]) if len(q) else np.zeros(0, bool)
    # build via python-free vector ops:
    rem = (q % 32).astype(np.uint64)
    last_val = (np.uint64(1) << rem) - np.uint64(1)              # rem ones, then 0 implicit
    last_val |= extra_vals.astype(np.uint64) << (rem + np.uint64(1))
    last_len = rem.astype(np.int64) + 1 + extra_bits.astype(np.int64)
    ones32 = np.uint64(0xFFFFFFFF)
    all_vals = np.where(is_last, 0, ones32).astype(np.uint64)
    all_lens = np.where(is_last, 0, 32).astype(np.int64)
    lastpos = np.cumsum(reps + 1) - 1
    all_vals[lastpos] = last_val
    all_lens[lastpos] = last_len
    return pack_bits_np(all_vals, all_lens)


def rice_k(x: np.ndarray) -> int:
    x = np.asarray(x, np.uint32)
    if len(x) == 0:
        return 0
    mean = float(x.astype(np.float64).mean())
    k = int(np.floor(np.log2(max(0.69 * mean, 1.0))))
    # cap the worst-case quotient so pathological tails stay linear
    kmin = max(0, int(ebw_np(np.asarray([x.max()]))[0]) - 20)
    return max(k, kmin, 0)


def rice_encode(x: np.ndarray) -> Encoded:
    x = np.asarray(x, dtype=np.uint32)
    k = rice_k(x)
    q = (x >> k).astype(np.int64)
    extra = (x.astype(np.uint64) & np.uint64(mask_np(k))) if k else np.zeros(len(x), np.uint64)
    words, bits = _unary_binary_encode(q, extra, np.full(len(x), k, np.int64))
    return Encoded("rice", len(x), np.zeros(0, np.uint8), words,
                   data_bits=bits, header_bits=32 + 8, meta={"k": k})


def rice_decode(enc: Encoded) -> np.ndarray:
    k = enc.meta["k"]
    n = enc.n
    if n == 0:
        return np.zeros(0, np.uint32)
    bits = words_to_bits_np(enc.data, len(enc.data) * 32)
    zpos = np.flatnonzero(bits == 0)
    w = np.concatenate([enc.data, np.zeros(2, np.uint32)])
    out = np.zeros(n, np.uint32)
    pos = 0
    for i in range(n):
        z = zpos[np.searchsorted(zpos, pos)]
        q = z - pos
        extra = int(gather_bits_np(w, np.asarray([z + 1]), np.asarray([k]))[0]) if k else 0
        out[i] = (q << k) | extra
        pos = z + 1 + k
    return out


def gamma_encode(x: np.ndarray) -> Encoded:
    """Elias Gamma on x+1 (gamma cannot code 0)."""
    x1 = np.asarray(x, dtype=np.uint32).astype(np.uint64) + 1
    b = ebw_np(x1).astype(np.int64)                              # 1..33
    q = b - 1                                                    # unary ones
    extra_bits = b - 1
    extra = x1 & ((np.uint64(1) << extra_bits.astype(np.uint64)) - np.uint64(1))
    words, bits = _unary_binary_encode(q, extra, extra_bits)
    return Encoded("gamma", len(x1), np.zeros(0, np.uint8), words,
                   data_bits=bits, header_bits=32)


def gamma_decode(enc: Encoded) -> np.ndarray:
    n = enc.n
    if n == 0:
        return np.zeros(0, np.uint32)
    bits = words_to_bits_np(enc.data, len(enc.data) * 32)
    zpos = np.flatnonzero(bits == 0)
    w = np.concatenate([enc.data, np.zeros(2, np.uint32)])
    out = np.zeros(n, np.uint32)
    pos = 0
    for i in range(n):
        z = zpos[np.searchsorted(zpos, pos)]
        q = z - pos                                              # = b-1
        extra = int(gather_bits_np(w, np.asarray([z + 1]), np.asarray([q]))[0]) if q else 0
        val = (np.uint64(1) << np.uint64(q)) | np.uint64(extra)
        out[i] = np.uint32(val - np.uint64(1))
        pos = z + 1 + q
    return out


# --------------------------------------------------------------------------- #
# scalar frame codecs: PForDelta / AFOR / PackedBinary (horizontal layout)
# --------------------------------------------------------------------------- #

PFD_FRAME = 128
W_CHOICES = np.array([8, 16, 32], np.int32)


def pfd_encode(x: np.ndarray, zeta: float = 0.10) -> Encoded:
    x = np.asarray(x, dtype=np.uint32)
    n = len(x)
    if n == 0:
        return Encoded("pfordelta", 0, np.zeros(0, np.uint8), np.zeros(0, np.uint32),
                       exceptions=np.zeros(0, np.uint32), header_bits=32, meta={"n_exc": np.zeros(0, np.int32)})
    nf = (n + PFD_FRAME - 1) // PFD_FRAME
    e = ebw_np(x)
    ep = np.concatenate([e, np.zeros(nf * PFD_FRAME - n, np.int32)]).reshape(nf, PFD_FRAME)
    k = int(np.ceil((1.0 - zeta) * PFD_FRAME)) - 1
    bws = np.maximum(np.partition(ep, k, axis=1)[:, k], 1).astype(np.int32)
    xp = np.concatenate([x, np.zeros(nf * PFD_FRAME - n, np.uint32)])
    b_int = np.repeat(bws, PFD_FRAME)
    exc_mask = np.concatenate([e, np.zeros(nf * PFD_FRAME - n, np.int32)]) > b_int
    exc_mask[n:] = False
    exc_idx = np.flatnonzero(exc_mask)
    exc_frame = exc_idx // PFD_FRAME
    n_exc = np.bincount(exc_frame, minlength=nf).astype(np.int32)
    wcodes = np.zeros(nf, np.int32)
    if len(exc_idx):
        maxe = np.zeros(nf, np.int32)
        np.maximum.at(maxe, exc_frame, ebw_np(xp[exc_idx]))
        wcodes = np.minimum(np.searchsorted(W_CHOICES, np.maximum(maxe, 1)), 2)
    ws = W_CHOICES[wcodes]
    vals_list, lens_list = [], []
    for f in np.flatnonzero(n_exc):
        sel = exc_frame == f
        pos = (exc_idx[sel] % PFD_FRAME).astype(np.uint64)
        vals = xp[exc_idx[sel]].astype(np.uint64)
        vals_list += [pos, vals]
        lens_list += [np.full(sel.sum(), 8, np.int64), np.full(sel.sum(), int(ws[f]), np.int64)]
    if vals_list:
        exc_words, exc_bits = pack_bits_np(np.concatenate(vals_list), np.concatenate(lens_list))
    else:
        exc_words, exc_bits = np.zeros(0, np.uint32), 0
    data, dbits = pack_bits_np(xp[:n].astype(np.uint64) & mask_np(b_int[:n]).astype(np.uint64), b_int[:n].astype(np.int64))
    control = np.stack([(bws.astype(np.uint8) | (wcodes.astype(np.uint8) << 6)), n_exc.astype(np.uint8)], axis=1).reshape(-1)
    return Encoded("pfordelta", n, control, data, control_bits=nf * 16,
                   data_bits=dbits, exceptions=exc_words, exception_bits=exc_bits,
                   header_bits=32, meta={"n_exc": n_exc})


def pfd_decode(enc: Encoded) -> np.ndarray:
    if enc.n == 0:
        return np.zeros(0, np.uint32)
    c = enc.control.reshape(-1, 2)
    bws = (c[:, 0] & 63).astype(np.int64)
    ws = W_CHOICES[(c[:, 0] >> 6).astype(np.int64)]
    n_exc = c[:, 1].astype(np.int64)
    b_int = np.repeat(bws, PFD_FRAME)[: enc.n]
    offs = np.cumsum(b_int) - b_int
    out = gather_bits_np(enc.data, offs, b_int)
    tot = int(n_exc.sum())
    if tot:
        frame_bits = n_exc * (8 + ws)
        base = np.cumsum(frame_bits) - frame_bits
        fid = np.repeat(np.arange(len(n_exc)), n_exc)
        j = np.arange(tot) - np.repeat(np.cumsum(n_exc) - n_exc, n_exc)
        pos = gather_bits_np(enc.exceptions, base[fid] + j * 8, np.full(tot, 8))
        vals = gather_bits_np(enc.exceptions, base[fid] + n_exc[fid] * 8 + j * ws[fid], ws[fid])
        g = fid * PFD_FRAME + pos
        out[g[g < enc.n]] = vals[g < enc.n]
    return out


def afor_encode(x: np.ndarray) -> Encoded:
    """Scalar AFOR: frames of {8,16,32} integers, DP partition, 1-byte headers."""
    x = np.asarray(x, dtype=np.uint32)
    n = len(x)
    if n == 0:
        return Encoded("afor", 0, np.zeros(0, np.uint8), np.zeros(0, np.uint32), header_bits=32)
    e = ebw_np(x)
    nb = (n + 7) // 8
    ep = np.concatenate([e, np.zeros(nb * 8 - n, np.int32)])
    m1 = np.maximum(ep.reshape(-1, 8).max(axis=1), 1)
    m2 = np.maximum(m1[:-1], m1[1:]) if nb > 1 else np.zeros(0, np.int32)
    m4 = np.maximum(m2[:-2], m2[2:]) if nb > 3 else np.zeros(0, np.int32)
    dp = np.zeros(nb + 1, np.int64)
    ch = np.zeros(nb, np.int8)
    for i in range(nb - 1, -1, -1):
        best = 8 + 8 * int(m1[i]) + dp[i + 1]
        c = 0
        if i + 2 <= nb and 8 + 16 * int(m2[i]) + dp[i + 2] < best:
            best, c = 8 + 16 * int(m2[i]) + dp[i + 2], 1
        if i + 4 <= nb and 8 + 32 * int(m4[i]) + dp[i + 4] < best:
            best, c = 8 + 32 * int(m4[i]) + dp[i + 4], 2
        dp[i], ch[i] = best, c
    sizes, bws = [], []
    i = 0
    while i < nb:
        c = int(ch[i])
        blocks = (1, 2, 4)[c]
        sizes.append(blocks * 8)
        if c == 0:
            bws.append(int(m1[i]))
        elif c == 1:
            bws.append(int(m2[i]))
        else:
            bws.append(int(m4[i]))
        i += blocks
    sizes = np.asarray(sizes, np.int64)
    bws = np.asarray(bws, np.int64)
    b_int = np.repeat(bws, sizes)[:n]
    data, dbits = pack_bits_np(x.astype(np.uint64) & mask_np(b_int).astype(np.uint64), b_int)
    control = (np.searchsorted([8, 16, 32], sizes).astype(np.uint8) | (bws.astype(np.uint8) << 2))
    return Encoded("afor", n, control, data, control_bits=len(control) * 8,
                   data_bits=dbits, header_bits=32)


def afor_decode(enc: Encoded) -> np.ndarray:
    if enc.n == 0:
        return np.zeros(0, np.uint32)
    sizes = np.asarray([8, 16, 32])[(enc.control & 3).astype(np.int64)]
    bws = (enc.control >> 2).astype(np.int64)
    b_int = np.repeat(bws, sizes)[: enc.n]
    offs = np.cumsum(b_int) - b_int
    return gather_bits_np(enc.data, offs, b_int)


def packedbinary_encode(x: np.ndarray, frame: int = 512) -> Encoded:
    x = np.asarray(x, dtype=np.uint32)
    n = len(x)
    if n == 0:
        return Encoded("packed_binary", 0, np.zeros(0, np.uint8), np.zeros(0, np.uint32), header_bits=32, meta={"frame": frame})
    nf = (n + frame - 1) // frame
    e = np.concatenate([ebw_np(x), np.zeros(nf * frame - n, np.int32)]).reshape(nf, frame)
    bws = np.maximum(e.max(axis=1), 1).astype(np.int64)
    b_int = np.repeat(bws, frame)[:n]
    data, dbits = pack_bits_np(x.astype(np.uint64), b_int)
    return Encoded("packed_binary", n, bws.astype(np.uint8), data,
                   control_bits=nf * 8, data_bits=dbits, header_bits=32, meta={"frame": frame})


def packedbinary_decode(enc: Encoded) -> np.ndarray:
    if enc.n == 0:
        return np.zeros(0, np.uint32)
    frame = enc.meta["frame"]
    bws = enc.control.astype(np.int64)
    b_int = np.repeat(bws, frame)[: enc.n]
    offs = np.cumsum(b_int) - b_int
    return gather_bits_np(enc.data, offs, b_int)
