"""Segmented accumulate: the scatter half of every device-resident round.

Per work-list entry, combine a (lane,) contribution vector into the owning
query's row of a batch-segmented state array: survivor bits into the
(Q, words) candidate bitmaps, integer impact codes into a (Q, width)
accumulator.

* :func:`scatter_bits` / :func:`scatter_add`: kernel B2 of the port
  (``csrc/accumulate.cu``), replacing the JAX package's Pallas kernel
  ``kernels/accumulate.py`` ``_sparse_pallas`` (body ``_sparse_kernel``).
  ``atomicAdd`` on unsigned int (wrapping mod 2**32 like the reference's
  u32) for each live add; ``atomicOr`` for the bits, one a word a warp
  after the warp merges its lanes' bits.  :func:`scatter_bits` reads four
  lanes' mask a thread, so a warp of 128 dead lanes (most of a fused
  round) costs one load a thread, and takes the mask as bools or as the
  fused decode's int32 hit words.
  The TPU form's sort by query slot and row-resident VMEM aliasing existed
  for its sequential grid; the port drops both.  What bounds both forms on
  the H100 is sector traffic: a round's docids lie far apart in a state
  array much larger than L2, so each update reads and writes back a 32-byte
  sector of its own (64 B), beside the inputs read once; how near the add
  form gets to that depends on the order its atomics reach memory, so it
  keeps one thread per (entry, lane) in the array's order (one block per
  256 lanes of one entry, no per-lane division).
  :func:`scatter_add_masked`, the ranked rounds' form, takes the survivor
  mask beside the codes and reads a dead lane's code and id never.
* :func:`dense_add` / :func:`dense_add_packed`: kernel B4 of the port
  (``csrc/accumulate.cu``), replacing the Pallas kernel
  ``kernels/accumulate.py`` ``_dense_pallas`` (body ``_dense_kernel``):
  ``acc[qslot[j], col0[j] : col0[j] + 4096] += codes[j]`` where ``act[j]``.
  The TPU form relied on a sequential grid (entries sorted by query, the row
  aliased in VMEM); two entries of one query may overlap in columns within a
  call, so the kernel makes one unsigned ``atomicAdd`` per non-zero code,
  each warp-wide atomic on 32 consecutive words.  :func:`dense_add` takes
  (P, 4096) codes; :func:`dense_add_packed`, the ranked rounds' form, takes
  the packed (P, 1024) score tiles and, gated, the (P, 128) window bits, so
  the codes are never unpacked into memory; gated, it reads a window word
  before its 32 codes and fetches none of them where the word is 0.  What
  bounds it on the H100 is bytes: per active entry 16 KB (unpacked), 4 KB
  (packed) or, gated, 512 B of window and 32 B per non-zero window word,
  and one read-modify-write per touched word.
* :func:`dense_window_gather` / :func:`dense_window_add` /
  :func:`dense_window_or`: 128-word window probe/commit of the dense
  rounds, plain torch (the reference leaves them to XLA).

Both sparse forms update their state **in place** and return it: the
reference's ``scatter_bits`` returned a freshly zeroed scatter that its
caller ORed into ``new``; ORing straight into ``new`` gives the same bits
because one round's docid sets are disjoint (within one round a
(query, term) contributes each docid at most once, and a block is served by
one representation), and saves a zero-fill of the whole bitmap per call.

A wrapper given CPU tensors runs the plain torch version; given CUDA tensors
it launches the kernel or raises.  Every word tensor holds uint32 bit
patterns as int32 (``core/bits.py``).
"""

from __future__ import annotations

import ctypes

import torch

from ..core.bits import i32, u32
from . import count_launch, cuda_build

DENSE_WINDOW = 4096          # dense score window: 128 words * 32 bits
WINDOW_WORDS = 128
TILE_WORDS = DENSE_WINDOW // 4   # packed score window: four u8 codes a word

# elements per chunk of the plain packed dense add's unpacked codes (1 GB
# of int32)
CHUNK_ELEMS = 1 << 28

_BITS_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4 + [
    ctypes.c_int, ctypes.c_void_p]
_ADD_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 4 + [
    ctypes.c_void_p]
_DENSE_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 3 + [
    ctypes.c_int, ctypes.c_void_p]
_UNPACKED, _PACKED, _PACKED_GATED = 0, 1, 2    # repro_dense_add's forms


def _check_scatter(state, ids, qslot, vals, vals_dtype, what: str) -> None:
    """``vals_dtype``: the dtype ``vals`` must have, or a tuple of those it
    may have."""
    named = {"state": (state, torch.int32), "ids": (ids, torch.int32),
             "qslot": (qslot, torch.int32), what: (vals, vals_dtype)}
    for name, (t, dt) in named.items():
        if t.dtype not in (dt if isinstance(dt, tuple) else (dt,)):
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != state.device:
            raise ValueError(f"{name} on {t.device}, state on {state.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if state.dim() != 2 or ids.dim() != 2:
        raise ValueError("state and ids must be 2-D")
    if tuple(qslot.shape) != (ids.shape[0],) or vals.shape != ids.shape:
        raise ValueError(f"qslot {tuple(qslot.shape)} / {what} "
                         f"{tuple(vals.shape)} do not match ids "
                         f"{tuple(ids.shape)}")


def _scatter_launch(symbol: str, argtypes, state, ids, qslot, *vals,
                    extra=()):
    """Launch ``repro_scatter_bits(..., surv, ..., mask_bytes)`` or
    ``repro_scatter_add(..., contrib, surv or None, ...)`` on ``state``
    (``extra``: the arguments between the sizes and the stream)."""
    fn = cuda_build.function("accumulate", symbol, argtypes)
    with torch.cuda.device(state.device):
        err = fn(state.data_ptr(), ids.data_ptr(), qslot.data_ptr(),
                 *(None if v is None else v.data_ptr() for v in vals),
                 ids.shape[0], ids.shape[1], state.shape[0], state.shape[1],
                 *extra, cuda_build.stream_ptr(state))
    cuda_build.check(err, "accumulate", f"{symbol}(P={ids.shape[0]})")


def _flat_targets(state, cols, qslot, keep):
    """Flat state indices of the kept (entry, lane) updates; rows or columns
    out of range are dropped, as the reference's XLA scatter drops them."""
    q = qslot.long()[:, None].expand_as(cols)
    keep = keep & (q >= 0) & (q < state.shape[0]) & (cols < state.shape[1])
    return (q * state.shape[1] + cols)[keep], keep


def _sums_at(flat, vals):
    """(unique flat indices, int64 sum of ``vals`` at each)."""
    uniq, inv = torch.unique(flat, return_inverse=True)
    sums = torch.zeros(uniq.shape[0], dtype=torch.int64, device=flat.device)
    sums.index_add_(0, inv, vals)
    return uniq, sums


def _add_at(state, flat, vals) -> None:
    """state.flat[flat] += vals mod 2**32, duplicates summed first."""
    if flat.numel() == 0:
        return
    uniq, sums = _sums_at(flat, vals)
    view = state.view(-1)
    view[uniq] = i32(u32(view[uniq]) + sums)


def _or_at(state, flat, vals) -> None:
    """state.flat[flat] |= vals, duplicates summed first: the reference's
    zeroed scatter-add ORed into ``state`` (an OR where the summed values
    share no bit)."""
    if flat.numel() == 0:
        return
    uniq, sums = _sums_at(flat, vals)
    view = state.view(-1)
    view[uniq] = view[uniq] | i32(sums)


# --------------------------------------------------------------------------- #
# B2, bits form
# --------------------------------------------------------------------------- #


def scatter_bits(bm, ids, qslot, surv):
    """OR survivor docids into ``bm`` in place and return it:
    ``bm[qslot[j], ids[j, l] >> 5] |= 1 << (ids[j, l] & 31)`` where
    ``surv[j, l]``.

    bm: (Q, words) int32; ids: (P, L) int32 docids; qslot: (P,) int32;
    surv: (P, L) bool, or int32 hit words (a lane survives where its word
    is not 0: the fused decode's hits, read as they are, with no pass that
    makes bools of them).  On a zeroed ``bm`` this is the reference's
    ``scatter_bits`` of ``surv != 0`` bit for bit.
    """
    _check_scatter(bm, ids, qslot, surv, (torch.bool, torch.int32), "surv")
    if not bm.is_cuda:
        return scatter_bits_plain(bm, ids, qslot, surv)
    if ids.numel():
        _scatter_launch("repro_scatter_bits", _BITS_ARGS, bm, ids, qslot,
                        surv, extra=(surv.element_size(),))
        count_launch("B2", P=ids.shape[0], L=ids.shape[1], Q=bm.shape[0],
                     words=bm.shape[1])
    return bm


def scatter_bits_plain(bm, ids, qslot, surv):
    """Plain torch version of :func:`scatter_bits` (any device): the
    reference's zeroed scatter-add of ``1 << (id & 31)``, ORed into ``bm``."""
    idw = u32(ids)
    flat, keep = _flat_targets(bm, idw >> 5, qslot, surv != 0)
    _or_at(bm, flat, torch.bitwise_left_shift(torch.ones_like(idw),
                                              idw & 31)[keep])
    return bm


# --------------------------------------------------------------------------- #
# B2, add form
# --------------------------------------------------------------------------- #


def scatter_add(acc, ids, qslot, contrib):
    """``acc[qslot[j], ids[j, l]] += contrib[j, l]`` mod 2**32, in place;
    returns ``acc``.  acc: (Q, width) int32, width < 2**31; ids, contrib:
    (P, L) int32; qslot: (P,) int32.  Exact, duplicates included (masked
    lanes carry contrib == 0)."""
    _check_scatter(acc, ids, qslot, contrib, torch.int32, "contrib")
    if not acc.is_cuda:
        return scatter_add_plain(acc, ids, qslot, contrib)
    if ids.numel():
        _scatter_launch("repro_scatter_add", _ADD_ARGS, acc, ids, qslot,
                        contrib, None)
        count_launch("B2add", P=ids.shape[0], L=ids.shape[1], Q=acc.shape[0],
                     width=acc.shape[1])
    return acc


def scatter_add_plain(acc, ids, qslot, contrib):
    """Plain torch version of :func:`scatter_add` (any device)."""
    flat, keep = _flat_targets(acc, u32(ids), qslot,
                               torch.ones_like(ids, dtype=torch.bool))
    _add_at(acc, flat, u32(contrib)[keep])
    return acc


def scatter_add_masked(acc, ids, qslot, codes, surv):
    """:func:`scatter_add` of ``torch.where(surv, codes, 0)``, in place,
    without making it: the ranked rounds' scatter.  surv: (P, L) bool; the
    rest as :func:`scatter_add`.  The kernel reads a dead lane's code and
    id never."""
    _check_scatter(acc, ids, qslot, codes, torch.int32, "codes")
    _check_scatter(acc, ids, qslot, surv, torch.bool, "surv")
    if not acc.is_cuda:
        return scatter_add_masked_plain(acc, ids, qslot, codes, surv)
    if ids.numel():
        _scatter_launch("repro_scatter_add", _ADD_ARGS, acc, ids, qslot,
                        codes, surv)
        count_launch("B2add", P=ids.shape[0], L=ids.shape[1], Q=acc.shape[0],
                     width=acc.shape[1])
    return acc


def scatter_add_masked_plain(acc, ids, qslot, codes, surv):
    """Plain torch version of :func:`scatter_add_masked` (any device)."""
    return scatter_add_plain(acc, ids, qslot, torch.where(surv, codes, 0))


# --------------------------------------------------------------------------- #
# B4: dense 4096-column window add (score side of bitmap blocks)
# --------------------------------------------------------------------------- #


def _check_dense(acc, codes, cols, qslot, col0, act, win=None) -> None:
    named = {"acc": (acc, torch.int32), "codes": (codes, torch.int32),
             "qslot": (qslot, torch.int32), "col0": (col0, torch.int32),
             "act": (act, torch.bool)}
    if win is not None:
        named["win"] = (win, torch.int32)
    for name, (t, dt) in named.items():
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != acc.device:
            raise ValueError(f"{name} on {t.device}, acc on {acc.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    p = codes.shape[0]
    if (acc.dim() != 2 or acc.shape[1] < DENSE_WINDOW
            or tuple(codes.shape) != (p, cols)):
        raise ValueError(f"acc must be (Q, >= {DENSE_WINDOW}) and codes "
                         f"(P, {cols}); got {tuple(acc.shape)}, "
                         f"{tuple(codes.shape)}")
    if win is not None and tuple(win.shape) != (p, WINDOW_WORDS):
        raise ValueError(f"win must have shape ({p}, {WINDOW_WORDS})")
    for name in ("qslot", "col0", "act"):
        if tuple(named[name][0].shape) != (p,):
            raise ValueError(f"{name} must have shape ({p},)")


def _dense_launch(acc, codes, win, qslot, col0, act, form: int) -> None:
    fn = cuda_build.function("accumulate", "repro_dense_add", _DENSE_ARGS)
    with torch.cuda.device(acc.device):
        err = fn(acc.data_ptr(), codes.data_ptr(),
                 None if win is None else win.data_ptr(), qslot.data_ptr(),
                 col0.data_ptr(), act.data_ptr(), codes.shape[0],
                 acc.shape[0], acc.shape[1], form, cuda_build.stream_ptr(acc))
    cuda_build.check(err, "accumulate",
                     f"repro_dense_add(P={codes.shape[0]}, form={form})")
    count_launch("B4", P=codes.shape[0], Q=acc.shape[0], width=acc.shape[1],
                 packed=form != _UNPACKED, gated=form == _PACKED_GATED)


def dense_add(acc, codes, qslot, col0, act):
    """``acc[qslot[j], col0[j] : col0[j] + 4096] += codes[j]`` mod 2**32
    where ``act[j]``, in place; returns ``acc``.

    acc: (Q, width) int32; codes: (P, 4096) int32; qslot, col0: (P,) int32
    (``col0`` 128-aligned, the window inside the row); act: (P,) bool.
    Entries need no order, and two entries of one query may overlap in
    columns.
    """
    _check_dense(acc, codes, DENSE_WINDOW, qslot, col0, act)
    if not acc.is_cuda:
        return dense_add_plain(acc, codes, qslot, col0, act)
    if codes.shape[0]:
        _dense_launch(acc, codes, None, qslot, col0, act, _UNPACKED)
    return acc


def dense_add_plain(acc, codes, qslot, col0, act):
    """Plain torch version of :func:`dense_add` (any device): the
    reference's CPU route ``_dense_loop``, whose ``dynamic_slice`` clamps
    each window's row and start into the array (the kernel instead stops on
    such a window, a caller bug)."""
    q = qslot.long().clamp(0, acc.shape[0] - 1)
    c0 = col0.long().clamp(0, acc.shape[1] - DENSE_WINDOW)
    cols = c0[:, None] + torch.arange(DENSE_WINDOW, device=acc.device)
    flat = (q[:, None] * acc.shape[1] + cols)[act]
    _add_at(acc, flat.reshape(-1), u32(codes)[act].reshape(-1))
    return acc


def _window_codes(tiles):
    """(P, 1024) packed code windows -> (P, 4096) codes, position p from
    byte p & 3 of word p >> 2."""
    shifts = 8 * torch.arange(4, dtype=torch.int32, device=tiles.device)
    return ((tiles[:, :, None] >> shifts) & 0xFF).reshape(tiles.shape[0], -1)


def _window_bits(words):
    """(P, 128) bitmap windows -> (P, 4096) 0/1, position p from bit p & 31
    of word p >> 5."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words[:, :, None] >> shifts) & 1).reshape(words.shape[0], -1)


def dense_add_packed(acc, tiles, win, qslot, col0, act, *, gated: bool):
    """:func:`dense_add` of the codes packed in ``tiles``, times the window
    bits of ``win`` when ``gated``, in place; returns ``acc``.

    tiles: (P, 1024) int32 packed code windows, position p at byte p & 3 of
    word p >> 2 (positions without a posting carry 0); win: (P, 128) int32
    window words, position p at bit p & 31 of word p >> 5 (read only when
    ``gated``); the rest as :func:`dense_add`.  Ungated, every code of the
    window adds, as in the reference's ungated round.
    """
    _check_dense(acc, tiles, TILE_WORDS, qslot, col0, act, win)
    if not acc.is_cuda:
        return dense_add_packed_plain(acc, tiles, win, qslot, col0, act,
                                      gated=gated)
    if tiles.shape[0]:
        _dense_launch(acc, tiles, win, qslot, col0, act,
                      _PACKED_GATED if gated else _PACKED)
    return acc


def dense_add_packed_plain(acc, tiles, win, qslot, col0, act, *,
                           gated: bool):
    """Plain torch version of :func:`dense_add_packed` (any device): unpack
    (and gate) the codes, then :func:`dense_add_plain`.  The unpacked codes
    cost 16 KB an entry, so entries go in chunks of CHUNK_ELEMS // 4096;
    adds commute, so chunking changes no result."""
    step = max(1, CHUNK_ELEMS // DENSE_WINDOW)
    for s in range(0, tiles.shape[0], step):
        part = slice(s, s + step)
        codes = _window_codes(tiles[part])
        if gated:
            codes = codes * _window_bits(win[part])
        dense_add_plain(acc, codes, qslot[part], col0[part], act[part])
    return acc


# --------------------------------------------------------------------------- #
# 128-word window probe / commit (bitmap rounds), plain torch
# --------------------------------------------------------------------------- #


def dense_window_gather(bm, qslot, w0):
    """(P, 128) int32: each entry's word window of its query's bitmap row."""
    return bm.view(-1)[_window_targets(bm, qslot, w0)]


def dense_window_add(dst, vals, qslot, w0, act):
    """dst[qslot[j], w0[j] : w0[j] + 128] += vals[j] where act[j], in place
    (mod 2**32); returns ``dst``.  An exact OR under the disjoint-bits
    contract."""
    flat = _window_targets(dst, qslot, w0)[act]
    _add_at(dst, flat.reshape(-1), u32(vals)[act].reshape(-1))
    return dst


def dense_window_or(dst, vals, qslot, w0, act):
    """``dst | dense_window_add(zeros_like(dst), vals, qslot, w0, act)`` in
    place (the membership commit of the dense score rounds); returns
    ``dst``."""
    flat = _window_targets(dst, qslot, w0)[act]
    _or_at(dst, flat.reshape(-1), u32(vals)[act].reshape(-1))
    return dst


def _window_targets(dst, qslot, w0):
    """(P, 128) flat indices of each entry's word window."""
    cols = w0.long()[:, None] + torch.arange(WINDOW_WORDS, device=dst.device)
    return qslot.long()[:, None] * dst.shape[1] + cols
