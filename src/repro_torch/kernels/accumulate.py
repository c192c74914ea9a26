"""Segmented accumulate: the scatter half of every device-resident round.

Per work-list entry, combine a (lane,) contribution vector into the owning
query's row of a batch-segmented state array: survivor bits into the
(Q, words) candidate bitmaps, integer impact codes into a (Q, width)
accumulator.

* :func:`scatter_bits` / :func:`scatter_add`: kernel B2 of the port
  (``csrc/accumulate.cu``), replacing the JAX package's Pallas kernel
  ``kernels/accumulate.py`` ``_sparse_pallas`` (body ``_sparse_kernel``).
  One thread per (entry, lane) and one atomic per survivor: ``atomicOr`` for
  the bits, ``atomicAdd`` on unsigned int (wrapping mod 2**32 like the
  reference's u32) for the adds.  The TPU form's sort by query slot and
  row-resident VMEM aliasing existed for its sequential grid; the port drops
  both.  What bounds it on the H100 is bytes: ids, masks and contributions
  read once, one 4-byte read-modify-write per survivor.
* :func:`dense_window_gather` / :func:`dense_window_add`: 128-word window
  probe/commit of the dense AND rounds, plain torch (the reference leaves
  them to XLA).

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

_SCATTER_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 4 + [
    ctypes.c_void_p]


def _check_scatter(state, ids, qslot, vals, vals_dtype, what: str) -> None:
    named = {"state": (state, torch.int32), "ids": (ids, torch.int32),
             "qslot": (qslot, torch.int32), what: (vals, vals_dtype)}
    for name, (t, dt) in named.items():
        if t.dtype != dt:
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


def _scatter_launch(symbol: str, state, ids, qslot, vals) -> None:
    fn = cuda_build.function("accumulate", symbol, _SCATTER_ARGS)
    with torch.cuda.device(state.device):
        err = fn(state.data_ptr(), ids.data_ptr(), qslot.data_ptr(),
                 vals.data_ptr(), ids.shape[0], ids.shape[1],
                 state.shape[0], state.shape[1],
                 cuda_build.stream_ptr(state))
    cuda_build.check(err, "accumulate", f"{symbol}(P={ids.shape[0]})")


def _flat_targets(state, cols, qslot, keep):
    """Flat state indices of the kept (entry, lane) updates; rows or columns
    out of range are dropped, as the reference's XLA scatter drops them."""
    q = qslot.long()[:, None].expand_as(cols)
    keep = keep & (q >= 0) & (q < state.shape[0]) & (cols < state.shape[1])
    return (q * state.shape[1] + cols)[keep], keep


def _add_at(state, flat, vals) -> None:
    """state.flat[flat] += vals mod 2**32, duplicates summed first."""
    if flat.numel() == 0:
        return
    uniq, inv = torch.unique(flat, return_inverse=True)
    sums = torch.zeros(uniq.shape[0], dtype=torch.int64, device=flat.device)
    sums.index_add_(0, inv, vals)
    view = state.view(-1)
    view[uniq] = i32(u32(view[uniq]) + sums)


# --------------------------------------------------------------------------- #
# B2, bits form
# --------------------------------------------------------------------------- #


def scatter_bits(bm, ids, qslot, surv):
    """OR survivor docids into ``bm`` in place and return it:
    ``bm[qslot[j], ids[j, l] >> 5] |= 1 << (ids[j, l] & 31)`` where
    ``surv[j, l]``.

    bm: (Q, words) int32; ids: (P, L) int32 docids; qslot: (P,) int32;
    surv: (P, L) bool.  On a zeroed ``bm`` this is the reference's
    ``scatter_bits`` bit for bit.
    """
    _check_scatter(bm, ids, qslot, surv, torch.bool, "surv")
    if not bm.is_cuda:
        return scatter_bits_plain(bm, ids, qslot, surv)
    if ids.numel():
        _scatter_launch("repro_scatter_bits", bm, ids, qslot, surv)
        count_launch("B2", P=ids.shape[0], L=ids.shape[1], Q=bm.shape[0],
                     words=bm.shape[1])
    return bm


def scatter_bits_plain(bm, ids, qslot, surv):
    """Plain torch version of :func:`scatter_bits` (any device): the
    reference's zeroed scatter-add of ``1 << (id & 31)``, ORed into ``bm``."""
    idw = u32(ids)
    flat, keep = _flat_targets(bm, idw >> 5, qslot, surv)
    if flat.numel():
        uniq, inv = torch.unique(flat, return_inverse=True)
        sums = torch.zeros(uniq.shape[0], dtype=torch.int64, device=bm.device)
        sums.index_add_(0, inv, torch.bitwise_left_shift(
            torch.ones_like(idw), idw & 31)[keep])
        view = bm.view(-1)
        view[uniq] = view[uniq] | i32(sums)
    return bm


# --------------------------------------------------------------------------- #
# B2, add form
# --------------------------------------------------------------------------- #


def scatter_add(acc, ids, qslot, contrib):
    """``acc[qslot[j], ids[j, l]] += contrib[j, l]`` mod 2**32, in place;
    returns ``acc``.  acc: (Q, width) int32; ids, contrib: (P, L) int32;
    qslot: (P,) int32.  Exact: docids are distinct per entry and masked
    lanes carry contrib == 0."""
    _check_scatter(acc, ids, qslot, contrib, torch.int32, "contrib")
    if not acc.is_cuda:
        return scatter_add_plain(acc, ids, qslot, contrib)
    if ids.numel():
        _scatter_launch("repro_scatter_add", acc, ids, qslot, contrib)
        count_launch("B2add", P=ids.shape[0], L=ids.shape[1], Q=acc.shape[0],
                     width=acc.shape[1])
    return acc


def scatter_add_plain(acc, ids, qslot, contrib):
    """Plain torch version of :func:`scatter_add` (any device)."""
    flat, keep = _flat_targets(acc, u32(ids), qslot,
                               torch.ones_like(ids, dtype=torch.bool))
    _add_at(acc, flat, u32(contrib)[keep])
    return acc


# --------------------------------------------------------------------------- #
# 128-word window probe / commit (bitmap AND rounds), plain torch
# --------------------------------------------------------------------------- #


def dense_window_gather(bm, qslot, w0):
    """(P, 128) int32: each entry's word window of its query's bitmap row."""
    cols = w0.long()[:, None] + torch.arange(WINDOW_WORDS, device=bm.device)
    return bm[qslot.long()[:, None], cols]


def dense_window_add(dst, vals, qslot, w0, act):
    """dst[qslot[j], w0[j] : w0[j] + 128] += vals[j] where act[j], in place
    (mod 2**32); returns ``dst``.  An exact OR under the disjoint-bits
    contract."""
    cols = w0.long()[:, None] + torch.arange(WINDOW_WORDS, device=dst.device)
    flat = (qslot.long()[:, None] * dst.shape[1] + cols)[act]
    _add_at(dst, flat.reshape(-1), u32(vals)[act].reshape(-1))
    return dst
