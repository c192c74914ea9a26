"""Device-resident AND rounds: segmented candidate bitmaps + per-round
intersection that never copies candidates back to the host.

Counterpart of the JAX package's ``kernels/intersect_rounds.py``:

  * **segmented candidate bitmap**: the whole batch's candidate sets as ONE
    (n_queries, words) int32 tensor; query q owns row q, a packed LSB-first
    bitmap over [0, n_docs), padded to whole (rows, 128) tiles.
  * ``round_accumulate*``: every work-list lane probes its query's segment of
    the *old* bitmap and survivors are ORed into one shared *new* bitmap
    (``accumulate.scatter_bits``, kernel B2); ``round_commit`` folds the new
    bitmap back per query.  The splits of one round (arena decode, fused
    decode, dense windows) serve disjoint blocks, so their ORs compose.
  * ``dense_round_accumulate``: dense-bitmap blocks ANDed word-parallel.
  * :func:`segmented_decode_and`: kernel B1 (``csrc/decode_and.cu``), the
    fused unpack + prefix-sum + probe where every work-list entry probes
    *its own query's* bitmap segment.  Replaces the Pallas kernel of the
    same name (body ``_seg_kernel``).
  * ``extract_ids``: the single final host copy, bitmap rows back to sorted
    uint32 docid arrays, once per batch.

Correctness does not depend on block selection: decoding a superset of the
blocks that could hold candidates is sound, because ids outside the current
candidate set fail the probe and scatter nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.bits import u32, word_index
from ..obs.trace import get_tracer
from . import accumulate, count_launch
from .bitpack import LANES
from .decode_fused import (check_decode_args, decode_and_launch,
                           decode_and_plain, rows_per_block)


def bitmap_geometry(n_docs: int) -> tuple[int, int]:
    """(words, rows) of one query's candidate bitmap segment: enough uint32
    words to cover [0, n_docs), padded to whole (rows, 128) lane tiles."""
    cw = max(1, -(-n_docs // 32))
    rows = -(-cw // LANES)
    return rows * LANES, rows


def pack_live_words(dead: np.ndarray, n_docs: int, words: int) -> np.ndarray:
    """One mutation epoch's live-doc mask as a ``(words,)`` uint32 bitmap row
    (bit d of word d // 32 is 1 iff doc d is live; bits past n_docs are 0)."""
    bits = np.zeros(words * 32, np.uint8)
    bits[:n_docs] = 1
    if len(dead):
        bits[dead] = 0
    return np.packbits(bits, bitorder="little").view(np.uint32)


def pack_live_words_range(dead: np.ndarray, lo: int, hi: int,
                          words: int) -> np.ndarray:
    """Per-shard form of :func:`pack_live_words`: the live row of the doc
    range [lo, hi) in the range's local docid space (bit d is doc lo + d);
    ``dead`` entries outside [lo, hi) are dropped before packing."""
    dead = np.asarray(dead, np.int64)
    sub = dead[(dead >= lo) & (dead < hi)] - lo
    return pack_live_words(sub, hi - lo, words)


# --------------------------------------------------------------------------- #
# probe + scatter rounds (the generic-arena placement and the seed round)
# --------------------------------------------------------------------------- #


def round_accumulate(new, ids, qslot, ns, bm_old, *, probe: bool = True):
    """Probe ``bm_old``, OR survivors into the shared ``new`` bitmap (in
    place; returns it).

    ids: (P, L) int32 decoded docid rows, zero-padded past ``ns``.
    qslot, ns: (P,) int32 owning query row and valid posting count.
    probe: False builds the seed bitmap (round 0: no old candidates yet).
    """
    lane = torch.arange(ids.shape[1], device=ids.device)
    surv = lane[None, :] < ns.long()[:, None]
    if probe:
        cw = bm_old.shape[1]
        d = u32(ids)
        word = bm_old[qslot.long()[:, None], word_index(d, cw)]
        surv = surv & (((u32(word) >> (d & 31)) & 1) == 1)
    return accumulate.scatter_bits(new, ids, qslot, surv)


def round_accumulate_masked(new, ids, qslot, hits):
    """:func:`round_accumulate` with the probe already applied: ``hits`` is
    the per-lane int32 survivor mask a fused kernel produced (non-zero:
    alive), which kernel B2 reads as it is."""
    return accumulate.scatter_bits(new, ids, qslot, hits)


def dense_round_accumulate(new, words, qslot, w0, act, bm_old, *,
                           probe: bool = True):
    """Dense-bitmap blocks' AND round: word-parallel bitmap algebra.

    words: (P, 128) int32, each entry's posting window.
    w0:    (P,) int32, the window's first word in the bitmap geometry.
    act:   (P,) bool, live entries (the engine launches at exact length,
           so all True there; the reference's padding carries False).
    """
    surv = words
    if probe:
        surv = surv & accumulate.dense_window_gather(bm_old, qslot, w0)
    return accumulate.dense_window_add(new, surv, qslot, w0, act)


def round_commit(bm_old, new, active):
    """Active queries take their new segment, inactive rows keep the old."""
    return torch.where(active[:, None], new, bm_old)


def bitmap_round(bm, ids, qslot, ns, active, *, probe: bool = True):
    """One single-call AND round over the whole batch (the accumulate /
    commit split generalizes it); returns the new (Q, words) bitmap."""
    new = round_accumulate(torch.zeros_like(bm), ids, qslot, ns, bm,
                           probe=probe)
    return round_commit(bm, new, active)


def bitmap_round_masked(bm, ids, qslot, hits, active):
    """Like :func:`bitmap_round` with the probe already applied."""
    new = round_accumulate_masked(torch.zeros_like(bm), ids, qslot, hits)
    return round_commit(bm, new, active)


# --------------------------------------------------------------------------- #
# B1: segmented fused decode + probe (the fused placement)
# --------------------------------------------------------------------------- #


def segmented_decode_and(tiles, slots, qslots, firsts, ns, cand_tiles,
                         bw: int, crows: int):
    """Decode + probe a round's work-list against per-query bitmap segments.

    tiles:      (S * rows_per_block(bw), 128) int32 packed gap arena.
    slots:      (W,) int32 arena tile index per entry.
    qslots:     (W,) int32 owning query row per entry.
    firsts:     (W,) int32 (uint32 bits) first docid per entry.
    ns:         (W,) int32 posting count per entry (0 entries hit nothing).
    cand_tiles: (Q * crows, 128) int32, query q owning rows
                [q * crows, (q + 1) * crows).

    Returns (docids, hits), each (W * 4, 128) int32; entry j owns rows
    [4j, 4j + 4) in linear order.  CPU tensors take the plain version; CUDA
    tensors the kernel.
    """
    check_decode_args(tiles, slots, qslots, firsts, ns, cand_tiles, bw, crows)
    if not tiles.is_cuda:
        return segmented_decode_and_plain(tiles, slots, qslots, firsts, ns,
                                          cand_tiles, bw, crows)
    if slots.shape[0] == 0:
        empty = torch.empty((0, LANES), dtype=torch.int32, device=tiles.device)
        return empty, empty.clone()
    out = decode_and_launch(tiles, slots, qslots, firsts, ns, cand_tiles, bw,
                            crows)
    count_launch("B1", bw=bw, W=slots.shape[0],
                 tiles=tiles.shape[0] // rows_per_block(bw),
                 Q=cand_tiles.shape[0] // crows, crows=crows)
    return out


def segmented_decode_and_plain(tiles, slots, qslots, firsts, ns, cand_tiles,
                               bw: int, crows: int):
    """Plain torch version of :func:`segmented_decode_and` (any device)."""
    return decode_and_plain(tiles, slots, qslots, firsts, ns, cand_tiles, bw,
                            crows)


# --------------------------------------------------------------------------- #
# final extraction (the one host copy per batch)
# --------------------------------------------------------------------------- #


def extract_ids(bm_np: np.ndarray, n_docs: int) -> list:
    """Bitmap rows (uint32, on the host) -> sorted uint32 docid arrays
    (fresh, caller-owned).  Only nonzero words are expanded, so a row costs
    a scan of its words plus its set bits."""
    with get_tracer().span("kernel/extract_ids", lane="device",
                           rows=int(bm_np.shape[0]), n_docs=n_docs):
        out = []
        for row in np.ascontiguousarray(bm_np, np.uint32):
            nz = np.flatnonzero(row)
            bits = np.unpackbits(row[nz].view(np.uint8),
                                 bitorder="little").reshape(-1, 32)
            r, c = np.nonzero(bits)
            ids = nz[r].astype(np.int64) * 32 + c
            out.append(ids[ids < n_docs].astype(np.uint32))
        return out
