"""Segmented device-resident top-k: quantized score accumulation and the
threshold-and-compact candidate selection of the ranked modes (``or`` /
``and_scored``).

Counterpart of the JAX package's ``kernels/topk.py``.  The state mirrors the
segmented candidate bitmaps of ``intersect_rounds``:

  * **score accumulator**: one (Q, accum_width(n_docs)) int32 tensor; query
    q owns row q and sums the u8 impact codes of its terms, one term
    occurrence per round, by an exact integer scatter-add (kernel B2's add
    form, or B4 for dense-bitmap blocks).  Sums of u8 codes stay far below
    2**31, so the int32 bit patterns compare as the reference's uint32.
  * **membership bitmap**: (Q, words) int32, a bit per doc that contributed
    anything (a code can floor to 0 while the float impact is > 0).
  * ``score_round`` / ``score_round_masked`` / ``dense_score_round``: one
    round's scatter; entries whose upper bound ``ub`` cannot beat the
    promoted theta (``ub <= (theta * iq) >> 16``) scatter nothing.
  * ``topk_threshold`` (a 16-step binary descend over rank counts, exact for
    sums below 2**16, saturating above, which only widens the superset),
    ``pooled_threshold`` (the same over the 32-group max pool: a sound
    per-round lower bound for theta promotion) and ``candidate_bitmap``
    (every member doc with ``acc >= theta - margin``, packed: the batch's
    one host copy).  These are whole-accumulator passes in plain torch; they
    run in row chunks of at most :data:`CHUNK_ELEMS` elements, so no
    intermediate grows past about 1 GB (at GOV2's 25.2 M docs one query row
    is 25.2 M words).  Chunking over rows changes no result.
  * :func:`unpack_codes`: kernel B3 of the port (``csrc/topk.cu``), the
    score side of the fused placement, replacing the Pallas kernel of the
    same name (body ``_unpack_kernel``).  Each work-list entry's (1, 128)
    packed score words become (4, 128) u8 codes, row r from byte r.  What
    bounds it on the H100 is bytes: 512 B read per distinct slot and 2 KB
    written per entry.

Every word tensor holds uint32 bit patterns as int32 (``core/bits.py``).  A
kernel wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.bits import U32_MASK, i32, u32, word_index
from ..obs.trace import get_tracer
from . import accumulate, count_launch, cuda_build
from .bitpack import LANES
from .decode_fused import BLOCK_ROWS
from .intersect_rounds import bitmap_geometry

THRESH_BITS = 16        # binary-descend range: exact for sums < 2**16

# elements per row chunk of the whole-accumulator passes (1 GB of int32)
CHUNK_ELEMS = 1 << 28

_UNPACK_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [
    ctypes.c_void_p]


def accum_width(n_docs: int) -> int:
    """Accumulator row width: [0, n_docs) padded to the bitmap geometry of
    ``intersect_rounds`` (whole words, whole 128-lane tiles), so the
    compacted candidate bitmap packs without a remainder."""
    return bitmap_geometry(n_docs)[0] * 32


def _scale_q16(theta, iq):
    """floor(theta * iq / 2**16) per query as int32, the reference's uint32
    arithmetic done in int64 and masked to 32 bits.  ``iq`` is a Q16.16
    scale in [1, 2**16] (65536 = identity)."""
    t, s = u32(theta), u32(iq)
    return i32((t >> 16) * s + (((t & 0xFFFF) * s) >> 16) & U32_MASK)


def _row_chunks(q: int, width: int) -> list:
    """Row slices of a (q, width) pass, each of at most CHUNK_ELEMS
    elements (one row at least)."""
    step = max(1, CHUNK_ELEMS // max(width, 1))
    return [slice(s, min(s + step, q)) for s in range(0, q, step)]


def _scatter(acc, member, ids, qslot, codes, surv):
    """Exact scatter, in place: per round a (query, term occurrence)
    contributes every docid at most once, so the integer add is a plain sum
    and the bit add an exact OR."""
    accumulate.scatter_add_masked(acc, ids, qslot, codes, surv)
    accumulate.scatter_bits(member, ids, qslot, surv)
    return acc, member


def score_round(acc, member, ids, qslot, codes, ns, gate, ub, theta, iq, *,
                gated: bool):
    """One ranked round over the whole batch, in place; returns (acc,
    member).

    acc: (Q, width) int32; member, gate: (Q, words) int32; ids, codes:
    (P, L) int32 docid rows and their codes; qslot, ns: (P,) int32 owning
    query row and valid posting count; ub: (P,) int32 quantized upper bound
    of each entry (an entry whose ub cannot beat the scaled theta is
    skipped); theta, iq: (Q,) int32.  ``gated`` probes ``gate`` (the AND
    bitmap of ``and_scored``) so only its docs accumulate.
    """
    q = qslot.long()
    ns = torch.where(ub > _scale_q16(theta, iq)[q], ns, 0)
    lane = torch.arange(ids.shape[1], device=ids.device)
    surv = lane[None, :] < ns.long()[:, None]
    if gated:
        word = gate[q[:, None], word_index(ids, gate.shape[1])]
        surv = surv & (((u32(word) >> (u32(ids) & 31)) & 1) == 1)
    return _scatter(acc, member, ids, qslot, codes, surv)


def score_round_masked(acc, member, ids, qslot, codes, hits, ub, theta, iq):
    """:func:`score_round` with the probe already applied: ``hits`` is the
    per-lane survivor mask of the fused decode (kernel B1)."""
    keep = ub > _scale_q16(theta, iq)[qslot.long()]
    return _scatter(acc, member, ids, qslot, codes,
                    (hits != 0) & keep[:, None])


def _kth_descend(vals, k: int):
    """Largest t with |{v : v >= t}| >= k per row, by THRESH_BITS halving
    steps (int32).  That t is the k-th largest value when it fits the bit
    range; with fewer than k values >= 1 it stays 0 (keep everything)."""
    lo = torch.zeros(vals.shape[0], dtype=torch.int32, device=vals.device)
    for rows in _row_chunks(*vals.shape):
        a, cur = vals[rows], lo[rows]
        for b in range(THRESH_BITS - 1, -1, -1):
            mid = cur + (1 << b)
            cnt = (a >= mid[:, None]).sum(dim=1)
            cur = torch.where(cnt >= k, mid, cur)
        lo[rows] = cur
    return lo


def topk_threshold(acc, k: int):
    """Per-query threshold theta (int32): the k-th largest accumulated code
    sum.  Span ``kernel/topk``."""
    tracer = get_tracer()
    with tracer.span("kernel/topk", lane="device", k=k, nq=int(acc.shape[0])):
        theta = _kth_descend(acc, k)
        tracer.fence(theta)
        return theta


def topk_stats(acc, k: int):
    """Per-query (theta, count) merge statistics for doc-range sharded
    top-k: theta with the raw k (a shard with fewer than k scored docs
    reports 0), and the candidate count at ``max(theta, 1)``.  Span
    ``kernel/topk``, fenced as :func:`topk_threshold`'s."""
    tracer = get_tracer()
    with tracer.span("kernel/topk", lane="device", k=k,
                     nq=int(acc.shape[0]), stats=True):
        theta = _kth_descend(acc, k)
        floor = torch.clamp(theta, min=1)
        count = torch.empty_like(theta)
        for rows in _row_chunks(*acc.shape):
            count[rows] = (acc[rows] >= floor[rows, None]).sum(dim=1)
        tracer.fence(theta, count)
        return theta, count


def pooled_threshold(acc, k: int):
    """Sound per-round lower bound on the k-th largest sum: the k-th largest
    of the 32-group maxima (k distinct groups are k distinct entries)."""
    q, width = acc.shape
    pooled = torch.empty((q, width // 32), dtype=torch.int32,
                         device=acc.device)
    for rows in _row_chunks(q, width):
        pooled[rows] = acc[rows].reshape(-1, width // 32, 32).amax(dim=-1)
    return _kth_descend(pooled, k)


def candidate_bitmap(acc, member, theta, margin, iq):
    """Compact the accumulator against ``(theta * iq >> 16) - margin`` into
    a packed (Q, words) candidate bitmap, ANDed with ``member``: every member
    doc whose quantized sum could still reach the true top-k."""
    thr = i32(_scale_q16(theta, iq).long() - margin.long())
    q, width = acc.shape
    weight = torch.bitwise_left_shift(
        torch.ones(8, dtype=torch.uint8, device=acc.device),
        torch.arange(8, dtype=torch.uint8, device=acc.device))
    out = torch.empty_like(member)
    for rows in _row_chunks(q, width):
        keep = (acc[rows] >= thr[rows, None]).view(torch.uint8)
        # 8 docs -> one byte, LSB first; four bytes -> one little-endian word
        packed = (keep.reshape(-1, width // 8, 8) * weight).sum(
            dim=-1, dtype=torch.uint8)
        out[rows] = packed.view(torch.int32)
    return out & member


# --------------------------------------------------------------------------- #
# dense-bitmap score round (density-adaptive posting blocks)
# --------------------------------------------------------------------------- #


def dense_score_round(acc, member, tiles, words, qslot, w0, ub, theta, iq,
                      gate, *, gated: bool):
    """One ranked round over the batch's dense-bitmap entries, in place;
    returns (acc, member).

    tiles: (P, 1024) int32 packed code windows (position p at byte p & 3 of
    word p >> 2; positions without a posting carry 0); words: (P, 128)
    int32 posting bitmap windows; w0: (P,) int32 first word of each window
    (4-word aligned, so column ``w0 * 32`` is 128-aligned).  Codes add as
    one 4096-column window each (kernel B4); membership and the gate stay
    word-parallel.  The codes go to B4 packed, in one call: no (P, 4096)
    array of unpacked codes is made on the card.
    """
    act = ub > _scale_q16(theta, iq)[qslot.long()]
    win = words
    if gated:
        win = win & accumulate.dense_window_gather(gate, qslot, w0)
    accumulate.dense_add_packed(acc, tiles, win, qslot, w0 * 32, act,
                                gated=gated)
    accumulate.dense_window_or(member, win, qslot, w0, act)
    return acc, member


# --------------------------------------------------------------------------- #
# B3: score-column unpack (the fused placement's score side)
# --------------------------------------------------------------------------- #


def _check_unpack(tiles, slots) -> None:
    for name, t in (("tiles", tiles), ("slots", slots)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.device != tiles.device:
            raise ValueError(f"{name} on {t.device}, tiles on {tiles.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tiles.dim() != 2 or tiles.shape[1] != LANES or slots.dim() != 1:
        raise ValueError(f"tiles must be (S, {LANES}) and slots (W,); got "
                         f"{tuple(tiles.shape)}, {tuple(slots.shape)}")


def unpack_codes(tiles, slots):
    """Unpack a work-list of packed score rows in one call.

    tiles: (S, 128) int32 score arena (four u8 codes per word); slots: (W,)
    int32 arena row per entry.  Returns (W * 4, 128) int32 codes; entry j
    owns rows [4j, 4j + 4), in the linear order of the docid rows kernel B1
    writes for it.  CPU tensors take the plain version; CUDA tensors the
    kernel.
    """
    _check_unpack(tiles, slots)
    if not tiles.is_cuda:
        return unpack_codes_plain(tiles, slots)
    w = slots.shape[0]
    out = torch.empty((w * BLOCK_ROWS, LANES), dtype=torch.int32,
                      device=tiles.device)
    if w:
        fn = cuda_build.function("topk", "repro_unpack_codes", _UNPACK_ARGS)
        with torch.cuda.device(tiles.device):
            err = fn(tiles.data_ptr(), slots.data_ptr(), out.data_ptr(), w,
                     tiles.shape[0], cuda_build.stream_ptr(tiles))
        cuda_build.check(err, "topk", f"repro_unpack_codes(W={w})")
        count_launch("B3", W=w, tiles=tiles.shape[0])
    return out


def unpack_codes_plain(tiles, slots):
    """Plain torch version of :func:`unpack_codes` (any device)."""
    w = tiles[slots.long()]
    shifts = 8 * torch.arange(BLOCK_ROWS, dtype=torch.int32,
                              device=tiles.device)
    return ((w[:, None, :] >> shifts[None, :, None]) & 0xFF).reshape(-1, LANES)
