"""Fused block decode + candidate bitmap-AND: kernel B5, and the shared body
of B1 (``intersect_rounds.segmented_decode_and``).

Replaces the JAX package's Pallas kernel ``kernels/decode_fused.py``
``fused_decode_and`` (body ``_fused_kernel``).  The CUDA source is
``csrc/decode_and.cu``; one warp per work-list entry (four entries a
block) unpacks the entry's packed gap tile, a uint4 of four lanes a thread,
prefix-sums the gaps into docids and probes each docid in the candidate
bitmap, every probe load sent before any store.  What bounds it on the
H100 is bytes moved, and the latency of the loads an entry waits on: the
tile rows it reads, the 32-byte sectors its probes touch and the 4 KB of
docids and hits it writes per entry.  The tiles must start on a 16-byte
boundary on the card.

Layout: a block of up to 512 postings is one (rows_per_block(bw), 128)
uint32 tile.  Value ``i`` of the block lives at row ``i // 128``, lane
``i % 128``, packed LSB-first at the block's bit width rounded up to
:data:`BW_BUCKETS`.  The candidate bitmap covers docids [0, R * 4096) as
(R, 128) words, LSB-first (``intersect.bitmap_build_np`` order).

Every word tensor holds uint32 bit patterns as int32 (``core/bits.py``).  A
wrapper given CPU tensors runs the plain torch version; given CUDA tensors it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.bits import U32_MASK, i32, u32, word_index
from . import count_launch, cuda_build
from .bitpack import LANES, _mask, check_aligned

BLOCK_ROWS = 4                       # 512 postings = 4 rows x 128 lanes

# per-block bit widths round up to one of these buckets, so a single outlier
# gap widens only its own bucket (and the kernel has one instance per bucket)
BW_BUCKETS = (4, 8, 12, 16, 24, 32)


def rows_per_block(bw: int) -> int:
    """Packed tile rows for one 512-posting block at bit width ``bw``."""
    return -(-BLOCK_ROWS * bw // 32)


def pack_gaps(gaps: np.ndarray, bw: int) -> np.ndarray:
    """Pack one block's d-gaps (<= 512 values, each < 2**bw) into the
    (rows_per_block(bw), 128) uint32 tile: value ``i`` at row ``i // 128``,
    lane ``i % 128``, LSB-first at width ``bw``."""
    vals = np.zeros(BLOCK_ROWS * LANES, np.uint32)
    vals[: len(gaps)] = gaps
    vals = vals.reshape(BLOCK_ROWS, LANES).astype(np.uint64)
    tile = np.zeros((rows_per_block(bw), LANES), np.uint32)
    for r in range(BLOCK_ROWS):
        start = r * bw
        w, off = start // 32, start % 32
        tile[w] |= ((vals[r] << off) & 0xFFFFFFFF).astype(np.uint32)
        if off + bw > 32:
            tile[w + 1] |= (vals[r] >> (32 - off)).astype(np.uint32)
    return tile


# --------------------------------------------------------------------------- #
# the shared decode + probe (plain torch and kernel launch)
# --------------------------------------------------------------------------- #


def check_decode_args(tiles, slots, qslots, firsts, ns, cand, bw: int,
                      crows: int) -> None:
    """Validate what the kernel takes: devices, dtypes, shapes, contiguity."""
    if bw not in BW_BUCKETS:
        raise ValueError(f"bw={bw} not in BW_BUCKETS {BW_BUCKETS}")
    rpb = rows_per_block(bw)
    w = slots.shape[0]
    named = {"tiles": tiles, "slots": slots, "firsts": firsts, "ns": ns,
             "cand": cand}
    if qslots is not None:
        named["qslots"] = qslots
    for name, t in named.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32 (uint32 bit patterns), "
                            f"got {t.dtype}")
        if t.device != tiles.device:
            raise ValueError(f"{name} on {t.device}, tiles on {tiles.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("slots", "qslots", "firsts", "ns"):
        t = named.get(name)
        if t is not None and tuple(t.shape) != (w,):
            raise ValueError(f"{name} must have shape ({w},), got {tuple(t.shape)}")
    if tiles.dim() != 2 or tiles.shape[1] != LANES or tiles.shape[0] % rpb:
        raise ValueError(f"tiles must be (S * {rpb}, {LANES}), got "
                         f"{tuple(tiles.shape)}")
    if (crows < 1 or cand.dim() != 2 or cand.shape[1] != LANES
            or cand.shape[0] % crows or cand.shape[0] == 0):
        raise ValueError(f"cand must be (Q * {crows}, {LANES}), got "
                         f"{tuple(cand.shape)}")


def decode_and_plain(tiles, slots, qslots, firsts, ns, cand, bw: int,
                     crows: int):
    """Plain torch version of the kernel: the reference's per-row unpack,
    prefix sum (mod 2**32) and clamped probe.  ``qslots=None`` probes query
    0 for every entry (B5).  Returns (ids, hits), each (W * 4, 128) int32."""
    w = slots.shape[0]
    dev = tiles.device
    rpb = rows_per_block(bw)
    m = _mask(bw)
    t = u32(tiles.reshape(-1, rpb, LANES)[slots.long()])      # (W, rpb, 128)
    rows = []
    for r in range(BLOCK_ROWS):
        start = r * bw
        wi, off = start // 32, start % 32
        v = t[:, wi] >> off
        if off + bw > 32:
            v = v | ((t[:, wi + 1] << (32 - off)) & U32_MASK)
        rows.append(v & m)
    v = torch.stack(rows, dim=1).reshape(w, BLOCK_ROWS * LANES)
    d = (torch.cumsum(v, dim=1) + u32(firsts)[:, None]) & U32_MASK
    cw = crows * LANES
    q = (qslots.long() if qslots is not None
         else torch.zeros(w, dtype=torch.int64, device=dev))
    word = cand.reshape(-1)[q[:, None] * cw + word_index(d, cw)]
    hit = (u32(word) >> (d & 31)) & 1
    valid = (torch.arange(BLOCK_ROWS * LANES, device=dev)[None, :]
             < ns.long()[:, None])
    hits = torch.where(valid, hit, 0).to(torch.int32)
    return (i32(d).reshape(w * BLOCK_ROWS, LANES),
            hits.reshape(w * BLOCK_ROWS, LANES))


_DECODE_AND_ARGS = [ctypes.c_void_p] * 8 + [
    ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_longlong, ctypes.c_void_p]


def decode_and_launch(tiles, slots, qslots, firsts, ns, cand, bw: int,
                      crows: int):
    """Launch ``repro_decode_and`` (csrc/decode_and.cu) on CUDA tensors;
    returns (ids, hits) allocated here, or raises on a launch error."""
    check_aligned(tiles, "tiles")
    w = slots.shape[0]
    ids = torch.empty((w * BLOCK_ROWS, LANES), dtype=torch.int32,
                      device=tiles.device)
    hits = torch.empty_like(ids)
    fn = cuda_build.function("decode_and", "repro_decode_and",
                             _DECODE_AND_ARGS)
    with torch.cuda.device(tiles.device):
        err = fn(tiles.data_ptr(), slots.data_ptr(),
                 None if qslots is None else qslots.data_ptr(),
                 firsts.data_ptr(), ns.data_ptr(), cand.data_ptr(),
                 ids.data_ptr(), hits.data_ptr(), w, bw,
                 tiles.shape[0] // rows_per_block(bw),
                 cand.shape[0] // crows, crows * LANES,
                 cuda_build.stream_ptr(tiles))
    cuda_build.check(err, "decode_and", f"decode_and(bw={bw}, W={w})")
    return ids, hits


# --------------------------------------------------------------------------- #
# B5: one shared candidate bitmap
# --------------------------------------------------------------------------- #


def fused_decode_and(tiles, slots, firsts, ns, cand_rows, bw: int):
    """Decode + intersect a work-list of packed block tiles in one call.

    tiles:     (S * rows_per_block(bw), 128) int32: the packed gap arena.
    slots:     (W,) int32: arena tile index per work-list entry.
    firsts:    (W,) int32 (uint32 bits): first docid per entry.
    ns:        (W,) int32: posting count per entry (<= 512).
    cand_rows: (R, 128) int32: candidate bitmap over [0, R * 4096).

    Returns (docids, hits), each (W * 4, 128) int32; entry j owns rows
    [4j, 4j+4) and its intersection is ``docids[hits == 1]`` in linear
    order.  CPU tensors take the plain version; CUDA tensors the kernel.
    """
    check_decode_args(tiles, slots, None, firsts, ns, cand_rows, bw,
                      cand_rows.shape[0])
    if not tiles.is_cuda:
        return fused_decode_and_plain(tiles, slots, firsts, ns, cand_rows, bw)
    if slots.shape[0] == 0:
        empty = torch.empty((0, LANES), dtype=torch.int32, device=tiles.device)
        return empty, empty.clone()
    out = decode_and_launch(tiles, slots, None, firsts, ns, cand_rows, bw,
                            cand_rows.shape[0])
    count_launch("B5", bw=bw, W=slots.shape[0],
                 tiles=tiles.shape[0] // rows_per_block(bw),
                 R=cand_rows.shape[0])
    return out


def fused_decode_and_plain(tiles, slots, firsts, ns, cand_rows, bw: int):
    """Plain torch version of :func:`fused_decode_and` (any device)."""
    return decode_and_plain(tiles, slots, None, firsts, ns, cand_rows, bw,
                            cand_rows.shape[0])
