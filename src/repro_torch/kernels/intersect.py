"""Vectorized sorted-set intersection for the host query path (numpy).

Two strategies (Lemire/Boytsov/Kurz, "SIMD Compression and the Intersection
of Sorted Integers"): galloping ``searchsorted`` probes when one list is much
shorter, and a packed-bitmap AND when both are dense over a shared range.
``intersect_sorted`` dispatches between them and is what the engine's host
placement calls per posting block.

Counterpart of the JAX package's ``kernels/intersect.py``.  Its Pallas tile
AND is kernel B10 of the port, :func:`bitmap_and_tiles`
(``csrc/intersect.cu``, replacing ``bitmap_and_tiles``, body
``_and_kernel``): one uint4 (4 words) of each input per thread, bound on
the H100 by bytes (two words read and one written per word); the tensors
must start on a 16-byte boundary.  Only ``use_pallas=True`` callers of
:func:`bitmap_and_words` / :func:`bitmap_intersect_np` reach it, as in the
reference (the keyword keeps its name for the same API); they run it on
``torch_device``, the card by default.  Without the keyword the AND is the
host ``&``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.bits import from_np, to_np
from . import count_launch, cuda_build
from .bitpack import LANES, check_aligned, check_tiles

# bitmap intersection pays off when the shorter list covers at least this
# fraction of the candidate docid span (one uint32 word per 32 docids)
BITMAP_DENSITY = 1.0 / 16.0

_AND_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p]


def gallop_contains_np(haystack: np.ndarray, needles: np.ndarray) -> np.ndarray:
    """Boolean mask over ``needles``: which appear in sorted ``haystack``."""
    if len(haystack) == 0 or len(needles) == 0:
        return np.zeros(len(needles), bool)
    pos = np.searchsorted(haystack, needles)
    hit = pos < len(haystack)
    safe = np.minimum(pos, len(haystack) - 1)
    return hit & (haystack[safe] == needles)


def gallop_intersect_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Intersection of two sorted unique uint32 arrays; probes the shorter."""
    if len(a) > len(b):
        a, b = b, a
    return a[gallop_contains_np(b, a)]


def bitmap_build_np(ids: np.ndarray, lo: int, hi: int) -> np.ndarray:
    """Pack sorted docids in [lo, hi) into a uint32 bitmap (LSB-first)."""
    span = hi - lo
    nw = (span + 31) // 32
    words = np.zeros(nw, np.uint32)
    rel = ids.astype(np.int64) - lo
    np.bitwise_or.at(words, rel >> 5, (np.uint32(1) << (rel & 31).astype(np.uint32)))
    return words


def bitmap_extract_np(words: np.ndarray, lo: int) -> np.ndarray:
    """Inverse of ``bitmap_build_np``: set bit positions + lo, ascending."""
    bits = np.unpackbits(words.view(np.uint8), bitorder="little")
    return (np.flatnonzero(bits) + lo).astype(np.uint32)


def bitmap_and_tiles(a, b):
    """(R, 128) int32 bitmap tiles -> their elementwise AND.  CPU tensors
    take the plain version; CUDA tensors kernel B10."""
    rows = check_tiles(a, "a")
    check_tiles(b, "b")
    if a.shape != b.shape or a.device != b.device:
        raise ValueError(f"a {tuple(a.shape)} on {a.device} and b "
                         f"{tuple(b.shape)} on {b.device} differ")
    if not a.is_cuda:
        return bitmap_and_tiles_plain(a, b)
    check_aligned(a, "a")
    check_aligned(b, "b")
    out = torch.empty_like(a)
    if rows:
        fn = cuda_build.function("intersect", "repro_bitmap_and", _AND_ARGS)
        with torch.cuda.device(a.device):
            err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                     rows * LANES, cuda_build.stream_ptr(a))
        cuda_build.check(err, "intersect", f"repro_bitmap_and(rows={rows})")
        count_launch("B10", rows=rows)
    return out


def bitmap_and_tiles_plain(a, b):
    """Plain torch version of :func:`bitmap_and_tiles`."""
    return a & b


def bitmap_and_words(wa: np.ndarray, wb: np.ndarray, use_pallas: bool = False,
                     torch_device="cuda") -> np.ndarray:
    """AND two equal-length uint32 bitmap word streams.

    ``use_pallas`` routes through the tile kernel B10 on ``torch_device``
    (padding to whole (rows, 128) tiles); the default is the host AND.
    """
    if not use_pallas:
        return wa & wb
    n = len(wa)
    rows = max(1, -(-n // LANES))
    pad = rows * LANES - n
    ta, tb = (from_np(np.concatenate([w, np.zeros(pad, np.uint32)])
                      .reshape(rows, LANES), torch_device) for w in (wa, wb))
    return to_np(bitmap_and_tiles(ta, tb)).reshape(-1)[:n]


def bitmap_intersect_np(a: np.ndarray, b: np.ndarray, use_pallas: bool = False,
                        torch_device="cuda") -> np.ndarray:
    """Intersect two sorted unique arrays via packed-bitmap AND
    (``use_pallas``: on kernel B10, see :func:`bitmap_and_words`)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros(0, np.uint32)
    lo = int(max(a[0], b[0]))
    hi = int(min(a[-1], b[-1])) + 1
    if lo >= hi:
        return np.zeros(0, np.uint32)
    a = a[np.searchsorted(a, lo):np.searchsorted(a, hi)]
    b = b[np.searchsorted(b, lo):np.searchsorted(b, hi)]
    if len(a) == 0 or len(b) == 0:
        return np.zeros(0, np.uint32)
    wa = bitmap_build_np(a, lo, hi)
    wb = bitmap_build_np(b, lo, hi)
    return bitmap_extract_np(bitmap_and_words(wa, wb, use_pallas,
                                              torch_device), lo)


def intersect_sorted(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Intersect sorted unique uint32 arrays, choosing gallop vs bitmap."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros(0, np.uint32)
    if len(a) > len(b):
        a, b = b, a
    lo = int(max(a[0], b[0]))
    hi = int(min(a[-1], b[-1])) + 1
    span = max(hi - lo, 1)
    if lo < hi and len(a) >= span * BITMAP_DENSITY and len(a) >= 64:
        return bitmap_intersect_np(a, b)
    return a[gallop_contains_np(b, a)]
