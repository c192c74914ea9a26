"""Vectorized sorted-set intersection for the host query path (numpy).

Two strategies (Lemire/Boytsov/Kurz, "SIMD Compression and the Intersection
of Sorted Integers"): galloping ``searchsorted`` probes when one list is much
shorter, and a packed-bitmap AND when both are dense over a shared range.
``intersect_sorted`` dispatches between them and is what the engine's host
placement calls per posting block.

Counterpart of the numpy helpers of the JAX package's ``kernels/intersect.py``;
its Pallas tile AND (``bitmap_and_tiles``, B10) is still to be ported, so the
AND here is the host ``&``.
"""

from __future__ import annotations

import numpy as np

# bitmap intersection pays off when the shorter list covers at least this
# fraction of the candidate docid span (one uint32 word per 32 docids)
BITMAP_DENSITY = 1.0 / 16.0


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


def bitmap_and_words(wa: np.ndarray, wb: np.ndarray) -> np.ndarray:
    """AND two equal-length uint32 bitmap word streams (host)."""
    return wa & wb


def bitmap_intersect_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Intersect two sorted unique arrays via packed-bitmap AND."""
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
    return bitmap_extract_np(bitmap_and_words(wa, wb), lo)


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
