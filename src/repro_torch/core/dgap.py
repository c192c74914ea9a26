"""d-gap (delta) transform for sorted integer sequences.

Postings are docid-sorted; d-gap replaces d_i with d_i - d_{i-1} (first
element kept raw).  Decoding is an inclusive prefix sum: the host form and
the torch form, on int32 bit-pattern words (``core/bits.py``'s rules).
"""

from __future__ import annotations

import numpy as np
import torch

from .bits import cumsum_u32, i32


def dgap_encode_np(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.uint32)
    out = x.copy()
    out[1:] = x[1:] - x[:-1]
    return out


def dgap_decode_np(g: np.ndarray) -> np.ndarray:
    return np.cumsum(np.asarray(g, dtype=np.uint64)).astype(np.uint32)


def dgap_decode(g: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum mod 2**32 of int32 bit-pattern gaps (int64
    sums masked to 32 bits), as int32 bit patterns."""
    return i32(cumsum_u32(g))
