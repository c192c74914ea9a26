"""d-gap (delta) transform for sorted integer sequences (host side).

Postings are docid-sorted; d-gap replaces d_i with d_i - d_{i-1} (first
element kept raw).  Decoding is an inclusive prefix sum.
"""

from __future__ import annotations

import numpy as np


def dgap_encode_np(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.uint32)
    out = x.copy()
    out[1:] = x[1:] - x[:-1]
    return out


def dgap_decode_np(g: np.ndarray) -> np.ndarray:
    return np.cumsum(np.asarray(g, dtype=np.uint64)).astype(np.uint32)
