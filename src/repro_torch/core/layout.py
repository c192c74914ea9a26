"""k-way vertical layout + quad-max (paper §3.1, §4.2, §4.4).

The paper distributes each quadruple of consecutive integers across the four
32-bit components of a 128-bit vector; both helpers are pure index
transforms.  ``quadmax`` is the torch form of the pseudo quad-max, on int32
bit-pattern words.
"""

from __future__ import annotations

import numpy as np
import torch


def pad_to_multiple(x: np.ndarray, m: int, fill=0) -> np.ndarray:
    r = (-len(x)) % m
    if r == 0:
        return np.asarray(x)
    return np.concatenate([x, np.full(r, fill, dtype=np.asarray(x).dtype)])


def to_vertical_np(x: np.ndarray, k: int = 4) -> np.ndarray:
    """n ints -> (n/k, k): integer i lands at [i // k, i % k]."""
    x = pad_to_multiple(np.asarray(x, dtype=np.uint32), k)
    return x.reshape(-1, k)


def from_vertical_np(v: np.ndarray, n: int) -> np.ndarray:
    return np.asarray(v, dtype=np.uint32).reshape(-1)[:n]


def quadmax_np(x: np.ndarray, k: int = 4, pseudo: bool = True) -> np.ndarray:
    """Quad-max array (paper §4.2); pseudo=True uses the OR trick (§4.4),
    which has the same effective bit width as the true max."""
    v = to_vertical_np(x, k)
    if pseudo:
        out = v[:, 0]
        for c in range(1, k):
            out = out | v[:, c]
        return out
    return v.max(axis=1)


def quadmax(x: torch.Tensor, k: int = 4) -> torch.Tensor:
    """Pseudo quad-max (the OR of each ``k`` consecutive words) of int32
    bit-pattern words whose length is a multiple of ``k``."""
    v = x.reshape(-1, k)
    out = v[:, 0]
    for c in range(1, k):
        out = out | v[:, c]
    return out
