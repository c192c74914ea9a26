"""Kernels of the port: hand-written CUDA C++ for Hopper (``csrc/``), each
beside its plain torch version.

decode_fused (B5) and intersect_rounds (B1): fused unpack + prefix sum +
candidate-bitmap probe; accumulate (B2, B4): segmented scatter of survivor
bits and integer contributions, and the dense 4096-column window add;
topk (B3): score-column unpack, and the ranked rounds, thresholds and
candidate compact.  pfd_decode (PFD): Group-PFD's whole-list decode, the
frame-offset scan, unpack and exception patch in one launch (no B number:
the JAX package has no Pallas site for it).  The stream codec: bitpack
(B7a pack, B7b unpack), quadmax (B9 per-frame OR), scan_add (B8 prefix
sum), unpack_delta (B6 fused unpack + prefix sum), with ops the
stream-level entry points over them and ref their torch oracles;
intersect: host gallop/bitmap helpers and the bitmap tile AND (B10).
cuda_build: nvcc build and ctypes binding.

Launch accounting lives here, in one place: each wrapper calls
:func:`count_launch` where it launches its kernel, and nowhere else (a CPU
tensor's plain version counts nothing).  ``LAUNCHES`` holds the counts per
kernel; ``RECENT`` the shapes of the latest launches, bounded.
"""

from __future__ import annotations

import collections

LAUNCHES: dict[str, int] = dict.fromkeys(
    ("B1", "B2", "B2add", "B3", "B4", "B5", "B6", "B7a", "B7b", "B8", "B9",
     "B10", "PFD"), 0)
RECENT: collections.deque = collections.deque(maxlen=4096)


def count_launch(kernel: str, **shape) -> None:
    """Record one launch of ``kernel`` (a key of ``LAUNCHES``) with the
    sizes it was launched at."""
    LAUNCHES[kernel] += 1
    RECENT.append((kernel, shape))


def reset_launches() -> None:
    """Set every count to 0 and forget the recorded shapes."""
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    RECENT.clear()
