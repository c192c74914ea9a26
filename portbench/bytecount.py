"""The yardstick of the roofline shares: the bytes a call must move at
least, and the chip's peak.

Bytes are counted once, each input byte read and each output byte written,
from the sizes of the benchmark's own inputs, the same whatever implements
the call, so a share from these counts never passes 100 % unless the time
leaves out part of the work.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB (data sheet): HBM3 bandwidth at the full 700 W
# power limit; a run's result line gives the card's own limit beside it
HBM_BYTES_PER_S = 3.35e12


def decode_bytes(encoded_bytes: int, n: int) -> int:
    """A whole-list decode: the encoded bytes read once, 4 B a posting
    written."""
    return encoded_bytes + 4 * n


def seconds_at_peak(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S
