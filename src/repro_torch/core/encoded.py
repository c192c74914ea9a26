"""Uniform container for a compressed integer sequence.

Every codec encodes to an ``Encoded`` and decodes from one.  Sizes are tracked
in *bits actually used* so compression-ratio accounting is exact even when the
backing numpy arrays are word-padded.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np


@dataclasses.dataclass
class Encoded:
    codec: str
    n: int                                  # number of source integers
    control: np.ndarray                     # control area (uint8 or uint32 words)
    data: np.ndarray                        # data area (uint32 words)
    control_bits: int = 0                   # bits used in the control area
    data_bits: int = 0                      # bits used in the data area
    exceptions: Optional[np.ndarray] = None # exception area (uint32 words), PFD only
    exception_bits: int = 0
    header_bits: int = 0                    # per-stream fixed header cost
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def total_bits(self) -> int:
        return self.control_bits + self.data_bits + self.exception_bits + self.header_bits

    @property
    def bits_per_int(self) -> float:
        return self.total_bits / max(self.n, 1)

    def nbytes(self) -> int:
        return (self.total_bits + 7) // 8
