"""Lane geometry shared by the fused kernels (counterpart of the constants of
the JAX package's ``kernels/bitpack.py``; its pack/unpack kernels B7a/B7b are
still to be ported, ``ROADMAP.md`` section B)."""

from __future__ import annotations

LANES = 128


def _mask(bw: int) -> int:
    """All-ones mask of ``bw`` bits (bw <= 32) as a Python int."""
    return 0xFFFFFFFF if bw >= 32 else (1 << bw) - 1
