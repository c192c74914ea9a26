"""The port's ``kernels/intersect.py`` against the JAX package's, bitwise:
the bitmap tile AND (kernel B10; the port's wrapper runs its plain version
on the CPU, the reference its Pallas kernel in interpret mode), the
``use_pallas`` route of ``bitmap_and_words`` / ``bitmap_intersect_np``,
the host helpers, each also against ``np.intersect1d``, and the torch probe
``gallop_contains`` against ``gallop_contains_jnp``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import intersect as ref_ix
from repro_torch.kernels import intersect

from _torch_parity import assert_u32_equal, t32


def _sorted_unique(rng, n: int, lo: int, hi: int) -> np.ndarray:
    return np.sort(rng.choice(np.arange(lo, hi), size=n,
                              replace=False)).astype(np.uint32)


def _pairs() -> dict:
    rng = np.random.default_rng(5)
    return {
        "dense": (_sorted_unique(rng, 3000, 0, 9000),
                  _sorted_unique(rng, 2500, 100, 9100)),
        "skewed": (_sorted_unique(rng, 40, 0, 50_000),
                   _sorted_unique(rng, 20_000, 0, 50_000)),
        "disjoint": (np.arange(0, 100, dtype=np.uint32),
                     np.arange(200, 300, dtype=np.uint32)),
        "one_each": (np.array([77], np.uint32), np.array([77], np.uint32)),
        "empty": (np.zeros(0, np.uint32), np.arange(5, dtype=np.uint32)),
        "top": (np.array([5, (1 << 32) - 2, (1 << 32) - 1], np.uint32),
                np.array([(1 << 32) - 1], np.uint32)),
    }


@pytest.mark.parametrize("case", sorted(_pairs()))
def test_bitmap_intersect_matches_reference(case):
    a, b = _pairs()[case]
    want = np.intersect1d(a, b).astype(np.uint32)
    ref = ref_ix.bitmap_intersect_np(a, b, use_pallas=True)
    assert_u32_equal(ref, want, "reference")
    assert_u32_equal(intersect.bitmap_intersect_np(a, b, use_pallas=True,
                                                   torch_device="cpu"),
                     want, "use_pallas")
    assert_u32_equal(intersect.bitmap_intersect_np(a, b), want, "host")
    assert_u32_equal(intersect.intersect_sorted(a, b),
                     ref_ix.intersect_sorted(a, b), "intersect_sorted")
    assert_u32_equal(intersect.gallop_intersect_np(a, b), want, "gallop")


@pytest.mark.parametrize("n", (1, 128, 300))
def test_bitmap_and_words_matches_reference(n):
    rng = np.random.default_rng(n)
    wa, wb = (rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
              for _ in range(2))
    want = ref_ix.bitmap_and_words(wa, wb, use_pallas=True)
    got = intersect.bitmap_and_words(wa, wb, use_pallas=True,
                                     torch_device="cpu")
    assert got.dtype == np.uint32
    assert_u32_equal(got, want, "use_pallas")
    assert_u32_equal(intersect.bitmap_and_words(wa, wb), want, "host")


def test_bitmap_and_tiles_matches_reference():
    rng = np.random.default_rng(9)
    a, b = (rng.integers(0, 1 << 32, (9, 128), dtype=np.uint64)
            .astype(np.uint32) for _ in range(2))
    want = ref_ix.bitmap_and_tiles(jnp.asarray(a), jnp.asarray(b),
                                   interpret=True)
    assert_u32_equal(intersect.bitmap_and_tiles(t32(a), t32(b)), want, "B10")
    with pytest.raises(ValueError, match="differ"):
        intersect.bitmap_and_tiles(t32(a), t32(b[:8]))


@pytest.mark.parametrize("n_hay,n_needles", [(500, 200), (0, 50), (50, 0),
                                              (0, 0), (1, 64)])
def test_gallop_contains_matches_reference(n_hay, n_needles):
    """Port of ``tests/test_query_engine.py``'s ``gallop_contains_jnp``
    case, with empty haystacks and needles and words past 2**31."""
    rng = np.random.default_rng(0)
    hay = _sorted_unique(rng, n_hay, 0, 3000)
    needles = _sorted_unique(rng, n_needles, 0, 3000)
    if n_hay:
        hay[-1:] = np.uint32(0xFFFFFFF0)          # an unsigned word
    if n_needles:
        needles[-1:] = np.uint32(0xFFFFFFF0)
    want = ref_ix.gallop_contains_jnp(jnp.asarray(hay), jnp.asarray(needles))
    got = intersect.gallop_contains(t32(hay), t32(needles))
    assert got.dtype == torch.bool and got.shape == (n_needles,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(),
                                  intersect.gallop_contains_np(hay, needles))
