"""The port's stream codec layer against the JAX package's, bitwise: the
frame kernels B7a, B7b, B9, B8 and B6 (the port's wrappers run their plain
torch versions on the CPU; the reference runs its Pallas kernels in
interpret mode, as ``tests/test_kernels.py`` runs them), the port's
``kernels/ref.py`` oracles against the reference's, and the stream entry
points of ``kernels/ops.py`` on streams with a ragged tail.  The kernels
themselves are held against their plain versions on the card by
``tests/test_torch_kernels.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import bitpack as ref_bitpack
from repro.kernels import ops as ref_ops
from repro.kernels import quadmax as ref_quadmax
from repro.kernels import ref as ref_ref
from repro.kernels import scan_add as ref_scan
from repro.kernels import unpack_delta as ref_ud
from repro_torch.core.bits import ebw_np
from repro_torch.kernels import (bitpack, intersect, ops, quadmax, ref,
                                 scan_add, unpack_delta)

from _torch_parity import assert_u32_equal, t32

BWS = (1, 5, 13, 17, 31, 32)


def _words(seed: int, rows: int, bits: int = 32) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << bits, (rows, 128),
                        dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("bw", BWS)
def test_pack_unpack_frames_match_reference(bw):
    """B7a on full-range words (wider than bw: the mask counts), B7b and B6
    on the packed words; 1-3 frames."""
    frames = 1 + bw % 3
    x = _words(bw, frames * 32)
    want = ref_bitpack.pack_frames(jnp.asarray(x), bw, interpret=True,
                                   frames_per_block=1)
    assert_u32_equal(want, ref_ref.pack_frames_ref(jnp.asarray(x), bw))
    assert_u32_equal(bitpack.pack_frames(t32(x), bw), want, f"B7a bw={bw}")
    assert_u32_equal(ref.pack_frames_ref(t32(x), bw), want, f"ref pack bw={bw}")
    p = np.asarray(want)
    want = ref_bitpack.unpack_frames(jnp.asarray(p), bw, interpret=True,
                                     frames_per_block=frames)
    assert_u32_equal(bitpack.unpack_frames(t32(p), bw), want, f"B7b bw={bw}")
    assert_u32_equal(ref.unpack_frames_ref(t32(p), bw), want,
                     f"ref unpack bw={bw}")
    assert_u32_equal(want, x & np.uint32(bitpack._mask(bw)), "round trip")
    want = ref_ud.unpack_delta_frames(jnp.asarray(p), bw, interpret=True,
                                      frames_per_block=1)
    assert_u32_equal(want, ref_ref.unpack_delta_ref(jnp.asarray(p), bw))
    assert_u32_equal(unpack_delta.unpack_delta_frames(t32(p), bw), want,
                     f"B6 bw={bw}")
    assert_u32_equal(ref.unpack_delta_ref(t32(p), bw), want,
                     f"ref unpack_delta bw={bw}")


@pytest.mark.parametrize("frames", (1, 2, 3))
def test_frame_or_matches_reference(frames):
    x = _words(40 + frames, frames * 32, bits=7 + 8 * frames)
    want = ref_quadmax.frame_or(jnp.asarray(x), interpret=True,
                                frames_per_block=2)
    assert_u32_equal(quadmax.frame_or(t32(x)), want, "B9")
    assert_u32_equal(ref.frame_or_ref(t32(x)), want, "ref frame_or")


@pytest.mark.parametrize("case", ("random", "wrap", "ragged"))
def test_prefix_sum_blocks_matches_reference(case):
    """B8 in row-major order: 64 rows of 20-bit words; 64 rows of 2**31
    and near-2**32 words, whose sum wraps past 2**32 many times; 37 rows
    (no multiple of the 32-row tile)."""
    if case == "wrap":
        x = np.full((64, 128), 1 << 31, np.uint32)
        x[::3] = _words(3, 64)[::3] | np.uint32(0xFFFF0000)
    else:
        x = _words(2, 64 if case == "random" else 37,
                   bits=20 if case == "random" else 32)
    want = ref_scan.prefix_sum_blocks(jnp.asarray(x), rows_per_block=16
                                      if case != "ragged" else 37,
                                      interpret=True)
    assert_u32_equal(want, ref_ref.prefix_sum_ref(jnp.asarray(x)))
    assert_u32_equal(scan_add.prefix_sum_blocks(t32(x)), want, f"B8 {case}")
    assert_u32_equal(ref.prefix_sum_ref(t32(x)), want, f"ref prefix {case}")
    if case == "wrap":
        total = int(x.astype(np.uint64).sum())
        assert total > 1 << 32 and int(np.asarray(want)[-1, -1]) == total % (1 << 32)


@pytest.mark.parametrize("n", (1, 4097, 3 * 4096 - 5))
def test_ops_match_reference(n):
    """Every stream entry point on a stream with a ragged tail: select_bw,
    pack_stream at the stream's width, both decodes, prefix_sum."""
    rng = np.random.default_rng(n)
    gaps = rng.integers(0, 1 << 11, n, dtype=np.int64).astype(np.uint32)
    gaps[n // 2] = 1 << 18                     # one frame wider than the rest
    g = jnp.asarray(gaps)
    bws = ref_ops.select_bw(g)
    assert_u32_equal(ops.select_bw(t32(gaps)), bws, "select_bw")
    bw = int(np.asarray(bws).max())
    packed = ref_ops.pack_stream(g, bw)
    assert_u32_equal(ops.pack_stream(t32(gaps), bw), packed, "pack_stream")
    p = t32(np.asarray(packed))
    assert_u32_equal(ops.unpack_stream(p, bw, n),
                     ref_ops.unpack_stream(packed, bw, n), "unpack_stream")
    docids = ref_ops.unpack_delta_stream(packed, bw, n)
    assert_u32_equal(ops.unpack_delta_stream(p, bw, n), docids,
                     "unpack_delta_stream")
    assert_u32_equal(ops.prefix_sum(t32(gaps)), ref_ops.prefix_sum(g),
                     "prefix_sum")
    assert_u32_equal(docids, np.cumsum(gaps, dtype=np.uint64).astype(np.uint32))


def test_select_bw_exact_near_float_limits():
    """One frame per width around 2**24 (where float32 rounds) and 2**31,
    the top word, and an all-zero frame (clamped to 1)."""
    tops = [0, 1, (1 << 24) - 1, 1 << 24, (1 << 24) + 1, (1 << 25) - 1,
            (1 << 31) - 1, 1 << 31, (1 << 32) - 1]
    x = np.zeros(len(tops) * 4096 - 7, np.uint32)
    for f, top in enumerate(tops):
        x[f * 4096 + (f * 977) % 4089] = top
    want = np.maximum(ebw_np(np.asarray(tops, np.uint32)), 1)
    assert_u32_equal(want, ref_ops.select_bw(jnp.asarray(x)), "reference")
    got = ops.select_bw(t32(x))
    assert got.dtype == torch.int32
    assert_u32_equal(got, want, "select_bw")
    np.testing.assert_array_equal(
        ops.bit_length(t32(np.asarray(tops, np.uint32))).numpy(),
        [0, 1, 24, 25, 25, 25, 31, 32, 32])


def test_pad_to_frames_matches_reference():
    for n in (0, 5, 4096, 4100):
        x = np.arange(n, dtype=np.uint32) * np.uint32(2654435761)
        assert_u32_equal(ops.pad_to_frames(t32(x)),
                         ref_ops.pad_to_frames(jnp.asarray(x)), f"n={n}")
    # a wider dtype is taken as values in [0, 2**32)
    assert_u32_equal(ops.pad_to_frames(torch.tensor([3, (1 << 32) - 1])),
                     ref_ops.pad_to_frames(jnp.asarray(
                         np.array([3, (1 << 32) - 1], np.uint32))))


def test_stream_wrappers_refuse_bad_arguments():
    x = torch.zeros((32, 128), dtype=torch.int32)
    for bw in (0, 33, 2.5):
        with pytest.raises(ValueError, match="bit width"):
            bitpack.pack_frames(x, bw)
    with pytest.raises(ValueError, match=r"\(k \* 32, 128\)"):
        bitpack.pack_frames(x[:16], 4)
    with pytest.raises(ValueError, match=r"\(k \* 5, 128\)"):
        unpack_delta.unpack_delta_frames(torch.zeros((7, 128),
                                                     dtype=torch.int32), 5)
    with pytest.raises(TypeError, match="int32"):
        quadmax.frame_or(x.long())
    with pytest.raises(ValueError, match="contiguous"):
        scan_add.prefix_sum_blocks(torch.zeros((128, 4), dtype=torch.int32).t())


def test_uint4_kernels_refuse_misaligned_tiles():
    """B8 and B10 load and store uint4: the check their wrappers make on a
    CUDA tensor refuses a view 4 bytes into its storage, and takes the
    tiles ``pad_to_frames`` hands B8, which it copies onto a 16-byte
    boundary when the stream it is given is such a view."""
    rows = 3
    flat = torch.arange(rows * 128 + 4, dtype=torch.int32)
    view = flat[1:1 + rows * 128].view(rows, 128)
    assert view.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte boundary"):
        bitpack.check_aligned(view, "x")
    bitpack.check_aligned(flat[4:].view(rows, 128), "x")
    tiles = ops.pad_to_frames(torch.arange(4096 + 1, dtype=torch.int32)[1:])
    assert tiles.data_ptr() % 16 == 0
    assert_u32_equal(tiles.reshape(-1), np.arange(1, 4097, dtype=np.uint32))
    assert_u32_equal(scan_add.prefix_sum_blocks(view),
                     np.cumsum(np.arange(1, rows * 128 + 1)).astype(np.uint32)
                     .reshape(rows, 128), "B8 plain on a view")
    assert_u32_equal(intersect.bitmap_and_tiles(view, view), view, "B10 plain")
