"""Kernels B1, B5 and B2 of the port against the JAX package's functions on
the same inputs, bitwise.

On the CPU the port's wrappers run their plain torch versions; the reference
runs its Pallas kernels in interpret mode (B1, B5) and its XLA scatter (B2:
``accumulate.use_pallas()`` is False off the TPU, which is the reference's
CPU semantics).  The test marked ``cuda`` holds each CUDA kernel against its
plain version on the card and skips where there is none."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import accumulate as ref_acc
from repro.kernels import decode_fused as ref_df
from repro.kernels import intersect_rounds as ref_ir
from repro_torch import kernels
from repro_torch.kernels import accumulate, decode_fused, intersect_rounds

from _torch_parity import assert_u32_equal, cuda_device, t32  # noqa: F401

BW_BUCKETS = decode_fused.BW_BUCKETS
Q, CROWS = 3, 2                        # 3 queries x 256 words = 8192 docids


def _decode_inputs(bw: int, seed: int):
    """A work-list of 12 live entries + 4 entries that hit nothing (copies
    of entry 0 with n=0, as the reference pads to its buckets), over 6
    packed tiles.  Entry 1 starts near
    the end of the bitmap so its docids cross the ``cand_words - 1`` clamp."""
    rng = np.random.default_rng(seed)
    s, w = 6, 12
    tiles = np.concatenate([
        ref_df.pack_gaps(rng.integers(0, 1 << min(bw, 12), 512,
                                      dtype=np.int64).astype(np.uint32)
                         if bw < 32 else
                         rng.integers(0, 1 << 32, 512, dtype=np.int64)
                         .astype(np.uint32), bw)
        for _ in range(s)])
    slots = rng.integers(0, s, w).astype(np.int32)
    qslots = rng.integers(0, Q, w).astype(np.int32)
    firsts = rng.integers(0, 6000, w).astype(np.uint32)
    firsts[1] = CROWS * 128 * 32 - 40          # near the clamp edge
    ns = rng.integers(1, 513, w).astype(np.int32)
    ns[2] = 512
    pad = 4
    cols = [np.concatenate([c, np.repeat(c[:1], pad)])
            for c in (slots, qslots, firsts, ns)]
    cols[3][-pad:] = 0
    cand = rng.integers(0, 1 << 32, (Q * CROWS, 128),
                        dtype=np.int64).astype(np.uint32)
    return (tiles, *cols, cand)


def test_pack_gaps_matches_reference():
    rng = np.random.default_rng(0)
    for bw in BW_BUCKETS:
        g = rng.integers(0, 1 << min(bw, 31), 300, dtype=np.int64).astype(np.uint32)
        np.testing.assert_array_equal(decode_fused.pack_gaps(g, bw),
                                      ref_df.pack_gaps(g, bw))
        assert decode_fused.rows_per_block(bw) == ref_df.rows_per_block(bw)


@pytest.mark.parametrize("bw", BW_BUCKETS)
def test_segmented_decode_and_matches_reference(bw):
    tiles, slots, qslots, firsts, ns, cand = _decode_inputs(bw, seed=bw)
    want_ids, want_hits = ref_ir.segmented_decode_and(
        jnp.asarray(tiles), jnp.asarray(slots), jnp.asarray(qslots),
        jnp.asarray(firsts), jnp.asarray(ns), jnp.asarray(cand),
        bw=bw, crows=CROWS)
    ids, hits = intersect_rounds.segmented_decode_and(
        t32(tiles), t32(slots), t32(qslots), t32(firsts), t32(ns), t32(cand),
        bw=bw, crows=CROWS)
    assert_u32_equal(ids, want_ids, f"B1 ids bw={bw}")
    assert_u32_equal(hits, want_hits, f"B1 hits bw={bw}")
    # the clamp edge really was crossed, and some lanes hit
    assert (np.asarray(want_ids)[4:8] >> 5 >= CROWS * 128).any()
    assert np.asarray(want_hits).any()


@pytest.mark.parametrize("bw", BW_BUCKETS)
def test_fused_decode_and_matches_reference(bw):
    tiles, slots, _, firsts, ns, cand = _decode_inputs(bw, seed=100 + bw)
    rows = cand[:CROWS]
    want_ids, want_hits = ref_df.fused_decode_and(
        jnp.asarray(tiles), jnp.asarray(slots), jnp.asarray(firsts),
        jnp.asarray(ns), jnp.asarray(rows), bw=bw)
    ids, hits = decode_fused.fused_decode_and(
        t32(tiles), t32(slots), t32(firsts), t32(ns), t32(rows), bw=bw)
    assert_u32_equal(ids, want_ids, f"B5 ids bw={bw}")
    assert_u32_equal(hits, want_hits, f"B5 hits bw={bw}")


def test_decode_wrappers_refuse_bad_arguments():
    tiles, slots, qslots, firsts, ns, cand = _decode_inputs(8, seed=1)
    args = [t32(a) for a in (tiles, slots, qslots, firsts, ns, cand)]
    with pytest.raises(TypeError, match="int32"):
        intersect_rounds.segmented_decode_and(
            *args[:4], args[4].long(), args[5], bw=8, crows=CROWS)
    with pytest.raises(ValueError, match="BW_BUCKETS"):
        intersect_rounds.segmented_decode_and(*args, bw=5, crows=CROWS)
    with pytest.raises(ValueError, match="cand"):
        intersect_rounds.segmented_decode_and(*args, bw=8, crows=4)


def _scatter_inputs(seed: int, words: int = 64):
    """10 entries x 512 lanes over 4 queries; within a query the entries'
    docids are disjoint (the round contract), survivors random."""
    rng = np.random.default_rng(seed)
    ids, qs = [], []
    for q, k in enumerate((3, 3, 2, 2)):
        perm = rng.permutation(words * 32)[:k * 512].astype(np.uint32)
        ids.extend(np.sort(perm.reshape(k, 512), axis=1))
        qs.extend([q] * k)
    ids = np.stack(ids)
    return ids, np.asarray(qs, np.int32), rng.random(ids.shape) < 0.6


def test_scatter_bits_matches_reference():
    words = 64
    ids, qslot, surv = _scatter_inputs(0, words)
    old = np.random.default_rng(1).integers(
        0, 1 << 32, (4, words), dtype=np.int64).astype(np.uint32)
    want = np.asarray(ref_acc.scatter_bits(
        jnp.asarray(old), jnp.asarray(ids), jnp.asarray(qslot),
        jnp.asarray(surv)))
    got = accumulate.scatter_bits(torch.zeros((4, words), dtype=torch.int32),
                                  t32(ids), t32(qslot), torch.as_tensor(surv))
    assert_u32_equal(got, want, "B2 bits")
    # in place into a live bitmap: the reference's `old | scatter`
    bm = t32(old.copy())
    out = accumulate.scatter_bits(bm, t32(ids), t32(qslot),
                                  torch.as_tensor(surv))
    assert out is bm
    assert_u32_equal(bm, old | want, "B2 bits in place")


def test_scatter_add_matches_reference():
    rng = np.random.default_rng(2)
    width = 2048
    ids, qslot, _ = _scatter_inputs(3, width // 32)
    qslot = rng.integers(0, 4, len(qslot)).astype(np.int32)  # overlaps add up
    contrib = rng.integers(0, 1 << 32, ids.shape, dtype=np.int64).astype(np.uint32)
    contrib[rng.random(ids.shape) < 0.3] = 0
    acc = rng.integers(0, 1 << 32, (4, width), dtype=np.int64).astype(np.uint32)
    want = np.asarray(ref_acc.scatter_add(
        jnp.asarray(acc), jnp.asarray(ids), jnp.asarray(qslot),
        jnp.asarray(contrib)))
    got = accumulate.scatter_add(t32(acc.copy()), t32(ids), t32(qslot),
                                 t32(contrib))
    assert_u32_equal(got, want, "B2 add")


def test_dense_window_round_matches_reference():
    rng = np.random.default_rng(4)
    words = 1024
    bm = rng.integers(0, 1 << 32, (4, words), dtype=np.int64).astype(np.uint32)
    win = rng.integers(0, 1 << 32, (8, 128), dtype=np.int64).astype(np.uint32)
    qs = rng.integers(0, 4, 8).astype(np.int32)
    w0 = (rng.integers(0, (words - 128) // 4, 8) * 4).astype(np.int32)
    act = np.array([1, 1, 1, 1, 1, 1, 0, 0], bool)
    new = np.zeros_like(bm)
    want = np.asarray(ref_ir.dense_round_accumulate(
        jnp.asarray(new), jnp.asarray(win), jnp.asarray(qs), jnp.asarray(w0),
        jnp.asarray(act), jnp.asarray(bm)))
    got = intersect_rounds.dense_round_accumulate(
        t32(new), t32(win), t32(qs), t32(w0), torch.as_tensor(act), t32(bm))
    assert_u32_equal(got, want, "dense round")


@pytest.mark.cuda
def test_cuda_kernels_match_their_plain_versions(cuda_device):
    """On the card: each kernel against its plain version, bitwise, and each
    launch counted."""
    for bw in BW_BUCKETS:
        tiles, slots, qslots, firsts, ns, cand = _decode_inputs(bw, seed=bw)
        args = [t32(a, cuda_device)
                for a in (tiles, slots, qslots, firsts, ns, cand)]
        n0 = kernels.LAUNCHES["B1"]
        got = intersect_rounds.segmented_decode_and(*args, bw=bw, crows=CROWS)
        want = intersect_rounds.segmented_decode_and_plain(*args, bw=bw,
                                                           crows=CROWS)
        assert kernels.LAUNCHES["B1"] == n0 + 1
        assert kernels.RECENT[-1] == ("B1", {"bw": bw, "W": len(slots),
                                             "tiles": 6, "Q": Q,
                                             "crows": CROWS})
        for g, w in zip(got, want):
            assert_u32_equal(g, w, f"B1 cuda bw={bw}")
        b5 = [args[0], args[1], args[3], args[4], args[5][:CROWS].contiguous()]
        for g, w in zip(decode_fused.fused_decode_and(*b5, bw=bw),
                        decode_fused.fused_decode_and_plain(*b5, bw=bw)):
            assert_u32_equal(g, w, f"B5 cuda bw={bw}")
    ids, qslot, surv = _scatter_inputs(0)
    dev_args = (t32(ids, cuda_device), t32(qslot, cuda_device),
                torch.as_tensor(surv, device=cuda_device))
    zeros = torch.zeros((4, 64), dtype=torch.int32, device=cuda_device)
    assert_u32_equal(accumulate.scatter_bits(zeros.clone(), *dev_args),
                     accumulate.scatter_bits_plain(zeros.clone(), *dev_args),
                     "B2 bits cuda")
    contrib = t32(ids * 3 + 1, cuda_device)
    acc = torch.zeros((4, 2048), dtype=torch.int32, device=cuda_device)
    assert_u32_equal(
        accumulate.scatter_add(acc.clone(), dev_args[0], dev_args[1], contrib),
        accumulate.scatter_add_plain(acc.clone(), dev_args[0], dev_args[1],
                                     contrib), "B2 add cuda")
    torch.cuda.synchronize()


def test_bitmap_rounds_and_live_words_match_reference():
    """The single-call rounds (probe + scatter + commit) and the live-row
    packing, which the AND engine does not reach until mutation epochs are
    ported."""
    rng = np.random.default_rng(5)
    words = 64
    bm = rng.integers(0, 1 << 32, (4, words), dtype=np.int64).astype(np.uint32)
    ids, qslot, surv = _scatter_inputs(6, words)
    ns = rng.integers(0, 513, len(qslot)).astype(np.int32)
    active = np.array([1, 0, 1, 1], bool)
    want = np.asarray(ref_ir.bitmap_round(
        jnp.asarray(bm), jnp.asarray(ids), jnp.asarray(qslot), jnp.asarray(ns),
        jnp.asarray(active)))
    got = intersect_rounds.bitmap_round(t32(bm), t32(ids), t32(qslot), t32(ns),
                                        torch.as_tensor(active))
    assert_u32_equal(got, want, "bitmap_round")
    hits = surv.astype(np.uint32)
    want = np.asarray(ref_ir.bitmap_round_masked(
        jnp.asarray(bm), jnp.asarray(ids), jnp.asarray(qslot),
        jnp.asarray(hits), jnp.asarray(active)))
    got = intersect_rounds.bitmap_round_masked(
        t32(bm), t32(ids), t32(qslot), t32(hits), torch.as_tensor(active))
    assert_u32_equal(got, want, "bitmap_round_masked")
    dead = np.sort(rng.choice(1500, 40, replace=False))
    np.testing.assert_array_equal(
        intersect_rounds.pack_live_words(dead, 1500, 64),
        ref_ir.pack_live_words(dead, 1500, 64))
    np.testing.assert_array_equal(
        intersect_rounds.pack_live_words_range(dead, 300, 900, 32),
        ref_ir.pack_live_words_range(dead, 300, 900, 32))
