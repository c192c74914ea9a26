"""Kernels B1, B2, B3, B4 and B5 of the port, and the ranked round and
threshold passes around them, against the JAX package's functions on the
same inputs, bitwise.

On the CPU the port's wrappers run their plain torch versions; the reference
runs its Pallas kernels in interpret mode (B1, B3, B5) and its CPU routes
for the accumulates (B2: the XLA scatter; B4: ``_dense_loop``;
``accumulate.use_pallas()`` is False off the TPU).  The tests marked
``cuda`` hold each CUDA kernel against its plain version on the card and
skip where there is none."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import accumulate as ref_acc
from repro.kernels import decode_fused as ref_df
from repro.kernels import intersect_rounds as ref_ir
from repro.kernels import topk as ref_topk
from repro_torch import kernels
from repro_torch.kernels import (accumulate, decode_fused, intersect,
                                 intersect_rounds, scan_add, topk)

from _torch_parity import assert_u32_equal, cuda_device, t32, u32  # noqa: F401

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


def test_scatter_bits_reads_hit_words_as_they_are():
    """The fused AND round's scatter: B1's int32 hit words (0 or 1; any
    non-zero word counts as alive) go to B2 as the mask with no ``!= 0``
    pass, through ``scatter_bits`` and ``round_accumulate_masked``, against
    the reference's ``scatter_bits`` of ``hits != 0`` on a zeroed bitmap
    and its ``round_accumulate_masked``."""
    words = 64
    ids, qslot, surv = _scatter_inputs(21, words)
    hits = surv.astype(np.uint32)
    hits[0, :8] *= np.uint32(0x80000001)          # non-zero words but 1
    zero = np.zeros((4, words), np.uint32)
    want = np.asarray(ref_acc.scatter_bits(
        jnp.asarray(zero), jnp.asarray(ids), jnp.asarray(qslot),
        jnp.asarray(hits != 0)))
    got = accumulate.scatter_bits(t32(zero), t32(ids), t32(qslot), t32(hits))
    assert_u32_equal(got, want, "B2 bits on hit words")
    new = np.random.default_rng(22).integers(
        0, 1 << 32, (4, words), dtype=np.int64).astype(np.uint32)
    want = np.asarray(ref_ir.round_accumulate_masked(
        jnp.asarray(new), jnp.asarray(ids), jnp.asarray(qslot),
        jnp.asarray(hits)))
    got = intersect_rounds.round_accumulate_masked(
        t32(new), t32(ids), t32(qslot), t32(hits))
    assert_u32_equal(got, want, "round_accumulate_masked")


def _runs_in_words(words: int):
    """6 entries x 512 lanes over 2 queries with runs of lanes in one word:
    entries 0-1 of query 0 take the even and the odd docids of one range
    (every word shared by the two entries, 16 lanes a word each), entry 2
    of query 0 512 consecutive docids (32 lanes a word), entries 3-5 of
    query 1 docids 1, 2 and 40 apart; no docid twice in a query (the round
    contract)."""
    ids = np.stack([np.arange(512) * 2 + 64, np.arange(512) * 2 + 65,
                    np.arange(512) + 3000, np.arange(512) + 21000,
                    np.arange(512) * 2 + 1000, np.arange(512) * 40 + 11]
                   ).astype(np.uint32)
    assert words * 32 > ids.max()
    return ids, np.array([0, 0, 0, 1, 1, 1], np.int32)


@pytest.mark.parametrize("mask", ("bool", "int32"))
def test_scatter_bits_runs_in_one_word_match_reference(mask):
    """B2 bits where many lanes of a warp and lanes of two entries of one
    query set bits of one word (the seed round's ascending docids), every
    second run of 40 lanes dead."""
    words = 1024
    ids, qslot = _runs_in_words(words)
    surv = (np.arange(512) // 40 % 2 == 0)[None, :].repeat(len(ids), 0)
    surv[2] = True
    want = np.asarray(ref_acc.scatter_bits(
        jnp.zeros((2, words), jnp.uint32), jnp.asarray(ids),
        jnp.asarray(qslot), jnp.asarray(surv)))
    m = torch.as_tensor(surv) if mask == "bool" else t32(surv.astype(np.uint32))
    got = accumulate.scatter_bits(torch.zeros((2, words), dtype=torch.int32),
                                  t32(ids), t32(qslot), m)
    assert_u32_equal(got, want, f"B2 bits runs, {mask} mask")


def test_scatter_bits_refuses_bad_masks():
    """The mask must be bool or int32, of the ids' shape, on the bitmap's
    device; nothing is written otherwise."""
    ids, qslot = _runs_in_words(1024)
    bm = torch.zeros((2, 1024), dtype=torch.int32)
    args = (bm, t32(ids), t32(qslot))
    for dt in (torch.int64, torch.uint8, torch.int16):
        with pytest.raises(TypeError, match="surv"):
            accumulate.scatter_bits(*args, torch.ones(ids.shape, dtype=dt))
    with pytest.raises(ValueError, match="surv"):
        accumulate.scatter_bits(*args, torch.ones((6, 511), dtype=torch.bool))
    with pytest.raises(ValueError, match="surv"):
        accumulate.scatter_bits(*args, torch.ones(ids.shape, dtype=torch.int32,
                                                  device="meta"))
    assert not bm.any()


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


def test_scatter_add_masked_matches_reference():
    """The ranked rounds' scatter: the reference's ``scatter_add`` of
    ``where(surv, codes, 0)``, with overlapping entries of one query."""
    rng = np.random.default_rng(12)
    width = 2048
    ids, _, surv = _scatter_inputs(13, width // 32)
    qslot = rng.integers(0, 4, len(ids)).astype(np.int32)
    codes = rng.integers(0, 1 << 32, ids.shape, dtype=np.int64).astype(
        np.uint32)
    acc = rng.integers(0, 1 << 32, (4, width), dtype=np.int64).astype(
        np.uint32)
    want = np.asarray(ref_acc.scatter_add(
        jnp.asarray(acc), jnp.asarray(ids), jnp.asarray(qslot),
        jnp.where(jnp.asarray(surv), jnp.asarray(codes), jnp.uint32(0))))
    got = accumulate.scatter_add_masked(t32(acc.copy()), t32(ids), t32(qslot),
                                        t32(codes), torch.as_tensor(surv))
    assert_u32_equal(got, want, "B2 add masked")


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


B1_NS = (0, 1, 31, 32, 127, 128, 511, 512)


@pytest.mark.cuda
@pytest.mark.parametrize("bw", BW_BUCKETS)
def test_cuda_decode_and_edges(bw, cuda_device):
    """B1 and B5 at every bit width against their plain versions, bitwise:
    posting counts at every warp and row edge, first docids just below
    2**32 (the prefix sum wraps), docids past the bitmap (the word index
    clamps), full-width gaps, and work-list lengths that leave a block's
    last warps without an entry."""
    rng = np.random.default_rng(300 + bw)
    s = 5
    tiles = np.concatenate([
        ref_df.pack_gaps(rng.integers(0, 1 << bw, 512, dtype=np.int64)
                         .astype(np.uint32), bw) for _ in range(s)])
    ns = np.array(B1_NS * 2, np.int32)
    w = len(ns) + 1                             # 17: no multiple of 4
    ns = np.append(ns, 300).astype(np.int32)
    slots = rng.integers(0, s, w).astype(np.int32)
    qslots = rng.integers(0, Q, w).astype(np.int32)
    firsts = rng.integers(0, CROWS * 4096, w).astype(np.uint32)
    firsts[len(B1_NS):] = (1 << 32) - rng.integers(1, 3000, w - len(B1_NS))
    firsts[3] = CROWS * 4096 - 5                # past the bitmap: clamped
    cand = rng.integers(0, 1 << 32, (Q * CROWS, 128),
                        dtype=np.int64).astype(np.uint32)
    args = [t32(a, cuda_device)
            for a in (tiles, slots, qslots, firsts, ns, cand)]
    for n in (w, 1, 4, 5):
        a = [args[0], *(x[:n] for x in args[1:5]), args[5]]
        n0 = kernels.LAUNCHES["B1"]
        got = intersect_rounds.segmented_decode_and(*a, bw=bw, crows=CROWS)
        assert kernels.LAUNCHES["B1"] == n0 + 1
        want = intersect_rounds.segmented_decode_and_plain(*a, bw=bw,
                                                           crows=CROWS)
        for g, x in zip(got, want):
            assert_u32_equal(g, x, f"B1 cuda edges bw={bw} W={n}")
        b5 = [a[0], a[1], a[3], a[4], args[5][:CROWS].contiguous()]
        for g, x in zip(decode_fused.fused_decode_and(*b5, bw=bw),
                        decode_fused.fused_decode_and_plain(*b5, bw=bw)):
            assert_u32_equal(g, x, f"B5 cuda edges bw={bw} W={n}")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ("random", "all_dead", "all_live"))
@pytest.mark.parametrize("lanes", (100, 257, 512))
def test_cuda_scatter_bits_cases(lanes, case, cuda_device):
    """B2 bits against its plain version, bitwise, on a bool and on an
    int32 mask: lane counts that are no multiple of 32 (a warp that would
    straddle two entries), runs of lanes in one word, words shared by
    entries of one query, and rows and words out of range (dropped); one
    counted launch a call."""
    rng = np.random.default_rng(lanes)
    p, q, words = 23, 3, 192
    qslot = (np.arange(p) % (q + 1)).astype(np.int32)    # row q: dropped
    qslot[0] = -1
    # each query's docids: runs of 32 consecutive docs in random order, some
    # past the bitmap's end, cut into its entries' lanes (no docid twice in
    # a query, the round contract), each entry's ascending
    runs = (words * 32 + 256) // 32
    ids = np.zeros((p, lanes), np.uint32)
    for row in range(-1, q + 1):
        pool = (rng.permutation(runs)[:, None] * 32 + np.arange(32)).ravel()
        for k, j in enumerate(np.flatnonzero(qslot == row)):
            ids[j] = np.sort(pool[k * lanes:(k + 1) * lanes])
    surv = {"random": rng.random((p, lanes)) < 0.5,
            "all_dead": np.zeros((p, lanes), bool),
            "all_live": np.ones((p, lanes), bool)}[case]
    start = t32(rng.integers(0, 1 << 32, (q, words), dtype=np.int64).astype(
        np.uint32), cuda_device)
    for mask in (torch.as_tensor(surv, device=cuda_device),
                 t32(surv * rng.integers(1, 1 << 32, surv.shape,
                                         dtype=np.int64).astype(np.uint32),
                     cuda_device)):
        args = (t32(ids, cuda_device), t32(qslot, cuda_device), mask)
        n0 = kernels.LAUNCHES["B2"]
        got = accumulate.scatter_bits(start.clone(), *args)
        assert kernels.LAUNCHES["B2"] == n0 + 1
        assert_u32_equal(got, accumulate.scatter_bits_plain(start.clone(),
                                                            *args),
                         f"B2 bits cuda lanes={lanes} {case} {mask.dtype}")
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


# --------------------------------------------------------------------------- #
# the ranked slice: B3, B4 and the passes around them
# --------------------------------------------------------------------------- #


def _unpack_inputs(seed: int):
    """A score arena of 5 packed blocks (512, 511, 100, 1 and 0 codes) and
    a work-list that repeats and reorders its slots."""
    rng = np.random.default_rng(seed)
    blocks = [rng.integers(0, 256, n).astype(np.uint32)
              for n in (512, 511, 100, 1, 0)]
    tiles = np.stack([ref_df.pack_gaps(c, 8)[0] for c in blocks])
    slots = np.array([3, 0, 0, 4, 1, 2, 0], np.int32)
    return blocks, tiles, slots


def test_unpack_codes_matches_reference():
    """B3's plain version against the Pallas kernel (interpret mode)."""
    blocks, tiles, slots = _unpack_inputs(0)
    want = ref_topk.unpack_codes(jnp.asarray(tiles), jnp.asarray(slots),
                                 interpret=True)
    got = topk.unpack_codes(t32(tiles), t32(slots))
    assert_u32_equal(got, want, "B3")
    rows = np.asarray(want).reshape(len(slots), -1)
    for j, s in enumerate(slots):           # and what the codes mean
        c = blocks[s]
        np.testing.assert_array_equal(rows[j, :len(c)], c)
        assert not rows[j, len(c):].any()


def _dense_inputs(seed: int, q: int = 3, width: int = 4 * 4096):
    """8 dense-window entries over ``q`` queries, unsorted; entries 0 and 1
    belong to one query and overlap in 3584 columns (codes at disjoint
    positions, as two blocks of one term hold disjoint docids); entry 5 is
    inactive.  Codes cover the whole u32 range to exercise the wrap."""
    rng = np.random.default_rng(seed)
    p = 8
    qslot = rng.integers(0, q, p).astype(np.int32)
    qslot[1] = qslot[0]
    col0 = (rng.integers(0, (width - 4096) // 128 + 1, p) * 128).astype(
        np.int32)
    col0[0], col0[1] = 1024, 1024 + 512
    codes = rng.integers(0, 1 << 32, (p, 4096), dtype=np.int64).astype(
        np.uint32)
    codes[rng.random(codes.shape) < 0.4] = 0
    pos = rng.random(4096) < 0.5            # entries 0 and 1: disjoint docs
    codes[0, 512:][~pos[:-512]] = 0
    codes[1, :-512][pos[:-512]] = 0
    act = np.ones(p, bool)
    act[5] = False
    acc = rng.integers(0, 1 << 32, (q, width), dtype=np.int64).astype(
        np.uint32)
    return acc, codes, qslot, col0, act


def test_dense_add_matches_reference():
    """B4's plain version against the reference's CPU route
    ``_dense_loop`` (entries in order, each window added in turn)."""
    acc, codes, qslot, col0, act = _dense_inputs(1)
    want = ref_acc._dense_loop(jnp.asarray(acc), jnp.asarray(codes),
                               jnp.asarray(qslot), jnp.asarray(col0),
                               jnp.asarray(act))
    got = t32(acc.copy())
    out = accumulate.dense_add(got, t32(codes), t32(qslot), t32(col0),
                               torch.as_tensor(act))
    assert out is got
    assert_u32_equal(got, want, "B4")
    # the inactive entry wrote nothing, the overlapping pair both landed
    assert_u32_equal(got, ref_acc.dense_add(
        jnp.asarray(acc), jnp.asarray(codes), jnp.asarray(qslot),
        jnp.asarray(col0), jnp.asarray(act)), "B4 public")
    moved = u32(got) != acc
    assert moved[qslot[0], 1024:1024 + 4096 + 512].any()


def test_dense_add_refuses_bad_arguments():
    acc, codes, qslot, col0, act = _dense_inputs(2)
    args = [t32(acc), t32(codes), t32(qslot), t32(col0), torch.as_tensor(act)]
    with pytest.raises(TypeError, match="act"):
        accumulate.dense_add(*args[:4], args[4].int())
    with pytest.raises(ValueError, match="codes"):
        accumulate.dense_add(args[0], args[1][:, :128].contiguous(),
                             *args[2:])


def _packed_inputs(seed: int):
    """``_dense_inputs``' windows (an overlapping pair of one query, an
    inactive entry) with packed (P, 1024) code tiles and (P, 128) window
    words in place of the codes, and entry 7's window at the row's end.
    The tiles carry codes at every position, so an ungated add that masks
    by anything shows."""
    acc, _, qslot, col0, act = _dense_inputs(seed)
    rng = np.random.default_rng(seed + 50)
    p = len(qslot)
    col0[7] = acc.shape[1] - 4096
    tiles = rng.integers(0, 1 << 32, (p, 1024), dtype=np.int64).astype(
        np.uint32)
    win = rng.integers(0, 1 << 32, (p, 128), dtype=np.int64).astype(
        np.uint32)
    return acc, tiles, win, qslot, col0, act


def _ref_dense_packed(acc, tiles, win, qslot, col0, act, gated: bool):
    """The reference's dense round composition: ``ref_topk``'s unpack and
    gate (``dense_score_round``), then ``ref_acc.dense_add``."""
    p = tiles.shape[0]
    t = jnp.asarray(tiles)
    shifts = jnp.uint32(8) * jnp.arange(4, dtype=jnp.uint32)
    codes = ((t[:, :, None] >> shifts) & jnp.uint32(0xFF)).reshape(p, -1)
    if gated:
        w = jnp.asarray(win)
        codes = codes * ((w[:, :, None] >> jnp.arange(32, dtype=jnp.uint32))
                         & jnp.uint32(1)).reshape(p, -1)
    return ref_acc.dense_add(jnp.asarray(acc), codes, jnp.asarray(qslot),
                             jnp.asarray(col0), jnp.asarray(act))


@pytest.mark.parametrize("chunked", (False, True))
@pytest.mark.parametrize("gated", (False, True))
def test_dense_add_packed_matches_reference(gated, chunked, monkeypatch):
    """B4's packed form (its plain version here) against the reference's
    unpack, gate and ``dense_add``, whole and in chunks of 3 entries."""
    if chunked:
        monkeypatch.setattr(accumulate, "CHUNK_ELEMS", 3 * 4096)
    acc, tiles, win, qslot, col0, act = _packed_inputs(3)
    got = t32(acc.copy())
    out = accumulate.dense_add_packed(got, t32(tiles), t32(win), t32(qslot),
                                      t32(col0), torch.as_tensor(act),
                                      gated=gated)
    assert out is got
    assert_u32_equal(got, _ref_dense_packed(acc, tiles, win, qslot, col0,
                                            act, gated),
                     f"B4 packed gated={gated}")
    # the inactive entry's window alone moved nothing; the last one did
    moved = u32(got) != acc
    assert moved[qslot[7], -4096:].any()


def test_dense_add_packed_refuses_bad_arguments():
    acc, tiles, win, qslot, col0, act = _packed_inputs(4)
    args = [t32(acc), t32(tiles), t32(win), t32(qslot), t32(col0),
            torch.as_tensor(act)]
    with pytest.raises(TypeError, match="win"):
        accumulate.dense_add_packed(*args[:2], args[2].long(), *args[3:],
                                    gated=True)
    with pytest.raises(ValueError, match="codes"):
        accumulate.dense_add_packed(args[0], t32(np.zeros((8, 4096),
                                                          np.uint32)),
                                    *args[2:], gated=False)
    with pytest.raises(ValueError, match="win"):
        accumulate.dense_add_packed(*args[:2], args[2][:, :64].contiguous(),
                                    *args[3:], gated=True)
    with pytest.raises(ValueError, match="contiguous"):
        accumulate.dense_add_packed(args[0], args[1].t().contiguous().t(),
                                    *args[2:], gated=False)


def _sparse_acc(seed: int, q: int = 5, width: int = 2048):
    """Accumulator rows as the ranked rounds leave them: mostly zero, a few
    sums below 2**16, a few above (where the descend saturates), and row 4
    with fewer non-zeros than any k used."""
    rng = np.random.default_rng(seed)
    acc = np.where(rng.random((q, width)) < 0.05,
                   rng.integers(1, 600, (q, width)), 0)
    acc[1, rng.integers(0, width, 6)] = rng.integers(1 << 16, 1 << 20, 6)
    acc[4] = 0
    acc[4, [3, 70]] = [9, 5]
    return acc.astype(np.uint32)


CHUNKS = {"one pass": None, "rows of 2": 2 * 2048, "rows of 1": 1}


@pytest.mark.parametrize("chunk", sorted(CHUNKS))
def test_threshold_passes_match_reference(chunk, monkeypatch):
    """``_kth_descend`` (through ``topk_threshold``), ``topk_stats``,
    ``pooled_threshold`` and ``candidate_bitmap`` equal the reference,
    whole and in row chunks (the last chunk ragged)."""
    if CHUNKS[chunk] is not None:
        monkeypatch.setattr(topk, "CHUNK_ELEMS", CHUNKS[chunk])
    acc = _sparse_acc(3)
    q, width = acc.shape
    rng = np.random.default_rng(4)
    member = rng.integers(0, 1 << 32, (q, width // 32),
                          dtype=np.int64).astype(np.uint32)
    margin = np.array([0, 2, 3, 1, 2], np.int32)
    iq = np.array([1 << 16, 40000, 1 << 16, 1, 65535], np.uint32)
    for k in (1, 3, 7, 10):
        want = ref_topk.topk_threshold(jnp.asarray(acc), k)
        theta = topk.topk_threshold(t32(acc), k)
        assert_u32_equal(theta, want, f"topk_threshold k={k}")
        for g, w in zip(topk.topk_stats(t32(acc), k),
                        ref_topk.topk_stats(jnp.asarray(acc), k)):
            assert_u32_equal(g, w, f"topk_stats k={k}")
        assert_u32_equal(topk.pooled_threshold(t32(acc), k),
                         ref_topk.pooled_threshold(jnp.asarray(acc), k),
                         f"pooled_threshold k={k}")
        got = topk.candidate_bitmap(t32(acc), t32(member), theta,
                                    t32(margin), t32(iq))
        assert_u32_equal(got, ref_topk.candidate_bitmap(
            jnp.asarray(acc), jnp.asarray(member), want, jnp.asarray(margin),
            jnp.asarray(iq)), f"candidate_bitmap k={k}")
    assert_u32_equal(topk._scale_q16(t32(np.array([0, 7, 65535, 65536, 123456,
                                                   (1 << 31) - 1])),
                                     t32(np.array([1 << 16, 3, 40000, 1,
                                                   65535, 1 << 16]))),
                     ref_topk._scale_q16(
                         jnp.asarray(np.array([0, 7, 65535, 65536, 123456,
                                               (1 << 31) - 1], np.uint32)),
                         jnp.asarray(np.array([1 << 16, 3, 40000, 1, 65535,
                                               1 << 16], np.uint32))),
                     "scale_q16")


def _round_state(seed: int, q: int = 4, words: int = 64):
    rng = np.random.default_rng(seed)
    acc = rng.integers(0, 1 << 20, (q, words * 32)).astype(np.uint32)
    member = rng.integers(0, 1 << 32, (q, words), dtype=np.int64).astype(
        np.uint32)
    gate = rng.integers(0, 1 << 32, (q, words), dtype=np.int64).astype(
        np.uint32)
    theta = np.array([0, 300, 1000, 65535], np.uint32)[:q]
    iq = np.array([1 << 16, 1 << 16, 30000, 1 << 16], np.uint32)[:q]
    return acc, member, gate, theta, iq


@pytest.mark.parametrize("gated", (False, True))
def test_score_rounds_match_reference(gated):
    """``score_round`` (probing the gate or not) and ``score_round_masked``:
    entries whose bound cannot beat the scaled theta scatter nothing."""
    acc, member, gate, theta, iq = _round_state(5)
    ids, qslot, hits = _scatter_inputs(6)
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 256, ids.shape).astype(np.uint32)
    ns = rng.integers(0, 513, len(qslot)).astype(np.int32)
    ub = rng.integers(0, 1200, len(qslot)).astype(np.int32)
    args = (ids, qslot, codes, ns, gate, ub, theta, iq)
    want = ref_topk.score_round(jnp.asarray(acc), jnp.asarray(member),
                                *map(jnp.asarray, args), gated=gated)
    got = topk.score_round(t32(acc), t32(member), *map(t32, args),
                           gated=gated)
    for g, w, what in zip(got, want, ("acc", "member")):
        assert_u32_equal(g, w, f"score_round gated={gated} {what}")
    args = (ids, qslot, codes, hits.astype(np.uint32), ub, theta, iq)
    want = ref_topk.score_round_masked(jnp.asarray(acc), jnp.asarray(member),
                                       *map(jnp.asarray, args))
    got = topk.score_round_masked(t32(acc), t32(member), *map(t32, args))
    for g, w, what in zip(got, want, ("acc", "member")):
        assert_u32_equal(g, w, f"score_round_masked {what}")


@pytest.mark.parametrize("chunked", (False, True))
@pytest.mark.parametrize("gated", (False, True))
def test_dense_score_round_matches_reference(gated, chunked, monkeypatch):
    """The dense round (window codes through B4, membership by window OR),
    whole and with the plain B4's entries split into chunks of 3."""
    if chunked:
        monkeypatch.setattr(accumulate, "CHUNK_ELEMS", 3 * 4096)
    acc, member, gate, theta, iq = _round_state(8, words=512)
    rng = np.random.default_rng(9)
    p = 8
    qslot = rng.integers(0, 4, p).astype(np.int32)
    w0 = (rng.integers(0, (512 - 128) // 4 + 1, p) * 4).astype(np.int32)
    qslot[1], w0[0], w0[1] = qslot[0], 40, 56     # overlapping windows
    words = rng.integers(0, 1 << 32, (p, 128), dtype=np.int64).astype(
        np.uint32)
    words[1, :112] &= ~words[0, 16:]                 # disjoint docs
    tiles = rng.integers(0, 1 << 32, (p, 1024), dtype=np.int64).astype(
        np.uint32)
    ub = rng.integers(0, 1200, p).astype(np.int32)
    args = (tiles, words, qslot, w0, ub, theta, iq, gate)
    want = ref_topk.dense_score_round(jnp.asarray(acc), jnp.asarray(member),
                                      *map(jnp.asarray, args), gated=gated)
    got = topk.dense_score_round(t32(acc), t32(member), *map(t32, args),
                                 gated=gated)
    for g, w, what in zip(got, want, ("acc", "member")):
        assert_u32_equal(g, w, f"dense_score_round gated={gated} {what}")


@pytest.mark.cuda
def test_cuda_score_kernels_match_their_plain_versions(cuda_device):
    """On the card: B3 and B4 against their plain versions, bitwise, and
    each launch counted."""
    _, tiles, slots = _unpack_inputs(0)
    args = (t32(tiles, cuda_device), t32(slots, cuda_device))
    n0 = kernels.LAUNCHES["B3"]
    assert_u32_equal(topk.unpack_codes(*args), topk.unpack_codes_plain(*args),
                     "B3 cuda")
    assert kernels.LAUNCHES["B3"] == n0 + 1
    acc, codes, qslot, col0, act = _dense_inputs(1)
    args = [t32(codes, cuda_device), t32(qslot, cuda_device),
            t32(col0, cuda_device), torch.as_tensor(act, device=cuda_device)]
    start = t32(acc, cuda_device)
    n0 = kernels.LAUNCHES["B4"]
    got = accumulate.dense_add(start.clone(), *args)
    assert kernels.LAUNCHES["B4"] == n0 + 1
    assert_u32_equal(got, accumulate.dense_add_plain(start.clone(), *args),
                     "B4 cuda")
    torch.cuda.synchronize()


# B2's add form: (entries, lanes, view offset in words).  Every case has
# duplicate targets across entries (two queries, docids from a narrow
# range), runs of zero contributions (and, masked, of dead lanes) and ids
# past the row's end; "ragged" is no multiple of 8 entries, "lanes_510"
# no multiple of 4 lanes and "misaligned" starts ids, contributions and
# mask past a 16-byte boundary.
B2_ADD_CASES = {"ragged": (13, 512, 0), "lanes_510": (9, 510, 0),
                "misaligned": (11, 512, 1)}


@pytest.mark.cuda
@pytest.mark.parametrize("masked", (False, True))
@pytest.mark.parametrize("case", sorted(B2_ADD_CASES))
def test_cuda_scatter_add_cases(case, masked, cuda_device):
    """B2's add form (plain, or masked by survivors as the ranked rounds
    call it) against its plain version, bitwise, one counted launch a
    call."""
    p, lanes, off = B2_ADD_CASES[case]
    rng = np.random.default_rng(p + lanes)
    width = 3072
    ids = rng.integers(0, width + 64, p * lanes + off).astype(np.uint32)
    contrib = rng.integers(0, 1 << 32, p * lanes + off,
                           dtype=np.int64).astype(np.uint32)
    contrib[rng.random(contrib.shape) < 0.3] = 0
    contrib[off + 8:off + 16] = 0
    ids_t = t32(ids, cuda_device)[off:].view(p, lanes)
    con_t = t32(contrib, cuda_device)[off:].view(p, lanes)
    qslot = t32(rng.integers(0, 2, p).astype(np.int32), cuda_device)
    start = t32(rng.integers(0, 1 << 32, (2, width), dtype=np.int64).astype(
        np.uint32), cuda_device)
    surv = rng.random(p * lanes + off) < 0.5
    surv[off + 16:off + 24] = False
    surv_t = torch.as_tensor(surv, device=cuda_device)[off:].view(p, lanes)
    if masked:
        fns, args = ((accumulate.scatter_add_masked,
                      accumulate.scatter_add_masked_plain),
                     (ids_t, qslot, con_t, surv_t))
    else:
        fns, args = ((accumulate.scatter_add, accumulate.scatter_add_plain),
                     (ids_t, qslot, con_t))
    n0 = kernels.LAUNCHES["B2add"]
    got = fns[0](start.clone(), *args)
    assert kernels.LAUNCHES["B2add"] == n0 + 1
    assert_u32_equal(got, fns[1](start.clone(), *args),
                     f"B2 add {case} masked={masked}")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("form", ("unpacked", "packed", "packed_gated"))
def test_cuda_dense_add_forms(form, cuda_device):
    """Both B4 instances against their plain versions, bitwise, on
    overlapping windows of one query, a window at the row's end and an
    inactive entry; one counted launch a call."""
    acc, tiles, win, qslot, col0, act = _packed_inputs(5)
    dev = [t32(a, cuda_device) for a in (acc, tiles, win, qslot, col0)]
    start, tiles_t, win_t, qslot_t, col0_t = dev
    act_t = torch.as_tensor(act, device=cuda_device)
    if form == "unpacked":
        codes = accumulate._window_codes(tiles_t)
        run = (lambda f, a: f(a, codes, qslot_t, col0_t, act_t))
        fns = (accumulate.dense_add, accumulate.dense_add_plain)
    else:
        gated = form == "packed_gated"
        run = (lambda f, a: f(a, tiles_t, win_t, qslot_t, col0_t, act_t,
                              gated=gated))
        fns = (accumulate.dense_add_packed, accumulate.dense_add_packed_plain)
    n0 = kernels.LAUNCHES["B4"]
    got = run(fns[0], start.clone())
    assert kernels.LAUNCHES["B4"] == n0 + 1
    assert kernels.RECENT[-1][1]["packed"] == (form != "unpacked")
    assert_u32_equal(got, run(fns[1], start.clone()), f"B4 {form}")
    torch.cuda.synchronize()


def _stream_words(rng, shape, bits: int = 32) -> np.ndarray:
    return rng.integers(0, 1 << bits, shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.cuda
def test_cuda_stream_kernels_match_their_plain_versions(cuda_device):
    """On the card: B6, B7a and B7b at every bit width 1..32 (values wider
    than the width, so B7a's mask counts), B9, B8 on a row count that is no
    multiple of 32 and on sums that wrap past 2**32, and B10, each against
    its plain version, bitwise, and each launch counted."""
    from repro_torch.kernels import (bitpack, intersect, quadmax, scan_add,
                                     unpack_delta)
    rng = np.random.default_rng(11)
    for bw in range(1, 33):
        frames = 1 + bw % 3
        x = t32(_stream_words(rng, (frames * 32, 128)), cuda_device)
        n0 = dict(kernels.LAUNCHES)
        packed = bitpack.pack_frames(x, bw)
        assert_u32_equal(packed, bitpack.pack_frames_plain(x, bw),
                         f"B7a cuda bw={bw}")
        assert_u32_equal(bitpack.unpack_frames(packed, bw),
                         bitpack.unpack_frames_plain(packed, bw),
                         f"B7b cuda bw={bw}")
        assert_u32_equal(unpack_delta.unpack_delta_frames(packed, bw),
                         unpack_delta.unpack_delta_frames_plain(packed, bw),
                         f"B6 cuda bw={bw}")
        for k in ("B7a", "B7b", "B6"):
            assert kernels.LAUNCHES[k] == n0[k] + 1, k
    x = t32(_stream_words(rng, (5 * 32, 128)), cuda_device)
    assert_u32_equal(quadmax.frame_or(x), quadmax.frame_or_plain(x), "B9 cuda")
    for rows, bits in ((37, 32), (1, 32), (300, 20)):
        x = t32(_stream_words(rng, (rows, 128), bits), cuda_device)
        assert_u32_equal(scan_add.prefix_sum_blocks(x),
                         scan_add.prefix_sum_blocks_plain(x),
                         f"B8 cuda rows={rows}")
    x = torch.full((64 * 32, 128), -(1 << 31), dtype=torch.int32,
                   device=cuda_device)                # 2**31 each: wraps
    got = scan_add.prefix_sum_blocks(x)
    assert_u32_equal(got, scan_add.prefix_sum_blocks_plain(x), "B8 wrap")
    assert int(got[0, 1]) == 0 and int(got[0, 2]) == -(1 << 31)
    a, b = (t32(_stream_words(rng, (9, 128)), cuda_device) for _ in range(2))
    n0 = kernels.LAUNCHES["B10"]
    assert_u32_equal(intersect.bitmap_and_tiles(a, b),
                     intersect.bitmap_and_tiles_plain(a, b), "B10 cuda")
    assert kernels.LAUNCHES["B10"] == n0 + 1
    torch.cuda.synchronize()


# B8's single-pass scan: (rows, bits of each word, fill), fill a constant
# word instead of random ones.  "many_tiles_ragged" has more tiles (1,001
# of 64 rows) than the card holds resident at once and a last tile of 7
# rows.
B8_CASES = {
    "many_tiles_ragged": (32 * 2000 + 7, 32, None),
    "one_row": (1, 32, None),
    "one_tile": (scan_add.TILE_ROWS, 32, None),
    "narrow_words": (300, 20, None),
    "wrap": (32 * 300 + 3, 32, 0xFFFFFFFF),
}


def _b8_input(case: str, seed: int, device):
    rows, bits, fill = B8_CASES[case]
    rng = np.random.default_rng(seed)
    x = (np.full((rows, 128), fill, np.uint32) if fill is not None
         else _stream_words(rng, (rows, 128), bits))
    return t32(x, device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(B8_CASES))
def test_cuda_prefix_sum_blocks_cases(case, cuda_device):
    """B8 against its plain version, bitwise, one counted launch a call."""
    x = _b8_input(case, 21, cuda_device)
    n0 = kernels.LAUNCHES["B8"]
    got = scan_add.prefix_sum_blocks(x)
    assert kernels.LAUNCHES["B8"] == n0 + 1
    assert_u32_equal(got, scan_add.prefix_sum_blocks_plain(x), f"B8 {case}")
    if case == "wrap":                       # -1 each: the sums count down
        assert int(got.view(-1)[-1]) == -x.numel()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_prefix_sum_blocks_back_to_back(cuda_device):
    """Two B8 calls queued back to back on different inputs of one shape:
    the second's scratch reuses the first's memory, and it must not read
    the first's tile status words.  Then a shorter call after both."""
    xs = [_b8_input("many_tiles_ragged", s, cuda_device) for s in (1, 2)]
    xs.append(_b8_input("narrow_words", 3, cuda_device))
    n0 = kernels.LAUNCHES["B8"]
    got = [scan_add.prefix_sum_blocks(x) for x in xs]
    assert kernels.LAUNCHES["B8"] == n0 + len(xs)
    for i, (g, x) in enumerate(zip(got, xs)):
        assert_u32_equal(g, scan_add.prefix_sum_blocks_plain(x),
                         f"B8 call {i}")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", (1, 9, 6154))
def test_cuda_bitmap_and_tiles_rows(rows, cuda_device):
    """B10 against its plain version, bitwise, one counted launch a call."""
    rng = np.random.default_rng(rows)
    a, b = (t32(_stream_words(rng, (rows, 128)), cuda_device)
            for _ in range(2))
    n0 = kernels.LAUNCHES["B10"]
    got = intersect.bitmap_and_tiles(a, b)
    assert kernels.LAUNCHES["B10"] == n0 + 1
    assert_u32_equal(got, intersect.bitmap_and_tiles_plain(a, b),
                     f"B10 rows={rows}")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ("B8", "B10"))
def test_cuda_uint4_kernels_refuse_misaligned_views(kernel, cuda_device):
    """A (R, 128) view 4 bytes into its storage raises ValueError and
    launches nothing."""
    rows = 5
    flat = torch.zeros(rows * 128 + 1, dtype=torch.int32, device=cuda_device)
    view = flat[1:].view(rows, 128)
    n0 = kernels.LAUNCHES[kernel]
    with pytest.raises(ValueError, match="16-byte boundary"):
        if kernel == "B8":
            scan_add.prefix_sum_blocks(view)
        else:
            intersect.bitmap_and_tiles(view, flat[:-1].view(rows, 128))
    assert kernels.LAUNCHES[kernel] == n0


def _live_rows(seed: int, words: int, n_rows: int) -> np.ndarray:
    """A mutation epoch's live row (``pack_live_words``: 1 % of the docs
    tombstoned, bits past the doc space 0) repeated for ``n_rows`` query
    rows, as the ranked ``or`` rounds gate with it."""
    rng = np.random.default_rng(seed)
    n_docs = words * 32 - 7
    dead = np.sort(rng.choice(n_docs, n_docs // 100, replace=False))
    row = intersect_rounds.pack_live_words(dead, n_docs, words)
    assert 0.98 < np.unpackbits(row.view(np.uint8)).mean() < 0.995
    return np.tile(row, (n_rows, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("bw", BW_BUCKETS)
def test_cuda_decode_and_probes_a_live_row(bw, cuda_device):
    """B1 probing the live row of a tombstone epoch (1 % of its bits
    cleared), as the fused ``or`` rounds do under deletes, against its
    plain version, bitwise."""
    tiles, slots, qslots, firsts, ns, _ = _decode_inputs(bw, seed=bw + 40)
    live = _live_rows(bw, CROWS * 128, Q).reshape(Q * CROWS, 128)
    args = [t32(a, cuda_device)
            for a in (tiles, slots, qslots, firsts, ns, live)]
    n0 = kernels.LAUNCHES["B1"]
    got = intersect_rounds.segmented_decode_and(*args, bw=bw, crows=CROWS)
    assert kernels.LAUNCHES["B1"] == n0 + 1
    want = intersect_rounds.segmented_decode_and_plain(*args, bw=bw,
                                                       crows=CROWS)
    for g, w in zip(got, want):
        assert_u32_equal(g, w, f"B1 live row bw={bw}")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_dense_add_packed_under_a_live_gate(cuda_device):
    """B4's gated packed form under a window gate with 99 % of its bits set
    (the live row of a tombstone epoch, as the ranked ``or`` rounds gate
    their dense windows under deletes), against its plain version,
    bitwise."""
    acc, tiles, _, qslot, col0, act = _packed_inputs(6)
    win = _live_rows(6, 128, len(qslot))
    dev = [t32(a, cuda_device) for a in (acc, tiles, win, qslot, col0)]
    start, tiles_t, win_t, qslot_t, col0_t = dev
    act_t = torch.as_tensor(act, device=cuda_device)
    n0 = kernels.LAUNCHES["B4"]
    got = accumulate.dense_add_packed(start.clone(), tiles_t, win_t, qslot_t,
                                      col0_t, act_t, gated=True)
    assert kernels.LAUNCHES["B4"] == n0 + 1
    assert kernels.RECENT[-1][1]["gated"]
    assert_u32_equal(got, accumulate.dense_add_packed_plain(
        start.clone(), tiles_t, win_t, qslot_t, col0_t, act_t, gated=True),
                     "B4 packed under a live gate")
    torch.cuda.synchronize()
