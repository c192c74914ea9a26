"""The ranked slice as a whole: the port's ``plan``/``execute`` in modes
``or`` and ``and_scored`` on the host, device and fused placements against
the JAX package's engine, on the corpora of ``tests/test_ranked.py`` built
with ``group_simple`` (``stream_vbyte`` and ``dense_bitmap`` beneath it),
and with ``stream_vbyte`` and ``group_pfd`` as the base codec (its
``RANKED_CODECS`` cases: placement parity and the float oracle, the
heavy-tail exception corpus, the dense-bitmap corpus, eviction pressure);
the accumulator, membership and candidate bitmaps after the round loop; the
ranked counters; and the quantized score arena.

The reference runs on the CPU as its own tests run it (Pallas kernels in
interpret mode, the XLA scatter and ``_dense_loop`` for the accumulates);
the port with ``torch_device="cpu"``, where every kernel wrapper takes its
plain torch version.  Every comparison is exact."""

import numpy as np
import pytest
import torch

from repro.index.engine import QueryBatch as RefBatch
from repro.index.engine import QueryEngine as RefEngine
from repro.index.invindex import InvertedIndex as RefIndex
from repro.index.scores import ScoreArena as RefScoreArena
from repro.index.scores import unpack_words_np as ref_unpack_words_np
from repro.kernels import topk as ref_topk
from repro_torch.index import scores
from repro_torch.index.engine import QueryBatch, QueryEngine
from repro_torch.index.invindex import InvertedIndex
from repro_torch.kernels import topk

from _torch_parity import assert_u32_equal
from test_ranked import (DENSE_QUERIES, DOCLEN, HDOCLEN, HPOSTINGS, N_DOCS,
                         POSTINGS, QUERIES, TDOCLEN, TPOSTINGS, _dense_corpus,
                         brute_or_topk)

# the rare-clustered + common shapes of test_ranked's pruning and
# adaptive-theta cases: block-max pruning fires on them
PRUNE_QUERIES = [[10, 7], [10, 3], [10, 7, 5], [10, 3, 8], [10, 1, 4, 6]]


def _zero_posting_corpus():
    postings = dict(POSTINGS)
    postings[99] = (np.zeros(0, np.uint32), np.zeros(0, np.uint32))
    return DOCLEN, postings


# name -> (doclen, postings, queries, k), as test_ranked.py uses them
CORPORA = {
    "default": (DOCLEN, POSTINGS, QUERIES + PRUNE_QUERIES, 7),
    "heavy": (HDOCLEN, HPOSTINGS, QUERIES, 9),
    "ties": (TDOCLEN, TPOSTINGS, QUERIES, 11),
    "dense": (*_dense_corpus(), DENSE_QUERIES, 7),
    "zero_posting": (*_zero_posting_corpus(),
                     [[99, 3, 7], [99], [3, 99, 5], [0, 7]], 5),
}
PLACEMENTS = ("host", "device", "fused")
MODES = ("or", "and_scored")
RANKED_COUNTERS = ("blocks_pruned", "blocks_scored", "blocks_dense",
                   "score_rounds", "score_syncs", "cand_syncs", "final_syncs")

_built: dict = {}


def _indexes(name: str):
    """(reference index, port index, queries, k) of one corpus, built once
    per test process."""
    if name not in _built:
        doclen, postings, queries, k = CORPORA[name]
        _built[name] = (RefIndex.build(doclen, postings, codec="group_simple"),
                        InvertedIndex.build(doclen, postings), queries, k)
    return _built[name]


def _engines(name: str, placement: str):
    ref_idx, idx, queries, k = _indexes(name)
    ref, eng = RefEngine(ref_idx), QueryEngine(idx)
    if placement != "host":
        ref.to_device(fused=placement == "fused")
        eng.to_device(fused=placement == "fused", torch_device="cpu")
    return ref, eng, queries, k


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("name", sorted(CORPORA))
def test_ranked_plan_execute_matches_reference(name, placement, mode):
    """Results bitwise equal (docids, float scores, order), and on the
    device placements the ranked counters equal the reference's, with one
    final sync and no score or candidate sync per batch."""
    ref, eng, queries, k = _engines(name, placement)
    want = ref.execute(ref.plan(RefBatch(queries, mode=mode, k=k),
                                placement=placement))
    plan = eng.plan(QueryBatch(queries, mode=mode, k=k), placement=placement)
    assert plan.placement == placement
    got = eng.execute(plan)
    assert got == want
    for res in got:
        for d, s in res:
            assert type(d) is int and type(s) is float
    if placement == "host":
        return
    stats = {c: eng.dev_stats[c] for c in RANKED_COUNTERS}
    assert stats == {c: ref.dev_stats[c] for c in RANKED_COUNTERS}
    assert stats["final_syncs"] == 1
    assert stats["score_syncs"] == 0 and stats["cand_syncs"] == 0
    assert stats["score_rounds"] >= 1 and stats["blocks_scored"] > 0
    if name == "dense":
        assert stats["blocks_dense"] > 0
    if name == "default" and mode == "or":
        assert stats["blocks_pruned"] > 0
    if placement == "fused":      # the same fused (B1 + B3) entries
        for c in ("fused_calls", "fused_blocks"):
            assert eng.arena.stats[c] == ref.arena.stats[c], c
        assert name == "dense" or eng.arena.stats["fused_calls"] > 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("placement", ("device", "fused"))
@pytest.mark.parametrize("name", ("default", "heavy", "ties", "dense"))
def test_ranked_accumulator_and_candidates_match_reference(name, placement,
                                                            mode):
    """After the round loop: the score accumulator, the membership bitmap
    and the compacted candidate bitmap equal the reference's rows [:nq]
    (the reference pads the rows to a power of two).  The float rescore
    turns any superset into the exact answer, so only this catches an
    accumulate fault."""
    ref, eng, queries, k = _engines(name, placement)
    nq = len(queries)
    rplan = ref.plan(RefBatch(queries, mode=mode, k=k), placement=placement)
    known, base_ts, tomb_only, armed, margins_l, iqs_l = ref._ranked_params(
        [list(q) for q in queries], k, ref._cur())
    racc, rmem, rmargins, riq, width, _ = ref._ranked_accumulate(
        [list(q) for q in queries], k, mode, rplan.terms,
        placement == "fused", base_ts=base_ts, armed=armed,
        tomb_only=tomb_only, margins_l=margins_l, iqs_l=iqs_l)
    rtheta = ref_topk.topk_threshold(racc, min(k, width))
    rcand = ref_topk.candidate_bitmap(racc, rmem, rtheta,
                                      np.asarray(rmargins), riq)

    plan = eng.plan(QueryBatch(queries, mode=mode, k=k), placement=placement)
    params = eng._ranked_params([list(q) for q in queries], k, eng._cur())
    assert params[:4] == (known, base_ts, tomb_only, armed)
    assert list(params[4]) == list(margins_l)
    assert list(params[5]) == [int(v) for v in iqs_l]
    acc, mem, margins, iq, pwidth = eng._ranked_accumulate(
        [list(q) for q in queries], k, mode, plan.terms,
        placement == "fused", base_ts=params[1], armed=params[3],
        tomb_only=params[2], margins_l=params[4], iqs_l=params[5])
    assert pwidth == width
    theta = topk.topk_threshold(acc, min(k, width))
    cand = topk.candidate_bitmap(acc, mem, theta, margins, iq)
    assert_u32_equal(acc, np.asarray(racc)[:nq], "accumulator")
    assert_u32_equal(mem, np.asarray(rmem)[:nq], "membership")
    assert_u32_equal(theta, np.asarray(rtheta)[:nq], "theta")
    assert_u32_equal(cand, np.asarray(rcand)[:nq], "candidate bitmap")
    assert np.asarray(rcand)[:nq].any()


def test_score_arena_defaults_to_the_card():
    """``ScoreArena.from_index`` with no device runs on the card, as the
    reference's puts its tiles on the default accelerator; with no card it
    raises before it quantizes anything (the CPU is asked for by name)."""
    _, idx, _, _ = _indexes("default")
    if torch.cuda.is_available():
        assert scores.ScoreArena.from_index(idx.gen).tiles.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            scores.ScoreArena.from_index(idx.gen)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            scores.ScoreArena(idx.gen)
    assert scores.ScoreArena.from_index(idx.gen, device="cpu").tiles.device \
        == torch.device("cpu")


@pytest.mark.parametrize("name", sorted(CORPORA))
def test_score_arena_matches_reference(name):
    """Every table of the quantized score arena, and its row decode."""
    ref_idx, idx, queries, k = _indexes(name)
    want = RefScoreArena.from_index(ref_idx.gen)
    got = scores.ScoreArena.from_index(idx.gen, device="cpu")
    assert got.delta == want.delta and got.gmax == want.gmax
    assert got.stripe_width == want.stripe_width
    assert got.slot == want.slot and got.dense_slot == want.dense_slot
    assert got.term_max == want.term_max
    np.testing.assert_array_equal(got.block_max, want.block_max)
    np.testing.assert_array_equal(got.dense_w0, want.dense_w0)
    assert_u32_equal(got.tiles, want.tiles, "score tiles")
    if want.dense_tiles is None:
        assert got.dense_tiles is None
    else:
        assert_u32_equal(got.dense_tiles, want.dense_tiles, "dense tiles")
    for t in want.term_tops:
        np.testing.assert_array_equal(got.term_tops[t], want.term_tops[t])
        np.testing.assert_array_equal(got.term_top_ids[t],
                                      want.term_top_ids[t])
        np.testing.assert_array_equal(got.stripes[t], want.stripes[t])
    pairs = list(want.slot)
    assert_u32_equal(got.rows(pairs), want.rows(pairs), "rows")
    for q in queries:
        for kk in (1, k, scores.TOP_TABLE + 1):
            assert got.theta0(q, kk) == want.theta0(q, kk)
    t = next(iter(want.stripes))
    los = np.array([0, 5, 100, idx.n_docs - 1])
    his = np.array([3, 900, 100, idx.n_docs - 1])
    np.testing.assert_array_equal(got.range_max_many(t, los, his),
                                  want.range_max_many(t, los, his))
    assert ([got.range_max(t, a, b) for a, b in zip(los, his)]
            == [want.range_max(t, a, b) for a, b in zip(los, his)])
    words = np.asarray(want.tiles)[0]
    np.testing.assert_array_equal(scores.unpack_words_np(words, 300),
                                  ref_unpack_words_np(words, 300))


def test_host_scoring_helpers_match_reference():
    """``term_scores`` and the block-lazy rescore of one query against the
    reference, on docs that mix hits and misses."""
    ref_idx, idx, _, _ = _indexes("default")
    ref, eng = RefEngine(ref_idx), QueryEngine(idx)
    for t in (0, 3, 10):
        a, b = eng.term_scores(t), ref.term_scores(t)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1].view(np.uint64),
                                      b[1].view(np.uint64))
    docs = np.unique(np.concatenate([POSTINGS[3][0][::3], POSTINGS[7][0][::5],
                                     np.arange(0, 3000, 97, dtype=np.uint32)]))
    for q in ([3, 7], [7, 3, 3], [10, 999]):
        want = ref._score_docs_blockwise(q, docs, 8)
        assert eng._score_docs_blockwise(q, docs, 8) == want
        assert eng._score_docs(q, docs, 8) == want


# --------------------------------------------------------------------------- #
# the other base codecs of test_ranked's RANKED_CODECS
# --------------------------------------------------------------------------- #

BASE_CODECS = ("stream_vbyte", "group_pfd")
# name -> (doclen, postings, queries, k), test_ranked's for its
# RANKED_CODECS cases
BASE_CORPORA = {
    "default": (DOCLEN, POSTINGS, QUERIES, 7),
    "heavy": (HDOCLEN, HPOSTINGS, QUERIES, 9),
    "dense": (*_dense_corpus(), DENSE_QUERIES, 7),
}


@pytest.mark.parametrize("corpus", sorted(BASE_CORPORA))
@pytest.mark.parametrize("name", BASE_CODECS)
def test_ranked_base_codec_matches_reference(name, corpus):
    """Both ranked modes on the host, device and fused placements equal the
    reference's, with its counters; on the default and dense corpora the
    ``or`` results also equal a brute-force float oracle; the heavy corpus
    gives ``group_pfd`` exception streams, the dense one bitmap blocks."""
    doclen, postings, queries, k = BASE_CORPORA[corpus]
    ref_idx = RefIndex.build(doclen, postings, codec=name)
    idx = InvertedIndex.build(doclen, postings, codec=name)
    if corpus == "heavy" and name == "group_pfd":
        assert any(encg.exceptions is not None and len(encg.exceptions)
                   for tp in idx.terms.values()
                   for _, encg, _ in tp.blocks), "no exception streams"
    for mode in MODES:
        for placement in PLACEMENTS:
            ref, eng = RefEngine(ref_idx), QueryEngine(idx)
            if placement != "host":
                ref.to_device(fused=placement == "fused")
                eng.to_device(fused=placement == "fused", torch_device="cpu")
            want = ref.execute(ref.plan(RefBatch(queries, mode=mode, k=k),
                                        placement=placement))
            got = eng.execute(eng.plan(QueryBatch(queries, mode=mode, k=k),
                                       placement=placement))
            assert got == want, (name, corpus, mode, placement)
            if placement == "host":
                continue
            for c in RANKED_COUNTERS:
                assert eng.dev_stats[c] == ref.dev_stats[c], (placement, c)
            assert eng.dev_stats["score_syncs"] == 0
            assert eng.dev_stats["final_syncs"] == 1
            assert eng.arena.stats["blocks_host"] == 0
            if corpus == "dense":
                assert eng.dev_stats["blocks_dense"] > 0
        if mode == "or" and corpus != "heavy":
            n_docs = N_DOCS if corpus == "default" else len(doclen)
            for q, res in zip(queries, got):
                oracle = brute_or_topk(doclen, postings, n_docs, q, k)
                assert [(d, pytest.approx(s_, rel=1e-12))
                        for d, s_ in oracle] == res, q


def test_ranked_eviction_pressure_stays_exact():
    """``group_pfd`` on the heavy corpus with a two-block cache and one
    score term: evictions, and the results equal the reference's."""
    ref_idx = RefIndex.build(HDOCLEN, HPOSTINGS, codec="group_pfd")
    idx = InvertedIndex.build(HDOCLEN, HPOSTINGS, codec="group_pfd")
    tiny = QueryEngine(idx, cache_blocks=2, cache_score_terms=1).to_device(
        torch_device="cpu")
    for mode in MODES:
        want = RefEngine(ref_idx).execute(RefBatch(QUERIES, mode=mode, k=6))
        got = tiny.execute(tiny.plan(QueryBatch(QUERIES, mode=mode, k=6)))
        assert got == want, mode
    assert tiny.cache.evictions > 0
