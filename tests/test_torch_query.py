"""The port's one-shot query shims (``repro_torch.index.query``) against
the JAX package's ``repro.index.query``, bitwise, on
``tests/test_pipeline_index.py``'s and ``tests/test_query_engine.py``'s
corpora, each index built with ``group_simple`` and with ``group_pfd``."""

import numpy as np
import pytest

from repro.data import synth as ref_synth
from repro.index import query as RQ
from repro.index.invindex import InvertedIndex as RefIndex
from repro_torch.data import synth
from repro_torch.index import query as Q
from repro_torch.index.engine import QueryBatch, QueryEngine
from repro_torch.index.invindex import InvertedIndex

CODECS = ["group_simple", "group_pfd"]


def _small_corpus():
    """``tests/test_query_engine.py``'s ``small_corpus`` (its RNG seed 11):
    12 terms, df 10..900, short-list and multi-block terms."""
    rng = np.random.default_rng(11)
    n_docs = 2000
    doclen = rng.integers(50, 400, n_docs).astype(np.int64)
    postings = {}
    for t, df in enumerate([10, 20, 40, 63, 64, 120, 300, 500, 700, 900, 55, 250]):
        ids = np.sort(rng.choice(n_docs, df, replace=False)).astype(np.uint32)
        tfs = rng.geometric(0.4, df).astype(np.uint32)
        postings[t] = (ids, tfs)
    queries = [rng.choice(12, size=int(rng.integers(2, 4)), replace=False).tolist()
               for _ in range(24)]
    return doclen, postings, queries


def _wikipedia():
    """``tests/test_pipeline_index.py``'s corpus: ``make_corpus("wikipedia")``
    (the port's synth equal to the reference's), queries over its most
    frequent terms plus unknown terms."""
    doclen, postings = synth.make_corpus("wikipedia")
    ref_doclen, ref_postings = ref_synth.make_corpus("wikipedia")
    np.testing.assert_array_equal(doclen, ref_doclen)
    for t, (ids, tfs) in ref_postings.items():
        np.testing.assert_array_equal(postings[t][0], ids)
        np.testing.assert_array_equal(postings[t][1], tfs)
    terms = sorted(postings)
    rng = np.random.default_rng(2)
    queries = [terms[:2]] + [rng.choice(terms[:60], size=int(rng.integers(1, 4)),
                                        replace=False).tolist() for _ in range(10)]
    return doclen, postings, queries + [[terms[0], 10_000], [10_000]]


CORPORA = {"small": _small_corpus, "wikipedia": _wikipedia}


@pytest.fixture(scope="module", params=[(c, k) for c in CORPORA for k in CODECS],
                ids=lambda p: f"{p[0]}-{p[1]}")
def built(request):
    corpus, codec = request.param
    doclen, postings, queries = CORPORA[corpus]()
    return (InvertedIndex.build(doclen, postings, codec=codec),
            RefIndex.build(doclen, postings, codec=codec), postings, queries)


def _same_ranked(got, want, msg):
    assert len(got) == len(want), msg
    for (d, s), (dw, sw) in zip(got, want):
        assert int(d) == int(dw) and np.float64(s) == np.float64(sw), (msg, d, dw, s, sw)


def test_and_query_and_seed_baseline_match_reference(built):
    idx, ref, postings, queries = built
    for q in queries:
        got, want = Q.and_query(idx, q), RQ.and_query(ref, q)
        assert got.dtype == np.uint32
        np.testing.assert_array_equal(got, want, err_msg=str(q))
        base = Q.and_query_ref(idx, q)
        np.testing.assert_array_equal(base, RQ.and_query_ref(ref, q), err_msg=str(q))
        np.testing.assert_array_equal(base, got, err_msg=str(q))


@pytest.mark.parametrize("k", [5, 10])
def test_ranked_shims_match_reference(built, k):
    idx, ref, postings, queries = built
    for q in queries:
        _same_ranked(Q.or_query(idx, q, k=k), RQ.or_query(ref, q, k=k), f"or {q}")
        _same_ranked(Q.and_query_scored(idx, q, k=k),
                     RQ.and_query_scored(ref, q, k=k), f"and_scored {q}")


def test_bm25_scores_match_reference(built):
    idx, ref, postings, queries = built
    for t in sorted(postings)[:6]:
        got, want = Q.bm25_scores(idx, t), RQ.bm25_scores(ref, t)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_shims_equal_an_explicit_plan(built):
    """The shims are single-query plans on the host placement: the same
    answers as planning the batch explicitly."""
    idx, _, _, queries = built
    eng = QueryEngine(idx)
    for mode in ("and", "or", "and_scored"):
        plan = eng.plan(QueryBatch(queries, mode=mode, k=10))
        assert plan.placement == "host"
        want = eng.execute(plan)
        shim = {"and": Q.and_query, "or": Q.or_query,
                "and_scored": Q.and_query_scored}[mode]
        for q, w in zip(queries, want):
            got = shim(idx, q)
            if mode == "and":
                np.testing.assert_array_equal(got, w)
            else:
                _same_ranked(got, w, f"{mode} {q}")


def test_unknown_terms_and_reexports():
    doclen, postings, _ = _small_corpus()
    idx = InvertedIndex.build(doclen, postings, codec="group_pfd")
    assert len(Q.and_query(idx, [999])) == 0
    assert Q.or_query(idx, [999]) == []
    assert len(Q.and_query_ref(idx, [999])) == 0
    assert (Q.K1, Q.B) == (RQ.K1, RQ.B)
    assert Q.QueryBatch is QueryBatch and Q.QueryEngine is QueryEngine
