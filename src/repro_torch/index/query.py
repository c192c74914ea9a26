"""One-shot query evaluation over the compressed index (paper §7.4).

Counterpart of the JAX package's ``index/query.py``.  Deprecated shims:
each helper builds an uncached :class:`~repro_torch.index.engine.QueryEngine`,
resolves an :class:`~repro_torch.index.engine.ExecutionPlan` for its single
query, and executes it; results are bit-identical to planning explicitly.
For batched serving (many queries, shared decoded-block LRU) use
``QueryEngine.plan`` / ``execute`` directly.

The shims take no device.  Their engine is never moved with
``to_device``: it serves on the host placement, the reference's placement
for these helpers, whatever card the process has.  That is the reference's
host path, not a CPU fallback of a device path.

``and_query_ref`` keeps the seed scalar path (full per-term decode +
``np.isin``) as the correctness/throughput baseline.
"""

from __future__ import annotations

import numpy as np

from .engine import K1, B, QueryBatch, QueryEngine  # noqa: F401  (re-export BM25 constants)
from .invindex import InvertedIndex


def _engine(idx: InvertedIndex) -> QueryEngine:
    return QueryEngine(idx, cache_blocks=0, cache_score_terms=0)


def _run_one(idx: InvertedIndex, terms: list, mode: str, k: int = 10):
    eng = _engine(idx)
    return eng.execute(eng.plan(QueryBatch([list(terms)], mode=mode, k=k)))[0]


def and_query(idx: InvertedIndex, terms: list) -> np.ndarray:
    return _run_one(idx, terms, "and")


def or_query(idx: InvertedIndex, terms: list, k: int = 10):
    return _run_one(idx, terms, "or", k)


def and_query_scored(idx: InvertedIndex, terms: list, k: int = 10):
    return _run_one(idx, terms, "and_scored", k)


def bm25_scores(idx: InvertedIndex, t: int):
    return _engine(idx).term_scores(t)


def and_query_ref(idx: InvertedIndex, terms: list) -> np.ndarray:
    """Seed baseline: full decode per term + scalar ``np.isin`` intersection."""
    terms = sorted((t for t in terms if t in idx.terms), key=lambda t: idx.terms[t].df)
    if not terms:
        return np.zeros(0, np.uint32)
    ids, _ = idx.decode_term(terms[0])
    for t in terms[1:]:
        if len(ids) == 0:
            break
        cand, _ = idx.decode_term(t, min_docid=int(ids[0]))
        ids = ids[np.isin(ids, cand, assume_unique=True)]
    return ids
