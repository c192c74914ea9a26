"""Ranked-retrieval scoring: the parts the index build needs.

The float BM25 formula and the top-k selection rule of the JAX package's
``index/scores.py``.  The quantized score arena (``ScoreArena``) and the rest
of the ranked path are still to be ported (``ROADMAP.md``, step A.6).
"""

from __future__ import annotations

import numpy as np

K1, B = 1.2, 0.75


def bm25_scores(tfs: np.ndarray, dls: np.ndarray, df: int, n_docs: int,
                avdl: float) -> np.ndarray:
    """Element-wise float64 BM25 impacts: the one formula every path uses,
    so floats are bitwise identical regardless of which slice of a term
    they score."""
    idf = np.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
    tf = tfs.astype(np.float64)
    return idf * tf * (K1 + 1) / (tf + K1 * (1 - B + B * dls / avdl))


def topk_select(docs: np.ndarray, scores: np.ndarray, k: int) -> list:
    """Top-k (docid, score) pairs by descending score, ties broken by
    ascending docid — the one selection rule of every ranked path."""
    k = min(k, len(docs))
    if k <= 0:
        return []
    if len(docs) > 2 * k:
        kth = scores[np.argpartition(-scores, k - 1)[:k]].min()
        cand = np.flatnonzero(scores >= kth)
    else:
        cand = np.arange(len(docs))
    order = cand[np.lexsort((docs[cand], -scores[cand]))][:k]
    return [(int(docs[i]), float(scores[i])) for i in order]
