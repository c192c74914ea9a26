"""The benchmark's inputs: a corpus with TREC statistics, made from a seed.

A frozen copy of the port's ``data/synth.py`` generator (``make_dataset``
and ``make_corpus``): the same crc32-seeded Zipf draw, so the same
(corpus, seed, n_docs) gives the same postings as the program's own
generator (a test holds the two equal).  It lives here so that no change
to the program can move the benchmark's inputs.
"""

from __future__ import annotations

import zlib

import numpy as np


def make_corpus(config: dict, seed: int):
    """(doclen int64 per doc, {term: (docids uint32 ascending, tfs uint32)})
    for the ``n_lists`` most frequent of ``n_terms_sampled`` terms, by the
    configuration's statistics (``corpus``, ``n_docs``, ``avg_doclen``,
    ``zipf_s``)."""
    n_docs, n_terms, s = (config["n_docs"], config["n_terms_sampled"],
                          config["zipf_s"])
    rng = np.random.default_rng(
        seed + zlib.crc32(config["corpus"].encode()) % (1 << 16))
    # document frequency per term rank (Zipf), clipped to the corpus size
    ranks = np.arange(1, n_terms + 1, dtype=np.float64)
    df = np.minimum((n_docs * 0.6) / ranks ** (s - 0.05), n_docs).astype(np.int64)
    df = np.maximum(df, 8)
    postings = {}
    for t in range(min(config["n_lists"], n_terms)):
        ids = np.sort(rng.choice(n_docs, size=int(df[t]), replace=False)).astype(np.uint32)
        # TF: geometric, more than 90 % of them fit a byte
        tf = np.minimum(rng.geometric(0.35, size=len(ids)).astype(np.uint32), 4096)
        postings[t] = (ids, tf)
    return np.full(n_docs, config["avg_doclen"], np.int64), postings
