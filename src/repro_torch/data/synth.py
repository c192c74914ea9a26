"""Synthetic datasets with paper-matched statistics (Table V, scaled 1/1000).

TREC GOV2 / ClueWeb09B / Wikipedia / Twitter are not redistributable; these
are Zipf-distributed corpora whose d-gap and TF statistics match the paper's
reported characteristics.  The same crc32-seeded generator as the JAX
package's ``data/synth.py``, so the same (name, seed) gives the same corpus
in both packages.  ``n_docs`` overrides the table's document count for
corpora at a collection's real size; the default reproduces the reference.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np

# name -> (n_docs, n_terms_sampled, avg_doclen_tokens, zipf_s)
DATASETS = {
    "gov2": (25_000, 2_000, 778, 1.15),
    "clueweb09b": (50_000, 2_000, 576, 1.12),
    "wikipedia": (10_000, 1_500, 344, 1.25),
    "twitter": (9_000, 1_500, 397, 1.30),
}


@dataclasses.dataclass
class PostingList:
    term: int
    docids: np.ndarray       # uint32 sorted ascending
    tfs: np.ndarray          # uint32 >= 1

    @property
    def dgaps(self) -> np.ndarray:
        out = self.docids.copy()
        out[1:] = self.docids[1:] - self.docids[:-1]
        return out


def make_dataset(name: str, seed: int = 0, n_lists: int = 200,
                 n_docs: int | None = None) -> list:
    """Posting lists for the n_lists most frequent sampled terms."""
    table_docs, n_terms, avg_len, s = DATASETS[name]
    n_docs = table_docs if n_docs is None else int(n_docs)
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % (1 << 16))
    # document frequency per term rank (Zipf), clipped to corpus size
    ranks = np.arange(1, n_terms + 1, dtype=np.float64)
    df = np.minimum((n_docs * 0.6) / ranks ** (s - 0.05), n_docs).astype(np.int64)
    df = np.maximum(df, 8)
    lists = []
    for t in range(min(n_lists, n_terms)):
        ids = np.sort(rng.choice(n_docs, size=int(df[t]), replace=False)).astype(np.uint32)
        # TF: geometric-ish, >90% fit one byte
        tf = rng.geometric(0.35, size=len(ids)).astype(np.uint32)
        tf = np.minimum(tf, 4096)
        lists.append(PostingList(t, ids, tf))
    return lists


def dataset_stats(lists) -> dict:
    gaps = np.concatenate([pl.dgaps for pl in lists])
    tfs = np.concatenate([pl.tfs for pl in lists])
    return {
        "n_postings": int(sum(len(pl.docids) for pl in lists)),
        "gap_fit8": float(np.mean(gaps < 256)),
        "tf_fit8": float(np.mean(tfs < 256)),
        "gap_mean": float(gaps.mean()),
    }


def concat_gaps(lists) -> np.ndarray:
    return np.concatenate([pl.dgaps for pl in lists]).astype(np.uint32)


def concat_tfs(lists) -> np.ndarray:
    return np.concatenate([pl.tfs for pl in lists]).astype(np.uint32)


def make_corpus(name: str, seed: int = 0, n_docs: int | None = None):
    """Token-level corpus for the query-processing path: returns
    (doc_lengths, postings dict term -> (docids, tfs))."""
    lists = make_dataset(name, seed, n_docs=n_docs)
    n = DATASETS[name][0] if n_docs is None else int(n_docs)
    doclen = np.full(n, DATASETS[name][2], np.int64)
    return doclen, {pl.term: (pl.docids, pl.tfs) for pl in lists}
