"""LSM delta segments + tombstones: the mutable half of the streaming index.

``InvertedIndex`` generations are immutable — the compressed blocks, skip
tables, impact tables, and device arenas built from them never change after
build/compact.  Writes land here instead (the Upscaledb paper's recipe for
keeping SIMD-compressed integer runs live under updates, PAPERS.md):

  * :class:`DeltaSegment` — a small host-side mutable segment holding whole
    documents (``docid -> (doclen, {term: tf})``).  Inserts and upserts go
    here; queries union the compressed generation's results with a brute
    -force scan of this segment (it is small by construction — ``compact()``
    drains it into the next generation).
  * :class:`Tombstones` — deleted (or upsert-shadowed) base docids.  Serving
    applies them as a *live bitmap* gate on every probe: the device paths
    seed their segmented candidate bitmaps from :meth:`Tombstones.live_words`
    (packed in the ``kernels/intersect_rounds`` geometry, uploaded once per
    mutation epoch, never downloaded), the host paths mask with
    :meth:`Tombstones.mask`.

Shadowing invariant: inserting a docid that exists in the current generation
always tombstones the base copy first, so the generation's postings and the
delta segment are disjoint at all times — query-result unions are plain
sorted merges and every doc has exactly one authoritative version.

Both structures carry a monotonically increasing ``version`` so caches and
execution plans can key on the mutation epoch; ``snapshot()`` returns a
frozen copy that pins a plan's view of the delta while the live segment
keeps absorbing writes.
"""

from __future__ import annotations

import numpy as np


class DeltaSegment:
    """Host-side mutable posting segment, organized doc-major.

    Doc-major (a forward index) rather than term-major because the segment is
    the *write* side: inserts and deletes are whole-document operations, and
    the term-major views queries need (``postings``, ``scan_and``,
    ``scan_any``) are derived on demand and memoized per version.
    """

    def __init__(self):
        self._docs: dict = {}        # docid -> (doclen, {term: tf})
        self.version = 0
        self.frozen = False
        self._views: dict = {}       # (kind, key) -> memoized per-version view

    # ---- mutation ----------------------------------------------------------- #

    def _touch(self) -> None:
        if self.frozen:
            raise RuntimeError("frozen DeltaSegment snapshots are immutable")
        self.version += 1
        self._views.clear()

    def insert(self, docid: int, terms: dict, doclen: int) -> None:
        """Add (or replace) one document.  ``terms`` maps term -> tf (> 0)."""
        docid = int(docid)
        if docid < 0:
            raise ValueError(f"docid must be >= 0, got {docid}")
        if doclen <= 0:
            raise ValueError(f"doclen must be > 0, got {doclen}")
        clean = {}
        for t, tf in terms.items():
            if int(tf) <= 0:
                raise ValueError(f"tf must be > 0, got {tf} for term {t}")
            clean[int(t)] = int(tf)
        self._touch()
        self._docs[docid] = (int(doclen), clean)

    def remove(self, docid: int) -> bool:
        """Drop one document; True if it was present."""
        if int(docid) not in self._docs:
            return False
        self._touch()
        del self._docs[int(docid)]
        return True

    def snapshot(self) -> "DeltaSegment":
        """Frozen copy pinning the current contents (plans hold these)."""
        snap = DeltaSegment()
        snap._docs = dict(self._docs)        # doc payloads are never mutated
        snap.version = self.version
        snap.frozen = True
        return snap

    _empty: "DeltaSegment | None" = None

    @classmethod
    def empty_snapshot(cls) -> "DeltaSegment":
        """The shared frozen empty segment.  Doc-range shard execution
        contexts pin this: shard-local rounds never consult a delta — delta
        docs live outside every shard's generation and are merged once, on
        the parent, after the cross-shard candidate merge."""
        if cls._empty is None:
            cls._empty = cls().snapshot()
        return cls._empty

    # ---- views -------------------------------------------------------------- #

    def __len__(self) -> int:
        return len(self._docs)

    def __bool__(self) -> bool:
        return bool(self._docs)

    def __contains__(self, docid) -> bool:
        return int(docid) in self._docs

    def doclen_of(self, docid: int) -> int:
        return self._docs[int(docid)][0]

    def terms_of(self, docid: int) -> dict:
        return self._docs[int(docid)][1]

    def items(self):
        return self._docs.items()

    def max_docid(self) -> int:
        """Largest docid held, -1 when empty (sizes the doc space)."""
        return max(self._docs) if self._docs else -1

    def df(self, t: int) -> int:
        """Number of delta docs containing term t."""
        return int(np.sum([t in d[1] for d in self._docs.values()], initial=0))

    def has_term(self, t: int) -> bool:
        return any(t in d[1] for d in self._docs.values())

    def n_postings(self) -> int:
        return sum(len(d[1]) for d in self._docs.values())

    def postings(self, t: int):
        """Term-major view: (sorted uint32 docids, aligned uint32 tfs)."""
        key = ("postings", t)
        v = self._views.get(key)
        if v is None:
            ids = sorted(d for d, (_, ts) in self._docs.items() if t in ts)
            v = (np.asarray(ids, np.uint32),
                 np.asarray([self._docs[d][1][t] for d in ids], np.uint32))
            self._views[key] = v
        return v

    def scan_and(self, terms) -> np.ndarray:
        """Sorted uint32 docids of delta docs containing EVERY term (the
        brute-force AND half of a query; empty term list -> empty)."""
        terms = list(terms)
        if not terms:
            return np.zeros(0, np.uint32)
        ids = sorted(d for d, (_, ts) in self._docs.items()
                     if all(t in ts for t in terms))
        return np.asarray(ids, np.uint32)

    def scan_any(self, terms) -> np.ndarray:
        """Sorted uint32 docids of delta docs containing ANY term (the
        ranked-candidate half of a query)."""
        tset = set(terms)
        ids = sorted(d for d, (_, ts) in self._docs.items()
                     if tset.intersection(ts))
        return np.asarray(ids, np.uint32)


def dead_hits(dead: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Bool mask over ``ids`` marking the docids in ``dead`` (sorted int64,
    non-empty, as ``Tombstones.sorted_ids`` gives it), by binary search.
    ``np.isin`` sorts or tables the whole dead set on every call: 62 ms a
    call against 252,051 dead docids on the H100 machine's host (numpy
    2.3), where this takes 0.02 ms."""
    pos = np.minimum(np.searchsorted(dead, ids), len(dead) - 1)
    return dead[pos] == ids


class Tombstones:
    """Deleted / shadowed base docids, with packed live-bitmap views.

    The docid set is host-side truth; serving consumes it as masks:
    ``mask(n)`` for the numpy paths, ``live_words(n)`` packed LSB-first in
    the exact geometry of ``kernels.intersect_rounds.bitmap_geometry`` so the
    device paths can seed their segmented candidate bitmaps from it (one
    upload per mutation epoch — the gate itself never syncs anything back).
    """

    def __init__(self):
        self._dead: set = set()
        self.version = 0
        self._views: dict = {}

    def add(self, docid: int) -> bool:
        """Tombstone one docid; True if newly dead."""
        docid = int(docid)
        if docid in self._dead:
            return False
        self._dead.add(docid)
        self.version += 1
        self._views.clear()
        return True

    def __len__(self) -> int:
        return len(self._dead)

    def __bool__(self) -> bool:
        return bool(self._dead)

    def __contains__(self, docid) -> bool:
        return int(docid) in self._dead

    def sorted_ids(self, below: int | None = None) -> np.ndarray:
        """Sorted int64 dead docids (optionally only those < ``below``)."""
        key = ("ids", below)
        v = self._views.get(key)
        if v is None:
            ids = np.asarray(sorted(self._dead), np.int64)
            if below is not None:
                ids = ids[ids < below]
            ids.setflags(write=False)
            self._views[key] = v = ids
        return v

    def mask(self, n_docs: int) -> np.ndarray:
        """Frozen bool live mask over [0, n_docs): True = live."""
        key = ("mask", n_docs)
        v = self._views.get(key)
        if v is None:
            m = np.ones(n_docs, bool)
            m[self.sorted_ids(below=n_docs)] = False
            m.setflags(write=False)
            self._views[key] = v = m
        return v

    def live_words(self, n_docs: int, words: int) -> np.ndarray:
        """Frozen packed uint32 live bitmap: bit d of word d // 32 (LSB
        -first) is 1 iff doc d is live; bits in [n_docs, words * 32) are 0 so
        seeding a candidate bitmap from this never admits out-of-range docs."""
        key = ("words", n_docs, words)
        v = self._views.get(key)
        if v is None:
            bits = np.zeros(words * 32, np.uint8)
            bits[:n_docs] = self.mask(n_docs)
            w = np.packbits(bits, bitorder="little").view(np.uint32)
            w.setflags(write=False)
            self._views[key] = v = w
        return v
