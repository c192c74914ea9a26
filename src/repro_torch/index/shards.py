"""Doc-range sharding: one generation split into self-contained per-shard
generations at contiguous docid boundaries.

Counterpart of the JAX package's ``index/shards.py``.  Sharding the serving
path doc-wise keeps every round shard-local: a doc's postings for every
term live in exactly one shard, so AND candidates and ranked score
accumulators never cross shards, and the one collective of a batch is the
final top-k merge (``kernels/topk.topk_stats`` +
``distributed/collectives.merge_topk_stats``).

A shard is an ordinary immutable :class:`~.invindex.Generation` over the
local docid space [0, hi - lo): the parent's postings are decoded, sliced
to the range, translated by -lo and re-encoded with the parent's codec
(block structure, skip tables and dense-bitmap choice re-derived locally).
What is not local is the statistics: BM25 and the impact quantizer must see
the parent corpus, or the quantized codes would drift across shards and the
merged threshold would mean nothing.  :func:`shard_generation` therefore
fixes up every shard after the local build:

  * ``TermPostings.df``    := the parent's global df,
  * ``impact_bmax``        := recomputed per local block with the parent's
                              (df, n_docs, avdl), bitwise the parent's
                              impacts for the same docs,
  * ``stat_n_docs`` / ``stat_avdl`` / ``stat_gmax``, which ``ScoreArena``
    reads so a shard quantizes at the parent's scale,
  * ``doc_lo`` / ``doc_hi`` / ``gid``: the global window served and the
    parent generation id (every shard of a generation shares its gid).

:meth:`ShardSpec.derive` picks the boundaries from build metadata only
(skip tables, no decode): per-tile posting mass balanced by
``distributed.sharding.balanced_range_bounds``, interior cuts aligned to
whole :data:`TILE_DOCS` bitmap tiles.  Explicit bounds (uneven, or with
empty shards) need no alignment: shard-local docid spaces are 0-based.
"""

from __future__ import annotations

import numpy as np

from ..distributed.sharding import balanced_range_bounds
from ..kernels.bitpack import LANES
from .invindex import SKIP, Generation
from .scores import bm25_scores

TILE_DOCS = LANES * 32          # docids per (1, 128)-word bitmap tile row


class ShardSpec:
    """Contiguous doc-range partition of one generation's docid space.

    ``bounds`` is a non-decreasing int tuple ``(0, b1, ..., n_docs)``; shard
    s serves the half-open global range [bounds[s], bounds[s+1]), possibly
    empty (repeated bounds are legal).
    """

    __slots__ = ("bounds",)

    def __init__(self, bounds):
        b = tuple(int(x) for x in bounds)
        if len(b) < 2:
            raise ValueError("ShardSpec needs at least (0, n_docs)")
        if b[0] != 0:
            raise ValueError(f"shard bounds must start at 0, got {b[0]}")
        if any(b[i] > b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"shard bounds must be non-decreasing: {b}")
        self.bounds = b

    @property
    def n_shards(self) -> int:
        return len(self.bounds) - 1

    def ranges(self) -> list:
        """[(lo, hi)] per shard, in docid order."""
        return list(zip(self.bounds[:-1], self.bounds[1:]))

    def shard_of(self, docid: int) -> int:
        """The shard serving a global docid."""
        return int(np.searchsorted(np.asarray(self.bounds), docid,
                                   side="right")) - 1

    def __repr__(self) -> str:
        return f"ShardSpec{self.bounds}"

    @classmethod
    def derive(cls, gen: Generation, n_shards: int) -> "ShardSpec":
        """Build-derived boundaries: balance per-tile posting mass read off
        the skip tables (block first/last docids and the SKIP-chunk posting
        counts, no block decoded), then align interior cuts to whole bitmap
        tiles."""
        n_docs = gen.n_docs
        if n_shards <= 1 or n_docs <= TILE_DOCS:
            return cls((0, n_docs))
        tiles = -(-n_docs // TILE_DOCS)
        mass = np.ones(tiles, np.float64)       # smooths posting-free tiles
        for t, tp in gen.terms.items():
            nb = len(tp.blocks)
            if not nb:
                continue
            counts = np.full(nb, SKIP, np.float64)
            counts[-1] = tp.df - SKIP * (nb - 1)
            firsts = gen.block_firsts(t).astype(np.int64)
            lasts = gen.block_lasts(t).astype(np.int64)
            mid = np.minimum((firsts + lasts) // 2 // TILE_DOCS, tiles - 1)
            np.add.at(mass, mid, counts)
        cuts = balanced_range_bounds(mass, n_shards)
        bounds = [0]
        for c in cuts[1:-1]:
            bounds.append(max(bounds[-1], min(c * TILE_DOCS, n_docs)))
        bounds.append(n_docs)
        return cls(bounds)


def shard_generation(gen: Generation, lo: int, hi: int) -> Generation:
    """One shard of ``gen``: a self-contained Generation over the local
    docid space [0, hi - lo), statistics fixed up to the parent's (module
    docstring).  ``hi > lo`` is required: empty ranges get no generation."""
    if not 0 <= lo < hi <= gen.n_docs:
        raise ValueError(f"bad shard range [{lo}, {hi}) for n_docs={gen.n_docs}")
    sub_post: dict = {}
    for t in gen.terms:
        ids, tfs = gen.decode_term(t, min_docid=lo)
        m = (ids >= lo) & (ids < hi)
        if not m.any():
            continue
        sub_post[t] = ((ids[m] - np.uint32(lo)).astype(np.uint32),
                       tfs[m].astype(np.uint32))
    sub_dl = np.asarray(gen.doclen)[lo:hi]
    sg = Generation.build(sub_dl, sub_post, codec=gen.codec, gid=gen.gid)
    # parent-statistics fixup: global df, block maxima at global statistics,
    # and the quantizer pins ScoreArena reads
    n_docs, avdl = gen.n_docs, gen.avdl
    gmax = 0.0
    for t in gen.terms:
        gmax = max(gmax, float(gen.impact_block_max(t).max(initial=0.0)))
    for t, (ids, tfs) in sub_post.items():
        tp = sg.terms[t]
        gdf = gen.terms[t].df
        bmax = []
        for i in range(0, len(ids), SKIP):
            sc = bm25_scores(tfs[i:i + SKIP], sub_dl[ids[i:i + SKIP]], gdf,
                             n_docs, avdl)
            bmax.append(float(sc.max(initial=0.0)))
        tp.df = gdf
        tp.impact_bmax = np.asarray(bmax, np.float64)
    sg.stat_n_docs = n_docs
    sg.stat_avdl = avdl
    sg.stat_gmax = gmax
    sg.doc_lo, sg.doc_hi = int(lo), int(hi)
    return sg
