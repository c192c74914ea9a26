"""Quantized impact score arenas: BM25 impacts as a device-resident column.

Counterpart of the JAX package's ``index/scores.py``, whose module docstring
states the quantization-rank parity contract this path relies on.  In
short:

  * one global scale ``delta = global_max_impact / 255`` and ``code =
    floor(impact / delta)`` clipped to 255: floor is monotone, so each
    stored block-max is exactly the max of the block's stored codes;
  * each block's <= 512 codes packed four to a word into a 128-word column
    (value ``i`` at word ``i % 128``, bits ``8 * (i // 128)``), the columns
    stacked into one (S, 128) int32 tensor aligned with the block slots;
  * per (term, block) the max code, per term the max code and its top
    :data:`TOP_TABLE` codes, per term the max code of each docid stripe;
  * a doc with quantized sum ``C`` over ``m`` term occurrences scores
    ``C * delta <= S < (C + m) * delta``, so the candidates ``{C >= theta -
    m}`` (theta the k-th largest sum) are a superset of the float top-k,
    which the exact float rescore then ranks bit for bit.

Every table is computed from one generation's corpus statistics.  Under a
mutation epoch the engine keeps them: a tombstone-only epoch re-arms the
theta cut through a Q16.16 idf-ratio deflation and
:meth:`ScoreArena.theta0_live`; a delta-bearing epoch disarms it and lets
the exact float rescore rank.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.bits import from_np
from ..core.codec import ARENA_BLOCK, ArenaColumn
from ..core.codec import get as codec_get
from ..kernels.intersect_rounds import bitmap_geometry
from ..kernels.topk import unpack_codes
from .device import resolve_device
from .segments import dead_hits

K1, B = 1.2, 0.75

CODE_MAX = 255                    # u8 quantization ceiling
TOP_TABLE = 32                    # per-term top-impact codes kept for theta0
SCORE_WORDS = ARENA_BLOCK // 4    # 512 codes packed four-per-word
STRIPE_TARGET = 512               # docid stripes per index for range bounds
STRIPE_MIN = 32                   # smallest stripe width (docids)

# the score stream under the padded-column contract of the codec arenas
SCORE_COLUMN = ArenaColumn("scores", SCORE_WORDS, dtype=np.uint32)


# --------------------------------------------------------------------------- #
# shared float BM25 (the exact oracle: one formula for every path)
# --------------------------------------------------------------------------- #


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


# --------------------------------------------------------------------------- #
# the quantized score arena
# --------------------------------------------------------------------------- #


def _unpack_rows(tiles: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """Gather + unpack packed score words: (P,) int32 slots -> (P, 512)
    int32 codes (value i of a block at word i % 128, bits 8 * (i // 128));
    kernel B3, one row per entry."""
    return unpack_codes(tiles, slots).reshape(slots.shape[0], -1)


def unpack_words_np(words: np.ndarray, n: int) -> np.ndarray:
    """Host-side unpack of one block's packed score words (tests)."""
    w = np.asarray(words, np.uint32)
    out = np.stack([(w >> np.uint32(8 * r)) & np.uint32(0xFF)
                    for r in range(4)]).reshape(-1)
    return out[:n]


class ScoreArena:
    """Device-resident quantized impact scores for one generation, on
    ``device``: the card unless the caller names another (``"cpu"``); with
    no card the default raises, as ``DeviceArena``'s does.

    tiles:     (S, 128) int32 tensor; slot s holds block s's packed codes.
    block_max: (S,) int32 numpy, the max code per slot.
    slot:      {(term, block) -> s}; a term's slots are contiguous.
    term_max:  {term -> int} max code over the term.
    term_tops: {term -> int32[<= TOP_TABLE]} top codes, descending.
    term_top_ids: {term -> uint32[...]} the docids carrying those codes (code
               ties by ascending docid).
    dense_slot / dense_w0 / dense_tiles: blocks whose docid stream is stored
               as a bitmap (the codec declares ``ArenaLayout.bitmap_words``
               and the block is in bitmap format) also get a window-aligned
               code tile: (D, 1024) int32, window position p (docid
               ``w0 * 32 + p``) at byte p & 3 of word p >> 2.  ``w0``
               follows the device arena's 4-word-aligned clamp.
    stripes:   {term -> int32[n_stripes]} max code per docid stripe of
               ``stripe_width`` docids, the range bound of block-max
               pruning.
    delta:     the quantization scale (global max impact / 255).
    """

    def __init__(self, idx, device="cuda"):
        device = resolve_device(device)
        self.idx = idx
        n_docs = idx.n_docs
        doclen = np.asarray(idx.doclen)
        # doc-range shard generations pin the parent's statistics (kept as
        # in the reference; the port has no shards yet, step A.10)
        stat_n = int(getattr(idx, "stat_n_docs", n_docs))
        stat_avdl = float(getattr(idx, "stat_avdl", idx.avdl))
        gmax = 0.0
        for t in idx.terms:
            gmax = max(gmax, float(idx.impact_block_max(t).max(initial=0.0)))
        gmax = float(getattr(idx, "stat_gmax", gmax))
        self.gmax = gmax
        self.delta = (gmax / CODE_MAX) if gmax > 0 else 1.0
        self.stripe_width = max(STRIPE_MIN, -(-n_docs // STRIPE_TARGET))
        n_stripes = max(1, -(-n_docs // self.stripe_width))
        words_total = bitmap_geometry(n_docs)[0]
        tiles, bmax, dense_tiles, dense_w0 = [], [], [], []
        n_slots = 0
        self.slot: dict = {}
        self.dense_slot: dict = {}
        self.term_max: dict = {}
        self.term_tops: dict = {}
        self.term_top_ids: dict = {}
        self.stripes: dict = {}
        for t, tp in idx.terms.items():
            nb = len(tp.blocks)
            blocks = [idx.decode_block(t, bi) for bi in range(nb)]
            ids_cat = (np.concatenate([b[0] for b in blocks]) if nb
                       else np.zeros(0, np.uint32))
            tfs_cat = (np.concatenate([b[1] for b in blocks]) if nb
                       else np.zeros(0, np.uint32))
            # element-wise, so each float equals the reference's per-block
            # computation bit for bit
            sc = bm25_scores(tfs_cat, doclen[ids_cat], tp.df, stat_n,
                             stat_avdl)
            cat = np.minimum(np.floor(sc / self.delta),
                             CODE_MAX).astype(np.uint32)
            # per block: codes at value i -> word i % 128, byte i // 128
            padded = np.zeros((nb, ARENA_BLOCK), np.uint32)
            start = 0
            for bi, (ids, _) in enumerate(blocks):
                codes = cat[start:start + len(ids)]
                padded[bi, :len(ids)] = codes
                self.slot[(t, bi)] = n_slots + bi
                bmax.append(int(codes.max(initial=0)))
                encg = tp.blocks[bi][1]
                lay = codec_get(encg.codec).arena
                if (lay is not None and lay.bitmap_words
                        and lay.is_bitmap is not None and lay.is_bitmap(encg)):
                    bw = lay.bitmap_words
                    w0 = min((int(ids[0]) >> 5) & ~3, words_total - bw)
                    pos = ids.astype(np.int64) - w0 * 32
                    tile = np.zeros(bw * 8, np.uint32)     # bw*32 / 4 words
                    # byte p of the little-endian words is position p
                    tile.view(np.uint8)[pos] = codes
                    self.dense_slot[(t, bi)] = len(dense_tiles)
                    dense_tiles.append(tile)
                    dense_w0.append(w0)
                start += len(ids)
            quads = padded.reshape(nb, 4, SCORE_WORDS)
            tiles.append(quads[:, 0] | (quads[:, 1] << 8)
                         | (quads[:, 2] << 16) | (quads[:, 3] << 24))
            n_slots += nb
            stripe = np.zeros(n_stripes, np.int32)
            np.maximum.at(stripe, ids_cat // self.stripe_width,
                          cat.astype(np.int32))
            self.term_max[t] = int(cat.max(initial=0))
            order = np.lexsort((ids_cat, -cat.astype(np.int64)))[:TOP_TABLE]
            self.term_tops[t] = cat[order].astype(np.int32)
            self.term_top_ids[t] = ids_cat[order].astype(np.uint32)
            self.stripes[t] = stripe
        self.block_max = np.asarray(bmax, np.int32)
        self.tiles = from_np(np.concatenate(tiles) if n_slots
                             else np.zeros((1, SCORE_WORDS), np.uint32), device)
        self.dense_w0 = np.asarray(dense_w0, np.int32)
        self.dense_tiles = (from_np(np.stack(dense_tiles), device)
                            if dense_tiles else None)

    @classmethod
    def from_index(cls, idx, device="cuda") -> "ScoreArena":
        return cls(idx, device=device)

    # ---- device decode ------------------------------------------------------ #

    def rows(self, pairs: list) -> torch.Tensor:
        """Decode a work-list of (term, block) score entries without a host
        copy: (len(pairs), 512) int32 code rows, zero past each block's
        posting count (the packing zero-pads)."""
        slots = torch.as_tensor([self.slot[p] for p in pairs],
                                dtype=torch.int32, device=self.tiles.device)
        return _unpack_rows(self.tiles, slots)

    # ---- WAND metadata ------------------------------------------------------ #

    def theta0(self, terms: list, k: int) -> int:
        """Static per-query threshold: the k-th top impact code of the
        query's strongest term (k docs of that term provably reach it, so it
        lower-bounds the k-th best total).  0 when no term has k postings or
        k > TOP_TABLE."""
        best = 0
        for t in terms:
            tops = self.term_tops.get(t)
            if tops is not None and k <= len(tops):
                best = max(best, int(tops[k - 1]))
        return best

    def theta0_live(self, terms: list, k: int, dead: np.ndarray) -> int:
        """:meth:`theta0` for a tombstone-only epoch (``dead``: its sorted
        int64 tombstoned docids): tombstoned entries leave the per-term
        top-code table (``term_top_ids``) before the k-th survivor is
        taken, so the k docs backing the bound are all live.
        Sound, and weaker than a rebuild's table where more than ``TOP_TABLE
        - k`` of a term's top codes are dead (that term then gives 0)."""
        if len(dead) == 0:
            return self.theta0(terms, k)
        best = 0
        for t in terms:
            tops = self.term_tops.get(t)
            if tops is None or not len(tops):
                continue
            alive = tops[~dead_hits(dead, self.term_top_ids[t])]
            if k <= len(alive):
                best = max(best, int(alive[k - 1]))
        return best

    def range_max(self, t: int, lo: int, hi: int) -> int:
        """Max code of term t over the docid range [lo, hi], from the stripe
        table: 0 when the term has no posting in any stripe it touches."""
        stripe = self.stripes[t]
        j0 = lo // self.stripe_width
        j1 = hi // self.stripe_width + 1
        return int(stripe[j0:j1].max(initial=0))

    def range_max_many(self, t: int, los: np.ndarray,
                       his: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`range_max` over per-block [lo, hi] ranges:
        segment maxima via ``np.maximum.reduceat`` over the stripe table."""
        if len(los) == 0:
            return np.zeros(0, np.int64)
        j0 = np.asarray(los) // self.stripe_width
        j1 = np.asarray(his) // self.stripe_width + 1
        # the sentinel keeps every reduceat index in range (j1 can equal the
        # stripe count); a [j0, j1) segment never reaches it since j1 > j0
        ext = np.append(self.stripes[t], np.int32(0))
        idx = np.empty(2 * len(j0), np.int64)
        idx[0::2] = j0
        idx[1::2] = j1
        return np.maximum.reduceat(ext, idx)[0::2].astype(np.int64)
