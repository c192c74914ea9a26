"""Compressed inverted index (paper §7.4/§7.5), an LSM handle over immutable
compressed **generations** (counterpart of the JAX package's
``index/invindex.py``; the host side is the same numpy code).

:class:`Generation` is the paper's one-shot index made explicit as an
immutable segment: per term, d-gapped docids + TFs compressed with a selected
codec from the ``repro_torch.core.codec`` registry (any
:class:`repro_torch.core.codec.Codec`); posting lists shorter than 64 fall back to
Stream VByte (the §7.5 VByte fallback upgraded to a separated-control layout
that decodes branch-free).  Block-level skip pointers every 512 postings
(first docid + compressed blocks) support AND-query skipping without decoding
whole lists.  The block is also the unit of the batched query engine
(``repro_torch.index.engine``): ``decode_block`` decompresses exactly one block,
and ``block_firsts`` exposes the skip table so the engine can prune blocks by
candidate docid range *before* any decompression happens.  Once built, a
generation's blocks, skip tables, impact tables, and device arenas never
change — caches and in-flight execution plans key on its ``gid``.

:class:`InvertedIndex` is the mutable handle serving reads while absorbing
writes, LSM-style (``repro_torch.index.segments``):

  * ``insert(docid, terms, doclen)`` lands in a small host-side
    :class:`~repro_torch.index.segments.DeltaSegment`; inserting a docid the
    current generation holds tombstones the base copy first (shadowing), so
    generation and delta stay disjoint per doc.
  * ``delete(docid)`` drops the delta copy or adds a
    :class:`~repro_torch.index.segments.Tombstones` entry for the base copy —
    served as a live-bitmap gate on every probe, never by touching blocks.
  * ``compact()`` re-encodes the merged live postings (generation minus
    tombstones, plus delta) through the same codec registry into the next
    generation (``gid + 1``) — the short-list fallback is re-evaluated per
    term — and atomically swaps it in; delta, tombstones, and doclen
    overrides reset to empty.

Query results under mutation are the union of generation results (tombstone
-gated) and a brute-force scan of the small delta segment, bitwise identical
to rebuilding from scratch with ``InvertedIndex.build(doclen_now(),
live_postings)``.

An index built elsewhere (the JAX package's, for one) is carried across as
plain numpy arrays: :meth:`InvertedIndex.from_state` takes per term its df,
block firsts and lasts, impact block-maxima and each block's ``Encoded``
fields, and serves the same compressed bytes.  Docid
space is append-only: deleting never shrinks ``doc_space`` and a deleted
doc's last doclen stays in ``doclen_now()`` (exactly what a from-scratch
rebuild would be given).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import codec as codec_lib
from ..core.dgap import dgap_decode_np, dgap_encode_np
from ..core.encoded import Encoded
from .segments import DeltaSegment, Tombstones, dead_hits

SKIP = 512
SHORT = 64
SHORT_CODEC = "stream_vbyte"

_EMPTY_POSTINGS = (np.zeros(0, np.uint32), np.zeros(0, np.uint32))


@dataclasses.dataclass
class TermPostings:
    df: int
    blocks: list                   # list of (first_docid, enc_gaps, enc_tfs)
    lasts: np.ndarray = None       # last docid per block (skip upper bounds)
    impact_bmax: np.ndarray = None  # max float BM25 impact per block (WAND)

    def nbytes(self) -> int:
        # + 4 per block for the last-docid column next to the skip pointer
        return sum(g.nbytes() + t.nbytes() for _, g, t in self.blocks) + 12 * len(self.blocks)


class Generation:
    """One immutable compressed index segment.

    Everything the serving paths consume — compressed blocks, skip tables,
    WAND impact tables, the cached device arena — hangs off a generation and
    is identified by its ``gid``; ``compact()`` builds the next generation
    instead of editing this one, so plans pinned to it keep executing
    bit-identically while the handle swaps forward.
    """

    def __init__(self, codec: str, terms: dict, n_docs: int,
                 doclen: np.ndarray, gid: int = 0):
        self.codec = codec
        self.terms = terms
        self.n_docs = n_docs
        self.doclen = doclen
        self.gid = gid

    @property
    def avdl(self) -> float:
        """Mean document length — THE value every BM25 site uses (scorer,
        quantizer, rescore): one cached implementation so their floats
        cannot drift apart."""
        a = getattr(self, "_avdl", None)
        if a is None:
            a = float(np.asarray(self.doclen).mean()) if self.n_docs else 1.0
            self._avdl = a
        return a

    @staticmethod
    def build(doclen: np.ndarray, postings: dict,
              codec: str = "group_simple", gid: int = 0) -> "Generation":
        from ..core import dense_bitmap   # the density policy lives there
        from .scores import bm25_scores   # local: scores sits above invindex
        spec = codec_lib.get(codec)
        short = codec_lib.get(SHORT_CODEC)
        dense = codec_lib.get(dense_bitmap.NAME)
        doclen = np.asarray(doclen)
        n_docs = len(doclen)
        # built empty-first so the impact tables read the one cached avdl
        gen = Generation(codec, {}, n_docs, doclen, gid)
        avdl = gen.avdl
        terms = gen.terms
        for t, (docids, tfs) in postings.items():
            base = spec if len(docids) >= SHORT else short
            blocks, lasts, bmax = [], [], []
            for i in range(0, len(docids), SKIP):
                ids = docids[i:i + SKIP]
                # density decision, per block at build time: past the cutoff
                # the docid stream is stored as a raw 128-word bitmap and
                # served word-parallel; everything downstream discovers the
                # choice through the registry (the Encoded names its codec)
                use = dense if dense_bitmap.eligible(ids) else base
                gaps = dgap_encode_np(ids)
                gaps = gaps.copy()
                gaps[0] = 0                      # first docid kept in the skip entry
                # TFs are not a sorted docid stream: always the base codec
                blocks.append((int(ids[0]), use.encode(gaps), base.encode(tfs[i:i + SKIP])))
                lasts.append(int(ids[-1]))
                # WAND block-max metadata, from the raw postings (no decode)
                sc = bm25_scores(tfs[i:i + SKIP], doclen[ids], len(docids),
                                 n_docs, avdl)
                bmax.append(float(sc.max(initial=0.0)))
            terms[t] = TermPostings(len(docids), blocks,
                                    np.asarray(lasts, np.int64),
                                    np.asarray(bmax, np.float64))
        return gen

    def to_device(self, build_fused: bool = True, device="cuda"):
        """Flatten the compressed blocks into device-resident arenas on the
        torch ``device`` (``repro_torch.index.device.DeviceArena``); cached
        per generation and device after the first call.  A cached arena built
        without fused tiles is upgraded in place when ``build_fused=True``
        asks for them later."""
        from .device import DeviceArena, resolve_device
        device = resolve_device(device)
        arenas = self.__dict__.setdefault("_arenas", {})
        arena = arenas.get(device)
        if arena is None:
            arena = DeviceArena.from_index(self, build_fused=build_fused,
                                           device=device)
            arenas[device] = arena
        elif build_fused:
            arena.ensure_fused()
        return arena

    def n_blocks(self, t: int) -> int:
        return len(self.terms[t].blocks)

    def block_firsts(self, t: int) -> np.ndarray:
        """Skip table: first docid of each block of term t (ascending)."""
        return np.asarray([b[0] for b in self.terms[t].blocks], np.int64)

    def block_lasts(self, t: int) -> np.ndarray:
        """Skip upper bounds: last docid of each block of term t.  Stored at
        build time; reconstructed once (and cached) for indexes whose blocks
        were assembled by hand."""
        tp = self.terms[t]
        if tp.lasts is None or len(tp.lasts) != len(tp.blocks):
            tp.lasts = np.asarray(
                [int(self.decode_block_ids(t, bi)[-1])
                 for bi in range(len(tp.blocks))], np.int64)
        return tp.lasts

    def impact_block_max(self, t: int) -> np.ndarray:
        """WAND metadata: max float BM25 impact per block of term t.  Stored
        at build time (computed from the raw postings); reconstructed once
        (and cached) from a decode pass for hand-assembled indexes."""
        tp = self.terms[t]
        if tp.impact_bmax is None or len(tp.impact_bmax) != len(tp.blocks):
            from .scores import bm25_scores
            doclen = np.asarray(self.doclen)
            out = []
            for bi in range(len(tp.blocks)):
                ids, tfs = self.decode_block(t, bi)
                sc = bm25_scores(tfs, doclen[ids], tp.df, self.n_docs,
                                 self.avdl)
                out.append(float(sc.max(initial=0.0)))
            tp.impact_bmax = np.asarray(out, np.float64)
        return tp.impact_bmax

    def decode_block_ids(self, t: int, bi: int) -> np.ndarray:
        """Decompress only the docids of one block (AND queries skip TFs)."""
        first, encg, _ = self.terms[t].blocks[bi]
        gaps = codec_lib.get(encg.codec).decode_np(encg)
        return dgap_decode_np(gaps) + np.uint32(first)

    def decode_block_tfs(self, t: int, bi: int) -> np.ndarray:
        _, _, enct = self.terms[t].blocks[bi]
        return codec_lib.get(enct.codec).decode_np(enct)

    def decode_block(self, t: int, bi: int):
        """Decompress exactly one posting block -> (docids, tfs)."""
        return self.decode_block_ids(t, bi), self.decode_block_tfs(t, bi)

    def decode_term(self, t: int, min_docid: int = 0):
        """Decode postings, skipping blocks entirely below min_docid."""
        tp = self.terms[t]
        ids_out, tf_out = [], []
        for bi in range(len(tp.blocks)):
            nxt = tp.blocks[bi + 1][0] if bi + 1 < len(tp.blocks) else None
            if nxt is not None and nxt <= min_docid:
                continue                         # skip pointer: whole block below
            ids, tfs = self.decode_block(t, bi)
            ids_out.append(ids)
            tf_out.append(tfs)
        if not ids_out:
            return _EMPTY_POSTINGS
        return np.concatenate(ids_out), np.concatenate(tf_out)

    def size_bytes(self) -> int:
        return sum(tp.nbytes() for tp in self.terms.values())


class InvertedIndex:
    """Mutable LSM handle over one current :class:`Generation`.

    Reads delegate to the current generation (``codec`` / ``terms`` /
    ``decode_block`` / ``to_device`` / … keep their one-shot semantics, so
    the entire pre-mutation surface is unchanged); writes go to ``delta`` /
    ``tomb`` (see the module docstring for the lifecycle).  ``epoch`` is the
    mutation clock callers key caches and plan snapshots on.
    """

    def __init__(self, codec: str = "group_simple", terms: dict | None = None,
                 n_docs: int = 0, doclen: np.ndarray | None = None, *,
                 gen: Generation | None = None):
        if gen is None:
            doclen = (np.asarray(doclen) if doclen is not None
                      else np.zeros(n_docs, np.int64))
            gen = Generation(codec, {} if terms is None else terms,
                             n_docs, doclen)
        self._gen = gen
        self.delta = DeltaSegment()
        self.tomb = Tombstones()
        self._dl_over: dict = {}     # docid -> last-set doclen, cleared at compact
        self._dl_cache = None        # (delta.version, doclen_now array)

    @staticmethod
    def build(doclen: np.ndarray, postings: dict,
              codec: str = "group_simple") -> "InvertedIndex":
        return InvertedIndex(gen=Generation.build(doclen, postings, codec))

    @staticmethod
    def from_state(state: dict) -> "InvertedIndex":
        """An index serving compressed blocks handed over as plain arrays.

        ``state`` holds ``codec`` (the long-list codec name), ``doclen``
        (int64 per doc) and ``terms``: term -> dict with ``df``, ``firsts``
        and ``lasts`` (int64 per block), ``impact_bmax`` (float64 per block)
        and ``gaps`` / ``tfs``, one dict per block of the ``Encoded`` fields
        (``codec``, ``n``, ``control``, ``data``, the bit counts,
        ``exceptions`` and ``meta``).  Every block's codec must be
        registered here; the words are served as given, not re-encoded.
        """
        doclen = np.asarray(state["doclen"], np.int64)
        terms = {}
        for t, ts in state["terms"].items():
            firsts = np.asarray(ts["firsts"], np.int64)
            gaps = [_encoded_from_state(e) for e in ts["gaps"]]
            tfs = [_encoded_from_state(e) for e in ts["tfs"]]
            if not len(firsts) == len(gaps) == len(tfs):
                raise ValueError(f"term {t}: {len(firsts)} firsts, "
                                 f"{len(gaps)} gap and {len(tfs)} tf blocks")
            terms[int(t)] = TermPostings(
                int(ts["df"]),
                [(int(f), g, tf) for f, g, tf in zip(firsts, gaps, tfs)],
                np.asarray(ts["lasts"], np.int64),
                np.asarray(ts["impact_bmax"], np.float64))
        codec_lib.get(state["codec"])           # unknown names raise here
        return InvertedIndex(gen=Generation(state["codec"], terms,
                                            len(doclen), doclen,
                                            int(state.get("gid", 0))))

    # ---- the immutable read surface (delegated to the current generation) --- #

    @property
    def gen(self) -> Generation:
        return self._gen

    @property
    def codec(self) -> str:
        return self._gen.codec

    @property
    def terms(self) -> dict:
        return self._gen.terms

    @property
    def n_docs(self) -> int:
        """Docs in the current generation (the device bitmap geometry); the
        mutable doc space including delta-only docids is ``doc_space``."""
        return self._gen.n_docs

    @property
    def doclen(self) -> np.ndarray:
        """The current generation's doclen column; the live view including
        delta inserts and doclen overrides is ``doclen_now()``."""
        return self._gen.doclen

    @property
    def avdl(self) -> float:
        return self._gen.avdl

    def to_device(self, build_fused: bool = True, device="cuda"):
        return self._gen.to_device(build_fused=build_fused, device=device)

    def n_blocks(self, t: int) -> int:
        return self._gen.n_blocks(t)

    def block_firsts(self, t: int) -> np.ndarray:
        return self._gen.block_firsts(t)

    def block_lasts(self, t: int) -> np.ndarray:
        return self._gen.block_lasts(t)

    def impact_block_max(self, t: int) -> np.ndarray:
        return self._gen.impact_block_max(t)

    def decode_block_ids(self, t: int, bi: int) -> np.ndarray:
        return self._gen.decode_block_ids(t, bi)

    def decode_block_tfs(self, t: int, bi: int) -> np.ndarray:
        return self._gen.decode_block_tfs(t, bi)

    def decode_block(self, t: int, bi: int):
        return self._gen.decode_block(t, bi)

    def decode_term(self, t: int, min_docid: int = 0):
        return self._gen.decode_term(t, min_docid)

    def size_bytes(self) -> int:
        return self._gen.size_bytes()

    # ---- mutation ----------------------------------------------------------- #

    @property
    def mutated(self) -> bool:
        """True when serving must consult delta/tombstone state (i.e. the
        handle has diverged from its current generation)."""
        return bool(self.tomb) or bool(self.delta) or bool(self._dl_over)

    @property
    def epoch(self) -> tuple:
        """(gid, tombstone version, delta version) — changes on every
        mutation and every compaction; cache keys and plan snapshots carry
        it so no state from one epoch can serve another."""
        return (self._gen.gid, self.tomb.version, self.delta.version)

    @property
    def doc_space(self) -> int:
        """Size of the append-only docid space: generation docs plus every
        docid ever inserted since (deletes never shrink it)."""
        return max(self._gen.n_docs, max(self._dl_over, default=-1) + 1)

    def insert(self, docid: int, terms: dict, doclen: int) -> None:
        """Insert (or upsert) one document into the delta segment.  A docid
        the current generation holds is tombstoned first, so its base
        postings are shadowed and the generation/delta doc sets stay
        disjoint."""
        self.delta.insert(docid, terms, doclen)      # validates its inputs
        docid = int(docid)
        if docid < self._gen.n_docs:
            self.tomb.add(docid)
        self._dl_over[docid] = int(doclen)

    def delete(self, docid: int) -> bool:
        """Delete one document; True if it was live.  Delta copies are
        dropped outright; base copies become tombstones (their blocks are
        immutable — serving gates them out instead)."""
        docid = int(docid)
        if self.delta.remove(docid):
            return True
        if docid < self._gen.n_docs and docid not in self.tomb:
            self.tomb.add(docid)
            return True
        return False

    def doclen_now(self) -> np.ndarray:
        """Frozen int64 doclen over [0, doc_space): the generation column
        extended by every doclen override since (inserts win; deleted docs
        keep their last-set length; never-inserted slots past the generation
        are 0) — exactly the array a from-scratch rebuild would be given."""
        if not self.mutated:
            return self._gen.doclen
        if self._dl_cache is not None and self._dl_cache[0] == self.delta.version:
            return self._dl_cache[1]
        g = self._gen
        dl = np.zeros(self.doc_space, np.int64)
        dl[:g.n_docs] = np.asarray(g.doclen)
        if self._dl_over:
            k = np.fromiter(self._dl_over.keys(), np.int64, len(self._dl_over))
            v = np.fromiter(self._dl_over.values(), np.int64, len(self._dl_over))
            dl[k] = v
        dl.setflags(write=False)
        self._dl_cache = (self.delta.version, dl)
        return dl

    def compact(self) -> Generation:
        """Merge generation-minus-tombstones with the delta segment and
        re-encode through the codec registry into the next generation
        (``gid + 1``), atomically swapped in; delta/tombstone state resets.

        The merge is the rebuild contract made literal: per term, the
        generation's live postings (tombstoned docids dropped via the skip
        -aware decode) and the delta postings — disjoint by the shadowing
        invariant — are merge-sorted and handed to :meth:`Generation.build`
        with ``doclen_now()``.  Terms with zero live postings are dropped,
        and the short-list codec fallback is re-decided per term from the
        merged length.  Returns the new generation.
        """
        g = self._gen
        new_doclen = np.array(self.doclen_now())         # unfrozen copy
        dead = self.tomb.sorted_ids(below=g.n_docs)
        all_terms = set(g.terms)
        for _, (_, ts) in self.delta.items():
            all_terms.update(ts)
        merged = {}
        for t in sorted(all_terms):
            if t in g.terms:
                ids, tfs = g.decode_term(t)
                if len(dead) and len(ids):
                    keep = ~dead_hits(dead, ids)
                    ids, tfs = ids[keep], tfs[keep]
            else:
                ids, tfs = _EMPTY_POSTINGS
            dids, dtfs = self.delta.postings(t)
            if len(dids):
                ids = np.concatenate([ids, dids])
                tfs = np.concatenate([tfs, dtfs])
                order = np.argsort(ids, kind="stable")
                ids, tfs = ids[order], tfs[order]
            if len(ids):
                merged[t] = (ids.astype(np.uint32), tfs.astype(np.uint32))
        self._gen = Generation.build(new_doclen, merged, codec=g.codec,
                                     gid=g.gid + 1)
        self.delta = DeltaSegment()
        self.tomb = Tombstones()
        self._dl_over = {}
        self._dl_cache = None
        return self._gen


_ENCODED_FIELDS = ("codec", "n", "control", "data", "control_bits",
                   "data_bits", "exceptions", "exception_bits",
                   "header_bits", "meta")


def _encoded_from_state(e: dict) -> Encoded:
    """One block's ``Encoded`` from its plain fields (codec checked against
    the registry, so a block this port cannot decode is refused up front)."""
    codec_lib.get(e["codec"])
    kw = {k: e[k] for k in _ENCODED_FIELDS if k in e}
    kw["n"] = int(kw["n"])
    kw["meta"] = dict(kw.get("meta") or {})
    return Encoded(**kw)
