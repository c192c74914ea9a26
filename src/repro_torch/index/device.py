"""Device-resident posting arenas: the compressed index as contiguous torch
tensors on the card, decodable in bulk without host round-trips.

Counterpart of the JAX package's ``index/device.py``.  A ``DeviceArena``
flattens the whole index once, generically: any codec whose registry entry
declares an :class:`~repro_torch.core.codec.ArenaLayout` participates.  Per
layout it holds one int32 tensor per declared column (every block's words
concatenated) and per-entry tables (offset/length per column, posting count,
first docid).

On top sit the batched paths:

  * ``decode_blocks`` / ``decode_blocks_device``: one batched torch decode
    per codec present in the work-list (each lane gathers its padded column
    slices and runs the layout's ``decode_block``, fused with the d-gap
    prefix sum and first-docid add).  Work-lists run at their exact length:
    eager torch has no compile cache that padding to fixed sizes would
    serve.
  * ``fused_and`` / ``fused_round``: every block's gaps re-packed into fixed
    (rows, 128) tiles at its bit width rounded up to
    ``decode_fused.BW_BUCKETS``, decoded *and* probed by the CUDA kernels B5
    (one shared bitmap) and B1 (one bitmap segment per query).
  * ``ensure_scores`` / ``fused_round_scored``: the quantized score column
    (``index/scores.py``) beside the blocks; the ranked fused rounds unpack
    it with kernel B3 on the same slots B1 decodes.

``stats`` counts calls and blocks per path.  An arena belongs to one
immutable generation and one torch device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import codec as codec_lib
from ..core.bits import cumsum_u32, ebw_np, from_np, i32, to_np, u32
from ..kernels import decode_fused, intersect_rounds, topk
from ..kernels.bitpack import LANES
from ..kernels.intersect import bitmap_build_np
from ..obs.trace import get_tracer

# rows a work-list decode hands the codec's ``decode_block`` at once: the
# batched decoders make several (rows, 512) int64 tensors (Group-PFD's
# patch lanes among them), so a round's 0.4-0.8 M entries decode in fixed
# chunks of at most this many rows, each chunk's words written into the
# one output tensor
DECODE_CHUNK_ROWS = 1 << 16


def resolve_device(device="cuda") -> torch.device:
    """The torch device an entry point runs on.  ``"cuda"`` with no card
    raises: nothing falls back to the CPU, which a caller asks for by name."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "torch_device='cuda' asked for, but torch sees no CUDA device;"
                " pass torch_device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """Host column -> device tensor (uint32 words as int32 bit patterns)."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        return from_np(a, device)
    return torch.as_tensor(a, device=device)


def _decode_worklist(arenas, offs, lens, n, first, is_delta, *, decode,
                     widths):
    """Work-list decode over one codec's column arenas, one row per block:
    gather one padded fixed-width slice per column, call the layout's
    batched ``decode(*slices, *lens, n_valid)``, and for docid rows fuse the
    prefix sum (mod 2**32) and first-docid add, zero past ``n``."""
    dev = arenas[0].device
    cols = tuple(a[o.long()[:, None] + torch.arange(wd, device=dev)]
                 for a, o, wd in zip(arenas, offs, widths))
    vals = decode(*cols, *lens, n)
    ids = i32(cumsum_u32(vals, dim=1) + u32(first)[:, None])
    i = torch.arange(vals.shape[1], device=dev)
    ids = torch.where(i[None, :] < n.long()[:, None], ids, 0)
    return torch.where(is_delta[:, None], ids, vals)


class _ArenaGroup:
    """Per-codec contiguous column arenas + per-entry tables, built from the
    codec's declared :class:`~repro_torch.core.codec.ArenaColumn` tuple."""

    def __init__(self, name: str, layout):
        self.name = name
        self.layout = layout
        k = len(layout.columns)
        self._parts: list = [[] for _ in range(k)]
        self._off = [0] * k
        self.offs: list = [[] for _ in range(k)]
        self.lens: list = [[] for _ in range(k)]
        self.tab: dict = {"n": [], "first": []}

    def add(self, enc, first: int) -> int:
        lay = self.layout
        if enc.n > lay.max_n:
            raise ValueError(f"{self.name}: block of {enc.n} > {lay.max_n}")
        slot = len(self.tab["n"])
        for c, col in enumerate(lay.columns):
            w = np.asarray(col.extract(enc), col.dtype).reshape(-1)
            if w.size > col.width:
                raise ValueError(f"{self.name}/{col.name}: {w.size} words "
                                 f"> declared width {col.width}")
            self._parts[c].append(w)
            self.offs[c].append(self._off[c])
            self.lens[c].append(w.size)
            self._off[c] += w.size
        self.tab["n"].append(enc.n)
        self.tab["first"].append(first)
        return slot

    def finalize(self, device) -> "_ArenaGroup":
        # trailing slack so the fixed-size slice gathers stay in bounds
        self.arenas = tuple(
            _to_device(np.concatenate(parts + [np.zeros(col.width, col.dtype)])
                       .view(np.int32), device)
            for parts, col in zip(self._parts, self.layout.columns))
        self.offs = [np.asarray(o, np.int32) for o in self.offs]
        self.lens = [np.asarray(v, np.int32) for v in self.lens]
        self.tab = {k: np.asarray(v, np.uint32 if k == "first" else np.int32)
                    for k, v in self.tab.items()}
        self._parts = None
        return self

    def _run(self, slots: np.ndarray, delta: np.ndarray):
        """One batched decode of ``slots``: the (len(slots), out_width)
        device tensor (docid rows with the prefix sum + first docid fused
        in, zero past their n), plus the per-slot posting counts."""
        dev = self.arenas[0].device
        ns = self.tab["n"][slots]
        offs = [_to_device(o[slots], dev) for o in self.offs]
        lens = [_to_device(v[slots], dev) for v in self.lens]
        n_t, first_t, delta_t = (_to_device(c, dev) for c in
                                 (ns, self.tab["first"][slots], delta))
        widths = tuple(col.width for col in self.layout.columns)
        res = torch.empty((len(slots), self.layout.out_width),
                          dtype=torch.int32, device=dev)
        for a in range(0, len(slots), DECODE_CHUNK_ROWS):
            b = a + DECODE_CHUNK_ROWS
            res[a:b] = _decode_worklist(
                self.arenas, [o[a:b] for o in offs], [v[a:b] for v in lens],
                n_t[a:b], first_t[a:b], delta_t[a:b],
                decode=self.layout.decode_block, widths=widths)
        return res, ns

    def decode(self, items: list, out: list) -> None:
        """Decode [(out_index, slot, (t, bi, field)), ...] in one batched
        call; field 0 entries get the prefix sum + first docid fused in."""
        slots = np.asarray([slot for _, slot, _ in items], np.int64)
        delta = np.asarray([e[2] == 0 for _, _, e in items])
        res, ns = self._run(slots, delta)
        res = to_np(res)
        for row, ((j, _, _), n) in enumerate(zip(items, ns)):
            out[j] = res[row, :n].copy()

    def decode_rows(self, slots: np.ndarray):
        """Device-resident decode: (len(slots), out_width) docid rows kept
        on device, plus per-slot posting counts."""
        return self._run(np.asarray(slots, np.int64),
                         np.ones(len(slots), bool))


class DeviceArena:
    """Flattened device-resident copy of an ``InvertedIndex`` on one torch
    device.

    Build via ``DeviceArena.from_index(idx, device=...)`` (or
    ``idx.to_device()`` / ``QueryEngine.to_device()``); decode any work-list
    of (term, block, field) entries with ``decode_blocks`` (field 0 =
    docids, 1 = TFs), or intersect a term's blocks against a candidate set
    with ``fused_and``.  Every codec registered in the port declares an
    ``ArenaLayout``; blocks without one (empty blocks) fall back to the
    numpy oracle.
    """

    def __init__(self, idx, build_fused: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self.idx = idx
        self.n_docs = idx.n_docs
        self.stats = {"device_calls": 0, "blocks_device": 0, "blocks_host": 0,
                      "fused_calls": 0, "fused_blocks": 0}
        self._loc: dict = {}
        self._groups: dict = {}
        self._build_compressed_arenas(idx)
        self._pk = None
        self.scores = None
        if build_fused:
            self.ensure_fused()

    # ---- build ------------------------------------------------------------- #

    def _build_compressed_arenas(self, idx) -> None:
        staging: dict = {}
        dense_rows, dense_w0 = [], []
        self.dense_slot: dict = {}
        words_total = intersect_rounds.bitmap_geometry(idx.n_docs)[0]
        for t, tp in idx.terms.items():
            for bi, (first, encg, enct) in enumerate(tp.blocks):
                for field, enc, fi in ((0, encg, first), (1, enct, 0)):
                    key = (t, bi, field)
                    spec = codec_lib.get(enc.codec) if enc.n else None
                    lay = spec.arena if spec is not None else None
                    if lay is None or not lay.supports(enc):
                        self._loc[key] = (None, -1)
                        continue
                    g = staging.get(enc.codec)
                    if g is None:
                        g = staging[enc.codec] = _ArenaGroup(enc.codec, lay)
                    self._loc[key] = (enc.codec, g.add(enc, fi))
                    if (field == 0 and lay.bitmap_words
                            and lay.is_bitmap is not None
                            and lay.is_bitmap(enc)):
                        # word-parallel-servable block: stage its raw bitmap
                        # window realigned to the serving bitmap geometry
                        # (first word rounded down to a 4-word phase, clamped
                        # so the window stays inside the geometry)
                        ids = first + np.cumsum(spec.decode_np(enc),
                                                dtype=np.uint64)
                        w0 = min((int(ids[0]) >> 5) & ~3,
                                 words_total - lay.bitmap_words)
                        bits = np.zeros(lay.bitmap_words * 32, np.uint8)
                        bits[(ids - np.uint64(w0 * 32)).astype(np.int64)] = 1
                        self.dense_slot[(t, bi)] = len(dense_rows)
                        dense_rows.append(np.packbits(
                            bits, bitorder="little").view(np.uint32))
                        dense_w0.append(w0)
        self._groups = {name: g.finalize(self.device)
                        for name, g in staging.items()}
        self.dense_w0 = np.asarray(dense_w0, np.int32)
        self.dense_words = (from_np(np.stack(dense_rows), self.device)
                            if dense_rows else None)

    def ensure_fused(self) -> "DeviceArena":
        """Build the fused-kernel tile arenas if absent: every block's d-gaps
        re-packed into the fixed (rows, 128) tiles the decode kernels read,
        grouped into per-bit-width buckets."""
        if self._pk is not None:
            return self
        idx = self.idx
        self._pk = {}
        self._pk_slot = {}
        self._cand_rows = intersect_rounds.bitmap_geometry(self.n_docs)[1]
        staged: dict = {bw: [] for bw in decode_fused.BW_BUCKETS}
        for t, tp in idx.terms.items():
            for bi in range(len(tp.blocks)):
                ids = idx.decode_block_ids(t, bi)
                g = np.zeros(len(ids), np.uint32)
                g[1:] = ids[1:] - ids[:-1]
                ebw = max(1, int(ebw_np(g.max(initial=0))))
                bw = next(b for b in decode_fused.BW_BUCKETS if b >= ebw)
                staged[bw].append(((t, bi), tp.blocks[bi][0], g))
        for bw, items in staged.items():
            if not items:
                continue
            rpb = decode_fused.rows_per_block(bw)
            tiles = np.zeros((len(items) * rpb, LANES), np.uint32)
            firsts, ns = [], []
            for s, (key, first, g) in enumerate(items):
                self._pk_slot[key] = (bw, s)
                firsts.append(first)
                ns.append(len(g))
                tiles[s * rpb:(s + 1) * rpb] = decode_fused.pack_gaps(g, bw)
            self._pk[bw] = {"tiles": from_np(tiles, self.device),
                            "first": np.asarray(firsts, np.uint32),
                            "n": np.asarray(ns, np.int32)}
        return self

    def ensure_scores(self) -> "DeviceArena":
        """Build the quantized impact score arena if absent: per posting
        block one packed 128-word score column plus the block-max /
        term-max / stripe tables (``index/scores.py``), the columns on this
        arena's device."""
        if self.scores is None:
            from .scores import ScoreArena
            self.scores = ScoreArena.from_index(self.idx, device=self.device)
        return self

    @classmethod
    def from_index(cls, idx, build_fused: bool = True,
                   device="cuda") -> "DeviceArena":
        return cls(idx, build_fused=build_fused, device=device)

    # ---- capability probes -------------------------------------------------- #

    def covers(self, key) -> bool:
        """True if (term, block, field) decodes natively on device."""
        return self._loc[key][0] is not None

    # ---- batched work-list decode ------------------------------------------ #

    def decode_blocks(self, entries: list) -> list:
        """Decode a work-list of (term, block, field) entries to host arrays;
        field 0 decodes docids (prefix sum + first docid fused in), field 1
        raw TFs.  One batched device call per codec in the work-list;
        entries without an arena capability decode through the numpy
        oracle.  Returns arrays aligned with ``entries``."""
        out: list = [None] * len(entries)
        by_codec: dict = {}
        host: list = []
        for j, e in enumerate(entries):
            name, slot = self._loc[e]
            if name is None:
                host.append((j, e))
            else:
                by_codec.setdefault(name, []).append((j, slot, e))
        for name, items in by_codec.items():
            with get_tracer().span(f"decode/{name}", lane="device",
                                   blocks=len(items)):
                self._groups[name].decode(items, out)
            self.stats["device_calls"] += 1
            self.stats["blocks_device"] += len(items)
        for j, (t, bi, field) in host:
            out[j] = (self.idx.decode_block_ids(t, bi) if field == 0
                      else self.idx.decode_block_tfs(t, bi))
            self.stats["blocks_host"] += 1
        return out

    def decode_blocks_device(self, entries: list):
        """Decode a work-list of (term, block) docid entries WITHOUT copying
        the results to the host: returns (rows, ns) where ``rows[j]`` is a
        padded (ARENA_BLOCK,) int32 device row of absolute docids (zero past
        ``ns[j]``).  Blocks without an arena capability decode through the
        numpy oracle and are uploaded in one batch: postings may flow host ->
        device here, but candidates never flow back."""
        rows: list = [None] * len(entries)
        ns: list = [0] * len(entries)
        by_codec: dict = {}
        host: list = []
        for j, (t, bi) in enumerate(entries):
            name, slot = self._loc[(t, bi, 0)]
            if name is None:
                host.append((j, t, bi))
            else:
                by_codec.setdefault(name, []).append((j, slot))
        for name, items in by_codec.items():
            g = self._groups[name]
            with get_tracer().span(f"decode/{name}", lane="device",
                                   blocks=len(items), resident=True):
                res, n_arr = g.decode_rows(np.asarray([s for _, s in items]))
            res = res[:, :codec_lib.ARENA_BLOCK]
            for r, ((j, _), n) in enumerate(zip(items, n_arr)):
                rows[j] = res[r]
                ns[j] = int(n)
            self.stats["device_calls"] += 1
            self.stats["blocks_device"] += len(items)
        if host:
            batch = np.zeros((len(host), codec_lib.ARENA_BLOCK), np.uint32)
            for k, (j, t, bi) in enumerate(host):
                ids = self.idx.decode_block_ids(t, bi)
                batch[k, :len(ids)] = ids
                ns[j] = len(ids)
            up = from_np(batch, self.device)
            for k, (j, _, _) in enumerate(host):
                rows[j] = up[k]
            self.stats["blocks_host"] += len(host)
        return rows, ns

    # ---- fused decode + AND ------------------------------------------------ #

    def has_fused(self, t, blocks) -> bool:
        return (self._pk is not None
                and all((t, int(bi)) in self._pk_slot for bi in blocks))

    def fused_and(self, t, blocks, cand: np.ndarray) -> np.ndarray:
        """Intersect sorted candidates with term t's selected blocks through
        the fused decode+AND kernel B5 (one call per bit-width bucket present
        in the work-list); exact ``intersect_sorted`` parity."""
        k = len(blocks)
        if k == 0 or len(cand) == 0:
            return np.zeros(0, np.uint32)
        groups: dict = {}
        for j, bi in enumerate(blocks):
            bw, row = self._pk_slot[(t, int(bi))]
            groups.setdefault(bw, []).append((j, row))
        words = bitmap_build_np(cand, 0, self._cand_rows * LANES * 32)
        cand_rows = from_np(words.reshape(self._cand_rows, LANES), self.device)
        parts: list = [None] * k
        for bw, items in groups.items():
            pk = self._pk[bw]
            rows = np.asarray([r for _, r in items], np.int64)
            ids, hits = decode_fused.fused_decode_and(
                pk["tiles"], _to_device(rows.astype(np.int32), self.device),
                _to_device(pk["first"][rows], self.device),
                _to_device(pk["n"][rows], self.device), cand_rows, bw=bw)
            ids = to_np(ids).reshape(len(items), -1)
            hits = to_np(hits).reshape(len(items), -1).astype(bool)
            for g, (j, _) in enumerate(items):
                parts[j] = ids[g][hits[g]]
            self.stats["fused_calls"] += 1
            self.stats["fused_blocks"] += len(items)
        return np.concatenate(parts)

    def _fused_rounds(self, pairs: list, cand_tiles, with_scores: bool,
                      ubs=None):
        """One kernel B1 call per bit-width bucket present in the work-list
        (plus, ``with_scores``, one kernel B3 call on the bucket's score
        slots): the shared body of the AND and ranked fused rounds, every
        call at the exact length of its bucket.  ``ubs`` (optional, aligned
        with ``pairs``) are per-entry quantized upper bounds, returned
        reordered to align with the output rows.  Returns (ids, hits, codes
        or None, qslots, ubs or None): device tensors of matching leading
        length, then two host arrays."""
        sa = self.ensure_scores().scores if with_scores else None
        groups: dict = {}
        for j, (qs, t, bi) in enumerate(pairs):
            bw, row = self._pk_slot[(t, int(bi))]
            groups.setdefault(bw, []).append((qs, row, j))
        ids_l, hits_l, codes_l, qs_l, order = [], [], [], [], []
        for bw, items in groups.items():
            pk = self._pk[bw]
            qs, rows, js = (np.asarray(c) for c in zip(*items))
            ids, hits = intersect_rounds.segmented_decode_and(
                pk["tiles"], *(_to_device(c, self.device)
                               for c in (rows.astype(np.int32),
                                         qs.astype(np.int32),
                                         pk["first"][rows], pk["n"][rows])),
                cand_tiles, bw=bw, crows=self._cand_rows)
            ids_l.append(ids.reshape(len(items), -1))
            hits_l.append(hits.reshape(len(items), -1))
            if with_scores:
                sslots = np.asarray([sa.slot[(pairs[j][1], int(pairs[j][2]))]
                                     for j in js], np.int32)
                codes = topk.unpack_codes(sa.tiles,
                                          _to_device(sslots, self.device))
                codes_l.append(codes.reshape(len(items), -1))
            qs_l.append(qs.astype(np.int32))
            order.append(js)
            self.stats["fused_calls"] += 1
            self.stats["fused_blocks"] += len(items)
        cat = (lambda xs: xs[0] if len(xs) == 1 else torch.cat(xs))
        ncat = (lambda xs: xs[0] if len(xs) == 1 else np.concatenate(xs))
        return (cat(ids_l), cat(hits_l), cat(codes_l) if with_scores else None,
                ncat(qs_l),
                None if ubs is None else np.asarray(ubs, np.int32)[ncat(order)])

    def fused_round(self, pairs: list, cand_tiles):
        """Segmented fused decode + probe for one device-resident AND round.

        pairs: [(qslot, t, bi), ...], every entry probing its own query's
            candidate tile block.
        cand_tiles: (Q * _cand_rows, 128) int32, the segmented bitmap.

        Returns (ids, hits, qslots): device tensors of matching leading
        length and the host qslot array; the decoded ids and hit masks never
        touch the host.
        """
        ids, hits, _, qs, _ = self._fused_rounds(pairs, cand_tiles, False)
        return ids, hits, qs

    def fused_round_scored(self, pairs: list, cand_tiles, ubs=None):
        """Segmented fused decode + probe + score unpack for one ranked
        round: like :meth:`fused_round`, and each entry's packed score words
        also go through kernel B3, so the engine can scatter ``codes * hits``
        straight into the segmented accumulator.  Returns (ids, hits, codes,
        qslots, ubs); ids, hits and codes never touch the host."""
        return self._fused_rounds(pairs, cand_tiles, True, ubs)
