"""Batched query engine: fused decode-and-intersect over the compressed
index on the host, and device-resident AND and ranked rounds on the card.

Counterpart of the JAX package's ``index/engine.py`` for the modes ``and``,
``or`` and ``and_scored``:

  1. **Host placement**: AND queries walk the rarest term first; for every
     other term the skip table prunes blocks before any decode, the kept
     blocks decode into a (term, block) LRU (``BlockCache``) and intersect
     with ``kernels/intersect``.
  2. **Device placement** (``to_device()``): the compressed blocks live in
     ``DeviceArena`` tensors.  Per AND round the engine dedupes the whole
     batch's (term, block) work-list and decodes it in one batched torch call
     per codec; the per-query candidate sets live in one segmented bitmap
     on the card across rounds, block selection uses only static skip
     metadata, and the one candidate download is the final result.
  3. **Fused placement** (``to_device(fused=True)``): rounds >= 1 run the
     CUDA kernel B1 (unpack + prefix sum + per-query probe) over the packed
     gap tiles, and every round's survivors go through kernel B2.
  4. **Ranked modes** (``or`` / ``and_scored``, BM25 top-k): on the host the
     float oracle per query; on the device placements each round scatters
     one term occurrence's quantized impact codes into a segmented score
     accumulator (``kernels/topk``; kernel B3 unpacks the codes on the
     fused placement, B2 and B4 add them), OR work-lists pruned by block-max
     bounds against a static and then promoted per-query theta.  The one
     host copy is the compacted candidate bitmap, which the block-lazy float
     rescore ranks bit for bit as the host oracle.
  5. **Mutation epochs**: the engine serves an ``InvertedIndex`` handle that
     may carry tombstones and a delta segment on top of its immutable
     generation.  Every query resolves a frozen :class:`_ExecCtx`
     (generation, delta snapshot, tombstones, live corpus statistics) and
     plans pin theirs, so a ``compact()`` under a pinned plan changes none
     of its results.  The device paths gate with the epoch's packed live
     row (one upload per epoch, no download); the host merges in a scan of
     the small delta segment.  Results equal a from-scratch rebuild's bit
     for bit.
  6. **Doc-range sharded serving** (``to_device(shards=/bounds=/mesh=)``):
     every generation splits into self-contained shard generations
     (``index/shards.py``), each served by a sub-engine on the card (or on
     its own card of a ``launch.mesh.serving_mesh``).  Rounds run
     shard-local; a ranked batch merges per-shard (k-th sum, count)
     statistics once (``distributed/collectives.merge_topk_stats``), and
     the exact float tail runs on the parent.  Results equal the unsharded
     paths bit for bit.

``engine.plan(batch)`` resolves placement and per-term codec capabilities
once; ``engine.execute(plan)`` follows the plan.  Entry points run on the
card: ``to_device(torch_device="cuda")`` raises without one, and the CPU is
used only when asked for by name (``torch_device="cpu"``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import difflib
import itertools
import warnings
from collections import OrderedDict
from typing import Mapping, Optional

import numpy as np
import torch

from ..core import codec as codec_lib
from ..core.bits import from_np, to_np
from ..distributed import collectives
from ..kernels import intersect, intersect_rounds, topk
from ..obs.metrics import DevStatsView, MetricsRegistry
from ..obs.trace import get_tracer
from . import shards as shards_lib
from .device import _to_device, resolve_device
from .invindex import InvertedIndex
from .scores import B, K1  # noqa: F401  (re-export, as the reference does)
from .scores import bm25_scores, topk_select
from .segments import DeltaSegment, dead_hits

# plan-time auto-placement: batches of at most this many queries are planned
# onto the host even when arenas exist.  The reference derives a measured
# crossover from its committed CPU baseline; the port has no baseline of its
# own yet, so the static rule decides (see ``CrossoverTable``).
HOST_BATCH_MAX = 1


@dataclasses.dataclass(frozen=True)
class CrossoverTable:
    """Host-vs-device placement crossover derived from measured qps curves.

    ``host_batch_max``: batches of at most this many queries are
    auto-placed on the host; None means no true crossing was measured and
    the static ``HOST_BATCH_MAX`` rule applies.  The port never reads the
    JAX package's baseline: :func:`get_crossover` is None until a caller
    installs a table with :func:`set_crossover` (one derived from a
    report's curves by :meth:`from_bench`, for example)."""
    host_batch_max: Optional[int]
    sizes: tuple = ()
    source: str = ""
    mode_cuts: tuple = ()       # ((mode, cut_or_None), ...) measured cells

    def cut_for(self, mode: str) -> Optional[int]:
        for m, c in self.mode_cuts:
            if m == mode:
                return c
        return self.host_batch_max

    @staticmethod
    def _derive(host: Mapping, dev: Mapping):
        """The conservative crossover rule over one pair of qps curves:
        (cut, common sizes) -- cut None when there is no true crossing:
        the largest size the host wins with the device winning every
        larger one; 0 when the device wins everywhere."""
        sizes = sorted(set(host) & set(dev))
        if not sizes:
            return None, ()
        if all(dev[b] > host[b] for b in sizes):
            return 0, tuple(sizes)
        cut = None
        for b in sizes:
            larger = [s for s in sizes if s > b]
            if (host[b] >= dev[b] and larger
                    and all(dev[s] > host[s] for s in larger)):
                cut = b
        return cut, tuple(sizes)

    @classmethod
    def from_bench(cls, report: Mapping, source: str = "BENCH_query.json"
                   ) -> "CrossoverTable":
        """The table of a benchmark report's qps curves (``host_qps`` /
        ``device_qps``: batch -> qps; ``mode_qps``: mode -> {"host"/
        "device": curve}, one cell per measured mode).  A pure function of
        ``report``: the port reads no baseline file itself."""
        host = {int(b): float(q)
                for b, q in (report.get("host_qps") or {}).items()}
        dev = {int(b): float(q)
               for b, q in (report.get("device_qps") or {}).items()}
        cut, sizes = cls._derive(host, dev)
        mode_cuts = []
        for m in sorted(report.get("mode_qps") or {}):
            curves = report["mode_qps"][m] or {}
            mh = {int(b): float(q)
                  for b, q in (curves.get("host") or {}).items()}
            md = {int(b): float(q)
                  for b, q in (curves.get("device") or {}).items()}
            mc, msz = cls._derive(mh, md)
            if msz:
                mode_cuts.append((m, mc))
        return cls(cut, sizes, source, tuple(mode_cuts))


_crossover: Optional[CrossoverTable] = None


def get_crossover() -> Optional[CrossoverTable]:
    """The installed placement crossover table (None: static rule)."""
    return _crossover


def set_crossover(table: Optional[CrossoverTable] = None) -> None:
    """Install (or, with None, drop) a crossover table."""
    global _crossover
    _crossover = table


_EMPTY_U32 = np.zeros(0, np.uint32)
_EMPTY_U32.setflags(write=False)
_EMPTY_I64 = np.zeros(0, np.int64)
_EMPTY_I64.setflags(write=False)

# a ranked margin so large the candidate compact keeps every member doc:
# under a delta-bearing epoch the quantized accumulator holds generation-time
# codes (stale df / avdl), so the theta cut is disarmed and the exact float
# rescore (live stats) does all the ranking.  Tombstone-only epochs stay
# armed through the Q16.16 idf-ratio deflation (``_iq_tomb``).  In
# ``topk.candidate_bitmap`` the cut becomes ``scale - 2**30``, inside int32
# for every scale below 2**16, so no sum is cut.
_KEEP_ALL_MARGIN = 1 << 30

# per-entry quantized upper bound so large the adaptive-theta work-list
# masking never drops the entry (``and_scored`` rounds, whose membership
# must cover the whole intersection, always scatter)
_UB_ALWAYS = 1 << 30

# stacked-work-list memo entries kept per engine (each holds a round's
# gathered device tensors; hot repeated batches skip the restacking)
_ROUND_CACHE = 32


def _merge_disjoint(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Union of two sorted uint32 docid arrays known to be disjoint (the
    generation half and the delta half of a result: delta docids shadow
    their base copies)."""
    if len(b) == 0:
        return a if a.flags.writeable else a.copy()
    if len(a) == 0:
        return b if b.flags.writeable else b.copy()
    out = np.concatenate([a, b])
    out.sort()
    return out


class BlockCache:
    """Cost-weighted LRU cache keyed by (term, block) for decoded postings.

    ``capacity`` is in cost units; a decoded 512-posting block costs 1 and
    whole-term concatenations pass their block count as ``cost``.
    Capacity 0 disables caching entirely (every lookup misses).
    """

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._d: OrderedDict = OrderedDict()
        self._cost: dict = {}
        self.cost_used = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key):
        v = self._d.get(key)
        if v is None:
            self.misses += 1
            return None
        self._d.move_to_end(key)
        self.hits += 1
        return v

    def contains(self, key) -> bool:
        """Membership probe that touches neither the LRU order nor the stats
        (used by the device prefetch planner)."""
        return key in self._d

    def keys(self):
        return list(self._d.keys())

    def put(self, key, value, cost: int = 1) -> None:
        if self.capacity <= 0:
            return
        if key in self._d:
            self.cost_used -= self._cost[key]
            del self._d[key]
        self._d[key] = value
        self._cost[key] = cost
        self.cost_used += cost
        while self.cost_used > self.capacity and self._d:
            k, _ = self._d.popitem(last=False)
            self.cost_used -= self._cost.pop(k)
            self.evictions += 1

    def __len__(self) -> int:
        return len(self._d)

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "entries": len(self._d),
                "cost_used": self.cost_used}


@dataclasses.dataclass
class QueryBatch:
    """A batch of term queries executed together for cache locality.

    mode: "and" (sorted uint32 docid arrays); "or" and "and_scored" (BM25
    top-k lists of (docid, score), descending score, ties by ascending
    docid).
    """
    queries: list
    mode: str = "and"
    k: int = 10


MODES = ("and", "or", "and_scored")
PLACEMENTS = ("host", "device", "fused")


def _check_mode(mode) -> None:
    """Reject unknown batch modes with the nearest-name convention."""
    if mode in MODES:
        return
    near = difflib.get_close_matches(str(mode), MODES, n=1)
    hint = f" (did you mean {near[0]!r}?)" if near else ""
    raise ValueError(
        f"unknown query mode {mode!r}{hint}; modes: {', '.join(MODES)}")


@dataclasses.dataclass(frozen=True)
class TermCaps:
    """One term's execution capabilities, resolved once at plan time from
    the codec registry's declarations.

    codec: the codec of the term's posting blocks (None for a term only
        the delta segment holds: it has no compressed blocks).
    arena: the codec declares an ``ArenaLayout``.
    fused: the arena's fused decode+AND tiles cover every block of the term.
    """
    codec: Optional[str]
    arena: bool
    fused: bool


class _ExecCtx:
    """One mutation epoch's frozen serving view: what a query (or a pinned
    plan) needs to run bit for bit alike whatever writes or compactions land
    afterwards.

    gen: the immutable generation.
    delta: frozen delta-segment snapshot (None when the epoch is unmutated).
    dead: sorted int64 tombstoned base docids (all < ``gen.n_docs``).
    doclen / n_docs / avdl: live corpus statistics over the whole
        append-only doc space, what a from-scratch rebuild computes, so BM25
        floats equal the rebuild's.
    mutated: whether serving consults delta / tombstone state at all.
    skey: the epoch key (gid, tombstone version, delta version) that score
        cache entries carry.
    """
    __slots__ = ("gen", "delta", "dead", "doclen", "n_docs", "avdl",
                 "mutated", "skey", "_df", "_live_dev", "_live_host")

    def __init__(self, idx):
        gen = getattr(idx, "gen", idx)
        self.gen = gen
        self.mutated = bool(getattr(idx, "mutated", False))
        self._df: dict = {}        # term -> live df memo
        self._live_dev = None      # uploaded packed live row (per epoch)
        self._live_host = None     # pre-packed host words (shard ctxs only)
        if self.mutated:
            self.delta = idx.delta.snapshot()
            self.dead = idx.tomb.sorted_ids(below=gen.n_docs)
            self.doclen = idx.doclen_now()
            self.n_docs = int(idx.doc_space)
            # the expression Generation.avdl uses, on the array a rebuild is
            # given: bitwise-equal BM25 floats
            self.avdl = (float(np.asarray(self.doclen).mean())
                         if self.n_docs else 1.0)
            self.skey = idx.epoch
        else:
            self.delta = None
            self.dead = _EMPTY_I64
            self.doclen = gen.doclen
            self.n_docs = gen.n_docs
            self.avdl = gen.avdl
            self.skey = (gen.gid, 0, 0)

    def live_dev(self, words: int, device) -> torch.Tensor:
        """The epoch's packed live bitmap as one (words,) int32 row on
        ``device``, uploaded on first use and reused by every round of every
        batch in the epoch (the gate downloads nothing).  Shard ctxs
        pre-pack their boundary-sliced words (``pack_live_words_range``),
        so a tombstone epoch uploads only each shard's span."""
        if self._live_dev is None or self._live_dev.device != device:
            packed = (self._live_host if self._live_host is not None
                      else intersect_rounds.pack_live_words(
                          self.dead, self.gen.n_docs, words))
            self._live_dev = from_np(packed, device)
        return self._live_dev


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """A typed, resolved execution of one ``QueryBatch``.

    placement: "host", "device" (round-batched arena decode with
        device-resident candidates) or "fused" (device + kernels B1/B2).
        Tiny batches (<= ``HOST_BATCH_MAX`` queries) are auto-placed on the
        host; ``note`` records that decision.
    terms: per distinct known term, its :class:`TermCaps`.
    ctx: the pinned :class:`_ExecCtx`: the mutation epoch (generation,
        delta snapshot, tombstones) this plan serves.  Writes or
        ``compact()`` calls after planning do not change its results;
        re-plan to serve the new epoch.
    """
    mode: str
    k: int
    placement: str
    queries: tuple
    terms: Mapping[int, TermCaps]
    note: str = ""
    ctx: object = dataclasses.field(default=None, repr=False, compare=False)


# per-engine counter taxonomy, the reference's names and meanings
_DEV_COUNTERS = (
    ("worklist_refs", "raw (term, block) work-list references, pre-dedup"),
    ("worklist_decodes", "deduped batched arena decodes actually issued"),
    ("fallback_decodes", "per-block arena decodes outside the work-list"),
    ("resident_rounds", "AND rounds run with candidates device-resident"),
    ("cand_syncs", "per-round candidate downloads (0 on resident paths)"),
    ("final_syncs", "end-of-batch result downloads (one per batch)"),
    ("score_rounds", "ranked accumulate rounds run device-resident"),
    ("score_syncs", "per-round score downloads (always 0 when resident)"),
    ("blocks_pruned", "ranked work-list entries dropped by block-max"),
    ("blocks_scored", "ranked work-list entries actually scored"),
    ("blocks_dense", "entries served from the dense-bitmap representation"),
    ("tomb_gates", "device live-bitmap gates applied (uploads, not syncs)"),
    ("merge_syncs", "sharded ranked top-k merge collectives (one/batch)"),
    ("collective_bytes", "wire bytes moved by the top-k merge collectives"),
    ("shard_final_syncs", "per-shard end-of-batch result downloads"),
)
_ENGINE_SEQ = itertools.count()


class QueryEngine:
    def __init__(self, idx: InvertedIndex, cache_blocks: int = 4096,
                 cache_score_terms: int = 512, device: bool = False,
                 fused: bool = False):
        self.idx = idx
        self.cache = BlockCache(cache_blocks)
        self.score_cache = BlockCache(cache_score_terms)
        self.arena = None
        self.torch_device = None     # set by to_device()
        self._fused = fused
        self._ctx = None           # pinned ctx while executing a plan
        self._ctx_cache = None     # (epoch, _ExecCtx) for the live handle
        self.metrics = MetricsRegistry(
            namespace="repro_torch_index",
            const_labels={"engine": f"q{next(_ENGINE_SEQ)}", "shard": ""})
        for mname, mhelp in _DEV_COUNTERS:
            self.metrics.counter(mname, mhelp)
        self.dev_stats = DevStatsView(self.metrics,
                                      tuple(n for n, _ in _DEV_COUNTERS))
        self.tracer = get_tracer()   # process-global; disabled by default
        self.trace_lane = "engine"   # sub-engines relabel to "shard<i>"
        self._shard_cfg = None     # doc-range sharded serving config
        self._shard_device = None  # a sub-engine's mesh device, if placed
        self._sctx_cache: dict = {}  # (skey, lo, hi) -> shard _ExecCtx
        self._last_shard_cands = None  # last ranked batch's shard candidates
        # (gid, kind, work-list) -> the round's gathered device tensors
        self._round_cache: OrderedDict = OrderedDict()
        if device or fused:
            warnings.warn(
                "QueryEngine(device=..., fused=...) is deprecated; use "
                "QueryEngine(idx).to_device(fused=...) and execute plans "
                "(engine.execute(engine.plan(batch)))",
                DeprecationWarning, stacklevel=2)
        if device:
            self.to_device(fused=fused)

    # ---- serving view -------------------------------------------------------- #

    def _ctx_now(self) -> _ExecCtx:
        e = getattr(self.idx, "epoch", None)
        c = self._ctx_cache
        if c is None or c[0] != e:
            self._ctx_cache = c = (e, _ExecCtx(self.idx))
        return c[1]

    def _cur(self) -> _ExecCtx:
        """The plan-pinned ctx inside ``execute``, else the live one (walking
        ``self.arena`` forward to the current generation after a
        compaction swap)."""
        if self._ctx is not None:
            return self._ctx
        ctx = self._ctx_now()
        if (self.arena is not None
                and getattr(self.arena.idx, "gen", self.arena.idx)
                is not ctx.gen):
            self.arena = ctx.gen.to_device(build_fused=self._fused,
                                           device=self.torch_device)
        return ctx

    def _arena_ctx(self, ctx: _ExecCtx):
        a = self.arena
        if a is not None and getattr(a.idx, "gen", a.idx) is ctx.gen:
            return a
        return ctx.gen.to_device(build_fused=self._fused,
                                 device=self.torch_device)

    def to_device(self, fused=None, shards=None, mesh=None, bounds=None,
                  torch_device="cuda") -> "QueryEngine":
        """Switch the engine onto device-resident arenas on ``torch_device``
        (the card unless the caller names the CPU; ``"cuda"`` without a card
        raises).  ``fused`` additionally routes AND rounds through the fused
        decode+probe kernel; its tile arenas are built only when requested.

        Doc-range sharded serving: any of ``shards`` (a count, boundaries
        from build metadata, :meth:`.shards.ShardSpec.derive`), ``bounds``
        (an explicit ``(0, ..., n_docs)``; uneven and empty ranges are
        legal) or ``mesh`` (a list of one torch device per shard,
        ``launch.mesh.serving_mesh``; absent or of another size, the shards
        run logically on ``torch_device``) splits every generation into
        self-contained per-shard engines (``_shard_engines``).  Resident
        rounds then run shard-local; a ranked batch merges once
        (``_execute_sharded``)."""
        dev = resolve_device(torch_device)
        if self.torch_device is not None and dev != self.torch_device:
            # cached device rows and stacked rounds live on the old device
            self.cache = BlockCache(self.cache.capacity)
            self._round_cache.clear()
        self.torch_device = dev
        if fused is not None:
            self._fused = fused
        if shards is not None or bounds is not None or mesh is not None:
            b = tuple(int(x) for x in bounds) if bounds is not None else None
            if mesh is not None:
                mesh = [resolve_device(d) for d in mesh]
            n = (int(shards) if shards is not None
                 else len(b) - 1 if b is not None
                 else len(mesh))
            if n < 1:
                raise ValueError(f"need at least one shard, got {n}")
            if b is not None and len(b) - 1 != n:
                raise ValueError(
                    f"bounds {b} define {len(b) - 1} shard(s), not {n}")
            self._shard_cfg = {"n": n, "bounds": b, "mesh": mesh}
            self.arena = None           # the shards own the arenas
            self._shard_engines(self._ctx_now())    # build eagerly
            return self
        self.arena = self.idx.to_device(build_fused=self._fused, device=dev)
        return self

    # ---- decode through the cache ------------------------------------------ #
    # Block entries are keyed (term, block, field, gid) with field 0 = docids,
    # 1 = TFs and 2 = a docid row resident on the device; whole-term
    # concatenations are (term, -1, field, gid) at cost = block count.  Every
    # cached host array is frozen read-only before insertion.

    @staticmethod
    def _freeze(a: np.ndarray) -> np.ndarray:
        a.setflags(write=False)
        return a

    def _decode_block_field(self, t: int, bi: int, field: int) -> np.ndarray:
        ctx = self._cur()
        key = (t, bi, field, ctx.gen.gid)
        v = self.cache.get(key)
        if v is None:
            if self.arena is not None:
                # cache-eviction stragglers outside the batched work-list
                self.metrics.inc("fallback_decodes")
                v = self._arena_ctx(ctx).decode_blocks([(t, bi, field)])[0]
            elif field == 0:
                v = ctx.gen.decode_block_ids(t, bi)
            else:
                v = ctx.gen.decode_block_tfs(t, bi)
            v = self._freeze(v)
            self.cache.put(key, v)
        return v

    def decode_block_ids(self, t: int, bi: int) -> np.ndarray:
        return self._decode_block_field(t, bi, 0)

    def decode_block_tfs(self, t: int, bi: int) -> np.ndarray:
        return self._decode_block_field(t, bi, 1)

    def decode_block(self, t: int, bi: int):
        return self.decode_block_ids(t, bi), self.decode_block_tfs(t, bi)

    def _term_concat(self, t: int, field: int, decode_one) -> np.ndarray:
        ctx = self._cur()
        key = (t, -1, field, ctx.gen.gid)
        v = self.cache.get(key)
        if v is None:
            nb = ctx.gen.n_blocks(t)
            if nb == 0:
                return _EMPTY_U32
            if self.arena is not None:
                self._prefetch_blocks([(t, bi, field) for bi in range(nb)])
            parts = [decode_one(t, bi) for bi in range(nb)]
            v = self._freeze(parts[0] if nb == 1 else np.concatenate(parts))
            self.cache.put(key, v, cost=nb)
        return v

    def _prefetch_blocks(self, entries: list) -> None:
        """Dedupe a (term, block, field) work-list against the cache and
        decode the misses in one batched arena call."""
        ctx = self._cur()
        gid = ctx.gen.gid
        missing, seen = [], set()
        for e in entries:
            if e in seen or self.cache.contains(e + (gid,)):
                continue
            seen.add(e)
            missing.append(e)
        self.metrics.inc("worklist_decodes", len(missing))
        if not missing:
            return
        arena = self._arena_ctx(ctx)
        for e, a in zip(missing, arena.decode_blocks(missing)):
            self.cache.put(e + (gid,), self._freeze(a))

    def _prefetch_terms(self, terms, fields=(0, 1)) -> None:
        ctx = self._cur()
        entries = []
        for t in terms:
            if t not in ctx.gen.terms:
                continue
            nb = ctx.gen.n_blocks(t)
            for f in fields:
                if not self.cache.contains((t, -1, f, ctx.gen.gid)):
                    entries.extend((t, bi, f) for bi in range(nb))
        self._prefetch_blocks(entries)

    def term_ids(self, t: int) -> np.ndarray:
        return self._term_concat(t, 0, self.decode_block_ids)

    def term_tfs(self, t: int) -> np.ndarray:
        return self._term_concat(t, 1, self.decode_block_tfs)

    def term_postings(self, t: int):
        return self.term_ids(t), self.term_tfs(t)

    # ---- live (mutation-aware) posting views -------------------------------- #

    def _df_live(self, t: int, ctx: _ExecCtx) -> int:
        """Live document frequency of term t under ``ctx``: generation df
        minus tombstoned postings plus delta postings (memoized per ctx).
        Under mutation a term is known when its live df is > 0, exactly the
        terms a from-scratch rebuild still holds."""
        if not ctx.mutated:
            tp = ctx.gen.terms.get(t)
            return tp.df if tp is not None else 0
        v = ctx._df.get(t)
        if v is None:
            tp = ctx.gen.terms.get(t)
            base = tp.df if tp is not None else 0
            if base and len(ctx.dead):
                base -= int(dead_hits(ctx.dead, self.term_ids(t)).sum())
            ctx._df[t] = v = base + ctx.delta.df(t)
        return v

    def _live_postings(self, t: int, ctx: _ExecCtx):
        """Term t's live postings under ``ctx``: generation postings minus
        tombstones, merge-sorted with the delta postings (disjoint by the
        shadowing invariant); the arrays a from-scratch rebuild's
        ``term_ids`` / ``term_tfs`` return."""
        if t in ctx.gen.terms:
            ids, tfs = self.term_ids(t), self.term_tfs(t)
            if len(ctx.dead) and len(ids):
                keep = ~dead_hits(ctx.dead, ids)
                ids, tfs = ids[keep], tfs[keep]
        else:
            ids, tfs = _EMPTY_U32, _EMPTY_U32
        dids, dtfs = ctx.delta.postings(t)
        if len(dids):
            if len(ids) == 0:
                return dids.copy(), dtfs.copy()
            ids = np.concatenate([ids, dids])
            tfs = np.concatenate([tfs, dtfs])
            order = np.argsort(ids, kind="stable")
            ids, tfs = ids[order], tfs[order]
        return ids, tfs

    # ---- fused decode-and-intersect (host candidates) ----------------------- #

    def _block_plan(self, t: int, cand: np.ndarray):
        """Skip-table pruning: candidate cut points per block of term t and
        the indices of blocks whose docid range contains a candidate."""
        gen = self._cur().gen
        firsts = gen.block_firsts(t).astype(cand.dtype)
        cut = np.empty(len(firsts) + 1, np.int64)
        cut[:-1] = np.searchsorted(cand, firsts)
        cut[-1] = len(cand)
        return cut, np.flatnonzero(cut[1:] > cut[:-1])

    def _term_fused(self, t: int, sel) -> bool:
        return (self._fused and self.arena is not None
                and self.arena.has_fused(t, sel))

    def _intersect_plan(self, t: int, cut: np.ndarray, sel: np.ndarray,
                        cand: np.ndarray, fused: bool | None = None) -> np.ndarray:
        if len(sel) == 0:
            return np.zeros(0, np.uint32)
        if self._term_fused(t, sel) if fused is None else fused:
            return self.arena.fused_and(t, sel, cand)
        out = [intersect.intersect_sorted(self.decode_block_ids(t, int(bi)),
                                          cand[cut[bi]:cut[bi + 1]])
               for bi in sel]
        return np.concatenate(out)

    def _intersect_term(self, t: int, cand: np.ndarray) -> np.ndarray:
        cut, sel = self._block_plan(t, cand)
        return self._intersect_plan(t, cut, sel, cand)

    def and_many(self, queries: list,
                 terms: Mapping[int, TermCaps] | None = None) -> list:
        """AND all queries together, round-batched for the device arenas:
        the legacy loop that syncs every query's candidates to the host
        between rounds (planned execution runs ``_and_many_resident``).
        Under ``to_device(fused=True)`` each term's blocks intersect through
        kernel B5.  Results are bit-identical to ``and_query`` per query."""
        def term_fused(t, sel):
            return (terms[t].fused if terms is not None
                    else self._term_fused(t, sel))

        gen = self._cur().gen
        qterms = [sorted((t for t in q if t in gen.terms),
                         key=lambda t: gen.terms[t].df) for q in queries]
        for ts in qterms:
            if ts:
                self.metrics.inc("worklist_refs", gen.n_blocks(ts[0]))
        if self.arena is not None:
            self._prefetch_terms({ts[0] for ts in qterms if ts}, fields=(0,))
        cands = [self.term_ids(ts[0]) if ts else _EMPTY_U32 for ts in qterms]
        owned = [False] * len(queries)
        r = 1
        while True:
            active = [i for i, ts in enumerate(qterms)
                      if len(ts) > r and len(cands[i])]
            if not active:
                break
            plans, worklist = {}, []
            for i in active:
                t = qterms[i][r]
                cut, sel = self._block_plan(t, cands[i])
                fused = term_fused(t, sel)
                plans[i] = (t, cut, sel, fused)
                self.metrics.inc("worklist_refs", len(sel))
                if self.arena is not None and not fused:
                    worklist.extend((t, int(bi), 0) for bi in sel)
            if self.arena is not None:
                self._prefetch_blocks(worklist)
            for i in active:
                t, cut, sel, fused = plans[i]
                cands[i] = self._intersect_plan(t, cut, sel, cands[i], fused)
                owned[i] = True
            if self.arena is not None:
                self.metrics.inc("cand_syncs", len(active))
            r += 1
        return [c if o else c.copy() for c, o in zip(cands, owned)]

    # ---- device-resident AND rounds ---------------------------------------- #

    def _select_blocks_static(self, t: int, cov_f: np.ndarray,
                              cov_l: np.ndarray) -> np.ndarray:
        """Blocks of term t whose [first, last] docid range overlaps any of
        the seed coverage intervals, from build-time skip metadata only."""
        gen = self._cur().gen
        f = gen.block_firsts(t)
        l = gen.block_lasts(t)
        j = np.searchsorted(cov_l, f)            # first interval ending >= f
        hit = j < len(cov_l)
        jc = np.minimum(j, max(len(cov_f) - 1, 0))
        return np.flatnonzero(hit & (cov_f[jc] <= l))

    def _round_rows(self, entries: list) -> dict:
        """Dedupe a round's (term, block) docid work-list against the cache
        and decode the misses in one device-resident arena call; returns
        {(t, bi): (padded_device_row, n)} for every entry."""
        ctx = self._cur()
        gid = ctx.gen.gid
        out: dict = {}
        missing: list = []
        for e in entries:
            if e in out:
                continue
            v = self.cache.get((e[0], e[1], 2, gid))
            if v is None:
                out[e] = None
                missing.append(e)
            else:
                out[e] = v
        self.metrics.inc("worklist_decodes", len(missing))
        if missing:
            rows, ns = self._arena_ctx(ctx).decode_blocks_device(missing)
            for e, row, n in zip(missing, rows, ns):
                out[e] = (row, n)
                self.cache.put((e[0], e[1], 2, gid), (row, n))
        return out

    def _round_memo(self, key, build):
        """Bounded memo for a round's stacked device tensors: identical
        work-lists reuse the gathered rows.  Keys carry the gid."""
        v = self._round_cache.get(key)
        if v is None:
            v = build()
            self._round_cache[key] = v
            while len(self._round_cache) > _ROUND_CACHE:
                self._round_cache.popitem(last=False)
        else:
            self._round_cache.move_to_end(key)
        return v

    def _stack_worklist(self, entries: list):
        """Dedupe a round's (qslot, term, block) entries, decode the unique
        (term, block) rows once and fan them out with one device gather.
        Returns (rows, qslots, ns), one row per entry."""
        key = (self._cur().gen.gid, "ids", tuple(entries))
        return self._round_memo(key,
                                lambda: self._stack_worklist_build(entries))

    def _stack_worklist_build(self, entries: list):
        pairs = [(t, bi) for _, t, bi in entries]
        rows = self._round_rows(pairs)
        ent_row = {e: j for j, e in enumerate(rows)}
        mat = torch.stack([rows[e][0] for e in rows])
        sel = np.asarray([ent_row[e] for e in pairs], np.int64)
        qs = np.asarray([q for q, _, _ in entries], np.int32)
        ns = np.asarray([rows[e][1] for e in pairs], np.int32)
        return mat[torch.as_tensor(sel, device=mat.device)], qs, ns

    def _stack_dense(self, entries: list, ubs=None, with_codes: bool = False):
        """Gather a round's dense-bitmap work-list: the entries' 128-word
        posting windows and, ``with_codes``, their window-aligned score
        tiles, in one device gather each (memoized per (gid, block-list)).
        Returns (words, tiles or None, qslots, w0, act, ub or None) device
        tensors, every entry active; ``ub`` only where ``ubs`` is given."""
        ctx = self._cur()
        ar = self._arena_ctx(ctx)
        dev = ar.device
        blocks = tuple((t, bi) for _, t, bi in entries)

        def build():
            sel = np.asarray([ar.dense_slot[b] for b in blocks], np.int64)
            words = ar.dense_words[torch.as_tensor(sel, device=dev)]
            tiles = None
            if with_codes:
                sa = ar.ensure_scores().scores
                srows = [sa.dense_slot[b] for b in blocks]
                tiles = sa.dense_tiles[torch.as_tensor(srows, device=dev)]
            return words, tiles, torch.as_tensor(ar.dense_w0[sel], device=dev)

        words, tiles, w0 = self._round_memo(
            (ctx.gen.gid, "dense", with_codes, blocks), build)
        qs = np.asarray([q for q, _, _ in entries], np.int32)
        ub = (None if ubs is None
              else torch.as_tensor(np.asarray(ubs, np.int32), device=dev))
        return (words, tiles, torch.as_tensor(qs, device=dev), w0,
                torch.ones(len(entries), dtype=torch.bool, device=dev), ub)

    def _score_rows(self, sa, pairs: list):
        """Memoized ``ScoreArena.rows`` for a round's (term, block)
        work-list."""
        key = (self._cur().gen.gid, "codes", tuple(pairs))
        return self._round_memo(key, lambda: sa.rows(pairs))

    def _and_qterms(self, queries: list, ctx: _ExecCtx) -> list:
        """Per-query known terms sorted rarest-first (df ascending).  Under
        a mutation epoch a query whose live terms include a delta-only term
        has no generation match at all and becomes ``[]`` (it seeds empty;
        the caller unions in the delta-segment scan)."""
        idx = ctx.gen
        if not ctx.mutated:
            return [sorted((t for t in q if t in idx.terms),
                           key=lambda t: idx.terms[t].df) for q in queries]
        qterms = []
        for q in queries:
            known = [t for t in q if self._df_live(t, ctx) > 0]
            if any(t not in idx.terms for t in known):
                qterms.append([])       # delta-only live term: no base match
            else:
                qterms.append(sorted(known, key=lambda t: idx.terms[t].df))
        return qterms

    def _and_many_resident(self, queries: list,
                           terms: Mapping[int, TermCaps] | None = None,
                           use_fused: bool = False,
                           qterms: list | None = None) -> list:
        """AND the batch device-resident; the single host copy turns the
        final bitmaps into sorted docid arrays."""
        bm, _, _ = self._and_bitmap_resident(queries, terms, use_fused,
                                             qterms=qterms)
        self.metrics.inc("final_syncs")
        return intersect_rounds.extract_ids(to_np(bm),
                                            self._cur().gen.n_docs)

    def _and_bitmap_resident(self, queries: list,
                             terms: Mapping[int, TermCaps] | None = None,
                             use_fused: bool = False,
                             qterms: list | None = None):
        """AND the batch with candidates device-resident across rounds.

        Round 0 scatters every query's rarest term into its row of the
        segmented candidate bitmap (one device tensor for the whole batch);
        round r >= 1 decodes the round's deduped (term, block) work-list,
        probes each decoded docid against its query's bitmap segment and
        scatters the survivors, all on the card.  Block selection is static
        (seed-term coverage intervals from the skip tables), so no candidate
        returns to the host until the single final copy.  Under
        ``use_fused`` the rounds run kernel B1 over the packed gap tiles.

        Returns (bitmap, qterms, cov): the (nq, words) device bitmap, the
        per-query known terms rarest-first, and the per-query seed coverage
        intervals.  Results are bit-identical to ``and_query`` per query.

        Under a mutation epoch the seed bitmap is ANDed with the epoch's
        packed live row right after round 0 (one upload, no download):
        tombstoned docs then fail every later probe, so the final bitmaps
        hold the generation's live intersections.
        """
        ctx = self._cur()
        idx = ctx.gen
        ar = self._arena_ctx(ctx)
        dev = ar.device
        nq = len(queries)
        words, crows = intersect_rounds.bitmap_geometry(idx.n_docs)
        if nq == 0:
            return torch.zeros((0, words), dtype=torch.int32, device=dev), [], {}
        if qterms is None:
            qterms = self._and_qterms(queries, ctx)
        bm = torch.zeros((nq, words), dtype=torch.int32, device=dev)

        def run_round(bm, plain, fused_pairs, dense, active_idx, probe):
            """One committed AND round: every representation split (arena
            decode, fused decode, dense windows) probes the same OLD bitmap
            and ORs survivors into ONE shared new bitmap (exact: a block is
            served by exactly one representation, so the splits' docid sets
            are disjoint), then a single commit folds active rows forward."""
            active = np.zeros(nq, bool)
            active[active_idx] = True
            new = torch.zeros_like(bm)
            if plain:
                rows, qs, ns = self._stack_worklist(plain)
                new = intersect_rounds.round_accumulate(
                    new, rows, _to_device(qs, dev), _to_device(ns, dev), bm,
                    probe=probe)
            if fused_pairs:
                ids, hits, qs = ar.fused_round(
                    fused_pairs, bm.reshape(nq * crows, -1))
                new = intersect_rounds.round_accumulate_masked(
                    new, ids.reshape(len(qs), -1), _to_device(qs, dev),
                    hits.reshape(len(qs), -1))
            if dense:
                dw, _, dqs, dw0, dact, _ = self._stack_dense(dense)
                new = intersect_rounds.dense_round_accumulate(
                    new, dw, dqs, dw0, dact, bm, probe=probe)
            return intersect_rounds.round_commit(
                bm, new, torch.as_tensor(active, device=dev))

        def split_dense(pairs):
            """Route (qslot, t, bi) entries to their serving representation
            (per-block capability: the arena's dense window table)."""
            sparse, dense = [], []
            for e in pairs:
                (dense if (e[1], e[2]) in ar.dense_slot else sparse).append(e)
            self.metrics.inc("blocks_dense", len(dense))
            return sparse, dense

        # round 0: seed every query's bitmap row with its rarest term
        seeds = [i for i, ts in enumerate(qterms)
                 if ts and idx.terms[ts[0]].df]
        for ts in qterms:
            if ts:
                self.metrics.inc("worklist_refs", idx.n_blocks(ts[0]))
        pairs0 = [(i, qterms[i][0], bi) for i in seeds
                  for bi in range(idx.n_blocks(qterms[i][0]))]
        plain0, dense0 = split_dense(pairs0)
        with self.tracer.span("and/seed", lane=self.trace_lane, nq=nq,
                              plain=len(plain0), dense=len(dense0)):
            bm = run_round(bm, plain0, [], dense0, seeds, probe=False)
            self.tracer.fence(bm)
        if ctx.mutated and len(ctx.dead):
            # gate the seed with the epoch's live row: every later round
            # only keeps survivors, so one AND serves the whole batch
            with self.tracer.span("and/tomb_gate", lane=self.trace_lane,
                                  dead=len(ctx.dead)):
                bm = bm & ctx.live_dev(words, dev)[None, :]
                self.tracer.fence(bm)
            self.metrics.inc("tomb_gates")
        cov = {i: (idx.block_firsts(qterms[i][0]),
                   idx.block_lasts(qterms[i][0])) for i in seeds}

        live = set(seeds)
        r = 1
        while True:
            active = [i for i in live if len(qterms[i]) > r]
            if not active:
                break
            self.metrics.inc("resident_rounds")
            plain, fused_pairs, dense = [], [], []
            for i in active:
                t = qterms[i][r]
                sel = self._select_blocks_static(t, *cov[i])
                self.metrics.inc("worklist_refs", len(sel))
                f = use_fused and (terms[t].fused if terms is not None
                                   else ar.has_fused(t, sel))
                for bi in sel:
                    e = (i, t, int(bi))
                    if (t, int(bi)) in ar.dense_slot:
                        dense.append(e)
                        self.metrics.inc("blocks_dense")
                    elif f:
                        fused_pairs.append(e)
                    else:
                        plain.append(e)
            with self.tracer.span("and/round", lane=self.trace_lane, r=r,
                                  plain=len(plain), fused=len(fused_pairs),
                                  dense=len(dense)):
                bm = run_round(bm, plain, fused_pairs, dense, active,
                               probe=True)
                self.tracer.fence(bm)
            r += 1

        return bm, qterms, cov

    def and_query(self, terms: list) -> np.ndarray:
        ctx = self._cur()
        if ctx.mutated:
            return self._and_query_mut(list(terms), ctx)
        return self._and_gen([t for t in terms if t in ctx.gen.terms], ctx)

    def _and_gen(self, terms: list, ctx: _ExecCtx) -> np.ndarray:
        """AND over generation postings only (terms already known)."""
        terms = sorted(terms, key=lambda t: ctx.gen.terms[t].df)
        if not terms:
            return np.zeros(0, np.uint32)
        cand = self.term_ids(terms[0])
        owned = False                           # does the caller own `cand`?
        for t in terms[1:]:
            if len(cand) == 0:
                break
            cand = self._intersect_term(t, cand)
            owned = True
        return cand if owned else cand.copy()

    def _and_query_mut(self, terms: list, ctx: _ExecCtx) -> np.ndarray:
        """Live AND under a mutation epoch: the generation intersection
        (tombstones filtered out) unioned with the delta-segment scan, what
        ``and_query`` on a from-scratch rebuild returns.  A term whose
        postings are all tombstoned is unknown, as in the rebuild; a live
        term only the delta holds leaves the generation half empty (delta
        docids shadow their base copies)."""
        known = [t for t in terms if self._df_live(t, ctx) > 0]
        if not known:
            return np.zeros(0, np.uint32)
        if all(t in ctx.gen.terms for t in known):
            base = self._and_gen(known, ctx)
            if len(ctx.dead) and len(base):
                base = base[~dead_hits(ctx.dead, base)]
        else:
            base = _EMPTY_U32
        return _merge_disjoint(base, ctx.delta.scan_and(known))

    # ---- BM25 -------------------------------------------------------------- #

    def term_scores(self, t: int):
        """(docids, float64 BM25 impacts) of term t, through the score
        cache keyed by the epoch; under mutation the live postings with the
        live df."""
        ctx = self._cur()
        key = (t,) + ctx.skey
        v = self.score_cache.get(key)
        if v is None:
            if ctx.mutated:
                ids, tfs = self._live_postings(t, ctx)
                ids = self._freeze(ids)
                df = len(ids)
            else:
                ids, tfs = self.term_ids(t), self.term_tfs(t)
                df = ctx.gen.terms[t].df
            sc = bm25_scores(tfs, ctx.doclen[ids], df, ctx.n_docs, ctx.avdl)
            v = (ids, self._freeze(sc))
            self.score_cache.put(key, v)
        return v

    def or_query(self, terms: list, k: int = 10):
        """Host top-k of the disjunction: exact BM25 summed over the known
        terms (under mutation, the terms with live postings),
        :func:`topk_select` order."""
        ctx = self._cur()
        if ctx.mutated:
            use = [t for t in terms if self._df_live(t, ctx) > 0]
        else:
            use = [t for t in terms if t in ctx.gen.terms]
        parts = [self.term_scores(t) for t in use]
        if not parts:
            return []
        ids = np.concatenate([p[0] for p in parts])
        sc = np.concatenate([p[1] for p in parts])
        docs, inv = np.unique(ids, return_inverse=True)
        if len(docs) == 0:
            return []
        tot = np.zeros(len(docs))
        np.add.at(tot, inv, sc)
        return topk_select(docs, tot, k)

    def _score_docs(self, terms: list, docs: np.ndarray, k: int) -> list:
        """The host float top-k oracle: exact BM25 over ``docs`` (term-level
        score vectors through the score cache), accumulated in query-term
        order and selected with :func:`topk_select`.  Under a mutation
        epoch the score vectors are the live ones (``_live_postings``)."""
        if len(docs) == 0:
            return []
        ctx = self._cur()
        scores = np.zeros(len(docs))
        for t in terms:
            if ctx.mutated:
                if self._df_live(t, ctx) <= 0:
                    continue        # unknown (or fully tombstoned) scores 0
            elif t not in ctx.gen.terms or not ctx.gen.terms[t].blocks:
                continue            # unknown or zero-posting term scores 0
            ids, sc = self.term_scores(t)
            pos = np.searchsorted(ids, docs)
            pos = np.clip(pos, 0, len(ids) - 1)
            hit = ids[pos] == docs
            scores += np.where(hit, sc[pos], 0.0)
        return topk_select(docs, scores, k)

    def _block_plans(self, t: int, docs: np.ndarray) -> np.ndarray:
        """Per doc, the index of term t's block whose [first, last] range
        holds it, or -1."""
        gen = self._cur().gen
        bi = np.searchsorted(gen.block_firsts(t), docs, side="right") - 1
        return np.where(gen.block_lasts(t)[np.maximum(bi, 0)] >=
                        docs.astype(np.int64), bi, -1)

    def _blockwise_scores(self, t: int, docs: np.ndarray,
                          bi: np.ndarray) -> np.ndarray:
        """Exact BM25 of term t at ``docs`` (0 where absent), decoding only
        the blocks ``bi`` names."""
        ctx = self._cur()
        df = ctx.gen.terms[t].df
        vals = np.zeros(len(docs))
        for b in np.unique(bi[bi >= 0]):
            sel = np.flatnonzero(bi == b)
            ids, tfs = self.decode_block(t, int(b))
            pos = np.searchsorted(ids, docs[sel])
            pos = np.clip(pos, 0, len(ids) - 1)
            hit = ids[pos] == docs[sel]
            sub = sel[hit]
            vals[sub] = bm25_scores(tfs[pos[hit]], ctx.doclen[docs[sub]], df,
                                    ctx.n_docs, ctx.avdl)
        return vals

    def _score_docs_blockwise(self, terms: list, docs: np.ndarray,
                              k: int) -> list:
        """Exact float rescore touching only the blocks that hold ``docs``;
        bitwise identical to :meth:`_score_docs` (same formula, same per-doc
        term accumulation order, same tie rule)."""
        if len(docs) == 0:
            return []
        return self._rescore_batch_blockwise([terms], [docs], k)[0]

    def _rescore_batch_blockwise(self, queries: list, cand: list,
                                 k: int) -> list:
        """Batch form of :meth:`_score_docs_blockwise`: each term scores the
        union of its queries' candidates once (decoding only the blocks that
        hold them), then every query accumulates its own docs in query-term
        order from the shared per-term vectors.  Bitwise identical to the
        per-query form: a candidate a term does not hold adds +0.0 exactly
        as the host oracle's ``np.where`` does."""
        union: dict = {}
        for q, c in zip(queries, cand):
            if len(c) == 0:
                continue
            for t in dict.fromkeys(q):
                union.setdefault(t, []).append(c)
        idx = self._cur().gen
        plans, prefetch = [], []
        for t, parts in union.items():
            if t not in idx.terms or not idx.terms[t].blocks:
                continue            # unknown or zero-posting term scores 0
            docs = (parts[0] if len(parts) == 1
                    else np.unique(np.concatenate(parts)))
            bi = self._block_plans(t, docs)
            plans.append((t, docs, bi))
            if self.arena is not None:
                prefetch.extend((t, int(b), f)
                                for b in np.unique(bi[bi >= 0])
                                for f in (0, 1))
        if prefetch:
            self._prefetch_blocks(prefetch)
        shared = {t: (docs, self._blockwise_scores(t, docs, bi))
                  for t, docs, bi in plans}
        out = []
        for q, c in zip(queries, cand):
            if len(c) == 0:
                out.append([])
                continue
            scores = np.zeros(len(c))
            for t in q:             # query-term order, duplicates kept
                e = shared.get(t)
                if e is not None:
                    docs, vals = e
                    scores += vals[np.searchsorted(docs, c)]
            out.append(topk_select(c, scores, k))
        return out

    def and_query_scored(self, terms: list, k: int = 10):
        return self._score_docs(terms, self.and_query(terms), k)

    # ---- device-resident ranked top-k (OR / and_scored) --------------------- #

    def _prune_ranked_blocks(self, sa, occs: list, r: int, theta0: int,
                             iq: int = 1 << 16) -> tuple:
        """Block-max prune for occurrence ``r`` of an OR query's term list:
        drop blocks whose upper bound (own block-max, plus every other
        occurrence's max code over the block's docid range, plus the
        quantization margin) cannot beat ``theta0``.  Returns (keep,
        n_pruned, ub[keep]); the kept bounds ride to the device, where later
        rounds re-test them against the promoted theta."""
        t = occs[r]
        gen = self._cur().gen
        nb = gen.n_blocks(t)
        if nb == 0:
            return np.arange(0), 0, _EMPTY_I64
        firsts = gen.block_firsts(t)
        lasts = gen.block_lasts(t)
        base = sa.slot[(t, 0)]          # a term's slots are contiguous
        ub = sa.block_max[base:base + nb].astype(np.int64) + len(occs)
        for t2 in occs[:r] + occs[r + 1:]:
            ub += sa.range_max_many(t2, firsts, lasts)
        if theta0 <= 0:
            return np.arange(nb), 0, ub
        keep = np.flatnonzero(ub > (theta0 * iq) >> 16)
        return keep, nb - len(keep), ub[keep]

    def _iq_tomb(self, ts: list, ctx: _ExecCtx) -> int:
        """Per-query Q16.16 threshold deflation ``floor(2**16 / Rmax)`` for
        a tombstone-only epoch: ``Rmax`` is the worst live / generation idf
        ratio over the query's terms (deletes only shrink df, so every ratio
        is >= 1), and the integer floor is nudged down until ``iq * Rmax <=
        2**16``, so float rounding never pushes a scaled threshold above
        theta / Rmax."""
        n = ctx.n_docs
        rmax = 1.0
        for t in ts:
            tp = ctx.gen.terms.get(t)
            if tp is None:
                continue
            dfg = tp.df
            dfl = self._df_live(t, ctx)
            if dfl <= 0 or dfl >= dfg:
                continue
            ig = float(np.log(1.0 + (n - dfg + 0.5) / (dfg + 0.5)))
            il = float(np.log(1.0 + (n - dfl + 0.5) / (dfl + 0.5)))
            if ig > 0.0 and il > ig:
                rmax = max(rmax, il / ig)
        iq = int((1 << 16) / rmax)
        while iq * rmax > (1 << 16):
            iq -= 1
        return max(iq, 1)

    def _ranked_resident(self, queries: list, k: int, mode: str,
                         terms: Mapping[int, TermCaps] | None = None,
                         use_fused: bool = False) -> list:
        """Ranked top-k with scores device-resident across rounds.

        Round r scatters every query's r-th strongest term occurrence into
        the segmented score accumulator (``kernels/topk``); for
        ``and_scored`` gated by the AND bitmap, which never leaves the card
        (``_and_bitmap_resident``).  OR work-lists are block-max pruned
        against the static theta0 before any decode, and after every round
        the per-query theta is promoted on the card (``pooled_threshold``),
        so later rounds drop entries whose bound cannot beat it.  The single
        host copy is the compacted candidate bitmap (k-th quantized sum
        minus the quantization margin, a superset of the float top-k), which
        the block-lazy float rescore ranks exactly: results equal the host
        path bit for bit, ties broken by ascending docid.

        Under a delta-bearing mutation epoch the quantized tables carry
        generation-time statistics, so the theta cut is disarmed (theta0 0,
        a margin that keeps every member) and OR rounds gate with the
        epoch's live row.  Tombstone-only epochs stay armed: a per-query
        Q16.16 deflation ``iq`` (``_iq_tomb``) keeps every threshold test
        sound against the generation-time tables, with theta0 from the
        tombstone-filtered top-code tables (``ScoreArena.theta0_live``).
        The rescore unions the delta-segment scan per query and runs the
        live-statistics float oracle."""
        ctx = self._cur()
        nq = len(queries)
        if nq == 0:
            return []
        known, base_ts, tomb_only, armed, margins_l, iqs_l = \
            self._ranked_params(queries, k, ctx)
        if known is None:
            return [[] for _ in queries]
        acc, member, margins, iq_dev, width = self._ranked_accumulate(
            queries, k, mode, terms, use_fused, base_ts=base_ts, armed=armed,
            tomb_only=tomb_only, margins_l=margins_l, iqs_l=iqs_l)
        theta = topk.topk_threshold(acc, min(k, width))
        cand_bm = topk.candidate_bitmap(acc, member, theta, margins, iq_dev)
        del acc, member
        # the single host copy: candidate bitmaps -> exact float rescore
        self.metrics.inc("final_syncs")
        cand = intersect_rounds.extract_ids(to_np(cand_bm), ctx.gen.n_docs)
        del cand_bm
        return self._ranked_rescore(queries, cand, k, mode, known, ctx)

    def _ranked_params(self, queries: list, k: int, ctx: _ExecCtx):
        """The batch's epoch-derived ranked parameters: (known, base_ts,
        tomb_only, armed, margins_l, iqs_l), known None when the batch
        yields only empty results.  ``known``: each query's live terms;
        ``base_ts``: those the generation holds; ``armed``: the theta cut
        is sound (unmutated or tombstone-only epoch); ``margins_l``: the
        quantization margin (the known-term count, or ``_KEEP_ALL_MARGIN``
        disarmed); ``iqs_l``: the Q16.16 scale (identity unless
        tombstone-only)."""
        idx = ctx.gen
        if ctx.mutated:
            known = [[t for t in q if self._df_live(t, ctx) > 0]
                     for q in queries]
            base_ts = [[t for t in ts if t in idx.terms] for ts in known]
        else:
            known = [[t for t in q if t in idx.terms] for q in queries]
            base_ts = known
        if k <= 0 or not any(known):
            return None, None, False, False, None, None
        # tombstone-only: no delta doc and corpus statistics untouched
        # (deletes never shrink the doc space or rewrite doclens; the array
        # check guards a doclen override)
        tomb_only = (ctx.mutated and len(ctx.delta) == 0
                     and ctx.n_docs == idx.n_docs
                     and np.array_equal(ctx.doclen, idx.doclen))
        armed = not ctx.mutated or tomb_only
        margins_l = [len(ts) if armed else _KEEP_ALL_MARGIN for ts in known]
        iqs_l = ([self._iq_tomb(ts, ctx) if ts else 1 << 16 for ts in known]
                 if tomb_only else [1 << 16] * len(queries))
        return known, base_ts, tomb_only, armed, margins_l, iqs_l

    def _ranked_accumulate(self, queries: list, k: int, mode: str,
                           terms: Mapping[int, TermCaps] | None,
                           use_fused: bool, *, base_ts: list, armed: bool,
                           tomb_only: bool, margins_l: list, iqs_l: list,
                           qterms: list | None = None,
                           theta0_l: list | None = None):
        """The round loop of :meth:`_ranked_resident`: accumulate the batch's
        quantized impact codes device-resident and return the final state
        ``(acc, member, margins, iq, width)``, no threshold, no download.
        The epoch-derived inputs (``base_ts`` ... ``iqs_l``) come from
        :meth:`_ranked_params`: under sharded execution this engine serves
        one doc-range shard and they come from the parent's global epoch,
        with ``qterms`` the shard's restriction of the ``and_scored`` terms.
        ``theta0_l`` overrides the static OR thresholds: the sharded path
        pools the per-shard theta0 on the host (the max over shards is
        sound: some shard provably holds k docs reaching it) and seeds every
        shard with it; the per-round promotion stays shard-local."""
        ctx = self._cur()
        idx = ctx.gen
        nq = len(queries)
        ar = self.arena
        sa = ar.ensure_scores().scores
        dev = ar.device
        words, crows = intersect_rounds.bitmap_geometry(idx.n_docs)
        width = topk.accum_width(idx.n_docs)
        acc = torch.zeros((nq, width), dtype=torch.int32, device=dev)
        member = torch.zeros((nq, words), dtype=torch.int32, device=dev)
        gate = cov = None
        if mode == "and_scored":
            gate, _, cov = self._and_bitmap_resident(queries, terms,
                                                     use_fused, qterms=qterms)
        eff_gate = gate
        if gate is None and ctx.mutated and len(ctx.dead):
            # OR mode under deletes: the epoch's live row gates every lane,
            # one row a query in memory of its own (the wrappers and the
            # dense window gather take contiguous tensors)
            with self.tracer.span("ranked/tomb_gate", lane=self.trace_lane,
                                  dead=len(ctx.dead)):
                eff_gate = ctx.live_dev(words, dev).expand(
                    nq, words).contiguous()
                self.tracer.fence(eff_gate)
            self.metrics.inc("tomb_gates")
        gate_tiles = None
        if use_fused:       # the probe target of the fused rounds: the AND
            # bitmap (live-gated under mutation), the live rows, or (OR mode,
            # no deletes) all ones so only lane validity gates
            gate_tiles = (eff_gate if eff_gate is not None else torch.full(
                (nq, words), -1, dtype=torch.int32, device=dev)
                          ).reshape(nq * crows, -1)
        order = [sorted(ts, key=lambda t: -sa.term_max[t]) for ts in base_ts]
        margins = torch.as_tensor(margins_l, dtype=torch.int32, device=dev)
        iq_dev = torch.as_tensor(iqs_l, dtype=torch.int32, device=dev)
        if mode == "or" and armed:
            theta0 = (list(theta0_l) if theta0_l is not None else
                      [(sa.theta0_live(ts, k, ctx.dead) if tomb_only
                        else sa.theta0(ts, k)) for ts in base_ts])
        else:
            theta0 = [0] * nq
        theta_dev = torch.as_tensor(theta0, dtype=torch.int32, device=dev)
        nrounds = max((len(ts) for ts in order), default=0)
        for r in range(nrounds):
            # detached span: covers work-list selection, block-max pruning
            # and the round's kernel calls
            rsp = self.tracer.begin("ranked/round", lane=self.trace_lane,
                                    r=r, mode=mode)
            plain, fused_pairs, dense = [], [], []
            plain_ub, fused_ub, dense_ub = [], [], []
            for i in range(nq):
                ts = order[i]
                if len(ts) <= r or (cov is not None and i not in cov):
                    continue        # done, or AND seed empty: nothing scores
                t = ts[r]
                if mode == "or":
                    sel, pruned, ubs_i = self._prune_ranked_blocks(
                        sa, ts, r, theta0[i], iqs_l[i])
                else:
                    sel, pruned, ubs_i = (
                        self._select_blocks_static(t, *cov[i]), 0, None)
                self.metrics.inc("blocks_pruned", pruned)
                self.metrics.inc("blocks_scored", len(sel))
                f = use_fused and (terms[t].fused if terms is not None
                                   else ar.has_fused(t, sel))
                n_dense = 0
                for j, bi in enumerate(sel):
                    e = (i, t, int(bi))
                    u = int(ubs_i[j]) if ubs_i is not None else _UB_ALWAYS
                    if ((t, int(bi)) in ar.dense_slot
                            and (t, int(bi)) in sa.dense_slot):
                        dense.append(e)
                        dense_ub.append(u)
                        n_dense += 1
                    elif f:
                        fused_pairs.append(e)
                        fused_ub.append(u)
                    else:
                        plain.append(e)
                        plain_ub.append(u)
                self.metrics.inc("blocks_dense", n_dense)
            self.metrics.inc("score_rounds")
            probe = eff_gate if eff_gate is not None else member
            if plain:
                rows, qs, ns = self._stack_worklist(plain)
                codes = self._score_rows(sa, [(t, bi) for _, t, bi in plain])
                topk.score_round(
                    acc, member, rows, _to_device(qs, dev), codes,
                    _to_device(ns, dev), probe,
                    _to_device(np.asarray(plain_ub, np.int32), dev),
                    theta_dev, iq_dev, gated=eff_gate is not None)
            if fused_pairs:
                ids, hits, codes, qs, ubf = ar.fused_round_scored(
                    fused_pairs, gate_tiles, fused_ub)
                topk.score_round_masked(
                    acc, member, ids, _to_device(qs, dev), codes, hits,
                    _to_device(ubf, dev), theta_dev, iq_dev)
                del ids, hits, codes
            if dense:
                dw, dtiles, dqs, dw0, _, dub = self._stack_dense(
                    dense, dense_ub, with_codes=True)
                topk.dense_score_round(acc, member, dtiles, dw, dqs, dw0, dub,
                                       theta_dev, iq_dev, probe,
                                       gated=eff_gate is not None)
            if mode == "or" and armed and k <= width // 32 and r + 1 < nrounds:
                # adaptive promotion: the pooled k-th is a sound, monotone
                # lower bound on the final k-th sum (only with the full k:
                # fewer pooled groups than k would over-promote)
                theta_dev = torch.maximum(theta_dev,
                                          topk.pooled_threshold(acc, k))
            self.tracer.fence(acc)
            self.tracer.end(rsp, plain=len(plain), fused=len(fused_pairs),
                            dense=len(dense))
        return acc, member, margins, iq_dev, width

    def _ranked_rescore(self, queries: list, cand: list, k: int, mode: str,
                        known: list, ctx: _ExecCtx) -> list:
        """The exact float tail: block-lazy batch rescore of the candidates
        (sorted docids) on an unmutated epoch, else per query the union with
        the delta-segment scan, scored by the live-statistics oracle.  Span
        ``ranked/rescore``."""
        with self.tracer.span("ranked/rescore", lane=self.trace_lane,
                              nq=len(queries), mode=mode,
                              cands=sum(len(c) for c in cand)):
            if not ctx.mutated:
                return self._rescore_batch_blockwise(queries, cand, k)
            out = []
            for i, (q, c) in enumerate(zip(queries, cand)):
                if mode == "or":
                    d = ctx.delta.scan_any(known[i])
                else:
                    d = (ctx.delta.scan_and(known[i]) if known[i]
                         else _EMPTY_U32)
                out.append(self._score_docs(q, _merge_disjoint(c, d), k))
            return out

    # ---- doc-range sharded execution ---------------------------------------- #

    def _shard_engines(self, ctx: _ExecCtx):
        """The per-shard serving set of ``ctx``'s generation: a
        :class:`.shards.ShardSpec` plus one sub-engine per non-empty shard
        (empty ranges hold ``None``), each over a self-contained
        statistics-fixed shard generation (:func:`.shards.shard_generation`).
        The whole set is built eagerly and cached on the generation, keyed
        by (bounds, fused, devices), so a ``compact()`` swaps every shard
        at once: a pinned plan keeps the old generation's set through its
        ctx, and the new epoch's first query builds the new one.  With a
        mesh of one device per shard each shard's arenas live on its own
        device (and its calls run there, ``_pinned``); otherwise every shard
        runs on this engine's ``torch_device``."""
        cfg = self._shard_cfg
        gen = ctx.gen
        bounds = cfg["bounds"]
        if bounds is not None and bounds[-1] == gen.n_docs:
            spec = shards_lib.ShardSpec(bounds)
        else:
            # derived boundaries; also the fallback when explicit bounds
            # went stale across a compaction (the doc space changed)
            spec = shards_lib.ShardSpec.derive(gen, cfg["n"])
        mesh = cfg["mesh"]
        devs = (list(mesh) if mesh is not None and len(mesh) == spec.n_shards
                else None)
        key = (spec.bounds, self._fused,
               tuple(map(str, devs)) if devs is not None
               else str(self.torch_device))
        cache = gen.__dict__.setdefault("_shard_serving", {})
        got = cache.get(key)
        if got is None:
            engs = []
            for s, (lo, hi) in enumerate(spec.ranges()):
                if hi <= lo:
                    engs.append(None)
                    continue
                dev = devs[s] if devs is not None else self.torch_device
                sgen = shards_lib.shard_generation(gen, lo, hi)
                eng = QueryEngine(sgen).to_device(fused=self._fused,
                                                  torch_device=dev)
                eng.arena.ensure_scores()
                eng._shard_device = dev if devs is not None else None
                eng.trace_lane = f"shard{s}"    # own Perfetto lane
                eng.metrics.relabel(shard=f"s{s}")
                engs.append(eng)
            cache[key] = got = (spec, engs)
        return got[0], got[1], mesh

    def _shard_ctx(self, ctx: _ExecCtx, lo: int, hi: int, sgen) -> _ExecCtx:
        """A shard's frozen view of the parent epoch: tombstones translated
        into the shard's local docid space, an empty delta snapshot (delta
        docids all sit above the generation's doc space, so no shard serves
        them; the parent unions the delta scan into the final results), and
        the parent's live statistics where they matter.  The packed live
        row is pre-sliced at the shard boundary (``pack_live_words_range``),
        so a tombstone epoch uploads only each shard's words."""
        key = (ctx.skey, lo, hi)
        got = self._sctx_cache.get(key)
        if got is not None:
            return got
        sctx = _ExecCtx.__new__(_ExecCtx)
        sctx.gen = sgen
        sctx.mutated = ctx.mutated
        sctx._df = {}
        sctx._live_dev = None
        sctx._live_host = None
        sctx.delta = DeltaSegment.empty_snapshot() if ctx.mutated else None
        dead = ctx.dead
        sctx.dead = ((dead[(dead >= lo) & (dead < hi)] - lo)
                     if len(dead) else _EMPTY_I64)
        sctx.doclen = np.asarray(ctx.doclen)[lo:hi]
        sctx.n_docs = hi - lo
        sctx.avdl = ctx.avdl
        sctx.skey = tuple(ctx.skey) + (lo, hi)
        if len(sctx.dead):
            words, _ = intersect_rounds.bitmap_geometry(sgen.n_docs)
            sctx._live_host = intersect_rounds.pack_live_words_range(
                ctx.dead, lo, hi, words)
        self._sctx_cache[key] = sctx
        return sctx

    @staticmethod
    def _shard_qterms(ts: list, sgen) -> list:
        """One query's global rarest-first AND term list restricted to a
        shard.  A known term with no postings in the shard's range means no
        doc of the range can match: the ``[]`` sentinel (as for the
        delta-only case).  Otherwise the parent's order is kept: shard dfs
        are fixed up to the global ones."""
        if not ts or any(t not in sgen.terms for t in ts):
            return []
        return list(ts)

    @staticmethod
    @contextlib.contextmanager
    def _pinned(eng: "QueryEngine", sctx: _ExecCtx):
        """Run a sub-engine call under its shard ctx (and, placed on a mesh
        card, with that card current): the shard's rounds resolve
        ``_cur()`` to the shard's frozen epoch view, never the parent's."""
        prev = eng._ctx
        eng._ctx = sctx
        dev = eng._shard_device
        try:
            with (torch.cuda.device(dev) if dev is not None
                  and dev.type == "cuda" else contextlib.nullcontext()):
                yield
        finally:
            eng._ctx = prev

    def _execute_sharded(self, plan: ExecutionPlan, ctx: _ExecCtx) -> list:
        """Planned execution over the doc-range shard set: every resident
        round runs shard-local (no candidate crosses shards), a ranked batch
        merges once, and the exact float tail runs on the parent against
        global docids.  Results equal the unsharded paths bit for bit."""
        queries = [list(q) for q in plan.queries]
        fused = plan.placement == "fused"
        spec, engs, mesh = self._shard_engines(ctx)
        parts = [(lo, hi, eng, self._shard_ctx(ctx, lo, hi, eng.idx))
                 for (lo, hi), eng in zip(spec.ranges(), engs)
                 if eng is not None]
        if plan.mode == "and":
            return self._sharded_and(queries, fused, parts, ctx)
        return self._sharded_ranked(queries, plan.k, plan.mode, fused,
                                    parts, mesh, ctx)

    def _sharded_and(self, queries: list, fused: bool, parts: list,
                     ctx: _ExecCtx) -> list:
        """AND across shards: the parent resolves the batch's known terms
        once, each shard intersects its restriction device-resident, and
        the per-shard extractions concatenate in range order (already
        globally sorted: the ranges are disjoint and ascending)."""
        qterms = self._and_qterms(queries, ctx)
        per_q = [[] for _ in queries]
        for lo, hi, eng, sctx in parts:
            sub_q = [self._shard_qterms(ts, eng.idx) for ts in qterms]
            with self._pinned(eng, sctx):
                ids = eng._and_many_resident(queries, None, fused,
                                             qterms=sub_q)
            self.metrics.inc("shard_final_syncs")
            for i, a in enumerate(ids):
                if len(a):
                    per_q[i].append(a + np.uint32(lo))
        base = [(ps[0] if len(ps) == 1 else np.concatenate(ps)) if ps
                else _EMPTY_U32.copy() for ps in per_q]
        if not ctx.mutated:
            return base
        out = []
        for q, b in zip(queries, base):
            known = [t for t in q if self._df_live(t, ctx) > 0]
            d = ctx.delta.scan_and(known) if known else _EMPTY_U32
            out.append(_merge_disjoint(b, d))
        return out

    def _sharded_ranked(self, queries: list, k: int, mode: str, fused: bool,
                        parts: list, mesh, ctx: _ExecCtx) -> list:
        """Ranked top-k across shards, margin-preserving merge:

        1. the parent derives the epoch parameters once
           (:meth:`_ranked_params`) and, for an armed OR batch, pools the
           per-shard static thresholds on the host (max over shards);
        2. every shard runs the whole round loop shard-local
           (:meth:`_ranked_accumulate` under ``_pinned``);
        3. the one collective: per-shard (k-th quantized sum, candidate
           count) gathered and maxed (``collectives.merge_topk_stats``).
           ``theta_merged = max_s theta_s`` <= the global k-th sum, so every
           shard cut at ``theta_merged - margin`` keeps every global top-k
           doc: the union of the shards' candidates is a superset of the
           float top-k under the unsharded path's margin contract;
        4. per-shard candidate extraction, translated to global docids and
           concatenated in range order, feeds the parent's exact float tail
           (:meth:`_ranked_rescore`): bitwise the unsharded result."""
        nq = len(queries)
        known, base_ts, tomb_only, armed, margins_l, iqs_l = \
            self._ranked_params(queries, k, ctx)
        if known is None or not parts:
            return [[] for _ in queries]
        theta0_l = None
        if mode == "or" and armed:
            pooled = [0] * nq
            for lo, hi, eng, sctx in parts:
                sa = eng.arena.ensure_scores().scores
                for i, ts in enumerate(base_ts):
                    sts = [t for t in ts if t in eng.idx.terms]
                    if not sts:
                        continue
                    th = (sa.theta0_live(sts, k, sctx.dead) if tomb_only
                          else sa.theta0(sts, k))
                    if th > pooled[i]:
                        pooled[i] = int(th)
            theta0_l = pooled
        and_q = (self._and_qterms(queries, ctx) if mode == "and_scored"
                 else None)
        per_shard, th_parts, cnt_parts = [], [], []
        for lo, hi, eng, sctx in parts:
            sts = [[t for t in ts if t in eng.idx.terms] for ts in base_ts]
            qt = ([self._shard_qterms(ts, eng.idx) for ts in and_q]
                  if and_q is not None else None)
            with self._pinned(eng, sctx):
                acc, member, margins, iq_dev, _ = eng._ranked_accumulate(
                    queries, k, mode, None, fused, base_ts=sts, armed=armed,
                    tomb_only=tomb_only, margins_l=margins_l, iqs_l=iqs_l,
                    qterms=qt, theta0_l=theta0_l)
                # raw k on purpose: a shard holding fewer than k scored docs
                # reports theta 0 (the sound degenerate answer); min(k,
                # width) would report its width-th sum, which can exceed the
                # global k-th and break the superset contract
                th, cnt = topk.topk_stats(acc, k)
            per_shard.append((lo, hi, eng, sctx, acc, member, margins,
                              iq_dev))
            th_parts.append(th)
            cnt_parts.append(cnt)
        with self.tracer.span("sharded/merge", lane=self.trace_lane,
                              shards=len(parts), nq=nq):
            theta_m, _, wire = collectives.merge_topk_stats(th_parts,
                                                            cnt_parts,
                                                            mesh=mesh)
        self.metrics.inc("merge_syncs")
        self.metrics.inc("collective_bytes", int(wire))
        del th_parts, cnt_parts
        theta_np = theta_m.astype(np.int32)
        cand_parts = [[] for _ in queries]
        shard_cands = []
        while per_shard:
            lo, hi, eng, sctx, acc, member, margins, iq_dev = per_shard.pop(0)
            with self._pinned(eng, sctx):
                theta_dev = torch.as_tensor(theta_np, device=acc.device)
                bm = topk.candidate_bitmap(acc, member, theta_dev, margins,
                                           iq_dev)
                del acc, member
                self.metrics.inc("shard_final_syncs")
                ids = intersect_rounds.extract_ids(to_np(bm), hi - lo)
                del bm
            shard_cands.append(ids)
            for i, a in enumerate(ids):
                if len(a):
                    cand_parts[i].append(a + np.uint32(lo))
        self._last_shard_cands = shard_cands
        cand = [(ps[0] if len(ps) == 1 else np.concatenate(ps)) if ps
                else _EMPTY_U32 for ps in cand_parts]
        return self._ranked_rescore(queries, cand, k, mode, known, ctx)

    # ---- planned execution -------------------------------------------------- #

    def plan(self, batch: QueryBatch,
             placement: Optional[str] = None) -> ExecutionPlan:
        """Resolve a batch into a typed :class:`ExecutionPlan` (span
        ``engine/plan``): placement (host / device / fused, following the
        engine's arena state) plus every known term's codec capabilities.

        Auto-placement (``placement=None``) demotes batches of at most
        ``HOST_BATCH_MAX`` queries (or an installed crossover table's cut)
        to the host; ``plan.note`` records it.  An explicit ``placement``
        skips the demotion and is validated against the arena state.

        The plan pins the current mutation epoch (:class:`_ExecCtx`): run
        after later writes or a ``compact()``, it returns what it would have
        returned at plan time."""
        with self.tracer.span("engine/plan", lane=self.trace_lane,
                              mode=batch.mode, nq=len(batch.queries)):
            return self._plan_impl(batch, placement)

    def _plan_impl(self, batch: QueryBatch,
                   placement: Optional[str] = None) -> ExecutionPlan:
        _check_mode(batch.mode)
        ctx = self._cur()
        note = ""
        resident = self.arena is not None or self._shard_cfg is not None
        if placement is not None:
            if placement not in PLACEMENTS:
                raise ValueError(f"unknown placement {placement!r}; "
                                 f"placements: {PLACEMENTS}")
            if placement != "host" and not resident:
                raise ValueError(
                    f"explicit placement {placement!r} needs device arenas; "
                    "call to_device() on this engine first")
            if placement == "fused" and not self._fused:
                raise ValueError(
                    "explicit placement 'fused' needs fused tile arenas; "
                    "call to_device(fused=True) on this engine first")
            note = f"placement {placement!r} pinned by caller"
        else:
            placement = ("fused" if resident and self._fused
                         else "device" if resident else "host")
            if placement != "host":
                n = len(batch.queries)
                xo = get_crossover()
                cut = xo.cut_for(batch.mode) if xo is not None else None
                if cut is not None:
                    if n <= cut:
                        note = (f"auto-placed host: batch={n} <= "
                                f"host_batch_max={cut} for "
                                f"mode={batch.mode!r} "
                                f"(measured crossover, {xo.source}, "
                                f"sizes={list(xo.sizes)})")
                        placement = "host"
                elif n <= HOST_BATCH_MAX:
                    note = (f"auto-placed host: batch={n} <= "
                            f"HOST_BATCH_MAX={HOST_BATCH_MAX} "
                            "(static rule; no measured crossover)")
                    placement = "host"
        if self._shard_cfg is not None and placement != "host":
            spec, _, mesh = self._shard_engines(ctx)
            snote = (f"sharded x{spec.n_shards} bounds={list(spec.bounds)} "
                     f"({'mesh-placed' if mesh is not None else 'logical'})")
            note = f"{note}; {snote}" if note else snote
        if ctx.mutated:
            mnote = (f"pinned epoch {ctx.skey}: {len(ctx.dead)} tombstone(s), "
                     f"{len(ctx.delta)} delta doc(s)")
            note = f"{note}; {mnote}" if note else mnote
        terms: dict[int, TermCaps] = {}
        for q in batch.queries:
            for t in q:
                if t in terms:
                    continue
                if t in ctx.gen.terms:
                    blocks = ctx.gen.terms[t].blocks
                    name = blocks[0][1].codec if blocks else None
                    spec = codec_lib.get(name) if name is not None else None
                    # a sharded plan records the nominal capability: each
                    # shard probes its own arena's fused coverage when it
                    # runs (its block geometry differs)
                    terms[t] = TermCaps(
                        codec=name,
                        arena=bool(spec is not None
                                   and spec.arena is not None),
                        fused=(placement == "fused"
                               and (self._shard_cfg is not None
                                    or self.arena.has_fused(
                                        t, range(len(blocks))))))
                elif ctx.delta is not None and ctx.delta.has_term(t):
                    # delta-only term: no compressed blocks, host scan only
                    terms[t] = TermCaps(codec=None, arena=False, fused=False)
        return ExecutionPlan(mode=batch.mode, k=batch.k, placement=placement,
                             queries=tuple(tuple(q) for q in batch.queries),
                             terms=terms, note=note, ctx=ctx)

    def execute(self, work) -> list:
        """Run an :class:`ExecutionPlan` (span ``engine/execute``); results
        align with the planned queries.  Passing a ``QueryBatch`` plans
        implicitly (bit-identical results).

        On the host placement queries run grouped by sorted term signature
        so queries sharing terms hit the decoded-block and score caches back
        to back; on the device/fused placements the batch runs round-batched
        and device-resident: mode ``and`` through ``_and_many_resident``,
        the ranked modes through ``_ranked_resident``; a sharded engine runs
        the batch over its shard set (``_execute_sharded``)."""
        if isinstance(work, QueryBatch):
            work = self.plan(work)
        with self.tracer.span("engine/execute", lane=self.trace_lane,
                              mode=work.mode, placement=work.placement,
                              nq=len(work.queries)):
            return self._execute_impl(work)

    def _execute_impl(self, plan: ExecutionPlan) -> list:
        _check_mode(plan.mode)
        ctx: _ExecCtx = plan.ctx if plan.ctx is not None else self._cur()
        if plan.placement != "host":
            if self._shard_cfg is not None:
                # the shard set (not self.arena) holds the arenas; the
                # sub-engines pin their shard ctxs per call
                prev_ctx, self._ctx = self._ctx, ctx
                try:
                    return self._execute_sharded(plan, ctx)
                finally:
                    self._ctx = prev_ctx
            if self.arena is None:
                raise ValueError(
                    f"plan placement {plan.placement!r} needs device arenas; "
                    "call to_device() on this engine (or re-plan on it) first")
            arena = self._arena_ctx(ctx)
            if plan.placement == "fused" and arena._pk is None:
                raise ValueError(
                    "plan placement 'fused' needs fused tile arenas; call "
                    "to_device(fused=True) on this engine (or re-plan on it) "
                    "first")
            prev_ctx, self._ctx = self._ctx, ctx
            prev_arena, self.arena = self.arena, arena
            try:
                return self._execute_device(plan, ctx)
            finally:
                self._ctx, self.arena = prev_ctx, prev_arena
        fn = {"and": self.and_query,
              "or": lambda q: self.or_query(q, plan.k),
              "and_scored": lambda q: self.and_query_scored(q, plan.k)
              }[plan.mode]
        order = sorted(range(len(plan.queries)),
                       key=lambda i: tuple(sorted(plan.queries[i])))
        results = [None] * len(plan.queries)
        # a host plan stays pinned to host intersection AND host block
        # decodes even on an engine that has arenas
        prev_ctx, self._ctx = self._ctx, ctx
        prev_fused, self._fused = self._fused, False
        prev_arena, self.arena = self.arena, None
        try:
            for i in order:
                results[i] = fn(list(plan.queries[i]))
        finally:
            self._ctx = prev_ctx
            self._fused, self.arena = prev_fused, prev_arena
        return results

    def _execute_device(self, plan: ExecutionPlan, ctx: _ExecCtx) -> list:
        queries = [list(q) for q in plan.queries]
        fused = plan.placement == "fused"
        if plan.mode == "and":
            base = self._and_many_resident(queries, plan.terms, fused)
            if not ctx.mutated:
                return base
            out = []
            for q, b in zip(queries, base):
                known = [t for t in q if self._df_live(t, ctx) > 0]
                d = ctx.delta.scan_and(known) if known else _EMPTY_U32
                out.append(_merge_disjoint(b, d))
            return out
        return self._ranked_resident(queries, plan.k, plan.mode, plan.terms,
                                     fused)
