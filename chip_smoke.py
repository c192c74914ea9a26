#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Drives the port's main paths, fused device-resident AND serving, ranked
BM25 top-k serving (modes ``or`` and ``and_scored``) and the stream codec
(encode and decode of every posting list), through the entry points a user
calls, at the real document count of the TREC GOV2 collection, and holds
every CUDA kernel of the paths against its plain torch version on the
card:

  card       the card, its power limit, torch / CUDA / nvcc versions
  build      nvcc builds every kernels/csrc/*.cu (one process per source)
  main path  GOV2-statistics corpus (synth's Zipf formula, 200 terms) at
             25,205,179 docs; InvertedIndex.build; QueryEngine.to_device(
             fused=True); one batch of 256 AND queries to warm up, then a
             fresh batch of 256 from the same distribution timed with every
             launch count set to 0 just before (block cache warm, round memo
             cold), then that batch repeated (round memo warm).  Every result
             is checked against a numpy oracle on the raw postings;
             cand_syncs == 0, final_syncs == 1, <= 1 decode per hot block,
             and kernels B1 and B2 launched.  A third fresh batch runs under
             the fenced span tracer for the time breakdown.
  legacy     ``and_many`` on 16 of the queries (kernel B5), counts set to 0
             just before; results equal the main path's.
  ranked     on the same index: ``ensure_scores()``, then per mode (``or``,
             ``and_scored``, k=10, fused placement) a warm-up batch of 256
             queries drawn like the AND batches (own generator), a fresh
             batch timed with every launch count set to 0 just before, and
             a third fresh batch under the fenced span tracer.  Every result
             equals a numpy oracle (a dense float64 accumulator per query,
             term scores added in query-term order, ``topk_select``'s rule);
             final_syncs == 1, score_syncs == cand_syncs == 0, and kernels
             B1, B2 (both forms) and B3 launched, B4 too where the batch
             scored dense-bitmap blocks.
  stream     the stream codec (``kernels/ops.py``) on every one of the
             corpus's 200 posting lists, counts set to 0 just before: the
             d-gaps uploaded, ``select_bw`` (B9) equal to numpy's per-frame
             widths, ``pack_stream`` (B7a) at the list's widest frame, the
             fused decode ``unpack_delta_stream`` (B6) and the two-pass one,
             ``unpack_stream`` (B7b) then ``prefix_sum`` (B8), each equal to
             numpy (gaps, docids); then ``bitmap_intersect_np(use_pallas=
             True)`` (B10) on the two longest lists equal to
             ``np.intersect1d``; B6-B10 launched.  Then the whole-corpus
             decode rate, fused and two-pass, in postings per second: CUDA
             events around the 200 lists, warm, host enqueue included.
  kernels    B1 (every bit-width bucket), B5, B2 (both forms), B3, B4 and
             B6-B10 on inputs made from --seed at the largest shape any main
             path gave each kernel (B1 probed against a random bitmap and
             against all ones, as the ``or`` rounds probe; B2's add form at
             the AND path's shape, as first recorded, and at the ranked
             path's), compared bitwise with their plain versions; B6, B7a
             and B7b also at every bit width 1..32, B8 also on a sum that
             wraps past 2**32, a ragged row count, 1,001 tiles with a
             ragged end (more than the card holds at once) and two calls
             queued back to back on inputs of one shape.  CUDA-event times
             (median of 30 after warm-up, each call queued behind a spin of
             the card so the events bracket device work, not the host's
             enqueue) of kernel, plain version and the library call where
             one computes the same function (``index_put_(accumulate=True)``
             for B2 and B4, ``torch.cumsum`` for B8, ``torch.bitwise_and``
             for B10); for B6-B10 also the time of one call from an idle
             queue (host enqueue included); the bytes bound.  For B8 and
             B10 the grid launches and memsets one call puts on the card,
             counted from a ``torch.profiler`` trace; B10 and
             ``torch.bitwise_and`` also at 65,536 rows (3 x 32 MiB, above
             the 50 MB L2).

Prints one ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
...}``.  Any failed phase raises and the script exits nonzero without that
line.  Usage::

    python3 chip_smoke.py [--seed 0] [--n-docs 25205179]

``--n-docs`` below GOV2's count runs a doc-range shard and prints it on a
``reduced`` line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

GOV2_DOCS = 25_205_179          # documents in the TREC GOV2 collection
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3, NVIDIA data sheet
TIMED_RUNS = 30
SPIN_CYCLES = 2_000_000         # about 1 ms of the card's clock
DECODE_RUNS = 5                 # whole-corpus decode passes timed per form
QUERIES = 256                   # queries per batch on the main paths
LEGACY_QUERIES = 16             # of the AND queries, through and_many
RANKED_K = 10                   # top-k of the ranked batches
QUERY_TERMS = 120               # queries draw from the most frequent terms


def log(msg: str) -> None:
    print(msg, flush=True)


def run_cmd(cmd: list) -> str:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return (out.stdout or out.stderr).strip()


# --------------------------------------------------------------------------- #
# timing and comparison helpers
# --------------------------------------------------------------------------- #


def cuda_ms(fn, torch, primed: bool = True) -> float:
    """Median CUDA-event time of ``fn()`` over TIMED_RUNS calls, after two
    warm-up calls.  ``primed``: each call is queued behind a spin of the
    card (``torch.cuda._sleep``, about 1 ms), so the events bracket its
    device work and not the host's time to enqueue it; otherwise the call
    starts from an idle queue and the host's enqueue counts."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(TIMED_RUNS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if primed:
            torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ops(fn, torch) -> dict:
    """Kernels and memsets that one call of ``fn()`` puts on the card,
    counted from a ``torch.profiler`` trace of that call (after one
    warm-up call).  Raises if the trace holds no kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = {"grid_launches": 0, "memsets": 0}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.key.startswith("Memset"):
                ops["memsets"] += e.count
            elif not e.key.startswith("Memcpy"):
                ops["grid_launches"] += e.count
    if not ops["grid_launches"]:
        raise AssertionError("the torch.profiler trace holds no kernel")
    return ops


def max_abs_err(got, want, torch) -> int:
    """Largest |got - want| over the outputs, as unsigned 32-bit words."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        d = ((g.long() & 0xFFFFFFFF) - (w.long() & 0xFFFFFFFF)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


# --------------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------------- #


def oracle_and(postings: dict, q: list, np):
    """Independent AND: the rarest term's docids, kept where searchsorted
    finds them in every other term's sorted docids."""
    ts = sorted((t for t in q if t in postings), key=lambda t: len(postings[t][0]))
    if not ts:
        return np.zeros(0, np.uint32)
    ids = postings[ts[0]][0]
    for t in ts[1:]:
        other = postings[t][0]
        pos = np.searchsorted(other, ids)
        ok = pos < len(other)
        ids = ids[ok][other[pos[ok]] == ids[ok]]
    return ids


def oracle_or(term_sc: dict, q: list, k: int, buf, np, topk_select) -> list:
    """Independent OR top-k: a dense float64 accumulator over all docs (the
    reusable ``buf`` pair, left zeroed), each term's BM25 impacts added in
    query-term order, then ``topk_select``'s argpartition + docid rule."""
    acc, hit = buf
    for t in q:
        ids, sc = term_sc[t]
        acc[ids] += sc
        hit[ids] = True
    docs = np.flatnonzero(hit)
    res = topk_select(docs, acc[docs], k)
    acc[docs] = 0.0
    hit[docs] = False
    return res


def oracle_and_scored(postings: dict, term_sc: dict, q: list, k: int, np,
                      topk_select) -> list:
    """Independent and_scored top-k: the AND oracle's docids, scored in
    query-term order."""
    docs = oracle_and(postings, q, np)
    scores = np.zeros(len(docs))
    for t in q:
        ids, sc = term_sc[t]
        scores += sc[np.searchsorted(ids, docs)]
    return topk_select(docs, scores, k)


def span_breakdown(tracer, children: tuple) -> dict:
    """{span name: (count, ms)} of the tracer's spans, plus "rest of
    execute": ``engine/execute`` minus the named ``children`` (disjoint
    intervals inside it)."""
    out = {}
    for sp in tracer.spans():
        n, tot = out.get(sp.name, (0, 0.0))
        out[sp.name] = (n + 1, tot + sp.dur * 1e3)
    rest = out.get("engine/execute", (0, 0.0))[1] - sum(
        out.get(c, (0, 0.0))[1] for c in children)
    out["rest of execute"] = (1, rest)
    return out


def pow2_bucket(k: int) -> int:
    """The launch width the power-of-two work-list buckets (smallest 8) of
    the JAX package give ``k`` entries; the port launches ``k``."""
    w = 8
    while w < k:
        w *= 2
    return w


def bucketed_widths(recent: list) -> dict:
    """Launch widths of B1 and B2 as recorded, and as the power-of-two
    buckets would have made them: each B1 call padded on its own, a B2 call
    that scatters the B1 calls just before it padded as their sum, any
    other B2 call padded on its own."""
    exact = {"B1": 0, "B2": 0}
    padded = {"B1": 0, "B2": 0}
    pending = []
    for kernel, shape in recent:
        if kernel == "B1":
            pending.append(shape["W"])
            exact["B1"] += shape["W"]
            padded["B1"] += pow2_bucket(shape["W"])
        elif kernel == "B2":
            exact["B2"] += shape["P"]
            padded["B2"] += (sum(map(pow2_bucket, pending))
                             if pending and sum(pending) == shape["P"]
                             else pow2_bucket(shape["P"]))
            pending = []
    return {"exact": exact, "pow2": padded}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-docs", type=int, default=GOV2_DOCS)
    args = ap.parse_args()

    root = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(root, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        log(f"FAIL: {src}/repro_torch not found: run from a checkout of the repo")
        return 2
    sys.path.insert(0, src)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is False: this smoke needs a GPU")
        return 2

    from repro_torch.data import synth
    from repro_torch.index.engine import QueryBatch, QueryEngine
    from repro_torch import kernels as K
    from repro_torch.index.invindex import InvertedIndex
    from repro_torch.index.scores import bm25_scores, topk_select
    from repro_torch.core.bits import ebw_np, from_np, to_np
    from repro_torch.core.dgap import dgap_encode_np
    from repro_torch.kernels import (accumulate, bitpack, cuda_build,
                                     decode_fused, intersect,
                                     intersect_rounds, ops, quadmax, scan_add,
                                     topk, unpack_delta)
    from repro_torch.kernels.bitpack import FRAME_INTS
    from repro_torch.kernels.decode_fused import BW_BUCKETS, rows_per_block
    from repro_torch.obs.trace import enable_tracing

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    phase_s = {}
    mark = [t_start]

    def phase_done(name):
        """Print and keep the seconds since the previous phase ended."""
        now = time.perf_counter()
        phase_s[name] = now - mark[0]
        mark[0] = now
        log(f"-- phase {name}: {phase_s[name]:.1f} s")

    # ---- card ------------------------------------------------------------ #
    smi = run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"])
    log("== card")
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()} python {sys.version.split()[0]}")
    log(run_cmd([cuda_build.nvcc(), "--version"]).splitlines()[-1])

    # ---- build ------------------------------------------------------------ #
    log("== build")
    t0 = time.perf_counter()
    took = cuda_build.build(verbose=True)
    log(f"built {sorted(took)} in {time.perf_counter() - t0:.2f} s (parallel nvcc)")

    # ---- main path -------------------------------------------------------- #
    phase_done("card and build")
    log("== main path: fused device-resident AND")
    if args.n_docs != GOV2_DOCS:
        log(f"reduced: n_docs={args.n_docs} of GOV2's {GOV2_DOCS}")
    t0 = time.perf_counter()
    doclen, postings = synth.make_corpus("gov2", seed=args.seed,
                                         n_docs=args.n_docs)
    n_post = sum(len(v[0]) for v in postings.values())
    log(f"corpus: {args.n_docs} docs, {len(postings)} terms, {n_post} "
        f"postings in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    idx = InvertedIndex.build(doclen, postings)
    n_blocks = sum(len(tp.blocks) for tp in idx.terms.values())
    log(f"InvertedIndex.build: {n_blocks} blocks in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    eng = QueryEngine(idx, cache_blocks=1 << 22).to_device(fused=True)
    torch.cuda.synchronize()
    ar = eng.arena
    log(f"to_device(fused=True): {time.perf_counter() - t0:.2f} s, "
        f"{len(ar.dense_slot)} dense windows, fused tiles per bw "
        f"{ {bw: len(pk['n']) for bw, pk in ar._pk.items()} }")

    rng = np.random.default_rng(args.seed + 3)
    terms = sorted(postings)

    def draw_batch():
        """QUERIES AND queries of 2-3 terms from the 120 most frequent, with
        the oracle's answers."""
        qs = [rng.choice(terms[:QUERY_TERMS], size=rng.integers(2, 4),
                         replace=False).tolist() for _ in range(QUERIES)]
        return qs, [oracle_and(postings, q, np) for q in qs]

    def check(what, queries, got, want):
        for q, a, b in zip(queries, got, want):
            if not np.array_equal(a, b):
                raise AssertionError(f"{what}, query {q}: {len(a)} docids, "
                                     f"oracle {len(b)}")

    def run_batch(queries):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.execute(eng.plan(QueryBatch(queries, mode="and")))
        return res, time.perf_counter() - t0

    t0 = time.perf_counter()
    (warm_q, warm_want), (queries, want), (traced_q, traced_want) = (
        draw_batch(), draw_batch(), draw_batch())
    log(f"numpy oracle, 3 batches: {time.perf_counter() - t0:.2f} s")
    with eng.metrics.scoped() as all_batches:
        warm, dt = run_batch(warm_q)
        log(f"warm-up batch (cold caches): {dt:.2f} s")
        check("warm-up batch", warm_q, warm, warm_want)

        # the main path: a fresh batch (block cache warm, round memo cold)
        fused0 = ar.stats["fused_blocks"]
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        with eng.metrics.scoped() as s:
            res, dt = run_batch(queries)
        launches = dict(K.LAUNCHES)
        recent = list(K.RECENT)
        peak = torch.cuda.max_memory_allocated()
        check("timed batch", queries, res, want)
        stats = {n: s.delta(n) for n in ("resident_rounds", "cand_syncs",
                                         "final_syncs", "worklist_refs",
                                         "worklist_decodes", "blocks_dense")}
        fused_entries = ar.stats["fused_blocks"] - fused0
        widths = bucketed_widths(recent)
        log(f"timed fresh batch: {QUERIES} queries in {dt:.4f} s = "
            f"{QUERIES / dt:.2f} qps (host clock, ends in the result copy)")
        log(f"rounds {stats['resident_rounds']}, worklist_refs "
            f"{stats['worklist_refs']}, fused entries {fused_entries}, dense "
            f"entries {stats['blocks_dense']}, decodes "
            f"{stats['worklist_decodes']}")
        log(f"launches {launches}; max_memory_allocated {peak} bytes "
            f"({peak / 2**30:.2f} GiB); mean result size "
            f"{np.mean([len(r) for r in res]):.1f}")
        for k in ("B1", "B2"):
            ex, p2 = widths["exact"][k], widths["pow2"][k]
            log(f"{k} launch width: {ex} entries in "
                f"{sum(1 for n, _ in recent if n == k)} launches; "
                f"power-of-two buckets would launch {p2} "
                f"(padded share {(p2 - ex) / p2:.4f}); padded share now 0")
        if widths["exact"]["B1"] != fused_entries:
            raise AssertionError(f"B1 launched {widths['exact']['B1']} "
                                 f"entries for {fused_entries} fused entries")
        if stats["cand_syncs"] != 0 or stats["final_syncs"] != 1:
            raise AssertionError(f"syncs: {stats}")
        if launches["B1"] <= 0 or launches["B2"] <= 0:
            raise AssertionError(f"main path did not launch B1 and B2: "
                                 f"{launches}")
        main_launches = launches

        # the same batch again: the round memo now holds its stacked rows
        with eng.metrics.scoped() as s:
            again, dt_again = run_batch(queries)
        check("repeated batch", queries, again, want)
        log(f"repeated batch: {QUERIES / dt_again:.2f} qps ({dt_again:.4f} s)")
        if s.delta("worklist_decodes") != 0:
            raise AssertionError("the repeated batch decoded again: "
                                 f"{s.delta('worklist_decodes')}")

        # where a fresh batch's time goes: the span tracer on and fenced
        # (each round span waits for the card), not timed
        tracer = enable_tracing(True, fenced=True)
        tracer.clear()
        traced, dt_traced = run_batch(traced_q)
        enable_tracing(False)
        check("traced batch", traced_q, traced, traced_want)
    spans = span_breakdown(tracer, ("and/seed", "and/round",
                                    "kernel/extract_ids"))
    log(f"fenced span breakdown of another fresh batch ({dt_traced:.4f} s):")
    for name, (n, tot) in sorted(spans.items(), key=lambda kv: -kv[1][1]):
        log(f"  {name:24s} x{n:<3d} {tot:10.2f} ms")
    tracer.clear()
    hot = {k for k in eng.cache.keys() if k[1] >= 0}
    decodes = (all_batches.delta("worklist_decodes")
               + all_batches.delta("fallback_decodes"))
    log(f"decodes over the 4 batches: {decodes} for {len(hot)} hot blocks")
    if eng.cache.evictions or decodes != len(hot):
        raise AssertionError(f"decodes per hot block: {decodes} decodes "
                             f"for {len(hot)} hot blocks, "
                             f"{eng.cache.evictions} evictions")

    # ---- legacy path ------------------------------------------------------ #
    phase_done("AND path")
    log("== legacy and_many (kernel B5)")
    sub = queries[:LEGACY_QUERIES]
    K.reset_launches()
    t0 = time.perf_counter()
    legacy = eng.and_many(sub)
    dt_legacy = time.perf_counter() - t0
    legacy_launches = K.LAUNCHES["B5"]
    recent += list(K.RECENT)
    check("and_many", sub, legacy, want)
    log(f"and_many: {len(sub)} queries in {dt_legacy:.3f} s, launches "
        f"{dict(K.LAUNCHES)}")
    if legacy_launches <= 0:
        raise AssertionError("legacy path did not launch B5")

    # ---- ranked path ------------------------------------------------------ #
    phase_done("legacy")
    log("== ranked path: fused device-resident top-k (or, and_scored)")
    t0 = time.perf_counter()
    ar.ensure_scores()
    torch.cuda.synchronize()
    sa = ar.scores
    log(f"ensure_scores: {time.perf_counter() - t0:.2f} s, "
        f"{sa.tiles.shape[0]} score rows, {len(sa.dense_slot)} dense code "
        f"windows, delta {sa.delta!r}")
    t0 = time.perf_counter()
    avdl = float(np.asarray(doclen).mean())       # Generation.avdl's formula
    term_sc = {t: (postings[t][0],
                   bm25_scores(postings[t][1], doclen[postings[t][0]],
                               len(postings[t][0]), len(doclen), avdl))
               for t in terms[:QUERY_TERMS]}
    buf = (np.zeros(len(doclen)), np.zeros(len(doclen), bool))
    log(f"oracle term scores: {time.perf_counter() - t0:.2f} s")
    rrng = np.random.default_rng(args.seed + 5)

    def draw_ranked(mode):
        """QUERIES ranked queries shaped like the AND batches, with the
        oracle's answers."""
        qs = [rrng.choice(terms[:QUERY_TERMS], size=rrng.integers(2, 4),
                          replace=False).tolist() for _ in range(QUERIES)]
        if mode == "or":
            want = [oracle_or(term_sc, q, RANKED_K, buf, np, topk_select)
                    for q in qs]
        else:
            want = [oracle_and_scored(postings, term_sc, q, RANKED_K, np,
                                      topk_select) for q in qs]
        return qs, want

    def check_ranked(what, queries, got, want):
        for q, a, b in zip(queries, got, want):
            if a != b:
                raise AssertionError(f"{what}, query {q}: {a[:3]}..., "
                                     f"oracle {b[:3]}...")

    def run_ranked(queries, mode):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.execute(eng.plan(QueryBatch(queries, mode=mode,
                                              k=RANKED_K)))
        return res, time.perf_counter() - t0

    ranked = {}
    for mode in ("or", "and_scored"):
        t0 = time.perf_counter()
        (warm_q, warm_want), (rq, rwant), (traced_q, traced_want) = (
            draw_ranked(mode), draw_ranked(mode), draw_ranked(mode))
        log(f"{mode}: numpy oracle, 3 batches: "
            f"{time.perf_counter() - t0:.2f} s")
        torch.cuda.reset_peak_memory_stats()
        warm, dt = run_ranked(warm_q, mode)
        log(f"{mode} warm-up batch: {dt:.2f} s")
        check_ranked(f"{mode} warm-up batch", warm_q, warm, warm_want)

        fused0 = ar.stats["fused_blocks"]
        K.reset_launches()
        with eng.metrics.scoped() as s:
            res, dt = run_ranked(rq, mode)
        launches = dict(K.LAUNCHES)
        rrecent = list(K.RECENT)
        peak = torch.cuda.max_memory_allocated()
        check_ranked(f"{mode} timed batch", rq, res, rwant)
        stats = {n: s.delta(n) for n in (
            "final_syncs", "score_syncs", "cand_syncs", "score_rounds",
            "blocks_scored", "blocks_pruned", "blocks_dense",
            "resident_rounds", "worklist_decodes", "fallback_decodes")}
        widths = {k: sum(sh.get("W", sh.get("P", 0)) for n, sh in rrecent
                         if n == k) for k in launches}
        log(f"{mode} timed fresh batch: {QUERIES} queries in {dt:.4f} s = "
            f"{QUERIES / dt:.2f} qps (host clock, ends in the rescore)")
        log(f"{mode} counters {stats}; fused entries "
            f"{ar.stats['fused_blocks'] - fused0}")
        log(f"{mode} launches {launches}; entries per kernel {widths}")
        log(f"{mode} max_memory_allocated {peak} bytes "
            f"({peak / 2**30:.2f} GiB) over the warm-up and timed batches")
        if (stats["final_syncs"] != 1 or stats["score_syncs"] != 0
                or stats["cand_syncs"] != 0):
            raise AssertionError(f"{mode} syncs: {stats}")
        for k in ("B1", "B2", "B2add", "B3"):
            if launches[k] <= 0:
                raise AssertionError(f"{mode} did not launch {k}: {launches}")
        if stats["blocks_dense"] > 0 and launches["B4"] <= 0:
            raise AssertionError(f"{mode} scored dense blocks without B4: "
                                 f"{launches}")

        tracer = enable_tracing(True, fenced=True)
        tracer.clear()
        traced, dt_traced = run_ranked(traced_q, mode)
        enable_tracing(False)
        check_ranked(f"{mode} traced batch", traced_q, traced, traced_want)
        spans = span_breakdown(tracer, ("and/seed", "and/round",
                                        "ranked/round", "kernel/topk",
                                        "kernel/extract_ids",
                                        "ranked/rescore"))
        tracer.clear()
        log(f"{mode} fenced span breakdown of another fresh batch "
            f"({dt_traced:.4f} s):")
        for name, (n, tot) in sorted(spans.items(), key=lambda kv: -kv[1][1]):
            log(f"  {name:24s} x{n:<3d} {tot:10.2f} ms")
        ranked[mode] = {"qps": QUERIES / dt, "seconds": dt, "stats": stats,
                        "launches": launches, "recent": rrecent,
                        "peak_bytes": peak,
                        "spans_ms": {n: v[1] for n, v in spans.items()}}
        del warm, res, traced

    # shapes the main paths gave each kernel: B1 and B2's bits form run on
    # the AND path and on both ranked modes, B5 on the legacy path
    paths = {"and": recent, **{m: v["recent"] for m, v in ranked.items()}}
    calls = {k: [(path, sh) for path, rec in paths.items() for n, sh in rec
                 if n == k] for k in ("B1", "B2", "B5")}
    rcalls = {k: [sh for m in ranked.values() for n, sh in m["recent"]
                  if n == k] for k in ("B2add", "B3", "B4")}
    ranked_launches = {k: {m: v["launches"][k] for m, v in ranked.items()}
                       for k in ("B1", "B2", "B2add", "B3", "B4")}
    n_docs = idx.n_docs
    del eng, idx, ar, sa, again, legacy, term_sc, buf
    torch.cuda.empty_cache()

    # ---- stream codec path ------------------------------------------------ #
    phase_done("ranked path")
    log("== stream codec path: select_bw, pack, fused and two-pass decode "
        "(B6-B10)")
    t0 = time.perf_counter()
    lists = []                  # (docids, gaps, numpy's per-frame widths)
    for t in terms:
        ids = postings[t][0]
        gaps = dgap_encode_np(ids)
        f = -(-len(gaps) // FRAME_INTS)
        tiles = np.zeros(f * FRAME_INTS, np.uint32)
        tiles[:len(gaps)] = gaps
        lists.append((ids, gaps, np.maximum(ebw_np(np.bitwise_or.reduce(
            tiles.reshape(f, -1), axis=1)), 1)))
    del postings
    n_stream = sum(len(ids) for ids, _, _ in lists)
    log(f"numpy d-gaps and widths of {len(lists)} lists, {n_stream} "
        f"postings: {time.perf_counter() - t0:.2f} s")

    def same(what, got, want):
        if not np.array_equal(to_np(got), want):
            raise AssertionError(f"stream phase, {what}: differs from numpy")

    K.reset_launches()
    t0 = time.perf_counter()
    packed_all, packed_words = [], 0
    for i, (ids, gaps, want_bws) in enumerate(lists):
        g = from_np(gaps, dev)
        same(f"list {i} select_bw", ops.select_bw(g), want_bws)
        bw, n = int(want_bws.max()), len(ids)
        packed = ops.pack_stream(g, bw)
        same(f"list {i} fused decode", ops.unpack_delta_stream(packed, bw, n),
             ids)
        back = ops.unpack_stream(packed, bw, n)
        same(f"list {i} unpack", back, gaps)
        same(f"list {i} two-pass decode", ops.prefix_sum(back), ids)
        packed_all.append((packed, bw, n))
        packed_words += packed.numel()
    a, b = sorted((ids for ids, _, _ in lists), key=len)[-2:]
    both = intersect.bitmap_intersect_np(a, b, use_pallas=True)
    if not np.array_equal(both, np.intersect1d(a, b)):
        raise AssertionError("bitmap_intersect_np(use_pallas=True) differs "
                             "from np.intersect1d")
    torch.cuda.synchronize()
    dt_stream = time.perf_counter() - t0
    stream_launches = {k: K.LAUNCHES[k] for k in
                       ("B6", "B7a", "B7b", "B8", "B9", "B10")}
    scalls = {k: [sh for n_, sh in K.RECENT if n_ == k]
              for k in stream_launches}
    log(f"{len(lists)} lists encoded and decoded both ways, all equal to "
        f"numpy, and the intersection of the two longest ({len(a)}, "
        f"{len(b)} postings: {len(both)} docids) equal to np.intersect1d, "
        f"in {dt_stream:.2f} s; launches {stream_launches}")
    log(f"packed size {packed_words * 32 / n_stream:.4f} bits per posting "
        f"(list widths {min(bw for _, bw, _ in packed_all)}-"
        f"{max(bw for _, bw, _ in packed_all)})")
    if min(stream_launches.values()) <= 0:
        raise AssertionError(f"stream phase missed a kernel: "
                             f"{stream_launches}")

    def decode_all(fused):
        for packed, bw, n in packed_all:
            if fused:
                ops.unpack_delta_stream(packed, bw, n)
            else:
                ops.prefix_sum(ops.unpack_stream(packed, bw, n))

    decode = {}
    for form, fused in (("fused", True), ("two_pass", False)):
        decode_all(fused)
        times = []
        for _ in range(DECODE_RUNS):
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            decode_all(fused)
            ev1.record()
            ev1.synchronize()
            times.append(ev0.elapsed_time(ev1))
        times.sort()
        ms = times[len(times) // 2]
        decode[form] = {"ms": ms, "postings_per_s": n_stream / ms * 1e3,
                        "runs_ms": times}
        log(f"whole-corpus {form} decode: {n_stream} postings of "
            f"{len(lists)} lists in {ms:.4f} ms (median of {DECODE_RUNS}, "
            f"CUDA events, warm, host enqueue included) = "
            f"{n_stream / ms * 1e3:.4e} postings/s; {smi}")
    stream = {"seconds": dt_stream, "launches": stream_launches,
              "postings": n_stream, "lists": len(lists),
              "bits_per_posting": packed_words * 32 / n_stream,
              "decode": decode}
    del packed_all, lists, a, b, both

    # ---- kernels ---------------------------------------------------------- #
    phase_done("stream path")
    log("== kernels vs plain versions (bitwise)")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)

    def rand_words(shape):
        return torch.randint(-2**31, 2**31, shape, generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)

    def rand_int(hi, n):
        return torch.randint(0, hi, (n,), generator=gen, device=dev,
                             dtype=torch.int64).to(torch.int32)

    report = []

    def decode_case(bw, w, n_tiles, q, crows, with_q):
        rpb = rows_per_block(bw)
        tiles = rand_words((n_tiles * rpb, 128))
        slots = rand_int(n_tiles, w)
        qslots = torch.sort(rand_int(q, w)).values if with_q else None
        firsts = rand_int(n_docs, w)
        ns = torch.where(rand_int(8, w) == 0, rand_int(513, w),
                         torch.full((w,), 512, dtype=torch.int32, device=dev))
        cand = rand_words((q * crows, 128))
        return tiles, slots, qslots, firsts, ns, cand

    def decode_bytes(bw, tiles, slots, qslots, ns, cand, crows, d):
        """Least bytes: the rows of each distinct tile the entries read,
        each entry's 12-16 B of indices, the distinct bitmap words its
        docids probe, and 4 KB of outputs per entry."""
        w = slots.shape[0]
        tiles_read = torch.unique(slots).numel()
        cw = crows * 128
        q = qslots.long() if qslots is not None else torch.zeros_like(d[:, 0])
        word = torch.clamp((d.long() & 0xFFFFFFFF) >> 5, max=cw - 1)
        probed = torch.unique(q[:, None] * cw + word).numel()
        idx_b = 16 if qslots is not None else 12
        return (tiles_read * rows_per_block(bw) * 512 + w * idx_b
                + probed * 4 + 2 * w * 512 * 4)

    # B1, every bw bucket, at the largest call any main path gave it, probed
    # against a random bitmap (as the AND rounds) and against all ones (the
    # `or` rounds' gate, where only lane validity masks a hit)
    per_bw, seen, b1_paths = {}, {}, {}
    for path, c in calls["B1"]:
        b1_paths.setdefault(c["bw"], set()).add(path)
        if c["bw"] not in seen or c["W"] > seen[c["bw"]][0]:
            seen[c["bw"]] = (c["W"], c["tiles"], c["Q"], c["crows"])
    w_max = max(v[0] for v in seen.values())
    _, _, q_main, crows_main = next(iter(seen.values()))
    for bw in BW_BUCKETS:
        w, n_tiles, q, crows = seen.get(bw, (w_max, w_max, q_main, crows_main))
        tiles, slots, qslots, firsts, ns, cand = decode_case(bw, w, n_tiles, q,
                                                             crows, True)
        args_ = (tiles, slots, qslots, firsts, ns, cand)
        err = 0
        for gate in (cand, torch.full_like(cand, -1)):
            a = (tiles, slots, qslots, firsts, ns, gate)
            got = intersect_rounds.segmented_decode_and(*a, bw=bw, crows=crows)
            ref = intersect_rounds.segmented_decode_and_plain(*a, bw=bw,
                                                              crows=crows)
            torch.cuda.synchronize()
            err = max(err, max_abs_err(got, ref, torch))
        # against all ones every valid lane hits and no other does
        n_hits = int(torch.count_nonzero(got[1]))
        if n_hits != int(ns.long().sum()):
            raise AssertionError(f"B1 bw={bw} all-ones gate: {n_hits} hits "
                                 f"for {int(ns.long().sum())} valid lanes")
        nbytes = decode_bytes(bw, tiles, slots, qslots, ns, cand, crows,
                              ref[0].reshape(w, -1))
        ms = cuda_ms(lambda: intersect_rounds.segmented_decode_and(
            *args_, bw=bw, crows=crows), torch)
        pms = cuda_ms(lambda: intersect_rounds.segmented_decode_and_plain(
            *args_, bw=bw, crows=crows), torch)
        per_bw[bw] = {"W": w, "queries": q, "crows": crows,
                      "on_main_path": bw in seen,
                      "paths": sorted(b1_paths.get(bw, ())), "max_abs_err": err,
                      "ms": ms, "plain_ms": pms, "bound_ms": bound_ms(nbytes),
                      "bytes": nbytes}
        log(f"B1 bw={bw:2d} W={w} Q={q} crows={crows}: err {err} (random and "
            f"all-ones gates) kernel {ms:.4f} ms plain {pms:.4f} ms bound "
            f"{bound_ms(nbytes):.4f} ms; paths "
            f"{', '.join(sorted(b1_paths.get(bw, ()))) or 'none'}")
        if err:
            raise AssertionError(f"B1 bw={bw} disagrees with its plain version")
        del tiles, cand, got, ref
    main_bw = max(seen, key=lambda b: seen[b][0])
    b1 = per_bw[main_bw]
    report.append({
        "name": "segmented_decode_and (B1)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_and.cu",
        "replaces": "src/repro/kernels/intersect_rounds.py:233",
        "launches": main_launches["B1"],
        "max_abs_err": max(v["max_abs_err"] for v in per_bw.values()),
        "ms": b1["ms"], "plain_ms": b1["plain_ms"], "bound_ms": b1["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "shape_bw": main_bw,
        "ranked_launches": ranked_launches["B1"], "per_bw": per_bw,
        "ok": True})

    # B5 at the legacy path's largest call
    c = max((sh for _, sh in calls["B5"]), key=lambda c: c["W"])
    bw, w, crows = c["bw"], c["W"], c["R"]
    tiles, slots, _, firsts, ns, cand = decode_case(bw, w, c["tiles"], 1,
                                                    crows, False)
    args_ = (tiles, slots, firsts, ns, cand)
    got = decode_fused.fused_decode_and(*args_, bw=bw)
    ref = decode_fused.fused_decode_and_plain(*args_, bw=bw)
    torch.cuda.synchronize()
    err = max_abs_err(got, ref, torch)
    nbytes = decode_bytes(bw, tiles, slots, None, ns, cand, crows,
                          ref[0].reshape(w, -1))
    ms = cuda_ms(lambda: decode_fused.fused_decode_and(*args_, bw=bw), torch)
    pms = cuda_ms(lambda: decode_fused.fused_decode_and_plain(*args_, bw=bw), torch)
    log(f"B5 bw={bw} W={w} R={crows}: err {err} kernel {ms:.4f} ms plain "
        f"{pms:.4f} ms bound {bound_ms(nbytes):.4f} ms")
    if err:
        raise AssertionError("B5 disagrees with its plain version")
    report.append({
        "name": "fused_decode_and (B5)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_and.cu",
        "replaces": "src/repro/kernels/decode_fused.py:111",
        "launches": legacy_launches, "path": "legacy and_many",
        "max_abs_err": err, "ms": ms, "plain_ms": pms,
        "bound_ms": bound_ms(nbytes), "bound_by": "bytes", "library_ms": None,
        "shape": {"bw": bw, "W": w, "R": crows}, "ok": True})
    del tiles, cand, got, ref

    def distinct_ids(q, p, lanes, width):
        """(qslot, ids) of p entries over q queries, sorted by query, with
        docids distinct within a query (the round contract): the k-th entry
        of a query takes docids (k * lanes + l) * step + offset."""
        qslot = torch.sort(rand_int(q, p)).values
        first_of = torch.searchsorted(qslot, qslot)
        rank = torch.arange(p, device=dev) - first_of
        n_max = int(torch.bincount(qslot.long(), minlength=q).max())
        step = max(1, width // (n_max * lanes))
        lane = torch.arange(lanes, device=dev)
        ids = ((rank[:, None] * lanes + lane[None, :]) * step
               + (qslot.long()[:, None] * 7919) % step).to(torch.int32)
        return qslot, ids

    # B2 at the largest scatter of any main path
    b2_path, c = max(calls["B2"], key=lambda pc: pc[1]["P"])
    q, words, p, lanes = c["Q"], c["words"], c["P"], c["L"]
    qslot, ids = distinct_ids(q, p, lanes, words * 32)
    surv = torch.rand((p, lanes), generator=gen, device=dev) < 0.5
    bm = torch.zeros((q, words), dtype=torch.int32, device=dev)
    got = accumulate.scatter_bits(bm.clone(), ids, qslot, surv)
    ref = accumulate.scatter_bits_plain(bm.clone(), ids, qslot, surv)
    torch.cuda.synchronize()
    err = max_abs_err([got], [ref], torch)
    idl = ids.long()
    flat = (qslot.long()[:, None] * words + (idl >> 5))[surv]
    vals = torch.bitwise_left_shift(torch.ones_like(idl), idl & 31)[surv].to(torch.int32)
    touched = torch.unique(flat).numel()
    # a touched word is read and written: 8 B of read-modify-write
    nbytes = p * lanes * 4 + p * lanes + p * 4 + touched * 8
    ms = cuda_ms(lambda: accumulate.scatter_bits(bm, ids, qslot, surv), torch)
    pms = cuda_ms(lambda: accumulate.scatter_bits_plain(bm, ids, qslot, surv), torch)
    lib_flat = bm.view(-1)
    lms = cuda_ms(lambda: lib_flat.index_put_((flat,), vals, accumulate=True), torch)
    log(f"B2 bits Q={q} words={words} P={p} L={lanes} ({b2_path} path): err "
        f"{err} kernel "
        f"{ms:.4f} ms plain {pms:.4f} ms index_put_ {lms:.4f} ms bound "
        f"{bound_ms(nbytes):.4f} ms")
    if err:
        raise AssertionError("B2 bits form disagrees with its plain version")
    b2 = {"name": "scatter_bits (B2)", "route": "cuda",
          "source": "src/repro_torch/kernels/csrc/accumulate.cu",
          "replaces": "src/repro/kernels/accumulate.py:85",
          "launches": main_launches["B2"], "max_abs_err": err, "ms": ms,
          "plain_ms": pms, "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
          "library_ms": lms, "ranked_launches": ranked_launches["B2"],
          "shape": {"Q": q, "words": words, "P": p, "L": lanes},
          "shape_path": b2_path, "ok": True}
    del bm, got, ref, flat, vals

    def accumulate_case(what, q, width, run, run_plain, flat, vals):
        """Run a kernel that adds ``vals`` at flat indices ``flat`` of a
        (q, width) accumulator, and its plain version, in turn on ONE
        zeroed accumulator (at GOV2 scale it is 256 x 25.2 M words), and
        compare them where they wrote; then time kernel, plain version and
        one ``index_put_(accumulate=True)`` on the precomputed indices."""
        acc = torch.zeros((q, width), dtype=torch.int32, device=dev)
        uniq = torch.unique(flat)
        run(acc)
        got = acc.view(-1)[uniq]
        # a write outside the targets leaves a non-zero word there; counted
        # per 8 rows, since a count over the whole accumulator widens it to
        # int64 (twice its 25.8 GB)
        nonzero = sum(int(torch.count_nonzero(acc[r:r + 8]))
                      for r in range(0, q, 8))
        if nonzero != int(torch.count_nonzero(got)):
            raise AssertionError(f"{what} wrote outside its targets")
        acc.zero_()
        run_plain(acc)
        ref = acc.view(-1)[uniq]
        torch.cuda.synchronize()
        err = max_abs_err([got], [ref], torch)
        del got, ref
        ms = cuda_ms(lambda: run(acc), torch)
        pms = cuda_ms(lambda: run_plain(acc), torch)
        acc_flat = acc.view(-1)
        lms = cuda_ms(lambda: acc_flat.index_put_((flat,), vals,
                                                  accumulate=True), torch)
        if err:
            raise AssertionError(f"{what} disagrees with its plain version")
        touched = uniq.numel()
        del acc, acc_flat, uniq
        torch.cuda.empty_cache()
        return err, ms, pms, lms, touched

    # B2, add form, at the AND path's largest scatter shape, as first
    # recorded: entries into a (Q, docs) accumulator, full-range
    # contributions
    del ids, qslot, surv
    c = max((sh for path, sh in calls["B2"] if path == "and"),
            key=lambda c: c["P"])
    q, words, p, lanes = c["Q"], c["words"], c["P"], c["L"]
    width = words * 32
    qslot, ids = distinct_ids(q, p, lanes, width)
    contrib = rand_words((p, lanes))
    err, ms, pms, lms, touched = accumulate_case(
        "B2 add form", q, width,
        lambda a: accumulate.scatter_add(a, ids, qslot, contrib),
        lambda a: accumulate.scatter_add_plain(a, ids, qslot, contrib),
        (qslot.long()[:, None] * width + ids.long()).reshape(-1),
        contrib.reshape(-1))
    nbytes = 2 * p * lanes * 4 + p * 4 + touched * 8
    log(f"B2 add Q={q} width={width} P={p} L={lanes}: err {err} kernel "
        f"{ms:.4f} ms plain {pms:.4f} ms index_put_ {lms:.4f} ms bound "
        f"{bound_ms(nbytes):.4f} ms")
    b2["add_form"] = {"launches_on_and_path": main_launches["B2add"],
                      "max_abs_err": err, "ms": ms, "plain_ms": pms,
                      "bound_ms": bound_ms(nbytes), "library_ms": lms,
                      "shape": {"Q": q, "width": width, "P": p, "L": lanes}}
    b2["max_abs_err"] = max(b2["max_abs_err"], err)
    report.append(b2)
    del contrib, ids, qslot

    # B2, add form, at the ranked path's largest scatter: u8 codes
    c = max(rcalls["B2add"], key=lambda c: c["P"])
    q, width, p, lanes = c["Q"], c["width"], c["P"], c["L"]
    qslot, ids = distinct_ids(q, p, lanes, width)
    codes = rand_int(256, p * lanes).reshape(p, lanes)
    flat = (qslot.long()[:, None] * width + ids.long())[codes != 0]
    err, ms, pms, lms, touched = accumulate_case(
        "B2 add form (ranked)", q, width,
        lambda a: accumulate.scatter_add(a, ids, qslot, codes),
        lambda a: accumulate.scatter_add_plain(a, ids, qslot, codes),
        flat, codes[codes != 0])
    nbytes = 2 * p * lanes * 4 + p * 4 + touched * 8
    log(f"B2 add (ranked shape) Q={q} width={width} P={p} L={lanes}: err "
        f"{err} kernel {ms:.4f} ms plain {pms:.4f} ms index_put_ {lms:.4f} "
        f"ms bound {bound_ms(nbytes):.4f} ms")
    report.append({
        "name": "scatter_add (B2, add form)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/accumulate.cu",
        "replaces": "src/repro/kernels/accumulate.py:85",
        "launches": sum(ranked_launches["B2add"].values()),
        "path": "ranked", "ranked_launches": ranked_launches["B2add"],
        "max_abs_err": err, "ms": ms, "plain_ms": pms,
        "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
        "library_ms": lms,
        "shape": {"Q": q, "width": width, "P": p, "L": lanes}, "ok": True})
    del flat, codes, ids, qslot
    torch.cuda.empty_cache()

    # B3 at the ranked path's largest unpack (random slots into an arena of
    # the real row count)
    c = max(rcalls["B3"], key=lambda c: c["W"])
    w, n_tiles = c["W"], c["tiles"]
    tiles = rand_words((n_tiles, 128))
    slots = rand_int(n_tiles, w)
    got = topk.unpack_codes(tiles, slots)
    ref = topk.unpack_codes_plain(tiles, slots)
    torch.cuda.synchronize()
    err = max_abs_err([got], [ref], torch)
    # distinct rows read, the slot indices, 2 KB of codes written per entry
    nbytes = torch.unique(slots).numel() * 512 + w * 4 + w * 2048
    ms = cuda_ms(lambda: topk.unpack_codes(tiles, slots), torch)
    pms = cuda_ms(lambda: topk.unpack_codes_plain(tiles, slots), torch)
    log(f"B3 W={w} tiles={n_tiles}: err {err} kernel {ms:.4f} ms plain "
        f"{pms:.4f} ms bound {bound_ms(nbytes):.4f} ms")
    if err:
        raise AssertionError("B3 disagrees with its plain version")
    report.append({
        "name": "unpack_codes (B3)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/topk.cu",
        "replaces": "src/repro/kernels/topk.py:295",
        "launches": sum(ranked_launches["B3"].values()), "path": "ranked",
        "ranked_launches": ranked_launches["B3"], "max_abs_err": err,
        "ms": ms, "plain_ms": pms, "bound_ms": bound_ms(nbytes),
        "bound_by": "bytes", "library_ms": None,
        "shape": {"W": w, "tiles": n_tiles}, "ok": True})
    del tiles, slots, got, ref

    # B4 at the ranked path's largest dense add: windows at random
    # 128-aligned columns, half the codes zero
    b4_calls = rcalls["B4"] or [{"P": 1, "Q": q, "width": width}]
    c = max(b4_calls, key=lambda c: c["P"])
    p, q, width = c["P"], c["Q"], c["width"]
    win = accumulate.DENSE_WINDOW
    qslot = torch.sort(rand_int(q, p)).values
    col0 = rand_int((width - win) // 128 + 1, p) * 128
    codes = torch.where(rand_int(2, p * win).reshape(p, win) == 0, 0,
                        rand_int(256, p * win).reshape(p, win))
    act = torch.ones(p, dtype=torch.bool, device=dev)
    nz = codes != 0
    flat = (qslot.long()[:, None] * width + col0.long()[:, None]
            + torch.arange(win, device=dev))[nz]
    err, ms, pms, lms, touched = accumulate_case(
        "B4", q, width,
        lambda a: accumulate.dense_add(a, codes, qslot, col0, act),
        lambda a: accumulate.dense_add_plain(a, codes, qslot, col0, act),
        flat, codes[nz])
    # 16 KB of codes and 9 B of indices per entry, 8 B of read-modify-write
    # per distinct word a non-zero code touches
    nbytes = p * win * 4 + p * 9 + touched * 8
    log(f"B4 Q={q} width={width} P={p}: err {err} kernel {ms:.4f} ms plain "
        f"{pms:.4f} ms index_put_ {lms:.4f} ms bound "
        f"{bound_ms(nbytes):.4f} ms"
        f"{'' if rcalls['B4'] else ' (no dense block on the ranked path)'}")
    report.append({
        "name": "dense_add (B4)", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/accumulate.cu",
        "replaces": "src/repro/kernels/accumulate.py:137",
        "launches": sum(ranked_launches["B4"].values()), "path": "ranked",
        "ranked_launches": ranked_launches["B4"], "max_abs_err": err,
        "ms": ms, "plain_ms": pms, "bound_ms": bound_ms(nbytes),
        "bound_by": "bytes", "library_ms": lms,
        "shape": {"Q": q, "width": width, "P": p}, "ok": True})
    del codes, flat, nz, qslot, col0, act

    # B6, B7a and B7b at every bit width 1..32, three frames each (the
    # corpus reaches only the widths its lists need); B8 on sums that wrap
    # past 2**32, on row counts that are no multiple of its tile (one of
    # them 1,001 tiles, more than the card holds resident at once), and
    # twice queued back to back on inputs of one shape (the second call's
    # scratch reuses the first's memory: no stale tile status)
    sweep = {"B7a": 0, "B7b": 0, "B6": 0, "B8": 0}
    for bw in range(1, 33):
        x = rand_words((3 * 32, 128))
        packed = bitpack.pack_frames(x, bw)
        sweep["B7a"] = max(sweep["B7a"], max_abs_err(
            [packed], [bitpack.pack_frames_plain(x, bw)], torch))
        sweep["B7b"] = max(sweep["B7b"], max_abs_err(
            [bitpack.unpack_frames(packed, bw)],
            [bitpack.unpack_frames_plain(packed, bw)], torch))
        sweep["B6"] = max(sweep["B6"], max_abs_err(
            [unpack_delta.unpack_delta_frames(packed, bw)],
            [unpack_delta.unpack_delta_frames_plain(packed, bw)], torch))
    wrap = torch.where(rand_int(2, 64 * 32 * 128).reshape(-1, 128) == 0,
                       -(1 << 31), rand_words((64 * 32, 128)))
    many = rand_words((32 * 2000 + 7, 128))
    for x in (wrap, rand_words((37, 128)), many):
        sweep["B8"] = max(sweep["B8"], max_abs_err(
            [scan_add.prefix_sum_blocks(x)],
            [scan_add.prefix_sum_blocks_plain(x)], torch))
    again = rand_words(many.shape)
    both = [scan_add.prefix_sum_blocks(many), scan_add.prefix_sum_blocks(again)]
    sweep["B8"] = max(sweep["B8"], max_abs_err(
        both, [scan_add.prefix_sum_blocks_plain(y) for y in (many, again)],
        torch))
    torch.cuda.synchronize()
    log(f"B6/B7a/B7b at bw 1..32 and B8 on wrapping, ragged and many-tile "
        f"inputs and back to back: max_abs_err {sweep}")
    if any(sweep.values()):
        raise AssertionError(f"stream kernel sweep disagrees: {sweep}")
    del wrap, x, packed, many, again, both

    def largest(k, key):
        return max(scalls[k], key=lambda c: c[key])

    def stream_case(key, name, source, replaces, run, run_plain, nbytes,
                    shape, library=None, library_name=None, per_call=False):
        """A stream kernel at the stream phase's largest call: bitwise
        against its plain version, then timed (primed and from an idle
        queue), its plain version and its library call timed; whether the
        library call gives the same bit patterns; ``per_call``: the grid
        launches and memsets of one call."""
        got = run()
        want = run_plain()
        torch.cuda.synchronize()
        err = max_abs_err([got], [want], torch)
        if err:
            raise AssertionError(f"{key} disagrees with its plain version")
        entry = {"name": name, "route": "cuda",
                 "source": f"src/repro_torch/kernels/csrc/{source}",
                 "replaces": replaces, "launches": stream_launches[key],
                 "path": "stream", "max_abs_err": max(err, sweep.get(key, 0)),
                 "ms": cuda_ms(run, torch), "plain_ms": cuda_ms(run_plain, torch),
                 "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
                 "library_ms": cuda_ms(library, torch) if library else None,
                 "call_ms": cuda_ms(run, torch, primed=False),
                 "library": library_name, "shape": shape, "ok": True}
        if library:
            entry["library_equal"] = bool(torch.equal(library().view(-1),
                                                      got.view(-1)))
        if per_call:
            entry["per_call"] = device_ops(run, torch)
        lms = entry["library_ms"]
        log(f"{key} {shape}: err {err} kernel {entry['ms']:.4f} ms (one call "
            f"from an idle queue {entry['call_ms']:.4f} ms) plain "
            f"{entry['plain_ms']:.4f} ms "
            + (f"{library_name} {lms:.4f} ms " if library else "")
            + f"bound {bound_ms(nbytes):.4f} ms"
            + (f"; per call {entry['per_call']}" if per_call else ""))
        report.append(entry)

    c = largest("B7a", "frames")
    f, bw = c["frames"], c["bw"]
    x = rand_words((f * 32, 128))
    stream_case("B7a", "pack_frames (B7a)", "stream.cu",
                "src/repro/kernels/bitpack.py:78",
                lambda: bitpack.pack_frames(x, bw),
                lambda: bitpack.pack_frames_plain(x, bw),
                f * FRAME_INTS * 4 + f * bw * 512, {"frames": f, "bw": bw})
    for key, wrapper, plain, name, replaces in (
            ("B7b", bitpack.unpack_frames, bitpack.unpack_frames_plain,
             "unpack_frames (B7b)", "src/repro/kernels/bitpack.py:96"),
            ("B6", unpack_delta.unpack_delta_frames,
             unpack_delta.unpack_delta_frames_plain,
             "unpack_delta_frames (B6)",
             "src/repro/kernels/unpack_delta.py:46")):
        c = largest(key, "frames")
        f, bw = c["frames"], c["bw"]
        packed = rand_words((f * bw, 128))
        stream_case(key, name, "stream.cu", replaces,
                    lambda: wrapper(packed, bw), lambda: plain(packed, bw),
                    f * bw * 512 + f * FRAME_INTS * 4,
                    {"frames": f, "bw": bw})
    c = largest("B8", "rows")
    x = rand_words((c["rows"], 128))
    flat = x.view(-1)
    stream_case("B8", "prefix_sum_blocks (B8)", "stream.cu",
                "src/repro/kernels/scan_add.py:38",
                lambda: scan_add.prefix_sum_blocks(x),
                lambda: scan_add.prefix_sum_blocks_plain(x),
                2 * c["rows"] * 512, {"rows": c["rows"]},
                lambda: torch.cumsum(flat, 0, dtype=torch.int32),
                "torch.cumsum(dtype=torch.int32)", per_call=True)
    c = largest("B9", "frames")
    x = rand_words((c["frames"] * 32, 128))
    stream_case("B9", "frame_or (B9)", "stream.cu",
                "src/repro/kernels/quadmax.py:29",
                lambda: quadmax.frame_or(x), lambda: quadmax.frame_or_plain(x),
                c["frames"] * (FRAME_INTS * 4 + 512), {"frames": c["frames"]})
    c = largest("B10", "rows")
    a, b = rand_words((c["rows"], 128)), rand_words((c["rows"], 128))
    stream_case("B10", "bitmap_and_tiles (B10)", "intersect.cu",
                "src/repro/kernels/intersect.py:115",
                lambda: intersect.bitmap_and_tiles(a, b),
                lambda: intersect.bitmap_and_tiles_plain(a, b),
                3 * c["rows"] * 512, {"rows": c["rows"]},
                lambda: torch.bitwise_and(a, b), "torch.bitwise_and",
                per_call=True)
    # B10 above the 50 MB L2: 3 x 32 MiB, so repeats read from HBM
    rows = 65536
    a, b = rand_words((rows, 128)), rand_words((rows, 128))
    err = max_abs_err([intersect.bitmap_and_tiles(a, b)],
                      [intersect.bitmap_and_tiles_plain(a, b)], torch)
    if err:
        raise AssertionError("B10 disagrees with its plain version above L2")
    big = {"rows": rows, "max_abs_err": err,
           "ms": cuda_ms(lambda: intersect.bitmap_and_tiles(a, b), torch),
           "library_ms": cuda_ms(lambda: torch.bitwise_and(a, b), torch),
           "bound_ms": bound_ms(3 * rows * 512)}
    report[-1]["above_l2"] = big
    log(f"B10 above L2 {{'rows': {rows}}}: err {err} kernel {big['ms']:.4f} "
        f"ms torch.bitwise_and {big['library_ms']:.4f} ms bound "
        f"{big['bound_ms']:.4f} ms")
    del x, flat, packed, a, b

    phase_done("kernels")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"phases_s": phase_s, "ranked": {
        m: {k: v for k, v in r.items() if k != "recent"}
        for m, r in ranked.items()}, "stream": stream}), flush=True)
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
