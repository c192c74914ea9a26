#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Drives the port's main path, fused device-resident AND serving, through the
entry points a user calls, at the real document count of the TREC GOV2
collection, and holds every CUDA kernel of the path against its plain torch
version on the card:

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
  kernels    B1 (every bit-width bucket), B5 and B2 (both forms) on inputs
             made from --seed at the shapes the main path gave each kernel,
             compared bitwise with their plain versions; CUDA-event times
             (median of 30 after warm-up) of kernel, plain version and, for
             B2, one ``index_put_(accumulate=True)``; the bytes bound.

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
QUERIES = 256                   # AND queries per batch on the main path
LEGACY_QUERIES = 16             # of them, through the legacy and_many


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


def cuda_ms(fn, torch) -> float:
    """Median CUDA-event time of ``fn()`` over TIMED_RUNS calls, after two
    warm-up calls."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(TIMED_RUNS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


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
    from repro_torch.kernels import (accumulate, cuda_build, decode_fused,
                                     intersect_rounds)
    from repro_torch.kernels.decode_fused import BW_BUCKETS, rows_per_block
    from repro_torch.obs.trace import enable_tracing

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)

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
        qs = [rng.choice(terms[:120], size=rng.integers(2, 4),
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
    spans = {}
    for sp in tracer.spans():
        n, tot = spans.get(sp.name, (0, 0.0))
        spans[sp.name] = (n + 1, tot + sp.dur)
    log(f"fenced span breakdown of another fresh batch ({dt_traced:.4f} s):")
    for name, (n, tot) in sorted(spans.items(), key=lambda kv: -kv[1][1]):
        log(f"  {name:24s} x{n:<3d} {tot * 1e3:10.2f} ms")
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

    # shapes the main path gave each kernel
    calls = {k: [sh for n, sh in recent if n == k] for k in ("B1", "B2", "B5")}
    n_docs = idx.n_docs
    del eng, idx, ar, warm, res, again, traced, postings, legacy
    torch.cuda.empty_cache()

    # ---- kernels ---------------------------------------------------------- #
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

    # B1, every bw bucket, at the main path's shapes
    per_bw = {}
    seen = {}
    for c in calls["B1"]:
        if c["bw"] not in seen or c["W"] > seen[c["bw"]][0]:
            seen[c["bw"]] = (c["W"], c["tiles"], c["Q"], c["crows"])
    w_max = max(v[0] for v in seen.values())
    _, _, q_main, crows_main = next(iter(seen.values()))
    for bw in BW_BUCKETS:
        w, n_tiles, q, crows = seen.get(bw, (w_max, w_max, q_main, crows_main))
        tiles, slots, qslots, firsts, ns, cand = decode_case(bw, w, n_tiles, q,
                                                             crows, True)
        args_ = (tiles, slots, qslots, firsts, ns, cand)
        got = intersect_rounds.segmented_decode_and(*args_, bw=bw, crows=crows)
        ref = intersect_rounds.segmented_decode_and_plain(*args_, bw=bw,
                                                          crows=crows)
        torch.cuda.synchronize()
        err = max_abs_err(got, ref, torch)
        nbytes = decode_bytes(bw, tiles, slots, qslots, ns, cand, crows,
                              ref[0].reshape(w, -1))
        ms = cuda_ms(lambda: intersect_rounds.segmented_decode_and(
            *args_, bw=bw, crows=crows), torch)
        pms = cuda_ms(lambda: intersect_rounds.segmented_decode_and_plain(
            *args_, bw=bw, crows=crows), torch)
        per_bw[bw] = {"W": w, "queries": q, "crows": crows,
                      "on_main_path": bw in seen, "max_abs_err": err,
                      "ms": ms, "plain_ms": pms, "bound_ms": bound_ms(nbytes),
                      "bytes": nbytes}
        log(f"B1 bw={bw:2d} W={w} Q={q} crows={crows}: err {err} kernel "
            f"{ms:.4f} ms plain {pms:.4f} ms bound {bound_ms(nbytes):.4f} ms"
            f"{'' if bw in seen else ' (bucket not on the main path)'}")
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
        "per_bw": per_bw, "ok": True})

    # B5 at the legacy path's largest call
    c = max(calls["B5"], key=lambda c: c["W"])
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

    # B2 at the main path's largest scatter
    c = max(calls["B2"], key=lambda c: c["P"])
    q, words, p, lanes = c["Q"], c["words"], c["P"], c["L"]
    qslot = torch.sort(rand_int(q, p)).values
    # docids distinct within a query (the round contract): the k-th entry of
    # a query takes docids (k * lanes + l) * step + offset
    first_of = torch.searchsorted(qslot, qslot)
    rank = torch.arange(p, device=dev) - first_of
    n_max = int(torch.bincount(qslot.long(), minlength=q).max())
    step = max(1, (words * 32) // (n_max * lanes))
    lane = torch.arange(lanes, device=dev)
    ids = ((rank[:, None] * lanes + lane[None, :]) * step
           + (qslot.long()[:, None] * 7919) % step).to(torch.int32)
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
    nbytes = p * lanes * 4 + p * lanes + p * 4 + touched * 4
    ms = cuda_ms(lambda: accumulate.scatter_bits(bm, ids, qslot, surv), torch)
    pms = cuda_ms(lambda: accumulate.scatter_bits_plain(bm, ids, qslot, surv), torch)
    lib_flat = bm.view(-1)
    lms = cuda_ms(lambda: lib_flat.index_put_((flat,), vals, accumulate=True), torch)
    log(f"B2 bits Q={q} words={words} P={p} L={lanes}: err {err} kernel "
        f"{ms:.4f} ms plain {pms:.4f} ms index_put_ {lms:.4f} ms bound "
        f"{bound_ms(nbytes):.4f} ms")
    if err:
        raise AssertionError("B2 bits form disagrees with its plain version")
    b2 = {"name": "scatter_bits (B2)", "route": "cuda",
          "source": "src/repro_torch/kernels/csrc/accumulate.cu",
          "replaces": "src/repro/kernels/accumulate.py:85",
          "launches": main_launches["B2"], "max_abs_err": err, "ms": ms,
          "plain_ms": pms, "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
          "library_ms": lms,
          "shape": {"Q": q, "words": words, "P": p, "L": lanes}, "ok": True}
    del bm, got, ref, flat, vals

    # B2, add form (the ranked path's; not on the AND path): same entries
    # into a (Q, docs) accumulator, full-range contributions
    # (one accumulator only: at GOV2 scale it is 256 x 25.2 M words, so the
    # two versions run in turn on it and are compared where they wrote)
    width = words * 32
    contrib = rand_words((p, lanes))
    acc = torch.zeros((q, width), dtype=torch.int32, device=dev)
    flat = qslot.long()[:, None] * width + ids.long()
    uniq = torch.unique(flat)
    touched = uniq.numel()
    accumulate.scatter_add(acc, ids, qslot, contrib)
    got = acc.view(-1)[uniq]
    if int(acc.sum(dtype=torch.int64)) != int(got.sum(dtype=torch.int64)):
        raise AssertionError("B2 add form wrote outside its targets")
    acc.zero_()
    accumulate.scatter_add_plain(acc, ids, qslot, contrib)
    ref = acc.view(-1)[uniq]
    torch.cuda.synchronize()
    err = max_abs_err([got], [ref], torch)
    del got, ref, uniq
    flat = flat.reshape(-1)
    cvals = contrib.reshape(-1)
    nbytes = 2 * p * lanes * 4 + p * 4 + touched * 4
    ms = cuda_ms(lambda: accumulate.scatter_add(acc, ids, qslot, contrib), torch)
    pms = cuda_ms(lambda: accumulate.scatter_add_plain(acc, ids, qslot, contrib), torch)
    acc_flat = acc.view(-1)
    lms = cuda_ms(lambda: acc_flat.index_put_((flat,), cvals, accumulate=True), torch)
    log(f"B2 add Q={q} width={width} P={p} L={lanes}: err {err} kernel "
        f"{ms:.4f} ms plain {pms:.4f} ms index_put_ {lms:.4f} ms bound "
        f"{bound_ms(nbytes):.4f} ms")
    if err:
        raise AssertionError("B2 add form disagrees with its plain version")
    b2["add_form"] = {"launches_on_and_path": main_launches["B2add"],
                      "max_abs_err": err, "ms": ms, "plain_ms": pms,
                      "bound_ms": bound_ms(nbytes), "library_ms": lms,
                      "shape": {"Q": q, "width": width, "P": p, "L": lanes}}
    b2["max_abs_err"] = max(b2["max_abs_err"], err)
    report.append(b2)
    del acc, flat, cvals, contrib

    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
