"""The port's latency-governed serving loop (``repro_torch.index.serve``)
against the JAX package's: ``tests/test_serving.py``'s cases on its corpus.

Every served result equals, bitwise, the port's offline ``plan()/execute()``
and the reference's offline plan on the same batch; the admission helpers
(``tenant_cap``, ``weighted_fill``, the arrival processes) return what the
reference's return on the same inputs.  The port's engines run on the CPU
(``torch_device="cpu"``).  ``CrossoverTable.from_bench`` derives the same
table as the reference's from the same report (the reference file's three
cases); the port reads no baseline file, so the plan-placement cases run
against tables installed with ``set_crossover``."""

import dataclasses

import asyncio

import numpy as np
import pytest

from repro.index.engine import CrossoverTable as RefCrossover
from repro.index.engine import QueryBatch as RefBatch
from repro.index.engine import QueryEngine as RefEngine
from repro.index.invindex import InvertedIndex as RefIndex
from repro.index import serve as ref_serve
from repro_torch.index.engine import (CrossoverTable, HOST_BATCH_MAX,
                                      QueryBatch, QueryEngine, set_crossover)
from repro_torch.index.invindex import InvertedIndex
from repro_torch.index.serve import (IndexServer, Rejected, Request,
                                     ServeConfig, bursty_offsets,
                                     poisson_offsets, serve_stream,
                                     tenant_cap, weighted_fill)

from test_serving import DOCLEN, POSTINGS


def _engine(device=False):
    eng = QueryEngine(InvertedIndex.build(DOCLEN, POSTINGS))
    return eng.to_device(torch_device="cpu") if device else eng


def _ref_engine(device=False):
    eng = RefEngine(RefIndex.build(DOCLEN, POSTINGS))
    return eng.to_device() if device else eng


def _serve(engine, reqs, offsets=None, **cfg_kw):
    cfg_kw.setdefault("max_batch", 4)
    cfg_kw.setdefault("max_wait_ms", 2.0)
    cfg_kw.setdefault("warm_terms", 4)
    if offsets is None:
        offsets = np.zeros(len(reqs))
    return serve_stream(engine, reqs, offsets, ServeConfig(**cfg_kw))


def _same(a, b) -> bool:
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (np.asarray(a).dtype == np.asarray(b).dtype
                and np.array_equal(np.asarray(a), np.asarray(b)))
    return a == b


def _replay(engine, ref_engine, batch, results) -> None:
    """One served batch through the port's and the reference's offline
    plan/execute: the served results must equal both, bitwise."""
    qs = [list(q) for q in batch.queries]
    oracle = engine.execute(engine.plan(
        QueryBatch(qs, mode=batch.mode, k=batch.k),
        placement=batch.placement))
    ref = ref_engine.execute(ref_engine.plan(
        RefBatch(qs, mode=batch.mode, k=batch.k), placement=batch.placement))
    for off, want, rid in zip(oracle, ref, batch.rids):
        assert _same(results[rid], off), (batch.batch_id, rid)
        assert _same(results[rid], want), (batch.batch_id, rid)


# --------------------------------------------------------------------------- #
# batcher edge cases
# --------------------------------------------------------------------------- #

def test_expired_at_enqueue_is_rejected_immediately():
    results, stats = _serve(_engine(), [Request([0, 1], deadline_ms=0),
                                        Request([0, 1], deadline_ms=-5.0),
                                        Request([0, 1], deadline_ms=500)])
    assert isinstance(results[0], Rejected) and results[0].reason == "expired"
    assert isinstance(results[1], Rejected) and results[1].reason == "expired"
    assert not isinstance(results[2], Rejected)
    assert stats.rejected_expired == 2 and stats.served == 1
    dead = [tr for tr in stats.traces if tr.outcome == "rejected_expired"]
    assert len(dead) == 2 and all(tr.stages() == (tr.t_enqueue,) for tr in dead)


def test_batch_of_one_bitwise_parity_with_offline_plan():
    engine = _engine()
    results, stats = _serve(engine, [Request([0, 2], deadline_ms=500)])
    assert stats.served == 1 and len(stats.batches) == 1
    b = stats.batches[0]
    assert len(b.queries) == 1 and b.placement == "host"
    _replay(engine, _ref_engine(), b, results)


def test_mixed_modes_never_cobatched():
    engine = _engine()
    reqs = [Request([0, 2], mode="and" if i % 2 == 0 else "or",
                    deadline_ms=1000) for i in range(8)]
    results, stats = _serve(engine, reqs, max_batch=8, max_wait_ms=5.0)
    assert stats.served == 8
    assert all(not isinstance(r, Rejected) for r in results)
    modes_by_batch = {b.batch_id: b.mode for b in stats.batches}
    for tr in stats.traces:
        assert modes_by_batch[tr.batch_id] == tr.mode
    assert {b.mode for b in stats.batches} == {"and", "or"}
    ref_engine = _ref_engine()
    for b in stats.batches:
        _replay(engine, ref_engine, b, results)
    reqs = [Request([0, 2], k=5 + (i % 2) * 5, mode="or", deadline_ms=1000)
            for i in range(6)]
    _, stats2 = _serve(engine, reqs, max_batch=8, max_wait_ms=5.0)
    assert all(len({tr.k for tr in stats2.traces
                    if tr.batch_id == b.batch_id}) == 1
               for b in stats2.batches)


def test_flush_on_idle_queue_beats_full_deadline():
    engine = _engine()
    results, stats = _serve(engine, [Request([0, 1], deadline_ms=10_000)],
                            max_batch=64, max_wait_ms=5.0)
    assert stats.served == 1
    tr = stats.traces[-1]
    assert (tr.t_close - tr.t_enqueue) < 1.0
    assert stats.batches[0].queries == (tuple([0, 1]),)


def test_compact_between_plan_and_execute_serves_pinned_epoch():
    idx = InvertedIndex.build(DOCLEN, POSTINGS)
    ref_idx = RefIndex.build(DOCLEN, POSTINGS)
    dead = int(POSTINGS[0][0][0])
    idx.delete(dead)                        # make compaction non-trivial
    ref_idx.delete(dead)
    engine = QueryEngine(idx)
    oracle_plan = engine.plan(QueryBatch([[0, 2]], mode="and"))
    pinned_key = oracle_plan.ctx.skey
    oracle = engine.execute(oracle_plan)
    want = RefEngine(ref_idx).execute(RefBatch([[0, 2]], mode="and"))
    assert _same(oracle[0], want[0])

    server = IndexServer(engine, ServeConfig(max_batch=4, max_wait_ms=2.0,
                                             warm_terms=2))
    compacted = []

    def boom(plan):
        assert plan.ctx.skey == pinned_key
        compacted.append(idx.compact())

    server._after_plan = boom

    async def go():
        await server.start()
        try:
            return await server.submit(Request([0, 2], deadline_ms=2000))
        finally:
            await server.stop()

    got = asyncio.run(go())
    assert compacted and idx.epoch != pinned_key
    assert _same(got, oracle[0])
    tr = [t for t in server.stats.traces if t.outcome == "served"][-1]
    assert tr.epoch == pinned_key


def test_queue_full_backpressure_sheds_explicitly():
    engine = _engine()

    async def go():
        server = IndexServer(engine, ServeConfig(queue_cap=3))
        # batcher not started: nothing drains, so the cap must bite
        futs = [server.submit_nowait(Request([0, 1], deadline_ms=1000))
                for _ in range(5)]
        out = [f.result() if f.done() else None for f in futs]
        for f in futs:
            f.cancel()
        return out, server.stats

    out, stats = asyncio.run(go())
    rejected = [r for r in out if isinstance(r, Rejected)]
    assert len(rejected) == 2
    assert all(r.reason == "queue_full" for r in rejected)
    assert stats.rejected_queue_full == 2


# --------------------------------------------------------------------------- #
# per-tenant weighted admission
# --------------------------------------------------------------------------- #

def test_tenant_cap_is_weighted_share():
    cases = [(100, {}, "anyone", 100), (90, {"a": 2.0, "b": 1.0}, "a", 60),
             (90, {"a": 2.0, "b": 1.0}, "b", 30), (80, {"a": 3.0}, "ghost", 20)]
    for cap, w, t, want in cases:
        assert tenant_cap(cap, w, t) == want == ref_serve.tenant_cap(cap, w, t)
    assert tenant_cap(4, {"a": 100.0, "b": 0.001}, "b") >= 1
    assert tenant_cap(4, {"a": 100.0, "b": 0.001}, "b") == \
        ref_serve.tenant_cap(4, {"a": 100.0, "b": 0.001}, "b")


def test_weighted_fill_is_proportional_and_skips_incompatible():
    def queues():
        return {"a": [("and", i) for i in range(8)],
                "b": [("and", 10 + i) for i in range(8)]}
    q, rq = queues(), queues()
    got = weighted_fill(q, {"a": 2.0, "b": 1.0}, lambda e: e[0] == "and", 6)
    want = ref_serve.weighted_fill(rq, {"a": 2.0, "b": 1.0},
                                   lambda e: e[0] == "and", 6)
    assert got == want and q == rq
    by_tenant = {"a": sum(1 for e in got if e[1] < 10),
                 "b": sum(1 for e in got if e[1] >= 10)}
    assert by_tenant == {"a": 4, "b": 2}
    queues1 = {"a": [("or", 0), ("and", 1)]}
    got = weighted_fill(queues1, {}, lambda e: e[0] == "and", 4)
    assert got == [("and", 1)]
    assert queues1["a"] == [("or", 0)]


def test_weighted_fill_carries_credit_across_batches():
    credit, rcredit = {}, {}
    queues = {"a": [1] * 10, "b": [2] * 10}
    rqueues = {"a": [1] * 10, "b": [2] * 10}
    both = []
    for _ in range(2):
        got = weighted_fill(queues, {"a": 3.0, "b": 1.0}, lambda e: True, 4,
                            credit)
        assert got == ref_serve.weighted_fill(rqueues, {"a": 3.0, "b": 1.0},
                                              lambda e: True, 4, rcredit)
        both += got
    assert both.count(1) == 6 and both.count(2) == 2
    assert credit == rcredit


# --------------------------------------------------------------------------- #
# placement crossover table
# --------------------------------------------------------------------------- #

def _from_bench(report: dict) -> CrossoverTable:
    """The port's table of ``report``, checked field for field against the
    reference's."""
    got = CrossoverTable.from_bench(report)
    want = RefCrossover.from_bench(report)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    return got


def test_crossover_from_bench_true_crossing():
    # host wins at 1 and 4, device at 16 and 256 -> cut at 4
    table = _from_bench({
        "host_qps": {"1": 100.0, "4": 90.0, "16": 50.0, "256": 40.0},
        "device_qps": {"1": 20.0, "4": 80.0, "16": 200.0, "256": 400.0}})
    assert table.host_batch_max == 4
    assert table.sizes == (1, 4, 16, 256)


def test_crossover_from_bench_no_crossing_or_degenerate():
    # host still winning at the largest measured size: no crossing
    assert _from_bench({
        "host_qps": {"1": 10.0, "16": 90.0, "256": 70.0},
        "device_qps": {"1": 20.0, "16": 40.0, "256": 60.0}
    }).host_batch_max is None
    # device wins everywhere: never demote
    assert _from_bench({
        "host_qps": {"1": 10.0, "16": 20.0},
        "device_qps": {"1": 15.0, "16": 40.0}}).host_batch_max == 0
    # non-monotone curve (host re-wins in the middle): only the LAST
    # host-winning size with device winning all larger sizes counts
    table = _from_bench({
        "host_qps": {"1": 50.0, "4": 10.0, "16": 90.0, "64": 10.0},
        "device_qps": {"1": 20.0, "4": 40.0, "16": 50.0, "64": 80.0}})
    assert table.host_batch_max == 16
    assert _from_bench({}).host_batch_max is None


def test_crossover_from_bench_per_mode_cells():
    # per-mode curves ("mode_qps") yield per-mode cells; cut_for falls back
    # to the pooled host_batch_max only for modes with no measured curve
    table = _from_bench({
        "host_qps": {"1": 100.0, "4": 90.0, "16": 50.0},
        "device_qps": {"1": 20.0, "4": 80.0, "16": 200.0},
        "mode_qps": {
            "or": {"host": {"1": 50.0, "16": 40.0},
                   "device": {"1": 60.0, "16": 90.0}},      # device always
            "and_scored": {"host": {"1": 90.0, "16": 80.0},
                           "device": {"1": 10.0, "16": 20.0}},  # no crossing
        }})
    assert table.host_batch_max == 4
    assert dict(table.mode_cuts) == {"or": 0, "and_scored": None}
    assert table.cut_for("or") == 0                 # never demote ranked-or
    assert table.cut_for("and_scored") is None      # host wins everywhere
    assert table.cut_for("and") == 4                # pooled fallback


# --------------------------------------------------------------------------- #
# plan placement (the port's static rule and set_crossover)
# --------------------------------------------------------------------------- #

def test_plan_demotes_via_measured_crossover_table():
    engine = _engine(device=True)
    try:
        set_crossover(CrossoverTable(host_batch_max=8, sizes=(1, 8, 64),
                                     source="SYNTHETIC.json"))
        small = engine.plan(QueryBatch([[0, 1]] * 8, mode="and"))
        assert small.placement == "host"
        assert "measured crossover" in small.note
        assert "SYNTHETIC.json" in small.note
        big = engine.plan(QueryBatch([[0, 1]] * 9, mode="and"))
        assert big.placement == "device" and big.note == ""
    finally:
        set_crossover()


def test_plan_static_fallback_when_baseline_absent():
    engine = _engine(device=True)
    try:
        set_crossover(None)
        tiny = engine.plan(QueryBatch([[0, 1]], mode="and"))
        assert tiny.placement == "host"
        assert f"HOST_BATCH_MAX={HOST_BATCH_MAX}" in tiny.note
        assert "static rule" in tiny.note
        assert engine.plan(QueryBatch([[0, 1]] * 2)).placement == "device"
    finally:
        set_crossover()


def test_plan_explicit_placement_bypasses_demotion():
    engine = _engine(device=True)
    plan = engine.plan(QueryBatch([[0, 1]], mode="and"), placement="device")
    assert plan.placement == "device" and "pinned by caller" in plan.note
    host_only = _engine(device=False)
    with pytest.raises(ValueError, match="needs device arenas"):
        host_only.plan(QueryBatch([[0, 1]], mode="and"), placement="device")
    with pytest.raises(ValueError, match="fused tile arenas"):
        engine.plan(QueryBatch([[0, 1]], mode="and"), placement="fused")
    with pytest.raises(ValueError, match="unknown placement"):
        engine.plan(QueryBatch([[0, 1]], mode="and"), placement="gpu")


# --------------------------------------------------------------------------- #
# streams, warm-up, stats
# --------------------------------------------------------------------------- #

def test_open_loop_stream_parity_and_stats():
    engine = _engine(device=True)
    n = 16
    reqs = [Request([0, 2] if i % 2 == 0 else [1, 3], deadline_ms=2000,
                    tenant=f"t{i % 2}") for i in range(n)]
    offsets = poisson_offsets(n, rate_qps=2000.0, seed=5)
    results, stats = _serve(engine, reqs, offsets, max_batch=4,
                            max_wait_ms=3.0, tenants={"t0": 1.0, "t1": 2.0})
    assert stats.served == n and stats.shed == 0
    snap = stats.snapshot()
    assert snap["shed_rate"] == 0.0
    assert snap["latency_ms"]["p50"] <= snap["latency_ms"]["p99"] <= \
        snap["latency_ms"]["p999"]
    assert sum(stats.per_tenant[t]["served"] for t in ("t0", "t1")) == n
    assert sum(n_b * size for hist in snap["batch_hist"].values()
               for size, n_b in hist.items()) == n
    ref_engine = _ref_engine(device=True)
    for b in stats.batches:         # every batch replays bitwise
        _replay(engine, ref_engine, b, results)
    for tr in stats.traces:
        s = tr.stages()
        assert all(a <= b2 for a, b2 in zip(s, s[1:]))


def test_arrival_processes_are_seeded_and_distinct():
    a = poisson_offsets(64, 500.0, seed=9)
    b = poisson_offsets(64, 500.0, seed=9)
    assert np.array_equal(a, b)
    assert np.array_equal(a, ref_serve.poisson_offsets(64, 500.0, seed=9))
    g = bursty_offsets(64, 500.0, seed=9, shape=0.25)
    assert np.array_equal(g, ref_serve.bursty_offsets(64, 500.0, seed=9,
                                                      shape=0.25))
    assert not np.array_equal(a, g)
    assert np.diff(g, prepend=0.0).var() > np.diff(a, prepend=0.0).var()
    assert np.all(np.diff(a) >= 0) and np.all(np.diff(g) >= 0)


def test_warmup_populates_hot_term_score_cache():
    engine = _engine(device=True)
    server = IndexServer(engine, ServeConfig(warm_terms=3, max_batch=2))

    async def go():
        await server.start()
        await server.stop()

    asyncio.run(go())
    assert server.stats.warmup_s > 0.0
    gen = engine.idx.gen
    hot = sorted(gen.terms, key=lambda t: -gen.terms[t].df)[:3]
    skey = engine._cur().skey
    for t in hot:
        assert engine.score_cache.get((t,) + skey) is not None


def test_shed_at_batch_close_when_deadline_passed():
    engine = _engine()

    async def go():
        server = IndexServer(engine, ServeConfig(
            max_batch=4, max_wait_ms=1000.0, slack_ms=0.0, warm_terms=2))
        await server.start()
        try:
            return await server.submit(Request([0, 1], deadline_ms=5.0))
        finally:
            await server.stop()

    got = asyncio.run(go())
    assert isinstance(got, Rejected) and got.reason == "deadline"
