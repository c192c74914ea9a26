"""The port's serving traces against the JAX package's:
``tests/test_obs.py``'s serving-trace cases.

The serve streams run on the port's engines (``torch_device="cpu"``) and
must leave the reference's span chain."""

import json
import math

import numpy as np
import pytest

from repro_torch.index.engine import QueryEngine
from repro_torch.index.invindex import InvertedIndex
from repro_torch.index.serve import (Request, ServeConfig, ServerStats,
                                     TraceRecord, serve_stream)
from repro_torch.obs import (enable_tracing, get_tracer, to_chrome_trace,
                             trace_coverage)

from test_obs import DOCLEN, N_DOCS, POSTINGS


def _engine(device=False, fused=False):
    eng = QueryEngine(InvertedIndex.build(DOCLEN, POSTINGS))
    if device or fused:
        eng.to_device(fused=fused, torch_device="cpu")
    return eng


def _serve(engine, n=6, **cfg_kw):
    cfg_kw.setdefault("max_batch", 4)
    cfg_kw.setdefault("max_wait_ms", 2.0)
    cfg_kw.setdefault("warm_terms", 4)
    reqs = [Request([t % 4, (t + 1) % 4], deadline_ms=2000) for t in range(n)]
    return serve_stream(engine, reqs, np.zeros(n), ServeConfig(**cfg_kw))


# --------------------------------------------------------------------------- #
# trace integrity on real serve streams
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("placement", ["host", "device", "fused"])
def test_full_span_chain_per_placement(placement):
    engine = _engine(device=True, fused=(placement == "fused"))
    results, stats = _serve(engine, n=6, placement=placement)
    assert stats.served == 6
    spans = stats.tracer.spans()
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    assert len(by_name["serve/request"]) == 6
    assert len(by_name["serve/batch"]) == len(stats.batches)
    batches = {s.sid: s for s in by_name["serve/batch"]}
    for child in ("serve/plan", "serve/execute", "serve/deliver"):
        assert {c.parent_sid for c in by_name[child]} == set(batches)
    assert trace_coverage(spans) >= 0.9
    req = {s.args["rid"]: s for s in by_name["serve/request"]}
    for tr in stats.traces:
        assert tr.outcome == "served" and tr.placement == placement
        s = req[tr.rid]
        assert s.t0 == tr.t_enqueue and s.t1 == tr.t_done
        assert s.args["outcome"] == "served"
        stamps = tr.stages()
        assert all(b >= a for a, b in zip(stamps, stamps[1:]))
    for b in stats.batches:
        bs = next(s for s in by_name["serve/batch"]
                  if s.args["bid"] == b.batch_id)
        assert bs.t0 == b.t_close and bs.t1 == b.t_done


def test_span_chain_two_shard_engine():
    engine = _engine()
    engine.to_device(fused=True, bounds=(0, N_DOCS // 2, N_DOCS),
                     torch_device="cpu")
    enable_tracing(True)
    try:
        get_tracer().clear()
        results, stats = _serve(engine, n=4, placement="device")
        deep = get_tracer().spans()
    finally:
        enable_tracing(False)
        get_tracer().clear()
    assert stats.served == 4
    lanes = {s.lane for s in deep}
    assert {"shard0", "shard1"} <= lanes
    # engine spans from the executor thread reach the process tracer
    assert {"engine/plan", "engine/execute", "and/seed"} <= {s.name
                                                            for s in deep}
    doc = to_chrome_trace(stats.tracer, deep)
    tracks = {e["args"]["name"] for e in doc["traceEvents"]
              if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"serve", "shard0", "shard1"} <= tracks
    json.loads(json.dumps(doc))


def test_ranked_sharded_batch_records_the_merge_span():
    engine = _engine()
    engine.to_device(bounds=(0, N_DOCS // 2, N_DOCS), torch_device="cpu")
    reqs = [Request([0, 1], mode="or", k=5, deadline_ms=2000)
            for _ in range(4)]
    enable_tracing(True)
    try:
        get_tracer().clear()
        _, stats = serve_stream(engine, reqs, np.zeros(4),
                                ServeConfig(max_batch=4, max_wait_ms=2.0,
                                            warm_terms=2, placement="device"))
        names = [s.name for s in get_tracer().spans()]
    finally:
        enable_tracing(False)
        get_tracer().clear()
    assert stats.served == 4
    assert names.count("sharded/merge") == len(stats.batches)
    assert engine.dev_stats["merge_syncs"] == len(stats.batches)


def test_rejected_and_shed_requests_close_their_spans():
    engine = _engine()
    reqs = [Request([0, 1], deadline_ms=0),          # rejected at enqueue
            Request([0, 1], deadline_ms=2000)]
    results, stats = serve_stream(
        engine, reqs, np.zeros(2),
        ServeConfig(max_batch=4, max_wait_ms=2.0, warm_terms=2))
    outcomes = {s.args["rid"]: s.args["outcome"]
                for s in stats.tracer.spans() if s.name == "serve/request"}
    assert outcomes[0] == "rejected_expired"
    assert outcomes[1] == "served"
    assert all(s.t1 is not None for s in stats.tracer.spans())


def test_server_stats_prometheus_snapshot():
    results, stats = _serve(_engine(), n=3)
    snap = stats.snapshot(prometheus=True)
    assert "repro_serve_requests_total" in snap["prometheus"]
    assert 'outcome="served"' in snap["prometheus"]
    assert "prometheus" not in stats.snapshot()     # opt-in only


def test_snapshot_percentiles_tiny_n():
    for n in (1, 2, 10):
        stats = ServerStats()
        for i in range(n):
            stats.record(TraceRecord(
                i, "t", "and", 10, "served", deadline=1e9,
                t_enqueue=0.0, t_close=0.0, t_plan=0.0, t_execute=0.0,
                t_done=(i + 1) * 1e-3, on_time=True))
        lat = sorted((i + 1.0) for i in range(n))
        pct = stats.snapshot()["latency_ms"]
        for name, q in (("p50", 50.0), ("p99", 99.0), ("p999", 99.9)):
            r = min(max(math.ceil(q / 100.0 * n), 1), n)
            assert pct[name] == pytest.approx(lat[r - 1])
        assert pct["p50"] <= pct["p99"] <= pct["p999"] == pct["max"]
