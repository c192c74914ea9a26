"""The port's serving traces and perf-regression gate against the JAX
package's: ``tests/test_obs.py``'s serving-trace and ``regress`` cases.

The serve streams run on the port's engines (``torch_device="cpu"``) and
must leave the reference's span chain; the gate functions of
``repro_torch.obs.regress`` must return what ``repro.obs.regress`` returns
on the same reports."""

import json
import math
import os

import numpy as np
import pytest

from repro.obs import regress as ref_regress
from repro_torch.index.engine import QueryEngine
from repro_torch.index.invindex import InvertedIndex
from repro_torch.index.serve import (Request, ServeConfig, ServerStats,
                                     TraceRecord, serve_stream)
from repro_torch.obs import (enable_tracing, get_tracer, regress,
                             to_chrome_trace, trace_coverage)

from test_obs import _QUERY_REPORT, DOCLEN, N_DOCS, POSTINGS


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


# --------------------------------------------------------------------------- #
# the regression gate, against the reference's
# --------------------------------------------------------------------------- #

def _same_violations(got, want):
    assert [_violation_key(v) for v in got] == \
        [_violation_key(v) for v in want]


def _violation_key(v):
    return (v.artifact, v.kind, v.path, v.detail)


def test_gate_identity_passes_and_2x_regression_fails():
    tol = regress.load_tolerances(None)
    assert tol == ref_regress.load_tolerances(None)
    v, n = regress.compare_reports("query", _QUERY_REPORT, _QUERY_REPORT, tol)
    assert not v and n == 3          # host_qps x2 + ranked or qps
    bad = regress.synthesize_regression(_QUERY_REPORT, factor=0.5)
    assert bad == ref_regress.synthesize_regression(_QUERY_REPORT, factor=0.5)
    assert bad["host_qps"]["1"] == 50.0
    assert bad["decodes_per_hot_block"] == 1.0
    assert bad["ranked"]["or"]["blocks_pruned"] == 12
    v, n = regress.compare_reports("query", bad, _QUERY_REPORT, tol)
    rv, rn = ref_regress.compare_reports("query", bad, _QUERY_REPORT, tol)
    assert len(v) == 3 and all(x.kind == "ratio" for x in v) and n == rn
    _same_violations(v, rv)


def test_gate_min_ratio_override_and_disable():
    tol = {"defaults": {"min_ratio": 0.55},
           "overrides": [{"artifact": "query", "pattern": "host_qps.*",
                          "min_ratio": 0}]}
    bad = regress.synthesize_regression(_QUERY_REPORT, factor=0.5)
    v, n = regress.compare_reports("query", bad, _QUERY_REPORT, tol)
    assert {x.path for x in v} == {"ranked.or.qps.host"}
    assert n == 1
    _same_violations(v, ref_regress.compare_reports(
        "query", bad, _QUERY_REPORT, tol)[0])


def test_gate_workload_stamp_mismatch_refuses():
    other = dict(_QUERY_REPORT, n_queries=256)
    keys = ("dataset", "codec", "backend", "n_queries")
    v = regress.check_workload("query", keys, other, _QUERY_REPORT)
    assert len(v) == 1 and v[0].kind == "workload" and v[0].path == "n_queries"
    _same_violations(v, ref_regress.check_workload("query", keys, other,
                                                   _QUERY_REPORT))


def test_gate_hard_invariants():
    ok, n = regress.check_invariants("query", _QUERY_REPORT)
    assert not ok and n >= 4
    broken = json.loads(json.dumps(_QUERY_REPORT))
    broken["placements"]["device"]["host_syncs_per_query"] = 3
    broken["ranked"]["or"]["blocks_pruned"] = 0
    v, _ = regress.check_invariants("query", broken)
    assert {x.path for x in v} == {"placements.device.host_syncs_per_query",
                                   "ranked.or.blocks_pruned"}
    _same_violations(v, ref_regress.check_invariants("query", broken)[0])
    mut = {"tombstone_qps": {"0.01": {"cand_syncs": 0, "qps": 5.0}},
           "ranked_tomb_1pct": {"score_syncs": 0, "blocks_pruned": 3}}
    v, _ = regress.check_invariants("mutation", mut)
    assert not v
    mut["ranked_tomb_1pct"]["blocks_pruned"] = 0
    v, _ = regress.check_invariants("mutation", mut)
    assert [x.path for x in v] == ["ranked_tomb_1pct.blocks_pruned"]
    srv = {"arrivals": {"poisson": {"host": {"shed_rate": 0.0,
                                             "parity_ok": True}},
                        "bursty": {"host": {"shed_rate": 0.25,
                                            "parity_ok": False}}}}
    v, _ = regress.check_invariants("serving", srv)
    assert [x.path for x in v] == ["arrivals.bursty.host.parity_ok"]
    _same_violations(v, ref_regress.check_invariants("serving", srv)[0])


def test_gate_missing_fresh_report_is_a_violation(tmp_path):
    base = tmp_path / "base"
    fresh = tmp_path / "fresh"
    base.mkdir()
    fresh.mkdir()
    (base / "BENCH_query.json").write_text(json.dumps(_QUERY_REPORT))
    res = regress.run_gate(str(fresh), str(base))
    assert not res.passed
    assert res.violations[0].kind == "workload"
    (fresh / "BENCH_query.json").write_text(json.dumps(_QUERY_REPORT))
    res = regress.run_gate(str(fresh), str(base))
    assert res.passed and res.checked_ratios == 3


def test_committed_tolerances_keep_selftest_teeth():
    tol = regress.load_tolerances(
        os.path.join(os.path.dirname(__file__), "..",
                     regress.TOLERANCES_FILE))
    floors = [float(tol["defaults"]["min_ratio"])]
    floors += [float(ov["min_ratio"]) for ov in tol["overrides"]
               if float(ov.get("min_ratio", 1)) > 0]
    assert all(0.5 < f <= 1.0 for f in floors), floors
