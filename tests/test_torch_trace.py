"""The codec layer's spans (``decode_list/<codec>`` with Group-PFD's three
phases inside, ``encode/<codec>``), their mirroring as ``torch.profiler``
ranges, and ``tools/decode_spans.py``'s readings of them."""

import importlib.util
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import codec
from repro_torch.obs import trace
from repro_torch.obs.trace import Tracer, enable_tracing, set_tracer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCH_CODECS = [n for n in codec.names() if codec.get(n).torch]
PFD = ("group_pfd", "group_optpfd")
PHASES = ("decode_list/widths", "decode_list/unpack", "decode_list/patch")


@pytest.fixture
def tracer():
    """A fresh process-global tracer with the codec spans on, put back off
    afterwards."""
    old = trace.get_tracer()
    tr = set_tracer(Tracer(enabled=True, codec=True))
    yield tr
    set_tracer(old)


def _gaps(n=3000, seed=0, heavy=True):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 200, n)
    if heavy:       # a few large gaps: Group-PFD's exceptions
        x[rng.integers(0, n, n // 40)] = rng.integers(1 << 16, 1 << 26,
                                                      n // 40)
    return x.astype(np.uint32)


def _decode(name, x):
    spec = codec.get(name)
    kw = spec.torch.args(spec.encode(x), device="cpu")
    return kw, spec.torch.vec(**kw)


@pytest.mark.parametrize("name", TORCH_CODECS)
def test_vec_emits_one_decode_list_span_a_call(name):
    x = _gaps()
    _, off = _decode(name, x)
    old = trace.get_tracer()
    tr = set_tracer(Tracer(enabled=True, codec=True))
    try:
        kw, on = _decode(name, x)
        _, again = _decode(name, x)
    finally:
        set_tracer(old)
    assert torch.equal(on, off) and torch.equal(again, off)
    assert np.array_equal(on.numpy().view(np.uint32), x)
    spans = [s for s in tr.spans() if s.name.startswith("decode_list/")]
    tops = [s for s in spans if s.name == f"decode_list/{name}"]
    assert len(tops) == 2 and all(s.parent_sid == 0 for s in tops)
    assert all(s.lane == "device" for s in spans)
    want = {"n": len(x)}
    if name in PFD:
        want["exc"] = kw["total_exc"]
        assert kw["total_exc"] > 0
    assert all(s.args == want for s in tops)
    children = [s for s in spans if s not in tops]
    if name not in PFD:
        assert children == []
        return
    for top in tops:
        kids = [s for s in children if s.parent_sid == top.sid]
        assert [s.name for s in kids] == list(PHASES)
        assert all(top.t0 <= s.t0 <= s.t1 <= top.t1 for s in kids)
    assert len(children) == 6


@pytest.mark.parametrize("name", PFD)
def test_patch_span_opens_without_exceptions(tracer, name):
    x = np.full(3000, 5, np.uint32)
    kw, out = _decode(name, x)
    assert kw["total_exc"] == 0
    assert np.array_equal(out.numpy().view(np.uint32), x)
    names = [s.name for s in tracer.spans() if s.name.startswith("decode_")]
    assert names == [*PHASES, f"decode_list/{name}"]
    assert tracer.spans()[-1].args == {"n": len(x), "exc": 0}


@pytest.mark.parametrize("name", codec.names())
def test_encode_emits_one_span_a_call(name):
    spec = codec.get(name)
    x = _gaps(600, heavy=False)
    off = spec.encode(x)
    old = trace.get_tracer()
    tr = set_tracer(Tracer(enabled=True, codec=True))
    try:
        on = spec.encode(x)
    finally:
        set_tracer(old)
    assert np.array_equal(np.asarray(on.data), np.asarray(off.data))
    assert np.array_equal(spec.decode_np(on), x)
    spans = tr.spans()
    assert [(s.name, s.lane, s.args) for s in spans] == [
        (f"encode/{name}", "host", {"n": len(x)})]


def test_codec_spans_need_their_own_switch():
    """The tracer on without ``codec``: the engine's spans only, none of
    the codec layer's per-call ones."""
    old = trace.get_tracer()
    tr = set_tracer(Tracer(enabled=True))
    try:
        _decode("group_pfd", _gaps())
    finally:
        set_tracer(old)
    assert tr.spans() == []
    tr = enable_tracing(True, codec=True)
    try:
        _decode("group_pfd", _gaps())
        assert len(tr.spans()) == 5
    finally:
        enable_tracing(False)
        tr.clear()
    assert trace.get_tracer().codec is False


def test_tracer_off_makes_no_span(monkeypatch):
    made, opened = [], []
    monkeypatch.setattr(trace, "Span", lambda *a: made.append(a))
    monkeypatch.setattr(trace, "_profiler_range",
                        lambda name: opened.append(name))
    for name in TORCH_CODECS:
        _decode(name, _gaps(500))
    with profile(activities=[ProfilerActivity.CPU]):
        _decode("group_pfd", _gaps(500))
    assert made == [] and opened == []


def test_no_profiler_range_without_a_profiler(tracer, monkeypatch):
    import torch.autograd.profiler as autograd_profiler
    real = autograd_profiler.record_function
    opened = []

    def counted(name, *a):
        opened.append(name)
        return real(name, *a)

    monkeypatch.setattr(autograd_profiler, "record_function", counted)
    _decode("group_pfd", _gaps())
    assert opened == [] and len(tracer.spans()) == 5
    with profile(activities=[ProfilerActivity.CPU]):
        _decode("group_pfd", _gaps())
    assert opened == ["encode/group_pfd", "decode_list/group_pfd", *PHASES]


def test_spans_are_user_annotation_ranges_under_a_profiler(tracer):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _decode("group_pfd", _gaps())
        with tracer.span("engine/plan", lane="engine"):
            pass
        sp = tracer.begin("serve/request", lane="serve")
        tracer.end(sp)
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            ranges.setdefault(e.name(), []).append((e.start_ns(),
                                                    e.end_ns()))
    want = ["encode/group_pfd", "decode_list/group_pfd", *PHASES,
            "engine/plan"]
    assert {n: len(v) for n, v in ranges.items()} == {n: 1 for n in want}
    (top0, top1), = ranges["decode_list/group_pfd"]
    phases = [ranges[n][0] for n in PHASES]
    assert all(top0 <= a <= b <= top1 for a, b in phases)
    assert all(b0 <= a1 for (_, b0), (a1, _) in zip(phases, phases[1:]))
    # the tracer's own record is unchanged by the mirroring
    assert [s.name for s in tracer.spans()] == [
        "encode/group_pfd", *PHASES, "decode_list/group_pfd", "engine/plan",
        "serve/request"]


@pytest.mark.cuda
def test_mirrored_ranges_leave_the_device_timeline_alone():
    """On the card, the ranges' images on the device's timeline are
    user annotations (so a reader of kernels can leave them out), and the
    kernels a decode launches are the same with the spans on or off."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    spec = codec.get("group_pfd")
    kw = spec.torch.args(spec.encode(_gaps(40_000)), device="cuda")
    spec.torch.vec(**kw)
    torch.cuda.synchronize()

    def kernels(spans_on):
        tr = enable_tracing(spans_on, codec=spans_on)
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                out = spec.torch.vec(**kw)
                torch.cuda.synchronize()
        finally:
            enable_tracing(False)
            tr.clear()
        ev = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
        named = [e for e in ev if e.name().startswith("decode_list/")]
        assert all(e.is_user_annotation() for e in named)
        return out, sorted(e.name() for e in ev if not e.is_user_annotation())

    out_off, off = kernels(False)
    out_on, on = kernels(True)
    assert on == off and torch.equal(out_on, out_off)


# --------------------------------------------------------------------------- #
# tools/decode_spans.py
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def tool():
    path = os.path.join(ROOT, "tools", "decode_spans.py")
    spec = importlib.util.spec_from_file_location("decode_spans", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_innermost_sweep(tool):
    ivs = [(0, 100, "req"), (10, 50, "list"), (12, 20, "widths"),
           (20, 45, "patch"), (60, 90, "list")]
    pts = [5, 15, 20, 30, 47, 55, 70, 95, 120]
    assert tool.innermost(ivs, pts, "out") == [
        "req", "widths", "patch", "patch", "list", "req", "list", "req",
        "out"]
    assert tool.innermost([], [1.0], "out") == ["out"]


def test_gaps_named_on_the_profilers_clock_despite_a_late_anchor(tool):
    """A list's three phases, 300 us each; the anchor stamp is 400 us off
    the profiler's clock.  The mirrored ranges name every gap by its phase;
    the anchor mapping names each by the phase before it, the first by
    no request at all."""
    us = 1e-6
    phases = [("decode_list/widths", 1000, 1300),
              ("decode_list/unpack", 1300, 1600),
              ("decode_list/patch", 1600, 1900)]
    events = [("portbench/profiled", False, 900.0, 5000.0, True),
              ("decode_list/group_pfd", False, 1000.0, 1900.0, True)]
    events += [(n, False, float(a), float(b), True) for n, a, b in phases]
    gaps = [(1100.0, 1200.0), (1400.0, 1500.0), (1700.0, 1800.0)]
    # monotonic seconds: the true offset is 0; the anchor believes 400 us
    spans = [(n, a * us, b * us) for n, a, b in phases]
    spans.append(("decode_list/group_pfd", 1000 * us, 1900 * us))
    got = tool.idle_names(events, gaps, [("in a request", 950 * us,
                                          2000 * us)], spans, 400.0,
                          "portbench/profiled")
    assert got["ranges"] == pytest.approx(
        {n: 100e-6 for n, _, _ in phases})
    assert got["anchor"] == pytest.approx(
        {"between requests": 100e-6, "decode_list/widths": 100e-6,
         "decode_list/unpack": 100e-6})
    assert got["differ_s"] == pytest.approx(300e-6)


def test_gaps_outside_every_range_fall_back_to_the_requests(tool):
    events = [("portbench/profiled", False, 0.0, 1000.0, True),
              ("kernel", True, 100.0, 200.0, False)]
    got = tool.idle_names(events, [(10.0, 20.0), (500.0, 600.0)],
                          [("in a request", 0.0, 300e-6)], [], 0.0,
                          "portbench/profiled")
    assert got["ranges"] == pytest.approx({"in a request": 10e-6,
                                           "between requests": 100e-6})
    assert got["differ_s"] == 0.0


def test_span_summary(tool):
    def sp(name, t0, t1, **args):
        return SimpleNamespace(name=name, t0=t0, t1=t1, args=args)

    spans = [sp("decode_list/patch", 0.1, 0.3),
             sp("decode_list/group_pfd", 0.0, 0.5, n=100, exc=7),
             sp("decode_list/patch", 1.1, 1.2),
             sp("decode_list/group_pfd", 1.0, 1.25, n=50, exc=0),
             sp("encode/group_pfd", 2.0, 2.5, n=150)]
    got = tool.span_summary(spans, 3, 4.0)
    assert got["seconds"] == 4.0 and got["dropped"] == 3
    rows = got["spans"]
    assert rows["decode_list/group_pfd"] == {
        "count": 2, "seconds": pytest.approx(0.75), "n": 150, "exc": 7}
    assert rows["decode_list/patch"] == {
        "count": 2, "seconds": pytest.approx(0.3), "n": 0, "exc": 0}
    assert rows["encode/group_pfd"]["n"] == 150


def test_tool_runs_a_tiny_cell_on_the_cpu(tool):
    out = tool.run("gov2pfd-decode", 5, 0.2, "cpu",
                   {"n_docs": 20_000, "n_terms_sampled": 20, "n_lists": 20})
    enc = out["setup"]["spans"]["encode/group_pfd"]
    assert enc["count"] == 20 and out["setup"]["dropped"] == 0
    off, spans, prof, off2 = out["parts"]
    assert [p["part"] for p in out["parts"]] == ["off", "spans", "profiled",
                                                 "off"]
    assert "spans" not in off and "spans" not in off2
    rows = spans["spans"]
    lists = rows["decode_list/group_pfd"]
    assert lists["count"] == 20 * spans["requests"]
    assert lists["n"] == spans["postings"] and spans["dropped"] == 0
    assert {r["count"] for r in rows.values()} == {lists["count"]}
    assert prof["range_events"] == 4 * prof["spans"]["decode_list/group_pfd"][
        "count"]
    assert prof["device_range_events"] == [0, 0]
    assert sum(prof["ranges"].values()) == pytest.approx(prof["idle_s"])
