"""The metric arithmetic on a recorded window and a recorded profiler
table; every reader by the name BENCHMARK.json gives."""

import os

import pytest

from portbench import bytecount, flops, harness, trace_read

READERS = {os.path.splitext(f)[0]: harness.load_module(
    os.path.join(harness.BENCH, "metrics", f))
    for f in os.listdir(os.path.join(harness.BENCH, "metrics"))
    if f.endswith(".py")}

KERNELS = {"unpack_kernel": [40, 1e-3],
           "Memcpy DtoH (Device -> Pinned)": [1, 0.5],
           "elementwise_kernel": [10, 1.5]}
REC = {
    "setup_s": 123.5, "fixed": {"bits_per_posting": 6.5},
    "window_s": 4.0, "peak_bytes": 2**31,
    "totals": {"lists": 40, "postings": 8_000_000, "tokens": 2048,
               "steps": 64, "model_flops": 3.9576e12},
    "profiled": {"busy_s": 2.0, "window_s": 8.0, "kernels": KERNELS,
                 "launches": 50, "totals": {"lists": 5, "min_bytes": 3.35e9,
                                            "steps": 5},
                 "idle_by_host": {}},
    # the traced run's untraced half: 0.8 s a step against 0.4 s busy
    "untraced": {"window_s": 4.0, "totals": {"steps": 5}},
}
WANT = {
    "setup_s": 123.5, "bits_per_posting": 6.5, "decode_rate": 2e6,
    "pfd_decode_roofline": 0.05, "pfd_launches_per_list": 10.0,
    "device_idle.decode": 75.0, "peak_gib.decode": 2.0,
    "lm_tokens_per_s": 512.0, "mfu": 0.1, "lm_launches_per_step": 10.0,
    "device_idle.lm": 50.0, "peak_gib.lm": 2.0,
}


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader(name):
    assert READERS[name].read(REC) == pytest.approx(WANT[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_without_its_record_gives_nothing(name):
    rec = {"setup_s": 1.0, "fixed": {}}
    assert READERS[name].read(rec) is (1.0 if name == "setup_s" else None)


def test_every_reader_is_tested():
    assert set(READERS) == set(WANT)


def test_byte_counts():
    assert bytecount.decode_bytes(100, 10) == 140
    assert bytecount.seconds_at_peak(3.35e12) == 1.0


def test_model_flops_by_hand():
    """flops.py at the smoke sizes against a count made by hand."""
    from tiny import SMOKE_LM
    d, h, lora, nope, rope, v = 64, 4, 32, 16, 8, 16
    attention = d * h * (nope + rope) + d * (lora + rope) \
        + h * lora * (nope + v) + h * v * d
    dense = 3 * d * 96
    moe = d * 8 + 3 * d * 32 * (2 + 2)
    head = d * 512
    params = 2 * attention + dense + moe + head
    for ctx in (1, 65, 4112):
        want = 2 * params + 2 * 2 * h * ctx * (nope + rope + v)
        assert flops.mla_moe_token_flops(SMOKE_LM, ctx) == want
    assert flops.decode_turn_flops(SMOKE_LM, 3, 64, 2) == 3 * (
        flops.mla_moe_token_flops(SMOKE_LM, 65)
        + flops.mla_moe_token_flops(SMOKE_LM, 66))


def test_busy_and_gaps():
    ops = [("a", 0, 10), ("b", 5, 15), ("c", 20, 30), ("d", 35, 50)]
    busy, gaps = trace_read.busy_and_gaps(ops, 0, 40)
    assert busy == 30 and gaps == [(15, 20), (30, 35)]
    assert trace_read.busy_and_gaps([], 0, 40) == (0.0, [(0, 40)])


def _event(name, device, start, end, annotation=False):
    return (name, device == "CUDA", start, end, annotation)


def test_summarize_a_profiler_record():
    events = [
        _event(trace_read.ANCHOR, "CPU", 1000.0, 9000.0, True),
        _event(trace_read.ANCHOR, "CUDA", 1000.0, 9000.0, True),
        _event("aten::add", "CPU", 1100.0, 1200.0),
        _event("decode_and_kernel", "CUDA", 2000.0, 3000.0),
        _event("decode_and_kernel", "CUDA", 2500.0, 4000.0),
        _event("Memset (Device)", "CUDA", 6000.0, 6500.0),
    ]
    # the program's spans and the harness's requests on the monotonic
    # clock: the anchor at 10.0 s
    spans = [(trace_read.IN_REQUEST, 10.0, 10.006, 0, 0, {}),
             ("decode/group_pfd", 10.0035, 10.0055, 2, 0, {})]
    rec = trace_read.summarize(events, 10.0, 0.010, spans)
    assert rec["busy_s"] == pytest.approx(0.0025)
    assert rec["launches"] == 2
    assert rec["kernels"]["decode_and_kernel"] == [2, pytest.approx(0.0025)]
    assert rec["idle_by_host"] == pytest.approx(
        {trace_read.IN_REQUEST: 0.001, "decode/group_pfd": 0.002,
         trace_read.HOST_IDLE: 0.0045})
    assert trace_read.top({"a": 1, "b": 3, "c": 2}, 2) == [["b", 3], ["c", 2]]
