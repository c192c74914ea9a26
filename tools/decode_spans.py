#!/usr/bin/env python3
"""Where the host time of a whole-list decode goes: a benchmark cell's lists
(``portbench``'s ``gov2pfd-decode`` by default) decoded with the codec
layer's spans on (``enable_tracing(codec=True)``), read three ways.

    python3 tools/decode_spans.py [--workload gov2pfd-decode] [--seed 1] \\
        [--seconds 10] [--device cuda] [--out chiprun_out/decode_spans.json]

After the cell's corpus, set-up (the tracer on, so each ``encode/<codec>``
span is summed) and one warm-up request, it serves the cell's requests in
a closed loop in four parts of ``--seconds`` each (a part ends with the
request that passes its deadline):

* ``off``: the tracer off, as the benchmark's untraced window runs;
* ``spans``: the codec spans on, no profiler: for each span name its count,
  seconds, summed ``n`` and ``exc``, and the tracer's ``dropped``;
* ``profiled``: the codec spans on under ``torch.profiler``: the device's
  idle gaps named by the innermost span as the profiler stamped it (its
  mirrored range), and as ``portbench/trace_read.py`` maps the monotonic
  spans through one anchor stamp, with the idle seconds the two name
  differently;
* ``off`` again.

On the card a Group-PFD list is one launch of kernel PFD
(``kernels/pfd_decode.py``), and ``decode_list/<codec>`` is its only span:
``decode_list/widths``, ``/unpack`` and ``/patch`` wrap the plain version
alone, which a CPU tensor runs.  A run on the card says so under
``"phases"``.

One JSON object goes to standard output and to ``--out``.  Reads the
benchmark's files; changes none of them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

OUTSIDE = "between requests"
PHASES_ON_CARD = ("decode_list/group_pfd alone: on the card a list is one "
                  "launch of kernel PFD, and the decode_list/widths, "
                  "/unpack and /patch spans exist only on the plain path "
                  "(a CPU tensor)")


def innermost(intervals: list, points: list, outside: str) -> list:
    """For each of ``points`` (ascending), the name of the innermost of
    ``intervals`` ((start, end, name), properly nested or disjoint) that
    holds it, else ``outside``: one sweep, not a search per point."""
    order = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    stack, j, names = [], 0, []
    for t in points:
        while j < len(order) and order[j][0] <= t:
            while stack and stack[-1][1] <= order[j][0]:
                stack.pop()
            stack.append(order[j])
            j += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        names.append(stack[-1][2] if stack else outside)
    return names


def idle_names(events: list, gaps: list, requests: list, spans: list,
               offset_us: float, anchor: str) -> dict:
    """The idle ``gaps`` ((start_us, end_us), ascending) named twice:
    ``ranges``, by the innermost user-annotation range on the profiler's
    clock (the mirrored spans), else the request that holds the gap;
    ``anchor``, by the innermost monotonic span or request mapped through
    ``offset_us``.  ``requests``, ``spans``: (name, t0_s, t1_s) monotonic.
    Returns {"ranges": {name: s}, "anchor": {name: s}, "differ_s": s}."""
    mids = [(s + e) / 2 for s, e in gaps]
    reqs = [(a * 1e6 + offset_us, b * 1e6 + offset_us, n)
            for n, a, b in requests]
    ranges = [(s, e, n) for n, dev, s, e, note in events
              if note and not dev and n != anchor]
    by_range = innermost(ranges, mids, "")
    by_req = innermost(reqs, mids, OUTSIDE)
    by_range = [r or q for r, q in zip(by_range, by_req)]
    by_anchor = innermost(reqs + [(a * 1e6 + offset_us, b * 1e6 + offset_us,
                                   n) for n, a, b in spans], mids, OUTSIDE)
    out = {"ranges": {}, "anchor": {}, "differ_s": 0.0}
    for (s, e), r, a in zip(gaps, by_range, by_anchor):
        d = (e - s) / 1e6
        out["ranges"][r] = out["ranges"].get(r, 0.0) + d
        out["anchor"][a] = out["anchor"].get(a, 0.0) + d
        if r != a:
            out["differ_s"] += d
    return out


def span_summary(spans: list, dropped: int, seconds: float) -> dict:
    """{"seconds", "dropped", "spans": {name: {count, seconds, n, exc}}} of
    a part's finished spans (``Span`` objects)."""
    table = {}
    for sp in spans:
        row = table.setdefault(sp.name, {"count": 0, "seconds": 0.0, "n": 0,
                                         "exc": 0})
        row["count"] += 1
        row["seconds"] += sp.t1 - sp.t0
        row["n"] += sp.args.get("n", 0)
        row["exc"] += sp.args.get("exc", 0)
    return {"seconds": seconds, "dropped": dropped, "spans": table}


def serve_for(drv, stream, seconds: float, sync) -> tuple:
    """(seconds, postings, [(t0, t1)] monotonic) of the requests served
    from ``stream`` until ``seconds`` have passed."""
    reqs, postings = [], 0
    t0 = time.perf_counter()
    while True:
        r = next(stream)
        m0 = time.monotonic()
        drv.serve(r)
        sync()
        reqs.append((m0, time.monotonic()))
        postings += drv.units(r)["postings"]
        if time.perf_counter() - t0 >= seconds:
            return time.perf_counter() - t0, postings, reqs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="gov2pfd-decode")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--config", default=None,
                    help="JSON object of configuration keys to override "
                         "(a small corpus for a CPU run)")
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    out = run(args.workload, args.seed, args.seconds, args.device,
              json.loads(args.config) if args.config else {})
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


def run(workload: str, seed: int, seconds: float, device: str,
        config: dict = None) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from portbench import corpus as corpus_lib
    from portbench import generator, harness, trace_read
    from repro_torch.obs.trace import enable_tracing

    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    cell = harness.resolve(workload)
    cfg = dict(cell.config, **(config or {}))
    drv = cell.driver.Driver(cfg, cell.traffic, dev, lambda msg: None)
    drv.prepare()
    corp = corpus_lib.make_corpus(cfg, seed)
    tracer = enable_tracing(True, codec=True)
    tracer.clear()
    t0 = time.perf_counter()
    drv.setup(corp)
    setup = span_summary(tracer.spans(), tracer.dropped,
                         time.perf_counter() - t0)
    enable_tracing(False)
    tracer.clear()
    stream = generator.requests(seed, generator.WINDOW, cell.traffic,
                                cfg["n_lists"])
    drv.serve(next(stream))
    sync()
    res = {"workload": workload, "seed": seed, "device": str(dev),
           "setup": setup, "parts": []}
    if cuda:
        res["phases"] = PHASES_ON_CARD

    def part(name, spans_on, profiled):
        tracer = enable_tracing(spans_on, codec=spans_on)
        tracer.clear()
        prof = None
        if profiled:
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else [])
            prof = profile(activities=acts)
            prof.__enter__()
            anchor = time.monotonic()
            rf = record_function(trace_read.ANCHOR)
            rf.__enter__()
        secs, postings, reqs = serve_for(drv, stream, seconds, sync)
        if profiled:
            rf.__exit__(None, None, None)
            prof.__exit__(None, None, None)
        spans, dropped = tracer.spans(), tracer.dropped
        enable_tracing(False)
        tracer.clear()
        row = {"part": name, "seconds": secs, "postings": postings,
               "postings_per_s": postings / secs, "requests": len(reqs)}
        if spans_on:
            row.update(span_summary(spans, dropped, secs))
        if profiled:
            events = trace_read.raw_events(prof)
            lo = trace_read.anchor_us(events)
            busy, gaps = trace_read.busy_and_gaps(
                trace_read.device_events(events), lo, lo + secs * 1e6)
            named = idle_names(
                events, gaps, [("in a request", a, b) for a, b in reqs],
                [(sp.name, sp.t0, sp.t1) for sp in spans],
                lo - anchor * 1e6, trace_read.ANCHOR)
            names = {sp.name for sp in spans}
            on_device = [e for e in events if e[1] and e[0] in names]
            row.update(busy_s=busy / 1e6, idle_s=secs - busy / 1e6,
                       range_events=sum(1 for e in events if e[4]
                                        and not e[1] and e[0] in names),
                       # the ranges' images on the device's timeline, and
                       # how many the profiler flags as annotations (those
                       # trace_read.device_events leaves out)
                       device_range_events=[len(on_device),
                                            sum(e[4] for e in on_device)],
                       **named)
        res["parts"].append(row)

    part("off", False, False)
    part("spans", True, False)
    part("profiled", True, True)
    part("off", False, False)
    return res


if __name__ == "__main__":
    sys.exit(main())
