"""Serving launcher of the port: the latency-governed index serving loop
(``--index``: async admission + dynamic batching over the ``QueryEngine``,
see ``repro_torch.index.serve``), on the card unless asked for the CPU.

  python -m repro_torch.launch.serve --index --smoke
  python -m repro_torch.launch.serve --index --smoke --torch-device cpu
  python -m repro_torch.launch.serve --index --rate 300 --requests 512 --placement device

Counterpart of the index half of the JAX package's ``launch/serve.py``
(``serve_index``).  Its model half (``--arch``: LM prefill and decode,
recsys scoring) is not ported yet (``ROADMAP.md`` step A.13) and raises.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def serve_index(args) -> None:
    """Index retrieval serving: build a seeded corpus, start the
    :class:`~repro_torch.index.serve.IndexServer`, drive an open-loop
    Poisson stream through it, and print the SLO snapshot.  ``--smoke``
    shrinks the stream to CI size and asserts nothing was shed."""
    from ..data import synth
    from ..index.device import resolve_device
    from ..index.engine import QueryEngine
    from ..index.invindex import InvertedIndex
    from ..index.serve import (Rejected, Request, ServeConfig,
                               poisson_offsets, serve_stream)
    from ..obs import (enable_tracing, get_tracer, to_chrome_trace,
                       trace_coverage)

    dev = resolve_device(args.torch_device)
    n = 32 if args.smoke else args.requests
    if args.trace_out:
        # deep engine/kernel spans ride the process-global tracer; the
        # server's lifecycle spans are always on (server-owned tracer)
        enable_tracing(True, fenced=args.fenced)
    doclen, postings = synth.make_corpus(args.dataset, args.seed)
    idx = InvertedIndex.build(doclen, postings)
    idx.to_device(build_fused=True, device=dev)
    engine = QueryEngine(idx).to_device(fused=True, torch_device=dev)
    # head-term conjunctions, the reference benchmark's workload shape
    rng = np.random.default_rng(3 + args.seed)
    terms = sorted(postings)
    queries = [rng.choice(terms[:120], size=rng.integers(2, 4),
                          replace=False).tolist() for _ in range(n)]
    reqs = [Request(list(q), mode="and", k=10, deadline_ms=args.deadline_ms)
            for q in queries]
    offsets = poisson_offsets(n, args.rate, seed=41 + args.seed)
    cfg = ServeConfig(max_batch=16, max_wait_ms=4.0, slack_ms=2.0,
                      queue_cap=max(256, 4 * n),
                      default_deadline_ms=args.deadline_ms,
                      placement=args.placement, warm_terms=32,
                      # prime with the (seeded, known) workload so the
                      # stream measures serving, not first-use builds
                      warm_queries=queries)
    results, stats = serve_stream(engine, reqs, offsets, cfg)
    snap = stats.snapshot()
    lat = snap["latency_ms"]
    print(f"served {snap['served']}/{snap['submitted']} "
          f"(shed_rate={snap['shed_rate']:.3f}) at {args.rate:.0f} qps "
          f"poisson on placement={args.placement or 'auto'}, device {dev}")
    print(f"latency ms: p50={lat.get('p50', 0):.2f} p99={lat.get('p99', 0):.2f} "
          f"p999={lat.get('p999', 0):.2f}  goodput={snap['goodput_qps']:.1f} qps  "
          f"mean_batch={snap['mean_batch']:.1f}  warmup={snap['warmup_s']:.2f}s")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            f.write(stats.to_prometheus())
        print(f"wrote prometheus metrics to {args.metrics_out}")
    if args.trace_out:
        trace = to_chrome_trace(stats.tracer, get_tracer())
        with open(args.trace_out, "w") as f:
            json.dump(trace, f)
        cov = trace_coverage(stats.tracer.spans())
        print(f"wrote {len(trace['traceEvents'])} trace events to "
              f"{args.trace_out} (batch coverage {cov:.3f}); load at "
              f"https://ui.perfetto.dev")
        if args.smoke:
            # the export round-trips as JSON and the plan/execute/deliver
            # children account for >= 90% of measured batch wall-clock
            with open(args.trace_out) as f:
                assert json.load(f)["traceEvents"], "empty trace export"
            assert cov >= 0.9, f"trace covers {cov:.3f} < 0.9 of batch time"
        enable_tracing(False)
    if args.smoke:
        shed = [r for r in results if isinstance(r, Rejected)]
        assert not shed, f"smoke stream shed {len(shed)} requests: {shed[:3]}"
        print("index serve smoke ok")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="model serving: not ported yet (ROADMAP.md A.13)")
    ap.add_argument("--index", action="store_true",
                    help="serve the inverted index (async admission + "
                         "dynamic batching)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--dataset", default="gov2")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--rate", type=float, default=200.0,
                    help="mean Poisson arrival rate (qps)")
    ap.add_argument("--deadline-ms", type=float, default=2500.0,
                    help="per-request SLO budget")
    ap.add_argument("--placement", default=None,
                    choices=["host", "device", "fused"],
                    help="pin every batch's placement (default: engine "
                         "auto-placement)")
    ap.add_argument("--torch-device", default="cuda",
                    help="torch device of the engine (default: the card; "
                         "'cpu' runs the kernels' plain versions)")
    ap.add_argument("--trace-out", default=None,
                    help="write a Perfetto-loadable Chrome trace-event JSON "
                         "of the run (also enables the deep engine/kernel "
                         "spans)")
    ap.add_argument("--metrics-out", default=None,
                    help="write the server's Prometheus text exposition to "
                         "this file after the stream")
    ap.add_argument("--fenced", action="store_true",
                    help="with --trace-out: synchronize the card inside "
                         "round spans so durations attribute device time to "
                         "the producing kernel")
    args = ap.parse_args(argv)
    if args.arch is not None:
        raise NotImplementedError(
            f"--arch {args.arch}: model serving is not ported yet "
            "(ROADMAP.md, step A.13); use --index")
    if not args.index:
        ap.error("--index is required (model serving waits for A.13)")
    serve_index(args)


if __name__ == "__main__":
    main()
