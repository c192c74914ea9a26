"""Serving launcher of the port, on the card unless asked for the CPU:
LM prefill + batched greedy decode, batched recsys scoring / retrieval
(``--arch``), or the latency-governed index serving loop (``--index``:
async admission + dynamic batching over the ``QueryEngine``, see
``repro_torch.index.serve``).

  python -m repro_torch.launch.serve --arch smollm-135m --smoke --tokens 8
  python -m repro_torch.launch.serve --arch smollm-135m --smoke --torch-device cpu
  python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b --smoke --torch-device cpu
  python -m repro_torch.launch.serve --arch mixtral-8x22b --smoke
  python -m repro_torch.launch.serve --arch din --shape serve_p99 --smoke --torch-device cpu
  python -m repro_torch.launch.serve --arch dien --shape retrieval_cand --smoke
  python -m repro_torch.launch.serve --index --smoke
  python -m repro_torch.launch.serve --index --rate 300 --requests 512 --placement device

Counterpart of the JAX package's ``launch/serve.py``.  ``--arch`` serves
every architecture with a serving cell (``repro_torch.configs.ARCHS``):
the LMs and the four recsys models.  EGNN has only train cells and raises,
naming the training slice (ROADMAP.md, step A.13.4); the reference fails
there too (an ``IndexError`` without ``--shape``, an ``AttributeError``
with one).  ``--shape`` picks the cell (default: the arch's first serving
cell); as in the reference it picks no plan or mesh until the sharding
slice (A.13.5), and ``--multi-pod`` waits for it.
"""

from __future__ import annotations

import argparse
import json
import time

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


def serve_lm(args, spec, cell) -> None:
    """Prefill a batch of seeded prompts, then batched greedy decode against
    the KV cache, as the reference's LM branch does; prints its line."""
    import torch

    from ..index.device import resolve_device
    from ..models import transformer

    cfg = spec.config_for_cell(
        spec.make_smoke_config() if args.smoke else spec.make_config(), cell)
    dev = resolve_device(args.torch_device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = transformer.init(cfg, gen)
    b, s = 2, 32
    prompts = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab, (b, s)),
        dtype=torch.int32, device=dev)
    logits, cache = transformer.prefill(model, prompts)
    if not cfg.window:
        cache = {k: torch.cat([v, v.new_zeros(v.shape[:2] + (args.tokens,) + v.shape[3:])], dim=2)
                 for k, v in cache.items()}
    tok = torch.argmax(logits, -1).to(torch.int32)
    t0 = time.perf_counter()
    for i in range(args.tokens):
        logits, cache = transformer.decode_step(model, cache, tok, s + i)
        tok = torch.argmax(logits, -1).to(torch.int32)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    print(f"decoded {args.tokens} steps x batch {b} in {(time.perf_counter()-t0)*1e3:.1f} ms")


def serve_recsys(args, spec, cell) -> None:
    """One step of a recsys cell (``serve``: probabilities; ``retrieval``:
    the top 100) on a seeded batch, as the reference's recsys branch runs
    it; prints its line."""
    import torch

    from ..configs.base import STEP_FNS
    from ..index.device import resolve_device
    from ..models import recsys
    from .batches import smoke_batch

    cfg = spec.config_for_cell(
        spec.make_smoke_config() if args.smoke else spec.make_config(), cell)
    dev = resolve_device(args.torch_device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = recsys.init(cfg, gen)
    step_fn, _ = STEP_FNS["recsys"](cfg, cell, None)
    # the reference's module-global generator, seeded 11, at its first draw
    batch = smoke_batch(spec, cfg, cell, np.random.default_rng(11), dev)
    if cell.kind == "retrieval":
        batch = {k: (v[:1] if not k.startswith("cand_") else v) for k, v in batch.items()}
    out = step_fn(model, batch)
    out0 = out[0] if isinstance(out, tuple) else out
    print(f"{cell.name}: output {tuple(out0.shape)} ok")


def main(argv=None) -> None:
    from .. import configs

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    choices=sorted(set(configs.ARCHS) | set(configs.PENDING)),
                    help="serve a model arch: the LMs and the recsys models "
                         "(egnn has only train cells and raises, naming "
                         "ROADMAP.md step A.13.4)")
    ap.add_argument("--shape", default=None,
                    help="the arch's cell to serve (default: its first "
                         "serving cell), e.g. serve_p99, serve_bulk, "
                         "retrieval_cand")
    ap.add_argument("--index", action="store_true",
                    help="serve the inverted index (async admission + "
                         "dynamic batching)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--tokens", type=int, default=8)
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
                    help="torch device of the model or the engine (default: "
                         "the card; 'cpu' runs the kernels' plain versions)")
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
    if args.index:
        serve_index(args)
        return
    if args.arch is None:
        ap.error("either --arch or --index is required")
    spec = configs.get(args.arch)
    serve_cells = [c for c in spec.shapes.values()
                   if c.kind in ("prefill", "decode", "serve", "retrieval")]
    if not serve_cells:
        raise NotImplementedError(
            f"{args.arch}: has only train cells ({', '.join(spec.shapes)}); "
            "its train step waits for the training slice (ROADMAP.md, step "
            "A.13.4)")
    if args.shape is not None and args.shape not in spec.shapes:
        ap.error(f"--shape {args.shape}: {args.arch} has {sorted(spec.shapes)}")
    cell = spec.shapes[args.shape] if args.shape else serve_cells[0]
    if spec.family == "lm":
        serve_lm(args, spec, cell)
    else:
        serve_recsys(args, spec, cell)


if __name__ == "__main__":
    main()
