"""Quickstart on the PyTorch/CUDA port: latency-governed online serving
over the compressed index, on the card unless asked for the CPU.

  1. build a seeded corpus and move it into device-resident arenas,
  2. start an IndexServer (async admission + dynamic batching) — warm-up
     primes the hot-term caches and the batch sizes,
  3. drive an open-loop Poisson request stream with per-request deadlines
     and two weighted tenants through it,
  4. read the SLO snapshot (p50/p99/p999 latency, goodput, shed rate,
     batch-size histogram per placement),
  5. replay one formed batch through the offline plan/execute oracle and
     check the served results are bitwise identical.

The port's counterpart of ``examples/serve_quickstart.py``.

Run:  PYTHONPATH=src python examples/serve_quickstart_torch.py [--torch-device cpu]
"""

import argparse

import numpy as np

from repro_torch.data import synth
from repro_torch.index.device import resolve_device
from repro_torch.index.engine import QueryBatch, QueryEngine
from repro_torch.index.invindex import InvertedIndex
from repro_torch.index.serve import (Rejected, Request, ServeConfig,
                                     poisson_offsets, serve_stream)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--torch-device", default="cuda",
                    help="torch device of the engine (default: the card; "
                         "'cpu' runs the kernels' plain versions)")
    args = ap.parse_args()
    dev = resolve_device(args.torch_device)

    # 1. corpus + device arenas (the same seeded GOV2-like shape)
    doclen, postings = synth.make_corpus("gov2", seed=0)
    idx = InvertedIndex.build(doclen, postings, codec="group_simple")
    idx.to_device(build_fused=False, device=dev)
    engine = QueryEngine(idx).to_device(torch_device=dev)

    # 2-3. a 128-request open-loop Poisson stream at 200 qps: every request
    # carries a 2.5 s deadline.  Tenant "pro" has twice "free"'s admission
    # weight, so under contention it gets ~2x the batch slots.
    n, rate = 128, 200.0
    rng = np.random.default_rng(3)
    terms = sorted(postings)
    reqs = [Request(rng.choice(terms[:120], size=3, replace=False).tolist(),
                    mode="and", k=10,
                    tenant="pro" if i % 3 else "free", deadline_ms=2500.0)
            for i in range(n)]
    cfg = ServeConfig(max_batch=16, max_wait_ms=4.0, slack_ms=2.0,
                      queue_cap=n, default_deadline_ms=2500.0,
                      tenants={"pro": 2.0, "free": 1.0}, warm_terms=32)
    results, stats = serve_stream(
        engine, reqs, poisson_offsets(n, rate, seed=41), cfg)
    assert all(not isinstance(r, Rejected) for r in results), "stream shed!"

    # 4. the SLO snapshot
    snap = stats.snapshot()
    lat = snap["latency_ms"]
    print(f"served {snap['served']}/{snap['submitted']} requests at "
          f"{rate:.0f} qps poisson (shed_rate={snap['shed_rate']:.3f}, "
          f"warmup={snap['warmup_s']:.2f}s) on device {dev}")
    print(f"latency ms: p50={lat['p50']:.2f}  p99={lat['p99']:.2f}  "
          f"p999={lat['p999']:.2f}   goodput={snap['goodput_qps']:.0f} qps  "
          f"on_time={snap['on_time_frac']:.2%}")
    print(f"batches: {snap['n_batches']} closed, mean size "
          f"{snap['mean_batch']:.1f}, histogram {snap['batch_hist']}")
    print(f"tenants: { {t: d['served'] for t, d in snap['per_tenant'].items()} }")

    # 5. bitwise parity: any batch the server formed replays through the
    # offline plan/execute discipline to the exact same results
    b = stats.batches[0]
    oracle = engine.execute(engine.plan(
        QueryBatch([list(q) for q in b.queries], mode=b.mode, k=b.k),
        placement=b.placement))
    for off, rid in zip(oracle, b.rids):
        assert np.array_equal(np.asarray(off), np.asarray(results[rid]))
    print(f"parity: batch {b.batch_id} ({len(b.queries)} requests, "
          f"placement={b.placement}) bitwise identical to the offline oracle")


if __name__ == "__main__":
    main()
