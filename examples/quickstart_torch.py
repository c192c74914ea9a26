"""Quickstart on the PyTorch/CUDA port: the paper's compression approach in
five minutes, on the card unless asked for the CPU.

  1. encode/decode posting-list d-gaps with every Group codec,
  2. compare scalar vs vectorized decode (the paper's central axis), each
     codec's torch decoders (``Codec.torch``) on the device,
  3. run the stream kernels: pack (CUDA kernel B7a), then the fused
     unpack + prefix sum (B6),
  4. build + query a compressed inverted index,
  5. serve a query batch through the batched host engine
     (plan, then execute: engine.execute(engine.plan(batch))),
  6. move the index into device-resident arenas (engine.to_device()) and
     serve the same batch with round-batched decodes on the device (the
     survivor scatter is kernel B2), then ranked top-k (B2's add form, the
     score-column unpack B3) — each asserted equal to the host engine.

The port's counterpart of ``examples/quickstart.py``.  Prints the kernel
launches of the run last (``repro_torch.kernels.LAUNCHES``; a CPU run
launches none: the kernels' plain versions run instead).

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--torch-device cpu]
"""

import argparse
import json
import time

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core import codec as codec_lib
from repro_torch.core.bits import from_np, to_np
from repro_torch.core.dgap import dgap_encode_np
from repro_torch.data import synth
from repro_torch.index import query as Q
from repro_torch.index.device import resolve_device
from repro_torch.index.engine import QueryBatch, QueryEngine
from repro_torch.index.invindex import InvertedIndex
from repro_torch.kernels import ops


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--torch-device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args()
    dev = resolve_device(args.torch_device)

    lists = synth.make_dataset("gov2", seed=0)
    gaps = synth.concat_gaps(lists)
    print(f"GOV2-like stream: {len(gaps)} d-gaps, "
          f"{100*float(np.mean(gaps < 256)):.1f}% fit in one byte; device {dev}\n")

    print(f"{'codec':22}{'bits/int':>9}{'scalar(ms)':>12}{'vec(ms)':>9}")
    for name in ("group_simple", "group_scheme_1-CU", "group_scheme_8-IU",
                 "group_afor", "group_pfd", "bp128"):
        spec = codec_lib.get(name)
        enc = spec.encode(gaps)
        targs = spec.torch.args(enc, dev)
        out = to_np(spec.torch.vec(**targs))
        assert np.array_equal(out, gaps)
        spec.torch.vec(**targs)       # warm-up: torch compiles nothing
        sync(dev)
        t0 = time.perf_counter(); spec.torch.scalar(**targs); sync(dev)
        ts = time.perf_counter() - t0
        t0 = time.perf_counter(); spec.torch.vec(**targs); sync(dev)
        tv = time.perf_counter() - t0
        print(f"{name:22}{enc.bits_per_int:9.2f}{ts*1e3:12.2f}{tv*1e3:9.2f}")

    # stream kernels: pack (B7a) -> fused unpack + prefix sum (B6)
    docids = np.sort(np.random.default_rng(0).choice(1 << 20, 20000, replace=False)).astype(np.uint32)
    g = dgap_encode_np(docids)
    bw = int(np.ceil(np.log2(g.max() + 1)))
    packed = ops.pack_stream(from_np(g, dev), bw)
    recon = to_np(ops.unpack_delta_stream(packed, bw, len(g)))
    assert np.array_equal(recon, docids)
    print(f"\nfused unpack+prefix-sum: {len(g)} gaps at bw={bw} -> docids OK "
          f"({packed.numel() * 4 / len(g):.2f} B/int vs 4.00 raw)")

    # compressed inverted index + queries
    doclen, postings = synth.make_corpus("gov2")
    idx = InvertedIndex.build(doclen, postings, codec="group_simple")
    hits = Q.and_query_scored(idx, [1, 5], k=5)
    print(f"\nindex: {idx.size_bytes()/1e6:.2f} MB (group_simple); "
          f"AND(1,5) top hit doc={hits[0][0]} bm25={hits[0][1]:.2f}")

    # batched serving: many queries per call, shared decoded-block LRU
    rng = np.random.default_rng(0)
    terms = sorted(postings)
    queries = [rng.choice(terms[:100], size=3, replace=False).tolist()
               for _ in range(256)]
    engine = QueryEngine(idx, cache_blocks=4096)
    plan = engine.plan(QueryBatch(queries, mode="and"))
    t0 = time.perf_counter()
    results = engine.execute(plan)
    dt = time.perf_counter() - t0
    st = engine.cache.stats()
    print(f"batched engine: {len(queries)} AND queries in {dt*1e3:.1f} ms "
          f"({len(queries)/dt:.0f} qps); block cache {st['hits']} hits / "
          f"{st['misses']} misses; first result has {len(results[0])} docs")

    # device-resident serving: compressed blocks flattened into device
    # arenas, each AND round issues one batched decode for the whole batch's
    # deduped (term, block) work-list instead of O(blocks) Python iterations
    dev_eng = QueryEngine(idx, cache_blocks=4096).to_device(torch_device=dev)
    dev_plan = dev_eng.plan(QueryBatch(queries, mode="and"))
    dev_eng.execute(dev_plan)                           # warm up
    dev_eng = QueryEngine(idx, cache_blocks=4096).to_device(torch_device=dev)
    calls0 = dev_eng.arena.stats["device_calls"]   # arena (and stats) are shared
    sync(dev)
    t0 = time.perf_counter()
    dev_results = dev_eng.execute(dev_plan)
    dt = time.perf_counter() - t0
    assert all(np.array_equal(a, b) for a, b in zip(results, dev_results))
    ds = dev_eng.dev_stats
    print(f"device engine:  {len(queries)} AND queries in {dt*1e3:.1f} ms "
          f"({len(queries)/dt:.0f} qps, exact parity); work-list "
          f"{ds['worklist_refs']} block refs -> {ds['worklist_decodes']} decodes "
          f"in {dev_eng.arena.stats['device_calls'] - calls0} device calls")

    # ranked top-k through the quantized score arenas: BM25 impacts ride as
    # u8 score columns next to the docid streams, OR work-lists are block-max
    # pruned, and only the final candidate bitmap returns to the host; the
    # float rescore makes the results exactly the host oracle's (docid ties)
    topk_plan = dev_eng.plan(QueryBatch(queries[:64], mode="or", k=5))
    top = dev_eng.execute(topk_plan)
    host_top = engine.execute(engine.plan(QueryBatch(queries[:64], mode="or", k=5)))
    assert top == host_top
    ds = dev_eng.dev_stats
    print(f"ranked top-k:   64 OR queries, k=5 -> top hit doc={top[0][0][0]} "
          f"bm25={top[0][0][1]:.2f}; {ds['blocks_pruned']} blocks pruned / "
          f"{ds['blocks_scored']} scored, {ds['score_syncs']} per-round syncs "
          f"(exact parity with the host float oracle)")
    print(f"dense-bitmap entries served: {ds['blocks_dense']}; the dense "
          f"window add (B4) {'launched' if kernels.LAUNCHES['B4'] else 'not launched'}")
    print("kernel launches: " + json.dumps(kernels.LAUNCHES))


if __name__ == "__main__":
    main()
