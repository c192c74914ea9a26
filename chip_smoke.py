#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Drives the port's main paths, fused device-resident AND serving, ranked
BM25 top-k serving (modes ``or`` and ``and_scored``), serving under
mutation epochs, the stream codec (encode and decode of every posting
list), the paper's Group codecs (a Group-PFD index served on the
``device`` placement, and the decode table of every codec with a torch
decoder), doc-range sharded serving and the ``IndexServer`` serving loop,
through the entry points a user calls, at the real document count of the
TREC GOV2 collection; the examples, the one-shot query shims and LM
serving (smollm-135m and starcoder2-3b dense, deepseek-v2-lite-16b and
mixtral-8x22b mixture-of-experts, at their published widths, prompts from
the compressed token store); recsys serving (dlrm-rm2, wide-deep, din,
dien) and the EGNN forward on its four graph regimes, at full width;
training (smollm-135m, the four recsys archs and EGNN taking train steps
at full width, checkpoints, crash and resume, the compressed gradient
all-reduce); and holds every CUDA kernel of the paths against its plain
torch version on the card:

  card       the card, its power limit, torch / CUDA / nvcc versions
  build      nvcc builds every kernels/csrc/*.cu and tools/and_round_forms.cu
             (one process per source), in threads beside the main path's
             corpus and index build; joined before the index goes to the card
  main path  GOV2-statistics corpus (synth's Zipf formula, 200 terms) at
             25,205,179 docs; InvertedIndex.build; QueryEngine.to_device(
             fused=True); one batch of 256 AND queries to warm up, then a
             fresh batch of 256 from the same distribution timed with every
             launch count set to 0 just before (block cache warm, round memo
             cold), then that batch repeated (round memo warm).  Every result
             is checked against a numpy oracle on the raw postings;
             cand_syncs == 0, final_syncs == 1, <= 1 decode per hot block,
             and kernels B1 and B2 launched.  A third fresh batch runs under
             the fenced span tracer for the time breakdown.  The warm-up
             batch leaves host copies of its largest B1 call of each bit
             width and its largest B2 bits call of each round kind (seed,
             fused, probed plain where one ran) for the kernel phase
             (``tools/and_round_forms.py``'s capture).
  legacy     ``and_many`` on 16 of the queries (kernel B5), counts set to 0
             just before; results equal the main path's.
  ranked     on the same index: ``ensure_scores()``, then per mode (``or``,
             ``and_scored``, k=10, fused placement) a warm-up batch of 256
             queries drawn like the AND batches (own generator), a fresh
             batch timed with every launch count set to 0 just before, and
             a third fresh batch under the fenced span tracer.  Every result
             equals a numpy oracle (a dense float64 accumulator per query,
             term scores added in query-term order, ``topk_select``'s rule;
             the ``or`` oracles computed by 4 worker processes, each making
             the corpus from --seed, while the main path's index builds);
             final_syncs == 1, score_syncs == cand_syncs == 0, and kernels
             B1, B2 (both forms) and B3 launched, B4 too where the batch
             scored dense-bitmap blocks, packed and at most once a round.
             Each mode's warm-up batch leaves host copies of its largest
             B2-add and B4 calls for the kernel phase, ``and_scored``'s
             also of its AND rounds' B1 and B2 bits calls, as above.
  serve      an ``IndexServer`` (max_batch 16, max_wait_ms 4, placement
             ``fused``, warm-up in ``and`` and ``or``), right after the
             ranked path, in front of a fresh engine over the main path's
             generation (its arenas and score arena, cached on the
             generation, reused; ``to_device`` timed): a seeded open-loop
             Poisson stream at 20 requests/s of 128 of the main path's
             fresh ``and`` queries and 32 of its fresh ``or`` queries (k=10),
             shuffled, each with a 60,000 ms deadline, counts set to 0
             after the warm-up; shed_rate == 0, every served result equal
             to the main path's, the ``serve/*`` spans present, B1, B2, B2
             add and B3 launched; warm-up, p50/p99/p999, goodput, mean
             batch and the batch-size histogram printed.  Then ``python -m
             repro_torch.launch.serve --index --smoke`` in a subprocess,
             exit 0.
  mutation   on the same index, a fresh engine (fused placement) per
             generation.  Tombstone-only epoch: 1 % of the docs deleted (a
             permutation from --seed), then one fresh batch of each mode
             (64 queries, k=10), the first ``_df_live`` pass timed inside
             the ``and`` batch; the ``and`` and ``or`` batches again under
             the fenced span tracer (``and/tomb_gate``,
             ``ranked/tomb_gate``), the ``or`` repeat leaving its largest
             B1, B2-add (masked) and gated B4 calls for the kernel phase;
             the dead-docid test (``np.isin`` beside ``dead_hits``) timed.
             Delta epoch: 4,096 fresh docs past the doc space and 1,024
             base docs upserted (8 of the 120 most frequent terms each, tf
             1-4, the mean doclen), then ``and`` and ``and_scored`` (64)
             and ``or`` (16: with the theta cut disarmed every member doc
             is a candidate for the host rescore).  Then a 16-query ``and``
             plan pinned, ``compact()`` timed (the pause), the pinned plan
             served across the swap, the old engine freed, the new
             generation put on the card and ``and`` and ``or`` (64) served.
             Every result equals a numpy oracle over the live postings
             (BM25 with live df, the doc space, the live doclen mean; the
             ``or`` oracles computed by the ranked path's 4 worker
             processes, each scoring the epoch from its own corpus);
             cand_syncs == score_syncs == 0, final_syncs == 1 a batch,
             tomb_gates >= 1 a batch under an epoch with deletes (0 after
             the compaction), and the path's kernels launched.
  stream     the stream codec (``kernels/ops.py``) on every one of the
             corpus's 200 posting lists, counts set to 0 just before: the
             d-gaps uploaded, ``select_bw`` (B9) equal to numpy's per-frame
             widths, ``pack_stream`` (B7a) at the list's widest frame, the
             fused decode ``unpack_delta_stream`` (B6) and the two-pass one,
             ``unpack_stream`` (B7b) then ``prefix_sum`` (B8), each equal to
             numpy (gaps, docids); then ``bitmap_intersect_np(use_pallas=
             True)`` (B10) on the two longest lists equal to
             ``np.intersect1d``; B6-B10 launched.  Then the whole-corpus
             decode rate, fused and two-pass, in postings per second: CUDA
             events around the 200 lists, warm, host enqueue included.
  codecs     with every earlier engine and arena freed (the main path's
             unmutated generation is kept on the host only, for the
             sharded and examples phases):
             ``InvertedIndex.build(..., codec="group_pfd")`` on the same
             postings (in the spawned build worker, which makes the
             corpus from --seed and builds from the main path's start on,
             its first job; timed there, and the wait for it here; blocks
             with exceptions
             counted, > 0), then
             ``QueryEngine(idx).to_device(fused=True)`` (timed) with the
             score arena ``ensure_scores()`` builds made by the worker on
             the host after the index (``ScoreArena.from_index(device=
             "cpu")``, its seconds printed) and its two tensors moved to
             the card (timed), serving the main
             path's own fresh batches (their first 128 queries), ``and``,
             ``or`` and
             ``and_scored`` (k=10) on the ``device`` placement, then ``and``
             on the ``fused`` one, counts set to 0 just before each; every
             result equals the oracle the main path computed for that
             batch; cand_syncs == 0, final_syncs == 1, ranked score_syncs
             == 0, B2 launched, and every block decoded on the card
             (``arena.stats["blocks_host"] == 0``); the main path's traced
             batch of each mode under the fenced span tracer; peak device
             memory.  Then the decode table (the paper's Table VII on the
             card): every codec that declares ``Codec.torch`` on 20 whole
             lists (every tenth of the 200 by descending df; encoded on the
             host by worker processes while the arenas build),
             ``decode_torch_vec``
             equal to the d-gaps, counts set to 0 just before (Group-PFD
             and Group-OptPFD: kernel PFD, one launch a list; the others
             none), timed over the 20 lists (CUDA events,
             median of 5 after one, host enqueue included), postings/s and
             bits/posting; ``decode_torch_scalar`` (equal to the d-gaps,
             one timed run: a run is 1,024+ loop steps) beside ``vec`` on
             the first 1,024 quadruples of the longest list; the stream
             codec's fused decode over the same lists.
  sharded    the main path's unmutated ``group_simple`` generation (its
             host tables; no unsharded arena on the card) behind a fresh
             handle: ``ShardSpec.derive`` (4 shards, bounds printed),
             then ``QueryEngine(...).to_device(fused=True, shards=4,
             mesh=serving_mesh(4))`` (one card a shard where the machine
             has 4, else logical shards on one card; printed), timed with
             the shards' arenas and ``ensure_scores`` apart.  The shard
             generations (``shard_generation``, host work) are the
             build worker's second job, from the same corpus and index
             made from --seed (its bounds equal ``derive``'s; its build
             seconds and the wait printed).  The main path's fresh
             batches (their first 128 queries) in ``and``,
             ``or`` and ``and_scored`` (k=10) on ``fused`` and ``and`` on
             ``device``, counts set to 0 just before each: every result
             equal to the main path's (its numpy oracles); on the shard
             engines cand_syncs == score_syncs == 0; merge_syncs == 1 and
             collective_bytes == shards x 128 x 8 a ranked batch (0 for
             ``and``), shard_final_syncs == the non-empty shards a batch;
             B1 (fused), B2, and for the ranked batches B2 add, B3 and B4
             (where dense blocks scored) launched.  The traced batches of
             the three modes on ``fused`` under the fenced span tracer:
             ``sharded/merge``, per shard ``ranked/round``, ``kernel/topk``
             and ``kernel/extract_ids``.  Peak device memory.
  examples   the one-shot shims ``index.query.and_query`` and
             ``or_query`` (k=10) on 8 of the main path's fresh queries
             each, over its unmutated generation on the host placement
             (the shims take no device): every result equal to the main
             path's.  Then ``examples/quickstart_torch.py``, ``examples/
             serve_quickstart_torch.py`` and ``python -m
             repro_torch.launch.serve --arch smollm-135m --tokens 8`` (the
             full config), ``python -m repro_torch.launch.train --arch
             smollm-135m --smoke --steps 4`` and ``examples/
             train_lm_torch.py --steps 20``, subprocesses on the card
             started together at the start of the sharded phase,
             collected: each exits 0 and prints its result line (the
             reference's ``final loss``; the example's loss decreased),
             and the quickstart's own launch counts show B2, B3, B6 and
             B7a (B4 printed, launched or not).
  kernels    B1 (every bit-width bucket), B5, B2 (both forms), B3, B4 and
             B6-B10 on inputs made from --seed at the largest shape any main
             path gave each kernel (B1 probed against a random bitmap and
             against all ones, as the ``or`` rounds probe; B2's add form at
             the AND path's shape, as first recorded, and at the ranked
             path's; B4 unpacked, packed and packed gated on the same
             codes), compared bitwise with their plain versions; B1, B2
             add (masked) and B4 (gated, timed in turns beside ungated)
             also on the mutation phase's captured calls; B1 and
             B2's bits form also on the AND rounds' captured calls, each
             beside its earlier form (``tools/and_round_forms.cu``: B1 a
             block an entry, B2 bits a thread a lane on a bool mask; in
             the fused round also after the ``hits != 0`` pass the port
             dropped), bitwise and timed in turn, with distinct tile rows,
             probed sectors, live lanes, touched words and sectors, words
             per warp and each sector floor (B1: 32 B a probed sector; B2
             bits: 64 B a touched sector); B2's
             masked add form and B4's packed form also on the captured
             calls, with B2's probes (every contribution 0, ids made
             contiguous, the where pass) and
             the unpacked dense round (unpack and gate in plain torch,
             then the unpacked form) timed beside the packed form, gated
             and ungated; zero shares, touched words and 32-byte sectors and
             each sector floor (inputs + 64 B a sector); B6, B7a
             and B7b also at every bit width 1..32, B8 also on a sum that
             wraps past 2**32, a ragged row count, 1,001 tiles with a
             ragged end (more than the card holds at once) and two calls
             queued back to back on inputs of one shape.  CUDA-event times
             (median of 30 after warm-up, of 10 for the plain versions and
             library calls, each call queued behind a spin of
             the card so the events bracket device work, not the host's
             enqueue) of kernel, plain version and the library call where
             one computes the same function (``index_put_(accumulate=True)``
             for B2 and B4, ``torch.cumsum`` for B8, ``torch.bitwise_and``
             for B10); for B6-B10 also the time of one call from an idle
             queue (host enqueue included); the bytes bound.  Kernel PFD
             (Group-PFD's whole-list decode) on the decode table's longest
             list (the largest call) and shortest, and a one-tile list of
             7,579 postings, each bitwise against its plain version and
             the d-gaps and timed the same way, the bound being the encoded
             bytes and 4 B a posting; its launches are the decode table's;
             on the 7,579-posting list the host microseconds of a call
             (20,000 calls with no synchronise inside), whole, through
             ``Codec.torch.vec``, and part by part.  For B8 and
             B10 the grid launches and memsets one call puts on the card,
             counted from a ``torch.profiler`` trace; B10 and
             ``torch.bitwise_and`` also at 65,536 rows (3 x 32 MiB, above
             the 50 MB L2).
  lm         last, with every index arena freed, per model (smollm-135m,
             starcoder2-3b, deepseek-v2-lite-16b at its 27 layers, then
             mixtral-8x22b at 8 of its 56 layers: the whole, 281 GB in
             bf16, does not fit one card; ``make_config()``, full
             width): a
             ``TokenStore`` (bp128, block 65,536) of 16,777,216 Zipf(1.1)
             token ids folded into the vocabulary, its ratio and host read
             rate, read back equal; ``lm_batch_iter`` (batch 8, seq 2,048)
             gives the prompts.  Weights from ``init`` with a seeded
             ``torch.Generator`` on the card.  ``prefill`` of 8 x 2,048
             (one warm-up, then timed), the cache grown by 32, 32 greedy
             ``decode_step``s timed one by one, one more under
             ``torch.profiler`` (kernel time, the dtype casts' share).
             Checks: every parameter, cache and logit tensor on the card;
             every logit finite; the cache written in place (``data_ptr``
             unchanged); with fp32 activations on the same weights, cut to
             the first 2 layers, the decode step at position 256 equals
             ``trunk`` on 257 tokens (2 prompts) within 1e-3 of max
             |logit|; the bf16 prefill of the first layer on the card
             equals the same code's on the host CPU (2 x 64) within 2e-2
             of max |logit|.  Printed beside them, not checked: the same
             two comparisons at all layers (decode vs forward; the served
             batch's bf16 prefill against an fp32 one, with the top-1
             agreement), where the reference's random-weight models
             amplify round-off to the size of the logits
             (``tools/lm_roundoff_depth.py``).  Prefill and decode
             tokens/s, seconds a step, peak memory.
             The MoE archs add: the warm-up prefill's routing recorded
             (``route_spy``) and checked (no token takes an expert twice,
             every slot a token in range or the sentinel, each expert
             keeps min(load, capacity) tokens in token order), with the
             share dropped by capacity and the largest expert load; one
             more decode step's routing, which drops nothing; the decode
             checks' forward at capacity factor E/k (a decode group
             drops nothing, a forward at 1.25 does: that figure printed);
             the cut across both stacks (deepseek's 2 layers are its
             dense one and an MoE one; its bf16 card-vs-host check covers
             both, mixtral's its first); mixtral's decode step at
             position 4,160 (window + 64, batch 1, 2 layers: the
             prefill's ring wrapped) against ``trunk`` on 4,161 tokens
             within 1e-3 of max |logit|; the first MoE layer's fp32
             routing of 2 x 256 tokens on the card against
             ``route_group`` on the host CPU (``idx`` equal on the slots
             of every expert no near-tied token may flip, ``wgt`` within
             1e-6).
  recsys_gnn after the lm phase, its tensors freed; fp32, TF32 off,
             weights from ``init`` with a seeded ``torch.Generator`` on
             the card.  Recsys (``make_config()``: dlrm-rm2, wide-deep,
             din, dien): ``serve_p99`` (512 rows), ``serve_bulk``
             (262,144) and ``retrieval_cand`` (10**6 candidates, top 100)
             through ``STEP_FNS["recsys"]`` on ``cell_batch``'s uniform ids
             (numpy, from --seed); median ms of 5 calls after a warm-up
             (host clock to a synchronize), rows or candidates/s, peak
             memory.  Checks: probabilities in [0, 1], every output
             finite; the same weights on the host CPU give ``serve_p99``'s
             logits and probabilities and the first 4,096 candidates'
             logits within 1e-4 of max |logit|; the chunked top 100 equals
             one stable sort over every candidate's logit, in ids and
             scores.  EGNN (4 layers, ``d_hidden`` 64, ``config_for_cell``)
             on ``full_graph_sm``, ``molecule``, ``ogb_products`` (2.45 M
             nodes, 61.9 M edges) and ``minibatch_lg`` (1,024 seeds at
             fanout 15-10 sampled from ``CSRGraph.random(232,965,
             114,615,892)``, the build worker's third job, padded to
             170,496 nodes): ``forward`` (median of 3
             after a warm-up, edges/s, peak memory) and ``loss_fn``'s value.
             Checks: finite; ``full_graph_sm`` and ``molecule`` on the host
             CPU give ``h`` within 1e-4 of max |h| and the loss within 1e-4
             relative; ``ogb_products``' ``h`` with the coordinates rotated
             (a seeded orthogonal 3x3) and translated within 1e-3 of max
             |h|; the subgraph's invariants (1,024 seeds, every valid
             edge's source in its destination's CSR row, padding edges at
             the sentinel).
  train      last, its tensors freed; fp32 weights, TF32 off; no kernel of
             the B line (the training path has no Pallas site: every
             launch count 0 from just before the phase to its end).
             smollm-135m (``make_config()``, 30 layers, bf16 activations)
             on ``train_4k`` cut to 4 x 4,096 tokens from a bp128
             ``TokenStore`` of 4,194,304 Zipf(1.1) ids through
             ``lm_batch_iter``: ``train_loop.run`` with ``make_train_step``
             (AdamW, lr 3e-3, no warm-up), one warm-up step and 4 timed
             (host clock to a synchronize); tokens/s, median ms, peak
             memory; one more step under ``torch.profiler`` (busy share,
             the 8 kernels of most device time).  Checks: every loss and
             gradient norm finite; one full-size checkpoint (params, m,
             v) saved (timed), restored and bitwise equal; on the first 2
             layers at full width, the losses of an uninterrupted run of
             5 steps fall, the last below the first (``test_system``'s
             rule: at 30 layers the reference's init of the attention
             projections makes the gradient norm about 1e14 and the loss
             chaotic, ROADMAP.md §C), and a run crashed at step 3 of 5
             and resumed from its step-2 checkpoint equals it bitwise
             (params, AdamW state, losses); one
             step of 1 x 128 on the card within 2e-2 of the host CPU's
             (bf16 activations): the loss relative, and each
             gradient leaf of its max |g| with the attention projections
             rescaled to 1/sqrt of their fan-in (the reference's init
             draws them at 1/sqrt(heads): scores in the hundreds, and wq
             and wk's gradients come from the few near-tied scores, which
             round-off flips; at that init the gradient errors are
             printed).  Then
             ``compressed_allreduce_flat`` of smollm's flat gradient
             (134,515,008 floats, one real gradient per rank, each of a
             128-token sequence, 8 logical ranks), int8 and int4 timed, every rank's output equal, int8
             within 0.05 of max |exact mean|; wire bytes a rank.  The four
             recsys archs (``make_config()``) on ``train_batch`` (65,536
             rows of ``cell_batch``): one warm-up step and 3 timed, ms,
             rows/s, peak; on 4,096 rows against the host CPU: the loss
             within 1e-4 relative, then loss and gradients with fp64
             weights and activations (dlrm-rm2's and wide-deep's tables
             cut to the rows those 4,096 read, ids renumbered: the same
             function) within 1e-4 (each leaf of the larger
             of its max |g| and 1e-3 of the largest |g| of any leaf:
             dien's score bias before its softmax has a zero gradient).
             In fp32 a ReLU input within round-off of 0 takes the other
             side on one of the two, and a table row's gradient, one
             row's term, moves by a whole (1.7e-2 of dlrm-rm2's tables'
             max in one run).  Compressed data
             parallelism: din at full width, 8 logical ranks of 8,192
             rows (the example's batches), ``bits`` None, 8 and 4, 4 steps
             each: the three loss trajectories, ms a step, wire bytes a
             rank.  EGNN on its four regimes (the recsys_gnn phase's
             batches and subgraph): one warm-up step and 2 timed, ms,
             edges/s, peak (ogb_products below 40 GiB); full_graph_sm's
             loss and gradients against the host CPU (1e-4 relative,
             1e-3).
  mesh       last: meshes and sharding plans.  The process group starts:
             one rank a card, spawned, with 2 or more cards; else a world of
             1 over NCCL in this process.  smollm-135m at its published
             widths, on the train phase's weights (--seed) and first batch
             (4 x 4,096): one train step (``make_train_step`` with
             ``lm_grads_like_params``) unplanned, and one on a
             ``make_host_mesh((world, 1))`` mesh under ``lm_dense_plan``
             (``DTensor`` parameters, batch and optimizer state), its loss,
             every gradient and the parameters after the update bitwise the
             unplanned step's on a world of 1 (within 2e-2 of each leaf's
             max |g| with more ranks); the planned step again, timed.
             dlrm-rm2's 26 tables of 2**20 x 64 under ``recsys_plan``:
             ``lookup_stacked`` on ``serve_bulk``'s 262,144 rows (the EP
             path) bitwise the plain gather.  With 2 or more cards only:
             ``pipeline_2stage`` on a ("pod", "data") mesh bitwise the
             sequential layers on each microbatch (cuBLAS rounds a GEMM
             of other rows otherwise); the process-group compressed all-reduce
             bitwise its list form; ``restore(shardings=)`` onto half the
             ranks equal to the tensor saved.  No B kernel launches.

Prints one ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
...}``.  Any failed phase raises and the script exits nonzero without that
line.  Usage::

    python3 chip_smoke.py [--seed 0] [--n-docs 25205179]

``--n-docs`` below GOV2's count runs a doc-range shard and prints it on a
``reduced`` line.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import gc
import json
import multiprocessing
import os
import re
import subprocess
import sys
import time

GOV2_DOCS = 25_205_179          # documents in the TREC GOV2 collection
HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3, NVIDIA data sheet
TIMED_RUNS = 30
PLAIN_RUNS = 10                 # the slow plain versions and library calls
SPIN_CYCLES = 2_000_000         # about 1 ms of the card's clock
DECODE_RUNS = 5                 # whole-corpus decode passes timed per form
QUERIES = 256                   # queries per batch on the main paths
LEGACY_QUERIES = 16             # of the AND queries, through and_many
RANKED_K = 10                   # top-k of the ranked batches
QUERY_TERMS = 120               # queries draw from the most frequent terms
MUT_INSERTS = 4096              # fresh docs past the doc space (delta epoch)
MUT_UPSERTS = 1024              # base docs re-inserted (delta epoch)
MUT_QUERIES = 64                # queries a mutation-epoch batch (cut)
MUT_OR_QUERIES = 16             # the delta epoch's disarmed `or` batch (cut)
REPLAY_QUERIES = 128            # codecs, sharded: fresh queries replayed (cut)
TABLE_STEP = 10                 # decode table: every tenth list by df
TABLE_RUNS = 5                  # decode table: timed passes (after one)
SCALAR_QUADS = 1024             # decode table: the scalar decode's input
PFD_CODECS = ("group_pfd", "group_optpfd")      # their lists: kernel PFD
PFD_MEDIAN_N = 7_579            # kernels: the decode cell's median list
HOST_CALLS = 20_000             # kernels: calls a host-time loop (PFD)
ENCODE_WORKERS = 6              # processes encoding the decode table's lists
ORACLE_WORKERS = 4              # processes computing the ranked `or` oracles
SHARDS = 4                      # doc-range shards of the sharded phase
SERVE_AND = 128                 # serve phase: `and` requests of the stream
SERVE_OR = 32                   # serve phase: `or` (k=10) requests
SERVE_RATE = 20.0               # serve phase: Poisson arrivals per second
SERVE_DEADLINE_MS = 60_000.0    # serve phase: every request's budget
SHIM_QUERIES = 8                # examples phase: fresh queries per shim
LM_ARCHS = ("smollm-135m", "starcoder2-3b",     # lm phase: full-width models
            "deepseek-v2-lite-16b", "mixtral-8x22b")
LM_DEPTH = {"mixtral-8x22b": 8}  # lm phase: layers served (mixtral: 8 of 56)
LM_STORE_TOKENS = 16_777_216    # lm phase: token ids in the TokenStore
LM_STORE_BLOCK = 65_536         # lm phase: the store's block
LM_ZIPF = 1.1                   # lm phase: the token ids' Zipf exponent
LM_BATCH = 8                    # lm phase: prompts (prefill_32k's 32, cut)
LM_PREFILL = 2048               # lm phase: prompt tokens (32,768, cut)
LM_DECODE = 32                  # lm phase: greedy decode steps
LM_CHECK = (2, 256)             # lm phase: the fp32 decode-vs-forward batch
LM_CHECK_LAYERS = 2             # lm phase: ... over the first 2 layers
LM_DECODE_TOL = 1e-3            # of max |logit|: fp32 decode vs forward
LM_BF16_CHECK = (2, 64)         # lm phase: the bf16 card-vs-host batch
LM_BF16_LAYERS = 1              # lm phase: ... over the first layer
LM_BF16_TOL = 2e-2              # of max |logit|: bf16 card vs host
LM_ROUTE_CHECK = (2, 256)       # lm phase: MoE routing, card vs host CPU
LM_ROUTE_MARGIN = 1e-5          # ... compared where top-k margins exceed it
LM_ROUTE_WGT_TOL = 1e-6         # ... the routing weights' tolerance
LM_WINDOW_EXTRA = 64            # lm phase: SWA check prompt = window + 64
RECSYS_ARCHS = ("dlrm-rm2", "wide-deep", "din", "dien")   # recsys_gnn phase
RECSYS_CELLS = ("serve_p99", "serve_bulk", "retrieval_cand")
RECSYS_RUNS = 5                 # timed calls a recsys cell (after a warm-up)
RECSYS_CHECK = 4096             # retrieval candidates held against the CPU
RECSYS_TOL = 1e-4               # of max |logit|: card vs the CPU path
EGNN_CELLS = ("full_graph_sm", "molecule", "ogb_products", "minibatch_lg")
EGNN_RUNS = 3                   # timed EGNN forwards a cell (after a warm-up)
EGNN_TOL = 1e-4                 # h of max |h|, losses relative: card vs CPU
EGNN_INVARIANCE_TOL = 1e-3      # of max |h|: rotated, translated coordinates
TRAIN_LM = "smollm-135m"        # train phase: the LM, at published widths
TRAIN_LM_BATCH = 4              # ... sequences a step (train_4k's 256, cut)
TRAIN_LM_STEPS = 5              # ... one warm-up, then timed steps
TRAIN_LM_STORE = 1 << 22        # ... token ids in its TokenStore
TRAIN_CRASH_LAYERS = 2          # crash/resume check: the first 2 layers
TRAIN_CRASH_AT = 3              # ... a run crashed at step 3 of 5
TRAIN_LM_CHECK = (1, 128)       # card vs host CPU: one step of 1 x 128
TRAIN_LM_TOL = 2e-2             # ... loss relative, grads of max |g| (fp32)
TRAIN_RECSYS_STEPS = 4          # recsys train_batch: one warm-up, 3 timed
TRAIN_RECSYS_CHECK = 4096       # ... rows held against the host CPU
TRAIN_RECSYS_TOL = 1e-4         # ... loss relative, grads of max |g|
TRAIN_EGNN_STEPS = 3            # EGNN: one warm-up, 2 timed
TRAIN_EGNN_PEAK_GIB = 40.0      # ogb_products' limit
TRAIN_EGNN_TOL = (1e-4, 1e-3)   # full_graph_sm card vs CPU: loss, grads
TRAIN_GRAD_FLOOR = 1e-3         # a leaf's bound floor: of the largest |g|
TRAIN_DP_RANKS = 8              # compressed DP: logical ranks on the card
TRAIN_DP_STEPS = 4              # ... steps per bits (None, 8, 4)
TRAIN_DP_ALLREDUCE_TOL = 0.05   # int8 all-reduce: of max |exact mean|
MESH_LM_TOL = 2e-2              # mesh phase, 2+ ranks: loss rel, max |g|
MESH_PIPE = (4, 2048, 4, 512)   # ... pipeline: layers, width, micro, rows
MESH_AR_FLOATS = 1 << 24        # ... compressed all-reduce: floats a rank
MESH_INPUTS: dict = {}          # the train phase's first smollm batch
# examples phase: (name, command, a line its output must hold)
EXAMPLES = (
    ("quickstart", ["examples/quickstart_torch.py"],
     r"ranked top-k: .*exact parity"),
    ("serve_quickstart", ["examples/serve_quickstart_torch.py"],
     r"parity: batch \d+ .* bitwise identical"),
    ("launch.serve", ["-m", "repro_torch.launch.serve", "--arch",
                      "smollm-135m", "--tokens", "8"],
     r"(?m)^decoded 8 steps x batch 2 in [0-9.]+ ms$"),
    ("launch.train", ["-m", "repro_torch.launch.train", "--arch",
                      "smollm-135m", "--smoke", "--steps", "4"],
     r"(?m)^final loss \d+\.\d{4}$"),
    ("train_lm", ["examples/train_lm_torch.py", "--steps", "20"],
     r"OK: loss decreased on the compressed pipeline"),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def run_cmd(cmd: list) -> str:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return (out.stdout or out.stderr).strip()


# --------------------------------------------------------------------------- #
# timing and comparison helpers
# --------------------------------------------------------------------------- #


def cuda_ms(fn, torch, primed: bool = True, runs: int = TIMED_RUNS) -> float:
    """Median CUDA-event time of ``fn()`` over ``runs`` calls, after two
    warm-up calls.  ``primed``: each call is queued behind a spin of the
    card (``torch.cuda._sleep``, about 1 ms), so the events bracket its
    device work and not the host's time to enqueue it; otherwise the call
    starts from an idle queue and the host's enqueue counts."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if primed:
            torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def in_turns(fns: dict, torch) -> dict:
    """{name: [two medians]}: each of ``fns`` timed by :func:`cuda_ms`
    twice, in turn (forwards, then backwards), so that forms of one kernel
    compare inside one call."""
    got = {}
    for name in list(fns) + list(fns)[::-1]:
        got.setdefault(name, []).append(cuda_ms(fns[name], torch))
    return got


def device_ops(fn, torch) -> dict:
    """Kernels and memsets that one call of ``fn()`` puts on the card,
    counted from a ``torch.profiler`` trace of that call (after one
    warm-up call), and the traces taken.  Raises if 3 traces hold no
    kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    # a trace can come back without the card's activity (seen once, for
    # B10's 6 us call right after B8's trace): the call is traced again,
    # up to 3 times, and counted from the first trace that holds a kernel
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = {"grid_launches": 0, "memsets": 0}
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if e.key.startswith("Memset"):
                    ops["memsets"] += e.count
                elif not e.key.startswith("Memcpy"):
                    ops["grid_launches"] += e.count
        if ops["grid_launches"]:
            ops["traces"] = attempt + 1
            return ops
    raise AssertionError("3 torch.profiler traces hold no kernel")


def max_abs_err(got, want, torch) -> int:
    """Largest |got - want| over the outputs, as unsigned 32-bit words."""
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        d = ((g.long() & 0xFFFFFFFF) - (w.long() & 0xFFFFFFFF)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


def events_ms(fn, torch, runs: int, warm: bool = True) -> tuple:
    """(median, all runs) of CUDA-event times of ``fn()`` over ``runs``
    calls (after one warm-up call where ``warm``), each from an idle queue
    (host enqueue included)."""
    if warm:
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2], times


def host_us(fn, torch, calls: int = HOST_CALLS) -> float:
    """Host microseconds a call of ``fn()``: the median of three loops of
    ``calls`` calls, with no synchronise inside a loop (the card keeps up
    with a short list a call) and one around it."""
    got = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        got.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return sorted(got)[1]


_TABLE_LISTS: list = []         # an encode worker's d-gap lists


def _encode_init(src: str, lists: list) -> None:
    """Encode worker set-up: the port on the path, the lists kept."""
    sys.path.insert(0, src)
    _TABLE_LISTS[:] = lists


def _encode_task(name: str, i: int):
    """Encode worker task: list ``i`` through codec ``name`` (host numpy);
    returns the ``Encoded`` and the seconds it took."""
    from repro_torch.core import codec as codec_lib
    t0 = time.perf_counter()
    enc = codec_lib.get(name).encode(_TABLE_LISTS[i])
    return enc, time.perf_counter() - t0


_ORACLE_STATE: dict = {}


def _oracle_init(src: str, seed: int, n_docs: int) -> None:
    """`or` oracle worker set-up: the same corpus as the main process (made
    from the seed), the BM25 impacts of the query terms (the main
    process's formula, on the same arrays) and one accumulator pair."""
    sys.path.insert(0, src)
    import numpy as np
    from repro_torch.data import synth
    from repro_torch.index.scores import bm25_scores
    doclen, postings = synth.make_corpus("gov2", seed=seed, n_docs=n_docs)
    avdl = float(np.asarray(doclen).mean())
    top = sorted(postings)[:QUERY_TERMS]
    _ORACLE_STATE["doclen"] = np.asarray(doclen, np.int64)
    _ORACLE_STATE["postings"] = {t: postings[t] for t in top}
    _ORACLE_STATE["epoch"] = None
    _ORACLE_STATE["sc"] = {
        t: (postings[t][0], bm25_scores(postings[t][1],
                                        doclen[postings[t][0]],
                                        len(postings[t][0]), len(doclen),
                                        avdl))
        for t in sorted(postings)[:QUERY_TERMS]}
    _ORACLE_STATE["buf"] = (np.zeros(len(doclen)),
                            np.zeros(len(doclen), bool))


def _pfd_build_task(src: str, seed: int, n_docs: int):
    """Group-PFD build worker: the same corpus as the main process (made
    from the seed), built with ``codec="group_pfd"``, and its generation's
    score arena built on the host (``ScoreArena.from_index(device="cpu")``,
    host work alone: its two tensors go to the card in the codecs phase);
    returns the index, the build's seconds, the score arena and its
    seconds (the codecs phase serves them)."""
    sys.path.insert(0, src)
    from repro_torch.data import synth
    from repro_torch.index.invindex import InvertedIndex
    from repro_torch.index.scores import ScoreArena
    doclen, postings = synth.make_corpus("gov2", seed=seed, n_docs=n_docs)
    t0 = time.perf_counter()
    idx = InvertedIndex.build(doclen, postings, codec="group_pfd")
    build_s = time.perf_counter() - t0
    del doclen, postings
    t0 = time.perf_counter()
    scores = ScoreArena.from_index(idx.gen, device="cpu")
    return idx, build_s, scores, time.perf_counter() - t0


def _shard_build_task(src: str, seed: int, n_docs: int, n_shards: int):
    """Shard build worker: the main path's corpus (made from the seed) and
    index, ``ShardSpec.derive`` and ``shard_generation`` of every
    non-empty range, then each shard's score arena on the host
    (``ScoreArena.from_index(device="cpu")``; host numpy); returns the
    bounds, {(lo, hi): shard generation}, the shard build's seconds, the
    score arenas and their seconds (the sharded phase serves them in
    place of its own build)."""
    sys.path.insert(0, src)
    from repro_torch.data import synth
    from repro_torch.index import shards
    from repro_torch.index.invindex import InvertedIndex
    from repro_torch.index.scores import ScoreArena
    doclen, postings = synth.make_corpus("gov2", seed=seed, n_docs=n_docs)
    gen = InvertedIndex.build(doclen, postings).gen
    del doclen, postings
    spec = shards.ShardSpec.derive(gen, n_shards)
    t0 = time.perf_counter()
    built = {(lo, hi): shards.shard_generation(gen, lo, hi)
             for lo, hi in spec.ranges() if hi > lo}
    shard_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    scores = [ScoreArena.from_index(sg, device="cpu") for sg in built.values()]
    return spec.bounds, built, shard_s, scores, time.perf_counter() - t0


def _graph_task(src: str, seed: int, n_nodes: int, n_edges: int,
                n_seeds: int, fanout: tuple) -> dict:
    """EGNN ``minibatch_lg`` worker: ``CSRGraph.random`` at the cell's graph
    size, ``n_seeds`` seeds and ``sample_subgraph`` (host numpy, about as
    long as the index build); returns the subgraph, the seeds and the CSR
    rows of every destination node, not the graph."""
    sys.path.insert(0, src)
    import numpy as np
    from repro_torch.models.sampler import CSRGraph, sample_subgraph
    t0 = time.perf_counter()
    g = CSRGraph.random(n_nodes, n_edges, seed)
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed + 29)
    seeds = rng.choice(n_nodes, n_seeds, replace=False)
    t0 = time.perf_counter()
    sub = sample_subgraph(g, seeds, fanout, rng)
    sample_s = time.perf_counter() - t0
    rows = np.unique(sub["nodes"][sub["dst"][sub["edge_valid"]]])
    return {"sub": sub, "seeds": seeds, "rows": rows,
            "row_lens": g.indptr[rows + 1] - g.indptr[rows],
            "row_idx": np.concatenate([g.indices[g.indptr[r]:g.indptr[r + 1]]
                                       for r in rows]),
            "build_s": build_s, "sample_s": sample_s}


def _oracle_or_task(queries: list) -> list:
    """`or` oracle worker task: :func:`oracle_or` of each query."""
    import numpy as np
    from repro_torch.index.scores import topk_select
    return [oracle_or(_ORACLE_STATE["sc"], q, RANKED_K, _ORACLE_STATE["buf"],
                      np, topk_select) for q in queries]


def _live_or_task(epoch: tuple, queries: list) -> list:
    """`or` oracle worker task under a mutation epoch: ``epoch`` is (key,
    the dead base docs as packed bits, the delta docs {term: {doc: tf}},
    the appended doclen column, {doc: doclen} of the upserts); the live
    impacts are :func:`live_impacts`' on the worker's own corpus, made
    once an epoch."""
    import numpy as np
    from repro_torch.index.scores import bm25_scores, topk_select
    st = _ORACLE_STATE
    key, dead_bits, delta, appended, upserted = epoch
    if st["epoch"] != key:
        base = st["doclen"]
        dead = np.unpackbits(dead_bits, count=len(base)).astype(bool)
        dl = np.concatenate([base, appended])
        dl[list(upserted)] = list(upserted.values())
        _, sc = live_impacts(st["postings"], list(st["postings"]), dead,
                             delta, dl, np, bm25_scores)
        st["epoch"], st["live_sc"] = key, sc
        st["live_buf"] = (np.zeros(len(dl)), np.zeros(len(dl), bool))
    sc = st["live_sc"]
    return [oracle_or(sc, [t for t in q if t in sc], RANKED_K,
                      st["live_buf"], np, topk_select) for q in queries]


def live_impacts(postings: dict, terms: list, dead, delta: dict, dl, np,
                 bm25_scores) -> tuple:
    """The terms' live postings and BM25 impacts under a mutation epoch:
    base postings without the ``dead`` docs, the ``delta`` docs merged in
    by docid, scored with the live df, the doc space ``len(dl)`` and the
    mean of the live doclen column ``dl``."""
    space, avdl = len(dl), float(dl.mean())
    live, sc = {}, {}
    for t in terms:
        ids, tfs = postings[t]
        keep = ~dead[ids]
        ids, tfs = ids[keep], tfs[keep]
        d = delta.get(t)
        if d:
            ids = np.concatenate([ids, np.fromiter(d, np.uint32, len(d))])
            tfs = np.concatenate([tfs, np.fromiter(d.values(), np.uint32,
                                                   len(d))])
            order = np.argsort(ids, kind="stable")
            ids, tfs = ids[order], tfs[order]
        if len(ids):
            live[t] = (ids, tfs)
            sc[t] = (ids, bm25_scores(tfs, dl[ids], len(ids), space, avdl))
    return live, sc


def bit_share(words) -> float:
    """The share of set bits in an int32 word tensor."""
    n = sum(int(((words >> b) & 1).sum()) for b in range(32))
    return n / max(words.numel() * 32, 1)


def bound_ms(nbytes: float) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


@contextlib.contextmanager
def keep_largest(module, name: str, store: dict, pick):
    """While open, every call of ``module.<name>`` first offers its
    arguments to ``pick(*args, **kwargs)``, which returns (size, {key:
    value}); the values of the largest call so far replace ``store``'s,
    tensors as host copies (so the card's peak memory does not see them).
    The ranked phase's real kernel inputs are taken this way."""
    orig = getattr(module, name)

    def hook(*args, **kwargs):
        size, values = pick(*args, **kwargs)
        if size > store.get("size", -1):
            store.clear()
            store["size"] = size
            store.update({k: v.cpu() if hasattr(v, "cpu") else v
                          for k, v in values.items()})
        return orig(*args, **kwargs)

    setattr(module, name, hook)
    try:
        yield store
    finally:
        setattr(module, name, orig)


# --------------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------------- #


def oracle_and(postings: dict, q: list, np):
    """Independent AND: the rarest term's docids, kept where searchsorted
    finds them in every other term's sorted docids."""
    ts = sorted((t for t in q if t in postings), key=lambda t: len(postings[t][0]))
    if not ts:
        return np.zeros(0, np.uint32)
    ids = postings[ts[0]][0]
    for t in ts[1:]:
        other = postings[t][0]
        pos = np.searchsorted(other, ids)
        ok = pos < len(other)
        ids = ids[ok][other[pos[ok]] == ids[ok]]
    return ids


def oracle_or(term_sc: dict, q: list, k: int, buf, np, topk_select) -> list:
    """Independent OR top-k: a dense float64 accumulator over all docs (the
    reusable ``buf`` pair, left zeroed), each term's BM25 impacts added in
    query-term order, then ``topk_select``'s argpartition + docid rule."""
    acc, hit = buf
    for t in q:
        ids, sc = term_sc[t]
        acc[ids] += sc
        hit[ids] = True
    docs = np.flatnonzero(hit)
    res = topk_select(docs, acc[docs], k)
    acc[docs] = 0.0
    hit[docs] = False
    return res


def oracle_and_scored(postings: dict, term_sc: dict, q: list, k: int, np,
                      topk_select) -> list:
    """Independent and_scored top-k: the AND oracle's docids, scored in
    query-term order."""
    docs = oracle_and(postings, q, np)
    scores = np.zeros(len(docs))
    for t in q:
        ids, sc = term_sc[t]
        scores += sc[np.searchsorted(ids, docs)]
    return topk_select(docs, scores, k)


def span_breakdown(tracer, children: tuple) -> dict:
    """{span name: (count, ms)} of the tracer's spans, plus "rest of
    execute": ``engine/execute`` minus the named ``children`` (disjoint
    intervals inside it)."""
    out = {}
    for sp in tracer.spans():
        n, tot = out.get(sp.name, (0, 0.0))
        out[sp.name] = (n + 1, tot + sp.dur * 1e3)
    rest = out.get("engine/execute", (0, 0.0))[1] - sum(
        out.get(c, (0, 0.0))[1] for c in children)
    out["rest of execute"] = (1, rest)
    return out


def pow2_bucket(k: int) -> int:
    """The launch width the power-of-two work-list buckets (smallest 8) of
    the JAX package give ``k`` entries; the port launches ``k``."""
    w = 8
    while w < k:
        w *= 2
    return w


def bucketed_widths(recent: list) -> dict:
    """Launch widths of B1 and B2 as recorded, and as the power-of-two
    buckets would have made them: each B1 call padded on its own, a B2 call
    that scatters the B1 calls just before it padded as their sum, any
    other B2 call padded on its own."""
    exact = {"B1": 0, "B2": 0}
    padded = {"B1": 0, "B2": 0}
    pending = []
    for kernel, shape in recent:
        if kernel == "B1":
            pending.append(shape["W"])
            exact["B1"] += shape["W"]
            padded["B1"] += pow2_bucket(shape["W"])
        elif kernel == "B2":
            exact["B2"] += shape["P"]
            padded["B2"] += (sum(map(pow2_bucket, pending))
                             if pending and sum(pending) == shape["P"]
                             else pow2_bucket(shape["P"]))
            pending = []
    return {"exact": exact, "pow2": padded}


def timed_calls(fn, total: list):
    """``fn`` wrapped to add the seconds each call takes to ``total[0]``."""
    def wrap(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            total[0] += time.perf_counter() - t0
    return wrap


def mutation_phase(idx, doclen, postings, terms, seed, oracle_pool, np,
                   torch) -> dict:
    """The mutation phase (module docstring) on ``idx``, which the ranked
    phase left unmutated with its arenas built: a tombstone-only epoch, a
    delta-bearing one, then ``compact()`` under a pinned plan.  Every batch
    equals a numpy oracle over the live postings (BM25 with live df, the
    doc space and the mean of the live doclen column; the `or` oracles by
    ``oracle_pool``'s workers); raises on any failed check.  Returns the
    figures and the tombstone ``or`` batch's captured B1, B2-add (masked)
    and B4 (gated) calls."""
    from repro_torch import kernels as K
    from repro_torch.index.engine import QueryBatch, QueryEngine
    from repro_torch.index.scores import bm25_scores, topk_select
    from repro_torch.index.segments import dead_hits
    from repro_torch.kernels import accumulate, intersect_rounds, topk
    from repro_torch.obs.trace import enable_tracing

    rng = np.random.default_rng(seed + 7)
    base_n = idx.n_docs
    top = terms[:QUERY_TERMS]
    out = {"steps_s": {}, "batches": {}, "spans_ms": {}}
    mark = [time.perf_counter()]

    def step(name):
        now = time.perf_counter()
        out["steps_s"][name] = now - mark[0]
        mark[0] = now
        log(f"   step {name}: {out['steps_s'][name]:.2f} s")

    # the oracle's own record of the live corpus
    dead = np.zeros(base_n, bool)        # base docs without a live base copy
    delta: dict = {}                     # term -> {docid: tf} of delta docs
    dl = np.asarray(doclen, np.int64).copy()

    upserted: dict = {}                  # base doc -> its upserted doclen
    epochs = [0]

    def live_view():
        """The query terms' live postings and BM25 impacts under the live
        statistics, and the epoch as the `or` oracle workers take it."""
        live, sc = live_impacts(postings, top, dead, delta, dl, np,
                                bm25_scores)
        epochs[0] += 1
        epoch = (epochs[0], np.packbits(dead[:base_n]), delta,
                 dl[base_n:].copy(), dict(upserted))
        return live, sc, epoch

    def draw(n, mode, view):
        live, sc, epoch = view
        qs = [rng.choice(top, size=rng.integers(2, 4), replace=False).tolist()
              for _ in range(n)]
        if mode == "and":
            want = [oracle_and(live, q, np) for q in qs]
        elif mode == "or":
            jobs = [oracle_pool.submit(_live_or_task, epoch, qs[i:i + 8])
                    for i in range(0, n, 8)]
            want = [r for f in jobs for r in f.result()]
        else:
            want = [oracle_and_scored(live, sc, [t for t in q if t in sc],
                                      RANKED_K, np, topk_select) for q in qs]
        return qs, want

    def same(mode, a, b):
        return np.array_equal(a, b) if mode == "and" else a == b

    cands = [0]

    def batch(eng, what, mode, queries, want, gated):
        """One fresh batch, counts set to 0 just before: results against
        the oracle, the sync counters, the gates and the kernels."""
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        cands[0] = 0
        with eng.metrics.scoped() as s:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = eng.execute(eng.plan(QueryBatch(queries, mode=mode,
                                                  k=RANKED_K)))
            dt = time.perf_counter() - t0
        launches = dict(K.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        for q, a, b in zip(queries, res, want):
            if not same(mode, a, b):
                raise AssertionError(f"{what}, query {q}: {len(a)} results, "
                                     f"oracle {len(b)}: {a[:3]} vs {b[:3]}")
        st = {n: s.delta(n) for n in (
            "cand_syncs", "final_syncs", "score_syncs", "tomb_gates",
            "resident_rounds", "score_rounds", "blocks_scored",
            "blocks_pruned", "blocks_dense", "worklist_decodes")}
        if st["cand_syncs"] or st["score_syncs"] or st["final_syncs"] != 1:
            raise AssertionError(f"{what} syncs: {st}")
        if (st["tomb_gates"] >= 1) != gated:
            raise AssertionError(f"{what}: tomb_gates {st['tomb_gates']}, "
                                 f"gated epoch {gated}")
        need = ("B1", "B2") + (("B2add", "B3") if mode != "and" else ())
        if min(launches[k] for k in need) <= 0 or (
                st["blocks_dense"] and mode != "and" and launches["B4"] <= 0):
            raise AssertionError(f"{what} missed a kernel: {launches}")
        r = {"queries": len(queries), "qps": len(queries) / dt,
             "seconds": dt, "stats": st, "launches": launches,
             "peak_bytes": peak}
        if mode != "and":
            r["candidates"] = cands[0]
        out["batches"][what] = r
        log(f"{what}: {len(queries)} queries in {dt:.4f} s = "
            f"{len(queries) / dt:.2f} qps; {st}; launches {launches}; "
            + (f"candidates downloaded {cands[0]}; " if mode != "and" else "")
            + f"max_memory_allocated {peak / 2**30:.2f} GiB")
        return res

    def traced(eng, what, mode, queries, want, children):
        """The batch again under the fenced span tracer (not timed)."""
        tracer = enable_tracing(True, fenced=True)
        tracer.clear()
        res = eng.execute(eng.plan(QueryBatch(queries, mode=mode,
                                              k=RANKED_K)))
        enable_tracing(False)
        for q, a, b in zip(queries, res, want):
            if not same(mode, a, b):
                raise AssertionError(f"{what} (traced), query {q}")
        spans = span_breakdown(tracer, children)
        tracer.clear()
        out["spans_ms"][what] = {n: v[1] for n, v in spans.items()}
        log(f"{what}: fenced spans of the batch run again:")
        for name, (n, tot) in sorted(spans.items(), key=lambda kv: -kv[1][1]):
            log(f"  {name:24s} x{n:<3d} {tot:10.2f} ms")

    def engine():
        eng = QueryEngine(idx, cache_blocks=1 << 22).to_device(fused=True)
        orig = eng._ranked_rescore

        def rescore(queries, cand, *rest):
            cands[0] += sum(len(c) for c in cand)
            return orig(queries, cand, *rest)
        eng._ranked_rescore = rescore
        return eng

    # ---- tombstone-only epoch: 1 % of the base docs deleted --------------- #
    log("== mutation epochs: tombstones, a delta segment, compact() "
        "(fused placement)")
    perm = rng.permutation(base_n)
    n_dead = base_n // 100
    for d in perm[:n_dead].tolist():
        idx.delete(d)
    dead[perm[:n_dead]] = True
    step(f"delete {n_dead} docs")
    eng = engine()
    view = live_view()
    tq = {m: draw(MUT_QUERIES, m, view) for m in ("and", "or", "and_scored")}
    step("tombstone oracle (3 batches)")
    df_s = [0.0]
    eng._df_live = timed_calls(eng._df_live, df_s)
    batch(eng, "tombstone and", "and", *tq["and"], gated=True)
    del eng._df_live
    out["df_live_first_pass_s"] = df_s[0]
    log(f"   of which the first _df_live pass (whole term lists decoded "
        f"on the host): {df_s[0]:.2f} s")
    step("tombstone and")
    batch(eng, "tombstone or", "or", *tq["or"], gated=True)
    step("tombstone or")
    batch(eng, "tombstone and_scored", "and_scored", *tq["and_scored"],
          gated=True)
    step("tombstone and_scored")
    # the dead-docid test of theta0_live and compact(): np.isin, as the
    # reference makes it, beside the port's binary search (dead_hits), on
    # the top-code tables of the or batch's first 8 queries
    sa = eng.arena.ensure_scores().scores
    dead_ids = np.flatnonzero(dead).astype(np.int64)
    tables = [sa.term_top_ids[t] for q in tq["or"][0][:8] for t in q]
    member = {}
    for name, fn in (("np.isin", lambda ids: np.isin(ids.astype(np.int64),
                                                     dead_ids)),
                     ("dead_hits", lambda ids: dead_hits(dead_ids, ids))):
        t0 = time.perf_counter()
        member[name] = [fn(ids) for ids in tables]
        out.setdefault("dead_test_ms", {})[name] = (
            (time.perf_counter() - t0) / len(tables) * 1e3)
    if not all(np.array_equal(a, b) for a, b in zip(*member.values())):
        raise AssertionError("dead_hits disagrees with np.isin")
    log(f"dead-docid test of {len(tables)} top-code tables against "
        f"{len(dead_ids)} dead docids, ms a call: {out['dead_test_ms']}")
    del sa, member
    # the and and or batches again, traced; the or batch keeps its largest
    # B1, B2-add (masked) and gated B4 calls for the kernel phase
    traced(eng, "tombstone and", "and", *tq["and"],
           ("and/seed", "and/tomb_gate", "and/round", "kernel/extract_ids"))
    caps = {"B1": {}, "B2add": {}, "B4": {}}
    with keep_largest(intersect_rounds, "segmented_decode_and", caps["B1"],
                      lambda tiles, slots, qslots, firsts, ns, cand, *, bw,
                      crows: (slots.shape[0], {
                          "tiles": tiles, "slots": slots, "qslots": qslots,
                          "firsts": firsts, "ns": ns, "cand": cand,
                          "bw": bw, "crows": crows})), \
            keep_largest(topk, "_scatter", caps["B2add"],
                         lambda acc, member, ids, qslot, codes, surv: (
                             ids.shape[0], {"ids": ids, "qslot": qslot,
                                            "codes": codes, "surv": surv,
                                            "Q": acc.shape[0],
                                            "width": acc.shape[1]})), \
            keep_largest(accumulate, "dense_add_packed", caps["B4"],
                         lambda acc, tiles, win, qslot, col0, act, *, gated: (
                             tiles.shape[0] if gated else -1, {
                                 "tiles": tiles, "win": win, "qslot": qslot,
                                 "col0": col0, "act": act, "gated": gated,
                                 "Q": acc.shape[0], "width": acc.shape[1]})):
        traced(eng, "tombstone or", "or", *tq["or"],
               ("ranked/tomb_gate", "ranked/round", "kernel/topk",
                "kernel/extract_ids", "ranked/rescore"))
    for k, cap in caps.items():
        if not cap:
            raise AssertionError(f"tombstone or: no {k} call captured")
    out["captured"] = caps
    step("tombstone traced batches")

    # ---- delta-bearing epoch: fresh docs and upserts ---------------------- #
    mean_dl = int(np.asarray(doclen).mean())
    upserts = perm[n_dead:n_dead + MUT_UPSERTS].tolist()
    fresh = list(range(base_n, base_n + MUT_INSERTS))
    for d in fresh + upserts:
        picked = rng.choice(top, size=8, replace=False)
        doc = {int(t): int(rng.integers(1, 5)) for t in picked}
        idx.insert(d, doc, mean_dl)
        for t, tf in doc.items():
            delta.setdefault(t, {})[d] = tf
    dead[upserts] = True
    dl = np.concatenate([dl, np.full(MUT_INSERTS, mean_dl, np.int64)])
    dl[upserts] = mean_dl
    upserted.update((d, mean_dl) for d in upserts)
    step(f"insert {MUT_INSERTS} docs and upsert {MUT_UPSERTS}")
    view = live_view()
    dq = {"and": draw(MUT_QUERIES, "and", view),
          "and_scored": draw(MUT_QUERIES, "and_scored", view),
          "or": draw(MUT_OR_QUERIES, "or", view)}
    step("delta oracle (3 batches)")
    for mode in ("and", "and_scored", "or"):
        batch(eng, f"delta {mode}", mode, *dq[mode], gated=True)
        step(f"delta {mode}")

    # ---- compaction under a pinned plan ------------------------------------ #
    pin_q, pin_want = dq["and"][0][:16], dq["and"][1][:16]
    pinned = eng.plan(QueryBatch(pin_q, mode="and"))
    old_gid = idx.gen.gid
    t0 = time.perf_counter()
    idx.compact()
    out["compaction_pause_s"] = time.perf_counter() - t0
    log(f"compact(): generation {old_gid} -> {idx.gen.gid}, "
        f"{idx.n_docs} docs, pause {out['compaction_pause_s']:.2f} s")
    got = eng.execute(pinned)
    if pinned.ctx.gen is idx.gen or not all(
            np.array_equal(a, b) for a, b in zip(got, pin_want)):
        raise AssertionError("the pinned plan did not serve its epoch "
                             "across compact()")
    log(f"pinned 16-query and plan served across compact(): equal to its "
        f"epoch's oracle")
    del pinned, got, eng
    gc.collect()                    # the old generation's arenas go here
    torch.cuda.empty_cache()
    step("compact and pinned plan")
    t0 = time.perf_counter()
    eng = engine()
    torch.cuda.synchronize()
    out["to_device_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng.arena.ensure_scores()
    torch.cuda.synchronize()
    out["ensure_scores_s"] = time.perf_counter() - t0
    log(f"new generation: to_device(fused=True) {out['to_device_s']:.2f} s, "
        f"ensure_scores {out['ensure_scores_s']:.2f} s")
    step("new generation on the card")
    cq = {m: draw(MUT_QUERIES, m, view) for m in ("and", "or")}
    step("compacted oracle (2 batches)")
    for mode in ("and", "or"):
        batch(eng, f"compacted {mode}", mode, *cq[mode], gated=False)
        step(f"compacted {mode}")
    del eng, view
    gc.collect()
    torch.cuda.empty_cache()
    return out


def codecs_phase(pfd_job, postings, fresh, src, smi, np, torch) -> tuple:
    """The codecs phase (module docstring): the Group-PFD index (built by
    ``pfd_job``, a worker process's future) served on the ``device``
    placement (and ``fused`` ``and``) against the main path's oracles,
    then the decode table of every codec that declares ``Codec.torch``.
    Raises on any failed check; returns the figures and, for the kernel
    phase, the table's longest and shortest lists as Group-PFD encodings
    with their d-gaps."""
    from repro_torch import kernels as K
    from repro_torch.core import codec as codec_lib
    from repro_torch.core.bits import ebw_np, from_np, to_np
    from repro_torch.core.dgap import dgap_encode_np
    from repro_torch.index.device import DeviceArena
    from repro_torch.index.engine import QueryBatch, QueryEngine
    from repro_torch.kernels import ops
    from repro_torch.obs.trace import enable_tracing

    dev = torch.device("cuda", 0)
    out = {"serving": {}, "table": {}}
    order = sorted(postings, key=lambda t: (-len(postings[t][0]), t))
    table_terms = order[::TABLE_STEP]
    gaps = [dgap_encode_np(postings[t][0]) for t in table_terms]
    n_table = sum(len(g) for g in gaps)
    names = [n for n in codec_lib.names() if codec_lib.get(n).torch]
    # the decode table's host encodes run in worker processes while the
    # arenas build (longest lists first); the table waits for them
    pool = concurrent.futures.ProcessPoolExecutor(
        ENCODE_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=_encode_init, initargs=(src, gaps))
    try:
        jobs = {(name, int(i)): pool.submit(_encode_task, name, int(i))
                for i in np.argsort([-len(g) for g in gaps], kind="stable")
                for name in names}

        log("== codecs: the Group-PFD index on the device placement")
        t0 = time.perf_counter()
        idx, out["build_s"], scores, out["worker_scores_s"] = pfd_job.result()
        out["build_wait_s"] = time.perf_counter() - t0
        encs = [e for tp in idx.terms.values() for _, e, _ in tp.blocks]
        pfd = [e for e in encs if e.codec == "group_pfd"]
        n_exc = sum(1 for e in pfd if len(e.exceptions))
        out["blocks"] = {"all": len(encs), "group_pfd": len(pfd),
                         "with_exceptions": n_exc,
                         "exception_bits": sum(e.exception_bits for e in pfd),
                         "codecs": sorted({e.codec for e in encs})}
        log(f"InvertedIndex.build(codec='group_pfd'): {len(encs)} docid "
            f"blocks ({len(pfd)} group_pfd, {n_exc} of them with "
            f"exceptions, the rest {out['blocks']['codecs']}) in "
            f"{out['build_s']:.2f} s in a worker process beside the earlier "
            f"phases; waited {out['build_wait_s']:.2f} s for it")
        if n_exc <= 0:
            raise AssertionError("the Group-PFD index holds no exceptions")
        del encs, pfd
        t0 = time.perf_counter()
        eng = QueryEngine(idx, cache_blocks=1 << 22).to_device(fused=True)
        torch.cuda.synchronize()
        out["to_device_s"] = time.perf_counter() - t0
        ar = eng.arena
        t0 = time.perf_counter()
        with prebuilt_scores(DeviceArena, [scores]) as adopted:
            ar.ensure_scores()
        torch.cuda.synchronize()
        out["ensure_scores_s"] = time.perf_counter() - t0
        if adopted != [scores] or ar.scores is not scores:
            raise AssertionError("ensure_scores did not adopt the worker's "
                                 "score arena of the served generation")
        del scores, adopted
        log(f"to_device(fused=True): {out['to_device_s']:.2f} s; "
            f"ensure_scores: {out['worker_scores_s']:.2f} s on the host in "
            f"the worker, {out['ensure_scores_s']:.2f} s to the card here")
        torch.cuda.reset_peak_memory_stats()

        def same(mode, got, want):
            for j, (a, b) in enumerate(zip(got, want)):
                if not (np.array_equal(a, b) if mode == "and" else a == b):
                    raise AssertionError(f"group_pfd {mode}, query {j}: "
                                         f"differs from the numpy oracle")

        for mode, placement in (("and", "device"), ("or", "device"),
                                ("and_scored", "device"), ("and", "fused")):
            what = f"{mode}/{placement}"
            (queries, want), (traced_q, traced_want) = fresh[mode]
            batch = QueryBatch(queries, mode=mode, k=RANKED_K)
            K.reset_launches()
            torch.cuda.synchronize()
            with eng.metrics.scoped() as s:
                t0 = time.perf_counter()
                res = eng.execute(eng.plan(batch, placement=placement))
                dt = time.perf_counter() - t0
            launches = {k: v for k, v in K.LAUNCHES.items() if v}
            same(mode, res, want)
            stats = {n: s.delta(n) for n in (
                "cand_syncs", "final_syncs", "score_syncs", "resident_rounds",
                "score_rounds", "worklist_decodes", "fallback_decodes",
                "blocks_dense", "blocks_scored")}
            log(f"{what}: {len(queries)} queries in {dt:.4f} s = "
                f"{len(queries) / dt:.2f} qps (fresh batch of the main path, "
                f"equal to its oracle); counters {stats}; launches "
                f"{launches}")
            if stats["cand_syncs"] != 0 or stats["final_syncs"] != 1:
                raise AssertionError(f"{what} syncs: {stats}")
            if mode != "and" and stats["score_syncs"] != 0:
                raise AssertionError(f"{what} score syncs: {stats}")
            if launches.get("B2", 0) + launches.get("B2add", 0) <= 0 or (
                    mode != "or" and launches.get("B2", 0) <= 0):
                raise AssertionError(f"{what} did not launch B2: {launches}")
            tracer = enable_tracing(True, fenced=True)
            tracer.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            traced = eng.execute(eng.plan(QueryBatch(traced_q, mode=mode,
                                                     k=RANKED_K),
                                          placement=placement))
            dt_traced = time.perf_counter() - t0
            enable_tracing(False)
            same(mode, traced, traced_want)
            spans = span_breakdown(tracer, (
                "and/seed", "and/round", "ranked/round", "kernel/topk",
                "kernel/extract_ids", "ranked/rescore"))
            tracer.clear()
            log(f"{what} fenced span breakdown of the main path's traced "
                f"batch ({dt_traced:.4f} s):")
            for name, (n, tot) in sorted(spans.items(),
                                         key=lambda kv: -kv[1][1]):
                log(f"  {name:24s} x{n:<3d} {tot:10.2f} ms")
            out["serving"][what] = {
                "qps": len(queries) / dt, "seconds": dt, "stats": stats,
                "launches": launches,
                "spans_ms": {n: v[1] for n, v in spans.items()}}
            del res, traced
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        out["arena_stats"] = dict(ar.stats)
        log(f"arena stats {ar.stats}; max_memory_allocated "
            f"{out['peak_bytes']} bytes ({out['peak_bytes'] / 2**30:.2f} "
            f"GiB) over the four batches and their traced repeats")
        if ar.stats["blocks_host"] != 0 or ar.stats["blocks_device"] <= 0:
            raise AssertionError(f"blocks decoded on the host: {ar.stats}")
        del eng, ar, idx
        gc.collect()
        torch.cuda.empty_cache()

        log("== codecs: decode table (Codec.torch on the card)")
        log(f"lists (every {TABLE_STEP}th by descending df): terms "
            f"{table_terms}, {n_table} postings; longest {len(gaps[0])}")
        t0 = time.perf_counter()
        encoded = {key: job.result() for key, job in jobs.items()}
        log(f"waited {time.perf_counter() - t0:.2f} s for the encode "
            f"workers")
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    head = gaps[0][:4 * SCALAR_QUADS]
    for name in names:
        spec = codec_lib.get(name)
        encs = [encoded[(name, i)][0] for i in range(len(gaps))]
        enc_s = sum(encoded[(name, i)][1] for i in range(len(gaps)))
        kws = [spec.torch.args(e, device=dev) for e in encs]
        K.reset_launches()
        for i, (g, kw) in enumerate(zip(gaps, kws)):
            if not np.array_equal(to_np(spec.torch.vec(**kw)), g):
                raise AssertionError(f"{name}: decode_torch_vec of list "
                                     f"{table_terms[i]} differs")
        launches = {k: v for k, v in K.LAUNCHES.items() if v}
        # a Group-PFD list is one launch of kernel PFD; the other codecs'
        # torch decoders are plain torch
        want_launches = ({"PFD": len(gaps)} if name in PFD_CODECS else {})
        if launches != want_launches:
            raise AssertionError(f"{name}: the table's decode launched "
                                 f"{launches}, not {want_launches}")

        def vec_all(kws=kws, spec=spec):
            for kw in kws:
                spec.torch.vec(**kw)

        ms, runs = events_ms(vec_all, torch, TABLE_RUNS)
        kw_s = spec.torch.args(spec.encode(head), device=dev)
        got_s = []
        s_ms, _ = events_ms(lambda: got_s.append(spec.torch.scalar(**kw_s)),
                            torch, 1, warm=False)
        if not np.array_equal(to_np(got_s[0]), head):
            raise AssertionError(f"{name}: decode_torch_scalar differs")
        v_ms, _ = events_ms(lambda: spec.torch.vec(**kw_s), torch,
                            TABLE_RUNS)
        bits = sum(e.total_bits for e in encs)
        row = {"ms": ms, "runs_ms": runs, "postings_per_s": n_table / ms * 1e3,
               "bits_per_posting": bits / n_table, "encode_s": enc_s,
               "scalar_ms": s_ms, "scalar_postings_per_s": len(head) / s_ms * 1e3,
               "vec_head_ms": v_ms,
               "vec_head_postings_per_s": len(head) / v_ms * 1e3,
               "launches": launches}
        out["table"][name] = row
        log(f"{name:18s} vec {ms:9.4f} ms = {row['postings_per_s']:.4e} "
            f"postings/s, {row['bits_per_posting']:.4f} bits/posting; "
            f"first {SCALAR_QUADS} quads: scalar {s_ms:.4f} ms "
            f"({row['scalar_postings_per_s']:.4e}/s), vec {v_ms:.4f} ms "
            f"({row['vec_head_postings_per_s']:.4e}/s); host encode "
            f"{enc_s:.2f} s; the table's launches {launches}")
        del kws, kw_s, encs
    packed = []
    for t, g in zip(table_terms, gaps):
        bw = max(1, int(ebw_np(g.max())))
        pk = ops.pack_stream(from_np(g, dev), bw)
        if not np.array_equal(to_np(ops.unpack_delta_stream(pk, bw, len(g))),
                              postings[t][0]):
            raise AssertionError(f"stream codec: list {t} differs")
        packed.append((pk, bw, len(g)))

    def stream_all():
        for pk, bw, n in packed:
            ops.unpack_delta_stream(pk, bw, n)

    ms, runs = events_ms(stream_all, torch, TABLE_RUNS)
    words = sum(pk.numel() for pk, _, _ in packed)
    out["table"]["stream (fused, B6)"] = {
        "ms": ms, "runs_ms": runs, "postings_per_s": n_table / ms * 1e3,
        "bits_per_posting": words * 32 / n_table}
    log(f"{'stream (fused, B6)':18s} vec {ms:9.4f} ms = "
        f"{n_table / ms * 1e3:.4e} postings/s, "
        f"{words * 32 / n_table:.4f} bits/posting (docids: decode and "
        f"prefix sum); CUDA events around the {len(gaps)} lists, median of "
        f"{TABLE_RUNS} after one, host enqueue included; {smi}")
    out["table_lists"] = {"terms": [int(t) for t in table_terms],
                          "postings": n_table}
    pfd_lists = {"longest": (encoded[("group_pfd", 0)][0], gaps[0]),
                 "shortest": (encoded[("group_pfd", len(gaps) - 1)][0],
                              gaps[-1])}
    return out, pfd_lists



@contextlib.contextmanager
def timed_methods(targets: dict):
    """Wrap ``{name: (owner, attribute)}`` with :func:`timed_calls` while
    the block runs; yields {name: [seconds]}."""
    totals = {name: [0.0] for name in targets}
    saved = {name: getattr(owner, attr) for name, (owner, attr)
             in targets.items()}
    for name, (owner, attr) in targets.items():
        setattr(owner, attr, timed_calls(saved[name], totals[name]))
    try:
        yield totals
    finally:
        for name, (owner, attr) in targets.items():
            setattr(owner, attr, saved[name])


@contextlib.contextmanager
def prebuilt_shards(shards_mod, parent, built: dict):
    """``shards_mod.shard_generation(parent, lo, hi)`` returns ``built[(lo,
    hi)]`` (a shard the worker made from the same corpus) while the block
    runs; any other call raises."""
    saved = shards_mod.shard_generation

    def lookup(gen, lo, hi):
        sg = built.get((lo, hi))
        if gen is not parent or sg is None or sg.gid != gen.gid:
            raise AssertionError(f"sharded: no prebuilt shard [{lo}, {hi}) "
                                 f"of this generation")
        return sg
    shards_mod.shard_generation = lookup
    try:
        yield
    finally:
        shards_mod.shard_generation = saved


@contextlib.contextmanager
def prebuilt_scores(arena_cls, built: list):
    """While the block runs, ``arena_cls.ensure_scores`` on an arena of a
    generation that ``built`` holds a score arena for (made by the build
    worker: ``ScoreArena.from_index(gen, device="cpu")``, host work alone)
    adopts it, its two tensors moved to the arena's device, in place of
    building it; yields the list of the score arenas adopted."""
    saved = arena_cls.ensure_scores
    left = {id(sa.idx): sa for sa in built}
    adopted = []

    def ensure_scores(self):
        sa = left.get(id(self.idx))
        if self.scores is None and sa is not None and sa.idx is self.idx:
            sa.tiles = sa.tiles.to(self.device)
            if sa.dense_tiles is not None:
                sa.dense_tiles = sa.dense_tiles.to(self.device)
            self.scores = sa
            adopted.append(left.pop(id(self.idx)))
        return saved(self)
    arena_cls.ensure_scores = ensure_scores
    try:
        yield adopted
    finally:
        arena_cls.ensure_scores = saved


def sharded_phase(gen, shard_job, fresh, smi, np, torch) -> dict:
    """The sharded phase (module docstring): the main path's unmutated
    ``group_simple`` generation split into SHARDS doc-range shards (built
    by a worker process, ``shard_job``), the main path's fresh batches
    served over them and held against the main path's oracles.  Raises on
    any failed check; returns the figures."""
    from repro_torch import kernels as K
    from repro_torch.index import shards as shards_mod
    from repro_torch.index.device import DeviceArena
    from repro_torch.index.engine import QueryBatch, QueryEngine
    from repro_torch.index.invindex import Generation, InvertedIndex
    from repro_torch.launch.mesh import serving_mesh
    from repro_torch.obs.trace import enable_tracing

    log(f"== sharded: {SHARDS} doc-range shards of the main path's index")
    gc.collect()
    torch.cuda.empty_cache()
    mesh = serving_mesh(SHARDS)
    out = {"shards": SHARDS, "placement": "mesh" if mesh else "logical",
           "batches": {}, "traced": {}}
    log(f"placement: {out['placement']} ("
        + (f"one card a shard: {[str(d) for d in mesh]}" if mesh else
           f"{torch.cuda.device_count()} card(s): the {SHARDS} shards run "
           f"logically on cuda:0") + ")")
    t0 = time.perf_counter()
    spec = shards_mod.ShardSpec.derive(gen, SHARDS)
    out["derive_s"] = time.perf_counter() - t0
    out["bounds"] = list(spec.bounds)
    log(f"ShardSpec.derive: bounds {list(spec.bounds)} in "
        f"{out['derive_s']:.3f} s")
    t0 = time.perf_counter()
    (bounds, built, out["shard_generation_s"], scores,
     out["worker_scores_s"]) = shard_job.result()
    out["shard_wait_s"] = time.perf_counter() - t0
    if tuple(bounds) != spec.bounds:
        raise AssertionError(f"the shard worker's bounds {bounds} != "
                             f"{spec.bounds}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with prebuilt_shards(shards_mod, gen, built), \
            prebuilt_scores(DeviceArena, scores) as adopted, timed_methods({
                "arenas": (Generation, "to_device"),
                "ensure_scores": (DeviceArena, "ensure_scores")}) as took:
        eng = QueryEngine(InvertedIndex(gen=gen), cache_blocks=1 << 22
                          ).to_device(fused=True, shards=SHARDS, mesh=mesh)
        torch.cuda.synchronize()
    if len(adopted) != len(scores):
        raise AssertionError(f"the shard engines adopted {len(adopted)} of "
                             f"the worker's {len(scores)} score arenas")
    del built, scores, adopted
    out["to_device_s"] = time.perf_counter() - t0
    out.update({f"{k}_s": v[0] for k, v in took.items()})
    got_spec, engs, _ = eng._shard_engines(eng._ctx_now())
    if got_spec.bounds != spec.bounds:
        raise AssertionError(f"engine bounds {got_spec.bounds} != derived "
                             f"{spec.bounds}")
    live = [e for e in engs if e is not None]
    out["shard_docs"] = [hi - lo for lo, hi in spec.ranges()]
    out["shard_blocks"] = [sum(len(tp.blocks) for tp in e.idx.terms.values())
                           for e in live]
    log(f"to_device(fused=True, shards={SHARDS}): {out['to_device_s']:.2f} s "
        f"(shard_generation {out['shard_generation_s']:.2f} s in the worker, "
        f"waited {out['shard_wait_s']:.2f} s; the shards' "
        f"arenas {out['arenas_s']:.2f} s, ensure_scores "
        f"{out['ensure_scores_s']:.2f} s here, their score arenas "
        f"{out['worker_scores_s']:.2f} s on the host in the worker); "
        f"{len(live)} shards, docs "
        f"{out['shard_docs']}, blocks {out['shard_blocks']}")

    def run(mode, placement, queries, want):
        torch.cuda.synchronize()
        K.reset_launches()
        with contextlib.ExitStack() as st:
            parent = st.enter_context(eng.metrics.scoped())
            subs = [st.enter_context(e.metrics.scoped()) for e in live]
            t0 = time.perf_counter()
            res = eng.execute(eng.plan(QueryBatch(queries, mode=mode,
                                                  k=RANKED_K),
                                       placement=placement))
            dt = time.perf_counter() - t0
        for j, (a, b) in enumerate(zip(res, want)):
            if not (np.array_equal(a, b) if mode == "and" else a == b):
                raise AssertionError(f"sharded {mode}/{placement}, query "
                                     f"{j}: differs from the main path's "
                                     f"result")
        st_ = {n: parent.delta(n) for n in ("merge_syncs", "collective_bytes",
                                            "shard_final_syncs")}
        for n in ("cand_syncs", "score_syncs", "final_syncs",
                  "blocks_dense", "score_rounds", "resident_rounds"):
            st_[n] = sum(s.delta(n) for s in subs)
        return res, dt, st_, dict(K.LAUNCHES)

    launches_all = {}
    for mode, placement in (("and", "fused"), ("or", "fused"),
                            ("and_scored", "fused"), ("and", "device")):
        what = f"{mode}/{placement}"
        (queries, want), _ = fresh[mode]
        res, dt, stats, launches = run(mode, placement, queries, want)
        ranked = mode != "and"
        need = {"merge_syncs": int(ranked),
                "collective_bytes": len(live) * len(queries) * 8 * ranked,
                "shard_final_syncs": len(live), "cand_syncs": 0,
                "score_syncs": 0}
        bad = {n: (stats[n], v) for n, v in need.items() if stats[n] != v}
        if bad:
            raise AssertionError(f"sharded {what} counters (got, want): {bad}")
        want_k = ["B2"] + (["B1"] if placement == "fused" else []) + (
            ["B2add", "B3"] if ranked else []) + (
            ["B4"] if ranked and stats["blocks_dense"] > 0 else [])
        missing = [k for k in want_k if launches.get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"sharded {what} did not launch {missing}: "
                                 f"{launches}")
        for k, v in launches.items():
            launches_all[k] = launches_all.get(k, 0) + v
        out["batches"][what] = {"qps": len(queries) / dt, "seconds": dt,
                                "stats": stats, "launches": launches}
        log(f"sharded {what}: {len(queries)} queries in {dt:.4f} s = "
            f"{len(queries) / dt:.2f} qps, equal to the main path's "
            f"results; counters {stats}; launches {launches}")
        del res
    for k in ("B1", "B2", "B2add", "B3", "B4"):
        if launches_all.get(k, 0) <= 0:
            raise AssertionError(f"the sharded phase never launched {k}")
    out["launches"] = launches_all

    for mode in ("and", "or", "and_scored"):
        _, (queries, want) = fresh[mode]
        tracer = enable_tracing(True, fenced=True)
        tracer.clear()
        try:
            res, dt, _, _ = run(mode, "fused", queries, want)
        finally:
            enable_tracing(False)
        per = {}
        for sp in tracer.spans():
            key = (sp.name if sp.name in ("engine/execute", "engine/plan",
                                          "sharded/merge", "ranked/rescore")
                   else f"{sp.name}@{sp.lane}")
            per.setdefault(key, []).append(sp.dur * 1e3)
        tracer.clear()
        out["traced"][mode] = {"seconds": dt, "spans_ms": {
            k: {"n": len(v), "ms": sum(v), "calls_ms": v}
            for k, v in per.items()}}
        log(f"sharded {mode}/fused, fenced spans of another fresh batch "
            f"({dt:.4f} s):")
        for k, v in sorted(per.items(), key=lambda kv: -sum(kv[1])):
            calls = (" [" + ", ".join(f"{x:.2f}" for x in v) + "]"
                     if k.startswith(("kernel/topk", "kernel/extract_ids"))
                     else "")
            log(f"  {k:32s} x{len(v):<3d} {sum(v):10.2f} ms{calls}")
        del res
    out["peak_bytes"] = torch.cuda.max_memory_allocated()
    log(f"sharded max_memory_allocated {out['peak_bytes']} bytes "
        f"({out['peak_bytes'] / 2**30:.2f} GiB) over the shard build and "
        f"the 7 batches; {smi}")
    del eng, engs, live
    gen.__dict__.pop("_shard_serving", None)
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serve_phase(gen, fresh, root, seed, smi, np, torch) -> dict:
    """The serve phase (module docstring): an ``IndexServer`` in front of
    the unsharded ``fused`` engine over the main path's generation, a
    seeded open-loop Poisson stream of the main path's queries, every
    served result held against the main path's oracle; then the port's
    ``launch.serve --index --smoke`` in a subprocess.  Raises on any failed
    check; returns the figures."""
    import asyncio
    from repro_torch import kernels as K
    from repro_torch.index.engine import QueryEngine
    from repro_torch.index.invindex import InvertedIndex
    from repro_torch.index.serve import (IndexServer, Rejected, Request,
                                         ServeConfig, drive_open_loop,
                                         poisson_offsets)
    from repro_torch.obs.trace import trace_coverage

    log(f"== serve: IndexServer, {SERVE_AND} `and` + {SERVE_OR} `or` "
        f"requests, Poisson at {SERVE_RATE} requests/s")
    (and_q, and_want), _ = fresh["and"]
    (or_q, or_want), _ = fresh["or"]
    items = ([("and", q, w) for q, w in zip(and_q[:SERVE_AND],
                                            and_want[:SERVE_AND])]
             + [("or", q, w) for q, w in zip(or_q[:SERVE_OR],
                                             or_want[:SERVE_OR])])
    order = np.random.default_rng(seed + 11).permutation(len(items))
    items = [items[i] for i in order]
    reqs = [Request(list(q), mode=m, k=RANKED_K,
                    deadline_ms=SERVE_DEADLINE_MS) for m, q, _ in items]
    offsets = poisson_offsets(len(reqs), SERVE_RATE, seed=seed + 13)
    t0 = time.perf_counter()
    eng = QueryEngine(InvertedIndex(gen=gen), cache_blocks=1 << 22
                      ).to_device(fused=True)
    torch.cuda.synchronize()
    out = {"to_device_s": time.perf_counter() - t0}
    log(f"engine over the main path's generation: to_device(fused=True) "
        f"{out['to_device_s']:.2f} s (its arenas and score arena cached on "
        f"the generation)")
    cfg = ServeConfig(max_batch=16, max_wait_ms=4.0, placement="fused",
                      default_deadline_ms=SERVE_DEADLINE_MS,
                      queue_cap=max(1024, len(reqs)),
                      warm_modes=("and", "or"))
    server = IndexServer(eng, cfg)
    launches = {}

    async def go():
        await server.start()
        K.reset_launches()
        try:
            return await drive_open_loop(server, reqs, offsets)
        finally:
            await server.stop()
            launches.update(K.LAUNCHES)

    t0 = time.perf_counter()
    results = asyncio.run(go())
    out["wall_s"] = time.perf_counter() - t0
    stats = server.stats
    snap = stats.snapshot()
    for j, ((mode, q, want), got) in enumerate(zip(items, results)):
        if isinstance(got, Rejected):
            raise AssertionError(f"serve: request {j} ({mode} {q}) rejected: "
                                 f"{got}")
        if not (np.array_equal(got, want) if mode == "and" else got == want):
            raise AssertionError(f"serve: request {j} ({mode} {q}) differs "
                                 f"from the main path's result")
    if snap["shed_rate"] != 0 or snap["served"] != len(reqs):
        raise AssertionError(f"serve: shed_rate {snap['shed_rate']}, served "
                             f"{snap['served']} of {len(reqs)}")
    names = {s.name for s in stats.tracer.spans()}
    need = {"serve/request", "serve/close", "serve/batch", "serve/plan",
            "serve/execute", "serve/deliver"}
    if not need <= names:
        raise AssertionError(f"serve: spans missing {sorted(need - names)}")
    missing = [k for k in ("B1", "B2", "B2add", "B3")
               if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"serve: the stream did not launch {missing}: "
                             f"{launches}")
    cov = trace_coverage(stats.tracer.spans())
    lat = snap["latency_ms"]
    hist = {p: dict(sorted(h.items())) for p, h in snap["batch_hist"].items()}
    out.update({"requests": len(reqs), "served": snap["served"],
                "shed_rate": snap["shed_rate"], "warmup_s": snap["warmup_s"],
                "latency_ms": lat, "goodput_qps": snap["goodput_qps"],
                "on_time_frac": snap["on_time_frac"],
                "stream_wall_s": snap["wall_s"],
                "mean_batch": snap["mean_batch"],
                "n_batches": snap["n_batches"], "batch_hist": hist,
                "launches": launches, "trace_coverage": cov})
    log(f"served {snap['served']}/{len(reqs)} (shed_rate "
        f"{snap['shed_rate']}), every result equal to the main path's; "
        f"warm-up {snap['warmup_s']:.2f} s; latency ms p50 "
        f"{lat['p50']:.2f} p99 {lat['p99']:.2f} p999 {lat['p999']:.2f} "
        f"(mean {lat['mean']:.2f}, max {lat['max']:.2f}); goodput "
        f"{snap['goodput_qps']:.2f} requests/s over {snap['wall_s']:.2f} s; "
        f"{snap['n_batches']} batches, mean {snap['mean_batch']:.2f}, "
        f"sizes {hist}; batch trace coverage {cov:.3f}; launches "
        f"{launches}; {smi}")
    del eng, server, results
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                           "--index", "--smoke"], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    out["launch_serve_s"] = time.perf_counter() - t0
    tail = (proc.stdout + proc.stderr).strip().splitlines()[-4:]
    for line in tail:
        log(f"  launch.serve | {line}")
    if proc.returncode != 0 or "index serve smoke ok" not in proc.stdout:
        raise AssertionError(f"python -m repro_torch.launch.serve --index "
                             f"--smoke exited {proc.returncode}")
    log(f"python -m repro_torch.launch.serve --index --smoke: exit 0 in "
        f"{out['launch_serve_s']:.2f} s")
    return out


def start_examples(root) -> dict:
    """Start the examples phase's subprocesses (``EXAMPLES``) on the card,
    all at once; {name: Popen}."""
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    return {name: subprocess.Popen([sys.executable, *cmd], cwd=root, env=env,
                                   stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True)
            for name, cmd, _ in EXAMPLES}


def examples_phase(procs, gen, fresh, smi, np) -> dict:
    """The examples phase (module docstring): the one-shot query shims on
    the main path's generation, each result held against the main path's;
    then the example subprocesses (``procs``, from :func:`start_examples`)
    collected: each exits 0 and prints its line, and the quickstart's
    launch counts show its kernels.  Raises on any failed check; returns
    the figures."""
    from repro_torch.index import query as Q
    from repro_torch.index.invindex import InvertedIndex

    log(f"== examples: the one-shot shims on {SHIM_QUERIES} of the fresh "
        f"queries; the {len(EXAMPLES)} subprocesses started with the "
        f"sharded phase")
    out = {"shims_s": {}, "subprocess_s": {}}
    # the shims serve on the host placement: no launch, no device state
    idx = InvertedIndex(gen=gen)
    (and_q, and_want), _ = fresh["and"]
    (or_q, or_want), _ = fresh["or"]
    for mode, shim, qs, want in (
            ("and", Q.and_query, and_q, and_want),
            ("or", lambda i, q: Q.or_query(i, q, k=RANKED_K), or_q, or_want)):
        t0 = time.perf_counter()
        for q, w in zip(qs[:SHIM_QUERIES], want[:SHIM_QUERIES]):
            got = shim(idx, q)
            if not (np.array_equal(got, w) if mode == "and" else got == w):
                raise AssertionError(f"examples: the {mode} shim on {q} "
                                     f"differs from the main path's result")
        out["shims_s"][mode] = time.perf_counter() - t0
    log(f"shims and_query, or_query (k={RANKED_K}) on {SHIM_QUERIES} "
        f"queries each, every result equal to the main path's: "
        f"{out['shims_s']['and']:.2f} s, {out['shims_s']['or']:.2f} s "
        f"(host placement)")
    for name, cmd, expect in EXAMPLES:
        t0 = time.perf_counter()
        stdout, stderr = procs[name].communicate(timeout=600)
        out["subprocess_s"][name] = time.perf_counter() - t0
        for line in stdout.strip().splitlines():
            log(f"  {name} | {line}")
        if procs[name].returncode != 0:
            for line in stderr.strip().splitlines()[-20:]:
                log(f"  {name} ! {line}")
            raise AssertionError(f"examples: {' '.join(cmd)} exited "
                                 f"{procs[name].returncode}")
        if not re.search(expect, stdout):
            raise AssertionError(f"examples: {' '.join(cmd)} did not "
                                 f"print /{expect}/")
        if name == "quickstart":
            line = [x for x in stdout.splitlines()
                    if x.startswith("kernel launches: ")][-1]
            launches = json.loads(line.split(": ", 1)[1])
            missing = [k for k in ("B2", "B3", "B6", "B7a")
                       if launches.get(k, 0) <= 0]
            if missing:
                raise AssertionError(f"examples: the quickstart did not "
                                     f"launch {missing}: {launches}")
            out["quickstart_launches"] = launches
    log(f"examples exit 0 (waited "
        f"{json.dumps({k: round(v, 2) for k, v in out['subprocess_s'].items()})} "
        f"s here); quickstart launches {out['quickstart_launches']} (B4 "
        f"{'launched' if out['quickstart_launches']['B4'] else 'not launched'}); "
        f"{smi}")
    return out


def step_breakdown(step, torch, casts: bool = False, top: int = 0) -> dict:
    """One call of ``step`` (after the timed ones) under ``torch.profiler``:
    the wall seconds (profiler on), the device's kernel time and busy
    share; with ``casts`` the kernel time under ``aten::_to_copy`` (the
    dtype casts: every weight cast to bf16 on use, and the cache to fp32
    for the scores), which needs the CPU ops traced too; with ``top`` the
    ``top`` kernels of most device time.  Without ``casts`` the card's
    activity alone is traced: a train step's CPU ops (tens of thousands)
    would take the profiler longer to sum than the step takes.  ``None``
    for a figure the trace does not hold."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if casts else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ks, cast_us = [], 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ks.append((getattr(e, "self_device_time_total", 0.0), e.key,
                       e.count))
        elif e.key == "aten::_to_copy":
            cast_us += getattr(e, "device_time_total", 0.0)
    kernels = sum(k[0] for k in ks)
    out = {"wall_s": wall, "kernel_s": None}
    if casts:
        out["cast_s"] = None
    if top:
        out["top"] = None
    if not kernels:
        return out
    out.update(kernel_s=kernels / 1e6, busy_share=kernels / 1e6 / wall)
    if casts:
        out.update(cast_s=cast_us / 1e6, cast_share_of_kernels=cast_us / kernels)
    if top:
        out["top"] = [{"kernel": kernel_tag(name), "ms": us / 1e3, "calls": n,
                       "share": us / kernels}
                      for us, name, n in sorted(ks, reverse=True)[:top]]
    return out


@contextlib.contextmanager
def route_spy(moe, torch):
    """Record every ``moe.route_group`` call made inside the block (each
    MoE layer's routing): its output, capacity and each group's expert
    loads (the top-k recomputed from the same input), as device tensors,
    with no sync; the first call's input too.  The spy runs only in
    untimed calls."""
    calls = []
    route = moe.route_group

    def spy(x, router_w, *, top_k, capacity):
        out = route(x, router_w, top_k=top_k, capacity=capacity)
        probs = torch.softmax(x.float() @ router_w.float(), dim=-1)
        expert = torch.sort(probs, dim=-1, descending=True,
                            stable=True)[1][..., :top_k]
        g, s, e = probs.shape
        load = torch.zeros(g, e, device=x.device).scatter_add_(
            1, expert.reshape(g, -1), torch.ones(g, s * top_k, device=x.device))
        first = not calls
        calls.append({"x": x if first else None,
                      "router": router_w if first else None, "top_k": top_k,
                      "capacity": capacity, "idx": out[0], "wgt": out[1],
                      "expert": expert, "load": load})
        return out

    moe.route_group = spy
    try:
        yield calls
    finally:
        moe.route_group = route


def route_invariants(calls, what: str, torch) -> dict:
    """Check the routing of every recorded layer (``route_spy``): no token
    takes an expert twice; every slot holds a token in range or the
    sentinel S, with weight 0 exactly at the sentinel; each expert keeps
    min(load, capacity) tokens, in token order, so a token keeps at most
    k.  Returns the share of assignments dropped by capacity and the
    largest expert load over the mean, over all layers."""
    assigned = kept = 0
    top = 0.0
    for li, c in enumerate(calls):
        idx, wgt, load, cap, k = (c["idx"].long(), c["wgt"], c["load"],
                                  c["capacity"], c["top_k"])
        g, s = c["expert"].shape[:2]
        e = load.shape[1]
        ex = torch.sort(c["expert"], dim=-1)[0]
        seg = idx.view(g, e, cap)
        real = seg < s
        ok = (bool((ex[..., 1:] != ex[..., :-1]).all())
              and bool(((idx >= 0) & (idx <= s)).all())
              and bool(((wgt == 0) == (idx == s)).all())
              and torch.equal(real.sum(-1).float(), torch.clamp(load, max=cap))
              and not bool((real[..., 1:] & ~real[..., :-1]).any())
              and bool(((seg[..., 1:] > seg[..., :-1]) | ~real[..., 1:]).all()))
        if not ok:
            raise AssertionError(f"{what}: MoE layer {li}'s routing breaks an "
                                 f"invariant (capacity {cap}, top-{k})")
        assigned += g * s * k
        kept += int(real.sum())
        top = max(top, float(load.max()) / (s * k / e))
    return {"layers": len(calls), "assignments": assigned,
            "dropped_share": 1.0 - kept / assigned, "max_load_over_mean": top}


def route_card_vs_host(call, moe, torch) -> dict:
    """One recorded MoE layer's routing (fp32 input) on the card against
    ``route_group`` on the host CPU: ``idx`` equal on every slot of the
    experts that no near-tied token (k-th and (k+1)-th probabilities within
    LM_ROUTE_MARGIN, host's) takes as its k-th or (k+1)-th choice, and
    ``wgt`` there within LM_ROUTE_WGT_TOL."""
    x, rw, k, cap = call["x"], call["router"], call["top_k"], call["capacity"]
    card = moe.route_group(x, rw, top_k=k, capacity=cap)
    host = moe.route_group(x.cpu(), rw.cpu(), top_k=k, capacity=cap)
    probs = torch.softmax(x.cpu().float() @ rw.cpu().float(), dim=-1)
    p, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    near = (p[..., k - 1] - p[..., k]) <= LM_ROUTE_MARGIN     # (G, S)
    amb = torch.zeros(probs.shape[0], probs.shape[2], dtype=torch.bool)
    gi, si = torch.nonzero(near, as_tuple=True)
    for j in (k - 1, k):
        amb[gi, order[gi, si, j]] = True
    ok = (~amb).repeat_interleave(cap, dim=1)
    idx_c, wgt_c = card[0].cpu(), card[1].cpu()
    out = {"tokens": int(near.numel()),
           "rows_compared_share": 1.0 - float(near.float().mean()),
           "slots_compared_share": float(ok.float().mean()),
           "idx_mismatches": int((idx_c != host[0])[ok].sum()),
           "wgt_max_abs_err": float((wgt_c - host[1])[ok].abs().max()),
           "aux_abs_err": float((card[2].cpu() - host[2]).abs().max())}
    if out["idx_mismatches"] or out["wgt_max_abs_err"] > LM_ROUTE_WGT_TOL:
        raise AssertionError(f"MoE routing on the card differs from the host "
                             f"CPU's: {out}")
    return out


def lm_phase(dev, seed, smi, np, torch) -> dict:
    """The lm phase (module docstring): dense-LM serving at full width on
    ``dev``, prompts from a compressed token store.  Raises on any failed
    check; returns the figures per model."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.data.pipeline import TokenStore, lm_batch_iter
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    from repro_torch.models.specs import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in fp32
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    log(f"== lm: {', '.join(LM_ARCHS)} at full width; prefill "
        f"{LM_BATCH} x {LM_PREFILL}, {LM_DECODE} greedy decode steps; "
        f"memory_allocated {torch.cuda.memory_allocated()} bytes at the start")
    out = {}

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for arch in LM_ARCHS:
        torch.cuda.reset_peak_memory_stats()
        cfg = configs.get(arch).make_config()
        r = {"published_layers": cfg.n_layers}
        if arch in LM_DEPTH:        # the model does not fit one card whole
            cfg = dataclasses.replace(cfg, n_layers=LM_DEPTH[arch])
        r["layers"] = cfg.n_layers
        rng = np.random.default_rng(seed + 17)
        toks = ((rng.zipf(LM_ZIPF, LM_STORE_TOKENS) - 1) % cfg.vocab
                ).astype(np.uint32)
        t0 = time.perf_counter()
        store = TokenStore.build(toks, codec="bp128", block=LM_STORE_BLOCK)
        r["store_build_s"] = time.perf_counter() - t0
        r["store_ratio"] = store.compressed_bytes() / store.raw_bytes
        t0 = time.perf_counter()
        back = store.read(0, store.n)
        r["store_read_tokens_per_s"] = store.n / (time.perf_counter() - t0)
        if not np.array_equal(back, toks):
            raise AssertionError(f"lm {arch}: the token store reads back wrong")
        batch, nxt = lm_batch_iter(store, LM_BATCH, LM_PREFILL)(0)
        flat = toks[:LM_BATCH * (LM_PREFILL + 1)].reshape(LM_BATCH, -1)
        if nxt != 1 or not np.array_equal(batch["tokens"], flat[:, :-1]):
            raise AssertionError(f"lm {arch}: lm_batch_iter's first batch")
        del toks, back
        log(f"{arch}: TokenStore bp128 of {store.n} Zipf({LM_ZIPF}) ids "
            f"(block {LM_STORE_BLOCK}) built in {r['store_build_s']:.2f} s, "
            f"ratio {r['store_ratio']:.4f} of raw, host read "
            f"{r['store_read_tokens_per_s']:.4e} tokens/s")

        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        t0 = time.perf_counter()
        model = T.init(cfg, gen)
        r["init_s"] = sync_s(t0)
        # init draws each leaf in fp32 first (a bf16 leaf's draw is a
        # transient): its peak apart from serving's
        r["peak_gib_init"] = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        params = list(model.parameters())
        r["params"] = sum(p.numel() for p in params)
        if not all(p.device == dev for p in params):
            raise AssertionError(f"lm {arch}: a parameter is not on the card")
        tokens = torch.as_tensor(batch["tokens"], device=dev)

        # bf16 serving: prefill (one warm-up, its MoE routing recorded and
        # checked), then greedy decode
        with route_spy(moe, torch) as calls:
            T.prefill(model, tokens)
        if cfg.moe:
            r["prefill_routing"] = route_invariants(calls, f"lm {arch} prefill",
                                                    torch)
        del calls
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = T.prefill(model, tokens)
        r["prefill_s"] = sync_s(t0)
        r["prefill_tokens_per_s"] = LM_BATCH * LM_PREFILL / r["prefill_s"]
        last_bf16 = logits.float()
        cache = {k: torch.cat([v, v.new_zeros(v.shape[:2] + (LM_DECODE,) + v.shape[3:])], dim=2)
                 for k, v in cache.items()}
        ptrs = {k: v.data_ptr() for k, v in cache.items()}
        finite = torch.isfinite(logits).all()
        on_card = [t.device == dev for t in (logits, *cache.values())]
        tok = torch.argmax(logits, -1).to(torch.int32)
        step_s = []
        for i in range(LM_DECODE):
            t0 = time.perf_counter()
            logits, cache2 = T.decode_step(model, cache, tok, LM_PREFILL + i)
            tok = torch.argmax(logits, -1).to(torch.int32)
            step_s.append(sync_s(t0))
            on_card.append(logits.device == dev)
            finite &= torch.isfinite(logits).all()
            if cache2 is not cache or {k: v.data_ptr() for k, v in cache.items()} != ptrs:
                raise AssertionError(f"lm {arch}: decode step {i} did not "
                                     f"write the cache in place")
        if not all(on_card) or not bool(finite):
            raise AssertionError(f"lm {arch}: logits or cache off the card "
                                 f"or not finite")
        r["decode_trace"] = step_breakdown(
            lambda: T.decode_step(model, cache, tok, LM_PREFILL + LM_DECODE - 1),
            torch, casts=True)
        if cfg.moe:     # one more step, recorded: a decode group drops nothing
            with route_spy(moe, torch) as calls:
                T.decode_step(model, cache, tok, LM_PREFILL + LM_DECODE - 1)
            r["decode_routing"] = rd = route_invariants(
                calls, f"lm {arch} decode", torch)
            del calls
            if rd["dropped_share"] != 0.0:
                raise AssertionError(f"lm {arch}: a decode step dropped MoE "
                                     f"assignments: {rd}")
        r["decode_s"] = sum(step_s)
        r["decode_tokens_per_s"] = LM_BATCH * LM_DECODE / r["decode_s"]
        r["decode_step_s"] = {"median": sorted(step_s)[len(step_s) // 2],
                              "first": step_s[0], "min": min(step_s)}
        r["cache_gib"] = sum(v.numel() * v.element_size()
                             for v in cache.values()) / 2**30
        del cache, cache2, logits
        r["peak_gib_bf16"] = torch.cuda.max_memory_allocated() / 2**30

        # The checks.  The reference's init draws every stacked leaf at
        # 1/sqrt(shape[-2]): wq and wk at 1/sqrt(H) and 1/sqrt(KH), so the
        # attention scores reach the hundreds and round-off grows layer by
        # layer (the reference's own fp32 decode differs from its forward by
        # 0.70 of max |logit| at smollm-135m's 30 layers, its bf16 prefill
        # from its fp32 one by 0.22 at starcoder2-3b's first layer:
        # tools/lm_roundoff_depth.py).  On the card the decode step's
        # products (B rows) and the forward's (B x S rows) also sum in
        # other orders.  So each check runs on the first layers of the
        # same weights, where round-off has not grown (two layers: the
        # cache's layer index is exercised), and the full depth's figures
        # are printed beside them.
        tree = model.tree()
        n_dense = cfg.n_dense_layers if cfg.moe else cfg.n_layers

        def cut(n, dtype, device=dev, **kw):
            """The first ``n`` layers (across the dense and the MoE stack)
            of the same weights, activations in ``dtype``, on ``device``."""
            n = min(n, cfg.n_layers)
            nd = min(n, n_dense)
            t = {k: v for k, v in tree.items()
                 if k not in ("dense_layers", "moe_layers")}
            for name, m in (("dense_layers", nd), ("moe_layers", n - nd)):
                if m:
                    t[name] = tree_map(lambda a: a[:m], tree[name])
            t = tree_map(lambda a: a.to(device), t)
            if cfg.moe:
                kw["n_dense_layers"] = nd
            return T.LM(dataclasses.replace(cfg, n_layers=n, dtype=dtype, **kw), t)

        def decode_vs_forward(m, toks2):
            """fp32: the decode step at position S against ``trunk`` on
            S+1 tokens, (max |diff|, max |logit|).  A prompt longer than
            the window leaves the prefill's ring wrapped."""
            s = toks2.shape[1]
            lg, c32 = T.prefill(m, toks2)
            if not m.cfg.window or s < m.cfg.window:
                c32 = {k: torch.cat([v, v.new_zeros(v.shape[:2] + (1,) + v.shape[3:])], dim=2)
                       for k, v in c32.items()}
            nxt_tok = torch.argmax(lg, -1).to(torch.int32)
            lg_d, _ = T.decode_step(m, c32, nxt_tok, s)
            x, _, _ = T.trunk(m, torch.cat([toks2, nxt_tok[:, None]], 1))
            full = torch.einsum("bd,vd->bv", x[:, -1], m.embed.to(x.dtype))
            return {"max_abs_err": float((lg_d - full).abs().max()),
                    "max_abs_logit": float(full.abs().max())}

        # A decode group is one token (capacity 1, k distinct experts:
        # nothing drops), while a forward at capacity factor 1.25 drops the
        # assignments past an expert's capacity and so computes another
        # function; the forward of the decode checks runs at capacity
        # factor E/k (capacity S: nothing drops), which leaves the decode
        # step's capacity at 1.  The served capacity's figure is printed.
        nodrop = ({"capacity_factor": cfg.n_experts / cfg.top_k}
                  if cfg.moe else {})
        b, s = LM_CHECK
        r["decode_vs_forward"] = dvf = decode_vs_forward(
            cut(LM_CHECK_LAYERS, torch.float32, **nodrop), tokens[:b, :s])
        if not dvf["max_abs_err"] <= LM_DECODE_TOL * dvf["max_abs_logit"]:
            raise AssertionError(f"lm {arch}: fp32 decode differs from the "
                                 f"full forward over {LM_CHECK_LAYERS} "
                                 f"layers: {dvf}")
        if cfg.moe:
            r["decode_vs_forward_served_capacity"] = decode_vs_forward(
                cut(LM_CHECK_LAYERS, torch.float32), tokens[:b, :s])
        r["decode_vs_forward_all_layers"] = decode_vs_forward(
            cut(cfg.n_layers, torch.float32, **nodrop), tokens[:b, :s])
        if cfg.window:  # the ring wrapped: the decode step at window + 64
            n = cfg.window + LM_WINDOW_EXTRA
            long = torch.as_tensor(store.read(0, n).astype(np.int32)[None],
                                   device=dev)
            r["window_decode_vs_forward"] = wdf = decode_vs_forward(
                cut(LM_CHECK_LAYERS, torch.float32, **nodrop), long)
            wdf["prompt"] = n
            if not wdf["max_abs_err"] <= LM_DECODE_TOL * wdf["max_abs_logit"]:
                raise AssertionError(f"lm {arch}: fp32 decode after the "
                                     f"window's ring wrapped differs from the "
                                     f"full forward: {wdf}")
            del long
        if cfg.moe:     # the first MoE layer's fp32 routing, card vs host
            b, s = LM_ROUTE_CHECK
            with route_spy(moe, torch) as calls:
                T.trunk(cut(n_dense + 1, torch.float32), tokens[:b, :s])
            r["route_card_vs_host"] = route_card_vs_host(calls[0], moe, torch)
            del calls
        # bf16 on the card against the same code's bf16 on the host CPU,
        # over the first layer (and the leading dense ones of an MoE arch)
        bf16_layers = LM_BF16_LAYERS + (cfg.n_dense_layers if cfg.moe else 0)
        b, s = LM_BF16_CHECK
        card = T.prefill(cut(bf16_layers, torch.bfloat16),
                         tokens[:b, :s])[0].float().cpu()
        host = T.prefill(cut(bf16_layers, torch.bfloat16, torch.device("cpu")),
                         tokens[:b, :s].cpu())[0].float()
        r["bf16_card_vs_host"] = bvh = {
            "max_abs_err": float((card - host).abs().max()),
            "max_abs_logit": float(host.abs().max()),
            "top1_agree": float((card.argmax(-1) == host.argmax(-1)).float().mean())}
        bvh["layers"] = bf16_layers
        if not bvh["max_abs_err"] <= LM_BF16_TOL * bvh["max_abs_logit"]:
            raise AssertionError(f"lm {arch}: bf16 prefill on the card differs "
                                 f"from the host CPU's over {bf16_layers} "
                                 f"layer(s): {bvh}")
        # the served batch's bf16 prefill against an fp32 prefill of the
        # same weights, all layers (printed, not a check: see above)
        t0 = time.perf_counter()
        lg32, c32 = T.prefill(cut(cfg.n_layers, torch.float32), tokens)
        r["prefill_fp32_s"] = sync_s(t0)
        del c32
        r["bf16_vs_fp32"] = {
            "max_abs_err": float((last_bf16 - lg32).abs().max()),
            "max_abs_logit": float(lg32.abs().max()),
            "top1_agree": float((last_bf16.argmax(-1) == lg32.argmax(-1))
                                .float().mean())}
        r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        log(f"{arch}: {r['params']} params ({cfg.n_layers} of "
            f"{r['published_layers']} layers), init {r['init_s']:.2f} s; prefill "
            f"{LM_BATCH} x {LM_PREFILL} in {r['prefill_s']:.4f} s = "
            f"{r['prefill_tokens_per_s']:.1f} tokens/s (fp32 "
            f"{r['prefill_fp32_s']:.4f} s); decode {LM_DECODE} steps x batch "
            f"{LM_BATCH} in {r['decode_s']:.4f} s = "
            f"{r['decode_tokens_per_s']:.1f} tokens/s, step median "
            f"{r['decode_step_s']['median']:.5f} s (first "
            f"{r['decode_step_s']['first']:.5f}); traced step "
            f"{json.dumps(r['decode_trace'])}; cache {r['cache_gib']:.3f} "
            f"GiB in place; fp32 decode vs forward "
            f"{r['decode_vs_forward']['max_abs_err']:.3e} of max |logit| "
            f"{r['decode_vs_forward']['max_abs_logit']:.4f} over "
            f"{LM_CHECK_LAYERS} layers ({cfg.n_layers} layers: "
            f"{r['decode_vs_forward_all_layers']['max_abs_err']:.3e} of "
            f"{r['decode_vs_forward_all_layers']['max_abs_logit']:.4f}); "
            f"bf16 card vs host {bvh['max_abs_err']:.3e} of "
            f"{bvh['max_abs_logit']:.4f} over {bf16_layers} layer(s), "
            f"top-1 agree {bvh['top1_agree']:.4f}; bf16 vs fp32 prefill, "
            f"{cfg.n_layers} layers, {r['bf16_vs_fp32']['max_abs_err']:.4e} of "
            f"{r['bf16_vs_fp32']['max_abs_logit']:.4f}, top-1 agree "
            f"{r['bf16_vs_fp32']['top1_agree']:.4f}; peak "
            f"{r['peak_gib_bf16']:.2f} GiB bf16 serving, {r['peak_gib']:.2f} "
            f"GiB with the fp32 checks ({r['peak_gib_init']:.2f} in init); "
            f"{smi}")
        if cfg.moe:
            pr, rc = r["prefill_routing"], r["route_card_vs_host"]
            sc = r["decode_vs_forward_served_capacity"]
            log(f"{arch} MoE: prefill routing over {pr['layers']} layers "
                f"drops {pr['dropped_share']:.4f} of {pr['assignments']} "
                f"assignments by capacity, largest expert load "
                f"{pr['max_load_over_mean']:.3f} x the mean; decode drops "
                f"{r['decode_routing']['dropped_share']}; routing card vs "
                f"host (2 x 256, first MoE layer, fp32) compared "
                f"{rc['rows_compared_share']:.4f} of the rows and "
                f"{rc['slots_compared_share']:.4f} of the slots, idx equal, "
                f"wgt err {rc['wgt_max_abs_err']:.3e}, aux err "
                f"{rc['aux_abs_err']:.3e}; fp32 decode vs forward at the "
                f"served capacity factor {sc['max_abs_err']:.3e} of "
                f"{sc['max_abs_logit']:.4f} over {LM_CHECK_LAYERS} layers"
                + (f"; window {cfg.window}: decode at position "
                   f"{r['window_decode_vs_forward']['prompt']} vs forward "
                   f"{r['window_decode_vs_forward']['max_abs_err']:.3e} of "
                   f"{r['window_decode_vs_forward']['max_abs_logit']:.4f}"
                   if cfg.window else ""))
        out[arch] = r
        del model, tree, params, tokens, lg32, last_bf16, store, card, host
        gc.collect()
        torch.cuda.empty_cache()
    return out


def subgraph_invariants(job: dict, n_seeds: int, np) -> dict:
    """The sampled subgraph's invariants: ``n_seed`` seeds, every valid
    edge's source in its destination's CSR row, every padding edge at the
    sentinel.  Raises on a breach."""
    sub, rows = job["sub"], job["rows"]
    nodes, ok, m = sub["nodes"], sub["edge_valid"], len(sub["nodes"])
    if sub["n_seed"] != n_seeds or not np.isin(job["seeds"], nodes).all():
        raise AssertionError(f"recsys_gnn minibatch_lg: n_seed "
                             f"{sub['n_seed']}, want {n_seeds}")
    src, dst = nodes[sub["src"][ok]], nodes[sub["dst"][ok]]
    # (row, neighbour) keys, sorted: rows ascend and each CSR row is sorted
    span = np.int64(job["row_idx"].max(initial=0)) + 1
    keys = (np.repeat(np.arange(len(rows), dtype=np.int64), job["row_lens"])
            * span + job["row_idx"])
    r = np.searchsorted(rows, dst)
    want = r * span + src
    pos = np.minimum(np.searchsorted(keys, want), len(keys) - 1)
    if not (rows[r] == dst).all() or not (keys[pos] == want).all():
        raise AssertionError("recsys_gnn minibatch_lg: a sampled edge's source "
                             "is not a neighbour of its destination")
    if not ((sub["src"][~ok] == m) & (sub["dst"][~ok] == m)).all():
        raise AssertionError("recsys_gnn minibatch_lg: a padding edge misses "
                             "the sentinel")
    return {"nodes": m, "valid_edges": int(ok.sum()), "edges": len(ok),
            "seeds": int(sub["n_seed"])}


def recsys_gnn_phase(dev, seed, graph_job, smi, np, torch) -> dict:
    """The recsys_gnn phase (module docstring): the four recsys archs on
    their three serving cells and EGNN on its four graph regimes, at full
    width on ``dev``.  Raises on any failed check; returns the figures."""
    from repro_torch import configs
    from repro_torch.configs.base import STEP_FNS
    from repro_torch.launch.batches import cell_batch, subgraph_batch
    from repro_torch.models import egnn as E
    from repro_torch.models import recsys as R
    from repro_torch.models.specs import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in fp32
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    host = torch.device("cpu")
    log(f"== recsys_gnn: {', '.join(RECSYS_ARCHS)} on {', '.join(RECSYS_CELLS)}, "
        f"EGNN on {', '.join(EGNN_CELLS)}, full width; memory_allocated "
        f"{torch.cuda.memory_allocated()} bytes at the start")

    def timed(fn, runs):
        """(last result, median ms of ``runs`` calls after a warm-up, host
        clock to a synchronize)."""
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(runs):
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return res, sorted(ts)[len(ts) // 2]

    def rel_err(got, want) -> tuple:
        """(max |got - want| on the host, max |want|)."""
        got, want = got.double().cpu(), want.double().cpu()
        return float((got - want).abs().max()), float(want.abs().max())

    def to_host(tree):
        return tree_map(lambda t: t.to(host), tree)

    out = {"recsys": {}, "egnn": {}}
    for arch in RECSYS_ARCHS:
        spec = configs.get(arch)
        cfg = spec.make_config()
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        t0 = time.perf_counter()
        model = R.init(cfg, gen)
        torch.cuda.synchronize()
        r = {"params": sum(p.numel() for p in model.parameters()),
             "init_s": time.perf_counter() - t0}
        cpu = R.RecModel(cfg, to_host(model.tree()))
        rng = np.random.default_rng(seed + 31)
        for name in RECSYS_CELLS:
            cell = spec.shapes[name]
            what = f"recsys_gnn {arch} {name}"
            batch = cell_batch(spec, cfg, cell, rng, dev)
            step, _ = STEP_FNS["recsys"](cfg, cell)
            torch.cuda.reset_peak_memory_stats()
            res, ms = timed(lambda: step(model, batch), RECSYS_RUNS)
            rows = cell.dims.get("n_candidates", cell.dims["batch"])
            c = {"ms": ms, "rows_per_s": rows / ms * 1e3,
                 "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
            hb = {k: v.to(host) for k, v in batch.items()}
            if cell.kind == "serve":
                if not (bool(torch.isfinite(res).all()) and float(res.min()) >= 0
                        and float(res.max()) <= 1):
                    raise AssertionError(f"{what}: a probability outside [0, 1]")
                if name == "serve_p99":     # card vs the CPU path
                    logit = R.forward(cpu, hb)
                    le, lmax = rel_err(R.forward(model, batch), logit)
                    pe, _ = rel_err(res, torch.sigmoid(logit))
                    c["vs_cpu"] = {"logit_err": le, "prob_err": pe, "max_abs_logit": lmax}
                    if max(le, pe) > RECSYS_TOL * lmax:
                        raise AssertionError(f"{what}: card vs CPU {c['vs_cpu']}")
            else:
                scores, ids = res
                logits = R.candidate_logits(model, batch)
                fs, fi = torch.sort(logits, descending=True, stable=True)
                c["topk_equal"] = (torch.equal(scores, fs[:100])
                                   and torch.equal(ids, batch["cand_items"][fi[:100]]))
                if not c["topk_equal"] or not bool(torch.isfinite(logits).all()):
                    raise AssertionError(f"{what}: the chunked top k differs from "
                                         f"one stable sort over every logit")
                le, lmax = rel_err(logits[:RECSYS_CHECK],
                                   R.candidate_logits(cpu, hb, 0, RECSYS_CHECK))
                c["vs_cpu"] = {"logit_err": le, "max_abs_logit": lmax,
                               "candidates": RECSYS_CHECK}
                if le > RECSYS_TOL * lmax:
                    raise AssertionError(f"{what}: card vs CPU {c['vs_cpu']}")
                del logits, fs, fi
            r[name] = c
            log(f"{arch} {name}: {c['ms']:.3f} ms (median of {RECSYS_RUNS}), "
                f"{c['rows_per_s']:.4e} {'candidates' if cell.kind == 'retrieval' else 'rows'}"
                f"/s, peak {c['peak_gib']:.2f} GiB"
                + (f"; card vs CPU logit err {c['vs_cpu']['logit_err']:.3e} of "
                   f"{c['vs_cpu']['max_abs_logit']:.4f}" if "vs_cpu" in c else "")
                + ("; chunked top 100 equals one stable sort" if cell.kind == "retrieval" else "")
                + f"; {smi}")
            del batch, hb, res
        out["recsys"][arch] = r
        del model, cpu
        gc.collect()
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    job = graph_job.result()
    spec = configs.get("egnn")
    mb = spec.shapes["minibatch_lg"].dims
    out["graph"] = {"build_s": job["build_s"], "sample_s": job["sample_s"],
                    "wait_s": time.perf_counter() - t0,
                    **subgraph_invariants(job, mb["batch_nodes"], np)}
    log(f"minibatch_lg graph (worker process): CSRGraph.random("
        f"{mb['graph_nodes']}, {mb['graph_edges']}) {job['build_s']:.2f} s, "
        f"sample_subgraph {job['sample_s']:.2f} s, waited "
        f"{out['graph']['wait_s']:.2f} s; {out['graph']}")
    for name in EGNN_CELLS:
        cell = spec.shapes[name]
        what = f"recsys_gnn egnn {name}"
        cfg = spec.config_for_cell(spec.make_config(), cell)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        model = E.init(cfg, gen)
        rng = np.random.default_rng(seed + 37)
        if name == "minibatch_lg":
            batch = subgraph_batch(job["sub"], job["seeds"], cfg, cell, rng, dev)
        else:
            batch = cell_batch(spec, cfg, cell, rng, dev)
        args = [batch[k] for k in ("feats", "coords", "src", "dst")]
        torch.cuda.reset_peak_memory_stats()
        h, ms = timed(lambda: E.forward(model, *args), EGNN_RUNS)
        loss, _ = E.loss_fn(model, batch)
        c = {"ms": ms, "edges_per_s": cell.dims["n_edges"] / ms * 1e3,
             "loss": float(loss),
             "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        if not (bool(torch.isfinite(h).all()) and bool(torch.isfinite(loss))):
            raise AssertionError(f"{what}: h or the loss is not finite")
        if name in ("full_graph_sm", "molecule"):   # card vs the CPU path
            cpu = E.EGNN(cfg, to_host(model.tree()))
            hb = {k: v.to(host) for k, v in batch.items()}
            he, hmax = rel_err(h, E.forward(cpu, *[hb[k] for k in ("feats", "coords", "src", "dst")]))
            cl = float(E.loss_fn(cpu, hb)[0])
            c["vs_cpu"] = {"h_err": he, "max_abs_h": hmax,
                           "loss_rel_err": abs(c["loss"] - cl) / abs(cl)}
            if he > EGNN_TOL * hmax or c["vs_cpu"]["loss_rel_err"] > EGNN_TOL:
                raise AssertionError(f"{what}: card vs CPU {c['vs_cpu']}")
        if name == "ogb_products":      # E(n) invariance at full size
            q, rr = np.linalg.qr(np.random.default_rng(seed + 41).standard_normal((3, 3)))
            q = torch.as_tensor(q * np.sign(np.diag(rr)), dtype=torch.float32, device=dev)
            shift = torch.tensor([3.0, -1.5, 0.25], device=dev)
            hr = E.forward(model, args[0], args[1] @ q.T + shift, args[2], args[3])
            ie, hmax = rel_err(hr, h)
            c["invariance"] = {"h_err": ie, "max_abs_h": hmax}
            if ie > EGNN_INVARIANCE_TOL * hmax:
                raise AssertionError(f"{what}: rotated and translated h "
                                     f"{c['invariance']}")
            del hr
        out["egnn"][name] = c
        log(f"egnn {name}: forward {ms:.3f} ms (median of {EGNN_RUNS}), "
            f"{c['edges_per_s']:.4e} edges/s, loss {c['loss']:.6f}, peak "
            f"{c['peak_gib']:.2f} GiB"
            + (f"; card vs CPU h err {c['vs_cpu']['h_err']:.3e} of "
               f"{c['vs_cpu']['max_abs_h']:.4f}, loss rel err "
               f"{c['vs_cpu']['loss_rel_err']:.3e}" if "vs_cpu" in c else "")
            + (f"; rotated + translated h err {c['invariance']['h_err']:.3e} "
               f"of {c['invariance']['max_abs_h']:.4f}" if "invariance" in c else "")
            + f"; {smi}")
        del model, batch, args, h, loss
        gc.collect()
        torch.cuda.empty_cache()
    return out


def kernel_tag(name: str) -> str:
    """A CUDA kernel's name without its template noise: the kernel, then
    the functors and kernels named inside its arguments (``elementwise_kernel
    [gpu_kernel_impl_nocast, BinaryFunctor, MulFunctor]``)."""
    head = re.match(r"(?:void )?([\w:]+)", name).group(1).split("::")[-1]
    inner = [m for m in re.findall(r"(\w+(?:Functor|_kernel_cuda|_impl_nocast"
                                   r"|_impl|_kernel))", name) if m not in head]
    inner = list(dict.fromkeys(inner))[:4]
    return head + (f" [{', '.join(inner)}]" if inner else "")


def attn_fan_in(params: dict, cfg, torch) -> None:
    """Rescale an LM's (d, heads, head_dim) and (heads, head_dim, d)
    attention projections, drawn at 1/sqrt(shape[-2]) by the reference's
    rule, to 1/sqrt of their fan-in (d, and heads x head_dim), in place."""
    d = cfg.d_model
    with torch.no_grad():
        for stack in ("dense_layers", "moe_layers"):
            a = params.get(stack, {}).get("attn", {})
            for k, w in a.items():
                if k in ("wq", "wk", "wv"):
                    w.mul_((w.shape[-2] / d) ** 0.5)
                elif k == "wo":
                    w.mul_((w.shape[-2] / (w.shape[-3] * w.shape[-2])) ** 0.5)


def touched_rows(params: dict, batch: dict, torch) -> tuple:
    """(params, batch) of the same function on this batch with dlrm's and
    wide-deep's stacked tables cut to the rows the batch reads: table t
    keeps its distinct ids' rows (padded with row 0 to one count) and the
    ids become their ranks.  The tables' gradient rows are the full
    gradient's at those ids (its other rows are 0).  Other models are
    returned as they are."""
    if "tables" not in params:
        return params, batch
    ids = batch["sparse"].long()
    uniq = [torch.unique(ids[:, t]) for t in range(ids.shape[1])]
    n = max(len(u) for u in uniq)
    rows = torch.stack([torch.cat([u, u.new_zeros(n - len(u))]) for u in uniq])
    t = torch.arange(ids.shape[1], device=ids.device)[:, None]
    cut = dict(params)
    for k in ("tables", "wide"):
        if k in params:
            cut[k] = params[k][t, rows]
    local = torch.stack([torch.searchsorted(u, ids[:, i].contiguous())
                         for i, u in enumerate(uniq)], dim=1)
    return cut, {**batch, "sparse": local.to(batch["sparse"].dtype)}


def _paths(tree, prefix=()) -> list:
    """The key paths of a nested dict's leaves, in the walk's order."""
    if not isinstance(tree, dict):
        return [prefix]
    return [p for k in sorted(tree) for p in _paths(tree[k], prefix + (k,))]


def grad_errs(got: list, want: list) -> tuple:
    """(max over leaves of |got - want| / bound, the leaf at that max) for
    each leaf's bound: the larger of its largest |g| and TRAIN_GRAD_FLOOR
    of the largest |g| of any leaf (a leaf whose gradient is a
    cancellation, such as dien's score bias before its softmax, has
    nothing but round-off)."""
    top = max(float(w.abs().max()) for w in want)
    worst = (-1.0, -1)
    for i, (g, w) in enumerate(zip(got, want)):
        w = w.to(g.device, g.dtype)
        bound = max(float(w.abs().max()), TRAIN_GRAD_FLOOR * top, 1e-30)
        worst = max(worst, (float((g - w).abs().max()) / bound, i))
    return worst


def train_lm_store(seed: int, cfg, np):
    """The train phase's smollm token store, drawn from --seed."""
    from repro_torch.data.pipeline import TokenStore
    rng = np.random.default_rng(seed + 43)
    toks = ((rng.zipf(LM_ZIPF, TRAIN_LM_STORE) - 1) % cfg.vocab).astype(np.uint32)
    return TokenStore.build(toks, codec="bp128", block=LM_STORE_BLOCK)


def train_phase(dev, seed, graph_job, smi, np, torch) -> dict:
    """The train phase (module docstring): smollm-135m, the four recsys
    archs and EGNN take train steps at full width on ``dev``; compressed
    data parallelism over logical ranks.  Raises on any failed check;
    returns the figures."""
    import dataclasses
    import importlib.util
    import tempfile

    from repro_torch import configs
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs.base import STEP_FNS
    from repro_torch.data.pipeline import lm_batch_iter
    from repro_torch.distributed import collectives as C
    from repro_torch.launch.batches import cell_batch, subgraph_batch
    from repro_torch.models import egnn as E
    from repro_torch.models import recsys as R
    from repro_torch.models import transformer as T
    from repro_torch.models.specs import tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import train_loop as TL
    from repro_torch.runtime.trainer import (make_compressed_dp_train_step,
                                             make_train_step, to_device,
                                             value_and_grad)

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 products in fp32
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.empty_cache()
    host = torch.device("cpu")
    out = {"lm": {}, "recsys": {}, "egnn": {}, "dp": {}}
    log(f"== train: {TRAIN_LM} ({TRAIN_LM_BATCH} x 4,096), "
        f"{', '.join(RECSYS_ARCHS)} (65,536 rows), EGNN on "
        f"{', '.join(EGNN_CELLS)}, compressed DP over {TRAIN_DP_RANKS} "
        f"ranks; memory_allocated {torch.cuda.memory_allocated()} bytes")

    def to_host(tree):
        return tree_map(lambda t: t.to(host), tree)

    def timed_step(step, times):
        """``step`` timed to a synchronize into ``times`` (seconds)."""
        def run(*a):
            t0 = time.perf_counter()
            res = step(*a)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            return res
        return run

    def same(a: list, b: list) -> bool:
        return len(a) == len(b) and all(
            x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))

    def state_leaves(model, opt) -> list:
        return tree_leaves(model.tree()) + [x for k in sorted(opt) for x in (
            tree_leaves(opt[k]) if isinstance(opt[k], dict) else [opt[k]])]

    secs, mark = {}, [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        secs[name] = now - mark[0]
        mark[0] = now
        log(f"-- train {name}: {secs[name]:.1f} s")

    # ---- smollm-135m ----------------------------------------------------- #
    spec = configs.get(TRAIN_LM)
    cell = spec.shapes["train_4k"]
    cfg = spec.config_for_cell(spec.make_config(), cell)
    seq = cell.dims["seq"]
    store = train_lm_store(seed, cfg, np)
    batches = lm_batch_iter(store, TRAIN_LM_BATCH, seq)
    MESH_INPUTS["lm_batch"] = batches(0)[0]
    ocfg = AdamWConfig(lr=3e-3, warmup_steps=0, total_steps=TRAIN_LM_STEPS)

    def lm_loss(m, b):
        return T.loss_fn(m, b["tokens"], b["labels"])

    r = out["lm"]
    with tempfile.TemporaryDirectory() as tmp:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        model = T.init(cfg, gen)
        opt = adamw_init(model.tree())
        r["params"] = sum(p.numel() for p in model.parameters())
        times = []
        step = timed_step(make_train_step(lm_loss, ocfg), times)
        torch.cuda.reset_peak_memory_stats()
        model, opt, info = TL.run(
            step, model, opt, batches,
            TL.LoopConfig(total_steps=TRAIN_LM_STEPS, ckpt_dir=tmp + "/loop",
                          ckpt_every=10 ** 9, log_every=1), log_fn=log)
        r["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        part("lm steps")
        losses = [m["loss"] for m in info["metrics"]]
        r["losses"] = losses
        r["step_ms"] = [t * 1e3 for t in times]
        med = sorted(times[1:])[len(times[1:]) // 2]
        r["median_step_ms"] = med * 1e3
        r["tokens_per_s"] = TRAIN_LM_BATCH * seq / med
        r["grad_norms"] = [m["grad_norm"] for m in info["metrics"]]
        if not all(np.isfinite(losses + r["grad_norms"])):
            raise AssertionError(f"train {TRAIN_LM}: losses {losses}, grad "
                                 f"norms {r['grad_norms']}")
        if not all(p.device == dev for p in model.parameters()):
            raise AssertionError(f"train {TRAIN_LM}: a parameter left the card")
        # one full-size checkpoint, saved, restored and compared bitwise
        ck = Checkpointer(tmp + "/one")
        t0 = time.perf_counter()
        ck.save(TRAIN_LM_STEPS, (model.tree(), opt), {"cursor": TRAIN_LM_STEPS})
        r["ckpt_save_s"] = time.perf_counter() - t0
        r["ckpt_bytes"] = os.path.getsize(os.path.join(
            tmp, "one", f"step_{TRAIN_LM_STEPS:06d}", "arrays.npz"))
        t0 = time.perf_counter()
        (tree, opt2), _, extra = ck.restore((model.tree(), opt))
        torch.cuda.synchronize()
        r["ckpt_restore_s"] = time.perf_counter() - t0
        if not (same(state_leaves(T.LM(cfg, tree), opt2), state_leaves(model, opt))
                and extra == {"cursor": TRAIN_LM_STEPS}
                and all(t.device == dev for t in tree_leaves(tree))):
            raise AssertionError(f"train {TRAIN_LM}: the restored checkpoint "
                                 f"differs from the state saved")
        del tree, opt2
        part("lm checkpoint")
        b, _ = batches(TRAIN_LM_STEPS)
        one = make_train_step(lm_loss, ocfg)
        r["traced"] = step_breakdown(lambda: one(model, opt, b), torch,
                                     top=8)
        del model, opt, one
        gc.collect()
        torch.cuda.empty_cache()
        log(f"{TRAIN_LM} train_4k ({r['params']} params, fp32 weights, bf16 "
            f"activations, batch {TRAIN_LM_BATCH} x {seq}): losses "
            f"{[round(x, 4) for x in losses]} (grad norms "
            f"{[float(f'{x:.3e}') for x in r['grad_norms']]}); steps ms "
            f"{[round(x, 1) for x in r['step_ms']]} (the first a warm-up), "
            f"median {r['median_step_ms']:.1f} ms = {r['tokens_per_s']:.1f} "
            f"tokens/s; peak {r['peak_gib']:.2f} GiB; checkpoint "
            f"{r['ckpt_bytes']} bytes saved in {r['ckpt_save_s']:.2f} s, "
            f"restored in {r['ckpt_restore_s']:.2f} s, bitwise equal; {smi}")
        tr = r["traced"]
        if tr["kernel_s"] is not None:
            log(f"  one traced step: {tr['wall_s'] * 1e3:.1f} ms wall, kernels "
                f"{tr['kernel_s'] * 1e3:.1f} ms, busy {tr['busy_share']:.3f}")
            for k in tr["top"]:
                log(f"    {k['ms']:9.2f} ms {k['share']:6.3f} x{k['calls']:<5d} "
                    f"{k['kernel']}")

        part("lm trace")
        # crash at step 3 and resume == uninterrupted, bitwise (2 layers)
        cfg2 = dataclasses.replace(cfg, n_layers=TRAIN_CRASH_LAYERS)
        runs = {}
        for name, where, crash in (("straight", "a", None),
                                   ("crashed", "b", TRAIN_CRASH_AT),
                                   ("resumed", "b", None)):
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed + 1)
            m = T.init(cfg2, gen)
            o = adamw_init(m.tree())
            loop = TL.LoopConfig(total_steps=TRAIN_LM_STEPS,
                                 ckpt_dir=f"{tmp}/{where}", ckpt_every=2,
                                 log_every=10 ** 9, crash_at_step=crash)
            try:
                m, o, info = TL.run(make_train_step(lm_loss, ocfg), m, o,
                                    batches, loop, log_fn=log)
            except RuntimeError as e:
                if crash is None or "injected crash" not in str(e):
                    raise
                continue
            runs[name] = (state_leaves(m, o), [x["loss"] for x in info["metrics"]],
                          [x["grad_norm"] for x in info["metrics"]])
        # the loss falls where the model trains: the reference's init of the
        # (d, heads, head_dim) projections (fan_in = heads) makes the 30
        # layers chaotic (grad norms above), so the rule runs on 2 layers
        straight = runs["straight"][1]
        r["two_layer_losses"] = straight
        if not (all(np.isfinite(straight)) and straight[-1] < straight[0]):
            raise AssertionError(f"train {TRAIN_LM} first {TRAIN_CRASH_LAYERS} "
                                 f"layers: losses {straight}")
        r["crash_resume_equal"] = same(runs["straight"][0], runs["resumed"][0])
        if not (r["crash_resume_equal"]
                and runs["resumed"][1] == runs["straight"][1][2:]):
            raise AssertionError(f"train {TRAIN_LM}: crashed at step "
                                 f"{TRAIN_CRASH_AT} and resumed differs from "
                                 f"the uninterrupted run")
        log(f"{TRAIN_LM} first {TRAIN_CRASH_LAYERS} layers: crashed at step "
            f"{TRAIN_CRASH_AT} of {TRAIN_LM_STEPS}, resumed from step 2, equals "
            f"the uninterrupted run bitwise (params and AdamW state; losses "
            f"{[round(x, 4) for x in straight]}, the last below the first; "
            f"grad norms {[float(f'{x:.3e}') for x in runs['straight'][2]]}); no op on the "
            f"path is nondeterministic on CUDA, so without "
            f"use_deterministic_algorithms")
        del runs, m, o
        part("lm crash-resume")

    # one step of the first 2 layers, card vs host CPU, in bf16.
    # The reference's init draws a (d, heads, head_dim) projection at
    # 1/sqrt(heads): scores in the hundreds, attention all but one-hot, and
    # the gradients of wq and wk made of the few near-tied scores, which
    # round-off flips (in fp32 4e-3 and 0.15 of their max in two runs).
    # So the gradients are checked with the projections at 1/sqrt of their
    # fan-in; the loss, and the gradients at the reference's init
    # (printed), as drawn.
    cb, cs = TRAIN_LM_CHECK
    b, _ = lm_batch_iter(store, cb, cs)(0)
    names = [".".join(k) for k in _paths(T.abstract(cfg2))]
    for fan_in in (False, True):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 2)
        card = T.init(cfg2, gen)
        if fan_in:
            attn_fan_in(card.tree(), cfg2, torch)
        cpu = T.LM(cfg2, to_host(card.tree()))
        (lc, _), gc_ = value_and_grad(lm_loss, card, to_device(b, dev))
        (lh, _), gh = value_and_grad(lm_loss, cpu, to_device(b, host))
        err, leaf = grad_errs(tree_leaves(gc_), tree_leaves(gh))
        tag = "fan_in" if fan_in else "reference_init"
        r[f"vs_cpu_{tag}"] = v = {
            "loss_rel_err": abs(float(lc) - float(lh)) / abs(float(lh)),
            "grad_err": err, "grad_leaf": names[leaf]}
        log(f"{TRAIN_LM} first {TRAIN_CRASH_LAYERS} layers, bf16, "
            f"{'projections at 1/sqrt(fan-in)' if fan_in else 'the reference init'}, "
            f"one step of {cb} x {cs} on the card vs the host CPU: loss rel "
            f"err {v['loss_rel_err']:.3e}, grads {err:.3e} of each leaf's max "
            f"|g| (worst {v['grad_leaf']})"
            + ("" if fan_in else "; the grads printed, not checked"))
        if max(v["loss_rel_err"], err if fan_in else 0.0) > TRAIN_LM_TOL:
            raise AssertionError(f"train {TRAIN_LM}: card vs CPU {tag} {v}")
        del card, cpu, gc_, gh

    part("lm vs cpu")
    # compressed all-reduce of smollm's flat gradient, one a rank (each the
    # gradient of a sequence of TRAIN_LM_CHECK's length)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model = T.init(cfg, gen)
    b, _ = lm_batch_iter(store, TRAIN_DP_RANKS, cs)(0)
    b = to_device(b, dev)
    flats = []
    for i in range(TRAIN_DP_RANKS):
        _, g = value_and_grad(lm_loss, model, {k: v[i:i + 1] for k, v in b.items()})
        flats.append(torch.cat([x.reshape(-1) for x in tree_leaves(g)]))
        del g
    del model, b
    n = flats[0].numel()
    exact = torch.stack(flats).mean(dim=0)
    emax = float(exact.abs().max())
    r["allreduce"] = {"n": n}
    for bits in (8, 4):
        C.compressed_allreduce_flat(flats, bits=bits)       # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reds, _ = C.compressed_allreduce_flat(flats, bits=bits)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        err = float((reds[0] - exact).abs().max())
        same_all = all(torch.equal(x, reds[0]) for x in reds)
        r["allreduce"][bits] = {"ms": dt * 1e3, "err": err, "max_abs_mean": emax,
                                "wire_bytes": C.wire_bytes(n, TRAIN_DP_RANKS, bits)}
        log(f"compressed_allreduce_flat int{bits} of {TRAIN_LM}'s flat gradient "
            f"({n} floats) over {TRAIN_DP_RANKS} ranks: {dt * 1e3:.1f} ms, max "
            f"err {err:.3e} of max |exact mean| {emax:.3e}; wire "
            f"{r['allreduce'][bits]['wire_bytes']} bytes a rank vs the fp32 "
            f"ring's {C.wire_bytes(n, TRAIN_DP_RANKS, None)}")
        if not same_all or (bits == 8 and err > TRAIN_DP_ALLREDUCE_TOL * emax):
            raise AssertionError(f"train: int{bits} all-reduce {r['allreduce'][bits]}")
        del reds
    del flats, exact, store
    gc.collect()
    torch.cuda.empty_cache()
    part("allreduce")

    # ---- recsys train_batch ---------------------------------------------- #
    for arch in RECSYS_ARCHS:
        spec = configs.get(arch)
        cfg = spec.make_config()
        cell = spec.shapes["train_batch"]
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        model = R.init(cfg, gen)
        batch = cell_batch(spec, cfg, cell, np.random.default_rng(seed + 47), dev)
        rows = cell.dims["batch"]
        # card vs host CPU on the first rows, at the initial weights: the
        # fp32 loss, then loss and gradients in fp64 (in fp32 a ReLU whose
        # input lies within round-off of 0 takes the other side on one of
        # them, and a table row's gradient, one row's term, moves whole)
        sub = {k: v[:TRAIN_RECSYS_CHECK] for k, v in batch.items()}
        hsub = to_device(sub, host)
        with torch.no_grad():
            lc = float(R.loss_fn(model, sub)[0])
            lh = float(R.loss_fn(R.RecModel(cfg, to_host(model.tree())), hsub)[0])
        c = {"vs_cpu": {"loss_rel_err": abs(lc - lh) / abs(lh)}}
        c64 = dataclasses.replace(cfg, dtype=torch.float64)
        p64, s64 = touched_rows(model.tree(), sub, torch)
        card = R.RecModel(c64, tree_map(lambda t: t.double(), p64))
        (lc, _), gc_ = value_and_grad(R.loss_fn, card, s64)
        del card
        (lh, _), gh = value_and_grad(R.loss_fn, R.RecModel(c64, tree_map(
            lambda t: t.to(host, torch.float64), p64)), to_device(s64, host))
        del p64, s64
        err, leaf = grad_errs(tree_leaves(gc_), tree_leaves(gh))
        c["vs_cpu"].update({"fp64_loss_rel_err": abs(float(lc) - float(lh)) / abs(float(lh)),
                            "fp64_grad_err": err, "fp64_grad_leaf": leaf})
        del gc_, gh
        v = c["vs_cpu"]
        if max(v["loss_rel_err"], v["fp64_loss_rel_err"], err) > TRAIN_RECSYS_TOL:
            raise AssertionError(f"train {arch}: card vs CPU {c['vs_cpu']}")
        step, _ = STEP_FNS["recsys"](cfg, cell, AdamWConfig(
            lr=1e-3, warmup_steps=0, total_steps=TRAIN_RECSYS_STEPS))
        opt = adamw_init(model.tree())
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        run = timed_step(step, times)
        for _ in range(TRAIN_RECSYS_STEPS):
            model, opt, m = run(model, opt, batch)
            losses.append(float(m["loss"]))
        med = sorted(times[1:])[len(times[1:]) // 2]
        c.update({"losses": losses, "step_ms": [t * 1e3 for t in times],
                  "median_step_ms": med * 1e3, "rows_per_s": rows / med,
                  "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
        if not all(np.isfinite(losses)):
            raise AssertionError(f"train {arch}: losses {losses}")
        out["recsys"][arch] = c
        log(f"{arch} train_batch ({rows} rows): steps ms "
            f"{[round(x, 2) for x in c['step_ms']]} (the first a warm-up), "
            f"median {c['median_step_ms']:.2f} ms = {c['rows_per_s']:.4e} "
            f"rows/s; losses {[round(x, 5) for x in losses]}; peak "
            f"{c['peak_gib']:.2f} GiB; card vs CPU ({TRAIN_RECSYS_CHECK} rows) "
            f"loss rel err {c['vs_cpu']['loss_rel_err']:.3e}, in fp64 "
            f"{c['vs_cpu']['fp64_loss_rel_err']:.3e}, grads {err:.3e} (leaf "
            f"{leaf}); {smi}")
        del model, opt, batch, sub, run
        gc.collect()
        torch.cuda.empty_cache()
        part(arch)

    # ---- compressed data parallelism: din, 8 ranks x 8,192 rows ---------- #
    spec = configs.get("din")
    cfg = spec.make_config()
    rows = spec.shapes["train_batch"].dims["batch"]
    ex = importlib.util.spec_from_file_location(
        "compressed_dp_example", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "examples", "compressed_dp_training_torch.py"))
    example = importlib.util.module_from_spec(ex)
    ex.loader.exec_module(example)
    ocfg = AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=TRAIN_DP_STEPS,
                       weight_decay=0.0)
    for bits in (None, 8, 4):
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        model = R.init(cfg, gen)
        n = sum(p.numel() for p in model.parameters())
        step, init_opt = make_compressed_dp_train_step(
            R.loss_fn, ocfg, ranks=TRAIN_DP_RANKS, bits=bits)
        opt = init_opt(model)
        brng = np.random.default_rng(seed + 53)
        times, losses = [], []
        run = timed_step(step, times)
        for _ in range(TRAIN_DP_STEPS):
            model, opt, m = run(model, opt, example.make_batch(cfg, brng, rows))
            losses.append(float(m["loss"]))
        tag = "fp32" if bits is None else f"int{bits}+EF"
        d = {"losses": losses, "step_ms": [t * 1e3 for t in times],
             "wire_bytes": C.wire_bytes(n, TRAIN_DP_RANKS, bits), "params": n}
        out["dp"][tag] = d
        log(f"din compressed DP {tag}: {TRAIN_DP_RANKS} ranks x "
            f"{rows // TRAIN_DP_RANKS} rows, losses "
            f"{[round(x, 5) for x in losses]}, steps ms "
            f"{[round(x, 1) for x in d['step_ms']]}; wire {d['wire_bytes']} "
            f"bytes a rank an all-reduce of {n} floats (fp32 ring "
            f"{C.wire_bytes(n, TRAIN_DP_RANKS, None)})")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"train din DP {tag}: losses {losses}")
        del model, opt, run
    gc.collect()
    torch.cuda.empty_cache()
    part("dp")

    # ---- EGNN on its four regimes ---------------------------------------- #
    job = graph_job.result()
    spec = configs.get("egnn")
    for name in EGNN_CELLS:
        cell = spec.shapes[name]
        cfg = spec.config_for_cell(spec.make_config(), cell)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        model = E.init(cfg, gen)
        rng = np.random.default_rng(seed + 37)
        if name == "minibatch_lg":
            batch = subgraph_batch(job["sub"], job["seeds"], cfg, cell, rng, dev)
        else:
            batch = cell_batch(spec, cfg, cell, rng, dev)
        c = {}
        if name == "full_graph_sm":       # card vs the host CPU
            cpu = E.EGNN(cfg, to_host(model.tree()))
            (lc, _), gc_ = value_and_grad(E.loss_fn, model, batch)
            (lh, _), gh = value_and_grad(E.loss_fn, cpu, to_device(batch, host))
            err, leaf = grad_errs(tree_leaves(gc_), tree_leaves(gh))
            c["vs_cpu"] = {"loss_rel_err": abs(float(lc) - float(lh)) / abs(float(lh)),
                           "grad_err": err, "grad_leaf": leaf}
            del cpu, gc_, gh
            if (c["vs_cpu"]["loss_rel_err"] > TRAIN_EGNN_TOL[0]
                    or err > TRAIN_EGNN_TOL[1]):
                raise AssertionError(f"train egnn {name}: card vs CPU {c['vs_cpu']}")
        step, _ = STEP_FNS["gnn"](cfg, cell, AdamWConfig(
            lr=1e-3, warmup_steps=0, total_steps=TRAIN_EGNN_STEPS))
        opt = adamw_init(model.tree())
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        run = timed_step(step, times)
        for _ in range(TRAIN_EGNN_STEPS):
            model, opt, m = run(model, opt, batch)
            losses.append(float(m["loss"]))
        med = sorted(times[1:])[len(times[1:]) // 2]
        c.update({"losses": losses, "step_ms": [t * 1e3 for t in times],
                  "median_step_ms": med * 1e3,
                  "edges_per_s": cell.dims["n_edges"] / med,
                  "peak_gib": torch.cuda.max_memory_allocated() / 2**30})
        out["egnn"][name] = c
        log(f"egnn {name} train: steps ms {[round(x, 2) for x in c['step_ms']]} "
            f"(the first a warm-up), median {c['median_step_ms']:.2f} ms = "
            f"{c['edges_per_s']:.4e} edges/s; losses "
            f"{[round(x, 5) for x in losses]}; peak {c['peak_gib']:.2f} GiB"
            + (f"; card vs CPU loss rel err {c['vs_cpu']['loss_rel_err']:.3e}, "
               f"grads {c['vs_cpu']['grad_err']:.3e} (leaf "
               f"{c['vs_cpu']['grad_leaf']})" if "vs_cpu" in c else "")
            + f"; {smi}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"train egnn {name}: losses {losses}")
        if name == "ogb_products" and c["peak_gib"] >= TRAIN_EGNN_PEAK_GIB:
            raise AssertionError(f"train egnn ogb_products: peak "
                                 f"{c['peak_gib']:.2f} GiB >= {TRAIN_EGNN_PEAK_GIB}")
        del model, opt, batch, run
        gc.collect()
        torch.cuda.empty_cache()
        part(f"egnn {name}")
    out["seconds"] = secs
    return out


def _mesh_rank(rank: int, world: int, port: int, src: str, seed: int,
               batch: dict, tmp: str) -> None:
    """A spawned rank of the mesh phase; rank 0 writes the figures."""
    sys.path.insert(0, src)
    import numpy as np
    import torch
    res = mesh_work(rank, world, port, seed, batch, tmp, np, torch)
    if rank == 0:
        with open(os.path.join(tmp, "mesh.json"), "w") as f:
            json.dump(res, f)


def mesh_work(rank, world, port, seed, batch, tmp, np, torch) -> dict:
    """The mesh phase on one rank of a world of ``world`` (NCCL, one card
    a rank).  Raises on any failed check; returns the figures."""
    from repro_torch import configs
    from repro_torch import kernels as K
    from repro_torch.configs.base import lm_grads_like_params
    from repro_torch.distributed import sharding as shlib
    from repro_torch.launch import mesh as M
    from repro_torch.models import embedding as E
    from repro_torch.models import transformer as T
    from repro_torch.models.specs import tree_leaves, tree_map
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.trainer import make_train_step, to_device

    def say(msg):
        if rank == 0:
            log(msg)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    def full(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    K.reset_launches()
    M.init_world("nccl", rank=rank, world_size=world, port=port)
    out = {"world": world}
    try:
        dev = torch.device("cuda", torch.cuda.current_device())
        host_mesh = M.make_host_mesh((world, 1))
        say(f"mesh: world {world} (NCCL), smollm on {host_mesh}")
        # ---- smollm-135m: one step planned, one unplanned ---------------- #
        spec = configs.get(TRAIN_LM)
        cell = spec.shapes["train_4k"]
        cfg = spec.config_for_cell(spec.make_config(), cell)
        plan = spec.plan_for(cfg, cell)
        b = to_device(batch, dev)
        ocfg = AdamWConfig(lr=3e-3, warmup_steps=0, total_steps=TRAIN_LM_STEPS)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        model = T.init(cfg, gen)
        if world > 1:
            # as the train phase's card-vs-CPU check: at the reference's
            # init wq and wk's gradients come from near-tied scores, which
            # another split of the batch's round-off flips
            attn_fan_in(model.tree(), cfg, torch)
        twin = T.LM(cfg, tree_map(lambda t: t.clone(), model.tree()))
        kept = {}

        def step_keeping(name):
            layout = lm_grads_like_params(cfg)

            def keep(grads):
                grads = layout(grads)
                kept[name] = [full(g).clone() for g in tree_leaves(grads)]
                return grads
            return make_train_step(
                lambda m, bb: T.loss_fn(m, bb["tokens"], bb["labels"]), ocfg,
                grad_transform=keep)

        if world > 1:           # a fresh process: warm the unplanned step
            warm = T.LM(cfg, tree_map(lambda t: t.clone(), model.tree()))
            step_keeping("warm")(warm, adamw_init(warm.tree()), b)
            del warm, kept["warm"]
        opt = adamw_init(model.tree())
        (_, _, m0), plain_ms = timed(
            lambda: step_keeping("plain")(model, opt, b))
        with shlib.plan_scope(host_mesh, plan):
            dm = shlib.distribute_model(twin, T.axes(cfg))
            db = shlib.distribute_tree(b, spec.batch_axes(cfg, cell))
            dopt = adamw_init(dm.tree())
            step = step_keeping("planned")
            (_, _, m1), planned_ms = timed(lambda: step(dm, dopt, db))
            loss0, loss1 = float(m0["loss"]), float(full(m1["loss"]))
            grads0, grads1 = kept["plain"], kept["planned"]
            after = [full(p).clone() for p in tree_leaves(dm.tree())]
            _, again_ms = timed(lambda: step(dm, dopt, db))
        del twin, dm, dopt, db, kept
        if not all(p.device == dev for p in after):
            raise AssertionError("mesh: a planned parameter left the card")
        if world == 1:
            same = (loss0 == loss1 and all(torch.equal(x, y) for x, y in
                                           zip(grads0, grads1))
                    and all(torch.equal(x, y) for x, y in
                            zip(tree_leaves(model.tree()), after)))
            if not same:
                raise AssertionError("mesh: the planned smollm step is not "
                                     "bitwise the unplanned one")
            check = "bitwise equal (loss, every gradient, the parameters after)"
        else:
            errs = [float((x - y).abs().max() / y.abs().max().clamp(min=1e-30))
                    for x, y in zip(grads1, grads0)]
            rel = abs(loss1 - loss0) / abs(loss0)
            if max(errs + [rel]) > MESH_LM_TOL:
                raise AssertionError(f"mesh: planned vs unplanned: loss rel "
                                     f"{rel}, grads {max(errs)}")
            check = (f"loss rel {rel:.3e}, grads {max(errs):.3e} of each "
                     f"leaf's max |g| (limit {MESH_LM_TOL})")
        del grads0, grads1, after, model, opt
        out["lm"] = {"plan": plan.name, "loss": loss1, "plain_step_ms": plain_ms,
                     "planned_step_ms": planned_ms,
                     "planned_step_again_ms": again_ms, "check": check}
        say(f"{TRAIN_LM} train_4k ({' x '.join(map(str, b['tokens'].shape))}) "
            f"under {plan.name} on ({world}, 1): loss {loss1:.6f}, {check}; "
            f"step ms unplanned {plain_ms:.1f}, planned {planned_ms:.1f} "
            f"(first), {again_ms:.1f} (again)")
        gc.collect()
        torch.cuda.empty_cache()
        # ---- dlrm-rm2's tables: the EP lookup ----------------------------- #
        rspec = configs.get("dlrm-rm2")
        rcell = rspec.shapes["serve_bulk"]
        rcfg = rspec.make_config()
        ep_mesh = (M.make_host_mesh((world // 2, 2)) if world % 2 == 0
                   else host_mesh)
        gen.manual_seed(seed + 7)
        tables = torch.randn((rcfg.n_sparse, rcfg.table_rows, rcfg.embed_dim),
                             generator=gen, device=dev)
        ids = torch.as_tensor(np.random.default_rng(seed + 8).integers(
            0, rcfg.table_rows, (rcell.dims["batch"], rcfg.n_sparse)),
            dtype=torch.int32, device=dev)
        plain, plain_ms = timed(lambda: E.lookup_stacked(tables, ids))
        with shlib.plan_scope(ep_mesh, rspec.plan_for(rcfg, rcell)):
            dt = shlib.distribute(tables, (None, "table_rows", None))
            di = shlib.distribute(ids, ("batch", None))
            del tables
            got, ep_ms = timed(lambda: E.lookup_stacked(dt, di))
            got = full(got)
            _, ep_again_ms = timed(lambda: E.lookup_stacked(dt, di))
        if not torch.equal(got, plain):
            raise AssertionError("mesh: dlrm-rm2's EP lookup differs from the "
                                 "plain gather")
        out["ep_lookup"] = {"rows": rcell.dims["batch"], "plain_ms": plain_ms,
                            "ep_ms": ep_ms, "ep_again_ms": ep_again_ms,
                            "mesh": list(ep_mesh.shape)}
        say(f"dlrm-rm2 lookup_stacked, {rcell.dims['batch']} rows x "
            f"{rcfg.n_sparse} tables of {rcfg.table_rows} x {rcfg.embed_dim} "
            f"under recsys_ep on {tuple(ep_mesh.shape)}: bitwise the plain "
            f"gather; ms EP {ep_ms:.2f} (first), {ep_again_ms:.2f} (again), "
            f"plain {plain_ms:.2f}")
        del dt, di, got, plain
        gc.collect()
        torch.cuda.empty_cache()
        if world == 1:
            say("mesh: pipeline_2stage, the process-group compressed "
                "all-reduce and the elastic restore need 2 cards: they ran in "
                "tests/test_torch_distribution.py on gloo ranks and in the "
                "4-card run of PERF.md")
        else:
            out.update(mesh_cross_card(rank, world, seed, tmp, dev, say, timed,
                                       full, np, torch))
        launched = {k: v for k, v in K.LAUNCHES.items() if v}
        if launched:
            raise AssertionError(f"the mesh phase launched B kernels: {launched}")
        out["launches"] = launched
    finally:
        M.shutdown_world()
    return out


def mesh_cross_card(rank, world, seed, tmp, dev, say, timed, full, np,
                    torch) -> dict:
    """The mesh phase's checks that exist only across cards."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding as shlib
    from repro_torch.distributed.pipeline import pipeline_2stage
    from repro_torch.launch import mesh as M
    out = {}
    # pipeline: 2 stages over "pod", the layers as the sequential loop
    n_layers, width, n_micro, rows = MESH_PIPE
    pmesh = M.make_host_mesh((2, world // 2), ("pod", "data"))
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 9)
    ws = torch.randn((n_layers, width, width), generator=g, device=dev) / width ** 0.5
    x = torch.randn((n_micro, rows, width), generator=g, device=dev)

    def layer(w, h):
        return torch.tanh(h @ w)
    got, first_ms = timed(lambda: pipeline_2stage(layer, ws, x, pmesh))
    _, pipe_ms = timed(lambda: pipeline_2stage(layer, ws, x, pmesh))

    def sequential(h):             # one microbatch, the stages' shapes
        for li in range(n_layers):
            h = layer(ws[li], h)
        return h
    ref = torch.stack([sequential(xm) for xm in x])
    if not torch.equal(got, ref):
        raise AssertionError(f"mesh: pipeline_2stage differs from the "
                             f"sequential layers by {(got - ref).abs().max()}")
    _, seq_ms = timed(lambda: [sequential(xm) for xm in x])
    out["pipeline"] = {"layers": n_layers, "width": width, "micro": n_micro,
                       "rows": rows, "first_ms": first_ms, "ms": pipe_ms,
                       "sequential_ms": seq_ms}
    say(f"pipeline_2stage on (2, {world // 2}) ('pod', 'data'): {n_layers} "
        f"layers of {width} x {width}, {n_micro} microbatches of {rows}: "
        f"bitwise the sequential layers; ms {first_ms:.1f} (first), "
        f"{pipe_ms:.1f} (again), sequential on one card {seq_ms:.1f}")
    # the compressed all-reduce: process group against the list form
    xs = [torch.as_tensor(np.random.default_rng([seed, r]).standard_normal(
        MESH_AR_FLOATS, dtype=np.float32), device=dev) for r in range(world)]
    (red, res), first_ms = timed(lambda: C.compressed_allreduce_flat_group(
        xs[rank], None, 8))
    _, ar_ms = timed(lambda: C.compressed_allreduce_flat_group(xs[rank], None, 8))
    reds, resids = C.compressed_allreduce_flat(xs, 8)
    if not (torch.equal(red, reds[rank]) and torch.equal(res, resids[rank])):
        raise AssertionError("mesh: the process-group compressed all-reduce "
                             "differs from the list form")
    out["allreduce"] = {"floats": MESH_AR_FLOATS, "first_ms": first_ms,
                        "ms": ar_ms,
                        "wire_bytes": C.wire_bytes(MESH_AR_FLOATS, world, 8)}
    say(f"compressed_allreduce_flat_group, int8, {MESH_AR_FLOATS} floats a "
        f"rank over {world} ranks: bitwise the list form; ms {first_ms:.1f} "
        f"(first), {ar_ms:.1f} (again)")
    del xs, reds, resids
    # the elastic restore: saved by every rank, restored onto half of them
    from torch.distributed.tensor import Replicate, Shard
    full_x = torch.arange(world * 4 * 64, dtype=torch.float32,
                          device=dev).reshape(world * 4, 64)
    wmesh = M.make_host_mesh((world, 1))
    half = M.make_host_mesh((world // 2, 1))
    ck = Checkpointer(os.path.join(tmp, "elastic"))
    ck.save(1, {"x": shlib.from_full(full_x, wmesh, (Shard(0), Replicate()))},
            {"cursor": 5})
    state, step, extra = ck.restore(
        {"x": full_x}, shardings={"x": (half, (Shard(0), Replicate()))})
    if state["x"] is not None:
        if not (torch.equal(state["x"].full_tensor(), full_x) and step == 1
                and extra == {"cursor": 5}):
            raise AssertionError("mesh: the elastic restore differs")
    out["elastic"] = {"saved_by": world, "restored_by": world // 2}
    say(f"checkpoint saved by {world} ranks, restored onto {world // 2}: equal")
    return out


def mesh_phase(seed, smi, np, torch) -> dict:
    """The mesh phase (module docstring), last: one rank a card, spawned,
    with 2 or more cards, else a world of 1 here."""
    import tempfile

    import torch.multiprocessing as tmp_mp

    from repro_torch.launch.mesh import free_port
    if "lm_batch" not in MESH_INPUTS:           # the phase run alone
        from repro_torch import configs
        spec = configs.get(TRAIN_LM)
        cell = spec.shapes["train_4k"]
        from repro_torch.data.pipeline import lm_batch_iter
        MESH_INPUTS["lm_batch"] = lm_batch_iter(
            train_lm_store(seed, spec.make_config(), np), TRAIN_LM_BATCH,
            cell.dims["seq"])(0)[0]
    batch = MESH_INPUTS["lm_batch"]
    world = torch.cuda.device_count()
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
    log(f"== mesh: world {world if world >= 2 else 1}; {smi}")
    with tempfile.TemporaryDirectory() as tmp:
        if world >= 2:
            gc.collect()
            torch.cuda.empty_cache()
            tmp_mp.spawn(_mesh_rank, args=(world, free_port(), src, seed,
                                           batch, tmp), nprocs=world,
                         join=True)
            with open(os.path.join(tmp, "mesh.json")) as f:
                return json.load(f)
        return mesh_work(0, 1, free_port(), seed, batch, tmp, np, torch)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--n-docs", type=int, default=GOV2_DOCS)
    args = ap.parse_args()

    root = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(root, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        log(f"FAIL: {src}/repro_torch not found: run from a checkout of the repo")
        return 2
    sys.path.insert(0, src)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is False: this smoke needs a GPU")
        return 2

    from repro_torch.data import synth
    from repro_torch.index.engine import QueryBatch, QueryEngine
    from repro_torch import kernels as K
    from repro_torch.index.invindex import Generation, InvertedIndex
    from repro_torch.index.scores import bm25_scores, topk_select
    from repro_torch.core import codec as codec_lib
    from repro_torch.core import group_pfd
    from repro_torch.core.bits import ebw_np, from_np, to_np
    from repro_torch.core.dgap import dgap_encode_np
    from repro_torch.kernels import (accumulate, bitpack, cuda_build,
                                     decode_fused, intersect,
                                     intersect_rounds, ops, pfd_decode,
                                     quadmax, scan_add, topk, unpack_delta)
    from repro_torch.kernels.bitpack import FRAME_INTS
    from repro_torch.kernels.decode_fused import BW_BUCKETS, rows_per_block
    from repro_torch.obs.trace import enable_tracing
    sys.path.insert(0, os.path.join(root, "tools"))
    import and_round_forms as forms

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    phase_s = {}
    mark = [t_start]

    def phase_done(name):
        """Print and keep the seconds since the previous phase ended."""
        now = time.perf_counter()
        phase_s[name] = now - mark[0]
        mark[0] = now
        log(f"-- phase {name}: {phase_s[name]:.1f} s")

    # ---- card ------------------------------------------------------------ #
    smi = run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"])
    log("== card")
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()} python {sys.version.split()[0]}")
    log(run_cmd([cuda_build.nvcc(), "--version"]).splitlines()[-1])

    # ---- build ------------------------------------------------------------ #
    log("== build")
    t_build = time.perf_counter()
    # the kernels and the AND round's earlier forms (tools/and_round_forms.cu,
    # timed beside B1 and B2 bits on the captured calls) build while this
    # process makes the corpus and the index; joined before the first
    # tensor goes to the card
    nvcc_pool = concurrent.futures.ThreadPoolExecutor(2)

    def timed_build(fn, *a, **kw):
        res = fn(*a, **kw)
        return res, time.perf_counter()

    forms_build = nvcc_pool.submit(timed_build, forms.build)
    kernels_build = nvcc_pool.submit(timed_build, cuda_build.build,
                                     verbose=True)

    # ---- main path -------------------------------------------------------- #
    phase_done("card and build")
    log("== main path: fused device-resident AND")
    if args.n_docs != GOV2_DOCS:
        log(f"reduced: n_docs={args.n_docs} of GOV2's {GOV2_DOCS}")
    # the ranked path's `or` oracles (a dense pass over every doc a query)
    # are computed by worker processes, each making the same corpus from
    # the seed, while the index builds; the batches start after them
    oracle_pool = concurrent.futures.ProcessPoolExecutor(
        ORACLE_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=_oracle_init, initargs=(src, args.seed, args.n_docs))
    # one build worker makes, in turn, the codecs phase's Group-PFD
    # index (about as long as the main path's build), the sharded phase's
    # SHARDS shard generations (about 80 s of shard_generation) and the
    # recsys_gnn phase's EGNN minibatch_lg graph and its sampled subgraph
    # (about 90 s): host work, each done long before its phase, in one
    # process so that it takes one core beside the oracle workers
    build_pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    pfd_job = build_pool.submit(_pfd_build_task, src, args.seed, args.n_docs)
    shard_job = build_pool.submit(_shard_build_task, src, args.seed,
                               args.n_docs, SHARDS)
    from repro_torch.configs.egnn import SHAPES as EGNN_SHAPES
    mb = EGNN_SHAPES["minibatch_lg"].dims
    graph_job = build_pool.submit(_graph_task, src, args.seed,
                               mb["graph_nodes"], mb["graph_edges"],
                               mb["batch_nodes"], mb["fanout"])
    t0 = time.perf_counter()
    doclen, postings = synth.make_corpus("gov2", seed=args.seed,
                                         n_docs=args.n_docs)
    n_post = sum(len(v[0]) for v in postings.values())
    log(f"corpus: {args.n_docs} docs, {len(postings)} terms, {n_post} "
        f"postings in {time.perf_counter() - t0:.2f} s")
    terms = sorted(postings)
    rrng = np.random.default_rng(args.seed + 5)
    # three batches a ranked mode (warm-up, timed, traced), drawn in the
    # order the ranked path serves them
    ranked_q = {m: [[rrng.choice(terms[:QUERY_TERMS],
                                 size=rrng.integers(2, 4),
                                 replace=False).tolist()
                     for _ in range(QUERIES)] for _ in range(3)]
                for m in ("or", "and_scored")}
    or_jobs = [[oracle_pool.submit(_oracle_or_task, qs[i:i + 32])
                for i in range(0, len(qs), 32)] for qs in ranked_q["or"]]
    t0 = time.perf_counter()
    idx = InvertedIndex.build(doclen, postings)
    n_blocks = sum(len(tp.blocks) for tp in idx.terms.values())
    log(f"InvertedIndex.build: {n_blocks} blocks in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    (took, t_k), (forms_lib, t_f) = (kernels_build.result(),
                                      forms_build.result())
    nvcc_pool.shutdown()
    log(f"built {sorted(took)} and tools/and_round_forms.cu in "
        f"{max(t_k, t_f) - t_build:.2f} s (parallel nvcc, beside the corpus "
        f"and the index build); waited {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    eng = QueryEngine(idx, cache_blocks=1 << 22).to_device(fused=True)
    torch.cuda.synchronize()
    ar = eng.arena
    log(f"to_device(fused=True): {time.perf_counter() - t0:.2f} s, "
        f"{len(ar.dense_slot)} dense windows, fused tiles per bw "
        f"{ {bw: len(pk['n']) for bw, pk in ar._pk.items()} }")

    rng = np.random.default_rng(args.seed + 3)

    def draw_batch():
        """QUERIES AND queries of 2-3 terms from the 120 most frequent, with
        the oracle's answers."""
        qs = [rng.choice(terms[:QUERY_TERMS], size=rng.integers(2, 4),
                         replace=False).tolist() for _ in range(QUERIES)]
        return qs, [oracle_and(postings, q, np) for q in qs]

    def check(what, queries, got, want):
        for q, a, b in zip(queries, got, want):
            if not np.array_equal(a, b):
                raise AssertionError(f"{what}, query {q}: {len(a)} docids, "
                                     f"oracle {len(b)}")

    def run_batch(queries):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.execute(eng.plan(QueryBatch(queries, mode="and")))
        return res, time.perf_counter() - t0

    t0 = time.perf_counter()
    (warm_q, warm_want), (queries, want), (traced_q, traced_want) = (
        draw_batch(), draw_batch(), draw_batch())
    log(f"numpy oracle, 3 batches: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    for jobs in or_jobs:
        concurrent.futures.wait(jobs)
    log(f"the ranked path's `or` oracles ({ORACLE_WORKERS} worker processes, "
        f"beside the build) done; waited {time.perf_counter() - t0:.2f} s")
    # each AND batch's largest B1 call per bit width and largest B2 bits
    # call per round kind, kept from the warm-up batches for the kernel phase
    and_caps = {"and": {}, "and_scored": {}}
    with eng.metrics.scoped() as all_batches:
        with forms.capture_and_rounds(intersect_rounds, accumulate,
                                      and_caps["and"]):
            warm, dt = run_batch(warm_q)
        log(f"warm-up batch (cold caches): {dt:.2f} s")
        check("warm-up batch", warm_q, warm, warm_want)
        forms.check_captures(and_caps["and"], "and warm-up batch")

        # the main path: a fresh batch (block cache warm, round memo cold)
        fused0 = ar.stats["fused_blocks"]
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        with eng.metrics.scoped() as s:
            res, dt = run_batch(queries)
        launches = dict(K.LAUNCHES)
        recent = list(K.RECENT)
        peak = torch.cuda.max_memory_allocated()
        check("timed batch", queries, res, want)
        stats = {n: s.delta(n) for n in ("resident_rounds", "cand_syncs",
                                         "final_syncs", "worklist_refs",
                                         "worklist_decodes", "blocks_dense")}
        fused_entries = ar.stats["fused_blocks"] - fused0
        widths = bucketed_widths(recent)
        log(f"timed fresh batch: {QUERIES} queries in {dt:.4f} s = "
            f"{QUERIES / dt:.2f} qps (host clock, ends in the result copy)")
        log(f"rounds {stats['resident_rounds']}, worklist_refs "
            f"{stats['worklist_refs']}, fused entries {fused_entries}, dense "
            f"entries {stats['blocks_dense']}, decodes "
            f"{stats['worklist_decodes']}")
        log(f"launches {launches}; max_memory_allocated {peak} bytes "
            f"({peak / 2**30:.2f} GiB); mean result size "
            f"{np.mean([len(r) for r in res]):.1f}")
        for k in ("B1", "B2"):
            ex, p2 = widths["exact"][k], widths["pow2"][k]
            log(f"{k} launch width: {ex} entries in "
                f"{sum(1 for n, _ in recent if n == k)} launches; "
                f"power-of-two buckets would launch {p2} "
                f"(padded share {(p2 - ex) / p2:.4f}); padded share now 0")
        if widths["exact"]["B1"] != fused_entries:
            raise AssertionError(f"B1 launched {widths['exact']['B1']} "
                                 f"entries for {fused_entries} fused entries")
        if stats["cand_syncs"] != 0 or stats["final_syncs"] != 1:
            raise AssertionError(f"syncs: {stats}")
        if launches["B1"] <= 0 or launches["B2"] <= 0:
            raise AssertionError(f"main path did not launch B1 and B2: "
                                 f"{launches}")
        main_launches = launches

        # the same batch again: the round memo now holds its stacked rows
        with eng.metrics.scoped() as s:
            again, dt_again = run_batch(queries)
        check("repeated batch", queries, again, want)
        log(f"repeated batch: {QUERIES / dt_again:.2f} qps ({dt_again:.4f} s)")
        if s.delta("worklist_decodes") != 0:
            raise AssertionError("the repeated batch decoded again: "
                                 f"{s.delta('worklist_decodes')}")

        # where a fresh batch's time goes: the span tracer on and fenced
        # (each round span waits for the card), not timed
        tracer = enable_tracing(True, fenced=True)
        tracer.clear()
        traced, dt_traced = run_batch(traced_q)
        enable_tracing(False)
        check("traced batch", traced_q, traced, traced_want)
    # the fresh batches and their oracles, served again by the codecs phase
    fresh = {"and": ((queries, want), (traced_q, traced_want))}
    spans = span_breakdown(tracer, ("and/seed", "and/round",
                                    "kernel/extract_ids"))
    log(f"fenced span breakdown of another fresh batch ({dt_traced:.4f} s):")
    for name, (n, tot) in sorted(spans.items(), key=lambda kv: -kv[1][1]):
        log(f"  {name:24s} x{n:<3d} {tot:10.2f} ms")
    tracer.clear()
    hot = {k for k in eng.cache.keys() if k[1] >= 0}
    decodes = (all_batches.delta("worklist_decodes")
               + all_batches.delta("fallback_decodes"))
    log(f"decodes over the 4 batches: {decodes} for {len(hot)} hot blocks")
    if eng.cache.evictions or decodes != len(hot):
        raise AssertionError(f"decodes per hot block: {decodes} decodes "
                             f"for {len(hot)} hot blocks, "
                             f"{eng.cache.evictions} evictions")

    # ---- legacy path ------------------------------------------------------ #
    phase_done("AND path")
    log("== legacy and_many (kernel B5)")
    sub = queries[:LEGACY_QUERIES]
    K.reset_launches()
    t0 = time.perf_counter()
    legacy = eng.and_many(sub)
    dt_legacy = time.perf_counter() - t0
    legacy_launches = K.LAUNCHES["B5"]
    recent += list(K.RECENT)
    check("and_many", sub, legacy, want)
    log(f"and_many: {len(sub)} queries in {dt_legacy:.3f} s, launches "
        f"{dict(K.LAUNCHES)}")
    if legacy_launches <= 0:
        raise AssertionError("legacy path did not launch B5")

    # ---- ranked path ------------------------------------------------------ #
    phase_done("legacy")
    log("== ranked path: fused device-resident top-k (or, and_scored)")
    t0 = time.perf_counter()
    ar.ensure_scores()
    torch.cuda.synchronize()
    sa = ar.scores
    log(f"ensure_scores: {time.perf_counter() - t0:.2f} s, "
        f"{sa.tiles.shape[0]} score rows, {len(sa.dense_slot)} dense code "
        f"windows, delta {sa.delta!r}")
    t0 = time.perf_counter()
    avdl = float(np.asarray(doclen).mean())       # Generation.avdl's formula
    term_sc = {t: (postings[t][0],
                   bm25_scores(postings[t][1], doclen[postings[t][0]],
                               len(postings[t][0]), len(doclen), avdl))
               for t in terms[:QUERY_TERMS]}
    log(f"oracle term scores: {time.perf_counter() - t0:.2f} s")

    def draw_ranked(mode, i):
        """Batch ``i`` of QUERIES ranked queries shaped like the AND
        batches, with the oracle's answers."""
        qs = ranked_q[mode][i]
        if mode == "or":
            want = [r for f in or_jobs[i] for r in f.result()]
        else:
            want = [oracle_and_scored(postings, term_sc, q, RANKED_K, np,
                                      topk_select) for q in qs]
        return qs, want

    def check_ranked(what, queries, got, want):
        for q, a, b in zip(queries, got, want):
            if a != b:
                raise AssertionError(f"{what}, query {q}: {a[:3]}..., "
                                     f"oracle {b[:3]}...")

    def run_ranked(queries, mode):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.execute(eng.plan(QueryBatch(queries, mode=mode,
                                              k=RANKED_K)))
        return res, time.perf_counter() - t0

    ranked = {}
    # each mode's largest B2-add and B4 calls, kept from its warm-up batch
    # for the kernel phase
    captured = {"B2add": {}, "B4": {}}
    warm_dense = {}             # each warm-up batch's dense blocks
    for mode in ("or", "and_scored"):
        t0 = time.perf_counter()
        (warm_q, warm_want), (rq, rwant), (traced_q, traced_want) = (
            draw_ranked(mode, 0), draw_ranked(mode, 1), draw_ranked(mode, 2))
        log(f"{mode}: numpy oracle, 3 batches: "
            f"{time.perf_counter() - t0:.2f} s")
        torch.cuda.reset_peak_memory_stats()
        with keep_largest(topk, "_scatter",
                          captured["B2add"].setdefault(mode, {}),
                          lambda acc, member, ids, qslot, codes, surv: (
                              ids.shape[0], {"ids": ids, "qslot": qslot,
                                             "codes": codes, "surv": surv,
                                             "Q": acc.shape[0],
                                             "width": acc.shape[1]})), \
                keep_largest(accumulate, "dense_add_packed",
                             captured["B4"].setdefault(mode, {}),
                             lambda acc, tiles, win, qslot, col0, act, *,
                             gated: (tiles.shape[0], {
                                 "tiles": tiles, "win": win, "qslot": qslot,
                                 "col0": col0, "act": act, "gated": gated,
                                 "Q": acc.shape[0],
                                 "width": acc.shape[1]})), \
                (forms.capture_and_rounds(intersect_rounds, accumulate,
                                          and_caps[mode])
                 if mode in and_caps else contextlib.nullcontext()), \
                eng.metrics.scoped() as ws:
            warm, dt = run_ranked(warm_q, mode)
        warm_dense[mode] = ws.delta("blocks_dense")
        log(f"{mode} warm-up batch: {dt:.2f} s")
        check_ranked(f"{mode} warm-up batch", warm_q, warm, warm_want)
        if mode in and_caps:
            forms.check_captures(and_caps[mode], f"{mode} warm-up batch")
        # the kernel phase replays these captures: an empty one means the
        # hook fell off the call path
        if not captured["B2add"][mode]:
            raise AssertionError(f"{mode}: no B2-add call captured")
        if warm_dense[mode] > 0 and not captured["B4"][mode]:
            raise AssertionError(f"{mode}: {warm_dense[mode]} dense blocks "
                                 f"but no dense_add_packed call captured")

        fused0 = ar.stats["fused_blocks"]
        K.reset_launches()
        with eng.metrics.scoped() as s:
            res, dt = run_ranked(rq, mode)
        launches = dict(K.LAUNCHES)
        rrecent = list(K.RECENT)
        peak = torch.cuda.max_memory_allocated()
        check_ranked(f"{mode} timed batch", rq, res, rwant)
        stats = {n: s.delta(n) for n in (
            "final_syncs", "score_syncs", "cand_syncs", "score_rounds",
            "blocks_scored", "blocks_pruned", "blocks_dense",
            "resident_rounds", "worklist_decodes", "fallback_decodes")}
        widths = {k: sum(sh.get("W", sh.get("P", 0)) for n, sh in rrecent
                         if n == k) for k in launches}
        log(f"{mode} timed fresh batch: {QUERIES} queries in {dt:.4f} s = "
            f"{QUERIES / dt:.2f} qps (host clock, ends in the rescore)")
        log(f"{mode} counters {stats}; fused entries "
            f"{ar.stats['fused_blocks'] - fused0}")
        log(f"{mode} launches {launches}; entries per kernel {widths}")
        log(f"{mode} max_memory_allocated {peak} bytes "
            f"({peak / 2**30:.2f} GiB) over the warm-up and timed batches")
        if (stats["final_syncs"] != 1 or stats["score_syncs"] != 0
                or stats["cand_syncs"] != 0):
            raise AssertionError(f"{mode} syncs: {stats}")
        for k in ("B1", "B2", "B2add", "B3"):
            if launches[k] <= 0:
                raise AssertionError(f"{mode} did not launch {k}: {launches}")
        if stats["blocks_dense"] > 0 and launches["B4"] <= 0:
            raise AssertionError(f"{mode} scored dense blocks without B4: "
                                 f"{launches}")
        b4_forms = [sh["packed"] for n, sh in rrecent if n == "B4"]
        if not all(b4_forms) or len(b4_forms) > stats["score_rounds"]:
            raise AssertionError(f"{mode}: B4 must run packed, at most once "
                                 f"a round: {len(b4_forms)} launches, packed "
                                 f"{b4_forms}, {stats['score_rounds']} rounds")

        tracer = enable_tracing(True, fenced=True)
        tracer.clear()
        traced, dt_traced = run_ranked(traced_q, mode)
        enable_tracing(False)
        check_ranked(f"{mode} traced batch", traced_q, traced, traced_want)
        spans = span_breakdown(tracer, ("and/seed", "and/round",
                                        "ranked/round", "kernel/topk",
                                        "kernel/extract_ids",
                                        "ranked/rescore"))
        tracer.clear()
        log(f"{mode} fenced span breakdown of another fresh batch "
            f"({dt_traced:.4f} s):")
        for name, (n, tot) in sorted(spans.items(), key=lambda kv: -kv[1][1]):
            log(f"  {name:24s} x{n:<3d} {tot:10.2f} ms")
        fresh[mode] = ((rq, rwant), (traced_q, traced_want))
        ranked[mode] = {"qps": QUERIES / dt, "seconds": dt, "stats": stats,
                        "launches": launches, "recent": rrecent,
                        "peak_bytes": peak,
                        "spans_ms": {n: v[1] for n, v in spans.items()}}
        del warm, res, traced

    # shapes the main paths gave each kernel: B1 and B2's bits form run on
    # the AND path and on both ranked modes, B5 on the legacy path
    paths = {"and": recent, **{m: v["recent"] for m, v in ranked.items()}}
    calls = {k: [(path, sh) for path, rec in paths.items() for n, sh in rec
                 if n == k] for k in ("B1", "B2", "B5")}
    rcalls = {k: [sh for m in ranked.values() for n, sh in m["recent"]
                  if n == k] for k in ("B2add", "B3", "B4")}
    ranked_launches = {k: {m: v["launches"][k] for m, v in ranked.items()}
                       for k in ("B1", "B2", "B2add", "B3", "B4")}
    n_docs = idx.n_docs
    del eng, ar, sa, again, legacy, term_sc, or_jobs
    gc.collect()        # the main engine's caches go; its arenas stay on idx
    torch.cuda.empty_cache()

    # ---- mutation epochs -------------------------------------------------- #
    phase_done("ranked path")
    # ---- serving loop, on the main path's arenas -------------------------- #
    serve = serve_phase(idx.gen, fresh, root, args.seed, smi, np, torch)

    # ---- mutation epochs -------------------------------------------------- #
    phase_done("serve")
    # the unmutated generation's host tables, kept for the sharded and
    # examples phases; a fresh handle, so its device arenas stay with idx
    # and go when the mutation phase compacts it away
    g = idx.gen
    gen0 = Generation(g.codec, g.terms, g.n_docs, g.doclen, g.gid)
    del g
    try:
        mut = mutation_phase(idx, doclen, postings, terms, args.seed,
                             oracle_pool, np, torch)
    finally:
        oracle_pool.shutdown()
    mcaps = mut.pop("captured")
    del idx
    gc.collect()        # free the arenas before the kernel phase
    torch.cuda.empty_cache()

    # ---- stream codec path ------------------------------------------------ #
    phase_done("mutation epochs")
    log("== stream codec path: select_bw, pack, fused and two-pass decode "
        "(B6-B10)")
    t0 = time.perf_counter()
    lists = []                  # (docids, gaps, numpy's per-frame widths)
    for t in terms:
        ids = postings[t][0]
        gaps = dgap_encode_np(ids)
        f = -(-len(gaps) // FRAME_INTS)
        tiles = np.zeros(f * FRAME_INTS, np.uint32)
        tiles[:len(gaps)] = gaps
        lists.append((ids, gaps, np.maximum(ebw_np(np.bitwise_or.reduce(
            tiles.reshape(f, -1), axis=1)), 1)))
    n_stream = sum(len(ids) for ids, _, _ in lists)
    log(f"numpy d-gaps and widths of {len(lists)} lists, {n_stream} "
        f"postings: {time.perf_counter() - t0:.2f} s")

    def same(what, got, want):
        if not np.array_equal(to_np(got), want):
            raise AssertionError(f"stream phase, {what}: differs from numpy")

    K.reset_launches()
    t0 = time.perf_counter()
    packed_all, packed_words = [], 0
    for i, (ids, gaps, want_bws) in enumerate(lists):
        g = from_np(gaps, dev)
        same(f"list {i} select_bw", ops.select_bw(g), want_bws)
        bw, n = int(want_bws.max()), len(ids)
        packed = ops.pack_stream(g, bw)
        same(f"list {i} fused decode", ops.unpack_delta_stream(packed, bw, n),
             ids)
        back = ops.unpack_stream(packed, bw, n)
        same(f"list {i} unpack", back, gaps)
        same(f"list {i} two-pass decode", ops.prefix_sum(back), ids)
        packed_all.append((packed, bw, n))
        packed_words += packed.numel()
    a, b = sorted((ids for ids, _, _ in lists), key=len)[-2:]
    both = intersect.bitmap_intersect_np(a, b, use_pallas=True)
    if not np.array_equal(both, np.intersect1d(a, b)):
        raise AssertionError("bitmap_intersect_np(use_pallas=True) differs "
                             "from np.intersect1d")
    torch.cuda.synchronize()
    dt_stream = time.perf_counter() - t0
    stream_launches = {k: K.LAUNCHES[k] for k in
                       ("B6", "B7a", "B7b", "B8", "B9", "B10")}
    scalls = {k: [sh for n_, sh in K.RECENT if n_ == k]
              for k in stream_launches}
    log(f"{len(lists)} lists encoded and decoded both ways, all equal to "
        f"numpy, and the intersection of the two longest ({len(a)}, "
        f"{len(b)} postings: {len(both)} docids) equal to np.intersect1d, "
        f"in {dt_stream:.2f} s; launches {stream_launches}")
    log(f"packed size {packed_words * 32 / n_stream:.4f} bits per posting "
        f"(list widths {min(bw for _, bw, _ in packed_all)}-"
        f"{max(bw for _, bw, _ in packed_all)})")
    if min(stream_launches.values()) <= 0:
        raise AssertionError(f"stream phase missed a kernel: "
                             f"{stream_launches}")

    def decode_all(fused):
        for packed, bw, n in packed_all:
            if fused:
                ops.unpack_delta_stream(packed, bw, n)
            else:
                ops.prefix_sum(ops.unpack_stream(packed, bw, n))

    decode = {}
    for form, fused in (("fused", True), ("two_pass", False)):
        decode_all(fused)
        times = []
        for _ in range(DECODE_RUNS):
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            decode_all(fused)
            ev1.record()
            ev1.synchronize()
            times.append(ev0.elapsed_time(ev1))
        times.sort()
        ms = times[len(times) // 2]
        decode[form] = {"ms": ms, "postings_per_s": n_stream / ms * 1e3,
                        "runs_ms": times}
        log(f"whole-corpus {form} decode: {n_stream} postings of "
            f"{len(lists)} lists in {ms:.4f} ms (median of {DECODE_RUNS}, "
            f"CUDA events, warm, host enqueue included) = "
            f"{n_stream / ms * 1e3:.4e} postings/s; {smi}")
    stream = {"seconds": dt_stream, "launches": stream_launches,
              "postings": n_stream, "lists": len(lists),
              "bits_per_posting": packed_words * 32 / n_stream,
              "decode": decode}
    del packed_all, lists, a, b, both

    # ---- codecs ----------------------------------------------------------- #
    phase_done("stream path")
    # the codecs and sharded phases replay the first REPLAY_QUERIES of each
    # of the main path's fresh batches (a depth cut: PERF.md, Cells)
    replay = {m: tuple((qs[:REPLAY_QUERIES], want[:REPLAY_QUERIES])
                       for qs, want in pair) for m, pair in fresh.items()}
    codecs, pfd_lists = codecs_phase(pfd_job, postings, replay, src, smi, np,
                                     torch)
    del postings, pfd_job
    gc.collect()
    torch.cuda.empty_cache()

    # ---- doc-range shards ------------------------------------------------- #
    phase_done("codecs")
    # the examples phase's subprocesses start here: the shard build ahead
    # is host work of this process alone, about twice their run time
    ex_procs = start_examples(root)
    try:
        sharded = sharded_phase(gen0, shard_job, replay, smi, np, torch)
        del shard_job

        # ---- examples and the one-shot shims ------------------------------ #
        phase_done("sharded")
        examples = examples_phase(ex_procs, gen0, fresh, smi, np)
    finally:
        for p in ex_procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    del fresh, replay, gen0
    gc.collect()
    torch.cuda.empty_cache()

    # ---- kernels ---------------------------------------------------------- #
    phase_done("examples")
    def kernel_phase() -> list:
        """The kernel phase (module docstring); returns its report.  A
        function of its own, so that every device tensor it makes is
        freed when it returns, before the lm phase."""
        log("== kernels vs plain versions (bitwise)")
        log(f"memory_allocated {torch.cuda.memory_allocated()} bytes at the start")
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed)

        def rand_words(shape):
            return torch.randint(-2**31, 2**31, shape, generator=gen, device=dev,
                                 dtype=torch.int64).to(torch.int32)

        def rand_int(hi, n):
            return torch.randint(0, hi, (n,), generator=gen, device=dev,
                                 dtype=torch.int64).to(torch.int32)

        report = []

        def decode_case(bw, w, n_tiles, q, crows, with_q):
            rpb = rows_per_block(bw)
            tiles = rand_words((n_tiles * rpb, 128))
            slots = rand_int(n_tiles, w)
            qslots = torch.sort(rand_int(q, w)).values if with_q else None
            firsts = rand_int(n_docs, w)
            ns = torch.where(rand_int(8, w) == 0, rand_int(513, w),
                             torch.full((w,), 512, dtype=torch.int32, device=dev))
            cand = rand_words((q * crows, 128))
            return tiles, slots, qslots, firsts, ns, cand

        # B1, every bw bucket, at the largest call any main path gave it, probed
        # against a random bitmap (as the AND rounds) and against all ones (the
        # `or` rounds' gate, where only lane validity masks a hit)
        per_bw, seen, b1_paths = {}, {}, {}
        for path, c in calls["B1"]:
            b1_paths.setdefault(c["bw"], set()).add(path)
            if c["bw"] not in seen or c["W"] > seen[c["bw"]][0]:
                seen[c["bw"]] = (c["W"], c["tiles"], c["Q"], c["crows"])
        w_max = max(v[0] for v in seen.values())
        _, _, q_main, crows_main = next(iter(seen.values()))
        for bw in BW_BUCKETS:
            w, n_tiles, q, crows = seen.get(bw, (w_max, w_max, q_main, crows_main))
            tiles, slots, qslots, firsts, ns, cand = decode_case(bw, w, n_tiles, q,
                                                                 crows, True)
            args_ = (tiles, slots, qslots, firsts, ns, cand)
            err = 0
            for gate in (cand, torch.full_like(cand, -1)):
                a = (tiles, slots, qslots, firsts, ns, gate)
                got = intersect_rounds.segmented_decode_and(*a, bw=bw, crows=crows)
                ref = intersect_rounds.segmented_decode_and_plain(*a, bw=bw,
                                                                  crows=crows)
                torch.cuda.synchronize()
                err = max(err, max_abs_err(got, ref, torch))
            # against all ones every valid lane hits and no other does
            n_hits = int(torch.count_nonzero(got[1]))
            if n_hits != int(ns.long().sum()):
                raise AssertionError(f"B1 bw={bw} all-ones gate: {n_hits} hits "
                                     f"for {int(ns.long().sum())} valid lanes")
            # bound: distinct tile rows, indices, probed words, outputs; sector
            # floor: 32 B a probed sector in place of 4 B a word
            counts = forms.b1_counts(slots, qslots, ns, ref[0].reshape(w, -1),
                                     bw, crows)
            nbytes = counts["bytes"]
            ms = cuda_ms(lambda: intersect_rounds.segmented_decode_and(
                *args_, bw=bw, crows=crows), torch)
            pms = cuda_ms(lambda: intersect_rounds.segmented_decode_and_plain(
                *args_, bw=bw, crows=crows), torch, runs=PLAIN_RUNS)
            per_bw[bw] = {"W": w, "queries": q, "crows": crows,
                          "on_main_path": bw in seen,
                          "paths": sorted(b1_paths.get(bw, ())), "max_abs_err": err,
                          "ms": ms, "plain_ms": pms, "bound_ms": bound_ms(nbytes),
                          "sector_floor_ms": bound_ms(counts["floor_bytes"]),
                          "bytes": nbytes, "counts": counts}
            log(f"B1 bw={bw:2d} W={w} Q={q} crows={crows}: err {err} (random and "
                f"all-ones gates) kernel {ms:.4f} ms plain {pms:.4f} ms bound "
                f"{bound_ms(nbytes):.4f} ms sector floor "
                f"{bound_ms(counts['floor_bytes']):.4f} ms; {counts}; paths "
                f"{', '.join(sorted(b1_paths.get(bw, ()))) or 'none'}")
            if err:
                raise AssertionError(f"B1 bw={bw} disagrees with its plain version")
            del tiles, cand, got, ref
        main_bw = max(seen, key=lambda b: seen[b][0])
        b1 = per_bw[main_bw]

        # B1 on each AND batch's captured calls (the largest of each bit width,
        # the real tiles, docids and candidate bitmap): against its plain
        # version and its earlier form (tools/and_round_forms.cu, a block an
        # entry), bitwise, then the two timed in turn
        b1_captured = {}
        for mode, caps in and_caps.items():
            for bw, cap in sorted(caps["B1"].items()):
                crows = cap["crows"]
                a = [None if cap[k] is None else cap[k].to(dev) for k in
                     ("tiles", "slots", "qslots", "firsts", "ns", "cand")]
                got = intersect_rounds.segmented_decode_and(*a, bw=bw,
                                                            crows=crows)
                ref = intersect_rounds.segmented_decode_and_plain(*a, bw=bw,
                                                                  crows=crows)
                old = forms.b1_block(forms_lib, 0, *a, bw, crows)
                torch.cuda.synchronize()
                err = max(max_abs_err(got, ref, torch),
                          max_abs_err(old, ref, torch))
                if err:
                    raise AssertionError(f"B1 bw={bw} on {mode}'s captured call "
                                         f"disagrees with its plain version or "
                                         f"its earlier form")
                counts = forms.b1_counts(a[1], a[2], a[4], ref[0].view(-1, 512),
                                         bw, crows)
                del got, ref, old
                t = in_turns({
                    "port": lambda: intersect_rounds.segmented_decode_and(
                        *a, bw=bw, crows=crows),
                    "earlier": lambda: forms.b1_block(forms_lib, 0, *a, bw,
                                                      crows)}, torch)
                r = b1_captured.setdefault(mode, {})[bw] = {
                    "max_abs_err": err, "ms": min(t["port"]),
                    "earlier_ms": min(t["earlier"]), "ms_in_turns": t,
                    "bound_ms": bound_ms(counts["bytes"]),
                    "sector_floor_ms": bound_ms(counts["floor_bytes"]),
                    "counts": counts}
                log(f"B1 bw={bw:2d} ({mode}'s captured call): err {err} kernel "
                    f"{t['port']} ms, earlier form {t['earlier']} ms in turns; "
                    f"bound {r['bound_ms']:.4f} ms sector floor "
                    f"{r['sector_floor_ms']:.4f} ms; {counts}")
                del a
                torch.cuda.empty_cache()
        # B1 on the tombstone `or` batch's largest call: it probes the epoch's
        # live row (1 % of the bits cleared) where the unmutated `or` rounds
        # probe all ones
        cap = mcaps["B1"]
        bw, crows = cap["bw"], cap["crows"]
        a = [cap[k].to(dev) for k in ("tiles", "slots", "qslots", "firsts", "ns",
                                      "cand")]
        got = intersect_rounds.segmented_decode_and(*a, bw=bw, crows=crows)
        ref = intersect_rounds.segmented_decode_and_plain(*a, bw=bw, crows=crows)
        torch.cuda.synchronize()
        err = max_abs_err(got, ref, torch)
        if err:
            raise AssertionError("B1 on the tombstone or batch's captured call "
                                 "disagrees with its plain version")
        counts = forms.b1_counts(a[1], a[2], a[4], ref[0].view(-1, 512), bw, crows)
        del got, ref
        b1_tomb = {"bw": bw, "W": int(a[1].shape[0]), "max_abs_err": err,
                   "ms": cuda_ms(lambda: intersect_rounds.segmented_decode_and(
                       *a, bw=bw, crows=crows), torch),
                   "plain_ms": cuda_ms(
                       lambda: intersect_rounds.segmented_decode_and_plain(
                           *a, bw=bw, crows=crows), torch, runs=PLAIN_RUNS),
                   "bound_ms": bound_ms(counts["bytes"]),
                   "sector_floor_ms": bound_ms(counts["floor_bytes"]),
                   "probe_bits_set": bit_share(a[5]),
                   "counts": counts}
        log(f"B1 bw={bw} (tombstone or batch's captured call, live-row probe, "
            f"{b1_tomb['probe_bits_set']:.4f} of its bits set): err {err} kernel "
            f"{b1_tomb['ms']:.4f} ms plain {b1_tomb['plain_ms']:.4f} ms bound "
            f"{b1_tomb['bound_ms']:.4f} ms sector floor "
            f"{b1_tomb['sector_floor_ms']:.4f} ms; {counts}")
        del a
        torch.cuda.empty_cache()
        report.append({
            "name": "segmented_decode_and (B1)", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_and.cu",
            "replaces": "src/repro/kernels/intersect_rounds.py:233",
            "launches": main_launches["B1"],
            "max_abs_err": max([v["max_abs_err"] for v in per_bw.values()]
                               + [b1_tomb["max_abs_err"]]),
            "ms": b1["ms"], "plain_ms": b1["plain_ms"], "bound_ms": b1["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "shape_bw": main_bw,
            "ranked_launches": ranked_launches["B1"], "per_bw": per_bw,
            "sector_floor_ms": b1["sector_floor_ms"], "captured": b1_captured,
            "captured_tombstone_or": b1_tomb,
            "mutation_launches": {w: r["launches"]["B1"]
                                  for w, r in mut["batches"].items()},
            "ok": True})

        # B5 at the legacy path's largest call
        c = max((sh for _, sh in calls["B5"]), key=lambda c: c["W"])
        bw, w, crows = c["bw"], c["W"], c["R"]
        tiles, slots, _, firsts, ns, cand = decode_case(bw, w, c["tiles"], 1,
                                                        crows, False)
        args_ = (tiles, slots, firsts, ns, cand)
        got = decode_fused.fused_decode_and(*args_, bw=bw)
        ref = decode_fused.fused_decode_and_plain(*args_, bw=bw)
        torch.cuda.synchronize()
        err = max_abs_err(got, ref, torch)
        counts = forms.b1_counts(slots, None, ns, ref[0].reshape(w, -1), bw,
                                 crows)
        nbytes = counts["bytes"]
        ms = cuda_ms(lambda: decode_fused.fused_decode_and(*args_, bw=bw), torch)
        pms = cuda_ms(lambda: decode_fused.fused_decode_and_plain(*args_, bw=bw), torch)
        old_ms = cuda_ms(lambda: forms.b1_block(forms_lib, 0, tiles, slots, None,
                                                firsts, ns, cand, bw, crows),
                         torch)
        log(f"B5 bw={bw} W={w} R={crows}: err {err} kernel {ms:.4f} ms (earlier "
            f"form {old_ms:.4f} ms) plain {pms:.4f} ms bound "
            f"{bound_ms(nbytes):.4f} ms sector floor "
            f"{bound_ms(counts['floor_bytes']):.4f} ms")
        if err:
            raise AssertionError("B5 disagrees with its plain version")
        report.append({
            "name": "fused_decode_and (B5)", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_and.cu",
            "replaces": "src/repro/kernels/decode_fused.py:111",
            "launches": legacy_launches, "path": "legacy and_many",
            "max_abs_err": err, "ms": ms, "plain_ms": pms,
            "bound_ms": bound_ms(nbytes), "bound_by": "bytes", "library_ms": None,
            "sector_floor_ms": bound_ms(counts["floor_bytes"]),
            "earlier_ms": old_ms, "counts": counts,
            "shape": {"bw": bw, "W": w, "R": crows}, "ok": True})
        del tiles, cand, got, ref

        def distinct_ids(q, p, lanes, width):
            """(qslot, ids) of p entries over q queries, sorted by query, with
            docids distinct within a query (the round contract): the k-th entry
            of a query takes docids (k * lanes + l) * step + offset."""
            qslot = torch.sort(rand_int(q, p)).values
            first_of = torch.searchsorted(qslot, qslot)
            rank = torch.arange(p, device=dev) - first_of
            n_max = int(torch.bincount(qslot.long(), minlength=q).max())
            step = max(1, width // (n_max * lanes))
            lane = torch.arange(lanes, device=dev)
            ids = ((rank[:, None] * lanes + lane[None, :]) * step
                   + (qslot.long()[:, None] * 7919) % step).to(torch.int32)
            return qslot, ids

        # B2 at the largest scatter of any main path
        b2_path, c = max(calls["B2"], key=lambda pc: pc[1]["P"])
        q, words, p, lanes = c["Q"], c["words"], c["P"], c["L"]
        qslot, ids = distinct_ids(q, p, lanes, words * 32)
        surv = torch.rand((p, lanes), generator=gen, device=dev) < 0.5
        bm = torch.zeros((q, words), dtype=torch.int32, device=dev)
        got = accumulate.scatter_bits(bm.clone(), ids, qslot, surv)
        ref = accumulate.scatter_bits_plain(bm.clone(), ids, qslot, surv)
        torch.cuda.synchronize()
        err = max_abs_err([got], [ref], torch)
        idl = ids.long()
        flat = (qslot.long()[:, None] * words + (idl >> 5))[surv]
        vals = torch.bitwise_left_shift(torch.ones_like(idl), idl & 31)[surv].to(torch.int32)
        counts = forms.bits_counts(q, words, ids, qslot, surv, 1)
        # a touched word is read and written: 8 B of read-modify-write; the
        # sector floor: 64 B a touched 32-byte sector, beside the same inputs
        inputs = p * lanes * 4 + p * lanes + p * 4
        nbytes = inputs + counts["touched_words"] * 8
        floor_ms = bound_ms(inputs + counts["touched_sectors"] * 64)
        ms = cuda_ms(lambda: accumulate.scatter_bits(bm, ids, qslot, surv), torch)
        pms = cuda_ms(lambda: accumulate.scatter_bits_plain(bm, ids, qslot, surv),
                      torch, runs=PLAIN_RUNS)
        lib_flat = bm.view(-1)
        lms = cuda_ms(lambda: lib_flat.index_put_((flat,), vals, accumulate=True),
                      torch, runs=PLAIN_RUNS)
        old_ms = cuda_ms(lambda: forms.bits_form(forms_lib, "flat", bm, ids,
                                                 qslot, surv), torch)
        log(f"B2 bits Q={q} words={words} P={p} L={lanes} ({b2_path} path): err "
            f"{err} kernel "
            f"{ms:.4f} ms (earlier form {old_ms:.4f} ms) plain {pms:.4f} ms "
            f"index_put_ {lms:.4f} ms bound {bound_ms(nbytes):.4f} ms sector "
            f"floor {floor_ms:.4f} ms; {counts}")
        if err:
            raise AssertionError("B2 bits form disagrees with its plain version")
        del bm, got, ref, flat, vals
        b2 = {"name": "scatter_bits (B2)", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/accumulate.cu",
              "replaces": "src/repro/kernels/accumulate.py:85",
              "launches": main_launches["B2"], "max_abs_err": err, "ms": ms,
              "plain_ms": pms, "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
              "library_ms": lms, "ranked_launches": ranked_launches["B2"],
              "sector_floor_ms": floor_ms, "earlier_ms": old_ms,
              "counts": counts,
              "shape": {"Q": q, "words": words, "P": p, "L": lanes},
              "shape_path": b2_path, "ok": True}

        # B2 bits on each AND batch's captured calls, the largest of each round
        # kind (seed: every posting of each query's rarest term; fused: B1's hit
        # words as the mask; probed: a plain round, where one ran): against its
        # plain version and its earlier form (tools/and_round_forms.cu, a thread
        # a lane from a flat index, on a bool mask), bitwise, then timed in
        # turn; in the fused round also the earlier round's scatter, the
        # `hits != 0` pass and the earlier form
        bits_captured = {}
        for mode, caps in and_caps.items():
            for kind, cap in sorted(caps["B2"].items()):
                cids, cq, csurv = (cap[k].to(dev) for k in ("ids", "qslot",
                                                              "surv"))
                alive = csurv != 0
                zero = torch.zeros((cap["Q"], cap["words"]), dtype=torch.int32,
                                   device=dev)
                got = accumulate.scatter_bits(zero.clone(), cids, cq, csurv)
                ref = accumulate.scatter_bits_plain(zero.clone(), cids, cq, csurv)
                old = forms.bits_form(forms_lib, "flat", zero.clone(), cids, cq,
                                      alive)
                torch.cuda.synchronize()
                err = max(max_abs_err([got], [ref], torch),
                          max_abs_err([old], [ref], torch))
                del got, ref, old
                if err:
                    raise AssertionError(f"B2 bits on {mode}'s captured {kind} "
                                         f"call disagrees with its plain version "
                                         f"or its earlier form")
                counts = forms.bits_counts(cap["Q"], cap["words"], cids, cq,
                                           csurv, csurv.element_size())
                fns = {"port": lambda: accumulate.scatter_bits(zero, cids, cq,
                                                               csurv),
                       "earlier": lambda: forms.bits_form(forms_lib, "flat", zero,
                                                          cids, cq, alive)}
                if csurv.dtype != torch.bool:
                    fns["pass_and_earlier"] = lambda: forms.bits_form(
                        forms_lib, "flat", zero, cids, cq, csurv != 0)
                t = in_turns(fns, torch)
                r = bits_captured.setdefault(mode, {})[kind] = {
                    "max_abs_err": err, "ms": min(t["port"]),
                    "earlier_ms": min(t["earlier"]), "ms_in_turns": t,
                    "mask": str(csurv.dtype).replace("torch.", ""),
                    "bound_ms": bound_ms(counts["bytes"]),
                    "sector_floor_ms": bound_ms(counts["floor_bytes"]),
                    "counts": counts}
                if "pass_and_earlier" in t:
                    r["pass_and_earlier_ms"] = min(t["pass_and_earlier"])
                log(f"B2 bits ({mode}'s captured {kind} call, {r['mask']} mask): "
                    f"err {err} in turns {t}; bound {r['bound_ms']:.4f} ms "
                    f"sector floor {r['sector_floor_ms']:.4f} ms; {counts}")
                del cids, cq, csurv, alive, zero
                torch.cuda.empty_cache()
        b2["captured"] = bits_captured
        b2["max_abs_err"] = max([b2["max_abs_err"]] + [
            r["max_abs_err"] for m in bits_captured.values() for r in m.values()])

        def accumulate_case(what, q, width, run, run_plain, flat, vals,
                            probes=None):
            """Run a kernel that adds ``vals`` at flat indices ``flat`` of a
            (q, width) accumulator, and its plain version, in turn on ONE
            zeroed accumulator (at GOV2 scale it is 256 x 25.2 M words), and
            compare them where they wrote; then time kernel, plain version,
            one ``index_put_(accumulate=True)`` on the precomputed indices and
            each of ``probes`` ({name: fn(acc)}) on the same accumulator.
            Returns a dict with the error, the times, and the distinct words
            and 32-byte sectors the targets touch."""
            acc = torch.zeros((q, width), dtype=torch.int32, device=dev)
            uniq = torch.unique(flat)
            run(acc)
            got = acc.view(-1)[uniq]
            # a write outside the targets leaves a non-zero word there; counted
            # per 8 rows, since a count over the whole accumulator widens it to
            # int64 (twice its 25.8 GB)
            nonzero = sum(int(torch.count_nonzero(acc[r:r + 8]))
                          for r in range(0, q, 8))
            if nonzero != int(torch.count_nonzero(got)):
                raise AssertionError(f"{what} wrote outside its targets")
            acc.zero_()
            run_plain(acc)
            ref = acc.view(-1)[uniq]
            torch.cuda.synchronize()
            err = max_abs_err([got], [ref], torch)
            del got, ref
            if err:
                raise AssertionError(f"{what} disagrees with its plain version")
            out = {"max_abs_err": err, "ms": cuda_ms(lambda: run(acc), torch),
                   "plain_ms": cuda_ms(lambda: run_plain(acc), torch,
                                       runs=PLAIN_RUNS)}
            acc_flat = acc.view(-1)
            out["library_ms"] = cuda_ms(lambda: acc_flat.index_put_(
                (flat,), vals, accumulate=True), torch, runs=PLAIN_RUNS)
            out["probes_ms"] = {name: cuda_ms(lambda: fn(acc), torch)
                                for name, fn in (probes or {}).items()}
            # width is a multiple of 8, so flat >> 3 is (row, column >> 3)
            out["touched"] = uniq.numel()
            out["sectors"] = torch.unique_consecutive(uniq >> 3).numel()
            del acc, acc_flat, uniq
            torch.cuda.empty_cache()
            return out

        # B2, add form, at the AND path's largest scatter shape, as first
        # recorded: entries into a (Q, docs) accumulator, full-range
        # contributions
        del ids, qslot, surv
        c = max((sh for path, sh in calls["B2"] if path == "and"),
                key=lambda c: c["P"])
        q, words, p, lanes = c["Q"], c["words"], c["P"], c["L"]
        width = words * 32
        qslot, ids = distinct_ids(q, p, lanes, width)
        contrib = rand_words((p, lanes))
        r = accumulate_case(
            "B2 add form", q, width,
            lambda a: accumulate.scatter_add(a, ids, qslot, contrib),
            lambda a: accumulate.scatter_add_plain(a, ids, qslot, contrib),
            (qslot.long()[:, None] * width + ids.long()).reshape(-1),
            contrib.reshape(-1))
        nbytes = 2 * p * lanes * 4 + p * 4 + r["touched"] * 8
        log(f"B2 add Q={q} width={width} P={p} L={lanes}: err {r['max_abs_err']} "
            f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms index_put_ "
            f"{r['library_ms']:.4f} ms bound {bound_ms(nbytes):.4f} ms")
        b2["add_form"] = {"launches_on_and_path": main_launches["B2add"],
                          "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                          "plain_ms": r["plain_ms"], "bound_ms": bound_ms(nbytes),
                          "library_ms": r["library_ms"],
                          "shape": {"Q": q, "width": width, "P": p, "L": lanes}}
        report.append(b2)
        del contrib, ids, qslot

        def scatter_add_case(what, q, width, ids, qslot, codes, surv=None,
                             probes=None):
            """B2's add form on one input, ``scatter_add(codes)`` or, given
            ``surv``, ``scatter_add_masked(codes, surv)``, against its plain
            version, timed.  Its bytes bound counts what the data needs: the
            mask (1 B a lane) or the codes (4 B a lane), the code of each live
            lane, the id of each non-zero contribution, 4 B of qslot an entry
            and 8 B of read-modify-write per distinct touched word; its sector
            floor the same inputs and 64 B per distinct touched 32-byte
            sector (a sector read and written back)."""
            p, lanes = ids.shape
            live = ((ids.long() & 0xFFFFFFFF) < width) & (codes != 0)
            if surv is None:
                run = (lambda a: accumulate.scatter_add(a, ids, qslot, codes))
                run_plain = (lambda a: accumulate.scatter_add_plain(
                    a, ids, qslot, codes))
                inputs = p * lanes * 4
            else:
                run = (lambda a: accumulate.scatter_add_masked(
                    a, ids, qslot, codes, surv))
                run_plain = (lambda a: accumulate.scatter_add_masked_plain(
                    a, ids, qslot, codes, surv))
                inputs = p * lanes + int(surv.sum()) * 4
                live &= surv
            n_live = int(live.sum())
            flat = (qslot.long()[:, None] * width + ids.long())[live]
            r = accumulate_case(what, q, width, run, run_plain, flat, codes[live],
                                probes)
            inputs += n_live * 4 + p * 4
            r.update(bound_ms=bound_ms(inputs + r["touched"] * 8),
                     sector_floor_ms=bound_ms(inputs + r["sectors"] * 64),
                     zero_share=1.0 - n_live / (p * lanes),
                     shape={"Q": q, "width": width, "P": p, "L": lanes,
                            "masked": surv is not None})
            log(f"{what} Q={q} width={width} P={p} L={lanes}: err "
                f"{r['max_abs_err']} kernel {r['ms']:.4f} ms plain "
                f"{r['plain_ms']:.4f} ms index_put_ {r['library_ms']:.4f} ms "
                f"bound {r['bound_ms']:.4f} ms sector floor "
                f"{r['sector_floor_ms']:.4f} ms ({r['sectors']} sectors, "
                f"{r['touched']} words, zero share {r['zero_share']:.4f})")
            return r

        # B2, add form, at the ranked path's largest scatter: u8 codes
        c = max(rcalls["B2add"], key=lambda c: c["P"])
        q, width, p, lanes = c["Q"], c["width"], c["P"], c["L"]
        qslot, ids = distinct_ids(q, p, lanes, width)
        codes = rand_int(256, p * lanes).reshape(p, lanes)
        b2add = scatter_add_case("B2 add (ranked shape)", q, width, ids, qslot,
                                 codes)
        del codes, ids, qslot
        torch.cuda.empty_cache()

        # the masked form, as the ranked rounds call it, on each mode's own
        # largest scatter (captured from its warm-up batch: the path's docid
        # spread and dead lanes), with probes of where the time goes, all
        # through scatter_add on where(surv, codes, 0): (a) as it is; (b) every
        # contribution 0 (reads and integer work, no atomic); (c) each query's
        # ids made contiguous (the atomics without the scatter: 8 lanes a
        # sector); and the where pass alone, which the mask saves
        # (tools/b2_add_order.py times other thread mappings and spreads)
        real = {}
        captured["B2add"]["or under tombstones"] = mcaps["B2add"]
        for mode, cap in captured["B2add"].items():
            if not cap:
                raise AssertionError(f"{mode}: no B2-add call captured")
            ids, qslot, codes, surv = (cap[k].to(dev) for k in
                                       ("ids", "qslot", "codes", "surv"))
            contrib = torch.where(surv, codes, 0)
            p, lanes = ids.shape
            order = torch.argsort(qslot, stable=True)
            sq = qslot[order]
            rank = torch.empty_like(order)
            rank[order] = (torch.arange(p, device=dev)
                           - torch.searchsorted(sq, sq, right=False))
            contiguous = (rank[:, None] * lanes
                          + torch.arange(lanes, device=dev)).to(torch.int32)
            zeros = torch.zeros_like(contrib)
            probes = {"a_unmasked": lambda a: accumulate.scatter_add(
                          a, ids, qslot, contrib),
                      "b_zero_contributions": lambda a: accumulate.scatter_add(
                          a, ids, qslot, zeros),
                      "c_contiguous_ids": lambda a: accumulate.scatter_add(
                          a, contiguous, qslot, contrib),
                      "where_pass": lambda a: torch.where(surv, codes, 0)}
            r = real[mode] = scatter_add_case(
                f"B2 add masked (captured, {mode})", cap["Q"], cap["width"], ids,
                qslot, codes, surv, probes)
            pr = r["probes_ms"]
            log(f"B2 add probes ({mode}): masked {r['ms']:.4f} ms; (a) "
                f"{pr['a_unmasked']:.4f} ms; (b) every contribution 0 "
                f"{pr['b_zero_contributions']:.4f} ms; (c) ids contiguous per "
                f"query {pr['c_contiguous_ids']:.4f} ms; (d) sector floor "
                f"{r['sector_floor_ms']:.4f} ms; where pass "
                f"{pr['where_pass']:.4f} ms; a-b "
                f"{pr['a_unmasked'] - pr['b_zero_contributions']:.4f} ms, b-c "
                f"{pr['b_zero_contributions'] - pr['c_contiguous_ids']:.4f} ms")
            del ids, qslot, codes, surv, contrib, contiguous, zeros, rank
            del order, sq
            torch.cuda.empty_cache()
        report.append({
            "name": "scatter_add (B2, add form)", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/accumulate.cu",
            "replaces": "src/repro/kernels/accumulate.py:85",
            "launches": sum(ranked_launches["B2add"].values()),
            "path": "ranked", "ranked_launches": ranked_launches["B2add"],
            "max_abs_err": max([b2add["max_abs_err"]]
                               + [r["max_abs_err"] for r in real.values()]),
            "ms": b2add["ms"], "plain_ms": b2add["plain_ms"],
            "bound_ms": b2add["bound_ms"], "bound_by": "bytes",
            "library_ms": b2add["library_ms"],
            "sector_floor_ms": b2add["sector_floor_ms"],
            "zero_share": b2add["zero_share"], "sectors": b2add["sectors"],
            "shape": b2add["shape"], "captured": real, "ok": True})

        # B3 at the ranked path's largest unpack (random slots into an arena of
        # the real row count)
        c = max(rcalls["B3"], key=lambda c: c["W"])
        w, n_tiles = c["W"], c["tiles"]
        tiles = rand_words((n_tiles, 128))
        slots = rand_int(n_tiles, w)
        got = topk.unpack_codes(tiles, slots)
        ref = topk.unpack_codes_plain(tiles, slots)
        torch.cuda.synchronize()
        err = max_abs_err([got], [ref], torch)
        # distinct rows read, the slot indices, 2 KB of codes written per entry
        nbytes = torch.unique(slots).numel() * 512 + w * 4 + w * 2048
        ms = cuda_ms(lambda: topk.unpack_codes(tiles, slots), torch)
        pms = cuda_ms(lambda: topk.unpack_codes_plain(tiles, slots), torch)
        log(f"B3 W={w} tiles={n_tiles}: err {err} kernel {ms:.4f} ms plain "
            f"{pms:.4f} ms bound {bound_ms(nbytes):.4f} ms")
        if err:
            raise AssertionError("B3 disagrees with its plain version")
        report.append({
            "name": "unpack_codes (B3)", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/topk.cu",
            "replaces": "src/repro/kernels/topk.py:295",
            "launches": sum(ranked_launches["B3"].values()), "path": "ranked",
            "ranked_launches": ranked_launches["B3"], "max_abs_err": err,
            "ms": ms, "plain_ms": pms, "bound_ms": bound_ms(nbytes),
            "bound_by": "bytes", "library_ms": None,
            "shape": {"W": w, "tiles": n_tiles}, "ok": True})
        del tiles, slots, got, ref

        win = accumulate.DENSE_WINDOW

        def dense_case(what, q, width, codes, tiles, wbits, qslot, col0, act,
                       gated, probes=None):
            """B4's packed form (``tiles``; or, with ``tiles`` None, the
            unpacked form on ``codes``) against its plain version on one input,
            timed; ``codes`` are the (P, 4096) codes it adds (gated and masked
            by ``act``).  Its bytes bound: an act byte per entry; per active
            entry 8 B of indices and the codes it needs (16 KB unpacked, 4 KB
            packed; gated, the window's 512 B and the 32-byte sector of codes
            under each non-zero window word); 8 B of read-modify-write per
            distinct touched word.  Its sector floor: the same inputs and 64 B
            per distinct touched sector."""
            p = codes.shape[0]
            n_act = int(act.sum())
            if tiles is None:
                run = (lambda a: accumulate.dense_add(a, codes, qslot, col0,
                                                      act))
                run_plain = (lambda a: accumulate.dense_add_plain(
                    a, codes, qslot, col0, act))
                code_bytes = n_act * win * 4
            else:
                run = (lambda a: accumulate.dense_add_packed(
                    a, tiles, wbits, qslot, col0, act, gated=gated))
                run_plain = (lambda a: accumulate.dense_add_packed_plain(
                    a, tiles, wbits, qslot, col0, act, gated=gated))
                code_bytes = n_act * win
                if gated:
                    live_words = int(((wbits != 0) & act[:, None]).sum())
                    code_bytes = n_act * win // 8 + live_words * 32
            nz = (codes != 0) & act[:, None]
            e, pos = nz.nonzero(as_tuple=True)
            flat = qslot.long()[e] * width + col0.long()[e] + pos
            r = accumulate_case(what, q, width, run, run_plain, flat, codes[nz],
                                probes)
            del e, pos, flat
            inputs = p + n_act * 8 + code_bytes
            r.update(bound_ms=bound_ms(inputs + r["touched"] * 8),
                     sector_floor_ms=bound_ms(inputs + r["sectors"] * 64),
                     zero_share=1.0 - int(nz.sum()) / (p * win),
                     code_bytes=code_bytes,
                     shape={"Q": q, "width": width, "P": p,
                            "active": n_act, "gated": gated})
            log(f"{what} Q={q} width={width} P={p} gated={gated}: err "
                f"{r['max_abs_err']} kernel {r['ms']:.4f} ms plain "
                f"{r['plain_ms']:.4f} ms index_put_ {r['library_ms']:.4f} ms "
                f"bound {r['bound_ms']:.4f} ms sector floor "
                f"{r['sector_floor_ms']:.4f} ms ({r['sectors']} sectors, "
                f"{r['touched']} words, {code_bytes} code bytes needed, zero "
                f"share {r['zero_share']:.4f})")
            return r

        def unpacked_round(acc, tiles, wbits, qslot, col0, act, gated):
            """The dense round's add with the codes unpacked first: plain torch
            unpacks (and gates) them, CHUNK_ELEMS at a time, for B4's unpacked
            form (the ranked rounds' add before the packed form)."""
            step = accumulate.CHUNK_ELEMS // win
            for s in range(0, tiles.shape[0], step):
                part = slice(s, s + step)
                codes = accumulate._window_codes(tiles[part])
                if gated:
                    codes = codes * accumulate._window_bits(wbits[part])
                accumulate.dense_add(acc, codes, qslot[part], col0[part],
                                     act[part])

        # B4 on 65,536 windows (one chunk of the plain packed form; fewer if
        # the path's largest call had fewer) at random 128-aligned columns of
        # the ranked accumulator, half the codes zero:
        # the unpacked form on the codes, the packed form on the same codes
        # packed, ungated and gated by random window bits
        b4_calls = rcalls["B4"] or [{"P": 1, "Q": q, "width": width}]
        log(f"B4 launches on the ranked path, entries: "
            f"{[c['P'] for c in b4_calls]}")
        c = max(b4_calls, key=lambda c: c["P"])
        p, q, width = (min(c["P"], accumulate.CHUNK_ELEMS // win), c["Q"],
                       c["width"])
        qslot = torch.sort(rand_int(q, p)).values
        col0 = rand_int((width - win) // 128 + 1, p) * 128
        codes = torch.where(rand_int(2, p * win).reshape(p, win) == 0, 0,
                            rand_int(256, p * win).reshape(p, win))
        tiles = codes.to(torch.uint8).view(torch.int32)     # byte p: position p
        wbits = rand_words((p, accumulate.WINDOW_WORDS))
        act = torch.ones(p, dtype=torch.bool, device=dev)
        b4u = dense_case("B4 unpacked", q, width, codes, None, None, qslot, col0,
                         act, False)
        b4 = dense_case("B4 packed", q, width, codes, tiles, wbits, qslot, col0,
                        act, False)
        b4g = dense_case("B4 packed", q, width,
                         codes * accumulate._window_bits(wbits), tiles, wbits,
                         qslot, col0, act, True)
        if not rcalls["B4"]:
            log("(no dense block on the ranked path)")
        del codes, tiles, wbits, qslot, col0, act
        torch.cuda.empty_cache()

        # the packed form on each mode's own largest dense round (captured from
        # its warm-up batch: the real windows, overlaps and dead positions), and
        # the unpacked round (unpack and gate in plain torch, then the unpacked
        # form) against it on the same inputs, gated and ungated
        b4_real = {}
        for mode, cap in captured["B4"].items():
            if not cap:
                if warm_dense[mode] > 0:
                    raise AssertionError(f"{mode}: no dense round captured")
                continue
            tiles, wbits, qslot, col0, act = (cap[k].to(dev) for k in (
                "tiles", "win", "qslot", "col0", "act"))
            gated = cap["gated"]
            codes = accumulate._window_codes(tiles)
            if gated:
                codes = codes * accumulate._window_bits(wbits)
            probes = {}
            for g in (False, True):
                probes[f"unpacked_round_gated_{g}"] = (
                    lambda a, g=g: unpacked_round(a, tiles, wbits, qslot, col0,
                                                  act, g))
                probes[f"packed_gated_{g}"] = (
                    lambda a, g=g: accumulate.dense_add_packed(
                        a, tiles, wbits, qslot, col0, act, gated=g))
            r = b4_real[mode] = dense_case(
                f"B4 packed (captured, {mode})", cap["Q"], cap["width"], codes,
                tiles, wbits, qslot, col0, act, gated, probes)
            pr = r["probes_ms"]
            for g in (False, True):
                unp, pk = (pr[f"unpacked_round_gated_{g}"],
                           pr[f"packed_gated_{g}"])
                log(f"B4 dense round ({mode}'s captured inputs, gated={g}): "
                    f"unpack{' and gate' if g else ''} + unpacked kernel "
                    f"{unp:.4f} ms, packed kernel {pk:.4f} ms: {unp / pk:.2f}x")
            del tiles, wbits, qslot, col0, act, codes
            torch.cuda.empty_cache()
        # the gated packed form on the tombstone `or` batch's largest dense
        # round, gated by the epoch's live row (nearly every window bit set):
        # against its plain version, then timed in turns beside the ungated
        # packed form on the same inputs
        cap = mcaps["B4"]
        tiles, wbits, qslot, col0, act = (cap[k].to(dev) for k in (
            "tiles", "win", "qslot", "col0", "act"))
        b4_tomb = dense_case(
            "B4 packed gated (captured, or under tombstones)", cap["Q"],
            cap["width"], accumulate._window_codes(tiles)
            * accumulate._window_bits(wbits), tiles, wbits, qslot, col0, act,
            True)
        acc = torch.zeros((cap["Q"], cap["width"]), dtype=torch.int32,
                          device=dev)
        b4_tomb["ms_in_turns"] = in_turns({
            f"gated_{g}": (lambda g=g: accumulate.dense_add_packed(
                acc, tiles, wbits, qslot, col0, act, gated=g))
            for g in (True, False)}, torch)
        b4_tomb["window_bits_set"] = bit_share(wbits)
        log(f"B4 packed on the tombstone or batch's captured round (window bits "
            f"set {b4_tomb['window_bits_set']:.4f}), in turns: "
            f"{b4_tomb['ms_in_turns']}")
        del tiles, wbits, qslot, col0, act, acc
        torch.cuda.empty_cache()
        # the entry's own numbers: the ranked path's largest captured round
        main = max(b4_real.values(), key=lambda r: r["shape"]["P"], default=b4)
        report.append({
            "name": "dense_add (B4)", "route": "cuda",
            "form": "ms, bound_ms and library_ms: the packed form "
                    "(dense_add_packed, the ranked path's form) on the ranked "
                    "path's largest captured round; synthetic.unpacked: the "
                    "unpacked form on synthetic windows",
            "source": "src/repro_torch/kernels/csrc/accumulate.cu",
            "replaces": "src/repro/kernels/accumulate.py:137",
            "launches": sum(ranked_launches["B4"].values()), "path": "ranked",
            "ranked_launches": ranked_launches["B4"],
            "max_abs_err": max(r["max_abs_err"] for r in
                               (b4, b4g, b4u, b4_tomb, *b4_real.values())),
            **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms",
                                    "sector_floor_ms", "zero_share", "sectors",
                                    "shape")},
            "bound_by": "bytes", "captured": b4_real,
            "captured_tombstone_or": b4_tomb,
            "synthetic": {"packed": b4, "packed_gated": b4g, "unpacked": b4u},
            "ok": True})

        # B6, B7a and B7b at every bit width 1..32, three frames each (the
        # corpus reaches only the widths its lists need); B8 on sums that wrap
        # past 2**32, on row counts that are no multiple of its tile (one of
        # them 1,001 tiles, more than the card holds resident at once), and
        # twice queued back to back on inputs of one shape (the second call's
        # scratch reuses the first's memory: no stale tile status)
        sweep = {"B7a": 0, "B7b": 0, "B6": 0, "B8": 0}
        for bw in range(1, 33):
            x = rand_words((3 * 32, 128))
            packed = bitpack.pack_frames(x, bw)
            sweep["B7a"] = max(sweep["B7a"], max_abs_err(
                [packed], [bitpack.pack_frames_plain(x, bw)], torch))
            sweep["B7b"] = max(sweep["B7b"], max_abs_err(
                [bitpack.unpack_frames(packed, bw)],
                [bitpack.unpack_frames_plain(packed, bw)], torch))
            sweep["B6"] = max(sweep["B6"], max_abs_err(
                [unpack_delta.unpack_delta_frames(packed, bw)],
                [unpack_delta.unpack_delta_frames_plain(packed, bw)], torch))
        wrap = torch.where(rand_int(2, 64 * 32 * 128).reshape(-1, 128) == 0,
                           -(1 << 31), rand_words((64 * 32, 128)))
        many = rand_words((32 * 2000 + 7, 128))
        for x in (wrap, rand_words((37, 128)), many):
            sweep["B8"] = max(sweep["B8"], max_abs_err(
                [scan_add.prefix_sum_blocks(x)],
                [scan_add.prefix_sum_blocks_plain(x)], torch))
        again = rand_words(many.shape)
        both = [scan_add.prefix_sum_blocks(many), scan_add.prefix_sum_blocks(again)]
        sweep["B8"] = max(sweep["B8"], max_abs_err(
            both, [scan_add.prefix_sum_blocks_plain(y) for y in (many, again)],
            torch))
        torch.cuda.synchronize()
        log(f"B6/B7a/B7b at bw 1..32 and B8 on wrapping, ragged and many-tile "
            f"inputs and back to back: max_abs_err {sweep}")
        if any(sweep.values()):
            raise AssertionError(f"stream kernel sweep disagrees: {sweep}")
        del wrap, x, packed, many, again, both

        def largest(k, key):
            return max(scalls[k], key=lambda c: c[key])

        def stream_case(key, name, source, replaces, run, run_plain, nbytes,
                        shape, library=None, library_name=None, per_call=False):
            """A stream kernel at the stream phase's largest call: bitwise
            against its plain version, then timed (primed and from an idle
            queue), its plain version and its library call timed; whether the
            library call gives the same bit patterns; ``per_call``: the grid
            launches and memsets of one call."""
            got = run()
            want = run_plain()
            torch.cuda.synchronize()
            err = max_abs_err([got], [want], torch)
            if err:
                raise AssertionError(f"{key} disagrees with its plain version")
            entry = {"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{source}",
                     "replaces": replaces, "launches": stream_launches[key],
                     "path": "stream", "max_abs_err": max(err, sweep.get(key, 0)),
                     "ms": cuda_ms(run, torch), "plain_ms": cuda_ms(run_plain, torch),
                     "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
                     "library_ms": cuda_ms(library, torch) if library else None,
                     "call_ms": cuda_ms(run, torch, primed=False),
                     "library": library_name, "shape": shape, "ok": True}
            if library:
                entry["library_equal"] = bool(torch.equal(library().view(-1),
                                                          got.view(-1)))
            if per_call:
                entry["per_call"] = device_ops(run, torch)
            lms = entry["library_ms"]
            log(f"{key} {shape}: err {err} kernel {entry['ms']:.4f} ms (one call "
                f"from an idle queue {entry['call_ms']:.4f} ms) plain "
                f"{entry['plain_ms']:.4f} ms "
                + (f"{library_name} {lms:.4f} ms " if library else "")
                + f"bound {bound_ms(nbytes):.4f} ms"
                + (f"; per call {entry['per_call']}" if per_call else ""))
            report.append(entry)

        c = largest("B7a", "frames")
        f, bw = c["frames"], c["bw"]
        x = rand_words((f * 32, 128))
        stream_case("B7a", "pack_frames (B7a)", "stream.cu",
                    "src/repro/kernels/bitpack.py:78",
                    lambda: bitpack.pack_frames(x, bw),
                    lambda: bitpack.pack_frames_plain(x, bw),
                    f * FRAME_INTS * 4 + f * bw * 512, {"frames": f, "bw": bw})
        for key, wrapper, plain, name, replaces in (
                ("B7b", bitpack.unpack_frames, bitpack.unpack_frames_plain,
                 "unpack_frames (B7b)", "src/repro/kernels/bitpack.py:96"),
                ("B6", unpack_delta.unpack_delta_frames,
                 unpack_delta.unpack_delta_frames_plain,
                 "unpack_delta_frames (B6)",
                 "src/repro/kernels/unpack_delta.py:46")):
            c = largest(key, "frames")
            f, bw = c["frames"], c["bw"]
            packed = rand_words((f * bw, 128))
            stream_case(key, name, "stream.cu", replaces,
                        lambda: wrapper(packed, bw), lambda: plain(packed, bw),
                        f * bw * 512 + f * FRAME_INTS * 4,
                        {"frames": f, "bw": bw})
        c = largest("B8", "rows")
        x = rand_words((c["rows"], 128))
        flat = x.view(-1)
        stream_case("B8", "prefix_sum_blocks (B8)", "stream.cu",
                    "src/repro/kernels/scan_add.py:38",
                    lambda: scan_add.prefix_sum_blocks(x),
                    lambda: scan_add.prefix_sum_blocks_plain(x),
                    2 * c["rows"] * 512, {"rows": c["rows"]},
                    lambda: torch.cumsum(flat, 0, dtype=torch.int32),
                    "torch.cumsum(dtype=torch.int32)", per_call=True)
        c = largest("B9", "frames")
        x = rand_words((c["frames"] * 32, 128))
        stream_case("B9", "frame_or (B9)", "stream.cu",
                    "src/repro/kernels/quadmax.py:29",
                    lambda: quadmax.frame_or(x), lambda: quadmax.frame_or_plain(x),
                    c["frames"] * (FRAME_INTS * 4 + 512), {"frames": c["frames"]})
        c = largest("B10", "rows")
        a, b = rand_words((c["rows"], 128)), rand_words((c["rows"], 128))
        stream_case("B10", "bitmap_and_tiles (B10)", "intersect.cu",
                    "src/repro/kernels/intersect.py:115",
                    lambda: intersect.bitmap_and_tiles(a, b),
                    lambda: intersect.bitmap_and_tiles_plain(a, b),
                    3 * c["rows"] * 512, {"rows": c["rows"]},
                    lambda: torch.bitwise_and(a, b), "torch.bitwise_and",
                    per_call=True)
        # B10 above the 50 MB L2: 3 x 32 MiB, so repeats read from HBM
        rows = 65536
        a, b = rand_words((rows, 128)), rand_words((rows, 128))
        err = max_abs_err([intersect.bitmap_and_tiles(a, b)],
                          [intersect.bitmap_and_tiles_plain(a, b)], torch)
        if err:
            raise AssertionError("B10 disagrees with its plain version above L2")
        big = {"rows": rows, "max_abs_err": err,
               "ms": cuda_ms(lambda: intersect.bitmap_and_tiles(a, b), torch),
               "library_ms": cuda_ms(lambda: torch.bitwise_and(a, b), torch),
               "bound_ms": bound_ms(3 * rows * 512)}
        report[-1]["above_l2"] = big
        log(f"B10 above L2 {{'rows': {rows}}}: err {err} kernel {big['ms']:.4f} "
            f"ms torch.bitwise_and {big['library_ms']:.4f} ms bound "
            f"{big['bound_ms']:.4f} ms")
        del x, flat, packed, a, b

        # kernel PFD, Group-PFD's whole-list decode: the codecs table's
        # longest list (the largest call) and shortest (two tiles), and a
        # one-tile list of the decode cell's median length; launches are
        # the codecs table's, one a list
        prng = np.random.default_rng(args.seed + 28)
        med = dgap_encode_np(np.sort(prng.choice(
            args.n_docs, PFD_MEDIAN_N, replace=False)).astype(np.uint32))
        lists = dict(pfd_lists, median=(group_pfd.encode(med), med))
        pfd = {}
        for which, (enc, g) in lists.items():
            kw = group_pfd.torch_args(enc, device=dev)
            got = pfd_decode.decode_list(**kw)
            err = max_abs_err([got], [pfd_decode.decode_list_plain(**kw)],
                              torch)
            if err or not np.array_equal(to_np(got), g):
                raise AssertionError(f"PFD disagrees with its plain version "
                                     f"or the d-gaps on the {which} list")
            frames = -(-kw["q"] // group_pfd.FRAME_QUADS)
            pfd[which] = {
                "n": enc.n, "frames": frames,
                "tiles": -(-frames // pfd_decode.TILE_FRAMES),
                "exc": kw["total_exc"], "max_abs_err": err,
                "ms": cuda_ms(lambda: pfd_decode.decode_list(**kw), torch),
                "call_ms": cuda_ms(lambda: pfd_decode.decode_list(**kw),
                                   torch, primed=False),
                "plain_ms": cuda_ms(
                    lambda: pfd_decode.decode_list_plain(**kw), torch,
                    runs=PLAIN_RUNS),
                "bound_ms": bound_ms(enc.nbytes() + 4 * enc.n)}
            log(f"PFD {which} list {pfd[which]}")
        kw = group_pfd.torch_args(lists["median"][0], device=dev)
        vec = codec_lib.get("group_pfd").torch.vec
        d = kw["data"]
        host = {"decode_list": host_us(lambda: pfd_decode.decode_list(**kw),
                                       torch),
                "codec_vec": host_us(lambda: vec(**kw), torch),
                "check_list_args": host_us(lambda: pfd_decode.check_list_args(
                    kw["control"], d, kw["exceptions"]), torch),
                "torch_empty": host_us(lambda: torch.empty(
                    kw["n"], dtype=torch.int32, device=dev), torch),
                "stream_ptr": host_us(lambda: cuda_build.stream_ptr(d), torch),
                "current_stream": host_us(
                    lambda: torch.cuda.current_stream(d.device).cuda_stream,
                    torch),
                "count_launch": host_us(lambda: K.count_launch(
                    "PFD", n=kw["n"], frames=1, exc=0), torch)}
        log(f"PFD host microseconds a call on the median list {host}")
        top = pfd["longest"]
        report.append({
            "name": "decode_list (PFD)", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/group_pfd.cu",
            "replaces": "src/repro/core/group_pfd.py:186 (jnp, no Pallas)",
            "launches": codecs["table"]["group_pfd"]["launches"]["PFD"],
            "path": "codecs", "max_abs_err": max(
                v["max_abs_err"] for v in pfd.values()),
            "ms": top["ms"], "call_ms": top["call_ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "library": None,
            "shape": {k: top[k] for k in ("n", "frames", "tiles", "exc")},
            "lists": pfd, "host_us": host, "ok": True})
        del lists, kw, d, got

        # the kernels the shard and serve phases launched, counted there
        for entry in report:
            key = {"segmented_decode_and (B1)": "B1", "scatter_bits (B2)": "B2",
                   "scatter_add (B2, add form)": "B2add",
                   "unpack_codes (B3)": "B3", "dense_add (B4)": "B4"
                   }.get(entry["name"])
            if key is not None:
                entry["sharded_launches"] = sharded["launches"].get(key, 0)
                entry["serve_launches"] = serve["launches"].get(key, 0)
        return report

    report = kernel_phase()
    del pfd_lists

    # ---- dense LM serving, after every index phase ------------------------ #
    phase_done("kernels")
    gc.collect()
    torch.cuda.empty_cache()
    lm = lm_phase(dev, args.seed, smi, np, torch)
    phase_done("lm")

    # ---- recsys and EGNN, after the lm phase ------------------------------ #
    gc.collect()
    torch.cuda.empty_cache()
    rg = recsys_gnn_phase(dev, args.seed, graph_job, smi, np, torch)
    phase_done("recsys_gnn")

    # ---- training, last ---------------------------------------------------- #
    gc.collect()
    torch.cuda.empty_cache()
    K.reset_launches()
    train = train_phase(dev, args.seed, graph_job, smi, np, torch)
    build_pool.shutdown()
    train["launches"] = {k: v for k, v in K.LAUNCHES.items() if v}
    if train["launches"]:
        raise AssertionError(f"the train phase launched B kernels: "
                             f"{train['launches']}")
    log("train launched no B kernel (every count 0)")
    phase_done("train")

    # ---- meshes and sharding plans, last ---------------------------------- #
    gc.collect()
    torch.cuda.empty_cache()
    mesh = mesh_phase(args.seed, smi, np, torch)
    log("mesh launched no B kernel (every count 0)")
    phase_done("mesh")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    print(json.dumps({"phases_s": phase_s, "ranked": {
        m: {k: v for k, v in r.items() if k != "recent"}
        for m, r in ranked.items()}, "mutation": mut, "stream": stream,
        "codecs": codecs, "sharded": sharded, "serve": serve,
        "examples": examples, "lm": lm, "recsys_gnn": rg, "train": train,
        "mesh": mesh}),
        flush=True)
    print(json.dumps({"kernels": report}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
