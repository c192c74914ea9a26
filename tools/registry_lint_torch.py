#!/usr/bin/env python
"""Registry lint of the PyTorch port: fail CI if any codec of
``repro_torch`` breaks the Codec protocol contract, or the index tables
the port serves from drift.

The counterpart of ``tools/registry_lint.py`` (which checks the JAX
package), with the same ten checks run against ``repro_torch``:

  1. protocol: required fields present and well-typed (name, category,
     encode, decode_np, max_bits); the declared capabilities structurally
     valid (``TorchDecode``'s three callables; every ``ArenaLayout``
     column named, positively sized, with a callable extractor);
  2. arena contract: every declared ``ArenaLayout`` decodes a smoke block
     from one padded slice per column with dynamic lengths, as the device
     arena calls it, zero past ``n_valid``;
  3. exception columns: a codec whose encoder stores a non-empty exception
     stream on a heavy-tailed probe must declare an ``"exceptions"`` arena
     column;
  4. parity coverage: the port's arena parity sweep
     (``tests/test_torch_codecs.py::ARENA_CODECS``) covers exactly the
     port's arena declarations;
  5. score tables: the ``ScoreArena`` block-max, term-max and stripe tables
     agree with the stored quantized impacts;
  6. segments: tombstones agree with their live-doc tables (count, mask,
     packed row, the host and kernel packers bit-identical), and after
     ``compact()`` the new generation's score tables match a from-scratch
     rebuild;
  7. dense-bitmap boundaries: a bitmap-block codec round-trips the density
     boundary cases and chooses bitmap or raw as the policy says;
  8. shards: every ``ShardSpec`` partitions the docid space; every shard
     generation carries the parent gid and global dfs, its postings are the
     parent's slice and its quantized codes and block maxima equal the
     parent's at the same (term, global doc);
  9. serving traces: every ``TraceRecord`` of a lint-sized serve stream has
     monotone stage stamps, served traces carry all five plus batch
     metadata, and batch records' stamps are ordered;
 10. metrics: snake_case names, labels from ``LABEL_KEYS``, duplicate
     registration raising, and one metric schema across engine instances.

Each check takes the torch device its score arenas and serve stream run
on.  Like the port's other entry points, the lint runs on the card unless
the caller names the CPU (``--torch-device cpu``); without a card the
default raises.

Run: PYTHONPATH=src python tools/registry_lint_torch.py [--torch-device cpu]
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import re
import sys

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "src"))

from repro_torch.core import codec  # noqa: E402
from repro_torch.core.bits import from_np, to_np  # noqa: E402

CATEGORIES = ("bit", "byte", "word", "frame")


def _fail(errors: list, msg: str) -> None:
    errors.append(msg)
    print(f"FAIL {msg}")


def lint_protocol(errors: list, device) -> None:
    for name in codec.names():
        spec = codec.get(name)
        if spec.name != name:
            _fail(errors, f"{name}: registered under mismatched name {spec.name!r}")
        if spec.category not in CATEGORIES:
            _fail(errors, f"{name}: category {spec.category!r} not in {CATEGORIES}")
        if not callable(spec.encode) or not callable(spec.decode_np):
            _fail(errors, f"{name}: encode/decode_np must be callable")
        if not isinstance(spec.max_bits, int) or not 1 <= spec.max_bits <= 32:
            _fail(errors, f"{name}: max_bits {spec.max_bits!r} outside 1..32")
        if spec.torch is not None:
            for field in ("args", "scalar", "vec"):
                if not callable(getattr(spec.torch, field)):
                    _fail(errors, f"{name}: TorchDecode.{field} not callable")
        if spec.arena is not None:
            lay = spec.arena
            if len(lay.columns) < 2:
                _fail(errors, f"{name}: ArenaLayout declares "
                              f"{len(lay.columns)} column(s); need >= 2")
            for col in lay.columns:
                if not col.name or col.width <= 0 or not callable(col.extract):
                    _fail(errors, f"{name}: ArenaLayout column {col.name!r} "
                                  f"malformed (width {col.width})")
            if min(lay.out_width, lay.max_n) <= 0:
                _fail(errors, f"{name}: ArenaLayout out_width/max_n must be "
                              f"positive")
            if lay.out_width < lay.max_n:
                _fail(errors, f"{name}: out_width {lay.out_width} < max_n {lay.max_n}")
            for field in ("decode_block", "supports"):
                if not callable(getattr(lay, field)):
                    _fail(errors, f"{name}: ArenaLayout.{field} not callable")


def _arena_roundtrip(spec, x: np.ndarray, device) -> None:
    """Decode one encoded block through the declared ArenaLayout the way
    ``repro_torch.index.device`` does: one padded fixed-width row per
    declared column plus the dynamic per-column lengths, as a batch of 1."""
    lay = spec.arena
    enc = spec.encode(x)
    rows, lens = [], []
    for col in lay.columns:
        words = np.asarray(col.extract(enc), col.dtype).reshape(-1)
        assert words.size <= col.width, (spec.name, col.name, words.size,
                                         col.width)
        padded = np.zeros(col.width, col.dtype)
        padded[: words.size] = words
        rows.append(from_np(padded[None, :], device))
        lens.append(from_np(np.asarray([words.size], np.int32), device))
    n = from_np(np.asarray([enc.n], np.int32), device)
    out = to_np(lay.decode_block(*rows, *lens, n))
    assert out.shape == (1, lay.out_width), (spec.name, out.shape)
    np.testing.assert_array_equal(out[0, : enc.n], x,
                                  err_msg=f"{spec.name}/arena")
    assert not out[0, enc.n:].any(), f"{spec.name}: arena decode not zero-padded"


def lint_arena_contract(errors: list, device) -> None:
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 12, 200, dtype=np.int64).astype(np.uint32)
    for name in codec.names():
        spec = codec.get(name)
        if spec.arena is None:
            continue
        try:
            _arena_roundtrip(spec, x, device)
        except AssertionError as e:
            _fail(errors, f"{name}: arena contract violated: {e}")


def lint_exception_columns(errors: list, device) -> None:
    """A codec that stores exceptions must declare an arena column for
    them: on a heavy-tailed probe (mostly tiny values, sparse huge
    outliers) the patched codecs emit a non-empty exception stream, which
    an arena without an ``"exceptions"`` column would silently drop."""
    rng = np.random.default_rng(5)
    for name in codec.names():
        spec = codec.get(name)
        if spec.arena is None:
            continue
        probe = rng.integers(0, 16, 400, dtype=np.int64).astype(np.uint32)
        probe[::50] = np.uint32(2 ** min(spec.max_bits, 32) - 1)
        enc = spec.encode(probe)
        if not np.array_equal(spec.decode_np(enc), probe):
            _fail(errors, f"{name}: heavy-tailed probe does not round-trip")
        if (enc.exceptions is not None and len(enc.exceptions)
                and not any(c.name == "exceptions"
                            for c in spec.arena.columns)):
            _fail(errors, f"{name}: stores a non-empty exception stream but "
                          f"declares an ArenaLayout without an 'exceptions' "
                          f"column")


def _load(module: str, *relpath: str):
    tests = os.path.join(_REPO, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    path = os.path.join(_REPO, *relpath)
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lint_parity_coverage(errors: list, device) -> None:
    mod = _load("test_torch_codecs", "tests", "test_torch_codecs.py")
    declared = {n for n in codec.names() if codec.get(n).arena is not None}
    covered = set(getattr(mod, "ARENA_CODECS", ()))
    for name in sorted(declared - covered):
        _fail(errors, f"{name}: declares an arena capability but is missing "
                      f"from the port's parity sweep (ARENA_CODECS)")
    for name in sorted(covered - declared):
        _fail(errors, f"{name}: in the port's parity sweep but declares no "
                      f"arena capability")


def lint_score_tables(errors: list, device) -> None:
    """Block-max soundness on the lint corpus: each stored block-max equals
    the max of the block's stored quantized impacts and the quantized
    build-time float maximum; term-max is the max block-max; the stripe
    range-bound table dominates every posting's code."""
    from repro_torch.index.invindex import InvertedIndex
    from repro_torch.index.scores import ScoreArena, unpack_words_np

    rng = np.random.default_rng(17)
    n_docs = 100_000
    postings = {}
    for t, df in enumerate([12, 64, 300, 513, 900]):
        gaps = rng.integers(1, 8, df).astype(np.int64)
        gaps[rng.random(df) < 0.02] += rng.integers(1 << 8, 1 << 12)
        ids = np.cumsum(gaps)
        assert int(ids[-1]) < n_docs
        postings[t] = (ids.astype(np.uint32),
                       rng.geometric(0.4, df).astype(np.uint32))
    doclen = rng.integers(50, 500, n_docs).astype(np.int64)
    for name in ("group_simple", "group_pfd"):
        idx = InvertedIndex.build(doclen, postings, codec=name)
        sa = ScoreArena.from_index(idx.gen, device=device)
        tiles = to_np(sa.tiles)
        for t, tp in idx.terms.items():
            per_block = []
            for bi in range(len(tp.blocks)):
                ids, _ = idx.decode_block(t, bi)
                s = sa.slot[(t, bi)]
                codes = unpack_words_np(tiles[s], len(ids))
                stored = int(sa.block_max[s])
                per_block.append(stored)
                if stored != int(codes.max(initial=0)):
                    _fail(errors, f"{name}: score block-max table "
                                  f"[{t},{bi}] = {stored} != max stored "
                                  f"impact {int(codes.max(initial=0))}")
                built = min(int(idx.impact_block_max(t)[bi] / sa.delta), 255)
                if stored != built:
                    _fail(errors, f"{name}: score block-max table "
                                  f"[{t},{bi}] = {stored} != quantized "
                                  f"build-time float max {built}")
                if np.any(sa.stripes[t][ids // sa.stripe_width]
                          < codes.astype(np.int64)):
                    _fail(errors, f"{name}: stripe range-bound table "
                                  f"under-bounds term {t} block {bi}")
            if sa.term_max[t] != max(per_block, default=0):
                _fail(errors, f"{name}: term-max table for term {t} "
                              f"inconsistent with block maxima")


def lint_segments(errors: list, device) -> None:
    """Mutation consistency on the lint corpus: the tombstone set and its
    live-doc views agree (count, bool mask, packed row; host and kernel
    packers bit-identical), the doclen overrides span the append-only doc
    space, and after ``compact()`` the new generation's score block-max
    tables match its stored impacts and a from-scratch rebuild's."""
    from repro_torch.index.invindex import InvertedIndex
    from repro_torch.index.scores import ScoreArena
    from repro_torch.kernels.intersect_rounds import (bitmap_geometry,
                                                      pack_live_words)

    rng = np.random.default_rng(23)
    n_docs = 5000
    postings = {}
    for t, df in enumerate([30, 120, 400, 900]):
        ids = np.sort(rng.choice(n_docs, df, replace=False)).astype(np.uint32)
        postings[t] = (ids, rng.geometric(0.4, df).astype(np.uint32))
    doclen = rng.integers(30, 300, n_docs).astype(np.int64)
    idx = InvertedIndex.build(doclen, postings, codec="group_pfd")
    dead = sorted(int(d) for d in rng.choice(n_docs, 200, replace=False))
    for d in dead:
        idx.delete(d)
    inserts = {}
    for j in range(40):
        t = int(rng.integers(0, 4))
        inserts[n_docs + j] = (t, int(rng.integers(1, 5)))
        idx.insert(n_docs + j, {t: inserts[n_docs + j][1]},
                   int(rng.integers(10, 100)))

    mask = idx.tomb.mask(idx.n_docs)
    if int((~mask).sum()) != len(idx.tomb):
        _fail(errors, f"segments: live mask drops {int((~mask).sum())} docs "
                      f"but the tombstone set holds {len(idx.tomb)}")
    words, _ = bitmap_geometry(idx.n_docs)
    lw = idx.tomb.live_words(idx.n_docs, words)
    pop = int(np.unpackbits(lw.view(np.uint8), bitorder="little").sum())
    if pop != int(mask.sum()):
        _fail(errors, f"segments: packed live bitmap popcount {pop} != live "
                      f"mask count {int(mask.sum())}")
    kernel_packed = pack_live_words(idx.tomb.sorted_ids(below=idx.n_docs),
                                    idx.n_docs, words)
    if not np.array_equal(kernel_packed, lw):
        _fail(errors, "segments: kernels.pack_live_words disagrees with "
                      "Tombstones.live_words: device and host gates differ")
    dl = idx.doclen_now()
    if len(dl) != idx.doc_space:
        _fail(errors, f"segments: doclen_now length {len(dl)} != doc_space "
                      f"{idx.doc_space}")

    deadset = set(dead)
    live = {}
    for t, (ids, tfs) in postings.items():
        keep = [j for j, d in enumerate(ids.tolist()) if d not in deadset]
        live[t] = ([int(ids[j]) for j in keep], [int(tfs[j]) for j in keep])
    for d, (t, tf) in inserts.items():
        live[t][0].append(d)
        live[t][1].append(tf)
    live = {t: (np.asarray(i, np.uint32), np.asarray(f, np.uint32))
            for t, (i, f) in live.items() if i}
    gen = idx.compact()
    if idx.mutated:
        _fail(errors, "segments: handle still mutated after compact()")
    rebuilt = InvertedIndex.build(np.array(dl), live, codec="group_pfd").gen
    sa = ScoreArena.from_index(gen, device=device)
    sr = ScoreArena.from_index(rebuilt, device=device)
    if abs(sa.delta - sr.delta) > 0:
        _fail(errors, "segments: compacted quantizer delta differs from the "
                      "from-scratch rebuild's")
    for t, tp in gen.terms.items():
        rp = rebuilt.terms.get(t)
        if rp is None or rp.df != tp.df:
            _fail(errors, f"segments: term {t} df {tp.df} != rebuild "
                          f"{getattr(rp, 'df', None)}")
            continue
        base, rbase = sa.slot[(t, 0)], sr.slot[(t, 0)]
        for bi in range(len(tp.blocks)):
            stored = int(sa.block_max[base + bi])
            built = min(int(gen.impact_block_max(t)[bi] / sa.delta), 255)
            if stored != built:
                _fail(errors, f"segments: compacted score block-max [{t},{bi}]"
                              f" = {stored} != quantized stored impact {built}")
            if stored != int(sr.block_max[rbase + bi]):
                _fail(errors, f"segments: compacted score block-max [{t},{bi}]"
                              f" = {stored} != rebuild "
                              f"{int(sr.block_max[rbase + bi])}")
        if sa.term_max[t] != sr.term_max[t]:
            _fail(errors, f"segments: compacted term-max for {t} != rebuild")


def lint_bitmap_blocks(errors: list, device) -> None:
    """Density boundary cases for every bitmap-block codec: a block exactly
    at the ``DENSE_GAP`` cutoff and a singleton are chosen as bitmaps and
    round-trip; one gap past the cutoff the policy declines; a stream no
    window holds falls back to the raw format and still round-trips."""
    from repro_torch.core import dense_bitmap as dbm

    def gaps_of(ids: np.ndarray) -> np.ndarray:
        return np.diff(ids, prepend=np.int64(0)).astype(np.uint32)

    n = 512
    base = 4096                                   # 128-bit aligned window base
    at = base + np.arange(n, dtype=np.int64) * dbm.DENSE_GAP
    at[-1] = base + dbm.DENSE_GAP * n - 1         # span == DENSE_GAP * n
    past = at.copy()
    past[-1] += 1                                 # span == DENSE_GAP * n + 1
    single = np.array([12345], np.int64)
    overflow = np.array([0, dbm.WINDOW_BITS + 7], np.int64)   # no window fits
    for name in codec.names():
        lay = codec.get(name).arena
        if lay is None or not lay.bitmap_words:
            continue
        spec = codec.get(name)
        if not callable(lay.is_bitmap):
            _fail(errors, f"{name}: declares bitmap_words="
                          f"{lay.bitmap_words} without a callable is_bitmap")
            continue
        for tag, ids, want_eligible, want_bitmap in (
                ("at-threshold", at, True, True),
                ("past-threshold", past, False, None),
                ("singleton", single, True, True),
                ("window-overflow", overflow, False, False)):
            if dbm.eligible(ids) != want_eligible:
                _fail(errors, f"{name}: {tag} block eligibility "
                              f"{dbm.eligible(ids)} != {want_eligible}")
            enc = spec.encode(gaps_of(ids))
            if want_bitmap is not None and lay.is_bitmap(enc) != want_bitmap:
                _fail(errors, f"{name}: {tag} block stored as "
                              f"{'bitmap' if lay.is_bitmap(enc) else 'raw'}; "
                              f"expected {'bitmap' if want_bitmap else 'raw'}")
            if not np.array_equal(spec.decode_np(enc), gaps_of(ids)):
                _fail(errors, f"{name}: {tag} block does not round-trip")


def lint_shards(errors: list, device) -> None:
    """Doc-range shard consistency on the lint corpus (a mass-balanced
    derived split and an explicit uneven one with an empty shard): the spec
    partitions the docid space; each shard generation carries the parent
    gid and global dfs; the union of the shard postings (translated back by
    +lo) is the parent's; each shard's quantized codes and block maxima
    equal the parent's at the same (term, global doc), which the merged
    k-th threshold of the sharded ranked path stands on."""
    from repro_torch.index.invindex import InvertedIndex
    from repro_torch.index.scores import ScoreArena, unpack_words_np
    from repro_torch.index.shards import ShardSpec, shard_generation

    rng = np.random.default_rng(41)
    n_docs = 40_000
    postings = {}
    for t, df in enumerate([40, 300, 900, 2000, 3500]):
        ids = np.sort(rng.choice(n_docs, df, replace=False)).astype(np.uint32)
        postings[t] = (ids, rng.geometric(0.4, df).astype(np.uint32))
    doclen = rng.integers(30, 300, n_docs).astype(np.int64)
    gen = InvertedIndex.build(doclen, postings, codec="group_simple").gen
    sa = ScoreArena.from_index(gen, device=device)
    ptiles = to_np(sa.tiles)
    pcodes = {}                       # term -> {global docid: quantized code}
    for t, tp in gen.terms.items():
        m = {}
        for bi in range(len(tp.blocks)):
            ids = gen.decode_block_ids(t, bi)
            codes = unpack_words_np(ptiles[sa.slot[(t, bi)]], len(ids))
            m.update(zip(ids.tolist(), codes.tolist()))
        pcodes[t] = m

    for spec in (ShardSpec.derive(gen, 3),
                 ShardSpec((0, 100, 100, 33_000, n_docs))):
        b = spec.bounds
        if b[0] != 0 or b[-1] != n_docs:
            _fail(errors, f"shards: {spec!r} does not cover [0, {n_docs})")
            continue
        union = {t: [] for t in gen.terms}
        for lo, hi in spec.ranges():
            if hi == lo:
                continue
            sg = shard_generation(gen, lo, hi)
            if sg.gid != gen.gid:
                _fail(errors, f"shards: [{lo},{hi}) gid {sg.gid} != parent "
                              f"{gen.gid} (epoch pinning would break)")
            ssa = ScoreArena.from_index(sg, device=device)
            if ssa.delta != sa.delta:
                _fail(errors, f"shards: [{lo},{hi}) quantizer delta "
                              f"{ssa.delta} != parent {sa.delta}")
            stiles = to_np(ssa.tiles)
            for t, tp in sg.terms.items():
                if tp.df != gen.terms[t].df:
                    _fail(errors, f"shards: [{lo},{hi}) term {t} df {tp.df} "
                                  f"!= global {gen.terms[t].df}")
                for bi in range(len(tp.blocks)):
                    ids = sg.decode_block_ids(t, bi)
                    s = ssa.slot[(t, bi)]
                    codes = unpack_words_np(stiles[s], len(ids))
                    stored = int(ssa.block_max[s])
                    if stored != int(codes.max(initial=0)):
                        _fail(errors, f"shards: [{lo},{hi}) block-max "
                                      f"[{t},{bi}] = {stored} != max stored "
                                      f"code {int(codes.max(initial=0))}")
                    want = [pcodes[t].get(int(d) + lo, -1) for d in ids]
                    if codes.tolist() != want:
                        _fail(errors, f"shards: [{lo},{hi}) term {t} block "
                                      f"{bi} codes drift from the parent's "
                                      f"at the same global docs")
                    union[t].extend(int(d) + lo for d in ids)
        for t in gen.terms:
            parent_ids = np.concatenate(
                [gen.decode_block_ids(t, bi)
                 for bi in range(gen.n_blocks(t))]).astype(np.int64)
            if union[t] != parent_ids.tolist():
                _fail(errors, f"shards: {spec!r} union of term {t} postings "
                              f"!= the parent postings (lost or duplicated "
                              f"docs at the cuts)")


def lint_serving_traces(errors: list, device) -> None:
    """Serving-trace discipline on a lint-sized stream through the port's
    :class:`IndexServer`: every ``TraceRecord``'s stage stamps are monotone
    (enqueue <= close <= plan <= execute <= done), every served trace
    carries all five stamps and its batch metadata, and every
    ``BatchRecord``'s own stamps are ordered."""
    from repro_torch.index.engine import QueryEngine
    from repro_torch.index.invindex import InvertedIndex
    from repro_torch.index.serve import (STAGES, Request, ServeConfig,
                                         serve_stream)

    rng = np.random.default_rng(29)
    n_docs = 4000
    postings = {}
    for t, df in enumerate([40, 150, 500, 800]):
        ids = np.sort(rng.choice(n_docs, df, replace=False)).astype(np.uint32)
        postings[t] = (ids, rng.geometric(0.4, df).astype(np.uint32))
    doclen = rng.integers(30, 300, n_docs).astype(np.int64)
    idx = InvertedIndex.build(doclen, postings)
    engine = QueryEngine(idx).to_device(torch_device=device)
    reqs = ([Request([0, 2], deadline_ms=500) for _ in range(12)]
            + [Request([1, 3], deadline_ms=0)])      # one expired-at-enqueue
    offsets = np.arange(len(reqs)) * 1e-4
    _, stats = serve_stream(engine, reqs, offsets,
                            ServeConfig(max_batch=4, max_wait_ms=1.0,
                                        warm_terms=4))
    if not stats.traces:
        _fail(errors, "serving: lint stream produced no trace records")
    n_stamps = len(STAGES)
    for tr in stats.traces:
        s = tr.stages()
        if any(b < a for a, b in zip(s, s[1:])):
            _fail(errors, f"serving: trace rid={tr.rid} ({tr.outcome}) has "
                          f"non-monotone stage timestamps {s}")
        if tr.outcome == "served":
            if len(s) != n_stamps:
                _fail(errors, f"serving: served trace rid={tr.rid} carries "
                              f"{len(s)}/{n_stamps} stage stamps")
            if tr.batch_size < 1 or tr.placement not in ("host", "device",
                                                         "fused"):
                _fail(errors, f"serving: served trace rid={tr.rid} missing "
                              f"batch metadata (size={tr.batch_size}, "
                              f"placement={tr.placement!r})")
    for b in stats.batches:
        s = (b.t_close, b.t_plan, b.t_execute, b.t_done)
        if any(y < x for x, y in zip(s, s[1:])):
            _fail(errors, f"serving: batch {b.batch_id} has non-monotone "
                          f"stage timestamps {s}")


def lint_metrics(errors: list, device) -> None:
    """Metrics-registry discipline (``repro_torch.obs.metrics``): snake_case
    metric names, labels from the fixed ``LABEL_KEYS`` vocabulary,
    duplicate registration raising, and the same metric schema (name ->
    kind + label set) on every engine instance."""
    from repro_torch.index.engine import QueryEngine
    from repro_torch.index.invindex import InvertedIndex
    from repro_torch.index.serve import ServerStats
    from repro_torch.obs.metrics import LABEL_KEYS, MetricsRegistry

    rng = np.random.default_rng(7)
    n_docs = 2000
    postings = {}
    for t, df in enumerate([50, 200, 400]):
        ids = np.sort(rng.choice(n_docs, df, replace=False)).astype(np.uint32)
        postings[t] = (ids, rng.geometric(0.4, df).astype(np.uint32))
    doclen = rng.integers(30, 300, n_docs).astype(np.int64)
    idx = InvertedIndex.build(doclen, postings)
    regs = [("engine-a", QueryEngine(idx).metrics),
            ("engine-b", QueryEngine(idx).metrics),
            ("server", ServerStats().metrics)]

    snake = re.compile(r"^[a-z][a-z0-9_]*$")
    for owner, reg in regs:
        for name, m in reg.metrics().items():
            if not snake.match(name):
                _fail(errors, f"metrics: {owner} metric {name!r} is not "
                              f"snake_case")
            bad = set(m.labelnames) - set(LABEL_KEYS)
            if bad:
                _fail(errors, f"metrics: {owner} metric {name!r} labelled "
                              f"outside the vocabulary: {sorted(bad)}")
        bad = set(reg.const_labels) - set(LABEL_KEYS)
        if bad:
            _fail(errors, f"metrics: {owner} const labels outside the "
                          f"vocabulary: {sorted(bad)}")

    sa, sb = regs[0][1].schema(), regs[1][1].schema()
    if sa != sb:
        drift = {k for k in sa.keys() | sb.keys() if sa.get(k) != sb.get(k)}
        _fail(errors, f"metrics: engine metric schemas drift across "
                      f"instances: {sorted(drift)}")

    reg = MetricsRegistry(namespace="lint")
    reg.counter("dup_probe")
    try:
        reg.counter("dup_probe")
        _fail(errors, "metrics: duplicate registration did not raise")
    except ValueError:
        pass
    try:
        reg.counter("bad_labels", labelnames=("no_such_label",))
        _fail(errors, "metrics: out-of-vocabulary label did not raise")
    except ValueError:
        pass


CHECKS = (lint_protocol, lint_arena_contract, lint_exception_columns,
          lint_parity_coverage, lint_score_tables, lint_segments,
          lint_bitmap_blocks, lint_shards, lint_serving_traces, lint_metrics)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--torch-device", default="cuda",
                    help="device of the lint's score arenas and serve stream "
                         "(default cuda, which raises without a card; 'cpu' "
                         "runs them on the CPU)")
    args = ap.parse_args(argv)
    from repro_torch.index.device import resolve_device
    device = resolve_device(args.torch_device)
    errors: list = []
    for check in CHECKS:
        check(errors, device)
    n_arena = sum(codec.get(n).arena is not None for n in codec.names())
    n_torch = sum(codec.get(n).torch is not None for n in codec.names())
    print(f"registry lint (repro_torch on {device}): {len(codec.names())} "
          f"codecs ({n_torch} TorchDecode, {n_arena} ArenaLayout), "
          f"{len(errors)} error(s)")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
