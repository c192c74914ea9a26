"""Doc-range sharded serving of the port against the JAX package's, bitwise.

The cases are ``tests/test_sharded.py``'s, on its corpus and queries: every
sharded batch of the port (``torch_device="cpu"``: every kernel wrapper
takes its plain torch version) must equal the reference's sharded batch
(its Pallas kernels in interpret mode) and the port's host oracle, in
``and``, ``or`` and ``and_scored``, on the ``device`` and ``fused``
placements, with the counters the zero-sync contract names
(``cand_syncs``, ``merge_syncs``, ``collective_bytes``,
``shard_final_syncs``) equal to the reference's.  The shard building
blocks (``ShardSpec.derive``, ``shard_generation``'s statistics fixup,
``pack_live_words_range``, ``balanced_range_bounds``,
``merge_topk_stats``) are compared word for word.  The mesh case runs on a
list of four CPU devices here; its card forms need one or two cards and
skip without them."""

import numpy as np
import pytest
import torch

from repro.distributed.collectives import merge_topk_stats as ref_merge
from repro.distributed.sharding import balanced_range_bounds as ref_balanced
from repro.index.device import _bucket as ref_bucket
from repro.index.engine import QueryBatch as RefBatch
from repro.index.engine import QueryEngine as RefEngine
from repro.index.invindex import InvertedIndex as RefIndex
from repro.index.shards import ShardSpec as RefSpec
from repro.index.shards import shard_generation as ref_shard_generation
from repro.kernels.intersect_rounds import \
    pack_live_words_range as ref_pack_range
from repro_torch.distributed.collectives import merge_topk_stats
from repro_torch.distributed.sharding import balanced_range_bounds
from repro_torch.index.engine import QueryBatch, QueryEngine
from repro_torch.index.invindex import InvertedIndex
from repro_torch.index.shards import ShardSpec, TILE_DOCS, shard_generation
from repro_torch.kernels.intersect_rounds import (bitmap_geometry,
                                                  pack_live_words,
                                                  pack_live_words_range)
from repro_torch.launch.mesh import serving_mesh

from _torch_parity import cuda_device, export_state  # noqa: F401
from test_sharded import DOCLEN, MODES, N_DOCS, POSTINGS, QUERIES

K = 10
# the counters that must equal the reference's on every sharded batch
COUNTERS = ("cand_syncs", "score_syncs", "merge_syncs", "collective_bytes",
            "shard_final_syncs")


def _pair(codec="group_simple"):
    return (RefIndex.build(DOCLEN, POSTINGS, codec=codec),
            InvertedIndex.build(DOCLEN, POSTINGS, codec=codec))


def _assert_same(mode, got, want, where):
    assert len(got) == len(want), where
    for i, (g, w) in enumerate(zip(got, want)):
        if mode == "and":
            assert g.dtype == np.uint32, where
            np.testing.assert_array_equal(g, w, err_msg=f"{where} query {i}")
        else:
            assert g == w, f"{where} query {i}: {g} != {w}"


def _compare(ref_eng, eng, host, where, placement="device",
             queries=QUERIES, modes=MODES):
    """Every mode through the reference's and the port's sharded engines
    and the port's host oracle; results and counter deltas must agree."""
    for mode in modes:
        qs = [list(q) for q in queries]
        with ref_eng.metrics.scoped() as rs, eng.metrics.scoped() as ps:
            want = ref_eng.execute(ref_eng.plan(RefBatch(qs, mode=mode, k=K),
                                                placement=placement))
            got = eng.execute(eng.plan(QueryBatch(qs, mode=mode, k=K),
                                       placement=placement))
        _assert_same(mode, got, want, (where, mode, placement, "ref"))
        oracle = host.execute(host.plan(QueryBatch(qs, mode=mode, k=K),
                                        placement="host"))
        _assert_same(mode, got, oracle, (where, mode, placement, "host"))
        for c in COUNTERS:
            assert ps.delta(c) == rs.delta(c), (where, mode, placement, c)


def _shards(codec="group_simple", **kw):
    ref_idx, idx = _pair(codec)
    ref_eng = RefEngine(ref_idx).to_device(**kw)
    eng = QueryEngine(idx).to_device(torch_device="cpu", **kw)
    return ref_idx, idx, ref_eng, eng


# --------------------------------------------------------------------------- #
# parity: 1 shard == unsharded, multi-shard sweeps
# --------------------------------------------------------------------------- #

def test_one_shard_bitwise_equals_unsharded_every_mode_and_placement():
    ref_idx, idx, ref_eng, eng = _shards(fused=True, shards=1)
    host = QueryEngine(idx)
    dev = QueryEngine(idx).to_device(fused=True, torch_device="cpu")
    for placement in ("device", "fused"):
        _compare(ref_eng, eng, host, "1shard", placement)
        for mode in MODES:
            b = QueryBatch([list(q) for q in QUERIES], mode=mode, k=K)
            _assert_same(mode, eng.execute(eng.plan(b, placement=placement)),
                         dev.execute(dev.plan(b, placement=placement)),
                         ("unsharded", mode, placement))


@pytest.mark.parametrize("codec", ["group_simple", "group_pfd"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_multi_shard_parity_sweep(codec, n_shards):
    ref_idx, idx, ref_eng, eng = _shards(codec, shards=n_shards)
    spec, _, _ = eng._shard_engines(eng._ctx_now())
    ref_spec, _, _ = ref_eng._shard_engines(ref_eng._ctx_now())
    assert spec.bounds == ref_spec.bounds
    _compare(ref_eng, eng, QueryEngine(idx), (codec, n_shards))


def test_fused_placement_parity_under_shards():
    ref_idx, idx, ref_eng, eng = _shards("group_pfd", fused=True, shards=3)
    _compare(ref_eng, eng, QueryEngine(idx), "fused", placement="fused")


def test_uneven_and_empty_explicit_bounds():
    bounds = (0, 100, 100, 17_001, N_DOCS)
    ref_idx, idx, ref_eng, eng = _shards(bounds=bounds)
    _compare(ref_eng, eng, QueryEngine(idx), "uneven")
    spec, engs, _ = eng._shard_engines(eng._ctx_now())
    assert spec.bounds == bounds
    assert engs[1] is None                  # an empty shard gets no engine
    assert sum(e is not None for e in engs) == 3


# --------------------------------------------------------------------------- #
# shard locality + the single merge collective
# --------------------------------------------------------------------------- #

def test_zero_cross_shard_syncs_and_one_merge_per_ranked_batch():
    ref_idx, idx, ref_eng, eng = _shards(shards=4)
    qs = [list(q) for q in QUERIES]
    with eng.metrics.scoped() as sample, ref_eng.metrics.scoped() as rsample:
        eng.execute(eng.plan(QueryBatch(qs, mode="or", k=K),
                             placement="device"))
        ref_eng.execute(ref_eng.plan(RefBatch(qs, mode="or", k=K),
                                     placement="device"))
    assert sample.delta("merge_syncs") == 1         # one collective a batch
    # (theta, count) of 32 bits each, per shard and query: S * nq * 8
    spec, engs, _ = eng._shard_engines(eng._ctx_now())
    live = [e for e in engs if e is not None]
    assert live and spec.n_shards == 4
    assert sample.delta("collective_bytes") == len(live) * len(qs) * 8
    for c in COUNTERS:
        assert sample.delta(c) == rsample.delta(c), c
    for eng_s in live:              # rounds never sync candidates or scores
        assert eng_s.dev_stats["cand_syncs"] == 0
        assert eng_s.dev_stats["score_syncs"] == 0
        assert eng_s.trace_lane.startswith("shard")
        assert eng_s.metrics.const_labels["shard"].startswith("s")
    # each non-empty shard contributes exactly one final download
    assert sample.delta("shard_final_syncs") == len(live)
    with eng.metrics.scoped() as sample:
        eng.execute(eng.plan(QueryBatch([[0, 1], [2, 3]], mode="and"),
                             placement="device"))
    assert sample.delta("merge_syncs") == 0         # AND merges nothing
    assert sample.delta("shard_final_syncs") == len(live)


def test_plan_note_records_shard_topology():
    ref_idx, idx, ref_eng, eng = _shards(shards=2)
    b = [[0, 1]] * 8
    note = eng.plan(QueryBatch(b, mode="or", k=K), placement="device").note
    assert "sharded x2" in note and "bounds=" in note and "logical" in note
    assert note == ref_eng.plan(RefBatch(b, mode="or", k=K),
                                placement="device").note


# --------------------------------------------------------------------------- #
# ranked superset contract, per shard
# --------------------------------------------------------------------------- #

def test_per_shard_candidates_superset_of_global_topk():
    ref_idx, idx, ref_eng, eng = _shards(shards=4)
    host = QueryEngine(idx)
    queries = [list(q) for q in QUERIES if q]
    for mode in ("or", "and_scored"):
        ref = host.execute(host.plan(QueryBatch(queries, mode=mode, k=K),
                                     placement="host"))
        eng.execute(eng.plan(QueryBatch(queries, mode=mode, k=K),
                             placement="device"))
        ref_eng.execute(ref_eng.plan(RefBatch(queries, mode=mode, k=K),
                                     placement="device"))
        spec, engs, _ = eng._shard_engines(eng._ctx_now())
        shard_cands = eng._last_shard_cands
        ranges = [r for r, e in zip(spec.ranges(), engs) if e is not None]
        assert len(shard_cands) == len(ranges)
        for s, ((lo, hi), cands) in enumerate(zip(ranges, shard_cands)):
            for i, top in enumerate(ref):
                want = [d for d, _ in top if lo <= d < hi]
                got = set((cands[i] + np.uint32(lo)).tolist())
                assert got.issuperset(want), (mode, i, lo, hi)
                # the same candidates as the reference's shard
                np.testing.assert_array_equal(
                    cands[i], ref_eng._last_shard_cands[s][i],
                    err_msg=f"{mode} shard {s} query {i}")


# --------------------------------------------------------------------------- #
# mutation epochs under shards
# --------------------------------------------------------------------------- #

def test_mutation_epochs_and_atomic_generation_swap():
    rng = np.random.default_rng(9)
    ref_idx, idx, ref_eng, eng = _shards("group_pfd", shards=3)
    host = QueryEngine(idx)
    gid0 = idx.gen.gid
    spec0, engs0, _ = eng._shard_engines(eng._ctx_now())
    assert all(e.idx.gid == gid0 for e in engs0 if e is not None)

    # tombstone-only epoch (pruning stays armed, per-shard sliced gates)
    for d in rng.choice(N_DOCS, 200, replace=False):
        idx.delete(int(d))
        ref_idx.delete(int(d))
    _compare(ref_eng, eng, host, "tomb-only")

    # delta-bearing epoch: fresh inserts served by the parent's delta scan
    for j in range(25):
        doc = {int(t): int(rng.integers(1, 5))
               for t in rng.choice(24, 4, replace=False)}
        dl = int(rng.integers(5, 100))
        idx.insert(N_DOCS + j, doc, dl)
        ref_idx.insert(N_DOCS + j, doc, dl)
    _compare(ref_eng, eng, host, "delta")

    # pin a plan, compact underneath it: the pinned plan keeps serving the
    # old generation's shard set; fresh plans serve the new one
    qs = [list(q) for q in QUERIES]
    pinned = eng.plan(QueryBatch(qs, mode="or", k=K), placement="device")
    want_pinned = eng.execute(pinned)
    idx.compact()
    ref_idx.compact()
    assert idx.gen.gid != gid0
    assert eng.execute(pinned) == want_pinned       # epoch pinning holds
    _compare(ref_eng, eng, host, "post-compact")
    # the new generation's shard set is a fresh build, all on the new gid
    _, engs1, _ = eng._shard_engines(eng._ctx_now())
    assert {e.idx.gid for e in engs1 if e is not None} == {idx.gen.gid}
    assert all(e not in engs0 for e in engs1 if e is not None)


# --------------------------------------------------------------------------- #
# shard building blocks
# --------------------------------------------------------------------------- #

def test_shard_spec_derive_covers_aligns_and_matches_reference():
    ref_idx, idx = _pair()
    for n in (1, 2, 3, 4, 7):
        spec = ShardSpec.derive(idx.gen, n)
        assert spec.bounds == RefSpec.derive(ref_idx.gen, n).bounds, n
    spec = ShardSpec.derive(idx.gen, 4)
    b = spec.bounds
    assert b[0] == 0 and b[-1] == N_DOCS and len(b) == 5
    assert all(x <= y for x, y in zip(b, b[1:]))
    assert all(x % TILE_DOCS == 0 for x in b[1:-1])     # interior cuts aligned
    assert spec.shard_of(0) == 0 and spec.shard_of(N_DOCS - 1) == 3
    for s, (lo, hi) in enumerate(spec.ranges()):
        if hi > lo:
            assert spec.shard_of(lo) == s and spec.shard_of(hi - 1) == s
    assert repr(spec) == repr(RefSpec(b))


class _GenHandle:
    """What ``export_state`` reads: an object with a ``gen``."""

    def __init__(self, gen):
        self.gen = gen


@pytest.mark.parametrize("codec", ["group_simple", "group_pfd"])
def test_shard_generation_stats_fixed_to_parent(codec):
    ref_idx, idx = _pair(codec)
    gen = idx.gen
    for lo, hi in ((4096, 12_288), (0, 100), (17_001, N_DOCS)):
        sg = shard_generation(gen, lo, hi)
        rg = ref_shard_generation(ref_idx.gen, lo, hi)
        assert sg.gid == gen.gid and (sg.doc_lo, sg.doc_hi) == (lo, hi)
        assert sg.n_docs == hi - lo
        assert sg.stat_n_docs == gen.n_docs and sg.stat_avdl == gen.avdl
        for f in ("gid", "n_docs", "doc_lo", "doc_hi", "stat_n_docs",
                  "stat_avdl", "stat_gmax"):
            assert getattr(sg, f) == getattr(rg, f), (lo, hi, f)
        # the shard generation word for word: blocks, skip tables, dfs and
        # the fixed-up block maxima
        want = export_state(_GenHandle(rg))
        got = export_state(_GenHandle(sg))
        assert got["codec"] == want["codec"] and got["gid"] == want["gid"]
        np.testing.assert_array_equal(got["doclen"], want["doclen"])
        assert sorted(got["terms"]) == sorted(want["terms"])
        for t, w in want["terms"].items():
            g = got["terms"][t]
            assert g["df"] == w["df"] == gen.terms[t].df     # global df
            for f in ("firsts", "lasts"):
                np.testing.assert_array_equal(g[f], w[f])
            assert g["impact_bmax"].tobytes() == w["impact_bmax"].tobytes()
            for field in ("gaps", "tfs"):
                for eg, ew in zip(g[field], w[field]):
                    assert eg["codec"] == ew["codec"] and eg["n"] == ew["n"]
                    for part in ("control", "data", "exceptions"):
                        a, b = eg[part], ew[part]
                        assert (a is None) == (b is None), (t, field, part)
                        if a is not None:
                            np.testing.assert_array_equal(
                                np.asarray(a), np.asarray(b))
            ids, tfs = sg.decode_term(t)
            gids_, gtfs = gen.decode_term(t)
            m = (gids_ >= lo) & (gids_ < hi)
            np.testing.assert_array_equal(ids.astype(np.int64) + lo,
                                          gids_[m].astype(np.int64))
            np.testing.assert_array_equal(tfs, gtfs[m])


def test_pack_live_words_range_equals_sliced_translation():
    rng = np.random.default_rng(3)
    dead = np.sort(rng.choice(N_DOCS, 300, replace=False)).astype(np.int64)
    for lo, hi in ((0, N_DOCS), (4096, 12_288), (100, 17_001), (50, 51)):
        words, _ = bitmap_geometry(hi - lo)
        sub = dead[(dead >= lo) & (dead < hi)] - lo
        got = pack_live_words_range(dead, lo, hi, words)
        np.testing.assert_array_equal(got, pack_live_words(sub, hi - lo,
                                                           words))
        np.testing.assert_array_equal(got, ref_pack_range(dead, lo, hi,
                                                          words))


def test_shard_spec_rejects_bad_bounds():
    with pytest.raises(ValueError):
        ShardSpec((5, 10))              # must start at 0
    with pytest.raises(ValueError):
        ShardSpec((0, 10, 5))           # must be non-decreasing
    with pytest.raises(ValueError):
        ShardSpec((0,))                 # needs at least (0, n_docs)
    with pytest.raises(ValueError):
        shard_generation(_pair()[1].gen, 10, 10)      # empty range
    idx = _pair()[1]
    with pytest.raises(ValueError, match="define 2 shard"):
        QueryEngine(idx).to_device(shards=3, bounds=(0, 5, N_DOCS),
                                   torch_device="cpu")
    with pytest.raises(ValueError, match="at least one shard"):
        QueryEngine(idx).to_device(shards=0, torch_device="cpu")


def test_collective_bytes_count_the_batch_not_its_bucket():
    """The port launches at the batch's own length, so its merge moves
    ``S * nq * 8`` bytes; the reference pads the batch to a jit bucket
    and counts ``S * _bucket(nq) * 8``.  Five queries tell them apart; the
    results stay equal."""
    ref_idx, idx, ref_eng, eng = _shards(shards=4)
    qs = [list(q) for q in QUERIES[:5]]
    assert ref_bucket(len(qs)) != len(qs)
    with eng.metrics.scoped() as sample, ref_eng.metrics.scoped() as rsample:
        got = eng.execute(eng.plan(QueryBatch(qs, mode="or", k=K),
                                   placement="device"))
        want = ref_eng.execute(ref_eng.plan(RefBatch(qs, mode="or", k=K),
                                            placement="device"))
    _assert_same("or", got, want, "nq=5")
    live = sum(e is not None for e in eng._shard_engines(eng._ctx_now())[1])
    assert sample.delta("merge_syncs") == rsample.delta("merge_syncs") == 1
    assert sample.delta("collective_bytes") == live * len(qs) * 8
    assert rsample.delta("collective_bytes") == (live * ref_bucket(len(qs))
                                                 * 8)


def test_balanced_bounds_and_merge_match_reference():
    rng = np.random.default_rng(12)
    for n in (0, 1, 5, 40):
        w = rng.integers(0, 50, n).astype(np.float64)
        for parts in (1, 2, 3, 8):
            assert balanced_range_bounds(w, parts) == ref_balanced(w, parts)
    lumpy = np.zeros(16)
    lumpy[3] = 1e6
    assert balanced_range_bounds(lumpy, 4) == ref_balanced(lumpy, 4)
    th = [rng.integers(0, 1 << 16, 8).astype(np.uint32) for _ in range(3)]
    cnt = [rng.integers(0, 500, 8).astype(np.int32) for _ in range(3)]
    want = ref_merge(th, cnt)
    for mesh in (None, [torch.device("cpu")] * 3):
        got = merge_topk_stats([torch.as_tensor(a.astype(np.int32))
                                for a in th],
                               [torch.as_tensor(c) for c in cnt], mesh=mesh)
        assert got[0].dtype == np.int64
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2] == 3 * 8 * 8


# --------------------------------------------------------------------------- #
# placed shards: one device per shard
# --------------------------------------------------------------------------- #

def test_mesh_of_cpu_devices_parity():
    """``mesh=`` a list of one device per shard: each sub-engine's arenas
    on its device, the merge gathered onto the first one.  Four CPU
    devices here take the mesh path the cards take."""
    ref_idx, idx = _pair()
    mesh = [torch.device("cpu")] * 4
    eng = QueryEngine(idx).to_device(shards=4, mesh=mesh, torch_device="cpu")
    ref_eng = RefEngine(ref_idx).to_device(shards=4)
    _compare(ref_eng, eng, QueryEngine(idx), "mesh")
    note = eng.plan(QueryBatch(QUERIES[:4], mode="or", k=K),
                    placement="device").note
    assert "mesh-placed" in note
    spec, engs, got_mesh = eng._shard_engines(eng._ctx_now())
    assert got_mesh == mesh
    for e in engs:
        if e is not None:
            assert e._shard_device == torch.device("cpu")
            assert e.arena.device == torch.device("cpu")
    if torch.cuda.device_count() < 4:
        assert serving_mesh(4) is None      # too few cards: logical shards


def test_sharded_to_device_on_the_card_without_one_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the raise is for machines without")
    idx = _pair()[1]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QueryEngine(idx).to_device(shards=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QueryEngine(idx).to_device(shards=2, torch_device="cuda")
    assert serving_mesh(1) is None


@pytest.mark.cuda
def test_two_shard_batch_on_the_card_equals_cpu(cuda_device):
    """A 2-shard engine on the card (kernels B1-B4 per shard) returns the
    CPU engine's results, bitwise, in every mode on both placements."""
    idx = _pair()[1]
    cpu = QueryEngine(idx).to_device(fused=True, shards=2,
                                     torch_device="cpu")
    card = QueryEngine(idx).to_device(fused=True, shards=2,
                                      torch_device=cuda_device)
    for placement in ("device", "fused"):
        for mode in MODES:
            b = QueryBatch([list(q) for q in QUERIES], mode=mode, k=K)
            with card.metrics.scoped() as sample:
                got = card.execute(card.plan(b, placement=placement))
            _assert_same(mode, got, cpu.execute(cpu.plan(b,
                                                         placement=placement)),
                         (mode, placement))
            assert sample.delta("cand_syncs") == 0


@pytest.mark.cuda
def test_mesh_of_two_cards_equals_cpu(cuda_device):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: one shard on each")
    idx = _pair()[1]
    mesh = serving_mesh(2)
    assert mesh == [torch.device("cuda", 0), torch.device("cuda", 1)]
    cpu = QueryEngine(idx).to_device(shards=2, torch_device="cpu")
    card = QueryEngine(idx).to_device(shards=2, mesh=mesh)
    _, engs, _ = card._shard_engines(card._ctx_now())
    assert [e.arena.device for e in engs] == mesh
    for mode in MODES:
        b = QueryBatch([list(q) for q in QUERIES], mode=mode, k=K)
        _assert_same(mode, card.execute(card.plan(b, placement="device")),
                     cpu.execute(cpu.plan(b, placement="device")), mode)
