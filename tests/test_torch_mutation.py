"""Mutation epochs of the port (tombstones, a delta segment, ``compact()``)
against the JAX package's engine and against a from-scratch rebuild of the
live corpus, bitwise.

The cases are ``tests/test_mutation.py``'s, each on ``group_simple`` (the
index's default long-list codec) and on ``group_pfd`` (exception streams
in the arena), as the reference runs them on both.  Every index mutation goes to a reference index and to a
port index alike; each query step runs every mode on the port's host,
device and fused placements (``torch_device="cpu"``: every kernel wrapper
takes its plain torch version), on the reference's three placements (its
Pallas kernels in interpret mode) and on the port's host engine over an
index rebuilt from a plain-dict oracle of the live docs.  Results, counters
that the zero-sync contract names and ``tomb_gates`` must agree."""

import numpy as np
import pytest

from repro.index.engine import QueryBatch as RefBatch
from repro.index.engine import QueryEngine as RefEngine
from repro.index.invindex import InvertedIndex as RefIndex
from repro.index.scores import ScoreArena as RefScoreArena
from repro_torch.index.engine import QueryBatch, QueryEngine
from repro_torch.index.invindex import InvertedIndex
from repro_torch.index.scores import TOP_TABLE, ScoreArena

from test_mutation import (K, MODES, N_STEPS, QUERY_EVERY, _random_doc,
                           _random_queries, _seed_corpus)

CODECS = ("group_simple", "group_pfd")
PLACEMENTS = ("host", "device", "fused")
SYNC_COUNTERS = ("cand_syncs", "score_syncs", "final_syncs", "tomb_gates")


def _port_engine(idx, placement: str) -> QueryEngine:
    eng = QueryEngine(idx)
    if placement != "host":
        eng.to_device(fused=placement == "fused", torch_device="cpu")
    return eng


def _ref_engine(idx, placement: str) -> RefEngine:
    eng = RefEngine(idx)
    if placement != "host":
        eng.to_device(fused=placement == "fused")
    return eng


@pytest.fixture(params=CODECS)
def codec(request) -> str:
    return request.param


def _assert_same(mode: str, got: list, want: list, where: str) -> None:
    assert len(got) == len(want), where
    for i, (g, w) in enumerate(zip(got, want)):
        if mode == "and":
            assert g.dtype == np.uint32, where
            np.testing.assert_array_equal(g, w, err_msg=f"{where} query {i}")
        else:
            # bitwise: float equality, order and docid ties
            assert g == w, f"{where} query {i}: {g} != {w}"


class DualModel:
    """A reference index and a port index under the same mutations, their
    engines (persistent across the run, as a serving process keeps them),
    and a plain-dict oracle of the live corpus."""

    def __init__(self, doclen, postings, n_terms, codec,
                 placements=PLACEMENTS):
        self.n_terms = n_terms
        self.codec = codec
        self.ref_idx = RefIndex.build(doclen, postings, codec=codec)
        self.idx = InvertedIndex.build(doclen, postings, codec=codec)
        # docid -> {term: tf} for live docs; docid -> last-set doclen
        self.live: dict = {d: {} for d in range(len(doclen))}
        self.dl: dict = {d: int(v) for d, v in enumerate(doclen)}
        for t, (ids, tfs) in postings.items():
            for d, f in zip(ids.tolist(), tfs.tolist()):
                self.live[int(d)][int(t)] = int(f)
        self.base_docs = len(doclen)
        self.engines = [(p, _port_engine(self.idx, p),
                         _ref_engine(self.ref_idx, p)) for p in placements]
        # the candidate lists each device batch downloads, port and reference
        self.cands = {p: {"port": _capture_cands(e), "ref": _capture_cands(r)}
                      for p, e, r in self.engines if p != "host"}
        self.steps = 0

    def insert(self, docid, terms, doclen):
        self.ref_idx.insert(docid, terms, doclen)
        self.idx.insert(docid, terms, doclen)
        self.live[docid] = dict(terms)
        self.dl[docid] = int(doclen)
        self.steps += 1

    def delete(self, docid):
        want = self.ref_idx.delete(docid)
        assert self.idx.delete(docid) == want, docid
        if docid in self.live:
            assert want, f"delete({docid}) missed a live doc"
        self.live.pop(docid, None)
        self.steps += 1

    def compact(self):
        gid = self.idx.gen.gid
        self.ref_idx.compact()
        assert self.idx.compact().gid == gid + 1
        assert not self.idx.mutated
        self.steps += 1

    def oracle(self) -> QueryEngine:
        """A host engine over an index rebuilt from the oracle dicts."""
        space = max(max(self.dl, default=-1) + 1, self.base_docs)
        doclen = np.zeros(space, np.int64)
        for d, v in self.dl.items():
            doclen[d] = v
        postings: dict = {}
        for d in sorted(self.live):
            for t, f in self.live[d].items():
                ids, tfs = postings.setdefault(t, ([], []))
                ids.append(d)
                tfs.append(f)
        postings = {t: (np.asarray(i, np.uint32), np.asarray(f, np.uint32))
                    for t, (i, f) in postings.items()}
        return QueryEngine(InvertedIndex.build(doclen, postings,
                                               codec=self.codec))

    def check_queries(self, queries):
        ora = self.oracle()
        for mode in MODES:
            want = ora.execute(QueryBatch(queries, mode=mode, k=K))
            for name, eng, ref in self.engines:
                where = f"{name}/{mode}/{queries} @step {self.steps}"
                got = eng.execute(QueryBatch(queries, mode=mode, k=K))
                _assert_same(mode, got, want, where)
                _assert_same(mode, got, ref.execute(
                    RefBatch(queries, mode=mode, k=K)), f"{where} (reference)")
        for c in self.cands.values():
            _assert_same_cands(c, len(c["ref"]))
        self.steps += 1

    def assert_zero_syncs(self):
        """No per-round download under any epoch, one final download a
        device batch, and the live-row gates counted as the reference
        counts them."""
        for name, eng, ref in self.engines:
            for c in SYNC_COUNTERS:
                assert eng.dev_stats[c] == ref.dev_stats[c], (name, c)
            if name == "host":
                continue
            assert eng.dev_stats["cand_syncs"] == 0, name
            assert eng.dev_stats["score_syncs"] == 0, name
            assert eng.dev_stats["final_syncs"] > 0, name
            assert eng.dev_stats["tomb_gates"] > 0, name


def _run_interleaving(model, rng, n_steps):
    """``test_mutation``'s seeded interleaving of inserts (fresh docids,
    upserts of base and of delta docs), deletes, compactions and query
    steps."""
    next_docid = model.base_docs
    while model.steps < n_steps:
        op = rng.random()
        if model.steps % QUERY_EVERY == QUERY_EVERY - 1:
            model.check_queries(_random_queries(rng, model.n_terms))
        elif op < 0.40:
            r = rng.random()
            if r < 0.5:
                d, next_docid = next_docid, next_docid + 1
            elif r < 0.8:
                d = int(rng.integers(0, model.base_docs))
            else:
                d = int(rng.integers(model.base_docs, next_docid + 1))
            terms, dl = _random_doc(rng, model.n_terms)
            model.insert(d, terms, dl)
        elif op < 0.70:
            model.delete(int(rng.integers(0, next_docid + 2)))
        elif op < 0.78 and model.idx.mutated:
            model.compact()
        else:
            model.delete(int(rng.integers(0, model.base_docs)))
    model.check_queries(_random_queries(rng, model.n_terms))


@pytest.mark.parametrize("codec,seed", [("group_simple", 0),
                                        ("group_pfd", 1)])
def test_stateful_mutation_differential(codec, seed):
    """More than 200 seeded insert / delete / compact / query steps; every
    query step bitwise equal to the rebuild and to the reference on every
    placement and mode, with no per-round sync."""
    rng = np.random.default_rng(seed)
    doclen, postings = _seed_corpus(rng, n_docs=400, n_terms=8)
    model = DualModel(doclen, postings, n_terms=8, codec=codec)
    _run_interleaving(model, rng, N_STEPS)
    assert model.steps >= 200
    model.assert_zero_syncs()


def test_delta_only_corpus_all_placements(codec):
    """A corpus held entirely by the delta segment (the generation has docs
    and no terms), before and after its first compaction."""
    rng = np.random.default_rng(7)
    model = DualModel(np.full(10, 25, np.int64), {}, n_terms=5, codec=codec)
    for _ in range(30):
        terms, dl = _random_doc(rng, 5)
        model.insert(int(rng.integers(0, 40)), terms, dl)
    queries = [[0, 1], [2], [3, 4, 0], [1, 2, 3]]
    plan = model.engines[1][1].plan(QueryBatch(queries, mode="and"))
    assert "delta doc(s)" in plan.note
    assert all(c.codec is None and not c.arena for c in plan.terms.values())
    model.check_queries(queries)
    model.compact()
    model.check_queries(queries)
    model.assert_zero_syncs()


def test_delta_only_term_beside_base_terms(codec):
    """Queries that mix generation terms with a term only the delta holds:
    the generation half is empty for AND (delta docids shadow their base
    copies) and the delta scan carries every match."""
    rng = np.random.default_rng(11)
    doclen, postings = _seed_corpus(rng, n_docs=350, n_terms=6)
    model = DualModel(doclen, postings, n_terms=6, codec=codec)
    model.delete(7)
    for d, terms in ((351, {0: 2, 9: 1}), (12, {0: 1, 1: 3, 9: 2}),
                     (400, {9: 4}), (30, {1: 1, 9: 1})):
        model.insert(d, terms, 40)
    model.check_queries([[0, 9], [9], [0, 1, 9], [1, 9, 2], [0, 1]])
    model.assert_zero_syncs()


def test_tombstone_only_mutation(codec):
    """Deletes with an empty delta segment: the live-row gate alone."""
    rng = np.random.default_rng(3)
    doclen, postings = _seed_corpus(rng, n_docs=300, n_terms=6)
    model = DualModel(doclen, postings, n_terms=6, codec=codec)
    for d in rng.choice(300, 40, replace=False).tolist():
        model.delete(int(d))
    assert not model.idx.delta and model.idx.tomb
    model.check_queries(_random_queries(rng, 6, nq=5))
    model.assert_zero_syncs()


# --------------------------------------------------------------------------- #
# generation pinning
# --------------------------------------------------------------------------- #


def _pin_fixture(codec):
    """``test_mutation``'s pinning corpus (350 docs, 6 terms) as a
    reference and a port index."""
    rng = np.random.default_rng(11)
    doclen, postings = _seed_corpus(rng, n_docs=350, n_terms=6)
    return (rng, RefIndex.build(doclen, postings, codec=codec),
            InvertedIndex.build(doclen, postings, codec=codec))


def _both(fn, ref_idx, idx):
    fn(ref_idx)
    fn(idx)


@pytest.mark.parametrize("fused", [False, True])
def test_plan_pins_generation_across_compact(fused, codec):
    """A plan made before ``compact()`` keeps returning its epoch's results
    from the old generation's arena; a fresh plan on the same engine serves
    the new generation."""
    _, ref_idx, idx = _pin_fixture(codec)
    eng = QueryEngine(idx).to_device(fused=fused, torch_device="cpu")
    queries = [[0, 1], [2, 3, 4], [1, 5], [0, 2]]
    plans = {m: eng.plan(QueryBatch(queries, mode=m, k=K)) for m in MODES}
    before = {m: eng.execute(plans[m]) for m in MODES}
    ref = RefEngine(ref_idx)
    for m in MODES:
        _assert_same(m, before[m], ref.execute(RefBatch(queries, mode=m,
                                                        k=K)), m)
    old_arena = eng.arena

    def mutate(ix):
        for d in (3, 50, 51, 120):
            ix.delete(d)
        ix.insert(5, {0: 4, 1: 1}, 30)
        ix.insert(360, {2: 2}, 15)
        ix.compact()
    _both(mutate, ref_idx, idx)
    old_gid = plans["and"].ctx.gen.gid
    assert idx.gen.gid == old_gid + 1
    for m in MODES:
        _assert_same(m, eng.execute(plans[m]), before[m], f"pinned {m}")
    assert eng.arena is old_arena      # the engine itself has not moved yet
    fresh = eng.plan(QueryBatch(queries, mode="and"))
    assert fresh.ctx.gen.gid == old_gid + 1
    assert eng.arena is not old_arena and eng.arena.idx is idx.gen
    for m in MODES:
        want = RefEngine(ref_idx).execute(RefBatch(queries, mode=m, k=K))
        _assert_same(m, eng.execute(eng.plan(QueryBatch(queries, mode=m,
                                                        k=K))), want, m)


def test_plan_pins_mutation_epoch_without_compact(codec):
    """Pinning is per epoch: writes after planning stay invisible to the
    plan, and a fresh plan sees them (as the reference does)."""
    _, ref_idx, idx = _pin_fixture(codec)
    eng = QueryEngine(idx).to_device(fused=False, torch_device="cpu")
    ref = RefEngine(ref_idx).to_device(fused=False)

    def first(ix):
        ix.delete(10)
        ix.insert(400, {0: 2, 3: 1}, 20)
    _both(first, ref_idx, idx)
    queries = [[0, 3], [1, 2], [0, 1, 2]]
    plan = eng.plan(QueryBatch(queries, mode="and_scored", k=K))
    assert plan.note.startswith("pinned epoch")
    before = eng.execute(plan)
    assert before == ref.execute(ref.plan(RefBatch(queries, mode="and_scored",
                                                   k=K)))

    def later(ix):
        ix.delete(0)
        ix.insert(401, {0: 9}, 10)
    _both(later, ref_idx, idx)
    assert eng.execute(plan) == before
    live_now = eng.execute(eng.plan(QueryBatch(queries, mode="and_scored",
                                               k=K)))
    assert live_now != before
    assert live_now == ref.execute(ref.plan(RefBatch(
        queries, mode="and_scored", k=K)))


def _capture_cands(eng) -> list:
    """Record the candidate lists each ranked batch of ``eng`` downloads
    (the argument of its ``_ranked_rescore``)."""
    got, orig = [], eng._ranked_rescore

    def keep(*a):
        got.append([np.asarray(c) for c in a[1]])
        return orig(*a)
    eng._ranked_rescore = keep
    return got


def _assert_same_cands(cands: dict, n_batches: int) -> None:
    assert len(cands["port"]) == len(cands["ref"]) == n_batches
    for got, want in zip(cands["port"], cands["ref"]):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fused", [False, True])
def test_tombstone_only_ranked_superset_contract(fused, codec):
    """Ranked top-k under tombstones, no compaction: the armed candidate
    set still holds the true top-k (results equal the rebuild), no deleted
    doc appears, and the candidate sets the one download carries, and what
    block-max pruning drops, equal the reference's (the theta cut stays
    armed through the deflated scale)."""
    rng, ref_idx, idx = _pin_fixture(codec)
    dead = sorted(int(d) for d in rng.choice(350, 60, replace=False))
    for d in dead:
        ref_idx.delete(d)
        idx.delete(d)
    eng = QueryEngine(idx).to_device(fused=fused, torch_device="cpu")
    ref = RefEngine(ref_idx).to_device(fused=fused)
    queries = [[0, 1, 2], [3, 4], [1, 5], [2, 4, 5]]
    cands = {"port": _capture_cands(eng), "ref": _capture_cands(ref)}
    deadset = set(dead)
    postings = {}
    for t in range(6):
        ids, tfs = idx.gen.decode_term(t)
        keep = [j for j, d in enumerate(ids.tolist()) if d not in deadset]
        if keep:
            postings[t] = (ids[keep], tfs[keep])
    ora = QueryEngine(InvertedIndex.build(np.asarray(idx.doclen_now()),
                                          postings, codec=codec))
    for mode in ("or", "and_scored"):
        want = ora.execute(QueryBatch(queries, mode=mode, k=K))
        got = eng.execute(QueryBatch(queries, mode=mode, k=K))
        assert got == want, mode
        assert got == ref.execute(RefBatch(queries, mode=mode, k=K)), mode
        for res in got:
            assert not any(d in deadset for d, _ in res)
    _assert_same_cands(cands, 2)
    for c in ("blocks_pruned", "blocks_scored", "tomb_gates", "score_syncs",
              "final_syncs"):
        assert eng.dev_stats[c] == ref.dev_stats[c], c
    assert eng.dev_stats["score_syncs"] == 0
    assert eng.dev_stats["tomb_gates"] > 0


@pytest.mark.parametrize("fused", [False, True])
def test_tombstone_only_epoch_keeps_pruning_armed_and_exact(fused, codec):
    """``test_ranked``'s rare-clustered corpus, where block-max pruning
    fires, under deletes that include the top-table docs of the query
    terms: the port prunes the blocks the reference prunes (deflated
    thresholds, ``theta0_live``), downloads the same candidates, and every
    result equals the rebuild of the live corpus."""
    from test_ranked import DOCLEN, N_DOCS, POSTINGS
    ref_idx = RefIndex.build(DOCLEN, POSTINGS, codec=codec)
    idx = InvertedIndex.build(DOCLEN, POSTINGS, codec=codec)
    eng = QueryEngine(idx).to_device(fused=fused, torch_device="cpu")
    sa = eng.arena.ensure_scores().scores
    rng = np.random.default_rng(31)
    dead = set(int(d) for d in rng.choice(N_DOCS, 30, replace=False))
    for t in (3, 5, 7, 10):
        dead.update(int(d) for d in sa.term_top_ids[t][:4])
    for d in sorted(dead):
        ref_idx.delete(d)
        idx.delete(d)
    ref = RefEngine(ref_idx).to_device(fused=fused)
    live = {}
    for t, (ids, tfs) in POSTINGS.items():
        keep = np.asarray([j for j, d in enumerate(ids.tolist())
                           if d not in dead], np.int64)
        if len(keep):
            live[t] = (ids[keep], tfs[keep])
    rebuilt = QueryEngine(InvertedIndex.build(DOCLEN, live, codec=codec))
    cands = {"port": _capture_cands(eng), "ref": _capture_cands(ref)}
    prunes = {"port": [], "ref": []}
    for name, e in (("port", eng), ("ref", ref)):
        def prune(sa_, occs, r, theta0, iq=1 << 16,
                  _orig=e._prune_ranked_blocks, _got=prunes[name]):
            _got.append((tuple(occs), r, int(theta0), int(iq)))
            return _orig(sa_, occs, r, theta0, iq)
        e._prune_ranked_blocks = prune
    queries = [[10, 7], [10, 3], [10, 7, 5], [0, 7], [3, 5, 8]] * 3
    # the epoch's ranked parameters: tombstone-only, armed, the known-term
    # margins and each query's deflated Q16.16 scale, and the static
    # thresholds from the filtered top tables
    params = eng._ranked_params(queries, 6, eng._cur())
    want = ref._ranked_params(queries, 6, ref._cur())
    assert params[2:4] == (True, True) and params[:4] == want[:4]
    assert list(params[4]) == list(want[4])
    assert list(params[5]) == [int(v) for v in want[5]]
    assert min(params[5]) < 1 << 16
    ref_sa = ref.arena.ensure_scores().scores
    for ts in params[1]:
        assert (sa.theta0_live(ts, 6, eng._cur().dead)
                == ref_sa.theta0_live(ts, 6, ref._cur().dead)), ts
    for mode in ("or", "and_scored"):
        want = rebuilt.execute(QueryBatch(queries, mode=mode, k=6))
        got = eng.execute(eng.plan(QueryBatch(queries, mode=mode, k=6)))
        assert got == want, mode
        assert got == ref.execute(ref.plan(RefBatch(queries, mode=mode,
                                                    k=6))), mode
    _assert_same_cands(cands, 2)
    # each OR entry pruned against the same static threshold and scale
    assert prunes["port"] == prunes["ref"] and prunes["port"]
    for c in ("blocks_pruned", "blocks_scored", "tomb_gates", "score_syncs"):
        assert eng.dev_stats[c] == ref.dev_stats[c], c
    assert eng.dev_stats["blocks_pruned"] > 0
    assert eng.dev_stats["tomb_gates"] == 2


# --------------------------------------------------------------------------- #
# generation- and epoch-keyed caches
# --------------------------------------------------------------------------- #


def test_caches_keyed_by_generation_not_stale_after_compact(codec):
    """After a ``compact()`` that rewrites a term's first block, a warm
    engine serves the new postings: every block-cache entry carries its gid
    and every score-cache entry its epoch."""
    _, ref_idx, idx = _pin_fixture(codec)
    eng = QueryEngine(idx)
    queries = [[0, 1], [0], [1, 2]]
    eng.execute(QueryBatch(queries, mode="and"))
    eng.execute(QueryBatch(queries, mode="or", k=K))
    gid0 = idx.gen.gid
    keys0 = set(eng.cache.keys())
    assert keys0 and all(k[-1] == gid0 for k in keys0)
    t0_ids = idx.gen.decode_term(0)[0]

    def mutate(ix):
        for d in t0_ids[:5].tolist():
            ix.delete(int(d))
        ix.insert(500, {0: 3, 1: 1}, 40)
        ix.compact()
    _both(mutate, ref_idx, idx)
    for mode in ("and", "or"):
        want = RefEngine(ref_idx).execute(RefBatch(queries, mode=mode, k=K))
        _assert_same(mode, eng.execute(QueryBatch(queries, mode=mode, k=K)),
                     want, mode)
    assert any(k[-1] == gid0 + 1 for k in eng.cache.keys())
    assert any(k[1] == gid0 + 1 for k in eng.score_cache.keys())


def test_score_cache_keyed_by_tombstone_epoch(codec):
    """Score vectors depend on live df and avdl, so one tombstone without
    compaction misses the old score-cache entry."""
    _, ref_idx, idx = _pin_fixture(codec)
    eng = QueryEngine(idx)
    r0 = eng.or_query([0, 1], k=K)
    d = int(idx.gen.decode_term(0)[0][0])
    _both(lambda ix: ix.delete(d), ref_idx, idx)
    r1 = eng.or_query([0, 1], k=K)
    assert r1 == RefEngine(ref_idx).or_query([0, 1], k=K)
    assert r1 == QueryEngine(idx).or_query([0, 1], k=K)
    assert r1 != r0


def test_theta0_live_matches_reference(codec):
    """``ScoreArena.theta0_live`` against the reference's on a table whose
    top ids are partly dead: some terms keep k live top codes, one loses so
    many that its k-th survivor falls off the table (it then gives 0)."""
    rng, ref_idx, idx = _pin_fixture(codec)
    sa = ScoreArena(idx.gen, device="cpu")
    ref_sa = RefScoreArena(ref_idx.gen)
    assert sa.term_tops.keys() == ref_sa.term_tops.keys()
    tops1 = sa.term_top_ids[1].astype(np.int64)
    dead_sets = {
        "none": np.zeros(0, np.int64),
        "scattered": np.unique(np.concatenate([
            sa.term_top_ids[t][::3].astype(np.int64) for t in range(6)])),
        "term 1's table": np.unique(np.concatenate([
            tops1[:TOP_TABLE - 2],
            rng.choice(350, 40, replace=False).astype(np.int64)])),
    }
    for name, dead in dead_sets.items():
        for terms in ([0], [1], [0, 1, 2], [3, 4, 5], list(range(6))):
            for k in (1, 3, 5, 10, TOP_TABLE):
                got = sa.theta0_live(terms, k, dead)
                want = ref_sa.theta0_live(terms, k, dead)
                assert got == want, (name, terms, k)
    assert sa.theta0_live([1], 5, dead_sets["term 1's table"]) == 0
    assert sa.theta0_live([1], 5, dead_sets["none"]) == sa.theta0([1], 5)
