"""The port's compressed data stores (``repro_torch.data.pipeline``)
against the JAX package's ``repro.data.pipeline`` on
``tests/test_pipeline_index.py``'s four store cases: the encoded words and
``compressed_bytes`` equal, every read equal, ``lm_batch_iter``'s batches
equal per cursor (a resumed loader included); and ``synth.concat_gaps``,
``concat_tfs`` and ``dataset_stats``."""

import numpy as np
import pytest

from repro.data import pipeline as ref_pipeline
from repro.data import synth as ref_synth
from repro.models.sampler import CSRGraph
from repro_torch.data import pipeline, synth

from _torch_parity import assert_encoded_equal


def _same_store(got, want, field: str):
    assert got.codec == want.codec
    a, b = getattr(got, field), getattr(want, field)
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert_encoded_equal(x, y, f"{field}[{i}]")
    assert got.compressed_bytes() == want.compressed_bytes()
    assert got.raw_bytes == want.raw_bytes


def _zipf_tokens():
    rng = np.random.default_rng(0)
    return np.minimum(rng.zipf(1.3, 200000), 49151).astype(np.uint32)


def test_token_store_matches_reference():
    toks = _zipf_tokens()
    got = pipeline.TokenStore.build(toks, codec="bp128", block=4096)
    want = ref_pipeline.TokenStore.build(toks, codec="bp128", block=4096)
    _same_store(got, want, "blocks")
    assert (got.block, got.n) == (want.block, want.n)
    for start, count in ((0, len(toks)), (5000, 1234), (4095, 2), (8192, 4096),
                         (len(toks) - 7, 7)):
        r = got.read(start, count)
        np.testing.assert_array_equal(r, want.read(start, count))
        np.testing.assert_array_equal(r, toks[start:start + count])
    assert got.compressed_bytes() < got.raw_bytes


@pytest.mark.parametrize("codec,block", [("group_simple", 8192), ("bp128", 4096)])
def test_lm_batch_iter_matches_reference_per_cursor(codec, block):
    toks = np.arange(100000, dtype=np.uint32) % 1000
    got = pipeline.TokenStore.build(toks, codec=codec, block=block)
    want = ref_pipeline.TokenStore.build(toks, codec=codec, block=block)
    _same_store(got, want, "blocks")
    it = pipeline.lm_batch_iter(got, batch=4, seq=16)
    ref_it = ref_pipeline.lm_batch_iter(want, batch=4, seq=16)
    cursor = 0
    for _ in range(40):        # past the wrap of (cursor * per) % (n - per)
        b, nxt = it(cursor)
        rb, rnxt = ref_it(cursor)
        assert nxt == rnxt == cursor + 1
        for k in ("tokens", "labels"):
            assert b[k].dtype == rb[k].dtype == np.int32
            np.testing.assert_array_equal(b[k], rb[k])
        np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])
        cursor = nxt
    # resume: a fresh loader at a saved cursor gives the same batches
    resumed = pipeline.lm_batch_iter(got, batch=4, seq=16)
    for c in (0, 17, 39):
        a, _ = resumed(c)
        r, _ = ref_it(c)
        np.testing.assert_array_equal(a["tokens"], r["tokens"])


def test_adjacency_store_matches_reference():
    g = CSRGraph.random(500, 20000, 0)
    got = pipeline.AdjacencyStore.build(g.indptr, g.indices, codec="group_pfd")
    want = ref_pipeline.AdjacencyStore.build(g.indptr, g.indices, codec="group_pfd")
    _same_store(got, want, "rows")
    assert (got.n_nodes, got.n_edges) == (want.n_nodes, want.n_edges)
    np.testing.assert_array_equal(got.indptr, want.indptr)
    for r in range(0, 500, 7):
        n = got.neighbors(r)
        np.testing.assert_array_equal(n, want.neighbors(r))
        np.testing.assert_array_equal(n, np.sort(g.indices[g.indptr[r]:g.indptr[r + 1]]))
    assert got.compressed_bytes() < got.raw_bytes
    # rows under min_compress go to varbyte, the rest to the named codec
    assert {e.codec for e in got.rows} == {e.codec for e in want.rows}


def test_bag_store_matches_reference():
    rng = np.random.default_rng(1)
    bags = [rng.choice(10000, size=rng.integers(5, 60), replace=False) for _ in range(50)]
    got = pipeline.BagStore.build(bags)
    want = ref_pipeline.BagStore.build(bags)
    _same_store(got, want, "bags")
    assert got.n_ids == want.n_ids
    for i in range(50):
        r = got.read(i)
        np.testing.assert_array_equal(r, want.read(i))
        np.testing.assert_array_equal(r, np.sort(bags[i]))


@pytest.mark.parametrize("name", sorted(synth.DATASETS))
def test_concat_gaps_matches_reference(name):
    got = synth.concat_gaps(synth.make_dataset(name, n_lists=40))
    want = ref_synth.concat_gaps(ref_synth.make_dataset(name, n_lists=40))
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(synth.DATASETS))
def test_concat_tfs_matches_reference(name):
    got = synth.concat_tfs(synth.make_dataset(name, n_lists=40))
    want = ref_synth.concat_tfs(ref_synth.make_dataset(name, n_lists=40))
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


def test_dataset_stats_match_paper_characteristics():
    """Port of ``tests/test_pipeline_index.py``'s case, each dataset's stats
    equal to the reference's."""
    for name in synth.DATASETS:
        stats = synth.dataset_stats(synth.make_dataset(name))
        assert stats == ref_synth.dataset_stats(ref_synth.make_dataset(name))
        assert stats["gap_fit8"] > 0.9 or stats["gap_mean"] < 300, (name, stats)
        assert stats["tf_fit8"] > 0.9, (name, stats)


def test_data_package_exports_pipeline_and_synth():
    import repro_torch.data as data
    assert data.pipeline is pipeline and data.synth is synth
