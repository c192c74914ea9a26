"""The port's index against the JAX package's: ``InvertedIndex.build`` gives
the same encoded words, skip tables and impact maxima; an index carried
across with ``from_state(export_state(ref))`` serves the same results; and
``DeviceArena.decode_blocks`` equals the reference's, on the corpus of
``test_device_arena.py`` (1,500 docs), for the index's three codecs and
the Group-PFD index."""

import numpy as np
import pytest

from repro.index.device import DeviceArena as RefArena
from repro.index.engine import QueryBatch as RefBatch
from repro.index.engine import QueryEngine as RefEngine
from repro.index.invindex import InvertedIndex as RefIndex
from repro_torch.index.device import DeviceArena
from repro_torch.index.engine import QueryBatch, QueryEngine
from repro_torch.index.invindex import InvertedIndex

from _torch_parity import assert_encoded_equal, assert_u32_equal, export_state
from test_device_arena import DOCLEN, POSTINGS, QUERIES

CODECS = ("group_simple", "stream_vbyte", "dense_bitmap")


def _assert_same_index(got, want):
    assert got.n_docs == want.n_docs and got.codec == want.codec
    assert sorted(got.terms) == sorted(want.terms)
    assert got.avdl == want.avdl
    for t, wp in want.terms.items():
        gp = got.terms[t]
        assert gp.df == wp.df and len(gp.blocks) == len(wp.blocks), t
        for bi, (g, w) in enumerate(zip(gp.blocks, wp.blocks)):
            assert g[0] == w[0], (t, bi)
            assert_encoded_equal(g[1], w[1], f"t={t} b={bi} gaps")
            assert_encoded_equal(g[2], w[2], f"t={t} b={bi} tfs")
        np.testing.assert_array_equal(got.block_lasts(t), want.block_lasts(t))
        # float64 maxima from the same numpy code: equal bit for bit
        np.testing.assert_array_equal(
            got.impact_block_max(t).view(np.uint64),
            want.impact_block_max(t).view(np.uint64))


@pytest.mark.parametrize("name", CODECS)
def test_build_matches_reference(name):
    ref = RefIndex.build(DOCLEN, POSTINGS, codec=name)
    _assert_same_index(InvertedIndex.build(DOCLEN, POSTINGS, codec=name), ref)


def test_from_state_serves_the_reference_index():
    ref = RefIndex.build(DOCLEN, POSTINGS, codec="group_simple")
    idx = InvertedIndex.from_state(export_state(ref))
    _assert_same_index(idx, ref)
    want = RefEngine(ref).execute(RefBatch(QUERIES, mode="and"))
    eng = QueryEngine(idx).to_device(fused=True, torch_device="cpu")
    got = eng.execute(eng.plan(QueryBatch(QUERIES, mode="and"),
                               placement="fused"))
    for q, a, b in zip(QUERIES, got, want):
        np.testing.assert_array_equal(a, b, err_msg=str(q))


def test_from_state_refuses_unported_codecs():
    """``from_state`` serves a reference ``group_pfd`` index (exception
    streams and all) as the reference serves it; a state whose codec name
    neither package registers raises the registry's ``KeyError``."""
    ref = RefIndex.build(DOCLEN, POSTINGS, codec="group_pfd")
    state = export_state(ref)
    idx = InvertedIndex.from_state(state)
    _assert_same_index(idx, ref)
    want = RefEngine(ref).execute(RefBatch(QUERIES, mode="and"))
    eng = QueryEngine(idx).to_device(torch_device="cpu")
    got = eng.execute(eng.plan(QueryBatch(QUERIES, mode="and"),
                               placement="device"))
    for q, a, b in zip(QUERIES, got, want):
        np.testing.assert_array_equal(a, b, err_msg=str(q))
    assert eng.arena.stats["blocks_host"] == 0
    state["codec"] = "group_pfd2"
    with pytest.raises(KeyError, match="unknown codec 'group_pfd2'"):
        InvertedIndex.from_state(state)


@pytest.mark.parametrize("name", CODECS)
def test_arena_decode_blocks_matches_reference(name):
    ref_idx = RefIndex.build(DOCLEN, POSTINGS, codec=name)
    idx = InvertedIndex.build(DOCLEN, POSTINGS, codec=name)
    entries = [(t, bi, f) for t, tp in idx.terms.items()
               for bi in range(len(tp.blocks)) for f in (0, 1)]
    ref_ar = RefArena.from_index(ref_idx, build_fused=False)
    ar = DeviceArena.from_index(idx, build_fused=False, device="cpu")
    for e, a, b in zip(entries, ar.decode_blocks(entries),
                       ref_ar.decode_blocks(entries)):
        assert_u32_equal(a, b, f"{name} {e}")
    assert ar.stats == ref_ar.stats
    # the device-resident rows (docids, zero-padded past n) as well
    pairs = [(t, bi) for t, bi, f in entries if f == 0]
    rows, ns = ar.decode_blocks_device(pairs)
    ref_rows, ref_ns = ref_ar.decode_blocks_device(pairs)
    assert ns == ref_ns
    for p, a, b in zip(pairs, rows, ref_rows):
        assert_u32_equal(a, b, f"{name} resident {p}")
    np.testing.assert_array_equal(ar.dense_w0, ref_ar.dense_w0)
    assert ar.dense_slot == ref_ar.dense_slot


def test_fused_tiles_match_reference():
    ref_idx = RefIndex.build(DOCLEN, POSTINGS, codec="group_simple")
    idx = InvertedIndex.build(DOCLEN, POSTINGS, codec="group_simple")
    ref_ar = RefArena.from_index(ref_idx)
    ar = DeviceArena.from_index(idx, device="cpu")
    assert ar._pk_slot == ref_ar._pk_slot
    assert sorted(ar._pk) == sorted(ref_ar._pk)
    for bw, pk in ref_ar._pk.items():
        assert_u32_equal(ar._pk[bw]["tiles"], pk["tiles"], f"tiles bw={bw}")
        np.testing.assert_array_equal(ar._pk[bw]["first"], pk["first"])
        np.testing.assert_array_equal(ar._pk[bw]["n"], pk["n"])
