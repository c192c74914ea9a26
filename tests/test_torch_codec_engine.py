"""The Group codecs served by the port's engine against the JAX package's,
following ``tests/test_device_arena.py``: every Group codec on the
``device`` placement in modes ``and``, ``or`` and ``and_scored``; the
``fused`` placement on BP128, Group-PackedBinary and Group-PFD; the
exception-bearing codecs on the heavy-tailed corpus with every block decoded
on the device and under eviction pressure across the 511/512/513/1024 block
edges; a codec with no arena (``varbyte``) and a block at a mismatched BP
frame size taking the host oracle.  The port runs with
``torch_device="cpu"``; every comparison is exact."""

import numpy as np
import pytest

from repro.core import bp128 as ref_bp128
from repro.index.device import DeviceArena as RefArena
from repro.index.engine import QueryBatch as RefBatch
from repro.index.engine import QueryEngine as RefEngine
from repro.index.invindex import InvertedIndex as RefIndex
from repro_torch.core import bp128
from repro_torch.core import codec as port_codec
from repro_torch.index.device import DeviceArena
from repro_torch.index.engine import QueryBatch, QueryEngine
from repro_torch.index.invindex import InvertedIndex

from _torch_parity import assert_u32_equal
from test_device_arena import (DOCLEN, EXC_CODECS, HDOCLEN, HPOSTINGS,
                               HQUERIES, POSTINGS, QUERIES)

GROUP = port_codec.names(group_only=True)
MODES = (("and", QUERIES, 10), ("or", QUERIES[:5], 7),
         ("and_scored", QUERIES[:5], 7))
COUNTERS = ("cand_syncs", "final_syncs", "score_syncs", "resident_rounds",
            "score_rounds", "blocks_dense")


def _same(mode, got, want, where):
    assert len(got) == len(want), where
    for q, (a, b) in enumerate(zip(got, want)):
        if mode == "and":
            assert a.dtype == np.uint32, where
            np.testing.assert_array_equal(a, b, err_msg=f"{where} query {q}")
        else:
            assert a == b, f"{where} query {q}"


def assert_device_placement_matches_reference(name: str, fused=False) -> None:
    """The port's device (or fused) placement against the reference's, in
    every mode: results, the zero-sync counters, and every block decoded on
    the device where the codec declares an arena."""
    placement = "fused" if fused else "device"
    ref_idx = RefIndex.build(DOCLEN, POSTINGS, codec=name)
    idx = InvertedIndex.build(DOCLEN, POSTINGS, codec=name)
    for mode, queries, k in MODES:
        ref = RefEngine(ref_idx).to_device(fused=fused)
        eng = QueryEngine(idx).to_device(fused=fused, torch_device="cpu")
        want = ref.execute(ref.plan(RefBatch(queries, mode=mode, k=k),
                                    placement=placement))
        plan = eng.plan(QueryBatch(queries, mode=mode, k=k),
                        placement=placement)
        assert plan.placement == placement
        got = eng.execute(plan)
        _same(mode, got, want, f"{name}/{placement}/{mode}")
        for c in COUNTERS:
            assert eng.dev_stats[c] == ref.dev_stats[c], (name, mode, c)
        assert eng.dev_stats["cand_syncs"] == 0
        assert eng.arena.stats == ref.arena.stats, (name, mode)
        if port_codec.get(name).arena is not None:
            assert eng.arena.stats["blocks_host"] == 0, (name, mode)
        if fused and mode == "and":
            assert eng.arena.stats["fused_calls"] > 0


@pytest.mark.parametrize("name", GROUP)
def test_device_engine_matches_reference(name):
    assert_device_placement_matches_reference(name)


@pytest.mark.parametrize("name", ["bp128", "g_packed_binary", "group_pfd"])
def test_fused_decode_and_matches_reference(name):
    assert_device_placement_matches_reference(name, fused=True)


@pytest.mark.parametrize("name", EXC_CODECS)
def test_exception_codecs_decode_natively_no_oracle_fallback(name):
    """Every block of the heavy-tailed corpus (PFD exception streams among
    them) decodes on the device, as the reference decodes it, with no
    numpy-oracle fallback."""
    ref_idx = RefIndex.build(HDOCLEN, HPOSTINGS, codec=name)
    idx = InvertedIndex.build(HDOCLEN, HPOSTINGS, codec=name)
    if name in ("group_pfd", "group_optpfd"):
        assert any(encg.exceptions is not None and len(encg.exceptions)
                   for tp in idx.terms.values()
                   for _, encg, _ in tp.blocks), "corpus has no exceptions"
    entries = [(t, bi, f) for t in idx.terms
               for bi in range(idx.n_blocks(t)) for f in (0, 1)]
    ar = DeviceArena.from_index(idx, build_fused=False, device="cpu")
    ref_ar = RefArena.from_index(ref_idx, build_fused=False)
    for e, a, b in zip(entries, ar.decode_blocks(entries),
                       ref_ar.decode_blocks(entries)):
        assert_u32_equal(a, b, f"{name} {e}")
    assert ar.stats == ref_ar.stats
    assert ar.stats["blocks_host"] == 0
    assert ar.stats["blocks_device"] == len(entries)


@pytest.mark.parametrize("name", EXC_CODECS)
def test_exception_codecs_eviction_and_block_boundary_parity(name):
    """A two-block cache under the heavy-tailed corpus's queries: evictions
    and re-decodes across the 511/512/513/1024 block edges stay exact."""
    idx = InvertedIndex.build(HDOCLEN, HPOSTINGS, codec=name)
    want = RefEngine(RefIndex.build(HDOCLEN, HPOSTINGS, codec=name)).execute(
        RefBatch(HQUERIES, mode="and"))
    tiny = QueryEngine(idx, cache_blocks=2, cache_score_terms=1).to_device(
        torch_device="cpu")
    got = tiny.execute(tiny.plan(QueryBatch(HQUERIES, mode="and")))
    assert tiny.cache.evictions > 0
    _same("and", got, want, f"{name}/eviction")
    assert tiny.dev_stats["cand_syncs"] == 0


def test_non_arena_codec_falls_back_to_host_oracle():
    """``varbyte`` declares no arena: its sparse blocks decode on the host,
    the short lists and dense blocks still on the device, as the reference
    splits them."""
    ref_idx = RefIndex.build(DOCLEN, POSTINGS, codec="varbyte")
    idx = InvertedIndex.build(DOCLEN, POSTINGS, codec="varbyte")
    entries = [(t, bi, f) for t in idx.terms
               for bi in range(idx.n_blocks(t)) for f in (0, 1)]
    ar = DeviceArena.from_index(idx, build_fused=False, device="cpu")
    ref_ar = RefArena.from_index(ref_idx, build_fused=False)
    for e, a, b in zip(entries, ar.decode_blocks(entries),
                       ref_ar.decode_blocks(entries)):
        assert_u32_equal(a, b, f"varbyte {e}")
    assert ar.stats == ref_ar.stats
    assert ar.stats["blocks_host"] > 0 and ar.stats["blocks_device"] > 0
    assert not ar.covers((2, 0, 0)) and ar.covers((0, 0, 0))


def test_mismatched_bp_frame_layout_falls_back_to_host():
    """A ``bp128``-named block at another frame size is outside the declared
    layout (``supports`` says no) and takes the host oracle, exactly."""
    ref_idx = RefIndex.build(DOCLEN, POSTINGS, codec="bp128")
    idx = InvertedIndex.build(DOCLEN, POSTINGS, codec="bp128")
    t = 6                                        # df=1024 -> two bp128 blocks
    for ix, enc_fn in ((idx, bp128.encode), (ref_idx, ref_bp128.encode)):
        first, encg, enct = ix.terms[t].blocks[0]
        gaps = port_codec.get(encg.codec).decode_np(encg)
        ix.terms[t].blocks[0] = (first, enc_fn(gaps, frame_quads=64), enct)
    ar = DeviceArena.from_index(idx, build_fused=False, device="cpu")
    ref_ar = RefArena.from_index(ref_idx, build_fused=False)
    assert not ar.covers((t, 0, 0)) and ar.covers((t, 1, 0))
    got = ar.decode_blocks([(t, 0, 0), (t, 1, 0)])
    want = ref_ar.decode_blocks([(t, 0, 0), (t, 1, 0)])
    for a, b, bi in zip(got, want, (0, 1)):
        assert_u32_equal(a, b, f"block {bi}")
        np.testing.assert_array_equal(a, idx.decode_block_ids(t, bi))
    assert ar.stats["blocks_host"] == 1 and ar.stats["blocks_device"] == 1
    assert ar.stats == ref_ar.stats
