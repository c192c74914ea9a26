"""The port's codecs against the JAX package's: the registry (all 31 codecs,
their categories, bit limits and capabilities), encoded words and
``decode_np`` on ``test_codecs.py``'s cases and the boundaries of
``test_codec_protocol.py``, and the torch arena decode (batched over blocks,
each block's slack holding the next block's words) equal to the reference's
``decode_arena_block`` on the same padded slices; on the card, each arena
codec's ``decode_block`` equal to its CPU result with no host sync; the
whole-list torch decoders of Group-Simple and Stream VByte against the
reference's JAX decoders; the
stream codec's host codec ``bp_tpu`` on GOV2-statistics streams."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import bp_tpu as ref_bp_tpu
from repro.core import codec as ref_codec
from repro_torch.core import bp_tpu
from repro_torch.core import codec as port_codec
from repro_torch.data import synth

from _torch_parity import (assert_encoded_equal, assert_u32_equal,  # noqa: F401
                           cuda_device, t32, u32)
from test_codecs import CASES
from test_torch_frame_codecs import (INDEX_TORCH_CODECS,
                                     assert_torch_decoders_match_reference)

ALL = ref_codec.names()
ARENA_CODECS = [n for n in ALL if ref_codec.get(n).arena is not None]
# the three codecs the index stores: its long lists, short lists and dense
# blocks
INDEX_CODECS = ("group_simple", "stream_vbyte", "dense_bitmap")


def _cases(max_bits: int) -> dict:
    rng = np.random.default_rng(7)
    top = 2 ** max_bits - 1
    return {
        "empty": np.zeros(0, np.uint32),
        "single": np.array([7], np.uint32),
        "single_max": np.array([top], np.uint32),
        "max_bits_boundary": np.full(130, top, np.uint32),
        "block_511": rng.integers(0, 1 << 16, 511, dtype=np.int64).astype(np.uint32),
        "block_512": rng.integers(0, 1 << 16, 512, dtype=np.int64).astype(np.uint32),
        "block_513": rng.integers(0, 1 << 16, 513, dtype=np.int64).astype(np.uint32),
        # a sorted docid block: exercises dense_bitmap's bitmap format
        "dense_gaps": np.concatenate([[40], rng.integers(1, 8, 511)]).astype(np.uint32),
        # blocks whose outliers give the PFD family exception streams
        "exceptions_512": CASES["exceptions"][:512],
        "outlier_257": CASES["single_outlier"][:257],
        "zipf_384": CASES["zipf_tail"][:384],
    }


def test_registry_holds_the_three_index_codecs():
    """The port registers the reference's 31 codecs: the three the index
    stores among them, each with the reference's category, bit limit,
    Group flag and capabilities (``torch`` where the reference declares
    ``jax``); ``bp_tpu`` and the scalar baselines declare no arena."""
    assert port_codec.names() == ALL and len(ALL) == 31
    assert set(INDEX_CODECS) <= set(port_codec.names())
    for name in ALL:
        ref, port = ref_codec.get(name), port_codec.get(name)
        assert (port.category, port.max_bits, port.is_group) == (
            ref.category, ref.max_bits, ref.is_group), name
        assert (port.arena is None) == (ref.arena is None), name
        assert (port.torch is None) == (ref.jax is None), name
        if ref.arena is not None:
            assert [(c.name, c.width) for c in port.arena.columns] == [
                (c.name, c.width) for c in ref.arena.columns], name
            assert port.arena.out_width == ref.arena.out_width, name
    baselines = [n for n in ALL if not ref_codec.get(n).is_group
                 and n not in INDEX_CODECS]
    assert len(baselines) == 11
    for name in baselines + ["bp_tpu"]:
        assert port_codec.get(name).arena is None, name
    assert port_codec.names(group_only=True) == ref_codec.names(group_only=True)
    with pytest.raises(KeyError, match="did you mean 'group_simple'"):
        port_codec.get("group_simpel")
    with pytest.raises(KeyError, match="registered codecs"):
        port_codec.get("bp129")


@pytest.mark.parametrize("name", ALL)
def test_encode_words_and_decode_np_match_reference(name):
    """Encoded words and accounting equal the reference's, and the port's
    ``decode_np`` and the reference's read them back, on the boundary cases
    and on ``test_codecs.py``'s cases and empty input."""
    ref, port = ref_codec.get(name), port_codec.get(name)
    cases = {**_cases(port.max_bits), **CASES}
    for case, x in cases.items():
        if x.size and int(x.max()) >= 2 ** port.max_bits:
            continue
        enc = port.encode(x)
        assert_encoded_equal(enc, ref.encode(x), f"{name}/{case}")
        np.testing.assert_array_equal(port.decode_np(enc), x,
                                      err_msg=f"{name}/{case}")
        np.testing.assert_array_equal(ref.decode_np(enc), x,
                                      err_msg=f"{name}/{case} (reference)")


def _arena_batch(lay, encs, device="cpu"):
    """The arena's padded column slices of ``encs``, one row a block: each
    block's words then the next block's (the slack the arena holds), and
    the per-column lengths and posting counts."""
    cols, lens = [], []
    for col in lay.columns:
        parts = [np.asarray(col.extract(e), col.dtype).reshape(-1) for e in encs]
        flat = np.concatenate(parts + [np.zeros(col.width, col.dtype)])
        offs = np.cumsum([0] + [p.size for p in parts[:-1]])
        cols.append(np.stack([flat[o:o + col.width] for o in offs]))
        lens.append(np.asarray([p.size for p in parts], np.int32))
    n = np.asarray([e.n for e in encs], np.int32)
    return cols, lens, n


def _block_encs(port):
    encs = [port.encode(x) for x in _cases(port.max_bits).values()
            if 0 < len(x) <= port.arena.max_n]
    return [e for e in encs if port.arena.supports(e)]


@pytest.mark.parametrize("name", ARENA_CODECS)
def test_arena_block_decode_matches_reference(name):
    """All boundary cases of one codec decode as ONE batched torch call; each
    row equals the reference's decode of the same padded slices.  Slack past
    each block holds the next case's words, as in the arena."""
    ref, port = ref_codec.get(name), port_codec.get(name)
    lay = port.arena
    encs = _block_encs(port)
    if name in ("group_pfd", "group_optpfd"):
        assert any(len(e.exceptions) for e in encs), "no exception stream"
    cols, lens, n = _arena_batch(lay, encs)
    got = lay.decode_block(*map(t32, cols), *map(t32, lens), t32(n))
    assert tuple(got.shape) == (len(encs), lay.out_width)
    for row, enc in enumerate(encs):
        want = ref.arena.decode_block(
            *[jnp.asarray(c[row]) for c in cols],
            *[jnp.int32(v[row]) for v in lens], jnp.int32(n[row]))
        assert_u32_equal(got[row], want, f"{name}/n={enc.n}")
        np.testing.assert_array_equal(u32(got[row])[:enc.n],
                                      port.decode_np(enc))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ARENA_CODECS)
def test_arena_block_decode_on_the_card(name, cuda_device):
    """On the card, each arena codec's batched ``decode_block`` equals its
    CPU result bitwise and makes no host sync."""
    lay = port_codec.get(name).arena
    cols, lens, n = _arena_batch(lay, _block_encs(port_codec.get(name)))
    want = lay.decode_block(*map(t32, cols), *map(t32, lens), t32(n))
    args = [t32(a, cuda_device) for a in (*cols, *lens, n)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = lay.decode_block(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert got.device.type == "cuda"
    assert_u32_equal(got.cpu(), want, name)


@pytest.mark.parametrize("name", INDEX_TORCH_CODECS)
def test_torch_decoders_match_jax_decoders(name):
    """``Codec.torch``'s ``vec`` and ``scalar`` of the index's long- and
    short-list codecs against the reference's ``jax`` decoders."""
    assert_torch_decoders_match_reference(name)


def _gov2_streams() -> dict:
    """The d-gaps of the 40 most frequent GOV2-statistics lists, one stream
    (11 frames of several widths, a ragged tail), one list's docids (wide
    values), and the boundary cases."""
    lists = synth.make_dataset("gov2", n_lists=40)
    return {"gov2_gaps": np.concatenate([pl.dgaps for pl in lists]),
            "gov2_docids": lists[3].docids,
            "empty": np.zeros(0, np.uint32),
            "single_max": np.array([(1 << 32) - 1], np.uint32),
            "one_frame": np.arange(4096, dtype=np.uint32)}


@pytest.mark.parametrize("case", sorted(_gov2_streams()))
def test_bp_tpu_matches_reference(case):
    x = _gov2_streams()[case]
    got, want = bp_tpu.encode(x), ref_bp_tpu.encode(x)
    assert (got.codec, got.n) == (want.codec, want.n)
    for f in ("control", "data"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        assert_u32_equal(a.astype(np.uint32), b.astype(np.uint32), f)
    for f in ("control_bits", "data_bits", "header_bits"):
        assert getattr(got, f) == getattr(want, f), f
    np.testing.assert_array_equal(got.meta["bws"], want.meta["bws"])
    assert got.meta["bws"].dtype == want.meta["bws"].dtype
    assert len(got.meta.get("parts", ())) == len(want.meta.get("parts", ()))
    for (gb, gs), (wb, ws) in zip(got.meta.get("parts", ()),
                                  want.meta.get("parts", ())):
        assert gb == wb and np.array_equal(gs, ws)
    if case == "gov2_gaps":
        assert len(np.unique(got.meta["bws"])) > 1
    np.testing.assert_array_equal(bp_tpu.decode_np(got), x)
    np.testing.assert_array_equal(ref_bp_tpu.decode_np(got), x)
    np.testing.assert_array_equal(port_codec.get("bp_tpu").decode(want), x)
