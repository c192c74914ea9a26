"""The port's codecs against the JAX package's: encoded words equal, and the
torch arena decode (batched over blocks) equal to the reference's
``decode_arena_block`` at the boundaries of ``test_codec_protocol.py``; the
stream codec's host codec ``bp_tpu`` on GOV2-statistics streams."""

import numpy as np
import pytest

import jax.numpy as jnp

from repro.core import bp_tpu as ref_bp_tpu
from repro.core import codec as ref_codec
from repro_torch.core import bp_tpu
from repro_torch.core import codec as port_codec
from repro_torch.data import synth

from _torch_parity import assert_encoded_equal, assert_u32_equal, t32

CODECS = ("group_simple", "stream_vbyte", "dense_bitmap")


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
    }


def test_registry_holds_the_three_index_codecs():
    assert port_codec.names() == sorted(CODECS + ("bp_tpu",))
    assert port_codec.get("bp_tpu").arena is None
    with pytest.raises(KeyError, match="did you mean 'group_simple'"):
        port_codec.get("group_simpel")
    with pytest.raises(KeyError, match="registered codecs"):
        port_codec.get("bp128")


@pytest.mark.parametrize("name", CODECS)
def test_encode_words_and_decode_np_match_reference(name):
    ref, port = ref_codec.get(name), port_codec.get(name)
    for case, x in _cases(port.max_bits).items():
        enc = port.encode(x)
        assert_encoded_equal(enc, ref.encode(x), f"{name}/{case}")
        np.testing.assert_array_equal(port.decode_np(enc), x,
                                      err_msg=f"{name}/{case}")


def _ref_arena_decode(spec, enc) -> np.ndarray:
    """The reference's single-block arena decode, padded as the arena pads."""
    slices, lens = [], []
    for col in spec.arena.columns:
        words = np.asarray(col.extract(enc), col.dtype).reshape(-1)
        padded = np.zeros(col.width, col.dtype)
        padded[: words.size] = words
        slices.append(jnp.asarray(padded))
        lens.append(jnp.int32(words.size))
    return np.asarray(spec.arena.decode_block(*slices, *lens,
                                              jnp.int32(enc.n)))


@pytest.mark.parametrize("name", CODECS)
def test_arena_block_decode_matches_reference(name):
    """All boundary cases of one codec decode as ONE batched torch call; each
    row equals the reference's decode of that block.  Slack past each block
    holds the next case's words, as in the arena."""
    ref, port = ref_codec.get(name), port_codec.get(name)
    lay = port.arena
    encs = [port.encode(x) for x in _cases(port.max_bits).values()
            if 0 < len(x) <= lay.max_n]
    cols, lens = [], []
    for col in lay.columns:
        parts = [np.asarray(col.extract(e), col.dtype).reshape(-1) for e in encs]
        flat = np.concatenate(parts + [np.zeros(col.width, col.dtype)])
        offs = np.cumsum([0] + [p.size for p in parts[:-1]])
        cols.append(t32(np.stack([flat[o:o + col.width] for o in offs])))
        lens.append(t32(np.asarray([p.size for p in parts], np.int32)))
    n = t32(np.asarray([e.n for e in encs], np.int32))
    got = lay.decode_block(*cols, *lens, n)
    assert tuple(got.shape) == (len(encs), lay.out_width)
    for row, enc in zip(got, encs):
        assert_u32_equal(row, _ref_arena_decode(ref, enc), f"{name}/n={enc.n}")


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
