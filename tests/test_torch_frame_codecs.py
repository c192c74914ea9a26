"""The torch whole-list decoders (``Codec.torch``: ``decode_torch_vec``, the
paper's vectorized decode, and ``decode_torch_scalar``, its one-quadruple-a
-step form) of the frame codecs (BP128, Group-PackedBinary, Group-AFOR,
Group-VSE, Group-PFD, Group-OptPFD) against
the JAX package's ``decode_jax_vec`` and ``decode_jax_scalar`` on
``test_codecs.py``'s cases, bitwise; Group-PFD's whole-list decode (kernel
PFD's plain version) on ``test_torch_pfd_decode.py``'s edge-case encodings
against ``decode_jax_vec``; Group-Simple's scatter decode
(``decode_torch_vec_scatter``) against ``decode_jax_vec_scatter`` on the
same cases; and the shared helpers of ``core/bits.py`` (``ebw`` too),
``core/frames.py``, ``core/dgap.py`` (``dgap_decode``) and
``core/layout.py`` (``quadmax``) against their reference forms."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import bits as ref_bits
from repro.core import codec as ref_codec
from repro.core import dgap as ref_dgap
from repro.core import frames as ref_frames
from repro.core import group_simple as ref_gs
from repro.core import layout as ref_layout
from repro_torch.core import bits, dgap, frames, group_pfd, group_simple
from repro_torch.core import layout
from repro_torch.core import codec as port_codec
from repro_torch.kernels import pfd_decode

from _torch_parity import assert_u32_equal, t32
from test_codecs import CASES
from test_torch_pfd_decode import CASES as PFD_CASES, _case as pfd_case

FRAME_CODECS = ["bp128", "g_packed_binary", "group_afor", "group_vse",
                "group_pfd", "group_optpfd"]
# swept in test_torch_codecs.py
INDEX_TORCH_CODECS = ["group_simple", "stream_vbyte"]


def assert_torch_decoders_match_reference(name: str) -> None:
    """Every case of ``CASES`` the codec takes: the port's encoding through
    its torch ``vec`` and ``scalar`` equals the reference's ``jax`` ones
    (and the input)."""
    ref, port = ref_codec.get(name), port_codec.get(name)
    for case, x in CASES.items():
        if x.size and int(x.max()) >= 2 ** port.max_bits:
            continue
        enc = port.encode(x)
        kw = port.torch.args(enc, device="cpu")
        rkw = ref.jax.args(enc)
        want_vec = np.asarray(ref.jax.vec(**rkw))
        want_scalar = np.asarray(ref.jax.scalar(**rkw))
        got_vec = port.torch.vec(**kw)
        got_scalar = port.torch.scalar(**kw)
        assert got_vec.dtype == got_scalar.dtype == torch.int32
        assert_u32_equal(got_vec, want_vec, f"{name}/{case}/vec")
        assert_u32_equal(got_scalar, want_scalar, f"{name}/{case}/scalar")
        np.testing.assert_array_equal(want_vec, x)


@pytest.mark.parametrize("name", FRAME_CODECS)
def test_torch_decoders_match_jax_decoders(name):
    assert_torch_decoders_match_reference(name)


@pytest.mark.parametrize("case", PFD_CASES)
def test_pfd_edge_cases_match_jax_decoder(case):
    """The encodings that stress kernel PFD's patch (255 exceptions in a
    frame, positions past n, bw 1..32, w 8/16/32, OptPFD, 3 tiles) through
    the plain version, which a CPU tensor runs, against the reference's
    ``decode_jax_vec``, bitwise."""
    enc = pfd_case(case)
    ref = ref_codec.get(enc.codec)
    want = np.asarray(ref.jax.vec(**ref.jax.args(enc)))
    kw = group_pfd.torch_args(enc, device="cpu")
    assert_u32_equal(pfd_decode.decode_list_plain(**kw), want, case)
    assert_u32_equal(port_codec.get(enc.codec).torch.vec(**kw), want, case)
    np.testing.assert_array_equal(want, group_pfd.decode_np(enc))


def test_every_torch_codec_is_swept():
    """The codecs declaring ``Codec.torch`` are exactly the ones this file,
    ``test_torch_group_scheme.py`` and ``test_torch_codecs.py`` sweep, and
    the ones declaring ``jax`` in the reference."""
    have = [n for n in port_codec.names() if port_codec.get(n).torch]
    assert have == [n for n in ref_codec.names() if ref_codec.get(n).jax]
    gsch = [n for n in have if n.startswith("group_scheme_")]
    assert (sorted(FRAME_CODECS + INDEX_TORCH_CODECS + gsch) == have
            and len(have) == 18)


def test_gather_bits_matches_reference():
    """``bits.gather_bits`` against ``gather_bits_jnp`` and the numpy
    reader: every width 0..32 at every bit phase, 1-D and row by row."""
    rng = np.random.default_rng(5)
    words = rng.integers(0, 1 << 32, 40, dtype=np.uint64).astype(np.uint32)
    offs = rng.integers(0, 38 * 32, 800).astype(np.int32)
    offs[:32] = np.arange(32)                     # every phase, bit 0 too
    bws = rng.integers(0, 33, 800).astype(np.int32)
    bws[32:65] = np.arange(33)
    want = ref_bits.gather_bits_jnp(jnp.asarray(words), jnp.asarray(offs),
                                    jnp.asarray(bws))
    got = bits.gather_bits(t32(words), torch.as_tensor(offs),
                           torch.as_tensor(bws))
    assert got.dtype == torch.int64 and int(got.min()) >= 0
    assert_u32_equal(bits.i32(got), np.asarray(want), "1-D")
    np.testing.assert_array_equal(
        bits.to_np(got), ref_bits.gather_bits_np(words, offs, bws))
    rows = bits.gather_bits(t32(np.stack([words, words[::-1]])),
                            torch.as_tensor(np.stack([offs, offs])),
                            torch.as_tensor(np.stack([bws, bws])))
    assert_u32_equal(rows[0], np.asarray(want), "row 0")
    np.testing.assert_array_equal(
        bits.to_np(rows[1]), ref_bits.gather_bits_np(words[::-1], offs, bws))


def test_numpy_bit_helpers_match_reference():
    rng = np.random.default_rng(6)
    counts = rng.integers(1, 40, 300)
    words, total = bits.unary_stream_np(counts)
    rwords, rtotal = ref_bits.unary_stream_np(counts)
    assert total == rtotal and np.array_equal(words, rwords)
    np.testing.assert_array_equal(bits.unary_decode_np(words, total, 300),
                                  ref_bits.unary_decode_np(words, total, 300))
    b = rng.integers(0, 2, 1000).astype(np.uint8)
    np.testing.assert_array_equal(bits.bits_to_words_np(b),
                                  ref_bits.bits_to_words_np(b))
    np.testing.assert_array_equal(bits.words_to_bits_np(words, total),
                                  ref_bits.words_to_bits_np(words, total))
    offs = rng.integers(0, (len(words) - 1) * 32, 200)
    lens = rng.integers(0, 33, 200)
    np.testing.assert_array_equal(bits.gather_bits_np(words, offs, lens),
                                  ref_bits.gather_bits_np(words, offs, lens))


@pytest.mark.parametrize("case", ["exceptions", "zipf_tail", "odd_len_257",
                                  "all_max32"])
def test_frames_unpack_matches_reference(case):
    """``frames.pack_data`` words equal the reference's, and ``unpack_data``
    (also on a batch of two rows) and ``unpack_data_scalar`` equal
    ``unpack_data_jnp`` and ``unpack_data_scalar_jnp``."""
    x = CASES[case]
    v = frames.quads_of(x)
    bw = np.maximum(bits.ebw_np(v.max(axis=1)), 1).astype(np.int32)
    data, dbits = frames.pack_data(v, bw)
    rdata, rbits = ref_frames.pack_data(ref_frames.quads_of(x), bw)
    assert dbits == rbits and np.array_equal(data, rdata)
    slack = np.concatenate([data, np.zeros((1, 4), np.uint32)])
    n, q = len(x), len(bw)
    want = np.asarray(ref_frames.unpack_data_jnp(jnp.asarray(slack),
                                                 jnp.asarray(bw), n))
    got = frames.unpack_data(t32(slack), torch.as_tensor(bw), n)
    assert_u32_equal(got, want, "vec")
    both = frames.unpack_data(t32(np.stack([slack, slack])),
                              torch.as_tensor(np.stack([bw, bw])), n)
    assert_u32_equal(both[1], want, "batched")
    want_s = np.asarray(ref_frames.unpack_data_scalar_jnp(
        jnp.asarray(slack), jnp.asarray(bw), n, q))
    assert_u32_equal(frames.unpack_data_scalar(t32(slack),
                                               torch.as_tensor(bw), n, q),
                     want_s, "scalar")
    np.testing.assert_array_equal(want, x)
    np.testing.assert_array_equal(frames.unpack_data_np(data, bw, n), x)


def test_group_simple_scatter_decode_matches_reference():
    """``decode_torch_vec_scatter`` against the reference's original scatter
    formulation on every case of ``CASES``, bitwise (and the input)."""
    for case, x in CASES.items():
        enc = group_simple.encode(x)
        kw = group_simple.torch_args(enc, device="cpu")
        want = np.asarray(ref_gs.decode_jax_vec_scatter(**ref_gs.jax_args(enc)))
        got = group_simple.decode_torch_vec_scatter(**kw)
        assert got.dtype == torch.int32
        assert_u32_equal(got, want, f"group_simple/{case}/vec_scatter")
        np.testing.assert_array_equal(want, x)


def test_ebw_matches_reference():
    """``bits.ebw`` against ``ebw_jnp`` (``32 - clz``) and ``ebw_np`` on 0,
    1, 2**k - 1, 2**k, 2**k + 1 and 2**32 - 1."""
    p = np.uint64(1) << np.arange(32, dtype=np.uint64)
    x = np.concatenate([[0, 1, 2 ** 32 - 1], p - 1, p, p + 1])
    x = np.unique(x[x < 2 ** 32]).astype(np.uint32)
    got = bits.ebw(t32(x))
    assert got.dtype == torch.int32
    want = np.asarray(ref_bits.ebw_jnp(jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), ref_bits.ebw_np(x))
    assert int(got[0]) == 0 and int(got[-1]) == 32


def test_dgap_decode_matches_reference():
    """``dgap.dgap_decode`` against ``dgap_decode_jnp`` on gaps whose sum
    wraps past 2**32 (more than once), and on an empty array."""
    rng = np.random.default_rng(3)
    gaps = rng.integers(0, 1 << 32, 300, dtype=np.uint64).astype(np.uint32)
    gaps[:3] = [0xFFFFFFFF, 1, 0x80000000]
    for g in (gaps, gaps[:1], gaps[:0]):
        got = dgap.dgap_decode(t32(g))
        assert got.dtype == torch.int32
        want = np.asarray(ref_dgap.dgap_decode_jnp(jnp.asarray(g)))
        assert_u32_equal(got, want, f"dgap_decode n={len(g)}")
        assert_u32_equal(got, ref_dgap.dgap_decode_np(g), "dgap_decode_np")


@pytest.mark.parametrize("k", [2, 4])
def test_quadmax_matches_reference(k):
    """``layout.quadmax`` (the OR of each ``k`` words) against
    ``quadmax_jnp`` and the pseudo ``quadmax_np``, words past 2**31 too."""
    rng = np.random.default_rng(k)
    x = rng.integers(0, 1 << 32, 64 * k, dtype=np.uint64).astype(np.uint32)
    x[:k] = 0
    got = layout.quadmax(t32(x), k)
    want = np.asarray(ref_layout.quadmax_jnp(jnp.asarray(x), k))
    assert_u32_equal(got, want, f"quadmax k={k}")
    assert_u32_equal(got, ref_layout.quadmax_np(x, k, pseudo=True), "quadmax_np")
