"""Kernel PFD, Group-PFD's whole-list decode (``kernels/pfd_decode.py``):
its plain version, which a CPU tensor runs, against the port's numpy
decoder on edge-case encodings, bitwise.  The tests marked ``cuda`` hold
the kernel against the plain version and the numpy decoder on the card and
skip where there is none.  No JAX here: the card's tests run without it."""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import group_pfd
from repro_torch.core.bits import pack_bits_np
from repro_torch.core.encoded import Encoded
from repro_torch.core.frames import pack_data, quads_of
from repro_torch.kernels import pfd_decode

from _torch_parity import assert_u32_equal, cuda_device, u32  # noqa: F401

FQ = group_pfd.FRAME_QUADS


def _gaps(rng, n: int, lo: int = 1 << 12, hi: int = 1 << 20,
              share: float = 0.02) -> np.ndarray:
    """d-gaps as a posting list has them: mostly small, a ``share`` of
    outliers in [lo, hi), which become the exceptions."""
    x = rng.geometric(1 / 40, n).astype(np.uint64)
    hot = rng.random(n) < share
    x[hot] = rng.integers(lo, hi, int(hot.sum()), dtype=np.uint64)
    return x.astype(np.uint32)


def _by_hand(x, bws, excs: dict):
    """A Group-PFD encoding written frame by frame: frame f's quadruples at
    ``bws[f]`` bits and ``excs[f] = (positions, values, w)`` its exception
    list as given, which an encoder never writes (positions past ``n``, a
    position twice with one value)."""
    x = np.asarray(x, np.uint32)
    v = quads_of(x)
    q = len(v)
    nf = -(-q // FQ)
    data, dbits = pack_data(v, np.repeat(np.asarray(bws), FQ)[:q])
    codes, lens, ctrl = [], [], []
    for f in range(nf):
        pos, val, w = excs.get(f, ((), (), 8))
        codes += [*pos, *val]
        lens += [8] * len(pos) + [w] * len(val)
        ctrl += [bws[f] | (list(group_pfd.W_CHOICES).index(w) << 6), len(pos)]
    words, ebits = pack_bits_np(np.array(codes, np.uint64),
                                np.array(lens, np.int64))
    n_exc = np.array(ctrl[1::2], np.int32)
    return Encoded("group_pfd", len(x), np.array(ctrl, np.uint8),
                   data.reshape(-1), control_bits=16 * nf,
                   data_bits=4 * dbits, exceptions=words,
                   exception_bits=ebits, header_bits=32,
                   meta={"Q": q, "n_exc": n_exc})


def _case(case: str):
    """The encoding of one edge case (``CASES``)."""
    rng = np.random.default_rng(sum(map(ord, case)))
    if case.startswith("n="):
        return group_pfd.encode(_gaps(rng, int(case[2:])))
    if case.startswith("w="):              # exceptions of one value width
        w = int(case[2:])
        x = rng.integers(0, 8, 1000, dtype=np.uint64)
        hot = rng.random(1000) < 0.03
        x[hot] = rng.integers(1 << (w // 2 + 1), (1 << w) - 1, int(hot.sum()),
                              dtype=np.uint64)
        enc = group_pfd.encode(x.astype(np.uint32))
        assert set(enc.meta["ws"][enc.meta["n_exc"] > 0]) == {w}
        return enc
    if case == "bw=1..32":                 # frame f all at f + 1 bits
        x = np.concatenate([rng.integers(1 << b >> 1, 1 << b, 128,
                                         dtype=np.uint64)
                            for b in range(1, 33)])[: 31 * 128 + 77]
        enc = group_pfd.encode(x.astype(np.uint32))
        assert list(enc.meta["bws"]) == list(range(1, 33))
        return enc
    if case == "exc_past_n":               # 3 valid, 9 and 100 past n
        x = rng.integers(0, 16, 2 * 128 + 5, dtype=np.uint64).astype(np.uint32)
        x[7] = 999
        return _by_hand(x, [4, 4, 4], {
            0: ((7,), (999,), 16), 2: ((3, 9, 100), (70000, 1, 2), 32)})
    if case == "exc_0_and_255":            # frame 1: 255 exceptions, w 16
        x = rng.integers(0, 4, 3 * 128, dtype=np.uint64).astype(np.uint32)
        pos = np.arange(255) % 128
        x[128:256] = 300 + np.arange(128)
        return _by_hand(x, [2, 2, 2], {1: (pos, 300 + pos, 16)})
    if case == "optpfd":
        return group_pfd.encode(_gaps(rng, 5000, hi=1 << 31), opt=True)
    if case == "tiles=3":                  # 521 frames: 3 tiles on the card
        return group_pfd.encode(_gaps(rng, 521 * 128 - 61))
    raise KeyError(case)


CASES = ("n=0", "n=1", "n=3", "n=4", "n=127", "n=128", "n=129",
             f"n={4 * 32 * 3 + 5}", "w=8", "w=16", "w=32", "bw=1..32",
             "exc_past_n", "exc_0_and_255", "optpfd", "tiles=3")


def _args(enc, device):
    return group_pfd.torch_args(enc, device=device)


@pytest.mark.parametrize("case", CASES)
def test_pfd_decode_list_plain_matches_decode_np(case):
    """The plain version, which a CPU tensor runs, against the numpy
    decoder, bitwise; a CPU tensor launches nothing."""
    enc = _case(case)
    kw = _args(enc, "cpu")
    want = group_pfd.decode_np(enc)
    n0 = kernels.LAUNCHES["PFD"]
    assert_u32_equal(pfd_decode.decode_list_plain(**kw), want, case)
    assert_u32_equal(pfd_decode.decode_list(**kw), want, case)
    assert_u32_equal(group_pfd.decode_torch_vec(**kw), want, case)
    assert kernels.LAUNCHES["PFD"] == n0
    if case == "exc_past_n":
        assert u32(want)[7] == 999 and u32(want)[2 * 128 + 3] == 70000


def _on_card(enc, device, sync_debug: bool = False):
    """(output, arguments) of kernel PFD on the card, after checking that
    the call counted one launch (none for n == 0); with ``sync_debug`` the
    call runs under ``set_sync_debug_mode("error")``."""
    kw = _args(enc, device)
    n0 = kernels.LAUNCHES["PFD"]
    if sync_debug:
        torch.cuda.set_sync_debug_mode("error")
    try:
        got = pfd_decode.decode_list(**kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert kernels.LAUNCHES["PFD"] == n0 + (enc.n > 0)
    assert got.dtype == torch.int32 and got.shape == (enc.n,)
    return got, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_cuda_pfd_decode_cases(case, cuda_device):
    """Kernel PFD against its plain version on the card and the numpy
    decoder, bitwise."""
    enc = _case(case)
    got, kw = _on_card(enc, cuda_device)
    assert_u32_equal(got, pfd_decode.decode_list_plain(**kw), case)
    assert_u32_equal(got, group_pfd.decode_np(enc), case)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_pfd_decode_many_tiles_back_to_back(cuda_device):
    """Two lists of 100,002 frames (391 tiles: the look-back runs) queued
    back to back, the second's status words in the first's memory, then a
    list of three tiles; the first call under the sync debug mode's
    "error", so the decode never waits for the host."""
    n = 100_002 * 128 - 100
    encs = [group_pfd.encode(_gaps(np.random.default_rng(s), n))
            for s in (1, 2)] + [_case("tiles=3")]
    got = [_on_card(e, cuda_device, sync_debug=i == 0)
           for i, e in enumerate(encs)]
    for i, (enc, (g, kw)) in enumerate(zip(encs, got)):
        assert_u32_equal(g, group_pfd.decode_np(enc), f"PFD call {i}")
        if i == 2:
            assert_u32_equal(g, pfd_decode.decode_list_plain(**kw), "plain")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_pfd_decode_refuses_bad_arguments(cuda_device):
    """A data view off its 16-byte boundary, or control on another
    device, raises ValueError and launches nothing."""
    kw = _args(_case("n=389"), cuda_device)
    flat = torch.zeros(kw["data"].numel() + 1, dtype=torch.int32,
                       device=cuda_device)
    n0 = kernels.LAUNCHES["PFD"]
    with pytest.raises(ValueError, match="16-byte boundary"):
        pfd_decode.decode_list(**{**kw, "data": flat[1:].view(-1, 4)})
    with pytest.raises(ValueError, match="control on cpu"):
        pfd_decode.decode_list(**{**kw, "control": kw["control"].cpu()})
    assert kernels.LAUNCHES["PFD"] == n0
