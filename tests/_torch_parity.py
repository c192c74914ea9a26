"""Shared helpers for the parity tests of the PyTorch port against the JAX
package: the same inputs go through both, outputs compare bitwise as
``np.uint32`` views."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.bits import from_np, to_np

_ENCODED_FIELDS = ("codec", "n", "control", "data", "control_bits",
                   "data_bits", "exceptions", "exception_bits", "header_bits",
                   "meta")


@pytest.fixture
def cuda_device():
    """The card, for tests marked ``cuda``; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA; runs on the card")
    return torch.device("cuda")


def u32(a) -> np.ndarray:
    """Any word array (numpy, jax, or an int32 bit-pattern tensor) as a
    numpy uint32 view."""
    if isinstance(a, torch.Tensor):
        return to_np(a)
    a = np.asarray(a)
    if a.dtype == bool:
        return a.astype(np.uint32)
    return np.ascontiguousarray(a).view(np.uint32) if a.dtype.itemsize == 4 \
        else a.astype(np.uint32)


def assert_u32_equal(got, want, msg: str = "") -> None:
    g, w = u32(got), u32(want)
    assert g.shape == w.shape, (msg, g.shape, w.shape)
    if not np.array_equal(g, w):
        bad = np.flatnonzero(g.reshape(-1) != w.reshape(-1))
        i = int(bad[0])
        raise AssertionError(f"{msg}: {len(bad)} words differ; first at flat "
                             f"index {i}: got {g.reshape(-1)[i]}, "
                             f"want {w.reshape(-1)[i]}")


def t32(a, device="cpu") -> torch.Tensor:
    """numpy words -> the port's int32 bit-pattern tensor, in memory of its
    own: the port updates state in place, and JAX on the CPU may alias the
    same numpy buffer while its dispatch is still running."""
    return from_np(np.array(a), device)


def assert_encoded_equal(got, want, msg: str = "") -> None:
    """Two ``Encoded`` records hold the same words and accounting."""
    assert got.codec == want.codec and got.n == want.n, msg
    for f in ("control", "data"):
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), (msg, f)
    for f in ("control_bits", "data_bits", "exception_bits", "header_bits"):
        assert getattr(got, f) == getattr(want, f), (msg, f)
    assert set(got.meta) == set(want.meta), msg
    for k, v in want.meta.items():
        assert _same_value(got.meta[k], v), (msg, k)


def _same_value(a, b) -> bool:
    """Equal meta values: arrays by value, lists and tuples (``bp_tpu``'s
    ``parts``) item by item."""
    if isinstance(b, (list, tuple)):
        return (isinstance(a, (list, tuple)) and len(a) == len(b)
                and all(_same_value(x, y) for x, y in zip(a, b)))
    return np.array_equal(np.asarray(a), np.asarray(b))


def export_state(ref_idx) -> dict:
    """Read the reference index into the plain-array state that
    ``repro_torch.index.invindex.InvertedIndex.from_state`` takes."""
    gen = ref_idx.gen
    terms = {}
    for t, tp in gen.terms.items():
        terms[int(t)] = {
            "df": int(tp.df),
            "firsts": np.asarray([b[0] for b in tp.blocks], np.int64),
            "lasts": np.asarray(gen.block_lasts(t), np.int64),
            "impact_bmax": np.asarray(gen.impact_block_max(t), np.float64),
            "gaps": [{f: getattr(b[1], f) for f in _ENCODED_FIELDS}
                     for b in tp.blocks],
            "tfs": [{f: getattr(b[2], f) for f in _ENCODED_FIELDS}
                    for b in tp.blocks],
        }
    return {"codec": gen.codec, "doclen": np.asarray(gen.doclen, np.int64),
            "gid": int(gen.gid), "terms": terms}
