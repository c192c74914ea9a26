"""The 10 Group-Scheme variants' torch whole-list decoders (the packed LD
decode then one vectorized unpack, and the one-quadruple-a-step form with
its TZCNT-style unary reads) against the JAX package's ``decode_jax_vec``
and ``decode_jax_scalar`` on ``test_codecs.py``'s cases, bitwise; the IU
lookup tables and the arena control geometry against the reference's."""

import numpy as np
import pytest

from repro.core import group_scheme as ref_gs
from repro_torch.core import group_scheme

from test_torch_frame_codecs import assert_torch_decoders_match_reference


@pytest.mark.parametrize("variant", group_scheme.VARIANTS)
def test_torch_decoders_match_jax_decoders(variant):
    assert_torch_decoders_match_reference(f"group_scheme_{variant}")


def test_iu_tables_and_arena_geometry_match_reference():
    assert group_scheme.VARIANTS == ref_gs.VARIANTS
    np.testing.assert_array_equal(group_scheme.IU_COUNT_NP, ref_gs.IU_COUNT_NP)
    np.testing.assert_array_equal(group_scheme.IU_LDS_NP, ref_gs.IU_LDS_NP)
    x = np.random.default_rng(3).geometric(0.05, 509).astype(np.uint32)
    for v in group_scheme.VARIANTS:
        for qmax in (32, 128, 129):
            assert (group_scheme.arena_ctrl_width(v, qmax)
                    == ref_gs.arena_ctrl_width(v, qmax)), (v, qmax)
        enc = group_scheme.encode(x, v)
        np.testing.assert_array_equal(group_scheme.arena_block_ctrl(enc),
                                      ref_gs.arena_block_ctrl(enc))
