"""starcoder2-7b [arXiv:2402.19173; hf]: 32L d_model=4608 36H (GQA kv=4)
d_ff=18432 vocab=49152, RoPE.  long_500k skipped (pure full attention)."""

import torch

from ..models.transformer import LMConfig
from .base import ArchSpec, lm_batch_axes, lm_input_specs, lm_plan_for, lm_shapes


def make_config() -> LMConfig:
    return LMConfig(
        name="starcoder2-7b", n_layers=32, d_model=4608, n_heads=36,
        n_kv=4, head_dim=128, d_ff=18432, vocab=49152,
        dtype=torch.bfloat16, q_chunk=None, kv_chunk=1024,
    )


def make_smoke_config() -> LMConfig:
    return LMConfig(
        name="starcoder2-7b-smoke", n_layers=2, d_model=72, n_heads=6,
        n_kv=2, head_dim=12, d_ff=144, vocab=512,
        dtype=torch.float32, q_chunk=16, kv_chunk=16, loss_chunk=16,
    )


ARCH = ArchSpec(
    arch_id="starcoder2-7b", family="lm",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=lm_shapes(long_ok=False),
    plan_for=lm_plan_for(dense=True), input_specs=lm_input_specs,
    batch_axes=lm_batch_axes,
)
