"""starcoder2-3b [arXiv:2402.19173; hf]: 30L d_model=3072 24H (GQA kv=2)
d_ff=12288 vocab=49152, RoPE.  long_500k skipped (pure full attention)."""

import torch

from ..models.transformer import LMConfig
from .base import ArchSpec, lm_batch_axes, lm_input_specs, lm_plan_for, lm_shapes


def make_config() -> LMConfig:
    return LMConfig(
        name="starcoder2-3b", n_layers=30, d_model=3072, n_heads=24,
        n_kv=2, head_dim=128, d_ff=12288, vocab=49152,
        dtype=torch.bfloat16, q_chunk=None, kv_chunk=1024,
    )


def make_smoke_config() -> LMConfig:
    return LMConfig(
        name="starcoder2-3b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv=2, head_dim=16, d_ff=128, vocab=512,
        dtype=torch.float32, q_chunk=16, kv_chunk=16, loss_chunk=16,
    )


ARCH = ArchSpec(
    arch_id="starcoder2-3b", family="lm",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=lm_shapes(long_ok=False),
    plan_for=lm_plan_for(dense=True), input_specs=lm_input_specs,
    batch_axes=lm_batch_axes,
)
