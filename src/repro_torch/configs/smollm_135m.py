"""smollm-135m [hf:HuggingFaceTB/SmolLM-135M]: 30L d_model=576 9H (GQA kv=3)
d_ff=1536 vocab=49152, llama-arch.  long_500k skipped (full attention)."""

import torch

from ..models.transformer import LMConfig
from .base import ArchSpec, lm_batch_axes, lm_input_specs, lm_plan_for, lm_shapes


def make_config() -> LMConfig:
    return LMConfig(
        name="smollm-135m", n_layers=30, d_model=576, n_heads=9,
        n_kv=3, head_dim=64, d_ff=1536, vocab=49152,
        dtype=torch.bfloat16, q_chunk=None, kv_chunk=1024,
    )


def make_smoke_config() -> LMConfig:
    return LMConfig(
        name="smollm-smoke", n_layers=2, d_model=48, n_heads=3,
        n_kv=3, head_dim=16, d_ff=96, vocab=512,
        dtype=torch.float32, q_chunk=16, kv_chunk=16, loss_chunk=16,
    )


ARCH = ArchSpec(
    arch_id="smollm-135m", family="lm",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=lm_shapes(long_ok=False),
    plan_for=lm_plan_for(dense=True), input_specs=lm_input_specs,
    batch_axes=lm_batch_axes,
)
