"""mixtral-8x22b [arXiv:2401.04088; hf]: 56L d_model=6144 48H (GQA kv=8)
d_ff=16384 vocab=32768, 8 experts top-2, SWA (window 4096 per assignment).
long_500k runs: the sliding window caps the KV cache at 4096."""

import torch

from ..models.transformer import LMConfig
from .base import ArchSpec, lm_input_specs, lm_shapes


def make_config() -> LMConfig:
    return LMConfig(
        name="mixtral-8x22b", n_layers=56, d_model=6144, n_heads=48,
        n_kv=8, head_dim=128, d_ff=16384, vocab=32768, window=4096,
        n_experts=8, n_shared=0, top_k=2, d_ff_expert=16384, n_dense_layers=0,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16,
        expand_kv=True,  # 48H/8KV cannot split (8,6) over 16-way TP
        q_chunk=None, kv_chunk=1024,
    )


def make_smoke_config() -> LMConfig:
    return LMConfig(
        name="mixtral-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv=2, head_dim=8, d_ff=128, vocab=512, window=16,
        n_experts=4, n_shared=0, top_k=2, d_ff_expert=32, n_dense_layers=0,
        dtype=torch.float32, q_chunk=16, kv_chunk=16, loss_chunk=16,
    )


ARCH = ArchSpec(
    arch_id="mixtral-8x22b", family="lm",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=lm_shapes(long_ok=True),
    plan_for=None, input_specs=lm_input_specs, batch_axes=None,
)
