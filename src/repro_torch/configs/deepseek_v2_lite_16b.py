"""deepseek-v2-lite-16b [arXiv:2405.04434; hf]: 27L d_model=2048 16H MLA
(kv_lora=512, qk_nope=128, qk_rope=64, v_head=128) vocab=102400; MoE: 64
routed experts top-6 + 2 shared, d_ff_expert=1408, first layer dense
(d_ff=10944).  long_500k runs: the MLA latent cache is 576/token."""

import torch

from ..models.transformer import LMConfig
from .base import ArchSpec, lm_batch_axes, lm_input_specs, lm_plan_for, lm_shapes


def make_config() -> LMConfig:
    return LMConfig(
        name="deepseek-v2-lite-16b", n_layers=27, d_model=2048, n_heads=16,
        n_kv=16, head_dim=128, d_ff=10944, vocab=102400, attn="mla",
        kv_lora=512, qk_nope=128, qk_rope=64, v_head=128,
        n_experts=64, n_shared=2, top_k=6, d_ff_expert=1408, n_dense_layers=1,
        dtype=torch.bfloat16, q_chunk=None, kv_chunk=1024,
    )


def make_smoke_config() -> LMConfig:
    return LMConfig(
        name="deepseek-v2-lite-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv=4, head_dim=16, d_ff=96, vocab=512, attn="mla",
        kv_lora=32, qk_nope=16, qk_rope=8, v_head=16,
        n_experts=8, n_shared=2, top_k=2, d_ff_expert=32, n_dense_layers=1,
        dtype=torch.float32, q_chunk=16, kv_chunk=16, loss_chunk=16,
    )


ARCH = ArchSpec(
    arch_id="deepseek-v2-lite-16b", family="lm",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=lm_shapes(long_ok=True),
    plan_for=lm_plan_for(dense=False), input_specs=lm_input_specs,
    batch_axes=lm_batch_axes,
    notes="assignment lists '2 shared+160 routed' alongside 'MoE 64e top-6'; "
          "the 64-routed figure matches V2-Lite (160 belongs to full V2) and "
          "is used here.",
)
