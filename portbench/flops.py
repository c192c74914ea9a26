"""The yardstick of the model cells' ``mfu``: the operations the published
model needs for a token, and the chip's peak.

A token at position ``p`` attends to ``p + 1`` positions.  Its work is
two operations a multiply-add of every active parameter outside the
embedding (each layer's attention projections; the dense layers' FFN; in
an expert layer the router, the ``num_experts_per_tok`` routed experts
and the shared ones), of the output head, and of the scores and values
over its context.  Capacity slots, casts and padding are not counted, so
a share from these counts never passes 100 % unless the time leaves out
part of the work.  Keys are the configuration's (the model's own
``config.json`` names).
"""

from __future__ import annotations

# NVIDIA H100 SXM5 (data sheet): dense bf16 tensor-core peak at the full
# 700 W power limit; a run's result line gives the card's own limit
PEAK_BF16_FLOPS = 989.4e12


def mla_moe_token_flops(cfg: dict, context: int) -> int:
    """Operations of one token that attends to ``context`` positions."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    lora, v = cfg["kv_lora_rank"], cfg["v_head_dim"]
    attention = (d * h * qk                                  # q (no q_lora)
                 + d * (lora + cfg["qk_rope_head_dim"])      # latent, rope key
                 + h * lora * (cfg["qk_nope_head_dim"] + v)  # up-projections
                 + h * v * d)                                # output
    dense_ffn = 3 * d * cfg["intermediate_size"]
    active = cfg["num_experts_per_tok"] + cfg["n_shared_experts"]
    moe_ffn = (d * cfg["n_routed_experts"]                   # router
               + 3 * d * cfg["moe_intermediate_size"] * active)
    layers, dense = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    params = (layers * attention + dense * dense_ffn
              + (layers - dense) * moe_ffn + d * cfg["vocab_size"])
    return 2 * params + 2 * layers * h * context * (qk + v)


def decode_turn_flops(cfg: dict, sessions: int, start: int,
                      steps: int) -> int:
    """Operations of ``steps`` decode steps of ``sessions`` sessions, the
    first step's token at position ``start``."""
    return sessions * sum(mla_moe_token_flops(cfg, start + j + 1)
                          for j in range(steps))
