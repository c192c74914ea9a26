"""A cell of ``BENCHMARK.json`` cut to a size a CPU test run holds: 20,000
documents and 40 lists for an index cell; for a model cell the arch's
smoke configuration (the port's ``make_smoke_config`` sizes, computing in
the cell's bfloat16), 8 sessions of 64 tokens taking 16-token turns; a
short window.

A model cell's limits are the cell's rule applied at this size: at the
published size bfloat16 routing flips cascade through the 26 expert
layers, at this one they do not, so each limit lies between this size's
own readings (:data:`TINY_LM_LIMITS`)."""

from __future__ import annotations

import time

TINY_DOCS = 20_000
TINY_LISTS = 40


# deepseek-v2-lite-16b's smoke configuration, by the model's own key names
SMOKE_LM = {"num_hidden_layers": 2, "hidden_size": 64,
            "num_attention_heads": 4, "intermediate_size": 96,
            "vocab_size": 512, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
            "qk_rope_head_dim": 8, "v_head_dim": 16,
            "n_routed_experts": 8, "n_shared_experts": 2,
            "num_experts_per_tok": 2, "moe_intermediate_size": 32,
            "num_key_value_heads": 4, "first_k_dense_replace": 1,
            "capacity_factor": 8 / 2, "smoke": True}
TINY_TURN = {"sessions": 8, "prompt_len": 64, "turn_tokens": 16,
             "prefill_batch": 4, "first_kept": 8}
# sound runs read logit_err_p50 0.0021-0.0023 at this size, the float8
# control 0.0158-0.0163; worst_session_err_p50 0.0026-0.0028 against
# 0.0206-0.0236 (seeds 3, 4, 5, 11, 12, 2**31 + 5); token_gap_p90 reads 0
# on both
TINY_LM_LIMITS = {"logit_err_p50": 0.006, "worst_session_err_p50": 0.008,
                  "token_gap_p90": 0.2, "rows_missing": 0}


def tiny_cell(name: str, n_docs: int = TINY_DOCS):
    from portbench import harness
    cell = harness.resolve(name)
    if "arch" in cell.config:
        cell.config = dict(cell.config, **SMOKE_LM)
        cell.traffic = dict(cell.traffic, **TINY_TURN)
        cell.driver.LIMITS = dict(TINY_LM_LIMITS)
    else:
        cell.config = dict(cell.config, n_docs=n_docs,
                           n_terms_sampled=TINY_LISTS, n_lists=TINY_LISTS)
    # a short window serves a few passes: half of the later lists are checked
    cell.traffic = dict(cell.traffic,
                        check_share=max(cell.traffic.get("check_share", 1.0),
                                        0.5))
    return cell


def tiny_run(name: str, seed: int = 5, seconds: float = 0.5, device="cpu",
             trace: bool = False) -> dict:
    import torch
    from portbench import harness
    return harness.run(tiny_cell(name), seed, seconds, trace,
                       torch.device(device), time.perf_counter(),
                       log=lambda msg: None)
