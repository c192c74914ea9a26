#!/usr/bin/env python3
"""The model cells' weights at depth: the port's own float32 decode
against its float32 forward, and both against the plain reference.

    python3 portbench/lm_depth.py --workload dsv2lite-decode-conv \\
        --seeds 1,2 [--prompt 64] [--steps 8]

For each seed: the cell's weights (``reference/lm_weights.py``) in the
port's ``LM`` computing in float32 (TF32 off), a prompt of ``prompt``
tokens prefilled, then ``steps`` tokens decoded through the cache, each
step's logits held against the port's forward over the same tokens
(``transformer.prefill``) and against the reference's
(``reference/deepseek_v2_lite.py``).  Prints one JSON line a seed with
the largest gap over the largest logit magnitude of each pair.  Random
weights whose round-off grew with depth would make no limit of the
cell's check mean anything; these readings show that the init law keeps
float32 paths together at the published depth.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compare(cell, seed: int, prompt: int, steps: int, device) -> dict:
    """{pair: largest |gap| / largest |logit|} over the decoded steps."""
    import torch
    from repro_torch.models import transformer
    from portbench.reference import deepseek_v2_lite as reference
    from portbench.reference import lm_weights
    reference.fp32_matmuls()
    config = cell.config
    cfg = dataclasses.replace(cell.driver.port_config(config),
                              dtype=torch.float32)
    w = lm_weights.draw(config, seed, device)
    model = transformer.LM(cfg, w)
    tokens = torch.as_tensor(lm_weights.prompts(config, 1, prompt + steps,
                                                seed), device=device)
    _, cache = transformer.prefill(model, tokens[:, :prompt])
    cache = {k: torch.cat([v, v.new_zeros(v.shape[:2] + (steps,)
                                          + v.shape[3:])], dim=2)
             for k, v in cache.items()}
    ref, _ = reference.run(w, config, tokens, 0)
    worst = {"decode_vs_forward": 0.0, "decode_vs_reference": 0.0,
             "forward_vs_reference": 0.0}

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    for j in range(steps):
        dec, cache = transformer.decode_step(model, cache,
                                             tokens[:, prompt + j],
                                             prompt + j)
        fwd, _ = transformer.prefill(model, tokens[:, :prompt + j + 1])
        want = ref[:, prompt + j]
        for name, value in (("decode_vs_forward", rel(dec, fwd)),
                            ("decode_vs_reference", rel(dec, want)),
                            ("forward_vs_reference", rel(fwd, want))):
            worst[name] = max(worst[name], value)
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    from portbench import harness
    cell = harness.resolve(args.workload)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else (
        torch.device("cpu"))
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = compare(cell, seed, args.prompt, args.steps, device)
        print(json.dumps({"seed": seed, "device": str(device), **out,
                          "seconds": time.perf_counter() - t0}), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
