"""Serving example on the PyTorch/CUDA port: prefill a batch of prompts,
then batched greedy decode against the KV cache, on the card unless asked
for the CPU.

The port's counterpart of ``examples/serve_lm.py``, with the same arguments
and output (and ``--torch-device``): any LM of ``repro_torch.configs.ARCHS``
(dense GQA, MLA, mixture-of-experts).

  PYTHONPATH=src python examples/serve_lm_torch.py [--arch smollm-135m] [--tokens 16] [--torch-device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.index.device import resolve_device
from repro_torch.models import transformer as T


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--torch-device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args()
    dev = resolve_device(args.torch_device)

    spec = configs.get(args.arch)
    cfg = spec.make_smoke_config()           # CPU-sized; same code path as full
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = T.init(cfg, gen)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)),
                              dtype=torch.int32, device=dev)

    logits, cache = T.prefill(model, prompts)
    # extend cache capacity for generated tokens (no SWA ring growth needed)
    if not cfg.window:
        cache = {k: torch.cat(
            [v, v.new_zeros(v.shape[:2] + (args.tokens,) + v.shape[3:])], dim=2)
            for k, v in cache.items()}

    out = []
    tok = torch.argmax(logits, -1).to(torch.int32)
    t0 = time.perf_counter()
    for i in range(args.tokens):
        out.append(tok.cpu().numpy())
        logits, cache = T.decode_step(model, cache, tok, args.prompt_len + i)
        tok = torch.argmax(logits, -1).to(torch.int32)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    gen_toks = np.stack(out, axis=1)
    print(f"arch={args.arch} cache={'MLA latent' if cfg.attn == 'mla' else ('SWA ring' if cfg.window else 'GQA')}")
    print(f"generated {gen_toks.shape} tokens in {dt*1e3:.1f} ms "
          f"({args.batch*args.tokens/dt:.0f} tok/s batched greedy)")
    print("sample:", gen_toks[0][:12])


if __name__ == "__main__":
    main()
