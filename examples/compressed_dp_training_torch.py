"""Compressed data-parallel training on the PyTorch/CUDA port (the paper's
bit packing applied to the gradient exchange), on the card unless asked
for the CPU.

The port's counterpart of ``examples/compressed_dp_training.py``, with the
same arguments and output (and ``--torch-device``): the DIN recsys model
over 8 logical ranks in one process, each rank's gradient synchronised
with the int8/int4 compressed all-reduce + error feedback, against the
uncompressed fp32 mean; wire bytes drop 4x/8x, convergence matches.

  PYTHONPATH=src python examples/compressed_dp_training_torch.py [--steps 30] [--torch-device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import din
from repro_torch.index.device import resolve_device
from repro_torch.models import recsys as R
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.trainer import make_compressed_dp_train_step

RANKS = 8


def make_batch(cfg, rng, b):
    hist = rng.integers(0, cfg.item_vocab, (b, cfg.seq_len))
    target = rng.integers(0, cfg.item_vocab, b)
    # learnable signal: label correlates with target id parity
    label = ((target % 2) ^ (rng.random(b) < 0.1)).astype(np.int32)
    return {
        "target_item": target.astype(np.int32),
        "target_cate": (target % cfg.cate_vocab).astype(np.int32),
        "hist_items": hist.astype(np.int32),
        "hist_cates": (hist % cfg.cate_vocab).astype(np.int32),
        "hist_len": rng.integers(5, cfg.seq_len, b).astype(np.int32),
        "profile": rng.integers(0, cfg.profile_vocab, (b, cfg.n_profile)).astype(np.int32),
        "label": label,
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--torch-device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args()
    dev = resolve_device(args.torch_device)

    cfg = din.make_smoke_config()
    ocfg = AdamWConfig(lr=1e-2, warmup_steps=0, total_steps=args.steps, weight_decay=0.0)

    results = {}
    for bits in (None, 8, 4):
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        model = R.init(cfg, gen)
        step, init_opt = make_compressed_dp_train_step(
            R.loss_fn, ocfg, ranks=RANKS, bits=bits)
        opt = init_opt(model)
        rng = np.random.default_rng(1)
        losses = []
        for s in range(args.steps):
            batch = make_batch(cfg, rng, args.batch)
            model, opt, m = step(model, opt, batch)
            losses.append(float(m["loss"]))
        results[bits] = losses
        tag = "fp32" if bits is None else f"int{bits}+EF"
        print(f"{tag:9}  loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    drop32 = results[None][0] - results[None][-1]
    drop8 = results[8][0] - results[8][-1]
    print(f"\nconvergence ratio int8/fp32: {drop8/max(drop32,1e-9):.2f} "
          f"(1.0 = identical); wire bytes: int8 4x lower, int4 8x lower")


if __name__ == "__main__":
    main()
