"""End-to-end example on the PyTorch/CUDA port: train an LM on a COMPRESSED
token store with the fault-tolerant loop (checkpoint/resume, straggler
watchdog), on the card unless asked for the CPU.

The port's counterpart of ``examples/train_lm.py``, with the same presets,
arguments and output (and ``--torch-device``).  Default --preset tiny
trains a ~1M-param smollm-family model for 200 steps and asserts the loss
decreases; --preset full selects the real smollm-135m config (same code
path).  ``--ckpt`` defaults to a fresh temporary directory (removed at
exit); give one to resume a run from it.

  PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] [--preset tiny] [--torch-device cpu]
  PYTHONPATH=src python examples/train_lm_torch.py --ckpt DIR   # continue from DIR
"""

import argparse
import dataclasses
import tempfile

import numpy as np
import torch

from repro_torch.configs import smollm_135m
from repro_torch.data.pipeline import TokenStore, lm_batch_iter
from repro_torch.index.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import train_loop as TL
from repro_torch.runtime.trainer import make_train_step


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=["tiny", "full"], default="tiny")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--crash-at", type=int, default=None)
    ap.add_argument("--torch-device", default="cuda",
                    help="torch device (default: the card)")
    args = ap.parse_args()
    dev = resolve_device(args.torch_device)

    if args.preset == "full":
        cfg = smollm_135m.make_config()
    else:
        cfg = dataclasses.replace(
            smollm_135m.make_smoke_config(), n_layers=4, d_model=128, n_heads=4,
            n_kv=2, head_dim=32, d_ff=512, vocab=2048)

    # synthetic corpus stored COMPRESSED (bp128 blocks); loader decodes on the fly
    rng = np.random.default_rng(0)
    n_tok = args.batch * (args.seq + 1) * 64
    # markov-ish stream so the model has something to learn
    base = rng.integers(0, cfg.vocab // 4, n_tok).astype(np.uint32)
    toks = np.where(rng.random(n_tok) < 0.7, np.roll(base, 1) % cfg.vocab, base)
    store = TokenStore.build(toks.astype(np.uint32), codec="bp128")
    print(f"token store: {store.compressed_bytes()/1e6:.2f} MB compressed "
          f"({store.raw_bytes/1e6:.2f} MB raw)")

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = T.init(cfg, gen)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {cfg.name} {n_params/1e6:.1f}M params")

    ocfg = AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps)

    def loss_fn(m, batch):
        return T.loss_fn(m, batch["tokens"], batch["labels"])

    step = make_train_step(loss_fn, ocfg)
    with tempfile.TemporaryDirectory() as tmp:
        loop_cfg = TL.LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt or tmp,
                                 ckpt_every=50, log_every=20,
                                 crash_at_step=args.crash_at)
        model, opt, info = TL.run(step, model, adamw_init(model.tree()),
                                  lm_batch_iter(store, args.batch, args.seq),
                                  loop_cfg)
    first = info["metrics"][0]["loss"] if info["metrics"] else float("nan")
    last = info["metrics"][-1]["loss"]
    print(f"\nloss {first:.3f} -> {last:.3f}  (stragglers flagged: {len(info['stragglers'])})")
    if args.preset == "tiny" and info["metrics"]:
        assert last < first, "loss did not decrease"
        print("OK: loss decreased on the compressed pipeline")


if __name__ == "__main__":
    main()
