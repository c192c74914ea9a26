"""Training launcher of the port, on the card unless asked for the CPU
(counterpart of the JAX package's ``launch/train.py``).

  python -m repro_torch.launch.train --arch smollm-135m --smoke --steps 4
  python -m repro_torch.launch.train --arch din --smoke --steps 4 --torch-device cpu
  python -m repro_torch.launch.train --arch egnn --shape molecule --steps 20 --ckpt DIR

Runs the fault-tolerant loop (``runtime.train_loop``) of the arch's train
cell (``--shape``, default its first) through ``configs.base.STEP_FNS``,
on ``launch/batches.py``'s smoke batches (the reference draws the same
arrays with its tests' ``_smoke_batch``; here a batch is a function of the
data cursor, so a resumed run replays it), with AdamW
(``--lr``, cosine over ``--steps``), a checkpoint every quarter of the run
in ``--ckpt`` (default: a fresh temporary directory, removed at exit; an
existing directory resumes from its newest intact step), and prints the
reference's ``final loss ...``.

The mesh and the plan are the reference's: the process group starts
(NCCL on the card, gloo on the CPU; ``torchrun``'s world, else a world of
1), a ``(world, 1)`` host mesh below 256 ranks or the production mesh from
256 up (``--multi-pod``: the 2x16x16 one, which raises on a smaller
world), and on more than one rank the arch's ``plan_for`` lays out the
parameters, the optimizer state and each batch (``DTensor``s) for the
whole run (a world of 1 runs unplanned, on plain tensors):

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch smollm-135m --smoke --steps 4
"""

from __future__ import annotations

import argparse
import tempfile

import numpy as np
import torch
import torch.distributed as dist


def main(argv=None) -> None:
    from .. import configs
    from ..configs.base import STEP_FNS
    from ..index.device import resolve_device
    from ..models import egnn, recsys, transformer
    from ..optim import AdamWConfig, adamw_init
    from ..runtime import train_loop as TL
    from ..distributed import sharding as shlib
    from .batches import smoke_batch
    from .mesh import launch_mesh, launch_scope, shutdown_world

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(configs.ARCHS))
    ap.add_argument("--shape", default=None)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a fresh temporary "
                         "one, removed at exit)")
    ap.add_argument("--smoke", action="store_true", help="the reduced config")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--torch-device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs on the "
                         "host)")
    args = ap.parse_args(argv)

    spec = configs.get(args.arch)
    train_cells = [c for c in spec.shapes.values() if c.kind == "train"]
    cell = spec.shapes[args.shape] if args.shape else train_cells[0]
    assert cell.kind == "train", f"{cell.name} is a serving shape; use launch.serve"
    cfg = spec.config_for_cell(
        spec.make_smoke_config() if args.smoke else spec.make_config(), cell)
    resolve_device(args.torch_device)
    owned = not dist.is_initialized()
    try:
        mesh, dev = launch_mesh(args.torch_device, multi_pod=args.multi_pod,
                                smoke=args.smoke)
        plan = spec.plan_for(cfg, cell)
        ocfg = AdamWConfig(lr=args.lr, total_steps=args.steps)
        mod = {"lm": transformer, "gnn": egnn, "recsys": recsys}[spec.family]
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        step, is_train = STEP_FNS[spec.family](cfg, cell, ocfg)
        with launch_scope(mesh, plan), \
                tempfile.TemporaryDirectory() as tmp:
            model = shlib.distribute_model(mod.init(cfg, gen), mod.axes(cfg))
            b_axes = spec.batch_axes(cfg, cell)

            def batch_iter(cursor):
                rng = np.random.default_rng([11, cursor])
                batch = smoke_batch(spec, cfg, cell, rng, dev)
                return shlib.distribute_tree(batch, b_axes), cursor + 1

            loop = TL.LoopConfig(total_steps=args.steps,
                                 ckpt_dir=args.ckpt or tmp,
                                 ckpt_every=max(args.steps // 4, 1),
                                 log_every=10)
            model, opt, info = TL.run(step, model, adamw_init(model.tree()),
                                      batch_iter, loop)
        print(f"final loss {info['metrics'][-1]['loss']:.4f}")
    finally:
        if owned:
            shutdown_world()


if __name__ == "__main__":
    main()
