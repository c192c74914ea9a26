#!/usr/bin/env python3
"""How far round-off grows with depth in the dense LMs' random-weight
models, in the JAX reference and in the PyTorch port, on the CPU.

The weights are the reference's ``T.init`` draw (``jax.random.PRNGKey(0)``)
at the full width and vocabulary of each named architecture, carried into
the port by ``load_reference_params``; each depth runs the first ``n``
layers of that one draw.  The reference's init gives every stacked leaf the
standard deviation ``1/sqrt(shape[-2])``, so ``wq`` and ``wk`` (``(D, H,
K)``, ``(D, KH, K)``) draw at ``1/sqrt(H)`` and ``1/sqrt(KH)``: the
attention scores reach the hundreds, the softmax picks near-ties, and a
perturbation grows layer by layer.  Per depth it prints, for a batch of 2
prompts of ``--seq`` tokens from ``--seed``:

  * ``dvf``: fp32 decode step at position S against ``trunk`` on S+1
    tokens, max |diff| over max |logit| (the reference's
    ``test_decode_matches_full_forward`` check);
  * ``bf16``: the bf16 prefill's last logits against the fp32 prefill's,
    same measure;
  * ``sens`` (reference only): ``trunk``'s change when the embedding is
    scaled by 1 + 1e-7, over its max.

With ``--grad`` it prints instead, per depth, the training gradient of
one sequence of ``--seq`` tokens in the architecture's own dtypes (fp32
weights, its activation dtype): the global norm of ``loss_fn``'s gradient
in the reference (``jax.value_and_grad``) and in the port (autograd), the
loss of each, and each one's losses over ``--steps`` AdamW steps (lr
``--lr``, no warm-up) on that sequence: ``repro.optim.adamw`` and the
port's ``make_train_step``.

No card is needed.  Usage::

    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/lm_roundoff_depth.py \\
        [--arch smollm-135m:1,2,4,8,16,30] [--arch starcoder2-3b:1,2,4] \\
        [--seq 64] [--seed 0]
    JAX_PLATFORMS=cpu PYTHONPATH=src python tools/lm_roundoff_depth.py \\
        --grad --arch smollm-135m:2,30 --seq 512 [--steps 5] [--lr 3e-3]

(about 2 minutes and 8 GB of host memory with the defaults; ``--grad`` as
shown about 4 minutes and 6 GB).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_ARCHS = ("smollm-135m:1,2,4,8,16,30", "starcoder2-3b:1,2,4")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", action="append", default=None,
                    help="<arch>:<depth,depth,...> (repeatable)")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--grad", action="store_true",
                    help="gradient norms and AdamW losses per depth")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--lr", type=float, default=3e-3)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro import configs as ref_configs
    from repro.models import transformer as RT
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.models.specs import tree_map

    def rel(a, b) -> float:
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        return float(np.abs(a - b).max() / np.abs(b).max())

    if args.grad:
        return grad_rows(args, jax, jnp, np, torch, ref_configs, RT,
                         configs, T, tree_map)
    rows = []
    for item in args.arch or DEFAULT_ARCHS:
        arch, depths = item.split(":")
        depths = sorted(int(d) for d in depths.split(","))
        top = depths[-1]
        ref_full = dataclasses.replace(ref_configs.get(arch).make_config(),
                                       n_layers=top, dtype=jnp.float32)
        full = dataclasses.replace(configs.get(arch).make_config(),
                                   n_layers=top, dtype=torch.float32)
        params = RT.init(ref_full, jax.random.PRNGKey(args.seed))
        model = T.init(full, torch.Generator().manual_seed(args.seed))
        T.load_reference_params(model, jax.tree.map(np.asarray, params))
        rng = np.random.default_rng(args.seed + 1)
        toks = rng.integers(0, full.vocab, (2, args.seq)).astype(np.int32)
        s = args.seq
        for n in depths:
            rp = dict(params, dense_layers=jax.tree.map(lambda a: a[:n],
                                                        params["dense_layers"]))
            rc = dataclasses.replace(ref_full, n_layers=n)
            rcb = dataclasses.replace(rc, dtype=jnp.bfloat16)
            tree = model.tree()
            tree["dense_layers"] = tree_map(lambda a: a[:n], tree["dense_layers"])
            m32 = T.LM(dataclasses.replace(full, n_layers=n), tree)
            mbf = T.LM(dataclasses.replace(full, n_layers=n,
                                           dtype=torch.bfloat16), tree)
            row = {"arch": arch, "layers": n}
            # reference
            jt = jnp.asarray(toks)
            lg, cache = jax.jit(lambda p, t: RT.prefill(p, t, rc))(rp, jt)
            cache = {k: jnp.concatenate([v, jnp.zeros(v.shape[:2] + (1,) + v.shape[3:], v.dtype)], 2)
                     for k, v in cache.items()}
            nxt = jnp.argmax(lg, -1).astype(jnp.int32)
            ld, _ = jax.jit(lambda p, c, t: RT.decode_step(p, c, t, jnp.int32(s), rc))(rp, cache, nxt)
            trunk = jax.jit(lambda p, t: RT.trunk(p, t, rc)[0])
            x = trunk(rp, jnp.concatenate([jt, nxt[:, None]], 1))
            row["ref_dvf"] = rel(ld, x[:, -1] @ rp["embed"].T)
            lb, _ = jax.jit(lambda p, t: RT.prefill(p, t, rcb))(rp, jt)
            row["ref_bf16"] = rel(jnp.asarray(lb, jnp.float32), lg)
            x0 = trunk(rp, jt)
            x1 = trunk(dict(rp, embed=rp["embed"] * (1 + 1e-7)), jt)
            row["ref_sens"] = rel(x1, x0)
            # port
            tt = torch.from_numpy(toks)
            lg, cache = T.prefill(m32, tt)
            cache = {k: torch.cat([v, v.new_zeros(v.shape[:2] + (1,) + v.shape[3:])], 2)
                     for k, v in cache.items()}
            nxt = lg.argmax(-1).to(torch.int32)
            ld, _ = T.decode_step(m32, cache, nxt, s)
            x = T.trunk(m32, torch.cat([tt, nxt[:, None]], 1))[0]
            row["port_dvf"] = rel(ld.numpy(), (x[:, -1] @ m32.embed.T).numpy())
            lb, _ = T.prefill(mbf, tt)
            row["port_bf16"] = rel(lb.float().numpy(), lg.numpy())
            rows.append(row)
            print(f"{arch} layers {n:2d}: dvf ref {row['ref_dvf']:.3e} port "
                  f"{row['port_dvf']:.3e}; bf16 ref {row['ref_bf16']:.3e} port "
                  f"{row['port_bf16']:.3e}; sens ref {row['ref_sens']:.3e}",
                  flush=True)
    print(json.dumps({"seq": args.seq, "seed": args.seed, "rows": rows}))
    return 0


def grad_rows(args, jax, jnp, np, torch, ref_configs, RT, configs, T,
              tree_map) -> int:
    """The ``--grad`` table (module docstring)."""
    from repro.optim import adamw as RA
    from repro_torch.optim import AdamWConfig, adamw_init, global_norm
    from repro_torch.runtime.trainer import make_train_step, value_and_grad

    rows = []
    for item in args.arch or ("smollm-135m:2,30",):
        arch, depths = item.split(":")
        depths = sorted(int(d) for d in depths.split(","))
        top = depths[-1]
        ref_full = dataclasses.replace(ref_configs.get(arch).make_config(),
                                       n_layers=top)
        full = dataclasses.replace(configs.get(arch).make_config(),
                                   n_layers=top)
        params = RT.init(ref_full, jax.random.PRNGKey(args.seed))
        model = T.init(full, torch.Generator().manual_seed(args.seed))
        T.load_reference_params(model, jax.tree.map(np.asarray, params))
        rng = np.random.default_rng(args.seed + 1)
        toks = rng.integers(0, full.vocab, (1, args.seq + 1)).astype(np.int32)
        x, y = toks[:, :-1], toks[:, 1:]
        ocfg = RA.AdamWConfig(lr=args.lr, warmup_steps=0,
                              total_steps=args.steps)
        pcfg = AdamWConfig(lr=args.lr, warmup_steps=0, total_steps=args.steps)
        for n in depths:
            rp = dict(params, dense_layers=jax.tree.map(lambda a: a[:n],
                                                        params["dense_layers"]))
            rc = dataclasses.replace(ref_full, n_layers=n)
            tree = model.tree()
            tree["dense_layers"] = tree_map(lambda a: a[:n], tree["dense_layers"])
            m = T.LM(dataclasses.replace(full, n_layers=n), tree)
            vg = jax.jit(jax.value_and_grad(
                lambda p: RT.loss_fn(p, jnp.asarray(x), jnp.asarray(y), rc)[0]))
            loss, g = vg(rp)
            row = {"arch": arch, "layers": n, "dtype": str(rc.dtype),
                   "ref_loss": float(loss),
                   "ref_grad_norm": float(RA.global_norm(g))}
            lm_loss = lambda mm, b: T.loss_fn(mm, b["x"], b["y"])
            batch = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
            (pl, _), pg = value_and_grad(lm_loss, m, batch)
            row["port_loss"] = float(pl)
            row["port_grad_norm"] = float(global_norm(pg))
            del pg
            # the port's AdamW steps, on a copy (the depths share leaves)
            mc = T.LM(m.cfg, tree_map(lambda a: a.clone(), m.tree()))
            oc, pstep, plosses = adamw_init(mc.tree()), make_train_step(
                lm_loss, pcfg), []
            for _ in range(args.steps):
                mc, oc, met = pstep(mc, oc, batch)
                plosses.append(float(met["loss"]))
            row["port_adamw_losses"] = plosses
            del mc, oc
            # the reference's own AdamW steps on this one sequence
            p, opt, losses = rp, RA.adamw_init(rp), []
            step = jax.jit(lambda p, o: (lambda lg: (lg[0],) + RA.adamw_update(
                p, lg[1], o, ocfg)[:2])(vg(p)))
            for _ in range(args.steps):
                l, p, opt = step(p, opt)
                losses.append(float(l))
            row["ref_adamw_losses"] = losses
            rows.append(row)
            print(f"{arch} layers {n:2d} ({row['dtype']} activations): grad "
                  f"norm ref {row['ref_grad_norm']:.4e} port "
                  f"{row['port_grad_norm']:.4e}; loss ref {row['ref_loss']:.5f} "
                  f"port {row['port_loss']:.5f}; AdamW losses ref "
                  f"{[round(v, 4) for v in losses]} port "
                  f"{[round(v, 4) for v in plosses]}", flush=True)
    print(json.dumps({"seq": args.seq, "seed": args.seed, "lr": args.lr,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
