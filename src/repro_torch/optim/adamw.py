"""AdamW from scratch (counterpart of the JAX package's ``optim/adamw.py``):
decoupled weight decay, global-norm clipping, cosine schedule with linear
warmup.  The optimizer state mirrors the parameter tree (a nested dict of
tensors, ``models.specs``): ``m`` and ``v`` in fp32, ``step`` an int32
scalar and, where a parameter is not fp32, an fp32 ``master`` copy.  Its
keys are the reference's, so a checkpoint carries across both ways.

Leaves are walked in sorted-key order, the order of ``jax.tree.leaves``.
The arithmetic is the reference's, in its order (clip scale, bias
corrections, ``mhat / (sqrt(vhat) + eps) + wd * ref``), all in fp32; it
runs in place on the parameters and the state, with the step-dependent
scalars as device tensors, so an update never waits for the host.  Not
``torch.optim.AdamW``: its state and its arithmetic are not these.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..models.specs import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def cosine_lr(step, cfg: AdamWConfig) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), an fp32 tensor
    on the step's device."""
    step = torch.as_tensor(step).to(torch.float32)
    f32 = dict(dtype=torch.float32, device=step.device)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(torch.tensor(math.pi, **f32) * t))
    return cfg.lr * warm * cos


def _needs_master(params) -> bool:
    return any(x.dtype != torch.float32 for x in tree_leaves(params))


def adamw_init(params) -> dict:
    """m/v in fp32 on each parameter's device (laid out as the parameter,
    a ``DTensor``'s shards under a plan); an fp32 ``master`` copy when any
    parameter is low-precision (mixtral's bf16 weights)."""
    opt = {
        "m": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                      params),
        "v": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                      params),
        "step": torch.zeros((), dtype=torch.int32,
                            device=tree_leaves(params)[0].device),
    }
    if _needs_master(params):
        opt["master"] = tree_map(lambda p: p.detach().to(torch.float32,
                                                         copy=True), params)
    return opt


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(params, grads, opt: dict, cfg: AdamWConfig) -> dict:
    """One AdamW step, in place: ``params`` (the model's tree), ``opt``'s
    tensors and ``grads`` (consumed: scaled in place).  Returns the
    reference's metrics, ``{"grad_norm", "lr"}``, as device scalars."""
    step = opt["step"] + 1
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    lr = cosine_lr(step, cfg)
    stepf = step.to(torch.float32)
    b1, b2 = cfg.b1, cfg.b2
    f32 = dict(dtype=torch.float32, device=stepf.device)
    bc1 = 1 - torch.pow(torch.tensor(b1, **f32), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, **f32), stepf)
    flat_ma = (tree_leaves(opt["master"]) if "master" in opt
               else [None] * len(tree_leaves(params)))
    for p, g, m, v, ma in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(opt["m"]), tree_leaves(opt["v"]),
                              flat_ma):
        g = g.to(torch.float32).mul_(scale)
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        ref = ma if ma is not None else p           # p itself without one
        upd = (m / bc1).div_(torch.sqrt(v / bc2).add_(cfg.eps))
        upd.add_(cfg.weight_decay * ref)
        ref.sub_(upd.mul_(lr))
        if ma is not None:
            p.copy_(ma)
    opt["step"].copy_(step)
    return {"grad_norm": gn, "lr": lr}
