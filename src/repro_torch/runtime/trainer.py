"""Train-step factories (counterpart of the JAX package's
``runtime/trainer.py``).

  * ``make_train_step``: loss -> gradient -> AdamW on one device.  The
    reference's global-jit GSPMD path reduces gradients by the sharding
    plan's collectives; the port has no plans yet (ROADMAP.md, step
    A.13.5), so its ``grad_transform`` hook is not ported.

  * ``make_compressed_dp_train_step``: data parallelism over R ranks in
    one process, every rank's gradient synchronised with the COMPRESSED
    all-reduce (int8/int4 + error feedback, ``distributed/collectives.py``)
    -- the paper's bit packing applied to the gradient exchange.

A step takes the model (a ``models.specs._Tree``), the optimizer state
and a batch (numpy arrays or tensors, moved to the model's device) and
updates the model and the state in place, as ``decode_step`` writes its
cache: ``step(model, opt, batch) -> (model, opt, metrics)``, metrics the
reference's (``loss``, the loss's own, ``grad_norm``, ``lr``) as device
scalars.  Parameters take gradients only inside a step
(``_Tree.grads_on``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..distributed.collectives import compressed_psum_mean
from ..models.specs import tree_leaves, tree_map, tree_unflatten
from ..optim.adamw import AdamWConfig, adamw_init, adamw_update


def to_device(batch: dict, device) -> dict:
    """Every leaf of ``batch`` a tensor on ``device`` (numpy arrays keep
    their dtype)."""
    return {k: (torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor)
                else v).to(device) for k, v in batch.items()}


def value_and_grad(loss_fn: Callable, model, batch: dict):
    """((loss, metrics), grads): ``loss_fn(model, batch)`` and its gradient
    as a tree shaped like ``model.tree()`` (zeros where a parameter does
    not reach the loss, as ``jax.grad`` gives)."""
    with model.grads_on() as params:
        loss, metrics = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, tree_leaves(params),
                                    allow_unused=True, materialize_grads=True)
    detach = lambda t: t.detach() if isinstance(t, torch.Tensor) else t
    return ((loss.detach(), {k: detach(v) for k, v in metrics.items()}),
            tree_unflatten(params, list(grads)))


def _device(model) -> torch.device:
    return next(model.parameters()).device


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig):
    """loss_fn(model, batch) -> (loss, metrics)."""

    def step(model, opt, batch):
        batch = to_device(batch, _device(model))
        (loss, metrics), grads = value_and_grad(loss_fn, model, batch)
        om = adamw_update(model.tree(), grads, opt, opt_cfg)
        return model, opt, {"loss": loss, **metrics, **om}

    return step


def make_compressed_dp_train_step(loss_fn: Callable, opt_cfg: AdamWConfig,
                                  ranks: int, bits: Optional[int] = 8):
    """Data parallelism over ``ranks`` logical ranks with the compressed
    gradient all-reduce.  Returns ``(step_fn, init_opt_fn)``.

    Each rank takes the gradient of its share of the batch (rows split in
    ``ranks`` equal parts, in order) against the one copy of the
    parameters; ``compressed_psum_mean`` (``bits`` 8 or 4) with error
    feedback, or an fp32 mean over the ranks (``bits=None``), gives every
    rank the same mean gradient; the loss is averaged over the ranks, and
    AdamW runs once.  The loss's own metrics are rank 0's, as the
    reference's ``out_specs`` declares a device's own replicated.

    The error-feedback residual is a rank's own (the reference's ``ef``
    leaf holds each device's local residual under a replicated spec):
    ``opt["ef"]`` is a list of ``ranks`` trees, each rank's residual in
    memory, and a checkpoint stores every rank's (``1/ef/<r>/...``) where
    the reference's stores one device's (ROADMAP.md §C).
    """

    def init_opt(model):
        params = model.tree()
        opt = adamw_init(params)
        opt["ef"] = [tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                    device=p.device), params)
                     for _ in range(ranks)]
        return opt

    def step(model, opt, batch):
        batch = to_device(batch, _device(model))
        b = next(iter(batch.values())).shape[0]
        if b % ranks:
            raise ValueError(f"a batch of {b} rows does not split over "
                             f"{ranks} ranks")
        per = b // ranks
        results = [value_and_grad(loss_fn, model, {k: v[r * per:(r + 1) * per]
                                                   for k, v in batch.items()})
                   for r in range(ranks)]
        (_, metrics), _ = results[0]
        loss = sum(lo for (lo, _), _ in results) / ranks
        grads = [g for _, g in results]
        del results
        if bits is None:                      # uncompressed control (fp32 mean)
            flat = [sum(x.to(torch.float32) for x in xs) / ranks
                    for xs in zip(*map(tree_leaves, grads))]
            mean = tree_unflatten(grads[0], flat)
        else:
            means, opt["ef"] = compressed_psum_mean(
                grads, bits=bits, error_feedback=opt["ef"])
            mean = means[0]
        del grads
        # the reference's update sees m, v and step only, and its step
        # returns them with ef: a master copy from adamw_init goes
        opt.pop("master", None)
        om = adamw_update(model.tree(), mean, opt, opt_cfg)
        return model, opt, {"loss": loss, **metrics, **om}

    return step, init_opt
