"""Train-step factories (counterpart of the JAX package's
``runtime/trainer.py``).

  * ``make_train_step``: loss -> gradient -> AdamW.  Under a sharding
    plan (``distributed.sharding.plan_scope``) the model's parameters and
    the batch are ``DTensor``s and the plan's collectives reduce the
    gradients; ``grad_transform`` lays each out as its parameter
    (``configs.base.lm_step_fn``).

  * ``make_compressed_dp_train_step``: data parallelism over R ranks,
    every rank's gradient synchronised with the COMPRESSED all-reduce
    (int8/int4 + error feedback, ``distributed/collectives.py``) -- the
    paper's bit packing applied to the gradient exchange.  The ranks are
    processes on a mesh's DP axes, or a list in one process (one card).

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


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig,
                    grad_transform: Optional[Callable] = None):
    """loss_fn(model, batch) -> (loss, metrics).

    grad_transform (optional): applied to the gradient tree before the
    update, e.g. laying each gradient out as its parameter under a plan
    (``configs.base.lm_step_fn``), so a pending sum reduces into each
    rank's shard."""

    def step(model, opt, batch):
        batch = to_device(batch, _device(model))
        (loss, metrics), grads = value_and_grad(loss_fn, model, batch)
        if grad_transform is not None:
            grads = grad_transform(grads)
        om = adamw_update(model.tree(), grads, opt, opt_cfg)
        return model, opt, {"loss": loss, **metrics, **om}

    return step


def make_compressed_dp_train_step(loss_fn: Callable, opt_cfg: AdamWConfig,
                                  ranks: Optional[int] = None,
                                  bits: Optional[int] = 8, *, mesh=None,
                                  dp_axes=("pod", "data")):
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

    With ``mesh`` (a ``DeviceMesh``), the ranks are processes: the group
    of this rank along the mesh's ``dp_axes``, the reference's manual
    axes.  Every process takes the same global batch and keeps its own
    rows; ``ef`` is its own residual tree; the all-reduce is
    ``compressed_psum_mean_group``.  Its parameters, state and metrics
    are bit for bit the list form's (rank ``r``'s own metrics).
    """

    if mesh is not None:
        return _group_dp_step(loss_fn, opt_cfg, bits, mesh, dp_axes)

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


def _group_dp_step(loss_fn: Callable, opt_cfg: AdamWConfig, bits, mesh,
                   dp_axes):
    """``make_compressed_dp_train_step``'s form over a process group."""
    import torch.distributed as dist
    from ..distributed.collectives import (compressed_psum_mean_group,
                                           mesh_group)
    group = mesh_group(mesh, dp_axes)
    ranks, me = dist.get_world_size(group), dist.get_rank(group)

    def init_opt(model):
        params = model.tree()
        opt = adamw_init(params)
        opt["ef"] = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
        return opt

    def step(model, opt, batch):
        batch = to_device(batch, _device(model))
        b = next(iter(batch.values())).shape[0]
        if b % ranks:
            raise ValueError(f"a batch of {b} rows does not split over "
                             f"{ranks} ranks")
        per = b // ranks
        (loss, metrics), grads = value_and_grad(
            loss_fn, model, {k: v[me * per:(me + 1) * per]
                             for k, v in batch.items()})
        losses = [torch.empty_like(loss) for _ in range(ranks)]
        dist.all_gather(losses, loss, group=group)
        loss = sum(losses) / ranks            # the list form's order
        if bits is None:                      # uncompressed control (fp32 mean)
            flat = [g.to(torch.float32) for g in tree_leaves(grads)]
            for g in flat:
                dist.all_reduce(g, group=group)
            mean = tree_unflatten(grads, [g / ranks for g in flat])
        else:
            mean, opt["ef"] = compressed_psum_mean_group(
                grads, group, bits=bits, error_feedback=opt["ef"])
        del grads
        opt.pop("master", None)
        om = adamw_update(model.tree(), mean, opt, opt_cfg)
        return model, opt, {"loss": loss, **metrics, **om}

    return step, init_opt
