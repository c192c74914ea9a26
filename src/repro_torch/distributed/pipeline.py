"""2-stage GPipe pipeline parallelism across the "pod" axis (counterpart
of the JAX package's ``distributed/pipeline.py``).

The multi-pod mesh's "pod" axis defaults to data parallelism; for models
too deep or large for one pod, this module instead splits the layer stack
in two stages and microbatches activations across pods: the inter-pod hop
is the only traffic, once per microbatch, overlapping with the other
pod's compute (GPipe schedule, bubble = 1/(n_micro+1)).

One process a rank, as the reference's ``shard_map`` body is one device's
program: each "pod" rank holds its half of the stacked layers; both run
the same ``n_micro + 1`` steps; at each step stage 0 consumes microbatch
t, stage 1 the activation stage 0 sent it the step before, and the two
swap their outputs with ``batch_isend_irecv`` (the reference's
``ppermute`` [(0, 1), (1, 0)]).  Stage 1's outputs of steps 1..n_micro
are the results; they are broadcast over the pod group, so every rank
returns them, as the reference's ``out[n_micro:]`` is a value every
device can read.
"""

from __future__ import annotations

import torch

from ..models.specs import tree_leaves, tree_map


def _stage_params(params_stacked, me: int):
    """This stage's half of the stacked (L, ...) leaves: a ``DTensor`` split
    over "pod" gives its local shard, a full tensor its half."""
    def half(a):
        if hasattr(a, "to_local"):
            return a.to_local()
        n = a.shape[0] // 2
        return a[me * n:(me + 1) * n]
    return tree_map(half, params_stacked)


def pipeline_2stage(layer_fn, params_stacked, x_micro, mesh, *, pod_axis="pod"):
    """Run x through L stacked layers split across 2 pods.

    layer_fn(lp, x) -> x              (one layer)
    params_stacked: tree (nested dicts) or tensor, leaves (L, ...), L even
    x_micro: (n_micro, mb, ...) microbatched input (the same on every rank)
    mesh: a ``DeviceMesh`` with a ``pod_axis`` of size 2.
    Returns (n_micro, mb, ...) outputs after all L layers, on every rank.
    """
    import torch.distributed as dist
    if mesh.size(list(mesh.mesh_dim_names).index(pod_axis)) != 2:
        raise ValueError(f"the {pod_axis!r} axis must have 2 ranks")
    group = mesh.get_group(pod_axis)
    me = mesh.get_local_rank(pod_axis)
    peer = dist.get_global_rank(group, 1 - me)
    local = _stage_params(params_stacked, me)
    n_layers = tree_leaves(local)[0].shape[0]
    n_micro = x_micro.shape[0]

    def run_stage(h):
        for li in range(n_layers):
            h = layer_fn(tree_map(lambda a: a[li], local), h)
        return h

    buf = torch.zeros_like(x_micro[0])
    outs = []
    for t in range(n_micro + 1):
        # stage 0 consumes microbatch t (valid for t < n_micro);
        # stage 1 consumes the buffer received from stage 0
        inp = x_micro[min(t, n_micro - 1)] if me == 0 else buf
        out = run_stage(inp)
        got = torch.empty_like(out)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, out.contiguous(), peer, group),
                dist.P2POp(dist.irecv, got, peer, group)]):
            req.wait()
        buf = got
        outs.append(out)
    # stage-1 outputs for steps 1..n_micro are the pipeline results
    res = torch.stack(outs[1:]) if me == 1 else torch.empty(
        (n_micro,) + tuple(x_micro.shape[1:]), dtype=outs[0].dtype,
        device=outs[0].device)
    dist.broadcast(res, dist.get_global_rank(group, 1), group=group)
    return res

