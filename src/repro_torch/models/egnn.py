"""E(n)-Equivariant GNN (EGNN, Satorras et al. 2021, arXiv:2102.09844;
counterpart of the JAX package's ``models/egnn.py``): the forward and the
two losses, which train (``runtime.trainer``).

Message passing scatters with ``index_add_`` into a zeroed ``(n_nodes, .)``
tensor where the reference calls ``jax.ops.segment_sum``; on the card
float ``index_add_`` adds in no fixed order, so a run differs from the
next in the last bits.  Supports the four graph regimes: full-batch node
classification (cora / ogb-products), sampled subgraphs (reddit-like,
``models/sampler.py``), and batched small graphs (molecule, graph-level
regression through a sum readout).

Layer (eq. 3-6 of the paper):
  m_ij   = phi_e([h_i, h_j, ||x_i - x_j||^2])
  x_i'   = x_i + mean_j (x_i - x_j) * phi_x(m_ij)
  h_i'   = phi_h([h_i, sum_j m_ij])

The edge-wise part runs ``EDGE_CHUNK`` edges at a time, each chunk's sums
added into the node accumulators before ``h`` and ``x`` change: at
ogb-products' 61,859,328 edges one unchunked layer would hold over 100 GB
of (E, 64) fp32 activations.  The result is the same sums in another order.

Under a plan (``gnn_plan``) the edges split over every mesh axis and
the nodes stay whole: each rank sums its own edges' messages
(``index_add_`` has no ``DTensor`` rule: ``sharding.run_local``) and the
sums add up over the ranks; the sum readout of the molecule cell runs on
the whole node table the same way.

Under autograd (``specs.grad_on``) backward recomputes, as the reference
recomputes each layer under ``jax.checkpoint``: each layer, and inside it
each edge chunk (``torch.utils.checkpoint``), whose messages are added
into the node sums out of place; so backward holds one chunk's edge
activations at a time, and ogb-products trains on one card.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from ..distributed import sharding as shlib
from ..distributed.sharding import checkpoint, matmul, pick_last, shard
from .specs import (P, _Tree, abstract_params, axes_tree, grad_on,
                    init_params,
                    load_reference_params,  # noqa: F401  (the model's)
                    stack_layers, tree_leaves, tree_map, tree_unflatten)

# edges of one chunk of a layer's edge-wise part (about 8 GB of activations)
EDGE_CHUNK = 1 << 22


@dataclasses.dataclass(frozen=True)
class EGNNConfig:
    name: str
    n_layers: int = 4
    d_hidden: int = 64
    d_feat: int = 1433
    n_classes: int = 16
    task: str = "node_class"          # node_class | graph_reg
    coord_dim: int = 3
    dtype: Any = torch.float32


def _mlp_specs(d_in: int, d_hid: int, d_out: int) -> dict:
    return {
        "w0": P((d_in, d_hid), ("embed", "ffn")),
        "b0": P((d_hid,), (None,), "zeros"),
        "w1": P((d_hid, d_out), ("ffn", "embed")),
        "b1": P((d_out,), (None,), "zeros"),
    }


def _mlp(p, x):
    h = F.silu(matmul(x, p["w0"].to(x.dtype)) + p["b0"].to(x.dtype))
    return matmul(h, p["w1"].to(x.dtype)) + p["b1"].to(x.dtype)


def param_specs(cfg: EGNNConfig) -> dict:
    dh = cfg.d_hidden
    layer = {
        "phi_e": _mlp_specs(2 * dh + 1, dh, dh),
        "phi_x": _mlp_specs(dh, dh, 1),
        "phi_h": _mlp_specs(2 * dh, dh, dh),
    }
    return {
        "embed_in": P((cfg.d_feat, dh), ("embed", "ffn")),
        "layers": stack_layers(layer, cfg.n_layers),
        "head": _mlp_specs(dh, dh, cfg.n_classes if cfg.task == "node_class" else 1),
    }


class EGNN(_Tree):
    """The EGNN's parameters under the reference's names (``layers``
    stacked ``(L, ...)``), and its config."""

    def __init__(self, cfg: EGNNConfig, params: dict):
        super().__init__(params)
        self.cfg = cfg


def init(cfg: EGNNConfig, generator: torch.Generator) -> EGNN:
    """Parameters drawn from ``generator`` on its device."""
    return EGNN(cfg, init_params(param_specs(cfg), generator))


def abstract(cfg: EGNNConfig) -> dict:
    return abstract_params(param_specs(cfg))


def axes(cfg: EGNNConfig) -> dict:
    return axes_tree(param_specs(cfg))


def _messages(p, h, x, s, d):
    """One edge chunk's messages: (x_i - x_j) * phi_x(m_ij) (E, 3) and
    m_ij (E, dh), along edges (src=j, dst=i)."""
    hi, hj = h[d], h[s]
    diff = x[d] - x[s]
    d2 = torch.sum(diff * diff, dim=-1, keepdim=True)
    m = shard(_mlp(p["phi_e"], torch.cat([hi, hj, d2], dim=-1)), "edges", None)
    del hi, hj, d2          # two (chunk, 64) gathers freed before phi_x
    wx = _mlp(p["phi_x"], m)                                   # (E, 1)
    return diff * wx, m


def _edge_sums(p, h, x, src, dst, n_nodes: int):
    """The node sums of a layer's messages along edges src -> dst: (sum
    of (x_i - x_j) * phi_x(m_ij), in-degree, sum of m_ij), each
    (n_nodes, .)."""
    train = grad_on(h, x, *tree_leaves(p))
    num = x.new_zeros(n_nodes, x.shape[-1])
    cnt = x.new_zeros(n_nodes, 1)
    agg = h.new_zeros(n_nodes, p["phi_e"]["w1"].shape[-1])
    for lo in range(0, src.shape[0], EDGE_CHUNK):
        s, d = src[lo:lo + EDGE_CHUNK], dst[lo:lo + EDGE_CHUNK]
        cnt.index_add_(0, d, x.new_ones(d.shape[0], 1))
        if train:
            dx, m = checkpoint(_messages, p, h, x, s, d)
            num, agg = num.index_add(0, d, dx), agg.index_add(0, d, m)
        else:
            dx, m = _messages(p, h, x, s, d)
            num.index_add_(0, d, dx)
            agg.index_add_(0, d, m)
        del dx, m
    return num, cnt, agg


def _edge_sums_planned(p, h, x, src, dst, n_nodes: int):
    """``_edge_sums`` under a plan: each rank sums the messages of its own
    edges (``index_add_``: no ``DTensor`` rule), against whole node
    tables and weights, and the sums are all-reduced over the axes the
    edges split over (the reference's segment sum under ``psum``)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = shlib.active_mesh()
    leaves = tree_leaves(p)
    epl = shlib.placements(shlib.spec_for(("edges",), dims=tuple(src.shape)),
                           mesh)
    rep = (Replicate(),) * mesh.ndim
    part = tuple(Partial() if isinstance(q, Shard) else Replicate() for q in epl)

    def local(hl, xl, s, d, *ls):
        return _edge_sums(tree_unflatten(p, list(ls)), hl, xl, s, d, n_nodes)

    sums = shlib.run_local(
        local, (h, x, src, dst, *leaves), (rep, rep, epl, epl) + (rep,) * len(leaves),
        (list(part),) * 3, (part, part, epl, epl) + (part,) * len(leaves))
    return tuple(t.redistribute(mesh, rep) for t in sums)     # the all-reduce


def _layer(p, h, x, src, dst, n_nodes: int):
    """One EGNN layer. src/dst (E,) int32: message j->i along edge (src=j,
    dst=i), every index below ``n_nodes``."""
    sums = (_edge_sums_planned if shlib.plan_active() and shlib.is_dtensor(h)
            else _edge_sums)
    num, cnt, agg = sums(p, h, x, src, dst, n_nodes)
    x = x + num / torch.clamp(cnt, min=1.0)
    h = h + _mlp(p["phi_h"], torch.cat([h, agg], dim=-1))
    return h, x


def forward(model: EGNN, feats, coords, src, dst) -> torch.Tensor:
    """feats (N, d_feat), coords (N, 3), edges (E,). Returns node embeddings."""
    cfg, params = model.cfg, model.tree()
    n = feats.shape[0]
    h = matmul(feats.to(cfg.dtype), params["embed_in"].to(cfg.dtype))
    h = shard(h, "nodes", None)
    x = coords.to(cfg.dtype)
    train = grad_on(h, *tree_leaves(params["layers"]))
    for li in range(cfg.n_layers):
        lp = tree_map(lambda t: t[li], params["layers"])
        if train:       # the reference's scan body under jax.checkpoint
            h, x = checkpoint(_layer, lp, h, x, src, dst, n)
        else:
            h, x = _layer(lp, h, x, src, dst, n)
    return h


def node_class_loss(model: EGNN, batch: dict):
    """batch: feats, coords, src, dst, labels (N,), label_mask (N,)."""
    h = forward(model, batch["feats"], batch["coords"], batch["src"], batch["dst"])
    logits = _mlp(model.tree()["head"], h).to(torch.float32)
    lz = torch.logsumexp(logits, dim=-1)
    gold = pick_last(logits, batch["labels"].long())
    mask = batch["label_mask"].to(torch.float32)
    loss = torch.sum((lz - gold) * mask) / torch.clamp(mask.sum(), min=1.0)
    return loss, {"ce": loss}


def graph_reg_loss(model: EGNN, batch: dict):
    """Batched small graphs: graph_id (N,) segments, targets (G,)."""
    h = forward(model, batch["feats"], batch["coords"], batch["src"], batch["dst"])
    g = int(batch["targets"].shape[0])
    pool = lambda hl, gid: hl.new_zeros(g, hl.shape[-1]).index_add_(0, gid, hl)
    if shlib.plan_active() and shlib.is_dtensor(h):
        from torch.distributed.tensor import Replicate
        rep = (Replicate(),) * shlib.active_mesh().ndim
        pooled = shlib.run_local(pool, (h, batch["graph_id"]), (rep, rep),
                                 list(rep))
    else:
        pooled = pool(h, batch["graph_id"])
    pred = _mlp(model.tree()["head"], pooled)[:, 0].to(torch.float32)
    loss = torch.mean((pred - batch["targets"].to(torch.float32)) ** 2)
    return loss, {"mse": loss}


def loss_fn(model: EGNN, batch: dict):
    if model.cfg.task == "graph_reg":
        return graph_reg_loss(model, batch)
    return node_class_loss(model, batch)
