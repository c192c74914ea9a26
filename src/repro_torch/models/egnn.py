"""E(n)-Equivariant GNN (EGNN, Satorras et al. 2021, arXiv:2102.09844;
counterpart of the JAX package's ``models/egnn.py``): the forward and the
two losses' values (their gradients wait for ROADMAP.md step A.13.4).

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
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from .specs import (P, _Tree, abstract_params, axes_tree, init_params,
                    load_reference_params,  # noqa: F401  (the model's)
                    stack_layers, tree_map)

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
    h = F.silu(x @ p["w0"].to(x.dtype) + p["b0"].to(x.dtype))
    return h @ p["w1"].to(x.dtype) + p["b1"].to(x.dtype)


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


def _layer(p, h, x, src, dst, n_nodes: int):
    """One EGNN layer. src/dst (E,) int32: message j->i along edge (src=j,
    dst=i), every index below ``n_nodes``."""
    num = x.new_zeros(n_nodes, x.shape[-1])
    cnt = x.new_zeros(n_nodes, 1)
    agg = h.new_zeros(n_nodes, p["phi_e"]["w1"].shape[-1])
    for lo in range(0, src.shape[0], EDGE_CHUNK):
        s, d = src[lo:lo + EDGE_CHUNK], dst[lo:lo + EDGE_CHUNK]
        hi, hj = h[d], h[s]
        diff = x[d] - x[s]
        d2 = torch.sum(diff * diff, dim=-1, keepdim=True)
        m = _mlp(p["phi_e"], torch.cat([hi, hj, d2], dim=-1))
        del hi, hj, d2          # two (chunk, 64) gathers freed before phi_x
        wx = _mlp(p["phi_x"], m)                                   # (E, 1)
        num.index_add_(0, d, diff * wx)
        cnt.index_add_(0, d, x.new_ones(d.shape[0], 1))
        agg.index_add_(0, d, m)
    x = x + num / torch.clamp(cnt, min=1.0)
    h = h + _mlp(p["phi_h"], torch.cat([h, agg], dim=-1))
    return h, x


def forward(model: EGNN, feats, coords, src, dst) -> torch.Tensor:
    """feats (N, d_feat), coords (N, 3), edges (E,). Returns node embeddings."""
    cfg, params = model.cfg, model.tree()
    n = feats.shape[0]
    h = feats.to(cfg.dtype) @ params["embed_in"].to(cfg.dtype)
    x = coords.to(cfg.dtype)
    # the reference scans the stacked layers under jax.checkpoint, which
    # changes nothing in a forward
    for li in range(cfg.n_layers):
        lp = tree_map(lambda t: t[li], params["layers"])
        h, x = _layer(lp, h, x, src, dst, n)
    return h


def node_class_loss(model: EGNN, batch: dict):
    """batch: feats, coords, src, dst, labels (N,), label_mask (N,)."""
    h = forward(model, batch["feats"], batch["coords"], batch["src"], batch["dst"])
    logits = _mlp(model.tree()["head"], h).to(torch.float32)
    lz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, batch["labels"][:, None].long())[:, 0]
    mask = batch["label_mask"].to(torch.float32)
    loss = torch.sum((lz - gold) * mask) / torch.clamp(mask.sum(), min=1.0)
    return loss, {"ce": loss}


def graph_reg_loss(model: EGNN, batch: dict):
    """Batched small graphs: graph_id (N,) segments, targets (G,)."""
    h = forward(model, batch["feats"], batch["coords"], batch["src"], batch["dst"])
    g = int(batch["targets"].shape[0])
    pooled = h.new_zeros(g, h.shape[-1]).index_add_(0, batch["graph_id"], h)
    pred = _mlp(model.tree()["head"], pooled)[:, 0].to(torch.float32)
    loss = torch.mean((pred - batch["targets"].to(torch.float32)) ** 2)
    return loss, {"mse": loss}


def loss_fn(model: EGNN, batch: dict):
    if model.cfg.task == "graph_reg":
        return graph_reg_loss(model, batch)
    return node_class_loss(model, batch)
