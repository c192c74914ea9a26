"""Concrete batches of the recsys and GNN cells, drawn with numpy from an
explicit ``np.random.Generator`` and put on ``device``.

  * :func:`smoke_batch`: the small batch of a smoke config (an LM train
    cell's tokens and labels too).  It draws the same arrays, in the same
    order, as the reference's ``tests/test_arch_smoke.py::_smoke_batch``
    (which the reference's launcher imports and which draws from a
    module-global generator).
  * :func:`cell_batch`: the same draws at a cell's own full size (its
    ``dims``): ids uniform in each table, floats uniform in [0, 1).
  * :func:`subgraph_batch`: a sampled subgraph (``models.sampler``) padded
    to its cell's node and edge counts.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(a, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def _recsys_batch(cfg, kind: str, b: int, n_cand: int, rng, device) -> dict:
    i32 = torch.int32
    if cfg.model in ("dlrm", "wide_deep"):
        batch = {"sparse": _t(rng.integers(0, cfg.table_rows, (b, cfg.n_sparse)), i32, device)}
        if cfg.model == "dlrm":
            batch["dense"] = _t(rng.random((b, cfg.n_dense)), torch.float32, device)
    else:
        batch = {
            "target_item": _t(rng.integers(0, cfg.item_vocab, b), i32, device),
            "target_cate": _t(rng.integers(0, cfg.cate_vocab, b), i32, device),
            "hist_items": _t(rng.integers(0, cfg.item_vocab, (b, cfg.seq_len)), i32, device),
            "hist_cates": _t(rng.integers(0, cfg.cate_vocab, (b, cfg.seq_len)), i32, device),
            "hist_len": _t(rng.integers(1, cfg.seq_len, b), i32, device),
            "profile": _t(rng.integers(0, cfg.profile_vocab, (b, cfg.n_profile)), i32, device),
        }
    if kind == "train":
        batch["label"] = _t(rng.integers(0, 2, b), i32, device)
    if kind == "retrieval":
        din = cfg.model in ("din", "dien")
        batch["cand_items"] = _t(rng.integers(0, cfg.item_vocab if din else cfg.table_rows, n_cand), i32, device)
        if din:
            batch["cand_cates"] = _t(rng.integers(0, cfg.cate_vocab, n_cand), i32, device)
    return batch


def _gnn_batch(cfg, n: int, e: int, n_graphs: int, rng, device) -> dict:
    f32, i32 = torch.float32, torch.int32
    batch = {
        "feats": _t(rng.random((n, cfg.d_feat)), f32, device),
        "coords": _t(rng.random((n, 3)), f32, device),
        "src": _t(rng.integers(0, n, e), i32, device),
        "dst": _t(rng.integers(0, n, e), i32, device),
    }
    if cfg.task == "node_class":
        batch["labels"] = _t(rng.integers(0, cfg.n_classes, n), i32, device)
        batch["label_mask"] = torch.ones(n, dtype=f32, device=device)
    else:
        batch["graph_id"] = _t(rng.integers(0, n_graphs, n), i32, device)
        batch["targets"] = _t(rng.random(n_graphs), f32, device)
    return batch


def smoke_batch(spec, cfg, cell, rng: np.random.Generator, device) -> dict:
    """The reference's ``_smoke_batch`` for a recsys or GNN cell, or an LM
    train cell: batch 8 (64 candidates), a graph of 40 nodes and 120 edges
    (4 graphs), or 2 sequences of 32 tokens with their next tokens."""
    if spec.family == "recsys":
        return _recsys_batch(cfg, cell.kind, 8, 64, rng, device)
    if spec.family == "gnn":
        return _gnn_batch(cfg, 40, 120, 4, rng, device)
    if cell.kind == "train":
        t = rng.integers(0, cfg.vocab, (2, 33))
        return {"tokens": _t(t[:, :-1], torch.int32, device),
                "labels": _t(t[:, 1:], torch.int32, device)}
    raise ValueError(f"{spec.arch_id}: smoke_batch builds recsys and gnn "
                     f"batches and LM train batches, not {cell.kind}")


def cell_batch(spec, cfg, cell, rng: np.random.Generator, device) -> dict:
    """A cell's batch at its full size, drawn as :func:`smoke_batch` draws:
    ``dims["batch"]`` rows (a retrieval cell: one query row and
    ``n_candidates`` candidates), or ``n_nodes`` nodes and ``n_edges``
    uniform edges (``n_graphs`` graphs)."""
    d = cell.dims
    if spec.family == "recsys":
        return _recsys_batch(cfg, cell.kind, d["batch"], d.get("n_candidates", 0), rng, device)
    if spec.family == "gnn":
        return _gnn_batch(cfg, d["n_nodes"], d["n_edges"], d.get("n_graphs", 0), rng, device)
    raise ValueError(f"{spec.arch_id}: cell_batch builds recsys and gnn "
                     f"batches, not {spec.family}")


def subgraph_batch(sub: dict, seeds: np.ndarray, cfg, cell,
                   rng: np.random.Generator, device) -> dict:
    """A node-classification batch over ``sample_subgraph``'s output, padded
    with zero rows to the cell's ``n_nodes`` and with sentinel edges to its
    ``n_edges``.  Features, coordinates and labels are drawn for the
    subgraph's nodes; the loss is on the seeds only."""
    n_pad, e_pad = cell.dims["n_nodes"], cell.dims["n_edges"]
    m, e = len(sub["nodes"]), len(sub["src"])
    if m >= n_pad or e > e_pad:
        raise ValueError(f"{cell.name}: a subgraph of {m} nodes and {e} "
                         f"edges does not fit {n_pad} nodes and {e_pad} edges")
    feats = np.zeros((n_pad, cfg.d_feat), np.float32)
    feats[:m] = rng.random((m, cfg.d_feat))
    coords = np.zeros((n_pad, 3), np.float32)
    coords[:m] = rng.random((m, 3))
    src = np.full(e_pad, m, np.int32)       # the sampler's sentinel node
    dst = np.full(e_pad, m, np.int32)
    src[:e], dst[:e] = sub["src"], sub["dst"]
    labels = np.zeros(n_pad, np.int32)
    labels[:m] = rng.integers(0, cfg.n_classes, m)
    mask = np.zeros(n_pad, np.float32)
    mask[:m] = np.isin(sub["nodes"], seeds)
    f32, i32 = torch.float32, torch.int32
    return {"feats": _t(feats, f32, device), "coords": _t(coords, f32, device),
            "src": _t(src, i32, device), "dst": _t(dst, i32, device),
            "labels": _t(labels, i32, device),
            "label_mask": _t(mask, f32, device)}
