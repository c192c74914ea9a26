"""Embedding tables and EmbeddingBag (counterpart of the JAX package's
``models/embedding.py``), the plain path.

The reference has two paths per op: the plain one (``jnp.take``) whenever
no sharding plan is active, and an expert-parallel one (table rows sharded
over "model", a ``shard_map`` mask-gather-psum).  The port has no plans
yet, so it has the plain path only; the EP path waits for the sharding
slice (ROADMAP.md, step A.13.5).

Ids must lie inside the table.  The reference's ``jnp.take`` gives NaN
rows for an id at or past the end and wraps ``-1``; torch indexing wraps
``-1`` and raises past the end (on the card, a device-side assert).
"""

from __future__ import annotations

import torch


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Single table (R, D), ids (...,) -> (..., D)."""
    return table[ids]


def lookup_stacked(tables: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Stacked tables (T, R, D), ids (..., T) -> (..., T, D): out[..., t, :] =
    tables[t, ids[..., t], :], every table in one gather."""
    t = torch.arange(tables.shape[0], device=tables.device)
    return tables[t, ids]


def bag_sum(table: torch.Tensor, ids: torch.Tensor, valid=None) -> torch.Tensor:
    """EmbeddingBag(sum): ids (..., L) -> (..., D); valid (..., L) bool."""
    v = lookup(table, ids)
    if valid is not None:
        v = v * valid[..., None].to(v.dtype)
    return v.sum(dim=-2)


def bag_mean(table: torch.Tensor, ids: torch.Tensor, valid=None) -> torch.Tensor:
    v = lookup(table, ids)
    if valid is None:
        return v.mean(dim=-2)
    m = valid[..., None].to(v.dtype)
    return (v * m).sum(dim=-2) / torch.clamp(m.sum(dim=-2), min=1.0)
