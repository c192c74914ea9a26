"""Sharded embedding tables + EmbeddingBag (counterpart of the JAX
package's ``models/embedding.py``).  Two paths per op:

  * plain path (no plan, or rows that do not split): one gather.
  * EP path (table rows sharded over "model" by the active plan): each
    "model" rank gathers only the rows it owns, zeros the rest, and the
    ranks' results are summed (``all_reduce`` over "model": the
    reference's ``shard_map`` mask-gather-``psum``).  Wire bytes per
    lookup: batch*dim summed instead of all-gathering the table.  The
    gather runs on each rank's local shard (``sharding.run_local``): a
    gather of a row-sharded table has no ``DTensor`` rule that keeps the
    table where it is.

Ids must lie inside the table.  The reference's ``jnp.take`` gives NaN
rows for an id at or past the end and wraps ``-1``; torch indexing wraps
``-1`` and raises past the end (on the card, a device-side assert).
"""

from __future__ import annotations

import torch

from ..distributed import sharding as shlib


def _ep_ctx(table_rows: int, *tensors):
    """Returns (mesh, the row axis's mesh dim) when the EP path applies."""
    ctx = shlib._active()
    if ctx is None or not any(shlib.is_dtensor(t) for t in tensors):
        return None
    mesh, plan = ctx
    shape = shlib.mesh_shape(mesh)
    axes = tuple(a for a in (plan.axes_of("table_rows") or ()) if a in shape)
    if not axes or table_rows % shlib._mesh_size(shape, axes) != 0:
        return None
    return mesh, list(shape).index(axes[0])


def _ids_placements(ids, mesh) -> tuple:
    """The ids' rows over the plan's batch axes (where they split)."""
    return shlib.placements(shlib.spec_for(
        ("batch",) + (None,) * (ids.ndim - 1), dims=tuple(ids.shape)), mesh)


def _take_stacked(tables: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    t = torch.arange(tables.shape[0], device=tables.device)
    return tables[t, ids]


def _ep_lookup(table, ids, row_dim: int, ep) -> torch.Tensor:
    """The EP form of a lookup: ``table``'s ``row_dim`` split over the
    "model" axis, each rank's rows gathered where ``ids`` fall in them."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, raxis = ep
    ids_spec = _ids_placements(ids, mesh)
    tbl_spec = tuple(Shard(row_dim) if m == raxis else Replicate()
                     for m in range(mesh.ndim))
    # a pending sum over the axes the ids' rows split over
    tbl_grad = tuple(Partial() if isinstance(p, Shard) else q
                     for p, q in zip(ids_spec, tbl_spec))
    out_spec = [Partial() if m == raxis else p for m, p in enumerate(ids_spec)]
    me = mesh.get_coordinate()[raxis]
    gather = (lambda t, i: t[i]) if row_dim == 0 else _take_stacked

    def local(tbl, ids_l):
        r = tbl.shape[row_dim]
        loc = ids_l - me * r
        ok = (loc >= 0) & (loc < r)
        v = gather(tbl, loc.clamp(0, r - 1))
        return torch.where(ok[..., None], v, torch.zeros((), dtype=v.dtype,
                                                         device=v.device))

    out = shlib.run_local(local, (table, shlib._as_dtensor(ids, mesh)),
                          (tbl_spec, ids_spec), out_spec, (tbl_grad, ids_spec))
    return out.redistribute(mesh, tuple(ids_spec))          # the psum


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Single table (R, D), ids (...,) -> (..., D)."""
    ep = _ep_ctx(table.shape[0], table, ids)
    if ep is None:
        return shlib.take_rows(table, ids)
    return _ep_lookup(table, ids, 0, ep)


def lookup_stacked(tables: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Stacked tables (T, R, D), ids (..., T) -> (..., T, D): out[..., t, :] =
    tables[t, ids[..., t], :], every table in one gather."""
    ep = _ep_ctx(tables.shape[1], tables, ids)
    if ep is None:
        return shlib.take_rows(tables, ids, _take_stacked)
    return _ep_lookup(tables, ids, 1, ep)


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
