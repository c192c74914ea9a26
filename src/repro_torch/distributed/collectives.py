"""The top-k merge of doc-range sharded serving: the serving path's one
collective per ranked batch.

Counterpart of ``merge_topk_stats`` in the JAX package's
``distributed/collectives.py``.  There the merge is an ``all_gather`` + max
under ``shard_map`` when a mesh places one shard per device, all in one
process; here it is the same in one process: each shard's two vectors are
copied to the first shard's device, stacked, and the max taken there.  No
``torch.distributed`` process group is involved (one server process drives
every shard, as in the reference).  The compressed gradient all-reduce of
that module is training code and waits for ``ROADMAP.md`` step A.13.
"""

from __future__ import annotations

import numpy as np
import torch


def merge_topk_stats(theta_parts, count_parts, mesh=None):
    """Merge per-shard (k-th sum, candidate count) statistics into the
    global ranked threshold.

    theta_parts / count_parts: per-shard (nq,) int32 tensors (or arrays).
    Returns ``(theta_merged (nq,) int64 np, counts (S, nq) np, wire_bytes)``
    with ``theta_merged[q]`` the max over shards (a sound lower bound on the
    global k-th sum, see ``kernels/topk.topk_stats``) and ``wire_bytes =
    S * nq * 8`` (a 32-bit theta and a 32-bit count per shard and query).

    ``mesh``: a list of one torch device per shard (``launch.mesh
    .serving_mesh``).  When it places the ``S > 1`` shards, the vectors are
    gathered onto the first shard's device and reduced there; otherwise
    (logical shards on one device) they are stacked on the host, which
    moves the same bytes."""
    s = len(theta_parts)
    nq = int(theta_parts[0].shape[0])
    wire_bytes = s * nq * 4 * 2                 # 32-bit theta + 32-bit count
    if mesh is not None and len(mesh) == s and s > 1:
        root = torch.device(mesh[0])
        t = torch.stack([torch.as_tensor(p).to(root)
                         for p in theta_parts])
        c = torch.stack([torch.as_tensor(p).to(root)
                         for p in count_parts])
        theta = t.amax(dim=0)
        return (theta.cpu().numpy().astype(np.int64), c.cpu().numpy(),
                wire_bytes)
    thetas = np.stack([_host(p) for p in theta_parts])
    counts = np.stack([_host(p) for p in count_parts])
    return thetas.max(axis=0).astype(np.int64), counts, wire_bytes


def _host(p) -> np.ndarray:
    return p.cpu().numpy() if isinstance(p, torch.Tensor) else np.asarray(p)
