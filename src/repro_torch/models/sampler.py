"""Host-side CSR neighbor sampler for sampled-subgraph GNN training
(GraphSAGE-style fanout, used by the egnn `minibatch_lg` shape); the
port's copy of the JAX package's ``models/sampler.py``, host numpy as
there: with the same generator it gives bitwise the same arrays.

Produces fixed-size padded subgraphs (static shapes for jit): for a seed
batch B and fanouts (f1, f2), layer-0 nodes = B, layer-1 <= B*f1, layer-2 <=
B*f1*f2; edges <= B*f1 + B*f1*f2.  Padding uses a sentinel node whose
features are zero and which receives no loss.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray            # (N+1,) int64
    indices: np.ndarray           # (E,) int32 — sorted per row (d-gap friendly)
    n_nodes: int

    @staticmethod
    def random(n_nodes: int, n_edges: int, seed: int = 0) -> "CSRGraph":
        rng = np.random.default_rng(seed)
        src = rng.integers(0, n_nodes, n_edges)
        dst = rng.integers(0, n_nodes, n_edges)
        order = np.lexsort((dst, src))
        src, dst = src[order], dst[order]
        indptr = np.zeros(n_nodes + 1, np.int64)
        np.add.at(indptr, src + 1, 1)
        indptr = np.cumsum(indptr)
        return CSRGraph(indptr, dst.astype(np.int32), n_nodes)


def sample_subgraph(g: CSRGraph, seeds: np.ndarray, fanouts: tuple,
                    rng: np.random.Generator):
    """Returns dict of padded arrays: nodes (M,), src, dst (E_max,) (indices
    into the node list), valid edge mask, plus n_seed."""
    layers = [np.asarray(seeds, np.int64)]
    edges = []
    for f in fanouts:
        frontier = layers[-1]
        deg = g.indptr[frontier + 1] - g.indptr[frontier]
        # sample up to f neighbors per frontier node (with replacement when deg>0)
        has = deg > 0
        offs = rng.integers(0, np.maximum(deg, 1)[:, None], (len(frontier), f))
        nbrs = g.indices[(g.indptr[frontier, None] + offs).astype(np.int64)]
        nbrs = np.where(has[:, None], nbrs, -1)
        src = nbrs.reshape(-1)
        dst = np.repeat(np.arange(len(frontier)), f)  # local index into frontier
        edges.append((layers[-1], src, dst))
        layers.append(src[src >= 0])
    # build node list: unique of all layers
    all_nodes = np.concatenate([l for l in layers])
    all_nodes = all_nodes[all_nodes >= 0]
    uniq, inv = np.unique(all_nodes, return_inverse=True)
    remap = {int(n): i for i, n in enumerate(uniq)}
    max_edges = sum(len(l) * f for l, f in zip(layers[:-1], fanouts))
    src_out = np.full(max_edges, len(uniq), np.int32)   # sentinel
    dst_out = np.full(max_edges, len(uniq), np.int32)
    k = 0
    for (frontier, src, dst) in edges:
        ok = src >= 0
        s = np.asarray([remap[int(x)] for x in src[ok]], np.int32)
        d = np.asarray([remap[int(frontier[j])] for j in dst[ok]], np.int32)
        src_out[k:k + len(s)] = s
        dst_out[k:k + len(d)] = d
        k += len(s)
    return {
        "nodes": uniq.astype(np.int64),
        "src": src_out, "dst": dst_out,
        "edge_valid": (src_out < len(uniq)),
        "n_seed": len(seeds),
    }
