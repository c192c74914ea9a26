"""egnn [arXiv:2102.09844]: 4 layers, d_hidden=64, E(n)-equivariant.

Four graph regimes (kernel_taxonomy §GNN): full-batch small (cora-like),
sampled-subgraph training (reddit-like, real CSR fanout sampler), full-batch
large (ogb-products-like), and batched small graphs (molecule regression).
Message passing is a scatter-sum (``index_add_``) over an edge index; edge arrays are padded to
multiples of 512 so they shard evenly over the production meshes; padding
edges point at a sentinel node."""

import dataclasses

from ..models.egnn import EGNNConfig
from ..distributed import sharding as shlib
from .base import ArchSpec, ShapeCell, sds, I32, F32


def _pad512(n: int) -> int:
    return -(-n // 512) * 512


# fanout 15-10 over 1024 seed nodes
_MB_NODES = 1024 * (1 + 15) + 1024 * 15 * 10 + 1     # + sentinel
_MB_EDGES = 1024 * 15 + 1024 * 15 * 10

SHAPES = {
    "full_graph_sm": ShapeCell("full_graph_sm", "train", {
        "n_nodes": 2708, "n_edges": _pad512(10556), "d_feat": 1433,
        "n_classes": 7, "task": "node_class"}),
    "minibatch_lg": ShapeCell("minibatch_lg", "train", {
        "n_nodes": _pad512(_MB_NODES), "n_edges": _pad512(_MB_EDGES),
        "d_feat": 602, "n_classes": 41, "task": "node_class",
        "graph_nodes": 232965, "graph_edges": 114615892,
        "batch_nodes": 1024, "fanout": (15, 10)}),
    "ogb_products": ShapeCell("ogb_products", "train", {
        "n_nodes": _pad512(2449029), "n_edges": _pad512(61859140),
        "d_feat": 100, "n_classes": 47, "task": "node_class"}),
    "molecule": ShapeCell("molecule", "train", {
        "n_nodes": 30 * 128, "n_edges": 64 * 128, "d_feat": 11,
        "n_graphs": 128, "task": "graph_reg"}),
}


def make_config() -> EGNNConfig:
    return EGNNConfig(name="egnn", n_layers=4, d_hidden=64, d_feat=1433,
                      n_classes=47)


def make_smoke_config() -> EGNNConfig:
    return EGNNConfig(name="egnn-smoke", n_layers=2, d_hidden=16, d_feat=8,
                      n_classes=4)


def config_for_cell(cfg: EGNNConfig, cell: ShapeCell) -> EGNNConfig:
    return dataclasses.replace(
        cfg, d_feat=cell.dims["d_feat"],
        n_classes=cell.dims.get("n_classes", cfg.n_classes),
        task=cell.dims["task"])


def input_specs(cfg: EGNNConfig, cell: ShapeCell) -> dict:
    n, e = cell.dims["n_nodes"], cell.dims["n_edges"]
    specs = {
        "feats": sds((n, cell.dims["d_feat"]), F32),
        "coords": sds((n, 3), F32),
        "src": sds((e,), I32),
        "dst": sds((e,), I32),
    }
    if cell.dims["task"] == "node_class":
        specs["labels"] = sds((n,), I32)
        specs["label_mask"] = sds((n,), F32)
    else:
        specs["graph_id"] = sds((n,), I32)
        specs["targets"] = sds((cell.dims["n_graphs"],), F32)
    return specs


def batch_axes(cfg: EGNNConfig, cell: ShapeCell) -> dict:
    ax = {
        "feats": ("nodes", None), "coords": ("nodes", None),
        "src": ("edges",), "dst": ("edges",),
    }
    if cell.dims["task"] == "node_class":
        ax["labels"] = ("nodes",)
        ax["label_mask"] = ("nodes",)
    else:
        ax["graph_id"] = ("nodes",)
        ax["targets"] = ("batch",)
    return ax


def plan_for(cfg: EGNNConfig, cell: ShapeCell) -> shlib.Plan:
    return shlib.gnn_plan()


ARCH = ArchSpec(
    arch_id="egnn", family="gnn",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=SHAPES, plan_for=plan_for,
    input_specs=input_specs, batch_axes=batch_axes,
    config_for_cell=config_for_cell,
    notes="paper technique applies to the adjacency store (d-gapped CSR "
          "columns, Group-compressed in the data pipeline), not the model "
          "math (DESIGN.md §Arch-applicability)",
)
