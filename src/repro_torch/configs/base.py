"""Architecture registry: config + shapes + input specs (counterpart of the
JAX package's ``configs/base.py``).

Every ported architecture contributes an ``ArchSpec`` (one module per arch,
``ARCH`` symbol).  A *cell* is (arch x shape); ``input_specs`` returns
``device="meta"`` stand-ins (no allocation) for each input leaf.  The
sharding fields, ``plan_for`` and ``batch_axes``, are ``None`` until the
sharding slice ports the plans (ROADMAP.md, step A.13.5).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

I32 = torch.int32
F32 = torch.float32


def sds(shape, dtype) -> torch.Tensor:
    """A ``device="meta"`` tensor: shape and dtype, no memory."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str                      # train | prefill | decode | serve | retrieval
    dims: dict
    skip_reason: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                    # lm | gnn | recsys
    make_config: Callable[[], Any]
    make_smoke_config: Callable[[], Any]
    shapes: dict
    plan_for: Optional[Callable]   # None until the sharding slice
    input_specs: Callable[[Any, ShapeCell], dict]
    batch_axes: Optional[Callable]  # None until the sharding slice
    notes: str = ""
    # per-cell config adaptation (e.g. egnn d_feat/classes differ per graph)
    config_for_cell: Callable[[Any, ShapeCell], Any] = lambda cfg, cell: cfg


# --------------------------------------------------------------------------- #
# LM family shared machinery
# --------------------------------------------------------------------------- #

LM_SHAPES = {
    "train_4k": ShapeCell("train_4k", "train", {"seq": 4096, "batch": 256}),
    "prefill_32k": ShapeCell("prefill_32k", "prefill", {"seq": 32768, "batch": 32}),
    "decode_32k": ShapeCell("decode_32k", "decode", {"seq": 32768, "batch": 128}),
    "long_500k": ShapeCell("long_500k", "decode", {"seq": 524288, "batch": 1}),
}


def lm_shapes(long_ok: bool, skip_note: str = "") -> dict:
    out = dict(LM_SHAPES)
    if not long_ok:
        out["long_500k"] = dataclasses.replace(
            out["long_500k"],
            skip_reason=skip_note or "pure full attention: 500k decode has no "
            "sub-quadratic mechanism in the assigned config (DESIGN.md §5)")
    return out


def lm_input_specs(cfg, cell: ShapeCell) -> dict:
    from ..models import transformer as T
    b, s = cell.dims["batch"], cell.dims["seq"]
    if cell.kind == "train":
        return {"tokens": sds((b, s), I32), "labels": sds((b, s), I32)}
    if cell.kind == "prefill":
        return {"tokens": sds((b, s), I32)}
    # decode: one token against a cache of length s
    return {
        "token": sds((b,), I32),
        "pos": sds((), I32),
        "cache": T.cache_spec(cfg, b, s),
    }


# --------------------------------------------------------------------------- #
# step functions
# --------------------------------------------------------------------------- #


def lm_step_fn(cfg, cell: ShapeCell, opt_cfg=None):
    """(step(model, batch), is_train) of an LM cell: ``prefill`` and
    ``decode`` cells.  A ``train`` cell raises until training is ported."""
    from ..models import transformer as T
    if cell.kind == "train":
        raise NotImplementedError(
            f"{cell.name}: LM training (loss_fn, optim, runtime) is not ported "
            "yet (ROADMAP.md, step A.13.4)")
    if cell.kind == "prefill":
        def prefill(model, batch):
            return T.prefill(model, batch["tokens"])
        return prefill, False

    def decode(model, batch):
        return T.decode_step(model, batch["cache"], batch["token"], batch["pos"])
    return decode, False


def gnn_step_fn(cfg, cell: ShapeCell, opt_cfg=None):
    """Every EGNN cell is a ``train`` cell: its step (gradient and AdamW)
    waits for the training slice.  ``models.egnn`` serves the forward and
    the losses' values."""
    raise NotImplementedError(
        f"{cell.name}: EGNN has only train cells, and its train step (the "
        "gradient, AdamW, the trainer) is not ported yet (ROADMAP.md, step "
        "A.13.4)")


def recsys_step_fn(cfg, cell: ShapeCell, opt_cfg=None):
    """(step(model, batch), is_train) of a recsys cell: ``serve`` cells
    give probabilities, ``retrieval`` cells the top 100 (scores, ids).  A
    ``train`` cell raises until training is ported."""
    from ..models import recsys as R
    if cell.kind == "train":
        raise NotImplementedError(
            f"{cell.name}: recsys training (the gradient, AdamW, the "
            "trainer) is not ported yet (ROADMAP.md, step A.13.4)")
    if cell.kind == "retrieval":
        def retr(model, batch):
            return R.retrieval_topk(model, batch, k=100)
        return retr, False

    def serve_fn(model, batch):
        return R.serve(model, batch)
    return serve_fn, False


STEP_FNS = {"lm": lm_step_fn, "gnn": gnn_step_fn, "recsys": recsys_step_fn}


# --------------------------------------------------------------------------- #
# recsys shared shapes/specs
# --------------------------------------------------------------------------- #

RECSYS_SHAPES = {
    "train_batch": ShapeCell("train_batch", "train", {"batch": 65536}),
    "serve_p99": ShapeCell("serve_p99", "serve", {"batch": 512}),
    "serve_bulk": ShapeCell("serve_bulk", "serve", {"batch": 262144}),
    "retrieval_cand": ShapeCell("retrieval_cand", "retrieval",
                                {"batch": 1, "n_candidates": 1_000_000}),
}


def recsys_input_specs(cfg, cell: ShapeCell) -> dict:
    b = cell.dims["batch"]
    if cfg.model in ("dlrm", "wide_deep"):
        specs = {"sparse": sds((b, cfg.n_sparse), I32)}
        if cfg.model == "dlrm":
            specs["dense"] = sds((b, cfg.n_dense), F32)
    else:
        specs = {
            "target_item": sds((b,), I32), "target_cate": sds((b,), I32),
            "hist_items": sds((b, cfg.seq_len), I32),
            "hist_cates": sds((b, cfg.seq_len), I32),
            "hist_len": sds((b,), I32),
            "profile": sds((b, cfg.n_profile), I32),
        }
    if cell.kind == "train":
        specs["label"] = sds((b,), I32)
    if cell.kind == "retrieval":
        c = cell.dims["n_candidates"]
        specs["cand_items"] = sds((c,), I32)
        if cfg.model in ("din", "dien"):
            specs["cand_cates"] = sds((c,), I32)
    return specs
