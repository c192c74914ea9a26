"""RecSys models: DLRM (RM2), Wide&Deep, DIN, DIEN (counterpart of the JAX
package's ``models/recsys.py``).

Common substrate: large sparse embedding tables (``models/embedding.py``)
-> feature interaction (dot / concat / target attention / AUGRU) -> small
MLP.  Four shapes per arch: train_batch (BCE loss), serve_p99 /
serve_bulk (forward), retrieval_cand (1 query vs 10^6 candidates, batched
scoring + global top-k, never a loop over candidates).

Plain torch, as the reference is plain ``jnp``: the GRU's ``lax.scan``
becomes a Python loop over the history's steps.  Under a plan
(``recsys_plan``) the tables' rows split over "model" (the EP lookups of
``models/embedding.py``), the rows over the batch axes, the candidates of
retrieval over "model" (``shard``); the retrieval top-k (a sort: no
``DTensor`` rule) runs on each rank's local logits, then once on the
ranks' kept ones, gathered.

A card holds what the reference holds whole by taking rows (and
candidates) ``ROW_CHUNK`` at a time, under a plan ``ROW_CHUNK`` of each
rank's own rows (``sharding.row_slice``: a pass over every rank's rows
with no collective): a forward over more rows runs chunk by chunk, and
``retrieval_topk`` keeps each chunk's top k and merges them.  Under
autograd ``loss_fn`` takes ``TRAIN_ROW_CHUNK`` rows a pass, each
recomputed in backward (``torch.utils.checkpoint``): dien's two scans
save about 1 MB a row for backward.  Rows are independent, so each
chunked pass computes the reference's function (its values may differ in
the last bits, as matmul blocking and summation order change).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..distributed import sharding as shlib
from ..distributed.sharding import checkpoint, matmul, shard
from . import embedding as emb
from .specs import (P, _Tree, abstract_params, axes_tree, grad_on,
                    init_params,
                    load_reference_params,  # noqa: F401  (the model's)
                    tree_leaves)

# rows (serving) or candidates (retrieval) a forward pass takes at once:
# dien's two scans hold about 250 KB of activations a row, 16 GB at 2**16
ROW_CHUNK = 1 << 16
# rows of one recomputed pass of a train step (dien: about 16 GB saved)
TRAIN_ROW_CHUNK = 1 << 14


@dataclasses.dataclass(frozen=True)
class RecConfig:
    name: str
    model: str                        # dlrm | wide_deep | din | dien
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    table_rows: int = 1 << 20
    bot_mlp: tuple = (512, 256, 64)
    top_mlp: tuple = (512, 512, 256, 1)
    mlp: tuple = (200, 80)
    attn_mlp: tuple = (80, 40)
    seq_len: int = 100
    gru_dim: int = 108
    item_vocab: int = 1 << 20
    cate_vocab: int = 1 << 14
    n_profile: int = 4
    profile_vocab: int = 1 << 16
    dtype: Any = torch.float32

    @property
    def pair_dim(self) -> int:        # din/dien: item+cate concat
        return 2 * self.embed_dim


def _mlp_specs(d_in: int, dims: tuple) -> dict:
    out = {}
    cur = d_in
    for i, d in enumerate(dims):
        out[f"w{i}"] = P((cur, d), ("embed", "mlp" if d >= 256 else None))
        out[f"b{i}"] = P((d,), (None,), "zeros")
        cur = d
    return out


def _mlp(p, x, n: int, final_act: bool = False):
    for i in range(n):
        x = matmul(x, p[f"w{i}"].to(x.dtype)) + p[f"b{i}"].to(x.dtype)
        if i < n - 1 or final_act:
            x = torch.relu(x)
    return x


def _gru_specs(d_in: int, d_h: int) -> dict:
    return {
        "wx": P((d_in, 3 * d_h), ("embed", None)),
        "wh": P((d_h, 3 * d_h), ("embed", None)),
        "b": P((3 * d_h,), (None,), "zeros"),
    }


def _gru_cell(p, h, xt, a=None):
    """GRU step; a (B,1) in [0,1] scales the update gate (AUGRU, DIEN)."""
    d_h = h.shape[-1]
    gx = matmul(xt, p["wx"].to(xt.dtype))
    gh = matmul(h, p["wh"].to(h.dtype))
    zr_x, n_x = gx[..., : 2 * d_h], gx[..., 2 * d_h:]
    zr_h, n_h = gh[..., : 2 * d_h], gh[..., 2 * d_h:]
    zr = torch.sigmoid(zr_x + zr_h + p["b"][: 2 * d_h].to(h.dtype))
    z, r = zr[..., :d_h], zr[..., d_h:]
    n = torch.tanh(n_x + r * n_h + p["b"][2 * d_h:].to(h.dtype))
    if a is not None:
        z = a * z
    return (1.0 - z) * h + z * n


def _gru_scan(p, x, mask, a=None):
    """x (B, L, D) -> (final hidden (B, H), every step's (B, L, H)); masked
    positions keep the state.  The inputs are split into steps once and
    the states stacked at the end, as ``lax.scan`` slices and stacks: an
    index ``x[:, t]`` or a write into one (B, L, H) tensor a step would
    make backward fill a whole (B, L, .) gradient at every step."""
    b, l, _ = x.shape
    d_h = p["wh"].shape[0]
    h = x.new_zeros(b, d_h)
    xs = x.unbind(dim=1)
    ats = [None] * l if a is None else a[..., None].unbind(dim=1)
    hs = []
    for t in range(l):
        hn = _gru_cell(p, h, xs[t], ats[t])
        h = torch.where(mask[:, t, None], hn, h)
        hs.append(h)
    return h, torch.stack(hs, dim=1)


# --------------------------------------------------------------------------- #
# param specs and the module
# --------------------------------------------------------------------------- #


def param_specs(cfg: RecConfig) -> dict:
    d = cfg.embed_dim
    if cfg.model == "dlrm":
        n_feat = cfg.n_sparse + 1
        n_pairs = n_feat * (n_feat - 1) // 2
        return {
            "tables": P((cfg.n_sparse, cfg.table_rows, d), (None, "table_rows", None), "embed"),
            "bot": _mlp_specs(cfg.n_dense, cfg.bot_mlp),
            "top": _mlp_specs(cfg.bot_mlp[-1] + n_pairs, cfg.top_mlp),
        }
    if cfg.model == "wide_deep":
        return {
            "tables": P((cfg.n_sparse, cfg.table_rows, d), (None, "table_rows", None), "embed"),
            "wide": P((cfg.n_sparse, cfg.table_rows, 1), (None, "table_rows", None), "embed"),
            "deep": _mlp_specs(cfg.n_sparse * d, cfg.top_mlp),
        }
    # din / dien
    pair = cfg.pair_dim
    specs = {
        "item_table": P((cfg.item_vocab, d), ("table_rows", None), "embed"),
        "cate_table": P((cfg.cate_vocab, d), ("table_rows", None), "embed"),
        "profile_tables": P((cfg.n_profile, cfg.profile_vocab, d), (None, "table_rows", None), "embed"),
    }
    head_in = 3 * pair + cfg.n_profile * d
    if cfg.model == "din":
        specs["attn"] = _mlp_specs(4 * pair, cfg.attn_mlp + (1,))
        specs["head"] = _mlp_specs(head_in, cfg.mlp + (1,))
    else:  # dien
        specs["gru1"] = _gru_specs(pair, cfg.gru_dim)
        specs["augru"] = _gru_specs(cfg.gru_dim, cfg.gru_dim)
        specs["t_proj"] = P((pair, cfg.gru_dim), ("embed", None))
        specs["attn"] = _mlp_specs(2 * cfg.gru_dim, cfg.attn_mlp + (1,))
        specs["head"] = _mlp_specs(cfg.gru_dim + 2 * pair + cfg.n_profile * d, cfg.mlp + (1,))
    return specs


class RecModel(_Tree):
    """A recsys model's parameters under the reference's names, and its
    config.  Build one with :func:`init`, or around an existing parameter
    tree (``RecModel(cfg, model.tree())`` shares the tensors)."""

    def __init__(self, cfg: RecConfig, params: dict):
        super().__init__(params)
        self.cfg = cfg


def init(cfg: RecConfig, generator: torch.Generator) -> RecModel:
    """Parameters drawn from ``generator`` on its device."""
    return RecModel(cfg, init_params(param_specs(cfg), generator))


def abstract(cfg: RecConfig) -> dict:
    return abstract_params(param_specs(cfg))


def axes(cfg: RecConfig) -> dict:
    return axes_tree(param_specs(cfg))


# --------------------------------------------------------------------------- #
# forwards (over the parameter tree, as the reference's)
# --------------------------------------------------------------------------- #


def _dlrm_forward(params, batch, cfg: RecConfig):
    dense = batch["dense"].to(cfg.dtype)
    v = _mlp(params["bot"], dense, len(cfg.bot_mlp), final_act=True)      # (B, d)
    e = emb.lookup_stacked(params["tables"], batch["sparse"])             # (B, T, d)
    z = torch.cat([v[:, None, :], e.to(cfg.dtype)], dim=1)               # (B, T+1, d)
    zz = torch.einsum("bid,bjd->bij", z, z)
    n = z.shape[1]
    # row-major pairs (i < j), the order of jnp.triu_indices(n, k=1)
    iu, ju = torch.triu_indices(n, n, offset=1, device=z.device)
    pairs = zz[:, iu, ju]                                                 # (B, n(n-1)/2)
    top_in = torch.cat([v, pairs], dim=-1)
    return _mlp(params["top"], top_in, len(cfg.top_mlp))[:, 0]


def _wide_deep_forward(params, batch, cfg: RecConfig):
    ids = batch["sparse"]
    e = emb.lookup_stacked(params["tables"], ids).to(cfg.dtype)          # (B, T, d)
    wide = emb.lookup_stacked(params["wide"], ids).to(cfg.dtype)         # (B, T, 1)
    deep_in = e.reshape(e.shape[0], -1)
    deep = _mlp(params["deep"], deep_in, len(cfg.top_mlp))[:, 0]
    return deep + wide.sum(dim=(1, 2))


def _din_user_vec(params, hist, target, mask, cfg: RecConfig):
    """Target attention (DIN): hist (B,L,P), target (B,P) -> (B,P)."""
    t = target[:, None, :].expand(hist.shape)
    feat = torch.cat([hist, t, hist - t, hist * t], dim=-1)
    w = _mlp(params["attn"], feat, len(cfg.attn_mlp) + 1)[..., 0]        # (B, L)
    w = w * mask.to(w.dtype)
    return torch.einsum("bl,blp->bp", w, hist)


def _hist_embed(params, batch, cfg: RecConfig):
    hi = emb.lookup(params["item_table"], batch["hist_items"]).to(cfg.dtype)
    hc = emb.lookup(params["cate_table"], batch["hist_cates"]).to(cfg.dtype)
    hist = torch.cat([hi, hc], dim=-1)                                    # (B, L, P)
    ti = emb.lookup(params["item_table"], batch["target_item"]).to(cfg.dtype)
    tc = emb.lookup(params["cate_table"], batch["target_cate"]).to(cfg.dtype)
    target = torch.cat([ti, tc], dim=-1)                                  # (B, P)
    prof = emb.lookup_stacked(params["profile_tables"], batch["profile"]).to(cfg.dtype)
    prof = prof.reshape(prof.shape[0], -1)                                # (B, n_profile*d)
    steps = torch.arange(batch["hist_items"].shape[1], device=hist.device)
    mask = steps[None, :] < batch["hist_len"][:, None]
    return hist, target, prof, mask


def _din_forward(params, batch, cfg: RecConfig):
    hist, target, prof, mask = _hist_embed(params, batch, cfg)
    user = _din_user_vec(params, hist, target, mask, cfg)
    x = torch.cat([user, target, user * target, prof], dim=-1)
    return _mlp(params["head"], x, len(cfg.mlp) + 1)[:, 0]


def _dien_forward(params, batch, cfg: RecConfig):
    hist, target, prof, mask = _hist_embed(params, batch, cfg)
    _, hs = _gru_scan(params["gru1"], hist, mask)                         # (B, L, H)
    tproj = matmul(target, params["t_proj"].to(target.dtype))[:, None, :]  # (B,1,H)
    feat = torch.cat([hs, tproj.expand(hs.shape)], dim=-1)
    scores = _mlp(params["attn"], feat, len(cfg.attn_mlp) + 1)[..., 0]
    # -1e30, not -inf: a history of length 0 gives weights 0, not NaN
    scores = torch.where(mask, scores, -1e30)
    a = torch.softmax(scores, dim=-1) * mask.to(scores.dtype)             # (B, L)
    hfinal, _ = _gru_scan(params["augru"], hs, mask, a=a)
    x = torch.cat([hfinal, target, target, prof], dim=-1)
    return _mlp(params["head"], x, len(cfg.mlp) + 1)[:, 0]


FORWARDS = {
    "dlrm": _dlrm_forward,
    "wide_deep": _wide_deep_forward,
    "din": _din_forward,
    "dien": _dien_forward,
}


# --------------------------------------------------------------------------- #
# entry points
# --------------------------------------------------------------------------- #


def forward(model: RecModel, batch: dict) -> torch.Tensor:
    """Logits (B,) of a batch whose every leaf has B rows, ``ROW_CHUNK``
    rows (under a plan: of each rank's own rows) at a time."""
    cfg, params = model.cfg, model.tree()
    fn = FORWARDS[cfg.model]
    b = shlib.local_rows(batch)
    if b <= ROW_CHUNK:
        return shard(fn(params, batch, cfg), "batch")
    return shlib.cat_rows(
        [shard(fn(params, shlib.row_slice(batch, i, i + ROW_CHUNK), cfg), "batch")
         for i in range(0, b, ROW_CHUNK)], like=next(iter(batch.values())))


def _bce(logit: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """The rows' BCE-with-logits terms (B,), in fp32."""
    logit, y = logit.to(torch.float32), label.to(torch.float32)
    return (torch.clamp(logit, min=0) - logit * y
            + torch.log1p(torch.exp(-torch.abs(logit))))


def loss_fn(model: RecModel, batch: dict):
    """The mean BCE loss; under autograd ``TRAIN_ROW_CHUNK`` rows (under
    a plan: of each rank's own rows) a recomputed pass."""
    cfg, params = model.cfg, model.tree()
    if not grad_on(*tree_leaves(params)):
        loss = torch.mean(_bce(forward(model, batch), batch["label"]))
        return loss, {"bce": loss}
    fn = FORWARDS[cfg.model]

    def chunk_sum(c):
        return _bce(shard(fn(params, c, cfg), "batch"), c["label"]).sum()

    b = batch["label"].shape[0]
    loss = sum(checkpoint(chunk_sum, shlib.row_slice(batch, i, i + TRAIN_ROW_CHUNK))
               for i in range(0, shlib.local_rows(batch), TRAIN_ROW_CHUNK)) / b
    return loss, {"bce": loss}


def serve(model: RecModel, batch: dict) -> torch.Tensor:
    return torch.sigmoid(forward(model, batch))


# --------------------------------------------------------------------------- #
# retrieval scoring: 1 query vs n_candidates, batched + global top-k
# --------------------------------------------------------------------------- #


def _candidate_batch(batch: dict, cfg: RecConfig, lo: int, hi: int) -> dict:
    """The query's row broadcast over candidates [lo, hi), each candidate
    in the target (din, dien) or the first sparse slot (dlrm, wide-deep)."""
    cand = batch["cand_items"][lo:hi]
    c = cand.shape[0]
    if cfg.model in ("din", "dien"):
        q = {kk: v.expand((c,) + v.shape[1:]) for kk, v in batch.items()
             if kk in ("hist_items", "hist_cates", "hist_len", "profile")}
        q["target_item"] = cand
        q["target_cate"] = batch["cand_cates"][lo:hi]
        return q
    sparse = torch.cat([cand[:, None].to(batch["sparse"].dtype),
                        batch["sparse"][:, 1:].expand(c, cfg.n_sparse - 1)],
                       dim=1)
    if cfg.model == "dlrm":
        return {"dense": batch["dense"].expand(c, cfg.n_dense), "sparse": sparse}
    return {"sparse": sparse}


def _candidate_chunks(model: RecModel, batch: dict, lo: int, hi: int):
    """Yields (offset, logits) of candidates [lo, hi), ``ROW_CHUNK`` at a
    time."""
    cfg, params = model.cfg, model.tree()
    fn = FORWARDS[cfg.model]
    for i in range(lo, hi, ROW_CHUNK):
        yield i, fn(params, _candidate_batch(batch, cfg, i, min(i + ROW_CHUNK, hi)), cfg)


def candidate_logits(model: RecModel, batch: dict, lo: int = 0,
                     hi: int | None = None) -> torch.Tensor:
    """The logits of candidates [lo, hi), in the chunks ``retrieval_topk``
    scores."""
    hi = batch["cand_items"].shape[0] if hi is None else hi
    return torch.cat([logit for _, logit in _candidate_chunks(model, batch, lo, hi)])


def _top(x: torch.Tensor, k: int):
    # lax.top_k breaks ties to the lower index; torch.topk promises no
    # order for ties, the top k of a stable descending sort does
    s, i = torch.sort(x, descending=True, stable=True)
    return s[:k], i[:k]


def retrieval_topk(model: RecModel, batch: dict, k: int = 100):
    """batch carries the single query context + candidate ids (C,); returns
    the top-k (scores, candidate ids), ties to the lower candidate index.

    Candidates are scored ``ROW_CHUNK`` at a time; each chunk keeps its top
    k, and one stable sort over the kept ones, in candidate order, gives
    the global top k in the reference's order.  Under a plan the
    candidates are split as a batch's rows (the layout the forward's
    lookups give them), each rank scores its own so
    (:func:`_planned_chunks`), and one more stable sort over the ranks'
    kept ones, gathered in rank (so candidate) order, gives the top k.
    """
    cand = batch["cand_items"]                                            # (C,)
    c = cand.shape[0]
    k = min(k, c)
    planned = shlib.plan_active() and shlib.is_dtensor(cand)
    if planned:
        mesh = cand.device_mesh
        rows = shlib.placements(shlib.spec_for(("batch",), dims=(c,)), mesh)
        batch = {kk: (shlib._as_dtensor(v, mesh).redistribute(mesh, rows)
                      if kk.startswith("cand_") else v)
                 for kk, v in batch.items()}
        cand = batch["cand_items"]
    kept_s, kept_i = [], []
    for lo, logit in (_planned_chunks(model, batch) if planned
                      else _candidate_chunks(model, batch, 0, c)):
        s, i = _top(logit, k)
        kept_s.append(s)
        kept_i.append(i + lo)
    scores, j = _top(torch.cat(kept_s), k)
    if not planned:
        return scores, cand[torch.cat(kept_i)[j]]
    from torch.distributed.tensor import DTensor, Replicate
    ids = cand.to_local()[torch.cat(kept_i)[j] - _rank_first(cand)]
    s_all, id_all = (DTensor.from_local(t, mesh, rows, run_check=False).full_tensor()
                     for t in (scores, ids))
    top, j = _top(s_all, k)
    rep = (Replicate(),) * mesh.ndim
    return tuple(DTensor.from_local(t, mesh, rep, run_check=False)
                 for t in (top, id_all[j]))


def _rank_first(x) -> int:
    """The global row of this rank's first local row of ``x`` (rows split
    evenly over the mesh axes that shard them, in mesh order)."""
    from torch.distributed.tensor import Shard
    mesh, coord = x.device_mesh, x.device_mesh.get_coordinate()
    off = 0
    for m, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == 0:
            off = off * mesh.size(m) + coord[m]
    return off * x.to_local().shape[0]


def _planned_chunks(model: RecModel, batch: dict):
    """Yields (first candidate, local logits) of this rank's candidates
    under a plan (``cand_*`` split on their rows only), ``ROW_CHUNK`` of
    its own candidates a pass: each pass is one sharded forward over every
    rank's pass (the query's row broadcast over them, laid out as the
    candidates), so a rank holds one pass's activations at a time."""
    from torch.distributed.tensor import DTensor
    cfg, params = model.cfg, model.tree()
    fn = FORWARDS[cfg.model]
    cand = batch["cand_items"]
    mesh, pl = cand.device_mesh, tuple(cand.placements)
    local = {kk: (v.to_local() if kk.startswith("cand_") else
                  v.full_tensor() if shlib.is_dtensor(v) else v)
             for kk, v in batch.items()}
    first, n = _rank_first(cand), local["cand_items"].shape[0]
    for i in range(0, n, ROW_CHUNK):
        sub = {kk: DTensor.from_local(v, mesh, pl, run_check=False) for kk, v in
               _candidate_batch(local, cfg, i, min(i + ROW_CHUNK, n)).items()}
        logit = shard(fn(params, sub, cfg), "candidates")
        yield first + i, logit.redistribute(mesh, pl).to_local()
