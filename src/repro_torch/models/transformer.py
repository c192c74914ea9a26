"""Decoder-only LM, the dense architectures (counterpart of the JAX
package's ``models/transformer.py``):

  * GQA dense (starcoder2-3b/7b, smollm-135m), optionally with a sliding
    window (SWA ring cache);
  * MLA attention (the latent decode cache);
  * mixture-of-experts layers with shared experts.

Two entry points for serving: ``prefill`` (build KV caches for a full
sequence) and ``decode_step`` (one token against a cache), over ``trunk``.
The model is an ``nn.Module`` (:class:`LM`) holding the reference's
parameter tree under the same names, layers stacked ``(L, ...)``, so the
decode cache is ``(L, B, S, KH, D)`` as in the reference and its weights
cross over by a copy (:func:`load_reference_params`).  ``prefill`` and
``decode_step`` are plain functions of the module, as the reference's are
of its parameter tree.

As in the reference, fp32 parameters are cast to the activation dtype on
every use (``c(w)``); no second copy of the weights is kept.  Unlike the
reference (pure functions under ``jit``), ``decode_step`` writes the new
token's keys and values into the caller's cache in place: a copy of the
``(L, B, S, KH, D)`` cache per layer would multiply a step's memory
traffic by the layer count.

Mixture-of-experts layers (``n_experts > 0``: deepseek-v2-lite with MLA,
mixtral with a sliding window) run ``models/moe.py`` with the shared
experts added; as in the reference, the ``n_dense_layers`` leading dense
layers form the stack ``dense_layers`` and the rest ``moe_layers``, the
cache index of an MoE layer is its global one, and ``trunk`` sums the
layers' ``aux``.  ``loss_fn`` (training) waits for ROADMAP.md step A.13.4.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from . import attention as attn_lib
from . import moe as moe_lib
from .common import apply_rope, rmsnorm
from .specs import (P, _Tree, abstract_params, axes_tree, init_params,
                    load_reference_params,  # noqa: F401  (the model's)
                    stack_layers, tree_map)


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    attn: str = "gqa"                 # "gqa" | "mla"
    window: Optional[int] = None      # SWA window
    expand_kv: bool = False           # replicate KV heads to full H
    rope_theta: float = 10000.0
    # MLA dims (deepseek-v2-lite)
    kv_lora: int = 0
    qk_nope: int = 0
    qk_rope: int = 0
    v_head: int = 0
    # MoE
    n_experts: int = 0
    n_shared: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_dense_layers: int = 0           # leading dense layers (deepseek: 1)
    capacity_factor: float = 1.25
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    q_chunk: Optional[int] = 1024     # None -> one q chunk (kv-scan only)
    kv_chunk: int = 1024
    loss_chunk: int = 512
    aux_weight: float = 0.01

    @property
    def moe(self) -> bool:
        return self.n_experts > 0

    @property
    def n_moe_layers(self) -> int:
        return self.n_layers - self.n_dense_layers if self.moe else 0

    @property
    def qk_dim(self) -> int:
        return (self.qk_nope + self.qk_rope) if self.attn == "mla" else self.head_dim


# --------------------------------------------------------------------------- #
# parameter specs
# --------------------------------------------------------------------------- #


def _attn_specs(cfg: LMConfig) -> dict:
    d = cfg.d_model
    if cfg.attn == "mla":
        return {
            "wq": P((d, cfg.n_heads, cfg.qk_nope + cfg.qk_rope), ("embed", "heads", None)),
            "w_dkv": P((d, cfg.kv_lora + cfg.qk_rope), ("embed", None)),
            "kv_norm": P((cfg.kv_lora,), (None,), "ones"),
            "w_uk": P((cfg.n_heads, cfg.kv_lora, cfg.qk_nope), ("heads", None, None)),
            "w_uv": P((cfg.n_heads, cfg.kv_lora, cfg.v_head), ("heads", None, None)),
            "wo": P((cfg.n_heads, cfg.v_head, d), ("heads", None, "embed")),
        }
    return {
        "wq": P((d, cfg.n_heads, cfg.head_dim), ("embed", "heads", None)),
        "wk": P((d, cfg.n_kv, cfg.head_dim), ("embed", "kv_heads", None)),
        "wv": P((d, cfg.n_kv, cfg.head_dim), ("embed", "kv_heads", None)),
        "wo": P((cfg.n_heads, cfg.head_dim, d), ("heads", None, "embed")),
    }


def _dense_ffn_specs(cfg: LMConfig, d_ff: int) -> dict:
    d = cfg.d_model
    return {
        "w1": P((d, d_ff), ("embed", "ffn")),
        "w3": P((d, d_ff), ("embed", "ffn")),
        "w2": P((d_ff, d), ("ffn", "embed")),
    }


def _moe_ffn_specs(cfg: LMConfig) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    out = {
        "router": P((d, e), ("embed", None)),
        "w1": P((e, d, f), ("expert", "embed", "ffn_expert")),
        "w3": P((e, d, f), ("expert", "embed", "ffn_expert")),
        "w2": P((e, f, d), ("expert", "ffn_expert", "embed")),
    }
    if cfg.n_shared:
        out["shared"] = _dense_ffn_specs(cfg, cfg.n_shared * f)
    return out


def _layer_specs(cfg: LMConfig, moe: bool) -> dict:
    d = cfg.d_model
    return {
        "attn_norm": P((d,), (None,), "ones"),
        "ffn_norm": P((d,), (None,), "ones"),
        "attn": _attn_specs(cfg),
        "ffn": _moe_ffn_specs(cfg) if moe else _dense_ffn_specs(cfg, cfg.d_ff),
    }


def _n_dense(cfg: LMConfig) -> int:
    return cfg.n_dense_layers if cfg.moe else cfg.n_layers


def param_specs(cfg: LMConfig) -> dict:
    specs = {
        "embed": P((cfg.vocab, cfg.d_model), ("vocab", "embed"), "embed"),
        "final_norm": P((cfg.d_model,), (None,), "ones"),
    }
    if _n_dense(cfg):
        specs["dense_layers"] = stack_layers(_layer_specs(cfg, moe=False),
                                             _n_dense(cfg))
    if cfg.n_moe_layers:
        specs["moe_layers"] = stack_layers(_layer_specs(cfg, moe=True),
                                           cfg.n_moe_layers)
    if cfg.param_dtype != torch.float32:
        specs = tree_map(lambda s: dataclasses.replace(s, dtype=cfg.param_dtype),
                         specs)
    return specs


class LM(_Tree):
    """The LM's parameters (``embed``, ``final_norm``, ``dense_layers``
    and, with experts, ``moe_layers``) and its config.  Build one with
    :func:`init`, or around an existing parameter tree
    (``LM(cfg, model.tree())`` shares the tensors)."""

    def __init__(self, cfg: LMConfig, params: dict):
        super().__init__(params)
        self.cfg = cfg


def init(cfg: LMConfig, generator: torch.Generator) -> LM:
    """Parameters drawn from ``generator`` on its device."""
    return LM(cfg, init_params(param_specs(cfg), generator))


def abstract(cfg: LMConfig) -> dict:
    return abstract_params(param_specs(cfg))


def axes(cfg: LMConfig) -> dict:
    return axes_tree(param_specs(cfg))


# --------------------------------------------------------------------------- #
# blocks
# --------------------------------------------------------------------------- #


def _gqa_attention(p, h, pos, cfg: LMConfig):
    c = lambda w: w.to(h.dtype)
    q = torch.einsum("bsd,dhk->bshk", h, c(p["wq"]))
    k = torch.einsum("bsd,dhk->bshk", h, c(p["wk"]))
    v = torch.einsum("bsd,dhk->bshk", h, c(p["wv"]))
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    kv_out = (k, v)
    if cfg.expand_kv and cfg.n_kv != cfg.n_heads:
        rep = cfg.n_heads // cfg.n_kv
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    o = attn_lib.full_attention(q, k, v, causal=True, window=cfg.window,
                                q_chunk=cfg.q_chunk or 1 << 30, kv_chunk=cfg.kv_chunk)
    return torch.einsum("bshk,hkd->bsd", o, c(p["wo"])), kv_out


def _mla_attention(p, h, pos, cfg: LMConfig):
    c = lambda w: w.to(h.dtype)
    b, s, _ = h.shape
    q = torch.einsum("bsd,dhk->bshk", h, c(p["wq"]))
    q_nope, q_rope = q[..., : cfg.qk_nope], q[..., cfg.qk_nope:]
    q_rope = apply_rope(q_rope, pos, cfg.rope_theta)
    lat_all = torch.einsum("bsd,dl->bsl", h, c(p["w_dkv"]))
    lat = rmsnorm(lat_all[..., : cfg.kv_lora], p["kv_norm"])
    k_rope = apply_rope(lat_all[..., None, cfg.kv_lora:], pos, cfg.rope_theta)  # (B,S,1,Dr)
    k_nope = torch.einsum("bsl,hln->bshn", lat, c(p["w_uk"]))
    v = torch.einsum("bsl,hlv->bshv", lat, c(p["w_uv"]))
    q_full = torch.cat([q_nope, q_rope], dim=-1)
    k_full = torch.cat([k_nope, k_rope.expand(b, s, cfg.n_heads, cfg.qk_rope)], dim=-1)
    o = attn_lib.full_attention(q_full, k_full, v, causal=True, window=cfg.window,
                                q_chunk=cfg.q_chunk or 1 << 30, kv_chunk=cfg.kv_chunk)
    return torch.einsum("bshv,hvd->bsd", o, c(p["wo"])), (lat, k_rope[:, :, 0, :])


def _dense_ffn(p, h):
    c = lambda w: w.to(h.dtype)
    gate = torch.nn.functional.silu(torch.einsum("bsd,df->bsf", h, c(p["w1"])))
    up = torch.einsum("bsd,df->bsf", h, c(p["w3"]))
    return torch.einsum("bsf,fd->bsd", gate * up, c(p["w2"]))


def _moe_ffn(p, h, cfg: LMConfig):
    out, aux = moe_lib.moe_ffn(
        h, p["router"], p["w1"], p["w3"], p["w2"],
        top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)
    if cfg.n_shared:
        out = out + _dense_ffn(p["shared"], h)
    return out, aux


def _layer(p, x, pos, cfg: LMConfig, moe: bool, collect_cache: bool):
    """(x, the MoE layer's aux loss or None for a dense layer, kv)."""
    h = rmsnorm(x, p["attn_norm"])
    attn_fn = _mla_attention if cfg.attn == "mla" else _gqa_attention
    a, kv = attn_fn(p["attn"], h, pos, cfg)
    x = x + a
    h = rmsnorm(x, p["ffn_norm"])
    if moe:
        f, aux = _moe_ffn(p["ffn"], h, cfg)
    else:
        f, aux = _dense_ffn(p["ffn"], h), None
    return x + f, aux, (kv if collect_cache else None)


def _layer_params(stack: dict, li: int) -> dict:
    """Layer ``li`` of a stacked ``(L, ...)`` tree (views, no copies)."""
    return tree_map(lambda a: a[li], stack)


# --------------------------------------------------------------------------- #
# trunk
# --------------------------------------------------------------------------- #


def _stacks(cfg: LMConfig) -> list:
    """(stack name, layer count, moe) of the layer stacks, in order."""
    out = [("dense_layers", _n_dense(cfg), False),
           ("moe_layers", cfg.n_moe_layers, True)]
    return [t for t in out if t[1]]


def _run_stack(stack: dict, n: int, x, pos, cfg: LMConfig, moe: bool,
               collect_cache: bool):
    """x through the stack's ``n`` layers -> (x, the MoE layers' aux
    losses, the per-name caches (n, B, S, ...) when ``collect_cache``)."""
    auxes, kvs = [], []
    for li in range(n):
        x, aux, kv = _layer(_layer_params(stack, li), x, pos, cfg, moe,
                            collect_cache)
        if aux is not None:
            auxes.append(aux)
        kvs.append(kv)
    caches = tuple(torch.stack(c) for c in zip(*kvs)) if collect_cache else None
    return x, auxes, caches


def trunk(model: LM, tokens: torch.Tensor, collect_cache: bool = False):
    """tokens (B, S) -> (final-normed activations (B, S, D), the layers'
    summed aux loss, caches: {"dense": ..., "moe": ...}, each the stack's
    per-name caches (L, B, S, ...), when ``collect_cache``)."""
    cfg, params = model.cfg, model.tree()
    s = tokens.shape[1]
    x = params["embed"][tokens.long()].to(cfg.dtype)
    pos = torch.arange(s, device=x.device)
    auxes, caches = [], {}
    for name, n, moe in _stacks(cfg):
        x, aux, c = _run_stack(params[name], n, x, pos, cfg, moe, collect_cache)
        auxes += aux
        if collect_cache:
            caches["moe" if moe else "dense"] = c
    x = rmsnorm(x, params["final_norm"])
    aux_total = (torch.stack(auxes).sum() if auxes else
                 torch.zeros((), dtype=torch.float32, device=x.device))
    return x, aux_total, caches


# --------------------------------------------------------------------------- #
# serving: prefill + decode
# --------------------------------------------------------------------------- #


def _cache_names(cfg: LMConfig) -> tuple:
    return ("lat", "rope") if cfg.attn == "mla" else ("k", "v")


def cache_spec(cfg: LMConfig, batch: int, cache_len: int) -> dict:
    """``device="meta"`` tensors of the decode cache (shapes and dtypes for
    input specs and allocation; no memory)."""
    eff = min(cache_len, cfg.window) if cfg.window else cache_len
    l = cfg.n_layers
    if cfg.attn == "mla":
        shapes = {"lat": (l, batch, eff, cfg.kv_lora),
                  "rope": (l, batch, eff, cfg.qk_rope)}
    else:
        shapes = {"k": (l, batch, eff, cfg.n_kv, cfg.head_dim),
                  "v": (l, batch, eff, cfg.n_kv, cfg.head_dim)}
    return {k: torch.empty(v, dtype=cfg.dtype, device="meta")
            for k, v in shapes.items()}


@torch.no_grad()
def prefill(model: LM, tokens: torch.Tensor):
    """Full-sequence forward; returns last-position logits + stacked caches."""
    cfg = model.cfg
    x, _, caches = trunk(model, tokens, collect_cache=True)
    last = x[:, -1, :]
    logits = torch.einsum("bd,vd->bv", last, model.embed.to(x.dtype))
    stacked = _merge_cache_stacks(caches, cfg)
    if cfg.window:  # keep only the trailing window (ring layout, slot = pos % W)
        s = tokens.shape[1]
        w = min(cfg.window, s)
        slots = torch.arange(s - w, s, device=x.device) % w

        def ring(c):
            tail = c[:, :, -w:]
            return torch.zeros_like(tail).index_copy_(2, slots, tail)

        stacked = {k: ring(c) for k, c in stacked.items()}
    return logits, stacked


def _merge_cache_stacks(caches: dict, cfg: LMConfig) -> dict:
    """Concatenate dense-stack and moe-stack caches into (L, B, S, ...)."""
    parts = [c for c in (caches.get("dense"), caches.get("moe")) if c is not None]
    out = {}
    for i, name in enumerate(_cache_names(cfg)):
        arrs = [p[i] for p in parts]
        out[name] = torch.cat(arrs, dim=0) if len(arrs) > 1 else arrs[0]
    return out


@torch.no_grad()
def decode_step(model: LM, cache: dict, token: torch.Tensor, pos: int):
    """One-token decode.  token (B,) int; pos: the count of cached positions.
    Writes the token's cache entries in place (``cache``'s tensors) and
    returns (logits (B, V), cache)."""
    cfg, params = model.cfg, model.tree()
    pos = int(pos)
    b = token.shape[0]
    x = params["embed"][token.long()].to(cfg.dtype)[:, None, :]
    w = cache[_cache_names(cfg)[0]].shape[2]
    slot = (pos % w) if cfg.window else pos
    # the reference's dynamic_update_slice clamps its start into the cache
    slot = min(slot, w - 1)
    pos_arr = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    layers = [(name, li, moe) for name, n, moe in _stacks(cfg) for li in range(n)]
    for gi, (name, li, moe) in enumerate(layers):     # gi: the cache's layer
        lp = _layer_params(params[name], li)
        h = rmsnorm(x, lp["attn_norm"])
        c = lambda wgt: wgt.to(h.dtype)
        ap = lp["attn"]
        if cfg.attn == "mla":
            q = torch.einsum("bsd,dhk->bshk", h, c(ap["wq"]))
            q_nope, q_rope = q[..., : cfg.qk_nope], q[..., cfg.qk_nope:]
            q_rope = apply_rope(q_rope, pos_arr, cfg.rope_theta)
            lat_all = torch.einsum("bsd,dl->bsl", h, c(ap["w_dkv"]))
            lat = rmsnorm(lat_all[..., : cfg.kv_lora], ap["kv_norm"])
            k_rope = apply_rope(lat_all[..., None, cfg.kv_lora:], pos_arr,
                                cfg.rope_theta)[:, :, 0]
            cache["lat"][gi, :, slot] = lat[:, 0].to(cfg.dtype)
            cache["rope"][gi, :, slot] = k_rope[:, 0].to(cfg.dtype)
            o = attn_lib.mla_decode_attention(
                q_nope[:, 0], q_rope[:, 0], cache["lat"][gi], cache["rope"][gi],
                min(pos + 1, w), ap["w_uk"].to(cfg.dtype), ap["w_uv"].to(cfg.dtype))
            a = torch.einsum("bshv,hvd->bsd", o, c(ap["wo"]))
        else:
            q = apply_rope(torch.einsum("bsd,dhk->bshk", h, c(ap["wq"])), pos_arr,
                           cfg.rope_theta)
            k = apply_rope(torch.einsum("bsd,dhk->bshk", h, c(ap["wk"])), pos_arr,
                           cfg.rope_theta)
            v = torch.einsum("bsd,dhk->bshk", h, c(ap["wv"]))
            cache["k"][gi, :, slot] = k[:, 0].to(cfg.dtype)
            cache["v"][gi, :, slot] = v[:, 0].to(cfg.dtype)
            o = attn_lib.decode_attention(q, cache["k"][gi], cache["v"][gi],
                                          min(pos + 1, w),
                                          window=None)  # ring layout already bounds SWA
            a = torch.einsum("bshk,hkd->bsd", o, c(ap["wo"]))
        x = x + a
        h2 = rmsnorm(x, lp["ffn_norm"])
        x = x + (_moe_ffn(lp["ffn"], h2, cfg)[0] if moe else _dense_ffn(lp["ffn"], h2))
    x = rmsnorm(x, params["final_norm"])
    logits = torch.einsum("bd,vd->bv", x[:, 0], params["embed"].to(x.dtype))
    return logits, cache
