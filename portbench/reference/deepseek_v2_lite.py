"""The plain reference of DeepSeek-V2-Lite's forward pass, in float32.

Plain torch, TF32 off (:func:`fp32_matmuls`), no cache of the program's,
no batching across sessions: MLA without absorption (each position's
keys and values up-projected from its latent), attention in query
blocks, the experts looped over with no capacity (every routed token
computed), the two shared experts as one FFN of twice an expert's
width, the first layer dense, RMSNorm (eps 1e-6) before each block and
at the end.  It follows the arXiv:2405.04434 equations, and takes from the
configuration each choice in which the port departs from the published
model (``portbench/configs/deepseek-v2-lite-16b.json``, ``reduced``):
``tie_word_embeddings`` (the head is the embedding, or its own
``lm_head``), ``rope_scaling`` (plain RoPE, or YaRN as the published
``modeling_deepseek.py`` scales it), ``norm_topk_prob`` and
``routed_scaling_factor`` (the top-k gates renormalised or not, then
scaled).  So the published model's arithmetic is one configuration away:
a port that takes it up is held to the same reference.  Weights are
``lm_weights.draw``'s tree; ``wt`` maps each matrix as it is used (the
identity, or the control's :func:`fp8`).

A session's prompt runs once (:func:`run` with ``collect``), keeping
every layer's keys and values; a turn's tokens then run over them
(``past``), several turns of one session as the rows of one batch.
Causal attention makes that the full forward over prompt and turn.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

EPS = 1e-6


def fp32_matmuls() -> None:
    """float32 products in float32: TF32 would be a lower precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8(w: torch.Tensor) -> torch.Tensor:
    """The control's weights: ``w`` scaled so its largest magnitude is
    float8_e4m3fn's largest (448), rounded to float8_e4m3fn, and scaled
    back, in float32."""
    s = w.abs().amax().clamp(min=1e-30) / 448.0
    return (w / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _same(w):
    return w


def rmsnorm(x, w):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + EPS) * w


def _yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def rope_freqs(cfg: dict, d: int, device) -> tuple:
    """(the ``d / 2`` rotation frequencies, the factor on cos and sin) of
    the configuration's RoPE: plain at ``rope_theta``, or with a
    ``rope_scaling`` of type ``yarn`` the published model's YaRN: the
    frequencies below the correction range divided by ``factor``, those
    above it kept, a linear ramp between.  At ``factor`` 1 YaRN keeps
    every frequency and both mscale terms are 1: plain RoPE."""
    base = float(cfg["rope_theta"])
    extra = 1.0 / (base ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=device) / d))
    ys = cfg.get("rope_scaling")
    if not ys:
        return extra, 1.0
    if ys["type"] != "yarn":
        raise ValueError(f"no reference for rope_scaling {ys['type']!r}")
    factor, orig = ys["factor"], ys["original_max_position_embeddings"]
    if factor == 1:                  # the ramp below would round an ulp off
        return extra, 1.0

    def dim_of(rotations):
        return (d * math.log(orig / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(dim_of(ys["beta_fast"])), 0)
    high = min(math.ceil(dim_of(ys["beta_slow"])), d - 1)
    ramp = (torch.arange(d // 2, dtype=torch.float32, device=device) - low) / (
        max(high - low, 0.001))
    keep = 1.0 - ramp.clamp(0, 1)            # 1: the frequency kept as it is
    freqs = extra / factor * (1 - keep) + extra * keep
    return freqs, (_yarn_mscale(factor, ys["mscale"])
                   / _yarn_mscale(factor, ys["mscale_all_dim"]))


def softmax_scale(cfg: dict) -> float:
    """1 / sqrt(query width), times YaRN's mscale squared where the
    configuration scales RoPE by YaRN."""
    scale = 1.0 / math.sqrt(cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"])
    ys = cfg.get("rope_scaling")
    if ys and ys.get("mscale_all_dim"):
        scale *= _yarn_mscale(ys["factor"], ys["mscale_all_dim"]) ** 2
    return scale


def rope(x, pos, cfg):
    """x (..., T, H, D) rotated by positions pos (T,), halves rotated."""
    d = x.shape[-1]
    freqs, m = rope_freqs(cfg, d, x.device)
    ang = pos.to(torch.float32)[:, None] * freqs              # (T, D/2)
    cos, sin = (torch.cos(ang)[:, None, :] * m,
                torch.sin(ang)[:, None, :] * m)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(p, h, pos, cfg, past, wt, q_block):
    """MLA over h (R, T, D) at positions pos (T,), after ``past`` ((P, H,
    Dqk) keys and (P, H, Dv) values of positions 0..P-1, shared by every
    row) -> (output (R, T, D), this call's (keys, values))."""
    r, t, _ = h.shape
    nope, lora = cfg["qk_nope_head_dim"], cfg["kv_lora_rank"]
    heads = cfg["num_attention_heads"]
    q = torch.einsum("rtd,dhk->rthk", h, wt(p["wq"]))
    q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, cfg)], dim=-1)
    lat_all = h @ wt(p["w_dkv"])
    lat = rmsnorm(lat_all[..., :lora], p["kv_norm"])
    k_rope = rope(lat_all[..., None, lora:], pos, cfg)        # (R, T, 1, Dr)
    k = torch.cat([torch.einsum("rtl,hln->rthn", lat, wt(p["w_uk"])),
                   k_rope.expand(r, t, heads, k_rope.shape[-1])], dim=-1)
    v = torch.einsum("rtl,hlv->rthv", lat, wt(p["w_uv"]))
    keys, vals = k, v
    if past is not None:
        pk, pv = past
        keys = torch.cat([pk.expand(r, *pk.shape), k], dim=1)
        vals = torch.cat([pv.expand(r, *pv.shape), v], dim=1)
    kpos = torch.arange(keys.shape[1], device=h.device)
    scale = softmax_scale(cfg)
    out = []
    for i in range(0, t, q_block):
        qb = q[:, i:i + q_block]
        s = torch.einsum("rqhk,rshk->rhqs", qb, keys) * scale
        allowed = kpos[None, :] <= pos[i:i + q_block, None]
        s = s.masked_fill(~allowed, float("-inf"))
        out.append(torch.einsum("rhqs,rshv->rqhv", torch.softmax(s, -1),
                                vals))
    o = torch.cat(out, dim=1)
    return torch.einsum("rthv,hvd->rtd", o, wt(p["wo"])), (k, v)


def _ffn(p, h, wt):
    return (F.silu(h @ wt(p["w1"])) * (h @ wt(p["w3"]))) @ wt(p["w2"])


def _experts(p, h, cfg, wt):
    """The expert layer over h (N, D): softmax routing, top-k experts each
    token, every routed token computed by its experts (no capacity), and
    the shared experts."""
    k = cfg["num_experts_per_tok"]
    probs = torch.softmax(h @ wt(p["router"]), dim=-1)
    top, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate = top[:, :k]
    if cfg["norm_topk_prob"]:
        gate = gate / gate.sum(-1, keepdim=True)
    gate = gate * cfg.get("routed_scaling_factor", 1.0)
    flat = expert[:, :k].reshape(-1)
    order = torch.argsort(flat, stable=True)
    tok, g = order // k, gate.reshape(-1)[order]
    counts = torch.bincount(flat, minlength=probs.shape[-1]).tolist()
    out = _ffn(p["shared"], h, wt)
    o = 0
    for e, c in enumerate(counts):
        if c:
            rows = tok[o:o + c]
            x = h[rows]
            y = (F.silu(x @ wt(p["w1"][e])) * (x @ wt(p["w3"][e]))) @ wt(
                p["w2"][e])
            out.index_add_(0, rows, y * g[o:o + c, None])
            o += c
    return out


def _layers(w: dict, cfg: dict):
    """(layer parameters, expert layer?) for every layer, in order."""
    for name, moe in (("dense_layers", False), ("moe_layers", True)):
        stack = w.get(name)
        if stack is None:
            continue
        n = stack["attn_norm"].shape[0]
        for li in range(n):
            yield _index(stack, li), moe


def _index(tree: dict, i: int) -> dict:
    return {k: _index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


@torch.no_grad()
def run(w: dict, cfg: dict, tokens: torch.Tensor, start: int, past=None,
        collect: bool = False, head: bool = True, wt=None,
        q_block: int = 1024):
    """tokens (R, T) at positions start.. -> (logits (R, T, V) or None,
    each layer's (keys (T, H, Dqk), values (T, H, Dv)) of row 0 when
    ``collect``).  ``past``: a list of each layer's keys and values of
    positions 0..start-1, which every row attends to."""
    wt = wt or _same
    r, t = tokens.shape
    pos = torch.arange(start, start + t, device=tokens.device)
    x = wt(w["embed"])[tokens]
    kept = []
    for li, (p, moe) in enumerate(_layers(w, cfg)):
        h = rmsnorm(x, p["attn_norm"])
        a, kv = _attention(p["attn"], h, pos, cfg,
                           None if past is None else past[li], wt, q_block)
        if collect:
            kept.append((kv[0][0], kv[1][0]))
        x = x + a
        h = rmsnorm(x, p["ffn_norm"]).reshape(r * t, -1)
        f = _experts(p["ffn"], h, cfg, wt) if moe else _ffn(p["ffn"], h, wt)
        x = x + f.reshape(r, t, -1)
    logits = None
    if head:
        out = w["embed"] if cfg["tie_word_embeddings"] else w["lm_head"]
        logits = rmsnorm(x, w["final_norm"]) @ wt(out).T
    return logits, (kept if collect else None)
