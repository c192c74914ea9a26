"""Attention variants: GQA (+ sliding window), MLA; chunked online-softmax
("flash-style") full forward for prefill and O(window|cache) decode.

Counterpart of the JAX package's ``models/attention.py``, which is plain
``jnp`` under ``lax.scan`` (no Pallas kernel); here plain torch with a
Python loop over the same chunks in the same order, every score and
softmax sum in fp32, so the port stays within float tolerance of the
reference.  Under a plan the score block and the ``(m, l, acc)`` carry
take the reference's layouts (``shard``: batch, query sequence, kv
heads), the products are ``sharding.einsum``'s, and a kv chunk slice
gathers the keys and values of a sequence split over "model".

Two forms of one kv-chunk step, with the same values: serving scales,
masks and exponentiates the fp32 score block in place; under autograd
(``specs.grad_on``) every pass is out of place, and each chunk runs under
``torch.utils.checkpoint`` as the reference's step runs under
``jax.checkpoint``: backward recomputes a chunk's scores from its
``(m, l, acc)`` carry instead of holding every chunk's score block.
"""

from __future__ import annotations

import numpy as np
import torch

from ..distributed import sharding as shlib
from ..distributed.sharding import checkpoint, einsum, shard
from .specs import grad_on

NEG_INF = -1e30


def _scale(d: int) -> float:
    """``1 / sqrt(d)`` computed in fp32 as the reference does
    (``1.0 / jnp.sqrt(d).astype(float32)``): both IEEE operations are
    correctly rounded in numpy's float32, and the Python float holds that
    fp32 value exactly."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def _split_heads(x, kh: int):
    """x (..., H, D) -> (..., KH, H/KH, D).  Under a plan, heads split over
    mesh axes that KH does not divide are gathered first (GQA groups stay
    whole on a rank)."""
    if shlib.is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        hd, mesh = x.ndim - 2, x.device_mesh
        n = 1
        for m, p in enumerate(x.placements):
            if isinstance(p, Shard) and p.dim == hd:
                n *= mesh.size(m)
        if kh % n:
            x = x.redistribute(mesh, tuple(
                Replicate() if isinstance(p, Shard) and p.dim == hd else p
                for p in x.placements))
    return x.reshape(*x.shape[:-2], kh, x.shape[-2] // kh, x.shape[-1])


def _kv_step(m, l, acc, qf, kblk, vblk, mask, scale: float, inplace: bool):
    """One kv chunk of the online softmax: the carry ``(m, l, acc)`` after
    the chunk.  ``inplace``: the fp32 score block (B, Sq, KH, G, kv_chunk),
    the largest tensor of prefill, is scaled, masked and exponentiated in
    place (serving); else out of place (autograd saves ``s`` for ``amax``)."""
    s = einsum("bqkgd,bskd->bqkgs", qf, kblk.to(torch.float32))
    s = shard(s, "batch", "act_seq_attn", "act_heads", None, None)
    keep = mask[None, :, None, None, :]
    if inplace:
        s.mul_(scale).masked_fill_(~keep, NEG_INF)
    else:
        s = (s * scale).masked_fill(~keep, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = (s.sub_(m_new[..., None]).exp_() if inplace
         else torch.exp(s - m_new[..., None]))
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + einsum(
        "bqkgs,bskd->bqkgd", p, vblk.to(torch.float32))
    return m_new, l, acc


def _chunk_attn(q, k, v, q0: int, causal: bool, window, kv_chunk: int):
    """Online-softmax attention of q (B,Sq,H,D) over full k/v (B,Skv,KH,D).

    q0 = absolute position of q[0] (queries are at q0..q0+Sq-1, keys at
    0..Skv-1).  GQA: H % KH == 0, heads grouped.  window: only keys within
    (pos_q - window, pos_q] attend (SWA).
    """
    b, sq, h, d = q.shape
    skv, kh = k.shape[1], k.shape[2]
    dv = v.shape[-1]                      # may differ from d (MLA)
    g = h // kh
    dev = q.device
    scale = _scale(d)
    train = grad_on(q, k, v)
    qf = _split_heads(q.to(torch.float32), kh)
    nchunks = -(-skv // kv_chunk)
    pad = nchunks * kv_chunk - skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    qpos = q0 + torch.arange(sq, device=dev)
    m = shard(torch.full((b, sq, kh, g), NEG_INF, dtype=torch.float32, device=dev),
              "batch", "act_seq_attn", "act_heads", None)
    l = shard(torch.zeros((b, sq, kh, g), dtype=torch.float32, device=dev),
              "batch", "act_seq_attn", "act_heads", None)
    acc = shard(torch.zeros((b, sq, kh, g, dv), dtype=torch.float32, device=dev),
                "batch", "act_seq_attn", "act_heads", None, None)
    for ci in range(nchunks):
        kblk = k[:, ci * kv_chunk:(ci + 1) * kv_chunk]
        vblk = v[:, ci * kv_chunk:(ci + 1) * kv_chunk]
        kpos = ci * kv_chunk + torch.arange(kv_chunk, device=dev)
        mask = (kpos[None, :] <= skv - 1).expand(sq, kv_chunk)  # drop right-pad
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        if train:
            m, l, acc = checkpoint(_kv_step, m, l, acc, qf, kblk, vblk, mask,
                                   scale, False)
        else:
            m, l, acc = _kv_step(m, l, acc, qf, kblk, vblk, mask, scale, True)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(b, sq, h, dv).to(q.dtype)


def full_attention(q, k, v, *, causal: bool = True, window=None,
                   q_chunk: int = 1024, kv_chunk: int = 1024):
    """Train/prefill attention, looping over q chunks to bound the score
    block."""
    b, sq, h, d = q.shape
    dv = v.shape[-1]
    if sq <= q_chunk:
        return _chunk_attn(q, k, v, 0, causal, window, min(kv_chunk, k.shape[1]))
    nq = -(-sq // q_chunk)
    pad = nq * q_chunk - sq
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad)) if pad else q
    outs = [_chunk_attn(qp[:, ci * q_chunk:(ci + 1) * q_chunk], k, v,
                        ci * q_chunk, causal, window, kv_chunk)
            for ci in range(nq)]
    out = torch.cat(outs, dim=1).reshape(b, nq * q_chunk, h, dv)
    return out[:, :sq]


def decode_attention(q, k_cache, v_cache, cache_len: int, *, window=None):
    """One-token decode: q (B,1,H,D) over caches (B,S,KH,D); cache_len
    = number of valid cache entries (the new token's k/v already written)."""
    b, _, h, d = q.shape
    skv, kh = k_cache.shape[1], k_cache.shape[2]
    dv = v_cache.shape[-1]
    g = h // kh
    qf = _split_heads(q.to(torch.float32), kh).reshape(b, kh, g, d)
    s = einsum("bkgd,bskd->bkgs", qf, k_cache.to(torch.float32)) * _scale(d)
    kpos = torch.arange(skv, device=q.device)
    mask = kpos < cache_len
    if window is not None:
        mask = mask & (kpos >= cache_len - window)
    s = torch.where(mask[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = einsum("bkgs,bskd->bkgd", p, v_cache.to(torch.float32))
    return out.reshape(b, 1, h, dv).to(q.dtype)


# --------------------------------------------------------------------------- #
# MLA (DeepSeek-V2): low-rank latent KV cache
# --------------------------------------------------------------------------- #


def mla_decode_attention(q_nope, q_rope, latent_cache, rope_cache, cache_len: int,
                         w_uk, w_uv):
    """Absorbed MLA decode (memory-optimal: cache holds only latents).

    q_nope (B,H,Dn), q_rope (B,H,Dr); latent_cache (B,S,L); rope_cache (B,S,Dr)
    w_uk (H,L,Dn)  (key up-proj per head), w_uv (H,L,Dv).
    Returns (B,1,H,Dv).
    """
    scale = _scale(q_nope.shape[-1] + q_rope.shape[-1])
    qn = q_nope.to(torch.float32)
    qr = q_rope.to(torch.float32)
    lat = latent_cache.to(torch.float32)
    rop = rope_cache.to(torch.float32)
    # absorb key up-projection into the query: q_abs (B,H,L)
    q_abs = einsum("bhd,hld->bhl", qn, w_uk.to(torch.float32))
    s = einsum("bhl,bsl->bhs", q_abs, lat)
    s = s + einsum("bhd,bsd->bhs", qr, rop)
    s = s * scale
    mask = torch.arange(lat.shape[1], device=lat.device) < cache_len
    s = torch.where(mask[None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o_lat = einsum("bhs,bsl->bhl", p, lat)                 # attend over latents
    out = einsum("bhl,hld->bhd", o_lat, w_uv.to(torch.float32))
    return out[:, None].to(q_nope.dtype)
