"""Mixture-of-Experts with group-local top-k dispatch (counterpart of the
JAX package's ``models/moe.py``: the GShard/MaxText-style "dropping"
implementation, static shapes, no global sort).

Tokens are routed within fixed groups (one group = one sequence in
prefill, one batch row in decode).  Per group: top-k -> stable sort of the
S*k expert assignments -> capacity-clipped gather indices (E, C).  Expert
compute is a batched einsum (G, E, C, D) x (E, D, F).  Every group routes
in one batched call (the reference maps ``route_group`` over the groups
with ``vmap``); the reference's ``shard(...)`` constraints wait for the
sharding slice.

Plain torch, as the reference is plain ``jnp`` (no Pallas kernel): routing
in fp32; the gather, the expert products, ``y * wgt`` and the combine in
the activation dtype.  Neither the gather nor the combine builds an index
expanded to ``(G, E*C, D)``: the gather indexes rows, the combine is one
``index_add_`` over the flattened ``(G*(S+1), D)`` rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def route_group(x: torch.Tensor, router_w: torch.Tensor, *, top_k: int,
                capacity: int):
    """x (S, D) -> (idx (E*C,), weight (E*C,), aux_loss scalar); x (G, S, D)
    routes each of the G groups alike -> ((G, E*C), (G, E*C), (G,)).

    idx[e*C+c] = token slot assigned to expert e at capacity position c, or S
    (sentinel = dropped/empty).
    """
    grouped = x.dim() == 3
    xg = x if grouped else x[None]
    g, s, _ = xg.shape
    e = router_w.shape[-1]
    dev = x.device
    logits = xg.to(torch.float32) @ router_w.to(torch.float32)   # (G, S, E)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k breaks ties to the lower index; torch.topk promises no
    # order for ties, a stable descending sort keeps the lower index first
    sp, si = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = sp[..., :top_k], si[..., :top_k]              # (G, S, k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    # aux load-balancing loss (Switch-style)
    me = probs.mean(dim=1)                                       # (G, E)
    eid = expert.reshape(g, s * top_k)                           # (G, S*k)
    ce = torch.zeros(g, e, dtype=torch.float32, device=dev).scatter_add_(
        1, eid, torch.ones(eid.shape, dtype=torch.float32, device=dev)) / (s * top_k)
    aux = e * torch.sum(me * ce, dim=-1)
    # group-local stable sort of assignments by expert
    sorted_eid, order = torch.sort(eid, dim=-1, stable=True)
    seg_start = torch.searchsorted(
        sorted_eid, torch.arange(e, device=dev).expand(g, e).contiguous(),
        right=False)                                             # (G, E) int64
    pos_in_seg = torch.arange(s * top_k, device=dev) - torch.gather(
        seg_start, 1, sorted_eid)
    tok = order // top_k
    gflat = torch.gather(gate.reshape(g, -1), 1, order)
    keep = pos_in_seg < capacity
    dest = torch.where(keep, sorted_eid * capacity + pos_in_seg, e * capacity)
    # The kept destinations are distinct.  Every dropped assignment goes to
    # the extra slot e*capacity (the reference's mode="drop"): several
    # writers on one slot, whose value scatter_ leaves unspecified on the
    # card; the slot is cut off below, so no kept slot depends on it.
    idx = torch.full((g, e * capacity + 1), s, dtype=torch.int32, device=dev)
    idx.scatter_(1, dest, tok.to(torch.int32))
    wgt = torch.zeros((g, e * capacity + 1), dtype=torch.float32, device=dev)
    wgt.scatter_(1, dest, gflat)
    idx, wgt = idx[:, :-1], wgt[:, :-1]
    if not grouped:
        return idx[0], wgt[0], aux[0]
    return idx, wgt, aux


def moe_ffn(x: torch.Tensor, router_w, w1, w3, w2, *, top_k: int,
            capacity_factor: float = 1.25):
    """x (G, S, D); experts w1/w3 (E, D, F), w2 (E, F, D). Returns (G,S,D), aux."""
    g, s, d = x.shape
    e = router_w.shape[-1]
    cap = max(1, int(-(-s * top_k * capacity_factor // e)))
    idx, wgt, aux = route_group(x, router_w, top_k=top_k, capacity=cap)
    idx = idx.to(torch.int64)
    xpad = torch.cat([x, x.new_zeros(g, 1, d)], dim=1)          # sentinel row
    rows = torch.arange(g, device=x.device)[:, None]
    gathered = xpad[rows, idx].reshape(g, e, cap, d)             # (G, E, C, D)
    h1 = torch.einsum("gecd,edf->gecf", gathered, w1.to(gathered.dtype))
    h3 = torch.einsum("gecd,edf->gecf", gathered, w3.to(gathered.dtype))
    h = F.silu(h1) * h3
    del h1, h3
    y = torch.einsum("gecf,efd->gecd", h, w2.to(h.dtype))
    y = y.reshape(g, e * cap, d) * wgt[:, :, None].to(y.dtype)
    # a token's k outputs sum in another order than XLA's (on the card in
    # no fixed order): the outputs agree within float tolerance
    out = torch.zeros((g * (s + 1), d), dtype=y.dtype, device=x.device)
    out.index_add_(0, (rows * (s + 1) + idx).reshape(-1), y.reshape(-1, d))
    return out.view(g, s + 1, d)[:, :s], aux.mean()
