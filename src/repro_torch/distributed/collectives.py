"""Collectives of the port (counterpart of the JAX package's
``distributed/collectives.py``): the compressed gradient all-reduce of
data-parallel training and the top-k merge of doc-range sharded serving.

``compressed_psum_mean`` replaces an fp32 all-reduce with:

    quantize(int8/int4, per-block scale) -> all_to_all (reduce-scatter phase)
    -> local dequant+sum -> requantize -> all_gather -> dequant

Wire bytes: 2 * N * bits/8 vs ~8 * N for a ring fp32 all-reduce -- 8x
(int4) or 4x (int8) off the collective term.  int4 payloads are bit-packed
with the same LSB-first shift+mask scheme as kernels/bitpack.  Error
feedback (1-bit-Adam style): callers keep a residual per rank;
quantization error is re-injected next step.

The reference runs inside ``shard_map``, one device a rank.  The port has
two forms.  Over a process group (``*_group``), one process a rank: phase
1 is ``all_to_all_single``, phase 2 ``all_gather``.  Over a list of R
per-rank tensors in one process (what one card runs), each rank's
arithmetic the reference's; its ``all_to_all`` and ``all_gather`` become
list transposes (as ``merge_topk_stats`` merges shards).  The two forms
give the same bits.  Ranks are logical on one card, or
one rank a card when ``mesh`` lists a device a rank
(``launch.mesh.serving_mesh``): a payload then moves to the receiving
rank's card.  Wire words are integers and ``torch.round`` rounds half to
even as ``jnp.round`` does, so phase 1's words and scales are the
reference's bit for bit; phase 2 requantizes a sum over ranks, whose
order may differ from XLA's in the last bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.specs import tree_leaves, tree_unflatten

# --------------------------------------------------------------------------- #
# int4 pack/unpack (shift+mask, 8 nibbles per 32-bit word)
# --------------------------------------------------------------------------- #


def pack4(x: torch.Tensor) -> torch.Tensor:
    """int8 values in [-8, 7], length % 8 == 0 -> (n/8,) words, int32 bit
    patterns of the reference's uint32 words."""
    u = (x.to(torch.int32) & 0xF).reshape(-1, 8)
    out = torch.zeros(u.shape[0], dtype=torch.int32, device=x.device)
    for i in range(8):
        out = out | (u[:, i] << (4 * i))
    return out


def unpack4(w: torch.Tensor, n: int) -> torch.Tensor:
    vals = [(w >> (4 * i)) & 0xF for i in range(8)]     # the sign bits drop
    v = torch.stack(vals, dim=1).reshape(-1)[:n]
    return torch.where(v >= 8, v - 16, v).to(torch.int8)


# --------------------------------------------------------------------------- #
# quantization with per-block scales
# --------------------------------------------------------------------------- #

BLOCK = 1024


def _quantize(x: torch.Tensor, bits: int):
    """x fp32 (n,) n % BLOCK == 0 -> (q int8 (n,), scales fp32 (n/BLOCK,))."""
    qmax = (1 << (bits - 1)) - 1
    xb = x.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(xb), dim=1) / qmax
    scale = torch.clamp(scale, min=1e-30)
    q = torch.clamp(torch.round(xb / scale[:, None]), -qmax - 1, qmax).to(torch.int8)
    return q.reshape(-1), scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (q.to(torch.float32).reshape(-1, BLOCK) * scale[:, None]).reshape(-1)


def _pad_to(x: torch.Tensor, m: int) -> torch.Tensor:
    r = (-x.shape[0]) % m
    return torch.cat([x, x.new_zeros(r)]) if r else x


def wire_bytes(n: int, ranks: int, bits) -> int:
    """Bytes one rank sends in one all-reduce of ``n`` floats: the
    compressed one's two phases (words and scales to the ``ranks - 1``
    others, of the padded length), or an fp32 ring's (``bits=None``:
    ``2 (R-1)/R * 4 n``, about ``8 n``)."""
    if bits is None:
        return 2 * (ranks - 1) * 4 * n // ranks
    npad = n + (-n) % (ranks * BLOCK)
    return 2 * (ranks - 1) * (npad * bits // 8 + npad // BLOCK * 4) // ranks


def compressed_allreduce_flat(xs: list, bits: int = 8, mesh=None):
    """Mean all-reduce of R flat fp32 tensors (one a rank, equal lengths),
    2 quant rounds.

    Returns (reduced, residuals): lists of R (n,) tensors, each on its
    rank's device; every rank's reduced tensor holds the same values, and
    its residual is what ITS transmitted payload lost to quantization
    (phase-1 error everywhere, plus the phase-2 requantization error on
    the chunk it owns, times R), the error-feedback term.
    """
    r = len(xs)
    n = xs[0].shape[0]
    if mesh is not None and len(mesh) != r:
        raise ValueError(f"a mesh of {len(mesh)} devices for {r} ranks")
    devs = ([torch.device(d) for d in mesh] if mesh is not None
            else [x.device for x in xs])
    sent, resid = [], []
    for me, x in enumerate(xs):
        # phase 1: quantize; row j of the words goes to rank j
        xp = _pad_to(x.to(devs[me], torch.float32), r * BLOCK)
        chunk = xp.shape[0] // r
        q, s = _quantize(xp, bits)
        resid.append(xp - _dequantize(q, s))
        qr = q.reshape(r, chunk)
        payload = torch.stack([pack4(row) for row in qr]) if bits == 4 else qr
        sent.append((payload, s.reshape(r, chunk // BLOCK)))
    gathered = []
    for j in range(r):
        # all_to_all: rank j receives row j of every rank, in rank order
        got = torch.stack([p[j].to(devs[j]) for p, _ in sent])
        got_s = torch.stack([sc[j].to(devs[j]) for _, sc in sent])
        if bits == 4:
            got = torch.stack([unpack4(w, chunk) for w in got])
        part = torch.stack([_dequantize(g, gs) for g, gs in zip(got, got_s)]
                           ).sum(dim=0) / r                  # mean
        # phase 2: requantize the reduced chunk; all_gather
        q2, s2 = _quantize(part, bits)
        sl = slice(j * chunk, (j + 1) * chunk)
        resid[j][sl] = resid[j][sl] + (part - _dequantize(q2, s2)) * r
        gathered.append((pack4(q2) if bits == 4 else q2, s2))
    outs = []
    for me in range(r):
        parts = [_dequantize(unpack4(w.to(devs[me]), chunk) if bits == 4
                             else w.to(devs[me]), s2.to(devs[me]))
                 for w, s2 in gathered]
        outs.append(torch.cat(parts)[:n])
    return outs, [x[:n] for x in resid]


def mesh_group(mesh, axes):
    """The process group of this rank along ``axes`` of a ``DeviceMesh``
    (the reference's manual axes of ``shard_map``; axes absent from the
    mesh drop out).  Several axes make one group per coordinate of the
    others, every rank creating every group, as ``new_group`` asks."""
    import torch.distributed as dist
    names = list(mesh.mesh_dim_names)
    axes = [a for a in axes if a in names]
    if not axes:
        raise ValueError(f"none of {axes} is an axis of the mesh {names}")
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    idx = [names.index(a) for a in axes]
    rest = [i for i in range(len(names)) if i not in idx]
    n = int(np.prod([mesh.size(i) for i in idx]))
    mine = None
    for row in mesh.mesh.permute(rest + idx).reshape(-1, n).tolist():
        g = dist.new_group(row)
        if dist.get_rank() in row:
            mine = g
    return mine


def compressed_allreduce_flat_group(x: torch.Tensor, group=None, bits: int = 8):
    """The process-group form of :func:`compressed_allreduce_flat`: each
    rank of ``group`` (default: the world) calls it with its own flat fp32
    ``x`` and gets (reduced (n,), its residual (n,)), bit for bit what the
    list form gives that rank.  Phase 1 moves the words and their scales
    with ``all_to_all_single``, phase 2 with ``all_gather``."""
    import torch.distributed as dist
    r = dist.get_world_size(group)
    me = dist.get_rank(group)
    n = x.shape[0]
    xp = _pad_to(x.to(torch.float32), r * BLOCK)
    chunk = xp.shape[0] // r
    # phase 1: quantize; row j of the words goes to rank j
    q, s = _quantize(xp, bits)
    resid = xp - _dequantize(q, s)
    qr = q.reshape(r, chunk)
    payload = torch.stack([pack4(row) for row in qr]) if bits == 4 else qr
    got = torch.empty_like(payload)
    dist.all_to_all_single(got, payload.contiguous(), group=group)
    sc = s.reshape(r, chunk // BLOCK).contiguous()
    got_s = torch.empty_like(sc)
    dist.all_to_all_single(got_s, sc, group=group)
    if bits == 4:
        got = torch.stack([unpack4(w, chunk) for w in got])
    part = torch.stack([_dequantize(g, gs) for g, gs in zip(got, got_s)]
                       ).sum(dim=0) / r                      # mean
    # phase 2: requantize the reduced chunk; all_gather
    q2, s2 = _quantize(part, bits)
    sl = slice(me * chunk, (me + 1) * chunk)
    resid[sl] = resid[sl] + (part - _dequantize(q2, s2)) * r
    w2 = pack4(q2) if bits == 4 else q2
    all_w = [torch.empty_like(w2) for _ in range(r)]
    all_s = [torch.empty_like(s2) for _ in range(r)]
    dist.all_gather(all_w, w2, group=group)
    dist.all_gather(all_s, s2, group=group)
    out = torch.cat([_dequantize(unpack4(w, chunk) if bits == 4 else w, sc2)
                     for w, sc2 in zip(all_w, all_s)])
    return out[:n], resid[:n]


def compressed_psum_mean_group(tree, group=None, bits: int = 8,
                               error_feedback=None):
    """The process-group form of :func:`compressed_psum_mean`: this rank's
    tree (and its residual tree, or None) -> (the mean tree, its new
    residual tree), as the reference's, which runs inside ``shard_map``."""
    sizes = [int(l.numel()) for l in tree_leaves(tree)]
    flat = torch.cat([l.to(torch.float32).reshape(-1) for l in tree_leaves(tree)])
    if error_feedback is not None:
        flat = flat + torch.cat([e.to(torch.float32).reshape(-1)
                                 for e in tree_leaves(error_feedback)])
    red, ef = compressed_allreduce_flat_group(flat, group, bits)
    return (_split_like(tree, red, sizes, cast=True),
            _split_like(tree, ef, sizes, cast=False))


def compressed_psum_mean(trees: list, bits: int = 8, error_feedback=None,
                         mesh=None):
    """Mean-all-reduce R per-rank trees (same structure) with compression
    and error feedback.

    error_feedback: R residual trees or None.  Returns (R reduced trees,
    R new residual trees): each rank's leaves in its tree's dtype.
    """
    sizes = [int(l.numel()) for l in tree_leaves(trees[0])]
    flats = []
    for i, t in enumerate(trees):
        flat = torch.cat([l.to(torch.float32).reshape(-1) for l in tree_leaves(t)])
        if error_feedback is not None:
            flat = flat + torch.cat([e.to(torch.float32).reshape(-1)
                                     for e in tree_leaves(error_feedback[i])])
        flats.append(flat)
    reds, efs = compressed_allreduce_flat(flats, bits, mesh)
    return ([_split_like(t, red, sizes, cast=True) for t, red in zip(trees, reds)],
            [_split_like(t, ef, sizes, cast=False) for t, ef in zip(trees, efs)])


def _split_like(tree, flat: torch.Tensor, sizes: list, cast: bool):
    """``flat`` cut into ``tree``'s leaves (their shapes; their dtypes when
    ``cast``, else fp32)."""
    out, off = [], 0
    for l, sz in zip(tree_leaves(tree), sizes):
        v = flat[off:off + sz].reshape(l.shape)
        out.append(v.to(l.dtype) if cast else v)
        off += sz
    return tree_unflatten(tree, out)


# --------------------------------------------------------------------------- #
# sharded-serving top-k merge (the serving path's ONE collective per batch)
# --------------------------------------------------------------------------- #


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
