"""Logical-axis sharding: one model code path, many parallelism plans
(counterpart of the JAX package's ``distributed/sharding.py``).

A *plan* maps logical axis names (weight axes like "embed"/"heads"/
"expert" and activation axes like "act_seq") to mesh axis tuples.  Models
declare logical axes only; ``shard(x, axes...)`` sets a tensor's layout
when a (mesh, plan) context is active and is a no-op otherwise (one
device, no plan).  Divisibility guard: any mesh axis that does not evenly
divide the dimension is dropped from the spec, so every (arch x shape x
mesh) cell runs.

Parallelism vocabulary: DP/FSDP = ("pod","data") on batch and weight
fan-in dims; TP = "model" on heads/ffn; EP = "model" on expert dims;
SP = "model" on the residual sequence dim.

The JAX ``Mesh`` becomes a ``torch.distributed.device_mesh.DeviceMesh``
with the same axis names (``launch/mesh.py``), one process a rank; a
tensor laid out by a plan is a ``DTensor``.  A spec is a plain tuple, one
entry per tensor dim: ``None``, a mesh axis name, or a tuple of names
(entry by entry the reference's ``PartitionSpec``); :func:`placements`
turns it into ``DTensor`` placements, a tensor dim split over several mesh
axes becoming ``Shard(d)`` on each of them in mesh order, which is the
reference's major-to-minor order when the tuple is in mesh order (every
plan's is).  ``shard`` redistributes a ``DTensor`` (the reference's
``with_sharding_constraint``); a plain tensor the model made itself under
a plan (a mask, a position table, a zero carry) counts as replicated, as
``implicit_replication()`` treats it (:func:`plan_scope`).  Every sharded
form here applies only where an operand is a ``DTensor``: plain tensors
under a plan are a local region's (:func:`run_local`), whose
recomputation in backward runs with the plan active again.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class Plan:
    name: str
    rules: dict                     # logical axis -> tuple of mesh axes | None

    def axes_of(self, logical: Optional[str]):
        if logical is None:
            return None
        got = self.rules.get(logical, None)
        if got is None:
            return None
        if isinstance(got, str):
            return (got,)
        return tuple(got)


_STATE = threading.local()


def _active():
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def activate(mesh, plan: Plan):
    """Make (mesh, plan) the active context of this thread (nesting: the
    previous one comes back on exit).  ``mesh``: a ``DeviceMesh``, or any
    object whose ``shape`` maps axis names to sizes (enough for
    :func:`spec_for`)."""
    prev = _active()
    _STATE.ctx = (mesh, plan)
    try:
        yield
    finally:
        _STATE.ctx = prev


def plan_active() -> bool:
    return _active() is not None


def active_mesh():
    return _active()[0]


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (or of an object whose
    ``shape`` is that dict already)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def _mesh_size(shape: dict, axes: tuple) -> int:
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def spec_for(logical_axes, dims=None) -> tuple:
    """Logical axes tuple -> spec (a tuple, one entry a tensor dim) under
    the active plan; ``()`` without one.

    dims (optional): concrete dim sizes for the divisibility guard.
    """
    ctx = _active()
    if ctx is None:
        return ()
    mesh, plan = ctx
    shape = mesh_shape(mesh)
    parts = []
    for i, lax_ in enumerate(logical_axes):
        axes = plan.axes_of(lax_)
        if axes is None:
            parts.append(None)
            continue
        # ignore mesh axes absent from the active mesh (e.g. "pod" single-pod)
        axes = tuple(a for a in axes if a in shape)
        if dims is not None:
            # drop trailing mesh axes until the dim divides evenly
            while axes and dims[i] % _mesh_size(shape, axes) != 0:
                axes = axes[:-1]
        if not axes:
            parts.append(None)
        elif len(axes) == 1:
            parts.append(axes[0])
        else:
            parts.append(tuple(axes))
    return tuple(parts)


def placements(spec: tuple, mesh) -> tuple:
    """``DTensor`` placements (one a mesh dim) of ``spec``: ``Shard(d)`` on
    every mesh axis of more than one rank that tensor dim ``d`` names,
    ``Replicate()`` on the rest (a split over one rank is the whole
    tensor).  A tuple entry must list its axes in mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    sizes = mesh_shape(mesh)
    names = list(sizes)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        assert idx == sorted(idx), f"spec entry {axes} is not in mesh order {names}"
        for i in idx:
            assert isinstance(out[i], Replicate), f"mesh axis {names[i]} used twice"
            if sizes[names[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


def _as_dtensor(x, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def shard(x, *logical_axes):
    """Lay an activation out by the active plan (no-op without one): a
    ``DTensor`` redistributed to ``placements(spec_for(axes, x.shape))``.
    A plain tensor stays as it is: one the model made itself counts as
    replicated (``implicit_replication``), and one inside a local region
    (``run_local``, or its recomputation in backward) is a rank's own."""
    ctx = _active()
    if ctx is None or not is_dtensor(x):
        return x
    mesh, _ = ctx
    want = placements(spec_for(logical_axes, dims=tuple(x.shape)), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def distribute(x, logical_axes):
    """A full tensor (the same on every rank) as a ``DTensor`` laid out by
    the active plan: each rank keeps its own shard (no collective).
    Without a plan, ``x`` as it is."""
    ctx = _active()
    if ctx is None:
        return x
    mesh = ctx[0]
    return from_full(x, mesh, placements(
        spec_for(logical_axes, dims=tuple(x.shape)), mesh))


def from_full(x, mesh, placements_: tuple):
    """A full tensor (the same on every rank) as a ``DTensor`` of
    ``placements_``: each rank slices its own shard, as ``DTensor`` splits
    a ``Shard`` dim (``torch.chunk``, mesh dims in order), with no
    collective.  A rank outside ``mesh`` gets None."""
    from torch.distributed.tensor import DTensor, Shard
    coord = mesh.get_coordinate()
    if coord is None:
        return None
    loc = x
    for m, p in enumerate(placements_):
        if isinstance(p, Shard):
            parts = torch.chunk(loc, mesh.size(m), dim=p.dim)
            loc = (parts[coord[m]] if coord[m] < len(parts)
                   else loc.narrow(p.dim, 0, 0))
    return DTensor.from_local(loc.contiguous(), mesh, tuple(placements_),
                              run_check=False, shape=x.shape,
                              stride=torch.empty(x.shape, device="meta").stride())


def distribute_tree(tree, axes_tree):
    """A nested dict of full tensors as ``DTensor``s laid out by the active
    plan (:func:`distribute` on every leaf, ``axes_tree`` its axes); as it
    is without a plan."""
    if isinstance(tree, dict):
        return {k: distribute_tree(tree[k], axes_tree[k]) for k in sorted(tree)}
    return distribute(tree, axes_tree)


def distribute_model(model, axes_tree):
    """A copy of ``model`` (a ``models.specs._Tree`` with a ``cfg``) whose
    parameters are ``DTensor``s laid out by the active plan; ``model``
    itself without a plan."""
    if _active() is None:
        return model
    from ..models.specs import tree_map
    return type(model)(model.cfg, distribute_tree(
        tree_map(lambda t: t.detach(), model.tree()), axes_tree))


def sharding_for_axes_tree(axes_tree, shape_tree):
    """Map a tree (nested dicts) of logical-axes tuples (+ tensors or
    anything with a ``shape``) to ``(mesh, placements)`` leaves."""
    ctx = _active()
    assert ctx is not None, "sharding_for_axes_tree requires an active plan"
    mesh, _ = ctx

    def one(axes, arr):
        if isinstance(axes, dict):
            return {k: one(axes[k], arr[k]) for k in sorted(axes)}
        return (mesh, placements(spec_for(axes, dims=tuple(arr.shape)), mesh))

    return one(axes_tree, shape_tree)


@contextlib.contextmanager
def plan_scope(mesh, plan: Plan):
    """``activate(mesh, plan)`` with ``implicit_replication()``: model code
    under a plan treats the plain tensors it makes itself as replicated."""
    from torch.distributed.tensor.experimental import implicit_replication
    with activate(mesh, plan), implicit_replication():
        yield


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


@contextlib.contextmanager
def _suspended():
    prev = _active()
    _STATE.ctx = None
    try:
        yield
    finally:
        _STATE.ctx = prev


@contextlib.contextmanager
def _restored(ctx):
    """``ctx`` (a (mesh, plan) or None) as this thread's context, with
    ``implicit_replication`` under a plan (entered only where it is off:
    leaving it turns it off)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    prev = _active()
    _STATE.ctx = ctx
    on = getattr(DTensor._op_dispatcher, "_allow_implicit_replication", False)
    try:
        with (implicit_replication() if ctx is not None and not on
              else contextlib.nullcontext()):
            yield
    finally:
        _STATE.ctx = prev


def checkpoint(fn, *args):
    """``torch.utils.checkpoint`` (non-reentrant) whose recomputation in
    backward runs under the plan context active now: autograd may
    recompute on another thread (a card's backward runs on its device
    thread), where this thread's plan is not active, and a recomputation
    that took other ops than the forward would not match it."""
    from torch.utils.checkpoint import checkpoint as torch_checkpoint
    ctx = _active()
    return torch_checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), _restored(ctx)))


def run_local(fn, args: tuple, in_placements: tuple, out_placements,
              grad_placements: tuple | None = None):
    """``fn(*args)`` on every rank's local tensors (the reference's
    ``shard_map``; ``local_map`` with the gradient placements spelled
    out): each ``DTensor`` argument is redistributed to its entry of
    ``in_placements`` (``None``: a non-tensor, or a plain tensor passed as
    it is), ``fn`` runs on the local shards with the plan suspended (the
    plain model code), and its output is a ``DTensor`` of
    ``out_placements`` (one output), or a tuple of them (a tuple of
    placement lists for a tuple of outputs).

    ``grad_placements`` (one entry an argument) says what each argument's
    local gradient is: ``Partial()`` on a mesh axis where the argument is
    replicated but each rank's share of the work differs (a weight
    against the rank's rows), else its own placement (the default).  An
    output that is ``Partial`` takes its gradient replicated (``DTensor``
    keeps a replicated gradient as it is on the way back)."""
    from torch.distributed.tensor import DTensor
    mesh = _active()[0]
    local_args = []
    for i, (a, pl) in enumerate(zip(args, in_placements)):
        if pl is None or not isinstance(a, torch.Tensor):
            local_args.append(a)
            continue
        a = _as_dtensor(a, mesh)
        if not _even(a.shape, pl, mesh):
            raise ValueError(f"run_local: {tuple(pl)} splits {tuple(a.shape)} "
                             "unevenly")
        if tuple(a.placements) != tuple(pl):
            a = a.redistribute(mesh, tuple(pl))
        gp = grad_placements[i] if grad_placements is not None else None
        loc = a.to_local(grad_placements=gp)
        local_args.append(loc.wait() if hasattr(loc, "wait")
                          and not isinstance(loc, DTensor)
                          and type(loc).__name__ == "AsyncCollectiveTensor"
                          else loc)
    with _suspended():
        out = fn(*local_args)
    many = isinstance(out, tuple)
    outs, pls = (out, out_placements) if many else ((out,), (out_placements,))
    res = tuple(DTensor.from_local(o, mesh, tuple(pl), run_check=False)
                for o, pl in zip(outs, pls))
    return res if many else res[0]


def matmul(x, w):
    """``x @ w`` (``w`` 2-D), and under a plan the sharded product of
    :func:`einsum` (each rank's ``x @ w`` on its shards)."""
    if _active() is None or not (is_dtensor(x) or is_dtensor(w)):
        return x @ w
    lead = "abcdefgh"[: x.ndim - 1]
    return _sharded(f"{lead}y,yz->{lead}z", lambda a, b: a @ b, (x, w))


def local_rows(tree: dict) -> int:
    """Rows (dim 0) of this rank's part of a dict of tensors whose leaves
    share their rows: a ``DTensor`` leaf's local shard's, a plain one's."""
    v = next(iter(tree.values()))
    return (v.to_local() if is_dtensor(v) else v).shape[0]


def row_slice(tree: dict, lo: int, hi: int) -> dict:
    """Rows [lo, hi) of each leaf's local part: a plain leaf's rows; for a
    ``DTensor`` leaf the ``DTensor`` of every rank's rows [lo, hi) of its
    own shard, laid out as the leaf (a pass over each rank's own rows,
    with no collective)."""
    from torch.distributed.tensor import DTensor

    def one(v):
        if not is_dtensor(v):
            return v[lo:hi]
        return DTensor.from_local(v.to_local()[lo:hi], v.device_mesh,
                                  v.placements, run_check=False)
    return {k: one(v) for k, v in tree.items()}


def cat_rows(parts: list, like):
    """``torch.cat`` of the row passes of :func:`row_slice`, in order: for
    a ``DTensor`` ``like`` (a leaf the passes took rows of) each pass is
    laid out on its rows as ``like`` and the ranks' local rows are
    joined."""
    if not is_dtensor(like):
        return torch.cat(parts)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = like.device_mesh
    pl = tuple(p if isinstance(p, Shard) and p.dim == 0 else Replicate()
               for p in like.placements)
    loc = [_as_dtensor(p, mesh).redistribute(mesh, pl).to_local() for p in parts]
    return DTensor.from_local(torch.cat(loc), mesh, pl, run_check=False)


def _splits(placements_, mesh) -> dict:
    """{tensor dim: the ranks it is split over} of ``placements_``."""
    from torch.distributed.tensor import Shard
    split: dict = {}
    for m, p in enumerate(placements_):
        if isinstance(p, Shard):
            split[p.dim] = split.get(p.dim, 1) * mesh.size(m)
    return split


def _even(shape, placements_, mesh) -> bool:
    """Every dim ``placements_`` split divides evenly over its mesh axes
    (an output's global shape is then its local shape times the split)."""
    return all(shape[d] % n == 0 for d, n in _splits(placements_, mesh).items())


def local_shape(shape, placements_, mesh) -> tuple:
    """A rank's shard shape of a tensor of ``shape`` laid out by
    ``placements_`` (even splits: the divisibility guard drops every
    uneven axis)."""
    split = _splits(placements_, mesh)
    return tuple(n // split.get(d, 1) for d, n in enumerate(shape))


def einsum(eq: str, *operands):
    """``torch.einsum``, and under a plan its sharded form: each mesh axis
    keeps the one subscript the first operand (evenly) sharded over it
    has (an operand sharded otherwise is gathered over that axis: the
    FSDP all-gather of a weight), every operand holding that subscript is
    split alike (a local slice), and the product runs on the local
    shards.  The output is sharded on that subscript, or ``Partial`` (a
    pending sum) when the subscript is contracted.

    Why not ``DTensor``'s own einsum rule (torch 2.13, gloo, a 4x2 mesh):
    it picks its split without the divisibility guard and then fails on
    an uneven one (smollm's smoke ``bsd,dhk->bshk`` with a 31-token
    sequence: "Cannot unflatten unevenly sharded tensor: output dimension
    0 (size 3) is not evenly divisible by mesh dimension 1 (size 2)"),
    and the MoE expert products fail (``gecf,efd->gecd``, deepseek's and
    mixtral's smoke steps: "view size is not compatible with input
    tensor's size and stride").  Where
    every dim divides, its rule gave the same losses and gradients
    (within 5e-5 of each leaf's largest) for smollm, the three recsys
    archs tried and EGNN (``tools/dtensor_rules.py``)."""
    if _active() is None or not any(is_dtensor(o) for o in operands):
        return torch.einsum(eq, *operands)
    return _sharded(eq, lambda *ls: torch.einsum(eq, *ls), operands)


def _sharded(eq: str, local_fn, operands):
    """``local_fn`` (the product ``eq`` spells) on the operands' shards,
    laid out as :func:`einsum` says."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = _active()[0]
    ins, out = eq.replace(" ", "").split("->")
    subs = ins.split(",")
    ops = [_as_dtensor(o, mesh) for o in operands]
    in_pl = [[Replicate()] * mesh.ndim for _ in ops]
    grad_pl = [[Replicate()] * mesh.ndim for _ in ops]
    out_pl = []
    split: dict = {}                      # subscript -> ranks it splits over
    for m in range(mesh.ndim):
        letter = None
        for sub, o in zip(subs, ops):
            p = o.placements[m]
            if isinstance(p, Shard):
                n = split.get(sub[p.dim], 1) * mesh.size(m)
                if o.shape[p.dim] % n == 0:     # even splits only
                    letter = sub[p.dim]
                    break
        if letter is None:
            out_pl.append(Replicate())
            continue
        split[letter] = split.get(letter, 1) * mesh.size(m)
        for i, sub in enumerate(subs):
            if letter in sub:
                in_pl[i][m] = grad_pl[i][m] = Shard(sub.index(letter))
            else:                       # each rank's share of its gradient
                grad_pl[i][m] = Partial()
        out_pl.append(Shard(out.index(letter)) if letter in out else Partial())
    return run_local(local_fn, tuple(ops),
                     tuple(tuple(p) for p in in_pl), out_pl,
                     tuple(tuple(p) for p in grad_pl))


def take_rows(table, ids, gather=None):
    """``table[ids]`` (``gather(table, ids)``: rows of a table), and under
    a plan its sharded form: the table gathered whole (the FSDP
    all-gather) and the rows of each rank's ids taken locally, the output
    laid out as the ids.  ``DTensor``'s own rule for the gather (indexing)
    holds in torch 2.13 (``tools/dtensor_rules.py``) but fails in backward
    in the card's torch 2.11: smollm's step on a (4, 1) mesh, "Shard dim
    -1 in placements (Shard(dim=-1), Replicate()) must be normalized" in
    ``aten.index_put``."""
    gather = gather or (lambda t, i: t[i])
    if _active() is None or not (is_dtensor(table) or is_dtensor(ids)):
        return gather(table, ids)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = _active()[0]
    ids = _as_dtensor(ids, mesh)
    ipl = tuple(p if isinstance(p, Shard) else Replicate() for p in ids.placements)
    rep = (Replicate(),) * mesh.ndim
    tgrad = tuple(Partial() if isinstance(p, Shard) else Replicate() for p in ipl)
    return run_local(gather, (_as_dtensor(table, mesh), ids),
                     (rep, ipl), list(ipl), (tgrad, ipl))


def pick_last(x, idx):
    """``x[..., idx]`` per row: ``torch.gather(x, -1, idx[..., None])[...,
    0]``, and under a plan its sharded form: where ``x``'s last dim is
    split over mesh axes, each rank picks the entries it holds, zeros the
    rest, and the output is a pending sum (``Partial``) over those axes
    (the vocab-sharded cross entropy's gold logit).  ``DTensor``'s own
    rule for ``torch.gather`` fails there in backward (torch 2.13, a 4x2
    mesh: "too many indices for tensor of dimension 2" in smollm's smoke
    step, "... dimension 1" in EGNN's; ``tools/dtensor_rules.py``)."""
    if _active() is None or not (is_dtensor(x) or is_dtensor(idx)):
        return torch.gather(x, -1, idx[..., None])[..., 0]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = _active()[0]
    x = _as_dtensor(x, mesh)
    last = x.ndim - 1
    split = [m for m, p in enumerate(x.placements)
             if isinstance(p, Shard) and p.dim == last]
    x_pl = tuple(p if isinstance(p, Shard) else Replicate() for p in x.placements)
    i_pl = tuple(Replicate() if m in split else p for m, p in enumerate(x_pl))
    out_pl = [Partial() if m in split else p for m, p in enumerate(i_pl)]
    coord = mesh.get_coordinate()

    def local(xl, il):
        n = xl.shape[-1]
        off = 0
        for m in split:
            off = off * mesh.size(m) + coord[m]
        loc = il - off * n
        ok = (loc >= 0) & (loc < n)
        got = torch.gather(xl, -1, loc.clamp(0, n - 1)[..., None])[..., 0]
        return torch.where(ok, got, torch.zeros((), dtype=got.dtype,
                                                 device=got.device))

    return run_local(local, (x, _as_dtensor(idx, mesh)), (x_pl, i_pl), out_pl)


def balanced_range_bounds(weights, n_parts: int) -> list:
    """Contiguous prefix partition of ``weights`` into ``n_parts`` with
    near-equal mass: boundary i lands where the cumulative mass is closest
    to ``i * total / n_parts``.  Returns ``n_parts + 1`` non-decreasing
    indices into [0, len(weights)]; empty parts (repeated bounds) are legal
    when the mass is too lumpy to split.

    Doc-range sharded serving uses this over per-tile posting mass (from the
    skip tables, no decode) to pick the shard boundaries."""
    w = np.asarray(weights, np.float64)
    if n_parts <= 1 or not len(w):
        return [0, len(w)]
    cum = np.concatenate([[0.0], np.cumsum(w)])
    total = cum[-1]
    bounds = [0]
    for i in range(1, n_parts):
        target = total * i / n_parts
        j = int(np.argmin(np.abs(cum - target)))
        bounds.append(max(j, bounds[-1]))
    bounds.append(len(w))
    return bounds


# --------------------------------------------------------------------------- #
# plans
# --------------------------------------------------------------------------- #

DP = ("pod", "data")                # data-parallel axes (pod collapses single-pod)


def lm_dense_plan() -> Plan:
    """Dense LMs (starcoder2, smollm): FSDP + sequence parallelism.

    Head counts (24/36/9) don't divide the 16-way model axis, so attention
    keeps heads local and shards the *sequence* over "model" (KV
    all-gathered -- cheap under GQA with 2-4 KV heads).  Weights
    ZeRO-3-sharded over (DP x model), all-gathered per layer.
    """
    return Plan("lm_dense_sp", {
        "batch": DP,
        "act_seq": ("model",), "act_seq_attn": ("model",),
        "act_seq_ffn": ("model",),
        "act_heads": None, "act_ffn": None, "act_embed": None,
        "act_expert": None, "act_ffn_expert": None,
        "embed": DP, "ffn": ("model",), "vocab": ("model",),
        "heads": None, "kv_heads": None,
    })


def lm_moe_plan(expert_parallel: bool, capacity_parallel: bool = False) -> Plan:
    """MoE LMs: Megatron-SP residual (seq over "model") + TP over heads/ffn
    inside the blocks + FSDP over DP.

    Expert compute, one of three modes:
      * EP (expert_parallel, E >= axis): experts over "model" (deepseek 64e)
      * TP (default): expert hidden dim over "model"
      * CP (capacity_parallel): the capacity dim over "model".
    """
    mode = "_ep" if expert_parallel else ("_cp" if capacity_parallel else "_tp")
    return Plan("lm_moe" + mode, {
        "batch": DP,
        "act_seq": ("model",),            # residual stream: sequence-sharded
        "act_seq_attn": None, "act_seq_ffn": None,
        "act_heads": ("model",), "act_ffn": ("model",), "act_embed": None,
        "act_expert": ("model",) if expert_parallel else None,
        "act_capacity": ("model",) if capacity_parallel else None,
        "act_ffn_expert": None if (expert_parallel or capacity_parallel) else ("model",),
        "embed": DP, "ffn": ("model",), "vocab": ("model",),
        "heads": ("model",), "kv_heads": ("model",),
        "expert": ("model",) if expert_parallel else None,
        "ffn_expert": None if (expert_parallel or capacity_parallel) else ("model",),
    })


def lm_serve_plan(dense: bool) -> Plan:
    """Serving: batch over DP, KV-cache sequence over "model"."""
    rules = {
        "batch": DP, "act_seq": None, "act_seq_attn": None,
        "act_seq_ffn": None, "act_cache": ("model",),
        "embed": DP, "ffn": ("model",), "vocab": ("model",),
        "heads": None if dense else ("model",),
        "kv_heads": None, "act_heads": None if dense else ("model",),
        "act_ffn": None if dense else ("model",),
        "expert": None if dense else ("model",),
        "ffn_expert": None,
        "act_expert": None, "act_ffn_expert": None,
        "act_embed": None,
    }
    return Plan("lm_serve", rules)


def gnn_plan() -> Plan:
    """GNN: edges sharded over all axes (segment-sum + all-reduce), nodes
    replicated or row-sharded where divisible."""
    return Plan("gnn_edge_dp", {
        "batch": DP, "edges": ("pod", "data", "model"), "nodes": None,
        "feat": None, "act_embed": None, "embed": DP, "ffn": ("model",),
    })


def recsys_plan() -> Plan:
    """RecSys: embedding-table rows over "model" (EP), batch over DP axes,
    candidate corpus over "model" for retrieval scoring."""
    return Plan("recsys_ep", {
        "batch": DP, "table_rows": ("model",), "embed_dim": None,
        "act_embed": None, "embed": DP, "ffn": None, "mlp": ("model",),
        "candidates": ("model",),
    })
