"""Per-chip roofline accounting of one step, from the ops a rank runs
(the port's counterpart of the JAX package's ``launch/hlo_census.py``).

The reference parses the compiled, partitioned HLO: per-device shapes,
while-loop trip counts, fused computations.  The port has no compiled
module: it runs the step eagerly, one process a rank (under the dry-run,
a fake world and ``FakeTensorMode``: no allocation, no data), and
:class:`Census` counts every ATen op the rank runs on its LOCAL tensors:

  * FLOPs: ``torch.utils.flop_counter``'s formulas (matmuls, convolutions,
    attention) on the local shapes.  ``FlopCounterMode`` itself sits above
    ``DTensor`` and counts each sharded op at its global shape, 256 or 512
    times one chip's work; :class:`Census` steps aside for ``DTensor``
    arguments (it returns ``NotImplemented``), so it sees the local ops
    ``DTensor`` runs beneath.  ``DTensor``'s sharding propagation runs
    each new (op, shapes, placements) once at its global shapes and
    caches it: count a step's second run (the dry-run does).
  * Bytes of memory traffic: the operand plus result bytes of each op
    that moves memory (views and metadata ops are free).  Eager torch
    fuses nothing, so this is an upper bound on what a fused program
    reads and writes (the reference counts after XLA's fusion).
  * Wire bytes: each collective's result bytes times the reference's
    ``_WIRE_FACTOR`` (ring algorithms: an all-reduce moves twice its
    result, the others once), per kind, with their counts.

Python loops are unrolled as they run, so there is no trip count to
recover: a layer loop of 30 counts 30 layers.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
_WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}

# functional-collective ops (``torch.ops._c10d_functional``) by kind
_COLL_OPS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}

# ops that move no memory: views, metadata, waits
_FREE = {
    "view", "_unsafe_view", "reshape", "expand", "transpose", "t", "permute",
    "slice", "select", "as_strided", "unsqueeze", "squeeze", "detach",
    "alias", "split", "split_with_sizes", "unbind", "chunk", "narrow",
    "view_as_real", "view_as_complex", "_reshape_alias", "diagonal",
    "unfold", "empty", "empty_like", "empty_strided", "new_empty",
    "new_empty_strided", "lift_fresh", "wait_tensor", "sym_size",
    "sym_stride", "sym_numel", "is_same_size", "_local_scalar_dense",
    "set_", "resize_", "_to_copy_meta",
}


def _bytes(tree) -> int:
    from torch.utils._pytree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class Census(TorchDispatchMode):
    """Counts FLOPs, memory bytes and collectives of the ATen ops run on
    plain (local) tensors while the mode is on; ``DTensor`` ops pass
    through to their local ops.  Read :meth:`result`."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops_of = flop_registry
        self.flops = 0
        self.mem_bytes = 0
        self.coll_bytes: dict = {}
        self.coll_count: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t is not torch.Tensor and issubclass(t, torch.Tensor)
               and t.__name__ == "DTensor" for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        name = func._overloadpacket.__name__
        kind = _COLL_OPS.get(name)
        if kind is not None:
            b = _bytes(out)
            self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) + b
            self.coll_count[kind] = self.coll_count.get(kind, 0) + 1
            return out
        fl = self._flops_of.get(func._overloadpacket)
        if fl is not None:
            self.flops += int(fl(*args, **kwargs, out_val=out))
        if name not in _FREE and func.namespace != "prim":   # prim: metadata
            self.mem_bytes += _bytes(args) + _bytes(kwargs) + _bytes(out)
        return out

    def result(self) -> dict:
        wire = sum(_WIRE_FACTOR[k] * v for k, v in self.coll_bytes.items())
        return {
            "flops_per_chip": float(self.flops),
            "mem_bytes_per_chip": float(self.mem_bytes),
            "collective_bytes_per_chip": dict(self.coll_bytes),
            "collective_counts": dict(self.coll_count),
            "wire_bytes_per_chip": float(wire),
        }


def census(fn, *args, **kwargs):
    """``(fn(*args, **kwargs), the census of the ops it ran)``."""
    with Census() as c:
        out = fn(*args, **kwargs)
    return out, c.result()
