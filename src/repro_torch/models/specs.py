"""Parameter specs with logical sharding axes (counterpart of the JAX
package's ``models/specs.py``).

Every parameter is declared once as ``P(shape, axes)`` where ``axes`` are
*logical* names ("embed", "heads", "ffn", "vocab", ...).  A spec tree is a
nested dict whose leaves are ``P``; a parameter tree has the same keys with
tensors for leaves.

``init_params`` draws every leaf from one ``torch.Generator``, leaf after
leaf in the order of a fixed walk (keys sorted at every level, as
``jax.tree.flatten`` orders a dict).  It cannot give ``jax.random``'s
numbers; a test carries the reference's weights across instead
(:func:`load_reference_params`, which each model module re-exports).

A model is a :class:`_Tree` subclass holding its config: the parameter
tree as an ``nn.Module`` under the reference's names.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class P:
    shape: tuple
    axes: tuple                      # logical axis names, len == len(shape)
    init: str = "normal"             # normal | zeros | ones | embed
    scale: Optional[float] = None    # None -> 1/sqrt(fan_in)
    dtype: Any = torch.float32

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map(fn: Callable, tree):
    """``fn`` on every leaf of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict in the walk's order (keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def _init_leaf(spec: P, generator: torch.Generator) -> torch.Tensor:
    dev = generator.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=dev)
    scale = spec.scale
    if scale is None:
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    if spec.init == "embed":
        scale = 0.02
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=dev)
    return x.mul_(scale).to(spec.dtype)


def init_params(specs, generator: torch.Generator) -> Any:
    """Materialize a tree of P specs into tensors on the generator's device,
    each leaf drawn in turn from ``generator``."""
    return tree_map(lambda s: _init_leaf(s, generator), specs)


def abstract_params(specs) -> Any:
    """``device="meta"`` tensors of every leaf's shape and dtype (torch's
    counterpart of a ``ShapeDtypeStruct`` tree): no memory is allocated."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), specs)


def axes_tree(specs) -> Any:
    return tree_map(lambda s: s.axes, specs)


def stack_layers(specs, n_layers: int) -> Any:
    """Add a leading 'layers' dim to every spec in the tree."""
    return tree_map(
        lambda s: P((n_layers,) + s.shape, ("layers",) + s.axes, s.init, s.scale, s.dtype),
        specs)


def count_params(specs) -> int:
    return int(sum(np.prod(s.shape) for s in tree_leaves(specs)))


class _Tree(nn.Module):
    """A nested dict of tensors held as a module: each dict key names a
    submodule or a parameter, so ``named_parameters()`` gives the
    reference's tree paths joined by dots (``dense_layers.attn.wq``)."""

    def __init__(self, tree: dict):
        super().__init__()
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                self.add_module(k, _Tree(v))
            else:
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))

    def tree(self) -> dict:
        """The parameters as the reference's nested dict (no copies)."""
        out = {k: m.tree() for k, m in self.named_children()}
        out.update(self.named_parameters(recurse=False))
        return out


def load_tree(dst: dict, src, path: str = "") -> None:
    """Copy the reference's parameter tree, given as numpy arrays
    (``jax.tree.map(np.asarray, params)``), into the tensors of ``dst`` (a
    model's ``tree()``) on their device.  Every leaf's path, shape and
    dtype must match; a missing or an extra leaf raises."""
    if not isinstance(src, dict):
        raise TypeError(f"{path or 'root'}: expected a dict, got {type(src)}")
    missing, extra = sorted(set(dst) - set(src)), sorted(set(src) - set(dst))
    if missing or extra:
        raise KeyError(f"{path or 'root'}: missing leaves {missing}, extra "
                       f"leaves {extra}")
    for k in sorted(dst):
        d, name = dst[k], f"{path}{k}"
        if isinstance(d, dict):
            load_tree(d, src[k], name + ".")
            continue
        a = np.array(src[k])
        if tuple(a.shape) != tuple(d.shape):
            raise ValueError(f"{name}: shape {a.shape}, model {tuple(d.shape)}")
        want = str(d.dtype).removeprefix("torch.")
        if a.dtype.name != want:
            raise TypeError(f"{name}: dtype {a.dtype.name}, model {want}")
        t = (torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
             if want == "bfloat16" else torch.from_numpy(a))
        d.copy_(t)


def load_reference_params(model: _Tree, tree: dict) -> None:
    """Copy the reference's ``init(...)`` tree, given as numpy arrays
    (``jax.tree.map(np.asarray, params)``), into ``model`` on the model's
    device (:func:`load_tree`: every leaf must match)."""
    load_tree(model.tree(), tree)
