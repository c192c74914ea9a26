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
(``transformer.load_reference_params``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import numpy as np
import torch


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
