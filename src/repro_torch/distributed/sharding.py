"""Contiguous range partitioning for doc-range sharded serving.

Counterpart of ``balanced_range_bounds`` in the JAX package's
``distributed/sharding.py`` (numpy inside there too).  The logical-axis
sharding plans of that module (``Plan``, ``spec_for``, ``lm_*_plan``) serve
the LM path and wait for ``ROADMAP.md`` step A.13.
"""

from __future__ import annotations

import numpy as np


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
