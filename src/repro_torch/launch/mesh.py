"""Device placement for doc-range sharded serving.

Counterpart of ``serving_mesh`` in the JAX package's ``launch/mesh.py``.
The JAX mesh becomes a plain list of torch CUDA devices, one per shard,
which ``QueryEngine.to_device(mesh=...)`` takes.  The production and host
meshes of that module serve the LM path (``ROADMAP.md`` step A.13).
"""

from __future__ import annotations

import torch


def serving_mesh(n_shards: int):
    """One CUDA device per shard (``[cuda:0, ..., cuda:n-1]``), or None when
    the machine has fewer cards than shards: the engine then runs the
    shards logically on one device, with the same results."""
    if (n_shards < 1 or not torch.cuda.is_available()
            or torch.cuda.device_count() < n_shards):
        return None
    return [torch.device("cuda", i) for i in range(n_shards)]
