"""Meshes and the process group (counterpart of the JAX package's
``launch/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names, one process a rank: on the card NCCL, one process
a card (started by ``torchrun`` or a spawn); in tests gloo on the CPU; in
the dry-run the ``"fake"`` backend, a world of 256 or 512 ranks in one
process (no collective moves a byte).  Importing this module touches no
process group: :func:`init_world` starts one, and the launchers and the
smoke call it.

``serving_mesh`` stays what it was: doc-range sharded serving places one
shard a card from one process (a list of devices), with no process group.
"""

from __future__ import annotations

import os
import socket

import numpy as np
import torch


def free_port() -> int:
    """A TCP port on ``localhost`` that was free when asked."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_world(backend: str = "nccl", *, rank: int | None = None,
               world_size: int | None = None, port: int | None = None):
    """Start the default process group, once.

    ``backend``: ``"nccl"`` (the card; the rank's card becomes the current
    device), ``"gloo"`` (the CPU) or ``"fake"`` (the dry-run: a world of
    ``world_size`` in this process, rank 0).  ``rank``/``world_size``
    default to ``torchrun``'s ``RANK``/``WORLD_SIZE``, else a world of 1
    in this process; the address is ``MASTER_ADDR``/``MASTER_PORT`` when
    set, else ``tcp://localhost:<port>`` (a free one when not given).
    Returns (rank, world_size)."""
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if rank is None:
        rank = int(os.environ.get("RANK", 0))
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", 1))
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world_size)
        return rank, world_size
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    if "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        init = "env://"
    else:
        init = f"tcp://localhost:{port or free_port()}"
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world_size)
    return rank, world_size


def shutdown_world() -> None:
    """End the default process group, if one runs."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def launch_mesh(device, *, multi_pod: bool = False, smoke: bool = False):
    """The launchers' mesh, as the reference's: start the process group
    (NCCL on the card, gloo on the CPU; ``torchrun``'s world, else a world
    of 1 in this process), then a ``(world, 1)`` ("data", "model") host
    mesh below 256 ranks (or with ``smoke``), the production mesh from 256
    up or with ``multi_pod`` (which raises on a smaller world).  Returns
    (mesh, this rank's device)."""
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    _, world = init_world(backend)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if backend == "nccl" else torch.device("cpu"))
    if multi_pod or (not smoke and world >= 256):
        return make_production_mesh(multi_pod=multi_pod), dev
    return make_host_mesh((world, 1)), dev


def launch_scope(mesh, plan):
    """The launchers' plan context: ``sharding.plan_scope(mesh, plan)`` on
    a mesh of more than one rank; on one rank none, so the model's
    tensors stay plain (a mesh of one rank splits nothing, and ``DTensor``
    dispatch would only add host time)."""
    import contextlib

    from ..distributed import sharding as shlib
    if mesh.size() == 1:
        return contextlib.nullcontext()
    return shlib.plan_scope(mesh, plan)


def _device_type() -> str:
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_host_mesh(shape=(1, 1), axes=("data", "model"), device_type=None):
    """A mesh of ``shape`` over the first ranks of the running world (the
    reference's small mesh for tests and examples), on the card under
    NCCL, else on the CPU (``device_type`` overrides)."""
    from torch.distributed.device_mesh import DeviceMesh
    import torch.distributed as dist
    n = int(np.prod(shape))
    if dist.get_world_size() < n:
        raise RuntimeError(f"need {n} ranks for mesh {tuple(shape)}; have "
                           f"{dist.get_world_size()}")
    return DeviceMesh(device_type or _device_type(),
                      torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """The reference's production meshes: 16x16 ("data", "model"), or
    2x16x16 ("pod", "data", "model") with ``multi_pod``; raises when the
    world is smaller, naming the shape."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    import torch.distributed as dist
    ndev = int(np.prod(shape))
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < ndev:
        raise RuntimeError(
            f"need {ndev} ranks for mesh {shape}; have {have} (the dry-run "
            f"runs a fake world: python -m repro_torch.launch.dryrun)")
    return make_host_mesh(shape, axes, device_type)


def serving_mesh(n_shards: int):
    """One CUDA device per shard (``[cuda:0, ..., cuda:n-1]``), or None when
    the machine has fewer cards than shards: the engine then runs the
    shards logically on one device, with the same results."""
    if (n_shards < 1 or not torch.cuda.is_available()
            or torch.cuda.device_count() < n_shards):
        return None
    return [torch.device("cuda", i) for i in range(n_shards)]
