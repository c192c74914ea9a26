"""Atomic checkpoints in the JAX package's on-disk layout (counterpart of
its ``checkpoint/checkpointer.py``).

Layout per step::

    <dir>/step_000123.tmp/...   (written first)
    <dir>/step_000123/          (atomic rename on success)
        manifest.json           {step, keys, shapes, dtypes, sha256}
        arrays.npz              flat param/opt arrays
        extra.json              data cursor, arbitrary metadata

A state is a nested structure of dicts (keys sorted, as ``jax.tree``
walks them), tuples and lists of tensors; a leaf's key is its path joined
by ``/`` (``0/embed``, ``1/m/...``, ``1/step``), the reference's keys, so
a checkpoint of either package restores into the other's state.  A bf16
leaf goes to disk as the reference's does: numpy has no bfloat16, and the
reference's ``ml_dtypes`` array is written as 2-byte void (``|V2``); the
port writes the same bytes under the same ``descr`` and reads a 2-byte
leaf back through a ``uint16`` view (the reference's own restore cannot
cast ``|V2`` back: ROADMAP.md §C).  Integrity: every array's bytes are
sha256'd into the manifest; a truncated or bit-flipped checkpoint is
detected and the previous step is used instead.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil

import numpy as np
import torch


def _is_sharding(x) -> bool:
    """A ``(mesh, placements)`` leaf of a shardings tree."""
    return (isinstance(x, tuple) and len(x) == 2
            and hasattr(x[0], "mesh_dim_names"))


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()


def _flatten_with_paths(tree, prefix: str = "", leaf=None) -> dict:
    """{"a/b/0": leaf} in the walk's order (dict keys sorted)."""
    if leaf is not None and leaf(tree):
        return {prefix: tree}
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten_with_paths(v, f"{prefix}/{k}" if prefix else k,
                                       leaf))
    return out


def _unflatten_like(tree, leaves: dict, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _unflatten_like(tree[k], leaves,
                                   f"{prefix}/{k}" if prefix else str(k))
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten_like(v, leaves,
                                          f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return leaves[prefix]


def _to_numpy(t) -> np.ndarray:
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    if hasattr(t, "full_tensor"):           # a DTensor: the whole tensor
        t = t.full_tensor()
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:           # ml_dtypes' bytes, written as |V2
        return t.view(torch.int16).numpy().view(np.uint16).view("V2")
    return t.numpy()


def _to_tensor(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """The disk array as a tensor of ``like``'s dtype on its device."""
    a = np.ascontiguousarray(a).reshape(a.shape)    # keeps a 0-d leaf 0-d
    if like.dtype == torch.bfloat16:
        if a.dtype.itemsize != 2:
            raise TypeError(f"a bf16 leaf needs 2-byte words, got {a.dtype}")
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a).to(like.dtype)
    return t.to(like.device)


def latest_step(directory: str):
    if not os.path.isdir(directory):
        return None
    return max(_steps(directory), default=None)


def _steps(directory: str) -> list:
    """The finished steps in ``directory``, ascending (a ``step_*`` name
    that does not parse is skipped, as the reference's ``latest_step``
    skips it)."""
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                steps.append(int(name.split("_")[1]))
            except ValueError:
                continue
    return sorted(steps)


@dataclasses.dataclass
class Checkpointer:
    directory: str
    keep: int = 3

    def save(self, step: int, state, extra: dict | None = None) -> str:
        """Write ``state`` as step ``step``.  A ``DTensor`` leaf is written
        whole (the same bytes and keys as an unsharded save); with a
        process group every rank calls ``save`` (the gathers are
        collectives), rank 0 writes, and all wait for it."""
        arrays = {k: _to_numpy(v) for k, v in _flatten_with_paths(state).items()}
        final = os.path.join(self.directory, f"step_{step:06d}")
        if _rank() == 0:
            self._write(final, step, arrays, extra)
        _barrier()
        return final

    def _write(self, final: str, step: int, arrays: dict, extra) -> None:
        os.makedirs(self.directory, exist_ok=True)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        manifest = {
            "step": step,
            "keys": sorted(arrays),
            "shapes": {k: list(v.shape) for k, v in arrays.items()},
            "dtypes": {k: _dtype_name(v) for k, v in arrays.items()},
            "sha256": {k: hashlib.sha256(v.tobytes()).hexdigest()
                       for k, v in arrays.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "extra.json"), "w") as f:
            json.dump(extra or {}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                       # atomic publish
        self._gc()

    def _gc(self):
        for s in _steps(self.directory)[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:06d}"),
                          ignore_errors=True)

    def _verify(self, path: str) -> dict:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        data = np.load(os.path.join(path, "arrays.npz"))
        out = {}
        for k in manifest["keys"]:
            blob = data[k]
            if hashlib.sha256(blob.tobytes()).hexdigest() != manifest["sha256"][k]:
                raise IOError(f"checkpoint corruption detected: {path}:{k}")
            out[k] = blob
        return out

    def restore(self, state_template, step: int | None = None,
                shardings=None):
        """Restore into the structure of ``state_template`` (new tensors of
        each template leaf's dtype, on its device).  Skips corrupted
        checkpoints (falls back to older steps).  Returns (state, step,
        extra).

        shardings (optional): a tree like the template of ``(mesh,
        placements)`` leaves (``sharding.sharding_for_axes_tree``): each
        leaf comes back a ``DTensor`` on that mesh, every rank keeping its
        shard, whatever mesh wrote it (the elastic reshard); a rank outside
        the mesh gets None.  A ``DTensor`` template leaf with no entry
        comes back laid out as the template."""
        step = step if step is not None else latest_step(self.directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        last_err = None
        for s in [s for s in reversed(_steps(self.directory)) if s <= step]:
            path = os.path.join(self.directory, f"step_{s:06d}")
            try:
                arrays = self._verify(path)
                break
            except Exception as e:   # corrupted -> try previous
                last_err = e
        else:
            raise IOError(f"no intact checkpoint found: {last_err}")
        shard_of = (_flatten_with_paths(shardings, leaf=_is_sharding)
                    if shardings is not None else {})
        leaves = {}
        for k, tmpl in _flatten_with_paths(state_template).items():
            arr = arrays[k]
            assert tuple(arr.shape) == tuple(tmpl.shape), (k, arr.shape, tmpl.shape)
            leaves[k] = _to_tensor(arr, tmpl)
            if k not in shard_of and hasattr(tmpl, "placements"):
                shard_of[k] = (tmpl.device_mesh, tuple(tmpl.placements))
            if k in shard_of:
                from ..distributed.sharding import from_full
                mesh, pl = shard_of[k]
                leaves[k] = from_full(leaves[k], mesh, pl)
        with open(os.path.join(path, "extra.json")) as f:
            extra = json.load(f)
        return _unflatten_like(state_template, leaves), s, extra


def _dtype_name(a: np.ndarray) -> str:
    """The manifest's dtype: the reference's name (``bfloat16`` for a 2-byte
    void leaf, which only a bf16 tensor writes)."""
    return "bfloat16" if a.dtype == np.dtype("V2") else str(a.dtype)
