"""The port's meshes and process group (``launch/mesh.py``), and on the
card the planned train step and dien's full-width retrieval under a plan.

The CPU tests start a gloo world of 1 in this process and end it; the
``cuda`` tests run a world of 1 over NCCL in a subprocess.  No JAX here:
the card tests compare with the port's own unplanned steps.
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

from _torch_parity import cuda_device  # noqa: F401  (fixture)
from repro_torch.launch import mesh as M

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def gloo_world():
    import torch.distributed as dist
    assert not dist.is_initialized()
    M.init_world("gloo")
    try:
        yield
    finally:
        M.shutdown_world()


def test_meshes_of_a_world_of_one(gloo_world):
    """A (1, 1) host mesh with the reference's axis names; the production
    meshes raise naming their shapes; the launchers' mesh is (world, 1)."""
    host = M.make_host_mesh()
    assert host.mesh_dim_names == ("data", "model")
    assert tuple(host.shape) == (1, 1)
    with pytest.raises(RuntimeError, match=r"\(16, 16\)"):
        M.make_production_mesh()
    with pytest.raises(RuntimeError, match=r"\(2, 16, 16\)"):
        M.make_production_mesh(multi_pod=True)
    mesh, dev = M.launch_mesh("cpu", smoke=True)
    assert tuple(mesh.shape) == (1, 1) and dev == torch.device("cpu")
    with pytest.raises(RuntimeError, match=r"need 512 ranks"):
        M.launch_mesh("cpu", multi_pod=True)


def test_launchers_run_a_world_of_one_unplanned(gloo_world):
    """On a mesh of one rank the launchers' scope activates no plan, so
    the model's tensors stay plain (``distribute`` leaves them as they
    are); on a fake mesh of two ranks it activates the arch's plan."""
    import types

    from repro_torch.distributed import sharding as shlib
    mesh, _ = M.launch_mesh("cpu", smoke=True)
    x = torch.zeros(4, 2)
    with M.launch_scope(mesh, shlib.lm_dense_plan()):
        assert not shlib.plan_active()
        assert shlib.distribute(x, ("batch", None)) is x
    two = types.SimpleNamespace(size=lambda: 2, shape={"data": 2, "model": 1})
    with M.launch_scope(two, shlib.lm_dense_plan()):
        assert shlib.plan_active()
        assert shlib.spec_for(("batch", None), dims=(4, 2)) == ("data", None)
    assert not shlib.plan_active()


_CARD = r"""
import torch
from repro_torch import configs
from repro_torch.configs.base import STEP_FNS
from repro_torch.distributed import sharding as shlib
from repro_torch.launch import mesh as M
from repro_torch.launch.batches import smoke_batch
from repro_torch.models import transformer as T
from repro_torch.models.specs import tree_leaves
from repro_torch.optim import adamw_init
import numpy as np

M.init_world("nccl")
try:
    dev = torch.device("cuda", torch.cuda.current_device())
    spec = configs.get("smollm-135m")
    cell = spec.shapes["train_4k"]
    cfg = spec.make_smoke_config()
    batch = smoke_batch(spec, cfg, cell, np.random.default_rng(0), dev)
    step, _ = STEP_FNS["lm"](cfg, cell)
    plain = T.init(cfg, torch.Generator(device=dev).manual_seed(0))
    twin = T.init(cfg, torch.Generator(device=dev).manual_seed(0))
    _, _, m0 = step(plain, adamw_init(plain.tree()), batch)
    mesh = M.make_host_mesh((1, 1))
    with shlib.plan_scope(mesh, spec.plan_for(cfg, cell)):
        dm = shlib.distribute_model(twin, T.axes(cfg))
        db = shlib.distribute_tree(batch, spec.batch_axes(cfg, cell))
        _, _, m1 = step(dm, adamw_init(dm.tree()), db)
        after = [p.full_tensor() for p in tree_leaves(dm.tree())]
    assert torch.equal(m0["loss"], m1["loss"].full_tensor())
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(plain.tree()), after))
    assert all(p.device == dev for p in after)
finally:
    M.shutdown_world()
print("ok")
"""


@pytest.mark.cuda
def test_planned_step_on_the_card_world_of_one(cuda_device):
    """A world of 1 over NCCL: smollm's smoke train step under
    ``lm_dense_plan`` on a (1, 1) mesh bitwise the unplanned step (loss and
    updated parameters) on the card."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", _CARD], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.strip().splitlines()[-1] == "ok"



def test_backward_on_another_thread_recomputes_under_the_plan(gloo_world):
    """Autograd runs a card's backward on its device thread, where the
    plan (a Python thread-local) is not active: each checkpointed layer's
    recomputation still runs under the forward's plan, and the planned
    gradients equal the unplanned ones."""
    import threading

    import numpy as np

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import configs
    from repro_torch.distributed import sharding as shlib
    from repro_torch.launch.batches import smoke_batch
    from repro_torch.models import transformer as T
    from repro_torch.models.specs import tree_leaves
    spec = configs.get("smollm-135m")
    cell = spec.shapes["train_4k"]
    cfg = spec.make_smoke_config()
    batch = smoke_batch(spec, cfg, cell, np.random.default_rng(0), "cpu")
    model = T.init(cfg, torch.Generator().manual_seed(0))
    with model.grads_on() as p:
        loss, _ = T.loss_fn(model, batch["tokens"], batch["labels"])
        want = torch.autograd.grad(loss, tree_leaves(p))
    got = {}
    with shlib.plan_scope(M.make_host_mesh(), spec.plan_for(cfg, cell)):
        dm = shlib.distribute_model(model, T.axes(cfg))
        db = shlib.distribute_tree(batch, spec.batch_axes(cfg, cell))
        with dm.grads_on() as p:
            loss, _ = T.loss_fn(dm, db["tokens"], db["labels"])
            leaves = tree_leaves(p)

            def backward():
                # the engine hands its threads torch's own thread state
                # (``implicit_replication``'s flag), not Python's
                with implicit_replication():
                    got["grads"] = torch.autograd.grad(loss, leaves)
            t = threading.Thread(target=backward)
            t.start()
            t.join()
    assert all(torch.equal(g.full_tensor(), w)
               for g, w in zip(got["grads"], want))


_DIEN = r"""
import time
import numpy as np
import torch
from repro_torch import configs
from repro_torch.configs.base import STEP_FNS
from repro_torch.distributed import sharding as shlib
from repro_torch.launch import mesh as M
from repro_torch.launch.batches import cell_batch
from repro_torch.models import recsys as R

M.init_world("nccl")
try:
    dev = torch.device("cuda", torch.cuda.current_device())
    spec = configs.get("dien")
    cell = spec.shapes["retrieval_cand"]
    cfg = spec.config_for_cell(spec.make_config(), cell)
    batch = cell_batch(spec, cfg, cell, np.random.default_rng(0), dev)
    step, _ = STEP_FNS["recsys"](cfg, cell)
    model = R.init(cfg, torch.Generator(device=dev).manual_seed(0))
    s0, i0 = step(model, batch)
    mesh, _ = M.launch_mesh("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with shlib.plan_scope(mesh, spec.plan_for(cfg, cell)):
        dm = shlib.distribute_model(model, R.axes(cfg))
        s1, i1 = step(dm, shlib.distribute_tree(batch, spec.batch_axes(cfg, cell)))
        s1, i1 = s1.full_tensor(), i1.full_tensor()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    err = float((s1 - s0).abs().max() / s0.abs().max())
    rank = torch.distributed.get_rank()
    assert i1.shape == (100,) and torch.equal(i0, i1) and err < 1e-6, err
    assert peak < 40, peak
    if rank == 0:                       # one rank writes: lines stay whole
        print(f"dien retrieval_cand planned on {tuple(mesh.shape)}: "
              f"{batch['cand_items'].shape[0]} candidates in "
              f"{time.perf_counter() - t0:.1f} s, peak {peak:.2f} GiB, "
              f"top {i1.shape[0]} ids equal, score err {err:.3e}", flush=True)
finally:
    M.shutdown_world()
if rank == 0:
    print("ok")
"""


@pytest.mark.cuda
def test_dien_retrieval_at_full_width_under_a_plan_on_the_card(cuda_device,
                                                               tmp_path):
    """dien's ``retrieval_cand`` step at its full config (1,000,000
    candidates) under ``recsys_plan`` on the launchers' ``(world, 1)``
    mesh, one rank a card (``torchrun``; a world of 1 on one card): each
    rank takes ``ROW_CHUNK`` of its own candidates a pass (one pass over
    every candidate would hold about 86 GB of GRU states), so its peak
    stays under 40 GiB, and the top 100 equals the unplanned step's (ids
    equal, scores within 1e-6)."""
    script = tmp_path / "dien_retrieval.py"
    script.write_text(_DIEN)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run",
                        "--standalone", "--nproc-per-node",
                        str(torch.cuda.device_count()), str(script)],
                       env=env, capture_output=True, text=True, timeout=900)
    print(r.stdout)
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.strip().splitlines()[-1] == "ok", r.stdout
