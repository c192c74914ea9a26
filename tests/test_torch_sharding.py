"""The port's sharding plans against the JAX package's, with no process.

For every one of the 40 cells of ``configs.all_cells()``, on both
production meshes and on a 4x2 host mesh, every parameter leaf's and
every batch leaf's ``spec_for`` (with the divisibility guard on its
shape) equals the reference's ``PartitionSpec`` entry by entry.  The
reference's ``spec_for`` needs only ``mesh.shape``, so both run under
``activate(SimpleNamespace(shape=...), plan)``: no devices.  Also the
placements of a spec, and ``shard``/``spec_for`` without a plan.
"""

from __future__ import annotations

import types

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro import configs as ref_configs
from repro.distributed import sharding as ref_sh
from repro.models import egnn as ref_egnn
from repro.models import recsys as ref_recsys
from repro.models import transformer as ref_T
from repro_torch import configs
from repro_torch.distributed import sharding as shlib
from repro_torch.models import egnn, recsys, transformer

MESHES = {
    "pod16x16": {"data": 16, "model": 16},
    "pod2x16x16": {"pod": 2, "data": 16, "model": 16},
    "host4x2": {"data": 4, "model": 2},
}
REF_MODS = {"lm": ref_T, "gnn": ref_egnn, "recsys": ref_recsys}
MODS = {"lm": transformer, "gnn": egnn, "recsys": recsys}


def _leaves(axes, shapes, prefix=""):
    """[(path, logical axes, shape)] of a tree of axes tuples."""
    if isinstance(axes, dict):
        return [x for k in sorted(axes)
                for x in _leaves(axes[k], shapes[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tuple(axes), tuple(shapes.shape))]


def _specs(sh, mesh: dict, plan, leaves) -> dict:
    with sh.activate(types.SimpleNamespace(shape=mesh), plan):
        return {p: tuple(sh.spec_for(a, dims=s)) for p, a, s in leaves}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", [(a, s) for a, s, _ in
                                        ref_configs.all_cells()])
def test_spec_for_equals_the_reference_on_every_leaf(arch, shape, mesh):
    ref, spec = ref_configs.get(arch), configs.get(arch)
    cell, rcell = spec.shapes[shape], ref.shapes[shape]
    cfg = spec.config_for_cell(spec.make_config(), cell)
    rcfg = ref.config_for_cell(ref.make_config(), rcell)
    plan, rplan = spec.plan_for(cfg, cell), ref.plan_for(rcfg, rcell)
    assert (plan.name, plan.rules) == (rplan.name, rplan.rules)
    rm, m = REF_MODS[ref.family], MODS[spec.family]
    params = _leaves(m.axes(cfg), m.abstract(cfg))
    rparams = _leaves(rm.axes(rcfg), rm.abstract(rcfg))
    assert params == rparams                      # paths, axes and shapes
    batch = _leaves(spec.batch_axes(cfg, cell), spec.input_specs(cfg, cell))
    rbatch = _leaves(ref.batch_axes(rcfg, rcell), ref.input_specs(rcfg, rcell))
    assert batch == rbatch
    shape_ = MESHES[mesh]
    got = _specs(shlib, shape_, plan, params + batch)
    want = _specs(ref_sh, shape_, rplan, rparams + rbatch)
    assert got == want


def test_placements_of_a_spec():
    """One ``Shard(d)`` per mesh axis a dim names (in mesh order), a
    replicated one elsewhere and on an axis of one rank."""
    mesh = types.SimpleNamespace(shape={"pod": 2, "data": 16, "model": 16})
    assert shlib.placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert shlib.placements((None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    assert shlib.placements((), mesh) == (Replicate(),) * 3
    one = types.SimpleNamespace(shape={"data": 1, "model": 4})
    assert shlib.placements(("data", "model"), one) == (Replicate(), Shard(1))
    with pytest.raises(AssertionError, match="mesh order"):
        shlib.placements((("data", "pod"),), mesh)


def test_no_plan_no_layout():
    """Without an active plan ``spec_for`` is empty, ``shard``,
    ``einsum``, ``matmul``, ``take_rows`` and ``pick_last`` are the plain
    ops, and ``distribute`` leaves a tensor as it is."""
    x = torch.arange(12.0).reshape(3, 4)
    assert shlib.spec_for(("batch", "embed")) == ()
    assert shlib.shard(x, "batch", None) is x
    assert torch.equal(shlib.einsum("ij,jk->ik", x, x.T), x @ x.T)
    assert torch.equal(shlib.matmul(x, x.T), x @ x.T)
    assert torch.equal(shlib.pick_last(x, torch.tensor([3, 0, 1])),
                       torch.tensor([3.0, 4.0, 9.0]))
    assert torch.equal(shlib.take_rows(x, torch.tensor([2, 0])), x[[2, 0]])
    assert shlib.distribute(x, ("batch", None)) is x


def test_activate_nests_and_restores():
    a = types.SimpleNamespace(shape={"data": 4, "model": 2})
    b = types.SimpleNamespace(shape={"data": 2, "model": 2})
    with shlib.activate(a, shlib.lm_dense_plan()):
        assert shlib.spec_for(("batch",), dims=(8,)) == ("data",)
        with shlib.activate(b, shlib.recsys_plan()):
            assert shlib.spec_for(("table_rows",), dims=(6,)) == ("model",)
        assert shlib.spec_for(("vocab",), dims=(6,)) == ("model",)
        assert shlib.spec_for(("batch",), dims=(6,)) == (None,)   # 6 % 4
    assert shlib._active() is None
