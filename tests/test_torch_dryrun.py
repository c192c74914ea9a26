"""The port's dry-run (``launch/dryrun.py``), census (``launch/census.py``)
and roofline report, with no card.

A subprocess starts a fake world of 256 ranks (``"fake"`` backend, under
``FakeTensorMode``: no allocation) and runs ``run_cell`` on smollm-135m's
``train_4k`` (its smoke config at 1 layer, the cell cut to 16 x 16) and
dlrm-rm2's ``serve_bulk`` (its smoke config, the cell cut to 4,096 rows)
on the 16x16 mesh, and the census of a sharded product reckoned by hand.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CODE = r"""
import dataclasses, json, sys
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch import configs
from repro_torch.launch import dryrun, mesh as M
from repro_torch.launch.census import Census

out = {}
for arch, shape, dims in (("smollm-135m", "train_4k", {"seq": 16, "batch": 16}),
                          ("dlrm-rm2", "serve_bulk", {"batch": 4096})):
    spec = configs.ARCHS[arch]
    cell = dataclasses.replace(spec.shapes[shape], dims=dims)
    smoke = spec.make_smoke_config
    configs.ARCHS[arch] = dataclasses.replace(
        spec, make_config=(lambda smoke=smoke: dataclasses.replace(smoke(), n_layers=1))
        if arch == "smollm-135m" else smoke, shapes={**spec.shapes, shape: cell})
out["lm"] = dryrun.run_cell("smollm-135m", "train_4k", False)
out["recsys"] = dryrun.run_cell("dlrm-rm2", "serve_bulk", False)
mesh = M.make_production_mesh(device_type="cpu")
with FakeTensorMode() as fake:
    x = DTensor.from_local(torch.empty(64, 4096), mesh, (Shard(0), Replicate()),
                           run_check=False)
    w = DTensor.from_local(torch.empty(4096, 1024), mesh, (Replicate(), Shard(1)),
                           run_check=False)
    for _ in range(2):                  # the first warms sharding propagation
        with Census() as c:
            y = x @ w
    out["product"] = c.result()
    out["product_shape"] = list(y.shape)
    with Census() as c:
        x.redistribute(mesh, (Replicate(), Replicate()))
    out["gather"] = c.result()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_world():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", _CODE], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_census_counts_one_chip_of_a_sharded_product(fake_world):
    """(1024 x 4096) @ (4096 x 16384), rows over "data" and columns over
    "model" of 16x16: one chip multiplies 64 x 4096 by 4096 x 1024, 2 x 64
    x 4096 x 1024 FLOPs (``FlopCounterMode`` counts the global 1.37e11),
    reads 64 x 4096 + 4096 x 1024 floats and writes 64 x 1024, and sends
    nothing."""
    p = fake_world["product"]
    assert fake_world["product_shape"] == [1024, 16384]
    assert p["flops_per_chip"] == 2 * 64 * 4096 * 1024
    assert p["mem_bytes_per_chip"] == 4 * (64 * 4096 + 4096 * 1024 + 64 * 1024)
    assert p["wire_bytes_per_chip"] == 0 and p["collective_counts"] == {}
    g = fake_world["gather"]         # rows gathered over "data": 16 MiB
    assert g["collective_counts"] == {"all-gather": 1}
    assert g["wire_bytes_per_chip"] == 1024 * 4096 * 4


@pytest.mark.parametrize("which,plan", [("lm", "lm_dense_sp"),
                                        ("recsys", "recsys_ep")])
def test_run_cell_on_the_fake_production_mesh(fake_world, which, plan):
    """A smoke config's cell runs one step on the 16x16 mesh: the record's
    plan, per-rank bytes (exact from the local shapes) and census."""
    rec = fake_world[which]
    assert rec["status"] == "ok" and rec["plan"] == plan
    assert rec["mesh"] == [16, 16]
    assert rec["param_bytes_per_device"] > 0 and rec["input_bytes_per_device"] > 0
    c = rec["census"]
    assert c["flops_per_chip"] > 0 and c["mem_bytes_per_chip"] > 0
    assert c["wire_bytes_per_chip"] > 0          # weights gathered
    assert set(c["collective_counts"]) <= {"all-reduce", "all-gather",
                                          "reduce-scatter", "all-to-all",
                                          "collective-permute"}
    if which == "lm":                            # AdamW's m and v, fp32
        assert rec["opt_bytes_per_device"] == 2 * rec["param_bytes_per_device"]


def test_param_bytes_are_the_local_shards():
    """smollm's smoke parameters under ``lm_dense_plan`` on 16x16: the
    bytes a rank holds, from each leaf's local shape."""
    import types

    from repro_torch import configs
    from repro_torch.distributed import sharding as shlib
    from repro_torch.models import transformer as T
    from repro_torch.models.specs import tree_leaves
    spec = configs.get("smollm-135m")
    cfg = spec.make_smoke_config()
    shape = {"data": 16, "model": 16}
    mesh = types.SimpleNamespace(shape=shape, size=lambda m: list(shape.values())[m])
    total = 0
    with shlib.activate(mesh, shlib.lm_dense_plan()):
        for a, p in zip(tree_leaves(T.axes(cfg)), tree_leaves(T.abstract(cfg))):
            pl = shlib.placements(shlib.spec_for(a, dims=tuple(p.shape)), mesh)
            loc = shlib.local_shape(p.shape, pl, mesh)
            total += int(np.prod(loc)) * p.element_size()
    assert total < sum(p.numel() * p.element_size()
                       for p in tree_leaves(T.abstract(cfg)))
    assert total > 0


def test_skipped_cells_and_paths():
    """The three ``long_500k`` cells of pure full attention are skipped
    with the reference's reason (no world is started); the JSON names are
    the reference's."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    skipped = [(a, s) for a, s, c in configs.all_cells() if c.skip_reason]
    assert sorted(skipped) == [("smollm-135m", "long_500k"),
                               ("starcoder2-3b", "long_500k"),
                               ("starcoder2-7b", "long_500k")]
    for a, s in skipped:
        rec = dryrun.run_cell(a, s, True)
        assert rec["status"] == "skipped" and rec["mesh"] == [2, 16, 16]
        assert rec["skip_reason"] == configs.get(a).shapes[s].skip_reason
    assert dryrun.cell_path("d", "egnn", "molecule", True) == os.path.join(
        "d", "egnn__molecule__pod2x16x16.json")
    assert dryrun.cell_path("d", "din", "serve_p99", False) == os.path.join(
        "d", "din__serve_p99__pod16x16.json")


def test_roofline_rows_from_records(tmp_path):
    """The three terms from a record's census over the H100 constants."""
    from repro_torch.launch import roofline_report as R
    rec = {"arch": "smollm-135m", "shape": "train_4k", "mesh": [16, 16],
           "kind": "train", "status": "ok",
           "census": {"flops_per_chip": 2 * R.PEAK, "mem_bytes_per_chip": R.HBM,
                      "wire_bytes_per_chip": 3 * R.IB}}
    (tmp_path / "a.json").write_text(json.dumps(rec))
    (tmp_path / "b.json").write_text(json.dumps({
        "arch": "smollm-135m", "shape": "long_500k", "mesh": [16, 16],
        "status": "skipped", "skip_reason": "x"}))
    rows = {r[1]: r for r in R.rows(str(tmp_path))}
    tc, tm, tl, tn, dom, mf, ratio, frac = rows["train_4k"][3]
    assert (tc, tm, tl, dom) == (2.0, 1.0, 3.0, "collective")
    assert tn == pytest.approx(3 * R.IB / R.NVLINK)
    assert mf == pytest.approx(6.0 * R._lm_params(
        __import__("repro_torch.configs", fromlist=["get"]).get(
            "smollm-135m").make_config())[1] * 256 * 4096)
    assert rows["long_500k"][3] is None
