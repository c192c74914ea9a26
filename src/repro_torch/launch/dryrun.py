"""Multi-pod dry-run: run one step of every (arch x shape) cell on the
production meshes (16x16 single-pod, 2x16x16 multi-pod) with no card and
no allocation (counterpart of the JAX package's ``launch/dryrun.py``).

The reference lowers and compiles each cell on 512 forced host devices.
Here the cell's step runs eagerly as ONE rank of a fake world of 256 or
512 (``torch.distributed``'s ``"fake"`` backend: every collective returns
at once and moves nothing) under ``FakeTensorMode`` (tensors carry shape,
dtype and layout, no data): parameters, optimizer state and inputs are
``DTensor``s laid out by the cell's plan, each rank holding only its
shard's shape.  A sharding mismatch or an op without a sharded form
fails here.  The step runs twice: the first run warms ``DTensor``'s
sharding propagation (which runs each new op once at its global shape),
the second is counted.

Per cell it records: the plan; the bytes a rank holds of parameters,
optimizer state and inputs, exact from the local shapes
(``param_bytes_per_device`` is the reference's key); the collectives by
kind, their count and bytes (``CommDebugMode`` counts, the census's
shapes); and the per-chip FLOPs, memory bytes and wire bytes of
``launch/census.py``.  Results are JSON files under ``--out``, one a cell
and mesh (``cell_path``, incremental; ``--force`` redoes), with a
``.err`` file for a failure.  ``--all`` drives every cell in a
subprocess each (``--jobs`` at a time).

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--mesh both] --out experiments/dryrun_torch
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import subprocess
import sys
import time


def cell_path(out_dir: str, arch: str, shape: str, multi_pod: bool) -> str:
    mesh = "pod2x16x16" if multi_pod else "pod16x16"
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh}.json")


def _abstract_tree(metas, axes):
    """``DTensor``s of a tree of ``meta`` tensors' shapes and dtypes laid
    out by the active plan (``sharding_for_axes_tree``), each local shard
    an empty tensor (fake under ``FakeTensorMode``)."""
    import torch
    from torch.distributed.tensor import DTensor
    from ..distributed import sharding as shlib

    def one(meta, sharding):
        if isinstance(meta, dict):
            return {k: one(meta[k], sharding[k]) for k in sorted(meta)}
        mesh, pl = sharding
        local = torch.empty(shlib.local_shape(meta.shape, pl, mesh),
                            dtype=meta.dtype)
        return DTensor.from_local(local, mesh, pl, run_check=False,
                                  shape=meta.shape, stride=torch.empty(
                                      meta.shape, device="meta").stride())

    return one(metas, shlib.sharding_for_axes_tree(axes, metas))


def local_bytes(tree) -> int:
    """Bytes of the local shards of a tree of (``DTensor``) leaves."""
    from ..models.specs import tree_leaves
    out = 0
    for t in tree_leaves(tree):
        loc = t.to_local() if hasattr(t, "to_local") else t
        out += loc.numel() * loc.element_size()
    return out


def run_cell(arch_id: str, shape_name: str, multi_pod: bool) -> dict:
    """Run one cell's step on a fake production mesh; its record."""
    from .. import configs
    spec = configs.get(arch_id)
    cell = spec.shapes[shape_name]
    record = {
        "arch": arch_id, "shape": shape_name,
        "mesh": [2, 16, 16] if multi_pod else [16, 16],
        "kind": cell.kind, "dims": {k: v for k, v in cell.dims.items()
                                    if isinstance(v, (int, float, str))},
    }
    if cell.skip_reason:
        record["status"] = "skipped"
        record["skip_reason"] = cell.skip_reason
        return record

    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.debug import CommDebugMode
    from ..configs.base import STEP_FNS
    from ..distributed import sharding as shlib
    from ..models import egnn, recsys, transformer
    from ..optim import adamw_init
    from .census import Census
    from .mesh import init_world, make_production_mesh

    init_world("fake", world_size=512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    cfg = spec.config_for_cell(spec.make_config(), cell)
    plan = spec.plan_for(cfg, cell)
    record["plan"] = plan.name
    mod = {"lm": transformer, "gnn": egnn, "recsys": recsys}[spec.family]
    cls = {"lm": transformer.LM, "gnn": egnn.EGNN, "recsys": recsys.RecModel}[spec.family]

    t0 = time.time()
    with FakeTensorMode(), shlib.plan_scope(mesh, plan):
        params = _abstract_tree(mod.abstract(cfg), mod.axes(cfg))
        model = cls(cfg, params)
        inputs = spec.input_specs(cfg, cell)
        b_axes = spec.batch_axes(cfg, cell)
        pos = None
        if "pos" in inputs:             # decode: the last slot of the cache
            pos = cell.dims["seq"] - 1
            inputs, b_axes = ({k: v for k, v in d.items() if k != "pos"}
                              for d in (inputs, b_axes))
        batch = _abstract_tree(inputs, b_axes)
        if pos is not None:
            batch["pos"] = pos
        step, is_train = STEP_FNS[spec.family](cfg, cell)
        opt = adamw_init(model.tree()) if is_train else None
        record["param_bytes_per_device"] = local_bytes(params)
        record["input_bytes_per_device"] = local_bytes(
            {k: v for k, v in batch.items() if k != "pos"})
        if opt is not None:
            record["opt_bytes_per_device"] = local_bytes(
                {k: v for k, v in opt.items() if k != "step"})

        def run():
            return step(model, opt, batch) if is_train else step(model, batch)

        run()                                   # warms sharding propagation
        record["lower_s"] = round(time.time() - t0, 2)
        t1 = time.time()
        with CommDebugMode() as comm, Census() as cen:
            run()
        record["run_s"] = round(time.time() - t1, 2)
    c = cen.result()
    record["census"] = c
    record["collectives"] = {
        "per_kind_bytes": c["collective_bytes_per_chip"],
        "per_kind_count": c["collective_counts"],
        "comm_debug_counts": {str(k): int(v) for k, v in
                              comm.get_comm_counts().items()},
        "wire_bytes_per_chip": c["wire_bytes_per_chip"],
    }
    print("census: flops/chip=%.3e mem/chip=%.3e wire/chip=%.3e" % (
        c["flops_per_chip"], c["mem_bytes_per_chip"], c["wire_bytes_per_chip"]))
    record["status"] = "ok"
    return record


def _run_one(aid: str, sname: str, mp: bool, out: str, timeout: int) -> tuple:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", aid,
           "--shape", sname, "--out", out] + (["--multi-pod"] if mp else [])
    t0 = time.time()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
        ok, log = r.returncode == 0, r.stdout[-5000:] + "\n" + r.stderr[-10000:]
    except subprocess.TimeoutExpired as e:
        ok, log = False, f"timed out after {timeout} s\n{e.stderr or ''}"
    if not ok:
        with open(cell_path(out, aid, sname, mp) + ".err", "w") as f:
            f.write(log)
    return aid, sname, mp, ok, time.time() - t0


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", dest="multi_pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both",
                    help="which meshes to run with --all")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--timeout", type=int, default=3000)
    ap.add_argument("--jobs", type=int, default=2,
                    help="cells run at once with --all")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    if args.all:
        from .. import configs
        meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
        todo = [(aid, sname, mp) for aid, sname, _ in configs.all_cells()
                for mp in meshes
                if args.force or not os.path.exists(cell_path(args.out, aid, sname, mp))]
        print(f"[dryrun] {len(todo)} cells to run", flush=True)
        fails = []
        with cf.ThreadPoolExecutor(args.jobs) as ex:
            futs = [ex.submit(_run_one, *t, args.out, args.timeout) for t in todo]
            for i, f in enumerate(cf.as_completed(futs)):
                aid, sname, mp, ok, dt = f.result()
                mesh = "2x16x16" if mp else "16x16"
                print(f"[{i + 1}/{len(todo)}] {aid} x {sname} x {mesh}: "
                      f"{'ok' if ok else 'FAILED'} ({dt:.0f}s)", flush=True)
                if not ok:
                    fails.append((aid, sname, mp))
        print(f"[dryrun] done; {len(fails)} failures: {fails}")
        sys.exit(1 if fails else 0)

    record = run_cell(args.arch, args.shape, args.multi_pod)
    path = cell_path(args.out, args.arch, args.shape, args.multi_pod)
    with open(path, "w") as f:
        json.dump(record, f, indent=2)
    print(json.dumps({k: v for k, v in record.items() if k != "collectives"}, indent=2))
    print("->", path)


if __name__ == "__main__":
    main()
