"""Which sharded ops of the port need their hand-written forms: each
family's smoke train step under its plan on a 4x2 ("data", "model") gloo
mesh of 8 CPU ranks, against the unplanned step, with the port's forms or
with ``DTensor``'s own rules in their place.

  PYTHONPATH=src python tools/dtensor_rules.py [--modes port,products,rows,all]

Modes: ``port`` (the port as it is); ``products`` (``torch.einsum`` and
``@`` for ``sharding.einsum`` and ``matmul``); ``rows`` (also indexing
for ``take_rows``); ``all`` (also ``torch.gather`` for ``pick_last``).
Cases: the smoke train batch of smollm-135m (2 x 32 tokens),
deepseek-v2-lite-16b (experts over "model"), mixtral-8x22b, din,
dlrm-rm2, dien and EGNN, and smollm on 4 x 31 tokens (a sequence that
"model" does not split).  Prints one JSON object: per mode and case the loss difference and the largest gradient
difference (over the larger of its leaf's largest magnitude and 1e-3 of
every leaf's), or the error and the port's frame that raised it.
"""

from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys
import traceback

import numpy as np

WORLD = 8
CASES = [("smollm-135m", None), ("deepseek-v2-lite-16b", None),
         ("mixtral-8x22b", None), ("din", None), ("dlrm-rm2", None),
         ("dien", None), ("egnn", None), ("smollm-135m", (4, 31))]


def _patch(mode: str) -> None:
    import torch

    from repro_torch.distributed import sharding as shlib
    from repro_torch.models import attention as A
    from repro_torch.models import egnn as E
    from repro_torch.models import moe
    from repro_torch.models import recsys as R
    from repro_torch.models import transformer as T
    if mode in ("products", "rows", "all"):
        T.einsum = A.einsum = moe.einsum = torch.einsum
        R.matmul = E.matmul = lambda x, w: x @ w
    if mode in ("rows", "all"):
        def take(t, i, gather=None):
            return (gather or (lambda a, b: a[b]))(t, i)
        T.take_rows = shlib.take_rows = take
    if mode == "all":
        T.pick_last = E.pick_last = (
            lambda x, idx: torch.gather(x, -1, idx[..., None])[..., 0])


def _case(arch: str, tokens, mesh) -> dict:
    """``tokens`` (an LM's batch, sequence): tokens drawn in place of the
    smoke batch's."""
    import torch

    from repro_torch import configs
    from repro_torch.distributed import sharding as shlib
    from repro_torch.launch.batches import smoke_batch
    from repro_torch.models import egnn as E
    from repro_torch.models import recsys as R
    from repro_torch.models import transformer as T
    from repro_torch.models.specs import tree_leaves
    from repro_torch.runtime.trainer import value_and_grad
    spec = configs.get(arch)
    cell = [c for c in spec.shapes.values() if c.kind == "train"][0]
    cfg = spec.config_for_cell(spec.make_smoke_config(), cell)
    mod = {"lm": T, "gnn": E, "recsys": R}[spec.family]
    model = mod.init(cfg, torch.Generator().manual_seed(0))
    batch = smoke_batch(spec, cfg, cell, np.random.default_rng(3), "cpu")
    if tokens is not None:
        t = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab, (tokens[0], tokens[1] + 1)), dtype=torch.int32)
        batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    if spec.family == "lm":
        def lf(m, b):
            return T.loss_fn(m, b["tokens"], b["labels"])
    else:
        lf = mod.loss_fn
    (l0, _), g0 = value_and_grad(lf, model, batch)
    g0 = tree_leaves(g0)
    full = (lambda t: t.full_tensor() if shlib.is_dtensor(t) else t)
    try:
        with shlib.plan_scope(mesh, spec.plan_for(cfg, cell)):
            dm = shlib.distribute_model(model, mod.axes(cfg))
            db = shlib.distribute_tree(batch, spec.batch_axes(cfg, cell))
            (l1, _), g1 = value_and_grad(lf, dm, db)
            l1, g1 = full(l1), [full(g) for g in tree_leaves(g1)]
    except Exception as e:              # the finding: which op has no rule
        frames = [ln.strip() for ln in traceback.format_exc().splitlines()
                  if "repro_torch" in ln]
        return {"error": f"{type(e).__name__}: {str(e).splitlines()[0][:300]}",
                "at": frames[-1] if frames else None}
    top = max(float(w.abs().max()) for w in g0)
    return {"loss_err": abs(float(l1) - float(l0)),
            "grad_err": max(float((a - b).abs().max())
                            / max(float(b.abs().max()), 1e-3 * top)
                            for a, b in zip(g1, g0))}


def _rank(rank: int, port: int, mode: str) -> None:
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch import mesh as M
    _patch(mode)
    M.init_world("gloo", rank=rank, world_size=WORLD, port=port)
    try:
        mesh = M.make_host_mesh((4, 2), ("data", "model"))
        res = {f"{a} {t[0]}x{t[1]}" if t else a: _case(a, t, mesh)
               for a, t in CASES}
    finally:
        M.shutdown_world()
    if rank == 0:
        print(json.dumps(res), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", default="port,products,rows,all")
    args = ap.parse_args()
    out = {}
    for mode in args.modes.split(","):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r),
                                   str(port), mode],
                                  stdout=subprocess.PIPE if r == 0 else
                                  subprocess.DEVNULL,
                                  stderr=subprocess.DEVNULL, text=True)
                 for r in range(WORLD)]
        try:
            text = procs[0].communicate(timeout=900)[0]
            codes = [p.wait(timeout=60) for p in procs]
        finally:
            for p in procs:
                p.kill()
        if any(codes):
            sys.exit(f"{mode}: ranks exited with {codes}")
        out[mode] = json.loads(text.strip().splitlines()[-1])
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        _rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        main()
