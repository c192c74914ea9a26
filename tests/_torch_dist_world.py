"""One gloo world of 8 ranks on the CPU running every case of
``tests/test_torch_distribution.py`` (the JAX package's
``tests/test_distribution.py`` and ``test_pipeline_parallel.py``), each
result written by rank 0 to a JSON file:

  python tests/_torch_dist_world.py INPUTS.npz OUT.json

``INPUTS.npz`` holds the reference's smollm smoke parameters (``p/<path>``)
and tokens (``tokens``), made by the test from the JAX package.  Each rank
is a process of its own (``--rank R PORT INPUTS TMP OUT``).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

WORLD = 8


def _tree(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        node = out
        *path, leaf = k.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _grad_err(got: list, want: list) -> float:
    """The largest gradient difference over leaves, each over the larger of
    its leaf's largest magnitude and 1e-3 of every leaf's (a gradient that
    is round-off only is not held to its own scale)."""
    top = max(float(w.abs().max()) for w in want)
    return max(float((g - w).abs().max()) / max(float(w.abs().max()), 1e-3 * top)
               for g, w in zip(got, want))


def _full(t):
    from repro_torch.distributed import sharding as shlib
    return t.full_tensor() if shlib.is_dtensor(t) else t


def _lm_train_step(model, toks, mesh) -> dict:
    """smollm's smoke train step under ``lm_dense_plan`` on ``mesh`` (4x2:
    "model" of 2 ranks) against the unplanned step on the same weights:
    the loss (also against the reference's), every gradient and every
    parameter after AdamW."""
    import copy

    import torch

    from repro_torch import configs
    from repro_torch.configs.base import lm_grads_like_params
    from repro_torch.distributed import sharding as shlib
    from repro_torch.models import transformer as T
    from repro_torch.models.specs import tree_leaves
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    from repro_torch.runtime.trainer import value_and_grad
    spec = configs.get("smollm-135m")
    cfg = model.cfg
    cell = spec.shapes["train_4k"]
    ocfg = AdamWConfig(lr=1e-3)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def lf(m, b):
        return T.loss_fn(m, b["tokens"], b["labels"])
    # the train step's parts (``make_train_step``), the gradients read
    # before AdamW scales them in place
    plain = copy.deepcopy(model)
    (l0, _), g0 = value_and_grad(lf, plain, batch)
    want = [g.clone() for g in tree_leaves(g0)]
    adamw_update(plain.tree(), g0, adamw_init(plain.tree()), ocfg)
    with shlib.plan_scope(mesh, spec.plan_for(cfg, cell)):
        dm = shlib.distribute_model(copy.deepcopy(model), T.axes(cfg))
        db = shlib.distribute_tree(batch, spec.batch_axes(cfg, cell))
        (l1, _), g1 = value_and_grad(lf, dm, db)
        g1 = lm_grads_like_params(cfg)(g1)
        got = [_full(g).clone() for g in tree_leaves(g1)]
        adamw_update(dm.tree(), g1, adamw_init(dm.tree()), ocfg)
        p1 = [_full(p) for p in tree_leaves(dm.tree())]
    p0 = tree_leaves(plain.tree())
    return {"lm_loss": float(_full(l1)), "lm_loss_plain": float(l0),
            "lm_step_loss_err": abs(float(_full(l1)) - float(l0)),
            "lm_step_grad_err": _grad_err(got, want),
            "lm_step_param_err": max(float((a - b).abs().max())
                                     for a, b in zip(p1, p0)),
            "lm_step_param_moved": min(float((a - b).abs().max())
                                       for a, b in zip(p0, tree_leaves(model.tree()))),
            "lm_step_lr": ocfg.lr}


def _ep_backward(table, ids, tables, ids2, mesh) -> bool:
    """The table gradients of ``lookup`` and ``lookup_stacked`` on the EP
    path (rows over "model" of 2x4) bitwise the plain gather's: the
    upstream gradient holds small integers, so every sum is exact."""
    import torch

    from repro_torch.distributed import sharding as shlib
    from repro_torch.models import embedding as E
    same = True
    for fn, tbl, ix, t_axes in ((E.lookup, table, ids, ("table_rows", None)),
                                (E.lookup_stacked, tables, ids2,
                                 (None, "table_rows", None))):
        up = torch.as_tensor(np.random.default_rng(4).integers(
            -3, 4, tuple(ix.shape) + (tbl.shape[-1],)).astype(np.float32))
        want = tbl.clone().requires_grad_()
        (fn(want, ix) * up).sum().backward()
        with shlib.plan_scope(mesh, shlib.recsys_plan()):
            dt = shlib.distribute(tbl, t_axes).requires_grad_()
            out = fn(dt, shlib.distribute(ix, ("batch", None)))
            loss = (out * shlib.distribute(up, ("batch",) + (None,) * (up.ndim - 1))).sum()
            (got,) = torch.autograd.grad(loss.full_tensor(), dt)
            got = got.full_tensor()
        same &= bool(torch.equal(got, want.grad))
    return same


def _recsys_passes(arch: str, mesh) -> dict:
    """A recsys smoke model under ``recsys_plan`` on ``mesh`` (4x2), its
    forward, loss, gradients and retrieval top 10 taking one row (and 5
    candidates) of each rank's own a pass, against the plain single
    pass; and the number of passes each planned call took."""
    import torch

    from repro_torch import configs
    from repro_torch.distributed import sharding as shlib
    from repro_torch.launch.batches import smoke_batch
    from repro_torch.models import recsys as R
    from repro_torch.models.specs import tree_leaves
    from repro_torch.runtime.trainer import value_and_grad
    spec = configs.get(arch)
    cfg = spec.make_smoke_config()
    train, retr = spec.shapes["train_batch"], spec.shapes["retrieval_cand"]
    model = R.init(cfg, torch.Generator().manual_seed(2))
    tb = smoke_batch(spec, cfg, train, np.random.default_rng(5), "cpu")
    rb = smoke_batch(spec, cfg, retr, np.random.default_rng(6), "cpu")
    rb = {k: (v if k.startswith("cand_") else v[:1]) for k, v in rb.items()}
    logit0 = R.forward(model, tb)
    (l0, _), g0 = value_and_grad(R.loss_fn, model, tb)
    s0, i0 = R.retrieval_topk(model, rb, k=10)
    fwd, calls = R.FORWARDS[cfg.model], []
    chunks = (R.ROW_CHUNK, R.TRAIN_ROW_CHUNK)
    R.FORWARDS[cfg.model] = lambda *a: (calls.append(1), fwd(*a))[1]
    try:
        with shlib.plan_scope(mesh, spec.plan_for(cfg, train)):
            dm = shlib.distribute_model(model, R.axes(cfg))
            db = shlib.distribute_tree(tb, spec.batch_axes(cfg, train))
            R.ROW_CHUNK = R.TRAIN_ROW_CHUNK = 1
            logit1 = R.forward(dm, db).full_tensor()
            n_fwd = len(calls)
            (l1, _), g1 = value_and_grad(R.loss_fn, dm, db)
            n_loss = len(calls) - n_fwd
            R.ROW_CHUNK = 5
            rd = shlib.distribute_tree(rb, spec.batch_axes(cfg, retr))
            s1, i1 = R.retrieval_topk(dm, rd, k=10)
            n_retr = len(calls) - n_fwd - n_loss
    finally:
        R.FORWARDS[cfg.model] = fwd
        R.ROW_CHUNK, R.TRAIN_ROW_CHUNK = chunks
    return {"passes": [n_fwd, n_loss, n_retr],
            "forward_err": float((logit1 - logit0).abs().max()
                                 / logit0.abs().max()),
            "loss_err": abs(float(_full(l1)) - float(l0)),
            "grad_err": _grad_err([_full(g) for g in tree_leaves(g1)],
                                  tree_leaves(g0)),
            "topk_ids_equal": bool(torch.equal(_full(i1), i0)),
            "topk_score_err": float((_full(s1) - s0).abs().max()
                                    / s0.abs().max())}


def _run(rank: int, port: int, inputs: str, tmp: str, out_path: str) -> None:
    import torch
    torch.set_num_threads(1)
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch import configs
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed import sharding as shlib
    from repro_torch.distributed.pipeline import pipeline_2stage
    from repro_torch.launch import mesh as M
    from repro_torch.launch.batches import smoke_batch
    from repro_torch.models import embedding as E
    from repro_torch.models import recsys, transformer as T
    from repro_torch.models.specs import load_reference_params, tree_leaves
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.trainer import make_compressed_dp_train_step

    M.init_world("gloo", rank=rank, world_size=WORLD, port=port)
    res: dict = {}
    try:
        data = np.load(inputs)
        # ---- smollm's smoke loss and train step on a 4x2 mesh ----------------- #
        cfg = configs.get("smollm-135m").make_smoke_config()
        model = T.init(cfg, torch.Generator().manual_seed(0))
        load_reference_params(model, _tree({k[2:]: data[k] for k in data.files
                                            if k.startswith("p/")}))
        mesh42 = M.make_host_mesh((4, 2), ("data", "model"))
        res.update(_lm_train_step(model, torch.as_tensor(data["tokens"]), mesh42))
        # ---- the EP lookups on a 2x4 mesh, bitwise the plain gather ------------ #
        rng = np.random.default_rng(0)
        table = torch.as_tensor(rng.normal(0, 1, (64, 8)).astype(np.float32))
        ids = torch.as_tensor(rng.integers(0, 64, (16, 5)), dtype=torch.int32)
        tables = torch.as_tensor(rng.normal(0, 1, (3, 64, 8)).astype(np.float32))
        ids2 = torch.as_tensor(rng.integers(0, 64, (16, 3)), dtype=torch.int32)
        mesh24 = M.make_host_mesh((2, 4), ("data", "model"))
        with shlib.plan_scope(mesh24, shlib.recsys_plan()):
            got = E.lookup(shlib.distribute(table, ("table_rows", None)),
                           shlib.distribute(ids, ("batch", None))).full_tensor()
            got2 = E.lookup_stacked(
                shlib.distribute(tables, (None, "table_rows", None)),
                shlib.distribute(ids2, ("batch", None))).full_tensor()
        want2 = np.stack([tables.numpy()[t][ids2.numpy()[:, t]] for t in range(3)],
                         axis=1)
        res["ep_lookup_bitwise"] = bool(torch.equal(got, table[ids.long()]))
        res["ep_stacked_bitwise"] = bool(np.array_equal(got2.numpy(), want2))
        res["ep_grad_bitwise"] = _ep_backward(table, ids, tables, ids2, mesh24)
        # ---- recsys row passes under a plan on 4x2, against the plain pass --- #
        res["recsys_passes"] = _recsys_passes("din", mesh42)
        # ---- the elastic restore: saved by 8 ranks, restored by 4 -------------- #
        mesh8 = M.make_host_mesh((8, 1), ("data", "model"))
        mesh4 = M.make_host_mesh((4, 1), ("data", "model"))
        x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
        ck = Checkpointer(os.path.join(tmp, "ckpt"))
        ck.save(1, {"x": shlib.from_full(x, mesh8, (Shard(0), Replicate()))},
                {"cursor": 5})
        state, step, extra = ck.restore(
            {"x": x}, shardings={"x": (mesh4, (Shard(0), Replicate()))})
        if state["x"] is not None:          # ranks 0-3, the 4x1 mesh
            res["elastic"] = {
                "equal": bool(torch.equal(state["x"].full_tensor(), x)),
                "local_rows": int(state["x"].to_local().shape[0]),
                "data": int(state["x"].device_mesh.size(0)),
                "step": step, "cursor": extra["cursor"]}
        # ---- the compressed all-reduce: process group vs list form ------------- #
        xs = torch.as_tensor(np.random.default_rng(0).normal(
            0, 1, (WORLD * 5000,)).astype(np.float32)).reshape(WORLD, 5000)
        bitwise = True
        for bits in (8, 4):
            red, ef = C.compressed_allreduce_flat_group(xs[rank], None, bits)
            reds, efs = C.compressed_allreduce_flat(list(xs), bits)
            bitwise &= bool(torch.equal(red, reds[rank]) and torch.equal(ef, efs[rank]))
            if bits == 8:
                exact = xs.mean(dim=0)
                res["allreduce_err"] = float((red - exact).abs().max())
                res["allreduce_bound"] = 0.05 * (float(exact.abs().max()) + 1e-6)
        res["allreduce_bitwise"] = bitwise
        # ---- the compressed DP step: process group vs list form ---------------- #
        dspec = configs.get("din")
        dcfg = dspec.make_smoke_config()
        cell = dspec.shapes["train_batch"]
        batch = smoke_batch(dspec, dcfg, cell, np.random.default_rng(3), "cpu")
        ocfg = AdamWConfig()
        same = True
        for form in ("list", "group"):
            m = recsys.init(dcfg, torch.Generator().manual_seed(1))
            if form == "list":
                step_fn, init_opt = make_compressed_dp_train_step(
                    recsys.loss_fn, ocfg, WORLD, bits=8)
            else:
                step_fn, init_opt = make_compressed_dp_train_step(
                    recsys.loss_fn, ocfg, bits=8, mesh=mesh8)
            opt = init_opt(m)
            m, opt, metrics = step_fn(m, opt, batch)
            leaves = [t.clone() for t in tree_leaves(m.tree())] + [metrics["loss"]]
            if form == "list":
                ref_leaves = leaves
            else:
                same &= all(torch.equal(a, b) for a, b in zip(leaves, ref_leaves))
        res["dp_step_bitwise"] = bool(same)
        # ---- pipeline_2stage on a 2x4 ("pod", "data") mesh ------------------- #
        prng = np.random.default_rng(0)
        L, D, n_micro, mb = 4, 16, 3, 8
        ws = torch.as_tensor(prng.normal(0, 0.5, (L, D, D)).astype(np.float32))
        xm = torch.as_tensor(prng.normal(0, 1, (n_micro, mb, D)).astype(np.float32))

        def layer(w, h):
            return torch.tanh(h @ w)
        pmesh = M.make_host_mesh((2, 4), ("pod", "data"))
        out = pipeline_2stage(layer, ws, xm, pmesh)
        seq = xm
        for li in range(L):
            seq = layer(ws[li], seq)
        res["pipeline_bitwise"] = bool(torch.equal(out, seq))
        res["pipeline_out"] = out.numpy().tolist()
        res["pipeline_steps"] = [n_micro, mb, D]
    finally:
        M.shutdown_world()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)


def main(argv) -> None:
    """Start the 8 ranks as processes of their own (no parent torch) and
    wait for them; a rank that fails fails the world."""
    import socket
    import subprocess
    import tempfile
    inputs, out_path = argv
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r),
                                   str(port), inputs, tmp, out_path])
                 for r in range(WORLD)]
        try:
            codes = [p.wait(timeout=240) for p in procs]
        finally:                        # a hung rank: stop every rank
            for p in procs:
                p.kill()
    if any(codes):
        sys.exit(f"ranks exited with {codes}")


if __name__ == "__main__":
    if sys.argv[1] == "--rank":
        rank, port, inputs, tmp, out_path = sys.argv[2:]
        _run(int(rank), int(port), inputs, tmp, out_path)
    else:
        main(sys.argv[1:])
