"""The roofline table of the dry-run JSONs (counterpart of the JAX
package's ``launch/roofline_report.py``), with H100 constants.

Per (arch x shape x mesh): the three roofline terms of one chip's step,
from ``launch/census.py``'s per-chip counts (FLOPs, memory bytes, wire
bytes) over one card's rates; the dominant term; MODEL_FLOPS (6*N*D dense
/ 6*N_active*D MoE for training, 2*N*D for serving) and the usefulness
ratio MODEL_FLOPS / counted FLOPs.

Constants: one "NVIDIA H100 80GB HBM3" (SXM) at its 700.00 W power limit,
NVIDIA's data sheet: dense bf16 989 TFLOP/s (``PEAK``), HBM3 3.35 TB/s
(``HBM``), NVLink 4 900 GB/s a card both ways, 450 GB/s each way
(``NVLINK``).  An NVLink domain holds 8 cards: the 16-way "model" axis and
every "data" and "pod" group of the production meshes span several
nodes, whose traffic leaves the node over InfiniBand NDR, 400 Gb/s = 50
GB/s a card (``IB``), so ``T_coll`` is the wire bytes over ``IB`` and
``T_coll_nvl`` over NVLink, the bound a single domain would give.  The
memory term is eager torch's unfused traffic (an upper bound).

  PYTHONPATH=src python -m repro_torch.launch.roofline_report [--dir experiments/dryrun_torch]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

PEAK = 989e12
HBM = 3.35e12
NVLINK = 450e9
IB = 50e9


def _lm_params(cfg):
    from ..models import transformer as T
    from ..models.specs import count_params
    total = count_params(T.param_specs(cfg))
    active = total
    if cfg.moe:
        per_expert = 3 * cfg.d_model * cfg.d_ff_expert
        inactive = (cfg.n_experts - cfg.top_k) * per_expert * cfg.n_moe_layers
        active = total - inactive
    return total, active


def _model_flops(rec) -> float:
    from .. import configs
    spec = configs.get(rec["arch"])
    cell = spec.shapes[rec["shape"]]
    cfg = spec.config_for_cell(spec.make_config(), cell)
    kind = rec["kind"]
    if spec.family == "lm":
        total, active = _lm_params(cfg)
        if kind == "train":
            return 6.0 * active * cell.dims["batch"] * cell.dims["seq"]
        if kind == "prefill":
            return 2.0 * active * cell.dims["batch"] * cell.dims["seq"]
        return 2.0 * active * cell.dims["batch"]          # decode: 1 tok/seq
    if spec.family == "gnn":
        dh = cfg.d_hidden
        e = cell.dims["n_edges"]
        n = cell.dims["n_nodes"]
        per_edge = 2 * ((2 * dh + 1) * dh + dh * dh) + 2 * (dh * dh + dh)
        per_node = 2 * (2 * dh * dh + dh * dh)
        fwd = cfg.n_layers * (e * per_edge + n * per_node) + 2 * n * cell.dims["d_feat"] * dh
        return 3.0 * fwd                                   # fwd+bwd

    def mlp_flops(dims, d_in):
        f, cur = 0, d_in
        for d in dims:
            f += 2 * cur * d
            cur = d
        return f
    if cfg.model == "dlrm":
        per = (mlp_flops(cfg.bot_mlp, cfg.n_dense) + mlp_flops(cfg.top_mlp, 415)
               + 2 * 27 * 27 * 64)
    elif cfg.model == "wide_deep":
        per = mlp_flops(cfg.top_mlp, cfg.n_sparse * cfg.embed_dim)
    elif cfg.model == "din":
        pair = cfg.pair_dim
        per = (cfg.seq_len * mlp_flops(cfg.attn_mlp + (1,), 4 * pair)
               + mlp_flops(cfg.mlp + (1,), 3 * pair + cfg.n_profile * cfg.embed_dim))
    else:  # dien
        per = cfg.seq_len * (2 * 3 * (cfg.pair_dim + cfg.gru_dim) * cfg.gru_dim * 2
                             + mlp_flops(cfg.attn_mlp + (1,), 2 * cfg.gru_dim))
    b = cell.dims.get("n_candidates", cell.dims["batch"])
    return (3.0 if kind == "train" else 1.0) * per * b


def rows(out_dir="experiments/dryrun_torch"):
    out = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        mesh = "x".join(map(str, rec["mesh"]))
        chips = int(np.prod(rec["mesh"]))
        if rec.get("status") == "skipped":
            out.append((rec["arch"], rec["shape"], mesh, None, rec["skip_reason"]))
            continue
        c = rec["census"]
        tc = c["flops_per_chip"] / PEAK
        tm = c["mem_bytes_per_chip"] / HBM
        tl = c["wire_bytes_per_chip"] / IB
        tn = c["wire_bytes_per_chip"] / NVLINK
        dom = max((("compute", tc), ("memory", tm), ("collective", tl)),
                  key=lambda kv: kv[1])[0]
        mf = _model_flops(rec)
        total = c["flops_per_chip"] * chips
        ratio = mf / total if total else float("nan")
        frac = tc / max(tc, tm, tl)
        out.append((rec["arch"], rec["shape"], mesh,
                    (tc, tm, tl, tn, dom, mf, ratio, frac), None))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)
    print("| arch | shape | mesh | T_comp (ms) | T_mem (ms) | T_coll (ms) | "
          "T_coll_nvl (ms) | dominant | MODEL_FLOPS | useful/counted | "
          "roofline frac |")
    print("|---|---|---|---|---|---|---|---|---|---|---|")
    for arch, shape, mesh, t, skip in rows(args.dir):
        if t is None:
            print(f"| {arch} | {shape} | {mesh} | — | — | — | — | SKIPPED | — | — | — |")
            continue
        tc, tm, tl, tn, dom, mf, ratio, frac = t
        print(f"| {arch} | {shape} | {mesh} | {tc*1e3:.2f} | {tm*1e3:.2f} | "
              f"{tl*1e3:.2f} | {tn*1e3:.2f} | {dom} | {mf:.2e} | {ratio:.2f} | "
              f"{frac:.3f} |")


if __name__ == "__main__":
    main()
