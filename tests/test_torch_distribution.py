"""The port's distribution layer on gloo ranks on the CPU, against the
JAX package (``tests/test_distribution.py``'s four cases and
``tests/test_pipeline_parallel.py``'s one).

One world of 8 ranks runs every case once (``tests/_torch_dist_world.py``,
a subprocess that spawns them), in a module fixture whose results each
test reads: the sharded smollm smoke loss and train step on a 4x2 mesh,
the EP lookups and their backward on 2x4, din's row passes under a plan
on 4x2, the elastic restore 8 -> 4, the process-group compressed
all-reduce against its list form, the compressed DP step's process-group
form against the list form, and ``pipeline_2stage`` on a 2x4
("pod", "data") mesh.  The reference's values are computed here: its
single-device smoke loss on the weights the ranks load
(``load_reference_params``), its exact mean, and its sequential layers
(which its own test holds its pipeline to, within 2e-5).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import smollm_135m as ref_smollm
from repro.models import transformer as ref_T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flat(tree, prefix="p") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case's result from one 8-rank gloo world, and the reference's
    smoke loss on the same weights and tokens."""
    tmp = tmp_path_factory.mktemp("dist")
    cfg = ref_smollm.make_smoke_config()
    params = ref_T.init(cfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (4, 32)).astype(np.int32)
    ref, _ = jax.jit(lambda p, t: ref_T.loss_fn(p, t[:, :-1], t[:, 1:], cfg))(
        params, jnp.asarray(toks))
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, tokens=toks, **_flat(jax.tree.map(np.asarray, params)))
    out = str(tmp / "out.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, os.path.join(ROOT, "tests",
                                                     "_torch_dist_world.py"),
                        inputs, out], capture_output=True, text=True, env=env,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    with open(out) as f:
        res = json.load(f)
    res["ref_loss"] = float(ref)
    return res


def test_sharded_lm_forward_matches_single_device(world):
    """The smollm smoke loss under ``lm_dense_plan`` on a 4x2 mesh within
    1e-4 of the reference's single-device loss on the same weights."""
    assert abs(world["lm_loss"] - world["ref_loss"]) < 1e-4, world
    assert abs(world["lm_loss"] - world["lm_loss_plain"]) < 1e-5, world


def test_sharded_lm_train_step_matches_unplanned(world):
    """smollm's smoke train step under ``lm_dense_plan`` on a 4x2 mesh (a
    "model" axis of 2 ranks: the sequence, the vocab and the ffn split
    there) against the unplanned step on the same weights: the loss
    equal, every gradient within 1e-4 of its leaf's largest magnitude,
    every parameter after AdamW within 1e-6, and the step moved each."""
    assert world["lm_step_loss_err"] < 1e-5, world
    assert world["lm_step_grad_err"] < 1e-4, world
    assert world["lm_step_param_err"] < 1e-6, world
    assert world["lm_step_param_moved"] > 0, world


def test_embedding_ep_lookup_backward_matches_plain(world):
    """The table gradients of ``lookup`` and ``lookup_stacked`` on the EP
    path (rows over "model" of a 2x4 mesh, ids over "data") bitwise the
    plain gather's, on an upstream gradient of small integers."""
    assert world["ep_grad_bitwise"]


def test_recsys_row_passes_under_a_plan(world):
    """Under ``recsys_plan`` on a 4x2 mesh din's forward, loss and
    retrieval take ``ROW_CHUNK`` / ``TRAIN_ROW_CHUNK`` of each rank's own
    rows (candidates) a pass: with 1 row (5 candidates) a pass, 2 forward
    passes, 2 more recomputed in backward and 4 retrieval passes over
    the 16 candidates a rank (64 split as a batch's rows over "data");
    logits, loss and gradients within 1e-5 of the plain single pass, the
    top 10 ids equal."""
    got = world["recsys_passes"]
    assert got["passes"] == [2, 4, 4], got
    for key in ("forward_err", "loss_err", "grad_err", "topk_score_err"):
        assert got[key] < 1e-5, (key, got)
    assert got["topk_ids_equal"], got


def test_embedding_ep_lookup_matches_plain(world):
    """``lookup`` and ``lookup_stacked`` on the EP path (rows over "model"
    of a 2x4 mesh) bitwise the plain gather."""
    assert world["ep_lookup_bitwise"] and world["ep_stacked_bitwise"]


def test_checkpoint_reshard_elastic(world):
    """Saved by 8 ranks (rows over "data" of 8x1), restored by 4 (4x1):
    the same tensor, 2 rows a rank, the step and the cursor."""
    assert world["elastic"] == {"equal": True, "local_rows": 2, "data": 4,
                                "step": 1, "cursor": 5}


def test_compressed_allreduce_matches_pmean(world):
    """The process-group compressed all-reduce bitwise its list form
    (int8 and int4, reduced values and residuals) and, int8, within the
    reference's 0.05 of the exact mean."""
    assert world["allreduce_bitwise"]
    assert world["allreduce_err"] < world["allreduce_bound"], world


def test_compressed_dp_step_group_form_equals_list_form(world):
    """A compressed-DP step of din's smoke config over 8 ranks: the
    process-group form's parameters and loss bitwise the list form's."""
    assert world["dp_step_bitwise"]


def test_pipeline_2stage_matches_sequential(world):
    """``pipeline_2stage`` on a 2x4 ("pod", "data") mesh bitwise the port's
    sequential loop, and within 2e-5 of the reference's sequential
    layers."""
    assert world["pipeline_bitwise"]
    rng = np.random.default_rng(0)
    L, D, n_micro, mb = 4, 16, 3, 8
    assert world["pipeline_steps"] == [n_micro, mb, D]
    ws = jnp.asarray(rng.normal(0, 0.5, (L, D, D)).astype(np.float32))
    ref = jnp.asarray(rng.normal(0, 1, (n_micro, mb, D)).astype(np.float32))
    for li in range(L):
        ref = jnp.tanh(ref @ ws[li])
    np.testing.assert_allclose(np.asarray(world["pipeline_out"], np.float32),
                               np.asarray(ref), rtol=2e-5, atol=2e-5)
