"""AdamW of the port (``repro_torch.optim``) against the JAX package's
``optim/adamw.py``: the schedule, the global norm and one update given the
reference's own gradients, with and without the fp32 master copy of bf16
parameters.

Tolerances: the learning rate within 1e-6 relative (``jnp.cos`` and
``torch.cos`` may differ by an ulp), the global norm within 1e-6 relative;
the updated parameters, ``m``, ``v`` and the master copy within 1e-6 of
each leaf's largest magnitude; ``step`` bitwise.  Parameters after a step
are compared through the update alone, on identical gradients: a gradient
within round-off of 0 would flip the step-1 update (about ``lr *
sign(g)``) of a full train step."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.optim import adamw as RA
from repro_torch.optim import adamw as A

from _torch_parity import one_thread  # noqa: F401  (fixture)

TOL = 1e-6
CFG = dict(lr=3e-3, warmup_steps=5, total_steps=40)

pytestmark = pytest.mark.usefixtures("one_thread")


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.to(torch.float32) if x.dtype == torch.bfloat16 else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype == ml_dtypes.bfloat16 else a


def _close(got, want, msg=""):
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert g.shape == w.shape, msg
    bound = TOL * max(float(np.abs(w).max()), 1e-30)
    assert float(np.abs(g - w).max()) <= bound, (msg, float(np.abs(g - w).max()), bound)


def _tree(seed: int, bf16: bool):
    rng = np.random.default_rng(seed)
    shapes = {"b": (7,), "w": (5, 3), "layers": {"k": (2, 4, 4), "s": ()}}

    def leaf(s):
        return np.asarray(rng.standard_normal(s), np.float32)
    ref = jax.tree.map(leaf, shapes, is_leaf=lambda x: isinstance(x, tuple))
    dt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    jx = jax.tree.map(lambda a: jnp.asarray(a, dt[0]), ref)
    tx = jax.tree.map(lambda a: torch.from_numpy(np.array(
        jnp.asarray(a, dt[0]).astype(jnp.float32))).to(dt[1]), ref)
    return jx, tx


@pytest.mark.parametrize("cfg", [CFG, dict(lr=1e-3, warmup_steps=0, total_steps=10),
                                 dict(lr=3e-4, warmup_steps=100, total_steps=10000,
                                      min_lr_frac=0.0)])
def test_cosine_lr_on_a_grid_of_steps(cfg):
    rc, tc = RA.AdamWConfig(**cfg), A.AdamWConfig(**cfg)
    for step in [0, 1, 2, 3, 5, 6, 17, 39, 40, 41, 99, 100, 101, 5000, 9999, 10000, 20000]:
        want = float(RA.cosine_lr(jnp.int32(step), rc))
        got = float(A.cosine_lr(torch.tensor(step, dtype=torch.int32), tc))
        assert got == pytest.approx(want, rel=TOL, abs=1e-12), step
        assert float(A.cosine_lr(step, tc)) == got


def test_global_norm():
    jx, tx = _tree(0, bf16=False)
    want = float(RA.global_norm(jx))
    assert float(A.global_norm(tx)) == pytest.approx(want, rel=TOL)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16_master"])
@pytest.mark.parametrize("clip", [1.0, 100.0], ids=["clipped", "unclipped"])
def test_adamw_update_on_the_reference_gradients(bf16, clip):
    """Three updates in a row on the reference's gradients (numpy): the
    state, the parameters and the metrics after each."""
    rc = RA.AdamWConfig(clip_norm=clip, weight_decay=0.1, **CFG)
    tc = A.AdamWConfig(clip_norm=clip, weight_decay=0.1, **CFG)
    jp, tp = _tree(1, bf16)
    jo, to = RA.adamw_init(jp), A.adamw_init(tp)
    assert ("master" in jo) == ("master" in to) == bf16
    for i in range(3):
        rng = np.random.default_rng(10 + i)
        g = jax.tree.map(lambda a: np.asarray(rng.standard_normal(a.shape) * 3,
                                              np.float32), jp)
        jp, jo, jm = RA.adamw_update(jp, g, jo, rc)
        tg = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), g)
        tm = A.adamw_update(tp, tg, to, tc)
        assert to["step"].dtype == torch.int32
        assert int(to["step"]) == int(jo["step"]) == i + 1
        for k in ("grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=TOL), k
        for name in ("m", "v") + (("master",) if bf16 else ()):
            for a, b in zip(jax.tree.leaves(to[name]), jax.tree.leaves(jo[name])):
                _close(a, b, f"{name} after update {i + 1}")
        for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
            assert a.dtype == (torch.bfloat16 if bf16 else torch.float32)
            if bf16:
                # the bf16 parameter is the master copy rounded: equal unless
                # the two masters round across a bf16 boundary
                assert float(np.abs(_np(a) - _np(b)).max()) <= 2 ** -7 * max(
                    float(np.abs(_np(b)).max()), 1e-30)
            else:
                _close(a, b, f"params after update {i + 1}")
