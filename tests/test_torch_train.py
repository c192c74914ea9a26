"""The training path of the port against the JAX package's: ``loss_fn``
values and gradients of the LM (GQA, MLA with experts, experts with a
window), recsys and EGNN smoke configs with the reference's weights
carried across (``load_reference_params``), against the reference's
``jax.value_and_grad``; the trainable attention against the serving form;
the port of ``tests/test_arch_smoke.py::test_smoke_train_step`` for all
ten archs; and ``tests/test_system.py``'s train run on the compressed
token store.

Tolerances: fp32 losses within 1e-5 relative and each gradient leaf within
1e-4 of its largest |g|, or of 1e-3 of the largest |g| of any leaf where
that is larger (a leaf whose gradient is a cancellation: dien's score
bias before its softmax, 0 in exact arithmetic, and EGNN's ``phi_x``
output bias, 1e-5 of the largest, whose fp32 round-off is 1e-4 of its
own in both packages) (XLA on the CPU and torch differ by ulps in
``exp``, ``rsqrt``, RoPE's cos and sin and summation order, and backward
adds those up; smollm's, deepseek's and mixtral's smoke models move their
gradients by about 1e-5 of the largest under a 1e-7 relative change of
the weights, starcoder2's by 8e-5, so starcoder2 is held only by the
train-step test); bf16 activations: the loss 2e-2, the gradients 6e-2
of each leaf's largest, and closer to the reference's than to the fp32
gradient (XLA's bf16 ``logistic`` is not fp32's rounded, so ``silu``
differs in 3 of 10 elements; each package's bf16 gradients are 0.13-0.23
of the largest from the fp32 ones, 0.02-0.05 from each other).  The trainable attention equals
the serving form bitwise.  The compressed-pipeline run's first 5 losses
within 1e-3 relative of the reference's.  Parameters after AdamW steps
are not compared elementwise (a gradient within round-off of 0 flips the
step-1 update by ``2 * lr``): ``test_torch_optim.py`` compares the update
on identical gradients."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.data.pipeline import TokenStore as RefTokenStore
from repro.data.pipeline import lm_batch_iter as ref_lm_batch_iter
from repro.models import egnn as RE
from repro.models import recsys as RR
from repro.models import transformer as RT
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.runtime import train_loop as RTL
from repro.runtime.trainer import make_train_step as ref_make_train_step
from repro_torch import configs
from repro_torch.configs.base import STEP_FNS
from repro_torch.data.pipeline import TokenStore, lm_batch_iter
from repro_torch.launch.batches import smoke_batch
from repro_torch.models import attention, egnn, recsys, specs, transformer
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import train_loop as TL
from repro_torch.runtime.trainer import make_train_step, value_and_grad

from _torch_parity import cuda_device, one_thread  # noqa: F401  (fixtures)

LOSS_REL = 1e-5
GRAD_REL = 1e-4
GRAD_FLOOR = 1e-3        # of the largest |g| of any leaf
BF16_REL = 2e-2
BF16_GRAD_REL = 6e-2
MODS = {"lm": (transformer, RT), "gnn": (egnn, RE), "recsys": (recsys, RR)}

pytestmark = pytest.mark.usefixtures("one_thread")


def _f(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_rel(got, want, rel, msg=""):
    g, w = _f(got).astype(np.float64), _f(want).astype(np.float64)
    assert g.shape == w.shape, (msg, g.shape, w.shape)
    bound = rel * max(float(np.abs(w).max()), 1e-30)
    err = float(np.abs(g - w).max())
    assert err <= bound, f"{msg}: max |diff| {err} > {bound}"


def assert_grads(got: list, want: list, rel, msg=""):
    """Each leaf within ``rel`` of the larger of its largest |g| and
    GRAD_FLOOR of the largest |g| of any leaf."""
    assert len(got) == len(want), msg
    top = max(float(np.abs(_f(w)).max()) for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _f(g).astype(np.float64), _f(w).astype(np.float64)
        assert g.shape == w.shape, (msg, i)
        bound = rel * max(float(np.abs(w).max()), GRAD_FLOOR * top, 1e-30)
        err = float(np.abs(g - w).max())
        assert err <= bound, f"{msg} leaf {i}: max |diff| {err} > {bound}"


def _models(arch: str, seed: int = 0, **cfg_kw):
    """(ref cfg, port cfg, ref params, port model) of the arch's smoke
    config at its first train cell, the reference's weights in both."""
    spec, ref_spec = configs.get(arch), ref_configs.get(arch)
    cell = [c for c in spec.shapes.values() if c.kind == "train"][0]
    cfg = dataclasses.replace(spec.config_for_cell(spec.make_smoke_config(), cell), **cfg_kw)
    jkw = {k: (getattr(jnp, str(v).removeprefix("torch.")) if isinstance(v, torch.dtype)
               else v) for k, v in cfg_kw.items()}
    ref_cell = ref_spec.shapes[cell.name]
    rcfg = dataclasses.replace(ref_spec.config_for_cell(ref_spec.make_smoke_config(),
                                                        ref_cell), **jkw)
    mod, rmod = MODS[spec.family]
    params = rmod.init(rcfg, jax.random.PRNGKey(seed))
    model = mod.init(cfg, torch.Generator().manual_seed(seed + 1))
    mod.load_reference_params(model, jax.tree.map(np.asarray, params))
    return spec, cell, rcfg, cfg, params, model


def _batches(spec, cfg, cell, seed: int = 3):
    tb = smoke_batch(spec, cfg, cell, np.random.default_rng(seed), "cpu")
    return tb, {k: jnp.asarray(v.numpy()) for k, v in tb.items()}


def _ref_loss(spec, rcfg):
    if spec.family == "lm":
        return lambda p, b: RT.loss_fn(p, b["tokens"], b["labels"], rcfg)
    return lambda p, b: MODS[spec.family][1].loss_fn(p, b, rcfg)


def _port_loss(spec):
    if spec.family == "lm":
        return lambda m, b: transformer.loss_fn(m, b["tokens"], b["labels"])
    return MODS[spec.family][0].loss_fn


def _assert_loss_and_grads(arch, rel=GRAD_REL, loss_rel=LOSS_REL, **cfg_kw):
    """The reference's and the port's loss, metrics and gradients on the
    same weights and batch; returns both gradients' leaves."""
    spec, cell, rcfg, cfg, params, model = _models(arch, **cfg_kw)
    tb, jb = _batches(spec, cfg, cell)
    (rl, rm), rg = jax.jit(jax.value_and_grad(_ref_loss(spec, rcfg), has_aux=True))(
        params, jb)
    (tl, tm), tg = value_and_grad(_port_loss(spec), model, tb)
    assert float(tl) == pytest.approx(float(rl), rel=loss_rel), arch
    for k in rm:
        assert_rel(tm[k], rm[k], loss_rel, f"{arch} metric {k}")
    got, want = specs.tree_leaves(tg), jax.tree.leaves(rg)
    for t, p in zip(got, specs.tree_leaves(model.tree())):
        assert t.dtype == p.dtype and t.shape == p.shape
    assert_grads(got, want, rel, f"{arch} grad")
    # the parameters are frozen again after the gradient
    assert not any(p.requires_grad for p in model.parameters())
    return got, want


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-v2-lite-16b",
                                  "mixtral-8x22b"])
def test_lm_loss_and_grads_match_reference(arch):
    _assert_loss_and_grads(arch)


def test_lm_bf16_loss_and_grads_match_reference():
    got, want = _assert_loss_and_grads("smollm-135m", rel=BF16_GRAD_REL,
                                       loss_rel=BF16_REL, dtype=torch.bfloat16)
    spec, cell, _, cfg, _, model = _models("smollm-135m")
    _, g32 = value_and_grad(_port_loss(spec), model, _batches(spec, cfg, cell)[0])
    for g, w, t in zip(got, want, specs.tree_leaves(g32)):
        g, w, t = _f(g), _f(w), _f(t)
        assert np.abs(g - w).max() < min(np.abs(g - t).max(), np.abs(w - t).max())


def test_lm_bf16_params_grads_match_reference():
    """mixtral's bf16 parameters (the master-copy case): bf16 gradients."""
    _assert_loss_and_grads("mixtral-8x22b", rel=BF16_REL, loss_rel=BF16_REL,
                           param_dtype=torch.bfloat16)


@pytest.mark.parametrize("arch", ["dlrm-rm2", "wide-deep", "din", "dien"])
def test_recsys_loss_and_grads_match_reference(arch, monkeypatch):
    # 3 rows a recomputed pass: the smoke batch's 8 rows take 3 passes
    monkeypatch.setattr(recsys, "TRAIN_ROW_CHUNK", 3)
    _assert_loss_and_grads(arch)


@pytest.mark.parametrize("cell", ["full_graph_sm", "molecule"])
def test_egnn_loss_and_grads_match_reference(cell, monkeypatch):
    # 50 edges a recomputed chunk: the smoke graph's 120 edges take 3
    monkeypatch.setattr(egnn, "EDGE_CHUNK", 50)
    spec, ref_spec = configs.get("egnn"), ref_configs.get("egnn")
    c, rc = spec.shapes[cell], ref_spec.shapes[cell]
    cfg = dataclasses.replace(spec.config_for_cell(spec.make_smoke_config(), c), d_feat=8)
    rcfg = dataclasses.replace(ref_spec.config_for_cell(ref_spec.make_smoke_config(), rc),
                               d_feat=8)
    params = RE.init(rcfg, jax.random.PRNGKey(2))
    model = egnn.init(cfg, torch.Generator().manual_seed(3))
    egnn.load_reference_params(model, jax.tree.map(np.asarray, params))
    tb, jb = _batches(spec, cfg, c)
    (rl, _), rg = jax.jit(jax.value_and_grad(lambda p, b: RE.loss_fn(p, b, rcfg),
                                             has_aux=True))(params, jb)
    (tl, _), tg = value_and_grad(egnn.loss_fn, model, tb)
    assert float(tl) == pytest.approx(float(rl), rel=LOSS_REL)
    assert_grads(specs.tree_leaves(tg), jax.tree.leaves(rg), GRAD_REL, f"egnn {cell}")


@pytest.mark.parametrize("kw", [dict(causal=True, window=None, q_chunk=8, kv_chunk=8),
                                dict(causal=True, window=5, q_chunk=16, kv_chunk=6),
                                dict(causal=False, window=None, q_chunk=64, kv_chunk=7)])
def test_trainable_attention_equals_the_serving_form(kw):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 20, 4, 8), (2, 20, 2, 8), (2, 20, 2, 8)))
    with torch.no_grad():
        serve = attention.full_attention(q, k, v, **kw)
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    train = attention.full_attention(qg, kg, vg, **kw)
    assert train.requires_grad
    assert torch.equal(train.detach(), serve)
    # and its gradient is the plain softmax attention's
    train.square().sum().backward()
    qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
    kx, vx = (torch.repeat_interleave(t, 2, dim=2) for t in (kr, vr))
    s = torch.einsum("bqhd,bkhd->bhqk", qr, kx) / np.sqrt(8.0)
    pos = torch.arange(20)
    mask = torch.ones(20, 20, dtype=torch.bool)
    if kw["causal"]:
        mask &= pos[None, :] <= pos[:, None]
    if kw["window"]:
        mask &= pos[None, :] > pos[:, None] - kw["window"]
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s.masked_fill(~mask, -1e30), -1), vx)
    o.square().sum().backward()
    for a, b in ((qg, qr), (kg, kr), (vg, vr)):
        assert_rel(a.grad, b.grad, 1e-5, "attention grad")


def _finite(tree) -> bool:
    return all(bool(torch.isfinite(x).all()) for x in specs.tree_leaves(tree)
               if x.is_floating_point())


@pytest.mark.parametrize("arch_id", sorted(configs.ARCHS))
def test_smoke_train_step(arch_id):
    """The port of ``tests/test_arch_smoke.py::test_smoke_train_step``."""
    spec = configs.get(arch_id)
    cell = [c for c in spec.shapes.values() if c.kind == "train"][0]
    cfg = spec.config_for_cell(spec.make_smoke_config(), cell)
    mod = MODS[spec.family][0]
    model = mod.init(cfg, torch.Generator().manual_seed(0))
    before = [p.clone() for p in specs.tree_leaves(model.tree())]
    opt = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    step_fn, is_train = STEP_FNS[spec.family](cfg, cell, opt)
    assert is_train
    batch = smoke_batch(spec, cfg, cell, np.random.default_rng(11), "cpu")
    model2, opt2, metrics = step_fn(model, adamw_init(model.tree()), batch)
    assert model2 is model
    assert np.isfinite(float(metrics["loss"])), arch_id
    assert set(metrics) >= {"loss", "grad_norm", "lr"}
    assert _finite(model.tree()), f"{arch_id}: non-finite params after update"
    assert int(opt2["step"]) == 1
    after = specs.tree_leaves(model.tree())
    for a, b in zip(before, after):
        assert a.shape == b.shape
    assert any(not torch.equal(a, b) for a, b in zip(before, after))


def test_train_on_compressed_pipeline_matches_reference(tmp_path):
    """``tests/test_system.py::test_train_on_compressed_pipeline_loss_decreases``
    on the port, from the reference's weights: the first 5 losses within
    1e-3 relative of the reference's run, and the loss decreases."""
    kw = dict(name="sys", n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
              d_ff=128, vocab=512, q_chunk=16, kv_chunk=16, loss_chunk=16)
    rng = np.random.default_rng(0)
    base = rng.integers(0, 128, 40000).astype(np.uint32)
    toks = np.where(rng.random(40000) < 0.7, np.roll(base, 1) % 512, base).astype(np.uint32)
    rcfg = RT.LMConfig(dtype=jnp.float32, **kw)
    cfg = transformer.LMConfig(dtype=torch.float32, **kw)
    params = RT.init(rcfg, jax.random.PRNGKey(0))
    model = transformer.init(cfg, torch.Generator().manual_seed(0))
    transformer.load_reference_params(model, jax.tree.map(np.asarray, params))
    ocfg = dict(lr=3e-3, warmup_steps=5, total_steps=30)
    rstep = jax.jit(ref_make_train_step(
        lambda p, b: RT.loss_fn(p, b["tokens"], b["labels"], rcfg), RefAdamWConfig(**ocfg)))
    _, _, rinfo = RTL.run(rstep, params, ref_adamw_init(params),
                          ref_lm_batch_iter(RefTokenStore.build(toks, codec="group_simple"), 4, 32),
                          RTL.LoopConfig(total_steps=30, ckpt_dir=str(tmp_path / "ref"),
                                         ckpt_every=10, log_every=1000),
                          log_fn=lambda *a: None)
    store = TokenStore.build(toks, codec="group_simple")
    assert store.compressed_bytes() < store.raw_bytes
    step = make_train_step(lambda m, b: transformer.loss_fn(m, b["tokens"], b["labels"]),
                           AdamWConfig(**ocfg))
    _, _, info = TL.run(step, model, adamw_init(model.tree()), lm_batch_iter(store, 4, 32),
                        TL.LoopConfig(total_steps=30, ckpt_dir=str(tmp_path / "port"),
                                      ckpt_every=10, log_every=1000),
                        log_fn=lambda *a: None)
    losses = [m["loss"] for m in info["metrics"]]
    want = [m["loss"] for m in rinfo["metrics"]]
    assert len(losses) == len(want) == 30
    np.testing.assert_allclose(losses[:5], want[:5], rtol=1e-3)
    assert losses[-1] < losses[0], (losses[0], losses[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id", sorted(configs.ARCHS))
def test_smoke_train_step_on_the_card_equals_the_cpu(arch_id, cuda_device):
    """One smoke train step of every arch on the card: the loss and every
    gradient leaf against the host CPU's (1e-4, as ``assert_grads`` bounds
    a leaf; index_add_ and MoE combines add in no fixed order on the
    card)."""
    spec = configs.get(arch_id)
    cell = [c for c in spec.shapes.values() if c.kind == "train"][0]
    cfg = spec.config_for_cell(spec.make_smoke_config(), cell)
    mod = MODS[spec.family][0]
    cpu = mod.init(cfg, torch.Generator().manual_seed(0))
    card = type(cpu)(cfg, specs.tree_map(lambda t: t.to(cuda_device), cpu.tree()))
    batch = smoke_batch(spec, cfg, cell, np.random.default_rng(11), "cpu")
    loss = _port_loss(spec)
    (lc, _), gc = value_and_grad(loss, cpu, batch)
    (lg, _), gg = value_and_grad(loss, card, {k: v.to(cuda_device) for k, v in batch.items()})
    assert lg.device.type == "cuda"
    assert float(lg) == pytest.approx(float(lc), rel=GRAD_REL)
    assert all(a.device.type == "cuda" for a in specs.tree_leaves(gg))
    assert_grads(specs.tree_leaves(gg), specs.tree_leaves(gc), GRAD_REL,
                 f"{arch_id} grad")
