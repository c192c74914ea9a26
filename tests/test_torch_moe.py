"""The port's mixture-of-experts serving path against the JAX package's
``models/moe.py`` and the MoE half of ``models/transformer.py``:
``route_group`` (batched over groups, exact ties, capacity drops),
``moe_ffn`` in fp32 and bf16, and the two MoE smoke configs
(deepseek-v2-lite-16b with MLA, mixtral-8x22b with a window of 16 under a
32-token prompt, so the ring wraps) served with the reference's weights
carried across by ``load_reference_params``.

Tolerances: routing is discrete, so ``idx`` compares exactly wherever no
token's k-th and (k+1)-th probabilities lie within ``MARGIN`` of each other
(a near tie may flip on an ulp: such a token's two experts are left out of
the comparison); ``wgt`` and ``aux`` within ``1e-6`` (fp32 softmax and
means in other summation orders); ``moe_ffn`` within ``1e-5`` of its
largest magnitude in fp32 (a token's k outputs and the expert products sum
in other orders than XLA's) and ``2e-2`` in bf16; the models as in
``test_torch_models.py`` (fp32 logits ``atol=2e-4``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs.base import STEP_FNS as REF_STEP_FNS
from repro.models import moe as ref_moe
from repro.models import transformer as RT
from repro_torch import configs
from repro_torch.configs.base import STEP_FNS
from repro_torch.models import moe, specs
from repro_torch.models import transformer as T

from _torch_parity import cuda_device  # noqa: F401  (fixture)
from test_torch_models import (AUX_ATOL, LOGIT_ATOL, _carried, _extend,
                               _serve_parity, _smoke_pair, _tokens,
                               assert_logits, assert_rel)

MOE_ARCHS = ["deepseek-v2-lite-16b", "mixtral-8x22b"]
MARGIN = 1e-5
WGT_ATOL = 1e-6
FFN_REL = 1e-5
BF16_REL = 2e-2


def _routing_inputs(arch: str, g=3, s=24, seed=0):
    cfg = configs.get(arch).make_smoke_config()
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((g, s, cfg.d_model)).astype(np.float32)
    w = (rng.standard_normal((cfg.d_model, cfg.n_experts))
         / np.sqrt(cfg.d_model)).astype(np.float32)
    return cfg, x, w


def _ref_route(x, w, k, cap):
    return jax.vmap(lambda xi: ref_moe.route_group(
        xi, jnp.asarray(w), top_k=k, capacity=cap))(jnp.asarray(x))


def _comparable_slots(x, w, k, cap):
    """(G, E*C) bool: the slots of every expert that no near-tied token
    (k-th and (k+1)-th probabilities within ``MARGIN``) has as its k-th or
    (k+1)-th choice; the share of tokens that are not near-tied."""
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(w), axis=-1))
    g, s, e = probs.shape
    order = np.argsort(-probs, axis=-1, kind="stable")
    p = np.take_along_axis(probs, order, -1)
    near = (p[..., k - 1] - p[..., k]) <= MARGIN if k < e else np.zeros((g, s), bool)
    amb = np.zeros((g, e), bool)
    for gi, si in zip(*np.nonzero(near)):
        amb[gi, order[gi, si, k - 1]] = amb[gi, order[gi, si, k]] = True
    return np.repeat(~amb, cap, axis=1), float(1.0 - near.mean())


def _assert_routes_equal(got, want, ok, msg=""):
    idx, wgt, aux = (t.numpy() for t in got)
    ridx, rwgt, raux = (np.asarray(a) for a in want)
    assert idx.dtype == np.int32 and idx.shape == ridx.shape, msg
    np.testing.assert_array_equal(idx[ok], ridx[ok], err_msg=msg)
    np.testing.assert_allclose(wgt[ok], rwgt[ok], rtol=0, atol=WGT_ATOL, err_msg=msg)
    np.testing.assert_allclose(aux, raux, rtol=0, atol=AUX_ATOL, err_msg=msg)


# --------------------------------------------------------------------------- #
# route_group
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("s", [1, 24])
def test_route_group_matches_reference(arch, s):
    """Every group of a batch routed in one call, at the capacity
    ``moe_ffn`` gives the group (decode's 1, prefill's larger one)."""
    cfg, x, w = _routing_inputs(arch, s=s)
    k, e = cfg.top_k, cfg.n_experts
    cap = max(1, int(-(-s * k * cfg.capacity_factor // e)))
    got = moe.route_group(torch.from_numpy(x), torch.from_numpy(w),
                          top_k=k, capacity=cap)
    ok, share = _comparable_slots(x, w, k, cap)
    assert share > 0.9
    _assert_routes_equal(got, _ref_route(x, w, k, cap), ok, arch)
    # one group alone: the reference's signature, (S, D) -> (E*C,)
    one = moe.route_group(torch.from_numpy(x[1]), torch.from_numpy(w),
                          top_k=k, capacity=cap)
    assert one[0].shape == (e * cap,) and one[2].shape == ()
    for a, b in zip(one, got):
        torch.testing.assert_close(a, b[1], rtol=0, atol=0)


def test_route_group_breaks_ties_to_the_lower_expert():
    """Exact ties (integer inputs, so every logit is exact): three equal
    router columns for two slots pick the lower two, as ``lax.top_k``; an
    all-zero router picks experts 0..k-1."""
    e, k, d, s = 8, 2, 16, 12
    rng = np.random.default_rng(1)
    x = rng.integers(-2, 3, (2, s, d)).astype(np.float32)
    x[..., 0] = 1.0
    col = rng.integers(-2, 3, d).astype(np.float32)
    w = np.tile(col[:, None], (1, e))
    w[0, [0, 1, 3, 4, 7]] -= 50.0                  # the others lose
    for router, want_experts in ((w, (2, 5)), (np.zeros((d, e), np.float32), (0, 1))):
        cap = s
        got = moe.route_group(torch.from_numpy(x), torch.from_numpy(router),
                              top_k=k, capacity=cap)
        want = _ref_route(x, router, k, cap)
        _assert_routes_equal(got, want, np.ones((2, e * cap), bool), "ties")
        idx = got[0].numpy().reshape(2, e, cap)
        for ex in range(e):
            full = ex in want_experts
            assert (idx[:, ex] == np.arange(s)).all() if full else (idx[:, ex] == s).all()
        np.testing.assert_array_equal(got[1].numpy()[idx.reshape(2, -1) < s], 0.5)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_route_group_drops_past_capacity_like_the_reference(arch):
    """A capacity below the load: the kept slots hold the same tokens and
    weights as the reference's, the dropped ones the sentinel S with
    weight 0."""
    cfg, x, w = _routing_inputs(arch, s=32, seed=2)
    k, e = cfg.top_k, cfg.n_experts
    cap = max(1, int(-(-32 * k * 0.4 // e)))
    got = moe.route_group(torch.from_numpy(x), torch.from_numpy(w),
                          top_k=k, capacity=cap)
    ok, _ = _comparable_slots(x, w, k, cap)
    want = _ref_route(x, w, k, cap)
    _assert_routes_equal(got, want, ok, arch)
    idx, wgt = got[0].numpy(), got[1].numpy()
    kept = int((idx < 32).sum())
    assert kept < 3 * 32 * k                        # assignments were dropped
    assert (wgt[idx == 32] == 0).all() and (wgt[idx < 32] > 0).all()
    np.testing.assert_array_equal(idx == 32, np.asarray(want[0]) == 32)


# --------------------------------------------------------------------------- #
# moe_ffn
# --------------------------------------------------------------------------- #


def _ffn_inputs(arch: str, seed=4):
    cfg = configs.get(arch).make_smoke_config()
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((2, 24, d)),
            rng.standard_normal((d, e)) / np.sqrt(d),
            rng.standard_normal((e, d, f)) / np.sqrt(d),
            rng.standard_normal((e, d, f)) / np.sqrt(d),
            rng.standard_normal((e, f, d)) / np.sqrt(f)]
    return cfg, [a.astype(np.float32) for a in arrs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_reference(arch, dtype):
    cfg, arrs = _ffn_inputs(arch)
    x, w = arrs[0], arrs[1]
    cap = max(1, int(-(-24 * cfg.top_k * cfg.capacity_factor // cfg.n_experts)))
    ok, share = _comparable_slots(x, w, cfg.top_k, cap)
    assert share == 1.0                             # no near tie to flip
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want, raux = ref_moe.moe_ffn(jnp.asarray(x, jd), *map(jnp.asarray, arrs[1:]),
                                 top_k=cfg.top_k)
    got, aux = moe.moe_ffn(torch.from_numpy(x).to(td),
                           *map(torch.from_numpy, arrs[1:]), top_k=cfg.top_k)
    assert got.dtype == td and got.shape == x.shape
    assert_rel(got, want, FFN_REL if dtype == "float32" else BF16_REL, "moe_ffn")
    assert abs(float(aux) - float(raux)) <= AUX_ATOL


# --------------------------------------------------------------------------- #
# the MoE smoke configs, served with the reference's weights
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_smoke_config_serving_matches_reference(arch):
    """trunk (activations and aux), prefill logits and caches, 4 decode
    steps (logits, caches in place, greedy tokens where the margin allows);
    mixtral's window of 16 under 32 prompt tokens wraps the ring."""
    ref_cfg, cfg = _smoke_pair(arch)
    assert cfg.moe and (cfg.attn == "mla") == (arch == MOE_ARCHS[0])
    _serve_parity(ref_cfg, cfg, steps=4)


def test_moe_param_tree_is_the_reference_tree():
    """The MoE leaves (``moe_layers``, ``router``, ``shared``) carry over
    by name, shape and dtype; mixtral's full config holds bf16 leaves."""
    for arch in MOE_ARCHS:
        ref_cfg, cfg = _smoke_pair(arch)
        want = {".".join(p.key for p in path): (tuple(l.shape), l.dtype.name)
                for path, l in jax.tree_util.tree_flatten_with_path(
                    RT.abstract(ref_cfg))[0]}
        model = T.init(cfg, torch.Generator().manual_seed(0))
        got = {n: (tuple(p.shape), str(p.dtype).removeprefix("torch."))
               for n, p in model.named_parameters()}
        assert got == want and "moe_layers.ffn.router" in got
        assert ("dense_layers.attn.wq" in got) == (cfg.n_dense_layers > 0)
    full = configs.get("mixtral-8x22b").make_config()
    abstract = T.abstract(full)
    assert abstract["moe_layers"]["ffn"]["w1"].dtype == torch.bfloat16
    assert tuple(abstract["moe_layers"]["ffn"]["w1"].shape) == (56, 8, 6144, 16384)
    shared = T.abstract(configs.get("deepseek-v2-lite-16b").make_config())
    assert tuple(shared["moe_layers"]["ffn"]["shared"]["w1"].shape) == (26, 2048, 2816)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_matches_full_forward(arch):
    """Port of ``tests/test_system.py::test_decode_matches_full_forward`` to
    the MoE smoke configs: the decode step at position 32 gives the logits
    of ``trunk`` on 33 tokens (``atol=2e-4``) and equals the reference's
    decode step.  A decode group is one token (capacity 1, its k experts
    distinct: nothing drops), while a 33-token forward at capacity factor
    1.25 may drop assignments and so compute another function; the forward
    here runs at capacity factor E/k (capacity S: nothing drops), which
    leaves the decode step's capacity at 1."""
    ref_cfg, cfg = _smoke_pair(arch)
    params, model = _carried(ref_cfg, cfg)
    toks = torch.from_numpy(_tokens(cfg.vocab, seed=1))
    logits_pf, cache = T.prefill(model, toks)
    nxt = logits_pf.argmax(-1).to(torch.int32)
    if not cfg.window:
        cache = _extend(cache, 8)
    logits_d, _ = T.decode_step(model, cache, nxt, 32)
    nodrop = T.LM(dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k),
                  model.tree())
    x, _, _ = T.trunk(nodrop, torch.cat([toks, nxt[:, None]], 1))
    full = torch.einsum("bd,vd->bv", x[:, -1], model.embed.to(x.dtype))
    np.testing.assert_allclose(full.numpy(), logits_d.numpy(), atol=LOGIT_ATOL)
    cache_ref = RT.prefill(params, jnp.asarray(toks.numpy()), ref_cfg)[1]
    if not cfg.window:
        cache_ref = _extend(cache_ref, 8)
    want, _ = RT.decode_step(params, cache_ref, jnp.asarray(nxt.numpy()),
                             jnp.int32(32), ref_cfg)
    assert_logits(logits_d, want, msg="decode vs the reference's")


@pytest.mark.parametrize("arch", sorted(a for a, s in configs.ARCHS.items()
                                         if s.family == "lm"))
def test_smoke_lm_serve(arch):
    """Port of ``tests/test_arch_smoke.py::test_smoke_lm_serve`` for every
    ported LM: the ``prefill_32k`` and ``decode_32k`` step functions on a
    smoke batch (a zero cache for decode), finite and of the right shape,
    and equal to the reference's jitted step functions on the same
    weights."""
    ref_spec, spec = ref_configs.get(arch), configs.get(arch)
    ref_cfg, cfg = ref_spec.make_smoke_config(), spec.make_smoke_config()
    params, model = _carried(ref_cfg, cfg)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (2, 32)).astype(np.int32)
    step, _ = STEP_FNS["lm"](cfg, spec.shapes["prefill_32k"])
    ref_step, _ = REF_STEP_FNS["lm"](ref_cfg, ref_spec.shapes["prefill_32k"], None)
    logits, _ = step(model, {"tokens": torch.from_numpy(toks)})
    want, _ = jax.jit(ref_step)(params, {"tokens": jnp.asarray(toks)})
    assert logits.shape == (2, cfg.vocab) and bool(torch.isfinite(logits).all())
    assert_logits(logits, want, msg=f"{arch} prefill")
    tok = rng.integers(0, cfg.vocab, (2,)).astype(np.int32)
    cache = {k: torch.zeros(v.shape, dtype=v.dtype)
             for k, v in T.cache_spec(cfg, 2, 32).items()}
    ref_cache = jax.tree.map(lambda st: jnp.zeros(st.shape, st.dtype),
                             RT.cache_spec(ref_cfg, 2, 32))
    step, _ = STEP_FNS["lm"](cfg, spec.shapes["decode_32k"])
    ref_step, _ = REF_STEP_FNS["lm"](ref_cfg, ref_spec.shapes["decode_32k"], None)
    logits, _ = step(model, {"token": torch.from_numpy(tok), "pos": 31,
                             "cache": cache})
    want, _ = jax.jit(ref_step)(params, {"token": jnp.asarray(tok),
                                         "pos": jnp.int32(31), "cache": ref_cache})
    assert logits.shape == (2, cfg.vocab) and bool(torch.isfinite(logits).all())
    assert_logits(logits, want, msg=f"{arch} decode")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_smoke_serving_on_the_card_equals_the_cpu(arch, cuda_device):
    """An MoE smoke-config prefill and 4 decode steps on the card equal the
    same on the CPU within the fp32 logit tolerance (full-fp32 matmuls on
    the card), the CPU run's greedy tokens fed to both."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get(arch).make_smoke_config()
    cpu = T.init(cfg, torch.Generator().manual_seed(0))
    gpu = T.LM(cfg, specs.tree_map(lambda t: t.to(cuda_device), cpu.tree()))
    toks = torch.from_numpy(_tokens(cfg.vocab))
    outs, fed = [], []
    for model, dev in ((cpu, "cpu"), (gpu, cuda_device)):
        lg, cache = T.prefill(model, toks.to(dev))
        assert all(c.device.type == torch.device(dev).type for c in cache.values())
        if not cfg.window:
            cache = _extend(cache, 4)
        steps = [lg.cpu()]
        for i in range(4):
            if dev == "cpu":
                fed.append(lg.argmax(-1))
            lg, cache = T.decode_step(model, cache, fed[i].to(dev), 32 + i)
            steps.append(lg.cpu())
        outs.append(steps)
    for i, (a, b) in enumerate(zip(*outs)):
        assert float((a - b).abs().max()) <= LOGIT_ATOL, i
