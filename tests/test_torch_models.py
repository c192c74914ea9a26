"""The dense-LM serving path of the port against the JAX package's
``models`` and ``configs``: ``common`` and ``attention`` on the same inputs
(q chunks, right-pad, window, GQA groups, MLA decode); ``trunk``,
``prefill`` and ``decode_step`` of the three dense smoke configs, a
dense MLA config and a window config with the reference's weights carried
across by ``load_reference_params``; the port of
``tests/test_system.py::test_decode_matches_full_forward``; the configs
(the MoE ones too) field for field.  ``test_torch_moe.py`` serves the MoE
configs with this file's helpers.

Tolerances (float, not bitwise: XLA on the CPU and torch differ by ulps in
``pow``, ``rsqrt``, ``exp`` and summation order): fp32 logits ``atol=2e-4``
(the reference's own decode-vs-forward bound); the outputs of ``common``
and ``attention`` on the same inputs ``1e-5`` of their largest magnitude;
the whole model's activations and caches ``1e-4`` of theirs (RoPE's cos
and sin differ by ulps between XLA and torch, and a softmax over scores in
the hundreds amplifies that to about 1e-5 over two layers); bf16 outputs
``2e-2`` of their largest magnitude.
Greedy tokens are compared only where the reference's top-2 margin exceeds
the logit tolerance."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.configs import base as ref_base
from repro.models import attention as ref_attn
from repro.models import common as ref_common
from repro.models import specs as ref_specs
from repro.models import transformer as RT
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.models import attention, common, specs
from repro_torch.models import transformer as T
from repro_torch.optim import adamw_init

from _torch_parity import cuda_device  # noqa: F401  (fixture)

LOGIT_ATOL = 2e-4
REL = 1e-5
MODEL_REL = 1e-4
BF16_REL = 2e-2
AUX_ATOL = 1e-6
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}

# the dense MLA config of tests/test_system.py::test_decode_matches_full_forward
MLA_KW = dict(n_layers=2, d_model=64, n_heads=4, n_kv=4, head_dim=16, d_ff=128,
              vocab=256, q_chunk=8, kv_chunk=8, loss_chunk=8, attn="mla",
              kv_lora=32, qk_nope=16, qk_rope=8, v_head=16)
# a window smaller than the prompt: the prefill keeps the ring of its tail
WINDOW_KW = dict(n_layers=2, d_model=48, n_heads=4, n_kv=2, head_dim=12,
                 d_ff=96, vocab=384, window=8, q_chunk=16, kv_chunk=16,
                 loss_chunk=16)


def _f(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def assert_rel(got, want, rel=REL, msg=""):
    g, w = _f(got), _f(want)
    assert g.shape == w.shape, (msg, g.shape, w.shape)
    bound = rel * max(float(np.abs(w).max()), 1e-30)
    err = float(np.abs(g - w).max())
    assert err <= bound, f"{msg}: max |diff| {err} > {bound}"


def assert_logits(got, want, dtype="float32", msg=""):
    if dtype == "float32":
        err = float(np.abs(_f(got) - _f(want)).max())
        assert err <= LOGIT_ATOL, f"{msg}: max |diff| {err} > {LOGIT_ATOL}"
    else:
        assert_rel(got, want, BF16_REL, msg)


def assert_greedy(got_logits, want_logits, tol, msg=""):
    """argmax equal wherever the reference's top-2 margin exceeds ``tol``."""
    w = _f(want_logits)
    top2 = np.sort(w, axis=-1)[:, -2:]
    sure = top2[:, 1] - top2[:, 0] > tol
    g = _f(got_logits).argmax(-1)
    np.testing.assert_array_equal(g[sure], w.argmax(-1)[sure], err_msg=msg)


def _cfgs(kw: dict, dtype: str = "float32", name: str = "parity"):
    jd, td = DTYPES[dtype]
    return (RT.LMConfig(name=name, dtype=jd, **kw),
            T.LMConfig(name=name, dtype=td, **kw))


def _carried(ref_cfg, cfg, seed: int = 0, device="cpu"):
    """The reference's ``T.init`` weights, and the port's module holding a
    copy of them."""
    params = RT.init(ref_cfg, jax.random.PRNGKey(seed))
    g = torch.Generator(device=device)
    g.manual_seed(seed + 1)
    model = T.init(cfg, g)
    T.load_reference_params(model, jax.tree.map(np.asarray, params))
    return params, model


def _smoke_pair(arch: str, dtype: str = "float32"):
    ref_cfg = ref_configs.get(arch).make_smoke_config()
    cfg = configs.get(arch).make_smoke_config()
    if dtype != "float32":
        ref_cfg = dataclasses.replace(ref_cfg, dtype=DTYPES[dtype][0])
        cfg = dataclasses.replace(cfg, dtype=DTYPES[dtype][1])
    return ref_cfg, cfg


def _tokens(vocab, b=2, s=32, seed=5):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _extend(cache, n):
    """The serving loop's cache growth for ``n`` generated tokens."""
    if isinstance(next(iter(cache.values())), torch.Tensor):
        return {k: torch.cat([v, v.new_zeros(v.shape[:2] + (n,) + v.shape[3:])], 2)
                for k, v in cache.items()}
    return {k: jnp.concatenate([v, jnp.zeros(v.shape[:2] + (n,) + v.shape[3:], v.dtype)], 2)
            for k, v in cache.items()}


# --------------------------------------------------------------------------- #
# common and attention
# --------------------------------------------------------------------------- #


def test_common_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    assert_rel(common.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)),
               ref_common.rmsnorm(jnp.asarray(x), jnp.asarray(w)), msg="rmsnorm")
    assert_rel(common.rope_freqs(16, 500.0), ref_common.rope_freqs(16, 500.0),
               msg="rope_freqs")
    pos = np.arange(7, dtype=np.int32) + 3
    assert_rel(common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)),
               ref_common.apply_rope(jnp.asarray(x), jnp.asarray(pos)),
               msg="apply_rope")
    logits = rng.standard_normal((4, 9, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (4, 9)).astype(np.int32)
    mask = (rng.random((4, 9)) < 0.6).astype(np.float32)
    for m in (None, mask):
        got = common.cross_entropy(torch.from_numpy(logits),
                                   torch.from_numpy(labels),
                                   None if m is None else torch.from_numpy(m))
        want = ref_common.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                        None if m is None else jnp.asarray(m))
        assert_rel(got, want, msg="cross_entropy")


def test_rmsnorm_and_rope_keep_bf16():
    x = np.random.default_rng(1).standard_normal((2, 5, 2, 8)).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    xj = jnp.asarray(x, jnp.bfloat16)
    got = common.rmsnorm(xt, torch.ones(8))
    assert got.dtype == torch.bfloat16
    assert_rel(got, ref_common.rmsnorm(xj, jnp.ones(8)), BF16_REL, "rmsnorm bf16")
    pos = np.arange(5, dtype=np.int32)
    got = common.apply_rope(xt, torch.from_numpy(pos))
    assert got.dtype == torch.bfloat16
    assert_rel(got, ref_common.apply_rope(xj, jnp.asarray(pos)), BF16_REL,
               "apply_rope bf16")


@pytest.mark.parametrize("case", [
    # (B, Sq, H, KH, D, Dv, q_chunk, kv_chunk, window): one chunk; q chunks
    # with a ragged q tail and right-padded kv; GQA groups; SWA window;
    # Dv != D as in MLA
    (2, 16, 4, 4, 8, 8, 1024, 1024, None),
    (2, 21, 4, 2, 8, 8, 8, 6, None),
    (1, 19, 6, 2, 16, 16, 1 << 30, 8, None),
    (2, 24, 4, 1, 8, 8, 8, 8, 5),
    (2, 17, 4, 4, 12, 8, 16, 5, 7),
])
def test_full_attention_matches_reference(case):
    b, sq, h, kh, d, dv, qc, kc, window = case
    rng = np.random.default_rng(sq * 31 + h)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sq, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, sq, kh, dv)).astype(np.float32)
    got = attention.full_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True,
                                   window=window, q_chunk=qc, kv_chunk=kc)
    want = ref_attn.full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   causal=True, window=window, q_chunk=qc,
                                   kv_chunk=kc)
    assert_rel(got, want, msg=str(case))
    # non-causal, as a cross-attention would call it
    got = attention.full_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=False,
                                   q_chunk=qc, kv_chunk=kc)
    want = ref_attn.full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   causal=False, q_chunk=qc, kv_chunk=kc)
    assert_rel(got, want, msg=f"{case} non-causal")


@pytest.mark.parametrize("cache_len,window", [(13, None), (20, None), (13, 4)])
def test_decode_attention_matches_reference(cache_len, window):
    rng = np.random.default_rng(cache_len)
    q = rng.standard_normal((3, 1, 6, 8)).astype(np.float32)
    kc = rng.standard_normal((3, 20, 2, 8)).astype(np.float32)
    vc = rng.standard_normal((3, 20, 2, 8)).astype(np.float32)
    got = attention.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                     torch.from_numpy(vc), cache_len, window=window)
    want = ref_attn.decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                     jnp.int32(cache_len), window=window)
    assert_rel(got, want, msg="decode_attention")


def test_mla_decode_attention_matches_reference():
    rng = np.random.default_rng(7)
    b, h, s, lat, dn, dr, dv = 2, 4, 11, 16, 8, 4, 6
    arrs = [rng.standard_normal(shape).astype(np.float32) for shape in
            ((b, h, dn), (b, h, dr), (b, s, lat), (b, s, dr), (h, lat, dn),
             (h, lat, dv))]
    got = attention.mla_decode_attention(*map(torch.from_numpy, arrs[:4]), 9,
                                         *map(torch.from_numpy, arrs[4:]))
    want = ref_attn.mla_decode_attention(*map(jnp.asarray, arrs[:4]), jnp.int32(9),
                                         *map(jnp.asarray, arrs[4:]))
    assert got.shape == (b, 1, h, dv)
    assert_rel(got, want, msg="mla_decode_attention")


# --------------------------------------------------------------------------- #
# the model: trunk, prefill, decode_step with the reference's weights
# --------------------------------------------------------------------------- #


def _serve_parity(ref_cfg, cfg, dtype="float32", steps=4, seed=0):
    """prefill + ``steps`` greedy decode steps through both, the reference's
    tokens fed to both; every logit, cache and the trunk compared."""
    params, model = _carried(ref_cfg, cfg, seed)
    toks = _tokens(cfg.vocab)
    x_ref, aux_ref, _ = RT.trunk(params, jnp.asarray(toks), ref_cfg)
    x, aux, _ = T.trunk(model, torch.from_numpy(toks))
    if cfg.moe:
        assert abs(float(aux) - float(aux_ref)) <= AUX_ATOL, (float(aux), float(aux_ref))
    else:
        assert float(aux) == 0.0
    rel = MODEL_REL if dtype == "float32" else BF16_REL
    assert_rel(x, x_ref, rel, "trunk")
    lg_ref, cache_ref = RT.prefill(params, jnp.asarray(toks), ref_cfg)
    lg, cache = T.prefill(model, torch.from_numpy(toks))
    assert lg.dtype == cfg.dtype and set(cache) == set(cache_ref)
    assert_logits(lg, lg_ref, dtype, "prefill logits")
    for k in cache:
        assert cache[k].dtype == cfg.dtype
        assert_rel(cache[k], cache_ref[k], rel, f"prefill cache {k}")
    if not cfg.window:
        cache_ref, cache = _extend(cache_ref, steps), _extend(cache, steps)
    tol = LOGIT_ATOL if dtype == "float32" else BF16_REL * float(np.abs(_f(lg_ref)).max())
    assert_greedy(lg, lg_ref, tol, "prefill greedy")
    tok = jnp.argmax(lg_ref, -1).astype(jnp.int32)
    s = toks.shape[1]
    for i in range(steps):
        lg_ref, cache_ref = RT.decode_step(params, cache_ref, tok, jnp.int32(s + i), ref_cfg)
        ptrs = {k: v.data_ptr() for k, v in cache.items()}
        lg, cache2 = T.decode_step(model, cache, torch.from_numpy(np.array(tok)), s + i)
        assert cache2 is cache and {k: v.data_ptr() for k, v in cache.items()} == ptrs
        assert_logits(lg, lg_ref, dtype, f"decode step {i}")
        assert_greedy(lg, lg_ref, tol, f"decode greedy {i}")
        for k in cache:
            assert_rel(cache[k], cache_ref[k], rel, f"decode cache {k} step {i}")
        tok = jnp.argmax(lg_ref, -1).astype(jnp.int32)


@pytest.mark.parametrize("arch", ["smollm-135m", "starcoder2-3b", "starcoder2-7b"])
def test_smoke_config_serving_matches_reference(arch):
    _serve_parity(*_smoke_pair(arch))


def test_bf16_smoke_serving_matches_reference():
    _serve_parity(*_smoke_pair("smollm-135m", "bfloat16"), dtype="bfloat16", steps=2)


def test_dense_mla_serving_matches_reference():
    _serve_parity(*_cfgs(MLA_KW))


def test_window_ring_serving_matches_reference():
    """Window 8 under a 32-token prompt: the ring holds the tail at slot pos
    % 8, and decode wraps around it."""
    ref_cfg, cfg = _cfgs(WINDOW_KW)
    _serve_parity(ref_cfg, cfg, steps=10)
    _, model = _carried(ref_cfg, cfg)
    toks = torch.from_numpy(_tokens(cfg.vocab))
    _, cache = T.prefill(model, toks)
    _, _, full = T.trunk(model, toks, collect_cache=True)
    k_full = full["dense"][0]
    assert cache["k"].shape[2] == 8
    for p in range(24, 32):        # the ring slot of position p is p % 8
        torch.testing.assert_close(cache["k"][:, :, p % 8], k_full[:, :, p],
                                   rtol=0, atol=0)


def test_expand_kv_matches_reference():
    kw = dict(WINDOW_KW, window=None, expand_kv=True)
    _serve_parity(*_cfgs(kw), steps=1)


@pytest.mark.parametrize("attn", ["gqa", "mla"])
def test_decode_matches_full_forward(attn):
    """Port of tests/test_system.py::test_decode_matches_full_forward: the
    decode step at position 32 gives the logits of ``trunk`` on 33 tokens
    (the reference's bound, ``atol=2e-4``), here with the reference's
    weights; and both equal the reference's decode step."""
    kw = dict(n_layers=2, d_model=64, n_heads=4, n_kv=4, head_dim=16, d_ff=128,
              vocab=256, q_chunk=8, kv_chunk=8, loss_chunk=8)
    if attn == "mla":
        kw = MLA_KW
    ref_cfg, cfg = _cfgs(kw)
    params, model = _carried(ref_cfg, cfg)
    toks = torch.from_numpy(_tokens(256, seed=1))
    logits_pf, cache = T.prefill(model, toks)
    nxt = logits_pf.argmax(-1).to(torch.int32)
    cache = _extend(cache, 8)
    logits_d, _ = T.decode_step(model, cache, nxt, 32)
    x, _, _ = T.trunk(model, torch.cat([toks, nxt[:, None]], 1))
    full = torch.einsum("bd,vd->bv", x[:, -1], model.embed.to(x.dtype))
    np.testing.assert_allclose(full.numpy(), logits_d.numpy(), atol=2e-4)
    cache_ref = _extend(RT.prefill(params, jnp.asarray(toks.numpy()), ref_cfg)[1], 8)
    want, _ = RT.decode_step(params, cache_ref, jnp.asarray(nxt.numpy()),
                             jnp.int32(32), ref_cfg)
    assert_logits(logits_d, want, msg="decode vs the reference's")


def test_decode_clamps_a_full_cache_like_the_reference():
    """Past the cache's end the reference's ``dynamic_update_slice`` clamps
    the write to the last slot; the port does the same."""
    ref_cfg, cfg = _smoke_pair("smollm-135m")
    params, model = _carried(ref_cfg, cfg)
    toks = _tokens(cfg.vocab, s=12)
    _, cache_ref = RT.prefill(params, jnp.asarray(toks), ref_cfg)
    _, cache = T.prefill(model, torch.from_numpy(toks))
    tok = np.array([3, 4], np.int32)
    want, cache_ref = RT.decode_step(params, cache_ref, jnp.asarray(tok), jnp.int32(12), ref_cfg)
    got, cache = T.decode_step(model, cache, torch.from_numpy(tok), 12)
    assert_logits(got, want)
    assert_rel(cache["k"], cache_ref["k"], MODEL_REL, "clamped cache")


# --------------------------------------------------------------------------- #
# weights, specs, configs
# --------------------------------------------------------------------------- #


def test_load_reference_params_checks_every_leaf():
    ref_cfg, cfg = _smoke_pair("starcoder2-3b")
    tree = jax.tree.map(np.asarray, RT.init(ref_cfg, jax.random.PRNGKey(0)))
    model = T.init(cfg, torch.Generator().manual_seed(0))
    T.load_reference_params(model, tree)
    got = dict(model.named_parameters())
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        name = ".".join(p.key for p in path)
        np.testing.assert_array_equal(got[name].numpy(), leaf, err_msg=name)
    missing = {**tree, "dense_layers": {k: v for k, v in tree["dense_layers"].items()
                                        if k != "ffn_norm"}}
    with pytest.raises(KeyError, match="ffn_norm"):
        T.load_reference_params(model, missing)
    with pytest.raises(KeyError, match="extra"):
        T.load_reference_params(model, {**tree, "lm_head": tree["embed"]})
    with pytest.raises(ValueError, match="final_norm"):
        T.load_reference_params(model, {**tree, "final_norm": tree["final_norm"][:3]})
    with pytest.raises(TypeError, match="embed"):
        T.load_reference_params(model, {**tree, "embed": tree["embed"].astype(np.float16)})


def test_named_parameters_are_the_reference_tree():
    ref_cfg, cfg = _smoke_pair("smollm-135m")
    abstract = RT.abstract(ref_cfg)
    want = {".".join(p.key for p in path): (tuple(leaf.shape), leaf.dtype.name)
            for path, leaf in jax.tree_util.tree_flatten_with_path(abstract)[0]}
    model = T.init(cfg, torch.Generator().manual_seed(0))
    got = {n: (tuple(p.shape), str(p.dtype).removeprefix("torch."))
           for n, p in model.named_parameters()}
    assert got == want
    meta = T.abstract(cfg)
    assert meta["dense_layers"]["attn"]["wq"].device.type == "meta"
    assert T.axes(cfg) == jax.tree.map(lambda s: s.axes, RT.param_specs(ref_cfg),
                                       is_leaf=ref_specs.is_spec)


def test_init_params_is_seeded_and_scaled():
    cfg = configs.get("starcoder2-3b").make_smoke_config()
    a = T.init(cfg, torch.Generator().manual_seed(3))
    b = T.init(cfg, torch.Generator().manual_seed(3))
    c = T.init(cfg, torch.Generator().manual_seed(4))
    for (n, x), y, z in zip(a.named_parameters(), b.parameters(), c.parameters()):
        assert torch.equal(x, y), n
        if n.endswith("norm"):
            assert torch.equal(x, torch.ones_like(x)), n
        else:
            assert not torch.equal(x, z), n
    assert abs(float(a.embed.std()) - 0.02) < 2e-3
    # the reference's fan-in is the second-to-last dim: wq (L, D, H=4, K)
    # draws at 1/sqrt(4), w2 (L, F=128, D) at 1/sqrt(128)
    wq, w2 = a.dense_layers.attn.wq, a.dense_layers.ffn.w2
    assert abs(float(wq.std()) - 0.5) < 0.05
    assert abs(float(w2.std()) - 128 ** -0.5) < 0.01


@pytest.mark.parametrize("arch", ["smollm-135m", "starcoder2-3b", "starcoder2-7b",
                                  "deepseek-v2-lite-16b", "mixtral-8x22b"])
def test_configs_equal_reference_field_for_field(arch):
    ref, spec = ref_configs.get(arch), configs.get(arch)
    assert spec.arch_id == ref.arch_id and spec.family == ref.family
    assert spec.notes == ref.notes
    assert {k: dataclasses.asdict(c) for k, c in spec.shapes.items()} == \
        {k: dataclasses.asdict(c) for k, c in ref.shapes.items()}
    for name, cell in ref.shapes.items():         # the same plans and axes
        cfg, rcfg = spec.make_config(), ref.make_config()
        assert spec.plan_for(cfg, spec.shapes[name]).rules == \
            ref.plan_for(rcfg, cell).rules
        assert spec.batch_axes(cfg, spec.shapes[name]) == \
            ref.batch_axes(rcfg, cell)
    for make in ("make_config", "make_smoke_config"):
        a, b = getattr(spec, make)(), getattr(ref, make)()
        for f in dataclasses.fields(b):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if f.name in ("dtype", "param_dtype"):
                assert str(va).removeprefix("torch.") == jnp.dtype(vb).name, f.name
            else:
                assert va == vb, (make, f.name)
        assert [f.name for f in dataclasses.fields(a)] == \
            [f.name for f in dataclasses.fields(b)]
    # the specs: same parameter count at full width, no memory allocated
    full = spec.make_config()
    assert specs.count_params(T.param_specs(full)) == \
        ref_specs.count_params(RT.param_specs(ref.make_config()))


def test_input_specs_match_reference():
    cfg = configs.get("starcoder2-3b").make_config()
    ref_cfg = ref_configs.get("starcoder2-3b").make_config()
    for name, cell in base.LM_SHAPES.items():
        got = base.lm_input_specs(cfg, cell)
        want = ref_base.lm_input_specs(ref_cfg, ref_base.LM_SHAPES[name])
        flat_w = {".".join(p.key for p in path): leaf for path, leaf in
                  jax.tree_util.tree_flatten_with_path(want)[0]}
        flat_g = {}
        for k, v in got.items():
            if isinstance(v, dict):
                flat_g.update({f"{k}.{kk}": vv for kk, vv in v.items()})
            else:
                flat_g[k] = v
        assert set(flat_g) == set(flat_w), name
        for k, v in flat_g.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(flat_w[k].shape), (name, k)
            assert str(v.dtype).removeprefix("torch.") == flat_w[k].dtype.name


def test_step_fns_serve_and_name_what_waits():
    cfg = configs.get("smollm-135m").make_smoke_config()
    model = T.init(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(cfg.vocab, s=8))
    fn, is_train = base.STEP_FNS["lm"](cfg, base.LM_SHAPES["prefill_32k"])
    assert not is_train
    logits, cache = fn(model, {"tokens": toks})
    want = T.prefill(model, toks)[0]
    assert torch.equal(logits, want)
    fn, _ = base.STEP_FNS["lm"](cfg, base.LM_SHAPES["decode_32k"])
    out, _ = fn(model, {"cache": _extend(cache, 1), "token": want.argmax(-1), "pos": 8})
    assert out.shape == (2, cfg.vocab)
    # every train cell (the LM's, recsys', all of EGNN's) is a train step
    # since the training slice: step(model, opt, batch), AdamW in place
    fn, is_train = base.STEP_FNS["lm"](cfg, base.LM_SHAPES["train_4k"])
    assert is_train
    opt = adamw_init(model.tree())
    _, opt, metrics = fn(model, opt, {"tokens": toks, "labels": toks})
    assert int(opt["step"]) == 1 and set(metrics) == {"loss", "ce", "aux",
                                                       "grad_norm", "lr"}
    rcfg = configs.get("din").make_smoke_config()
    fn, is_train = base.STEP_FNS["recsys"](rcfg, base.RECSYS_SHAPES["serve_p99"])
    assert not is_train and callable(fn)
    fn, is_train = base.STEP_FNS["recsys"](rcfg, base.RECSYS_SHAPES["train_batch"])
    assert is_train and callable(fn)
    gspec = configs.get("egnn")
    for cell in gspec.shapes.values():
        fn, is_train = base.STEP_FNS["gnn"](gspec.make_smoke_config(), cell)
        assert is_train and callable(fn)


def test_registry_holds_the_dense_archs_and_names_the_rest():
    """Every architecture of the reference is ported, in its order (the
    LMs, EGNN and the four recsys models); nothing is pending; the cells
    are the reference's 40, 37 of them not skipped."""
    assert list(configs.ARCHS) == list(ref_configs.ARCHS) and len(configs.ARCHS) == 10
    assert configs.PENDING == {}
    for aid, spec in configs.ARCHS.items():
        assert configs.get(aid) is spec
        assert spec.family == ref_configs.ARCHS[aid].family
    for skipped in (True, False):
        want = [(a, n, dataclasses.asdict(c))
                for a, n, c in ref_configs.all_cells(include_skipped=skipped)]
        assert [(a, n, dataclasses.asdict(c))
                for a, n, c in configs.all_cells(include_skipped=skipped)] == want
    assert len(list(configs.all_cells())) == 40
    assert len(list(configs.all_cells(include_skipped=False))) == 37


def test_moe_config_raises_naming_its_step():
    """An MoE ``LMConfig`` builds, and its ``moe``, ``n_moe_layers`` and
    ``qk_dim`` equal the reference's (MoE with MLA, MoE with GQA, dense)."""
    for kw in (dict(n_experts=4, top_k=2, d_ff_expert=32, n_dense_layers=1,
                    attn="mla", kv_lora=16, qk_nope=8, qk_rope=4, v_head=8),
               dict(n_experts=4, top_k=2, d_ff_expert=32), {}):
        base_kw = dict(name="moe", n_layers=3, d_model=32, n_heads=2, n_kv=2,
                       head_dim=16, d_ff=64, vocab=64, **kw)
        got, want = T.LMConfig(**base_kw), RT.LMConfig(**base_kw)
        assert (got.moe, got.n_moe_layers, got.qk_dim) == \
            (want.moe, want.n_moe_layers, want.qk_dim), kw


@pytest.mark.cuda
def test_smoke_serving_on_the_card_equals_the_cpu(cuda_device):
    """A smoke-config prefill and decode on the card equal the same on the
    CPU within the fp32 logit tolerance (full-fp32 matmuls on the card), the
    CPU run's greedy tokens fed to both."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get("starcoder2-3b").make_smoke_config()
    cpu = T.init(cfg, torch.Generator().manual_seed(0))
    gpu = T.LM(cfg, specs.tree_map(lambda t: t.to(cuda_device), cpu.tree()))
    toks = torch.from_numpy(_tokens(cfg.vocab))
    outs, fed = [], []
    for model, dev in ((cpu, "cpu"), (gpu, cuda_device)):
        lg, cache = T.prefill(model, toks.to(dev))
        assert all(c.device.type == torch.device(dev).type for c in cache.values())
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
