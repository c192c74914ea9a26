"""Recsys serving of the port against the JAX package's ``models/recsys.py``,
``models/embedding.py`` and ``configs``: DLRM, Wide&Deep, DIN and DIEN at
their smoke configs with the reference's weights carried across
(``load_reference_params``), on seeded numpy batches (the port's
``launch/batches.py``, which draws the reference's ``_smoke_batch`` arrays).

Tolerances: the forwards, ``serve``, ``loss_fn`` and ``retrieval_topk``'s
scores within 1e-5 of their largest magnitude (XLA on the CPU and torch
differ by ulps in ``exp``, ``tanh`` and summation order); the lookups and
the batches bitwise; ``retrieval_topk``'s ids equal, as sets only among
scores closer than the tolerance.  The chunked passes against the
unchunked ones hold to the same 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_arch_smoke
from repro import configs as ref_configs
from repro.configs import base as ref_base
from repro.models import embedding as ref_emb
from repro.models import recsys as RR
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.launch.batches import cell_batch, smoke_batch
from repro_torch.models import embedding
from repro_torch.models import recsys as R
from repro_torch.models import specs

from _torch_parity import cuda_device  # noqa: F401  (fixture)

REL = 1e-5
RECSYS = ["din", "dien", "wide-deep", "dlrm-rm2"]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_rel(got, want, rel=REL, msg=""):
    g, w = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert g.shape == w.shape, (msg, g.shape, w.shape)
    bound = rel * max(float(np.abs(w).max()), 1e-30)
    err = float(np.abs(g - w).max())
    assert err <= bound, f"{msg}: max |diff| {err} > {bound}"


def assert_topk(got, want, rel=REL, msg=""):
    """Scores within ``rel`` of the largest; ids equal, as sets within each
    run of reference scores closer than that."""
    (gs, gi), (ws, wi) = [(_np(s), _np(i)) for s, i in (got, want)]
    assert_rel(gs, ws, rel, msg)
    tol = rel * max(float(np.abs(ws).max()), 1e-30)
    runs = np.split(np.arange(len(ws)), np.flatnonzero(np.diff(ws) < -tol) + 1)
    for r in runs:
        assert sorted(gi[r].tolist()) == sorted(wi[r].tolist()), (msg, r)


def _jit(fn):
    """A reference function jitted with its config static: one compile per
    batch shape instead of one dispatch per primitive."""
    return jax.jit(fn, static_argnums=2)


def _pair(arch: str, seed: int = 0, **kw):
    """The reference's smoke config and ``init`` weights, and the port's
    module holding a copy of them (``kw`` replaces config fields)."""
    ref_cfg = dataclasses.replace(ref_configs.get(arch).make_smoke_config(), **kw)
    cfg = dataclasses.replace(configs.get(arch).make_smoke_config(), **kw)
    params = RR.init(ref_cfg, jax.random.PRNGKey(seed))
    model = R.init(cfg, torch.Generator().manual_seed(seed + 1))
    R.load_reference_params(model, jax.tree.map(np.asarray, params))
    return ref_cfg, cfg, params, model


def _batch(arch: str, cfg, shape: str, seed: int = 3):
    """A seeded smoke batch for the port and the same arrays for the
    reference; a retrieval batch keeps one query row."""
    spec = configs.get(arch)
    cell = spec.shapes[shape]
    tb = smoke_batch(spec, cfg, cell, np.random.default_rng(seed))
    if cell.kind == "retrieval":
        tb = {k: (v if k.startswith("cand_") else v[:1]) for k, v in tb.items()}
    return tb, {k: jnp.asarray(v.numpy()) for k, v in tb.items()}


# --------------------------------------------------------------------------- #
# configs and registry
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", RECSYS)
def test_configs_and_input_specs_equal_the_reference(arch):
    spec, ref_spec = configs.get(arch), ref_configs.get(arch)
    for make in ("make_config", "make_smoke_config"):
        got = dataclasses.asdict(getattr(spec, make)())
        want = dataclasses.asdict(getattr(ref_spec, make)())
        assert str(got.pop("dtype")).removeprefix("torch.") == jnp.dtype(want.pop("dtype")).name
        assert got == want, (arch, make)
    assert spec.family == ref_spec.family == "recsys"
    assert list(spec.shapes) == list(ref_spec.shapes)
    for name, cell in spec.shapes.items():
        assert dataclasses.asdict(cell) == dataclasses.asdict(ref_spec.shapes[name])
        cfg = spec.make_config()
        got = base.recsys_input_specs(cfg, cell)
        want = ref_base.recsys_input_specs(ref_spec.make_config(), ref_spec.shapes[name])
        assert list(got) == list(want), (arch, name)
        for k, v in got.items():
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(want[k].shape), (arch, name, k)
            assert str(v.dtype).removeprefix("torch.") == want[k].dtype.name


def test_full_configs_count_the_reference_params():
    """The full configs' parameter counts (the issue's figures), port and
    reference alike."""
    want = {"dlrm-rm2": 1_745_592_641, "wide-deep": 1_386_088_449,
            "din": 21_588_618, "dien": 21_729_954}
    for arch, n in want.items():
        cfg = configs.get(arch).make_config()
        ref = ref_configs.get(arch).make_config()
        assert specs.count_params(R.param_specs(cfg)) == n, arch
        assert sum(int(np.prod(s.shape)) for s in jax.tree.leaves(RR.abstract(ref))) == n


# --------------------------------------------------------------------------- #
# embedding
# --------------------------------------------------------------------------- #


def test_embedding_lookups_bitwise_and_bags():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((50, 6)).astype(np.float32)
    tables = rng.standard_normal((3, 50, 6)).astype(np.float32)
    ids = rng.integers(0, 50, (4, 7)).astype(np.int32)
    sids = rng.integers(0, 50, (4, 5, 3)).astype(np.int32)
    valid = rng.random((4, 7)) < 0.6
    valid[0] = False                       # an empty bag
    t, ts = torch.from_numpy(table), torch.from_numpy(tables)
    got = embedding.lookup(t, torch.from_numpy(ids))
    assert np.array_equal(_np(got), np.asarray(ref_emb.lookup(jnp.asarray(table), jnp.asarray(ids))))
    got = embedding.lookup_stacked(ts, torch.from_numpy(sids))
    want = ref_emb.lookup_stacked(jnp.asarray(tables), jnp.asarray(sids))
    assert got.shape == (4, 5, 3, 6)
    assert np.array_equal(_np(got), np.asarray(want))
    for v in (None, valid):
        tv = None if v is None else torch.from_numpy(v)
        jv = None if v is None else jnp.asarray(v)
        for fn, rf in ((embedding.bag_sum, ref_emb.bag_sum),
                       (embedding.bag_mean, ref_emb.bag_mean)):
            assert_rel(fn(t, torch.from_numpy(ids), tv),
                       rf(jnp.asarray(table), jnp.asarray(ids), jv), msg=fn.__name__)


# --------------------------------------------------------------------------- #
# the forwards, serve, loss, retrieval
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch", RECSYS)
def test_forward_serve_and_loss_match_reference(arch):
    ref_cfg, cfg, params, model = _pair(arch)
    tb, jb = _batch(arch, cfg, "serve_p99")
    assert_rel(R.forward(model, tb), _jit(RR.forward)(params, jb, ref_cfg), msg="forward")
    assert_rel(R.serve(model, tb), _jit(RR.serve)(params, jb, ref_cfg), msg="serve")
    tb, jb = _batch(arch, cfg, "train_batch", seed=4)
    loss, aux = R.loss_fn(model, tb)
    want, waux = _jit(RR.loss_fn)(params, jb, ref_cfg)
    assert_rel(loss, want, msg="loss")
    assert set(aux) == set(waux) and aux["bce"] is loss


@pytest.mark.parametrize("arch", RECSYS)
def test_retrieval_topk_matches_reference(arch):
    ref_cfg, cfg, params, model = _pair(arch)
    tb, jb = _batch(arch, cfg, "retrieval_cand")
    got = R.retrieval_topk(model, tb)
    want = _jit(RR.retrieval_topk)(params, jb, ref_cfg)
    assert got[0].shape == (64,) and got[1].dtype == torch.int32
    assert_topk(got, want, msg=arch)
    got = R.retrieval_topk(model, tb, k=10)
    assert_topk(got, jax.jit(RR.retrieval_topk, static_argnums=(2, 3))(
        params, jb, ref_cfg, 10), msg=f"{arch} k=10")


@pytest.mark.parametrize("arch", ["din", "dien"])
def test_history_lengths_0_and_1(arch):
    """Histories of length 1 and 0 (DIEN's masked softmax gives weights 0,
    not NaN, where every step is masked)."""
    ref_cfg, cfg, params, model = _pair(arch)
    tb, _ = _batch(arch, cfg, "serve_p99")
    tb["hist_len"] = torch.tensor([0, 1, 1, 2, 0, 9, 1, 3], dtype=torch.int32)
    jb = {k: jnp.asarray(v.numpy()) for k, v in tb.items()}
    got = R.forward(model, tb)
    assert bool(torch.isfinite(got).all())
    assert_rel(got, _jit(RR.forward)(params, jb, ref_cfg))


def test_gru_scan_and_augru_on_masked_histories():
    ref_cfg, cfg, params, model = _pair("dien")
    p, jp = model.tree(), params
    rng = np.random.default_rng(7)
    b, l = 6, cfg.seq_len
    x = rng.standard_normal((b, l, cfg.pair_dim)).astype(np.float32)
    hist_len = np.array([1, 1, 4, l, 2, 7])
    mask = np.arange(l)[None, :] < hist_len[:, None]
    a = rng.random((b, l)).astype(np.float32)
    h, hs = R._gru_scan(p["gru1"], torch.from_numpy(x), torch.from_numpy(mask))
    wh, whs = RR._gru_scan(jp["gru1"], jnp.asarray(x), jnp.asarray(mask))
    assert_rel(h, wh, msg="gru h")
    assert_rel(hs, whs, msg="gru hs")
    # a masked step keeps the state: hist_len 1 holds step 0's state after it
    assert torch.equal(hs[0, -1], hs[0, 0]) and torch.equal(h[1], hs[1, 0])
    hs_np = _np(hs)
    h, hs2 = R._gru_scan(p["augru"], hs, torch.from_numpy(mask), a=torch.from_numpy(a))
    wh, whs2 = RR._gru_scan(jp["augru"], jnp.asarray(hs_np), jnp.asarray(mask),
                            a=jnp.asarray(a))
    assert_rel(h, wh, msg="augru h")
    assert_rel(hs2, whs2, msg="augru hs")


def test_dlrm_pair_order_at_27():
    """DLRM's interaction pairs at the full config's 26 tables plus one:
    torch.triu_indices gives jnp.triu_indices's row-major order, and a
    26-table forward equals the reference's."""
    iu, ju = torch.triu_indices(27, 27, offset=1)
    wi, wj = jnp.triu_indices(27, k=1)
    assert np.array_equal(_np(iu), np.asarray(wi)) and np.array_equal(_np(ju), np.asarray(wj))
    assert iu.numel() == 27 * 26 // 2
    ref_cfg, cfg, params, model = _pair("dlrm-rm2", n_sparse=26, embed_dim=4,
                                        table_rows=16, bot_mlp=(8, 4),
                                        top_mlp=(8, 1))
    tb, jb = _batch("dlrm-rm2", cfg, "serve_p99", seed=9)
    assert tb["sparse"].shape == (8, 26)
    assert_rel(R.forward(model, tb), _jit(RR.forward)(params, jb, ref_cfg))


def test_retrieval_ties_return_the_lower_index_first(monkeypatch):
    """Two candidate ids with identical rows tie exactly: the one at the
    lower candidate index comes first, as lax.top_k orders it, also when
    the tie straddles two chunks."""
    ref_cfg, cfg, params, model = _pair("wide-deep")
    tree = jax.tree.map(np.array, params)
    for leaf in ("tables", "wide"):
        tree[leaf][0, 3] = tree[leaf][0, 9]
    params = jax.tree.map(jnp.asarray, tree)
    R.load_reference_params(model, tree)
    tb, _ = _batch("wide-deep", cfg, "retrieval_cand")
    cand = np.array([9, 5, 3, 9, 11, 3, 7, 2], np.int32)
    tb["cand_items"] = torch.from_numpy(cand)
    jb = {k: jnp.asarray(v.numpy()) for k, v in tb.items()}
    ws, wi = RR.retrieval_topk(params, jb, ref_cfg, k=8)
    assert len(set(np.asarray(ws)[np.isin(np.asarray(wi), (3, 9))].tolist())) == 1
    s, i = R._top(torch.tensor([1.0, 2.0, 2.0, 1.0]), 3)
    assert i.tolist() == [1, 2, 0] and s.tolist() == [2.0, 2.0, 1.0]
    for chunk in (R.ROW_CHUNK, 3, 1):
        monkeypatch.setattr(R, "ROW_CHUNK", chunk)
        gs, gi = R.retrieval_topk(model, tb, k=8)
        assert _np(gi).tolist() == np.asarray(wi).tolist(), chunk
        ties = [int(x) for x in _np(gi) if x in (3, 9)]
        assert ties == [9, 3, 9, 3], (chunk, ties)
        assert_rel(gs, ws)


@pytest.mark.parametrize("arch", RECSYS)
def test_chunked_passes_equal_the_unchunked(arch, monkeypatch):
    """A forward over more rows than ``ROW_CHUNK`` and a retrieval over
    more candidates equal the one-pass forms."""
    _, cfg, _, model = _pair(arch)
    tb, _ = _batch(arch, cfg, "serve_p99")
    rb, _ = _batch(arch, cfg, "retrieval_cand")
    whole = R.forward(model, tb)
    top = R.retrieval_topk(model, rb, k=10)
    logits = R.candidate_logits(model, rb)
    for chunk in (3, 7):
        monkeypatch.setattr(R, "ROW_CHUNK", chunk)
        assert_rel(R.forward(model, tb), whole, msg=f"forward, chunk {chunk}")
        assert_topk(R.retrieval_topk(model, rb, k=10), top, msg=f"top k, chunk {chunk}")
        assert_rel(R.candidate_logits(model, rb), logits, msg=f"logits, chunk {chunk}")
        assert_rel(R.candidate_logits(model, rb, 5, 40), logits[5:40])
    # the top k of one stable sort over every candidate's logit
    s, i = torch.sort(logits, descending=True, stable=True)
    assert_topk(top, (s[:10], rb["cand_items"][i[:10]]))


# --------------------------------------------------------------------------- #
# batches, step functions, the smoke test's port
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("arch,shape", [
    (a, s) for a in RECSYS for s in ("train_batch", "serve_p99", "retrieval_cand")
] + [("egnn", "full_graph_sm"), ("egnn", "molecule")])
def test_smoke_batch_draws_the_reference_arrays(arch, shape, monkeypatch):
    """``smoke_batch`` on a fresh generator draws bitwise what the
    reference's ``_smoke_batch`` draws from its module generator reset to
    the same seed."""
    spec, ref_spec = configs.get(arch), ref_configs.get(arch)
    cfg = spec.config_for_cell(spec.make_smoke_config(), spec.shapes[shape])
    ref_cfg = ref_spec.config_for_cell(ref_spec.make_smoke_config(), ref_spec.shapes[shape])
    monkeypatch.setattr(test_arch_smoke, "RNG", np.random.default_rng(21))
    want = test_arch_smoke._smoke_batch(ref_spec, ref_cfg, ref_spec.shapes[shape])
    got = smoke_batch(spec, cfg, spec.shapes[shape], np.random.default_rng(21))
    assert list(got) == list(want)
    for k, v in got.items():
        w = np.asarray(want[k])
        assert str(v.dtype).removeprefix("torch.") == w.dtype.name, k
        assert np.array_equal(_np(v), w), (arch, shape, k)


def test_cell_batch_has_the_cells_shapes():
    """``cell_batch`` at a cell's own size (shapes of ``input_specs``), ids
    inside every table."""
    spec = configs.get("din")
    cfg = spec.make_smoke_config()
    for name, cell in spec.shapes.items():
        cell = dataclasses.replace(cell, dims={k: min(v, 300) for k, v in cell.dims.items()})
        got = cell_batch(spec, cfg, cell, np.random.default_rng(0))
        want = base.recsys_input_specs(cfg, cell)
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}, name
        assert int(got["hist_items"].max()) < cfg.item_vocab
        assert int(got["hist_len"].min()) >= 1


def test_step_fns_serve_retrieve_and_name_training():
    spec = configs.get("din")
    cfg = spec.make_smoke_config()
    model = R.init(cfg, torch.Generator().manual_seed(0))
    tb, _ = _batch("din", cfg, "serve_p99")
    fn, is_train = base.STEP_FNS["recsys"](cfg, spec.shapes["serve_bulk"])
    assert not is_train and torch.equal(fn(model, tb), R.serve(model, tb))
    rb, _ = _batch("din", cfg, "retrieval_cand")
    fn, _ = base.STEP_FNS["recsys"](cfg, spec.shapes["retrieval_cand"])
    s, i = fn(model, rb)
    ws, wi = R.retrieval_topk(model, rb, k=100)
    assert torch.equal(s, ws) and torch.equal(i, wi)
    with pytest.raises(NotImplementedError, match="A.13.4"):
        base.STEP_FNS["recsys"](cfg, spec.shapes["train_batch"])


@pytest.mark.parametrize("arch", RECSYS)
def test_smoke_recsys_serve_and_retrieval(arch):
    """The port of ``tests/test_arch_smoke.py::
    test_smoke_recsys_serve_and_retrieval``."""
    spec = configs.get(arch)
    cfg = spec.make_smoke_config()
    model = R.init(cfg, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(11)
    serve_cell = spec.shapes["serve_p99"]
    step_fn, _ = base.STEP_FNS["recsys"](cfg, serve_cell, None)
    probs = step_fn(model, smoke_batch(spec, cfg, serve_cell, rng))
    assert probs.shape == (8,) and bool(torch.isfinite(probs).all())
    assert float(probs.min()) >= 0 and float(probs.max()) <= 1
    retr_cell = spec.shapes["retrieval_cand"]
    step_fn, _ = base.STEP_FNS["recsys"](cfg, retr_cell, None)
    batch = smoke_batch(spec, cfg, retr_cell, rng)
    batch = {k: (v[:1] if k not in ("cand_items", "cand_cates") else v) for k, v in batch.items()}
    scores, ids = step_fn(model, batch)
    assert scores.shape[0] <= 100 and bool(torch.isfinite(scores).all())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", RECSYS)
def test_recsys_smoke_on_the_card_equals_the_cpu(arch, cuda_device):
    """A smoke config's serve and retrieval on the card equal the same on
    the CPU (full-fp32 products on the card)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = configs.get(arch)
    cfg = spec.make_smoke_config()
    cpu = R.init(cfg, torch.Generator().manual_seed(0))
    gpu = R.RecModel(cfg, specs.tree_map(lambda t: t.to(cuda_device), cpu.tree()))
    tb, _ = _batch(arch, cfg, "serve_p99")
    assert_rel(R.serve(gpu, {k: v.to(cuda_device) for k, v in tb.items()}),
               R.serve(cpu, tb))
    rb, _ = _batch(arch, cfg, "retrieval_cand")
    got = R.retrieval_topk(gpu, {k: v.to(cuda_device) for k, v in rb.items()}, k=10)
    assert got[0].device.type == "cuda"
    assert_topk(got, R.retrieval_topk(cpu, rb, k=10))
