"""The EGNN forward, its two losses' values and the neighbour sampler of the
port against the JAX package's ``models/egnn.py``, ``models/sampler.py``
and ``configs/egnn.py``, at the reference's smoke shapes
(``tests/test_arch_smoke.py::test_gnn_molecule_smoke``) with its weights
carried across (``load_reference_params``).

Tolerances: ``_layer``, ``forward`` and the losses within 1e-5 of their
largest magnitude (``index_add_`` sums in another order than
``segment_sum``); the edge-chunked layer against the unchunked one the
same; the E(n) invariance of ``h`` under a rotation and a translation of
the coordinates within 1e-5 of max |h| at this size; the sampler bitwise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import egnn as RE
from repro.models import sampler as ref_sampler
from repro_torch import configs
from repro_torch.configs import egnn as cfg_egnn
from repro_torch.launch.batches import smoke_batch, subgraph_batch
from repro_torch.models import egnn as E
from repro_torch.models import sampler, specs

from _torch_parity import cuda_device  # noqa: F401  (fixture)

REL = 1e-5
CELLS = ["full_graph_sm", "molecule"]


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


def _pair(cell: str, seed: int = 0):
    """The smoke config of a cell (d_feat 8, as the reference's molecule
    smoke test), the reference's weights, and the port's module holding a
    copy of them."""
    spec, ref_spec = configs.get("egnn"), ref_configs.get("egnn")
    cfg = dataclasses.replace(
        spec.config_for_cell(spec.make_smoke_config(), spec.shapes[cell]), d_feat=8)
    ref_cfg = dataclasses.replace(
        ref_spec.config_for_cell(ref_spec.make_smoke_config(), ref_spec.shapes[cell]), d_feat=8)
    params = RE.init(ref_cfg, jax.random.PRNGKey(seed))
    model = E.init(cfg, torch.Generator().manual_seed(seed + 1))
    E.load_reference_params(model, jax.tree.map(np.asarray, params))
    return ref_cfg, cfg, params, model


def _batch(cfg, cell: str, seed: int = 3):
    spec = configs.get("egnn")
    tb = smoke_batch(spec, cfg, spec.shapes[cell], np.random.default_rng(seed),
                     "cpu")
    return tb, {k: jnp.asarray(v.numpy()) for k, v in tb.items()}


def _rotation(seed: int) -> np.ndarray:
    q, r = np.linalg.qr(np.random.default_rng(seed).standard_normal((3, 3)))
    return (q * np.sign(np.diag(r))).astype(np.float32)


def test_configs_shapes_and_input_specs_equal_the_reference():
    spec, ref_spec = configs.get("egnn"), ref_configs.get("egnn")
    assert spec.family == ref_spec.family == "gnn"
    for make in ("make_config", "make_smoke_config"):
        got = dataclasses.asdict(getattr(spec, make)())
        want = dataclasses.asdict(getattr(ref_spec, make)())
        assert str(got.pop("dtype")).removeprefix("torch.") == jnp.dtype(want.pop("dtype")).name
        assert got == want, make
    assert list(spec.shapes) == list(ref_spec.shapes)
    for name, cell in spec.shapes.items():
        assert dataclasses.asdict(cell) == dataclasses.asdict(ref_spec.shapes[name])
        assert cell.kind == "train"
        cfg = spec.config_for_cell(spec.make_config(), cell)
        ref_cfg = ref_spec.config_for_cell(ref_spec.make_config(), ref_spec.shapes[name])
        assert (cfg.d_feat, cfg.n_classes, cfg.task) == (ref_cfg.d_feat, ref_cfg.n_classes, ref_cfg.task)
        got = spec.input_specs(cfg, cell)
        want = ref_spec.input_specs(ref_cfg, ref_spec.shapes[name])
        assert list(got) == list(want)
        for k, v in got.items():
            assert v.device.type == "meta" and tuple(v.shape) == tuple(want[k].shape)
            assert str(v.dtype).removeprefix("torch.") == want[k].dtype.name
    assert cfg_egnn._pad512(10556) == 10752
    assert specs.count_params(E.param_specs(spec.make_config())) == 215_411


def test_layer_matches_reference():
    ref_cfg, cfg, params, model = _pair("molecule")
    tb, jb = _batch(cfg, "molecule")
    rng = np.random.default_rng(5)
    h = rng.standard_normal((40, cfg.d_hidden)).astype(np.float32)
    lp = specs.tree_map(lambda t: t[0], model.tree()["layers"])
    jlp = jax.tree.map(lambda a: a[0], params["layers"])
    got = E._layer(lp, torch.from_numpy(h), tb["coords"], tb["src"], tb["dst"], 40)
    want = RE._layer(jlp, jnp.asarray(h), jb["coords"], jb["src"], jb["dst"], 40)
    assert_rel(got[0], want[0], msg="h")
    assert_rel(got[1], want[1], msg="x")


@pytest.mark.parametrize("cell", CELLS)
def test_forward_and_loss_match_reference(cell):
    ref_cfg, cfg, params, model = _pair(cell)
    tb, jb = _batch(cfg, cell)
    args = [tb[k] for k in ("feats", "coords", "src", "dst")]
    jargs = [jb[k] for k in ("feats", "coords", "src", "dst")]
    assert_rel(E.forward(model, *args), RE.forward(params, *jargs, ref_cfg), msg="h")
    loss, aux = E.loss_fn(model, tb)
    want, waux = RE.loss_fn(params, jb, ref_cfg)
    assert_rel(loss, want, msg="loss")
    assert set(aux) == set(waux) == {"ce" if cell == "full_graph_sm" else "mse"}
    named = E.node_class_loss if cell == "full_graph_sm" else E.graph_reg_loss
    assert torch.equal(named(model, tb)[0], loss)


def test_edge_chunked_layer_equals_the_unchunked(monkeypatch):
    _, cfg, _, model = _pair("full_graph_sm")
    tb, _ = _batch(cfg, "full_graph_sm")
    args = [tb[k] for k in ("feats", "coords", "src", "dst")]
    whole = E.forward(model, *args)
    for chunk in (7, 64):
        monkeypatch.setattr(E, "EDGE_CHUNK", chunk)
        assert_rel(E.forward(model, *args), whole, msg=f"chunk {chunk}")


def test_rotation_and_translation_leave_h_unchanged():
    """E(n) invariance of the node embeddings, and equivariance of one
    layer's coordinates, under a seeded orthogonal map and a shift."""
    _, cfg, _, model = _pair("full_graph_sm")
    tb, _ = _batch(cfg, "full_graph_sm")
    q, shift = torch.from_numpy(_rotation(2)), torch.tensor([0.5, -2.0, 3.0])
    moved = tb["coords"] @ q.T + shift
    h = E.forward(model, tb["feats"], tb["coords"], tb["src"], tb["dst"])
    assert_rel(E.forward(model, tb["feats"], moved, tb["src"], tb["dst"]), h)
    lp = specs.tree_map(lambda t: t[0], model.tree()["layers"])
    h0 = tb["feats"] @ model.tree()["embed_in"]
    _, x = E._layer(lp, h0, tb["coords"], tb["src"], tb["dst"], 40)
    _, xm = E._layer(lp, h0, moved, tb["src"], tb["dst"], 40)
    assert_rel(xm, x @ q.T + shift)


def test_sampler_bitwise_with_the_same_generator():
    got = sampler.CSRGraph.random(500, 6000, seed=4)
    want = ref_sampler.CSRGraph.random(500, 6000, seed=4)
    assert got.n_nodes == want.n_nodes
    for f in ("indptr", "indices"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    seeds = np.random.default_rng(1).choice(500, 32, replace=False)
    sub = sampler.sample_subgraph(got, seeds, (5, 3), np.random.default_rng(9))
    ref = ref_sampler.sample_subgraph(want, seeds, (5, 3), np.random.default_rng(9))
    assert set(sub) == set(ref) and sub["n_seed"] == ref["n_seed"] == 32
    for k in ("nodes", "src", "dst", "edge_valid"):
        assert sub[k].dtype == ref[k].dtype and np.array_equal(sub[k], ref[k]), k


def test_subgraph_batch_pads_to_the_cell():
    """A sampled subgraph padded to a cell: zero rows past its nodes,
    sentinel edges past its edges, the loss on the seeds only; a forward
    and a loss run on it."""
    g = sampler.CSRGraph.random(300, 4000, seed=0)
    seeds = np.arange(0, 300, 30)
    sub = sampler.sample_subgraph(g, seeds, (4, 3), np.random.default_rng(2))
    m, e = len(sub["nodes"]), len(sub["src"])
    cell = dataclasses.replace(configs.get("egnn").shapes["minibatch_lg"],
                               dims={**configs.get("egnn").shapes["minibatch_lg"].dims,
                                     "n_nodes": m + 9, "n_edges": e + 5})
    _, cfg, _, model = _pair("full_graph_sm")
    b = subgraph_batch(sub, seeds, cfg, cell, np.random.default_rng(0), "cpu")
    assert b["feats"].shape == (m + 9, cfg.d_feat) and b["src"].shape == (e + 5,)
    assert not b["feats"][m:].any() and not b["coords"][m:].any()
    assert (b["src"][e:] == m).all() and (b["dst"][e:] == m).all()
    assert int(b["label_mask"].sum()) == len(seeds)
    loss, _ = E.loss_fn(model, b)
    assert bool(torch.isfinite(loss))
    with pytest.raises(ValueError, match="does not fit"):
        subgraph_batch(sub, seeds, cfg, dataclasses.replace(
            cell, dims={**cell.dims, "n_nodes": m}), np.random.default_rng(0),
            "cpu")


def test_gnn_molecule_smoke():
    """The port of ``tests/test_arch_smoke.py::test_gnn_molecule_smoke``
    (the loss's value: its train step waits for training)."""
    spec = configs.get("egnn")
    cell = spec.shapes["molecule"]
    cfg = dataclasses.replace(spec.config_for_cell(spec.make_smoke_config(), cell), d_feat=8)
    model = E.init(cfg, torch.Generator().manual_seed(0))
    batch = smoke_batch(spec, cfg, cell, np.random.default_rng(11), "cpu")
    loss, m = E.loss_fn(model, batch)
    assert np.isfinite(float(loss))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_egnn_smoke_on_the_card_equals_the_cpu(cell, cuda_device):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, cfg, _, cpu = _pair(cell)
    gpu = E.EGNN(cfg, specs.tree_map(lambda t: t.to(cuda_device), cpu.tree()))
    tb, _ = _batch(cfg, cell)
    loss, _ = E.loss_fn(gpu, {k: v.to(cuda_device) for k, v in tb.items()})
    assert loss.device.type == "cuda"
    assert_rel(loss, E.loss_fn(cpu, tb)[0])
