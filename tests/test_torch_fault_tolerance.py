"""Fault tolerance of the port (``repro_torch.runtime.train_loop``,
``repro_torch.checkpoint``): the four cases of
``tests/test_fault_tolerance.py`` (crash/resume bit-exactness, a
corrupted checkpoint detected and skipped, the straggler watchdog,
garbage collection), and checkpoints carried across both ways between the
reference and the port, a bf16 leaf included.

Every comparison is bitwise.  The reference writes a bf16 leaf as 2-byte
void (``|V2``: numpy has no bfloat16) and cannot cast it back on restore
("No cast function available"); the port writes the same bytes under the
same dtype and reads them back through a ``uint16`` view."""

import dataclasses
import functools
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.checkpoint import Checkpointer as RefCheckpointer
from repro.models import transformer as RT
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.runtime.trainer import make_train_step as ref_make_train_step
from repro_torch import configs
from repro_torch.checkpoint import Checkpointer, latest_step
from repro_torch.models import specs, transformer
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import train_loop as TL
from repro_torch.runtime.trainer import make_train_step

from _torch_parity import one_thread  # noqa: F401  (fixture)

pytestmark = pytest.mark.usefixtures("one_thread")


class _Linear(specs._Tree):
    """The reference test's model: ``x @ w + b``."""

    def __init__(self, params):
        super().__init__(params)


def _setup():
    def loss_fn(model, batch):
        pred = batch["x"] @ model.w + model.b
        return torch.mean((pred - batch["y"]) ** 2), {}

    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 4)).astype(np.float32)
    Y = (X @ np.asarray([1., -2., 3., .5], np.float32)).astype(np.float32)

    def batch_iter(cursor):
        i = cursor % 4
        return {"x": X[i * 16:(i + 1) * 16], "y": Y[i * 16:(i + 1) * 16]}, cursor + 1

    ocfg = AdamWConfig(lr=0.05, warmup_steps=0, total_steps=40, weight_decay=0.0)
    step = make_train_step(loss_fn, ocfg)

    def model():
        return _Linear({"w": torch.zeros(4), "b": torch.zeros(())})
    return step, model, batch_iter


def _quiet(*a):
    pass


def test_crash_resume_bit_exact(tmp_path):
    step, model, batch_iter = _setup()
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    cfg = TL.LoopConfig(total_steps=40, ckpt_dir=d1, ckpt_every=10, log_every=1000)
    mA = model()
    mA, _, infoA = TL.run(step, mA, adamw_init(mA.tree()), batch_iter, cfg, log_fn=_quiet)
    cfg2 = TL.LoopConfig(total_steps=40, ckpt_dir=d2, ckpt_every=10,
                         log_every=1000, crash_at_step=23)
    m0 = model()
    with pytest.raises(RuntimeError, match="injected crash at step 23"):
        TL.run(step, m0, adamw_init(m0.tree()), batch_iter, cfg2, log_fn=_quiet)
    cfg3 = TL.LoopConfig(total_steps=40, ckpt_dir=d2, ckpt_every=10, log_every=1000)
    mB, log = model(), []
    mB, optB, infoB = TL.run(step, mB, adamw_init(mB.tree()), batch_iter, cfg3,
                             log_fn=log.append)
    assert log[0] == "[resume] restored step 20 cursor 20"
    assert len(infoB["metrics"]) == 20
    assert infoB["metrics"] == infoA["metrics"][20:]
    for a, b in zip(specs.tree_leaves(mA.tree()), specs.tree_leaves(mB.tree())):
        assert torch.equal(a, b)
    assert int(optB["step"]) == 40
    assert infoA["metrics"][-1]["loss"] < infoA["metrics"][0]["loss"]


def test_corrupted_checkpoint_detected_and_skipped(tmp_path):
    _, model, _ = _setup()
    d = str(tmp_path)
    ck = Checkpointer(d)
    m = model()
    state = (m.tree(), adamw_init(m.tree()))
    ck.save(10, state, {"cursor": 10})
    ck.save(20, state, {"cursor": 20})
    # corrupt the newest checkpoint's array blob
    path = os.path.join(d, "step_000020", "arrays.npz")
    with open(path, "r+b") as f:
        f.seek(200)
        f.write(b"\xde\xad\xbe\xef" * 8)
    restored, step_got, extra = ck.restore(state)
    assert step_got == 10 and extra["cursor"] == 10
    for a, b in zip(specs.tree_leaves(restored[0]), specs.tree_leaves(state[0])):
        assert torch.equal(a, b)


def test_straggler_watchdog_flags_slow_steps():
    dog = TL.StragglerWatchdog(factor=3.0)
    for i in range(10):
        dog.observe(i, 0.01)
    assert dog.observe(10, 0.2)          # 20x the EMA -> flagged
    assert len(dog.flagged) == 1
    assert not dog.observe(11, 0.012)


def test_checkpoint_gc_keeps_last_k(tmp_path):
    d = str(tmp_path)
    ck = Checkpointer(d, keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"w": torch.zeros(3)}, {})
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(d) if n.startswith("step_"))
    assert steps == [3, 4]
    assert latest_step(d) == 4


# --------------------------------------------------------------------------- #
# checkpoints across the two packages
# --------------------------------------------------------------------------- #


def _lm(arch: str, bf16: bool = False):
    """(reference params after one train step, its opt state, the port's
    model of the same config, its template state)."""
    params, opt = _ref_state(arch, bf16)
    cfg = configs.get(arch).make_smoke_config()
    if bf16:
        cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    model = transformer.init(cfg, torch.Generator().manual_seed(1))
    return params, opt, model, (model.tree(), adamw_init(model.tree()))


@functools.lru_cache(maxsize=None)
def _ref_state(arch: str, bf16: bool):
    """The reference's (params, opt) after one train step of the arch's
    smoke config (bf16 parameters when asked)."""
    ref_spec = ref_configs.get(arch)
    ref_cfg = ref_spec.make_smoke_config()
    if bf16:
        ref_cfg = dataclasses.replace(ref_cfg, param_dtype=jnp.bfloat16)
    params = RT.init(ref_cfg, jax.random.PRNGKey(0))
    t = np.random.default_rng(0).integers(0, ref_cfg.vocab, (2, 17))
    batch = {"tokens": jnp.asarray(t[:, :-1], jnp.int32),
             "labels": jnp.asarray(t[:, 1:], jnp.int32)}
    step = jax.jit(ref_make_train_step(
        lambda p, b: RT.loss_fn(p, b["tokens"], b["labels"], ref_cfg),
        RefAdamWConfig(warmup_steps=0)))
    params, opt, _ = step(params, ref_adamw_init(params), batch)
    return params, opt


def _words(a) -> np.ndarray:
    """A leaf's bytes as unsigned words of its width, flat."""
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a).reshape(-1)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


def _assert_state_equal(port_state, ref_state):
    ref_flat = jax.tree_util.tree_flatten_with_path(ref_state)[0]
    port_flat = specs.tree_leaves(port_state[0]) + _opt_leaves(port_state[1])
    assert len(ref_flat) == len(port_flat)
    for (path, r), t in zip(ref_flat, port_flat):
        assert tuple(t.shape) == tuple(r.shape), jax.tree_util.keystr(path)
        assert np.array_equal(_words(t), _words(r)), jax.tree_util.keystr(path)


def _opt_leaves(opt) -> list:
    return [x for k in sorted(opt) for x in
            (specs.tree_leaves(opt[k]) if isinstance(opt[k], dict) else [opt[k]])]


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16_params"])
def test_reference_checkpoint_restores_into_the_port(tmp_path, bf16):
    params, opt, model, template = _lm("mixtral-8x22b", bf16)
    assert ("master" in opt) == bf16
    RefCheckpointer(str(tmp_path)).save(1, (params, opt), {"cursor": 7})
    (tree, topt), step, extra = Checkpointer(str(tmp_path)).restore(template)
    assert step == 1 and extra == {"cursor": 7}
    assert topt["step"].dtype == torch.int32 and int(topt["step"]) == 1
    assert tree["embed"].dtype == (torch.bfloat16 if bf16 else torch.float32)
    _assert_state_equal((tree, topt), (params, opt))


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    params, opt, model, _ = _lm("smollm-135m")
    transformer.load_reference_params(model, jax.tree.map(np.asarray, params))
    topt = adamw_init(model.tree())
    for name in ("m", "v"):
        specs.load_tree(topt[name], jax.tree.map(np.asarray, opt[name]))
    topt["step"].fill_(int(opt["step"]))
    Checkpointer(str(tmp_path)).save(3, (model.tree(), topt), {"cursor": 5})
    tmpl = jax.tree.map(jnp.zeros_like, (params, opt))
    (rp, ro), step, extra = RefCheckpointer(str(tmp_path)).restore(tmpl)
    assert step == 3 and extra == {"cursor": 5}
    _assert_state_equal((model.tree(), topt), (rp, ro))
    _assert_state_equal((model.tree(), topt), (params, opt))


def test_bf16_leaf_goes_to_disk_as_the_reference_writes_it(tmp_path):
    """The same bf16 state saved by both: the same npz arrays (dtype and
    bytes) and the same manifest; the port restores both; the reference's
    own restore cannot cast its |V2 leaf back, from either file."""
    params, opt, model, template = _lm("mixtral-8x22b", bf16=True)
    ref_dir, port_dir = str(tmp_path / "ref"), str(tmp_path / "port")
    RefCheckpointer(ref_dir).save(1, (params, opt))
    (tree, topt), _, _ = Checkpointer(ref_dir).restore(template)
    Checkpointer(port_dir).save(1, (tree, topt))
    files = [os.path.join(d, "step_000001") for d in (ref_dir, port_dir)]
    (ma, mb) = [json.load(open(os.path.join(f, "manifest.json"))) for f in files]
    assert ma == mb
    assert ma["dtypes"]["0/embed"] == "bfloat16" and ma["dtypes"]["1/master/embed"] == "float32"
    za, zb = [np.load(os.path.join(f, "arrays.npz")) for f in files]
    for k in ma["keys"]:
        assert za[k].dtype == zb[k].dtype and za[k].tobytes() == zb[k].tobytes(), k
        assert hashlib.sha256(zb[k].tobytes()).hexdigest() == ma["sha256"][k]
    assert za["0/embed"].dtype == np.dtype("V2")
    for d in (ref_dir, port_dir):
        assert Checkpointer(d).restore(template)[1] == 1
        with pytest.raises(ValueError, match="No cast function"):
            RefCheckpointer(d).restore((params, opt))
