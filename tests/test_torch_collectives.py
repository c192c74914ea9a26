"""The compressed gradient all-reduce of the port
(``repro_torch.distributed.collectives``) against the JAX package's
``distributed/collectives.py``, which runs under ``shard_map`` on 8 forced
host devices in a subprocess (as ``tests/test_distribution.py`` runs it).

Bitwise: ``pack4`` / ``unpack4``, ``_quantize``'s int8 words and fp32
scales (against ``jnp`` run op by op), and every rank's phase-1 words.
Under ``jit`` XLA divides by ``qmax`` = 7 as a product with its
reciprocal, so the reference's int4 scales differ from ``jnp``'s (and the
port's) by an ulp in about half the blocks, and every value of those
blocks with them; int8's 127 happens to give the same bits.  Phase 2
requantizes a mean over the ranks, summed in another order than XLA's:
the output and each rank's residual are held within one phase-2
quantization step of the reference's (the residual within R steps: the
owner adds R x its chunk's error), the count of output values that differ
and of those that differ by more than 4 ulps (a phase-2 word) are
printed, the second at most 1 %, and the error of the mean is the
reference's (int8: within its test's bound, 0.05 of max |exact mean|).  Also: the compressed
pytree mean with error feedback, and what the reference's error-feedback
residual ``ef`` holds per device under its replicated ``out_specs``."""

import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import collectives as RC
from repro_torch.distributed import collectives as C

from _torch_parity import one_thread  # noqa: F401  (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R, N = 8, 5000

pytestmark = pytest.mark.usefixtures("one_thread")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (R, N)).astype(np.float32)
    x[:, :1024] *= 1e-3                 # a block of small values
    x[:, 1024:2048] = 0                 # a zero block (scale floor)
    tree = {"a": rng.normal(0, 1, (R, 300, 7)).astype(np.float32),
            "b": rng.normal(0, 3, (R, 50)).astype(np.float32)}
    ef = {"a": rng.normal(0, 1e-2, (R, 300, 7)).astype(np.float32),
          "b": rng.normal(0, 1e-2, (R, 50)).astype(np.float32)}
    return x, tree, ef


REF = """
import os, sys, json
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as PS
from jax.experimental.shard_map import shard_map
from repro.distributed import collectives as C
from repro.launch.mesh import make_host_mesh
sys.path.insert(0, {tests!r})
from test_torch_collectives import _inputs, R, N
out = {{}}
mesh = make_host_mesh((R,), ('dp',))
x, tree, ef = _inputs()
for bits in (8, 4):
    f = lambda xl: C.compressed_allreduce_flat(xl.reshape(-1), ('dp',), bits=bits)
    red, res = jax.jit(shard_map(f, mesh=mesh, in_specs=PS('dp'),
                                 out_specs=(PS('dp'), PS('dp')), check_rep=False))(
        jnp.asarray(x.reshape(-1)))
    out[f'red{{bits}}'] = np.asarray(red).reshape(R, N)
    out[f'res{{bits}}'] = np.asarray(res).reshape(R, N)
    def g(t, e):
        t = jax.tree.map(lambda a: a[0], t); e = jax.tree.map(lambda a: a[0], e)
        r_, e_ = C.compressed_psum_mean(t, ('dp',), bits=bits, error_feedback=e)
        return jax.tree.map(lambda a: a[None], r_), jax.tree.map(lambda a: a[None], e_)
    spec = {{'a': PS('dp'), 'b': PS('dp')}}
    rt, et = jax.jit(shard_map(g, mesh=mesh, in_specs=(spec, spec),
                               out_specs=(spec, spec), check_rep=False))(tree, ef)
    for k in ('a', 'b'):
        out[f'tree{{bits}}_{{k}}'] = np.asarray(rt[k])
        out[f'ef{{bits}}_{{k}}'] = np.asarray(et[k])
# the ef finding: one compressed DP step of a linear model on 8 devices
from repro.optim import AdamWConfig
from repro.runtime.trainer import make_compressed_dp_train_step
from repro.checkpoint import Checkpointer
rng = np.random.default_rng(1)
X = rng.normal(size=(64, 4)).astype(np.float32)
Y = (X @ np.asarray([1., -2., 3., .5], np.float32))
loss = lambda p, b: (jnp.mean((b['x'] @ p['w'] - b['y']) ** 2), {{}})
step, init_opt = make_compressed_dp_train_step(loss, AdamWConfig(warmup_steps=0), mesh,
    {{'x': PS('dp'), 'y': PS('dp')}}, dp_axes=('dp',), bits=8)
p0 = {{'w': jnp.zeros(4)}}
p1, o1, _ = jax.jit(step)(p0, init_opt(p0), {{'x': jnp.asarray(X), 'y': jnp.asarray(Y)}})
shards = sorted(o1['ef']['w'].addressable_shards, key=lambda s: s.device.id)
out['ef_shards'] = np.stack([np.asarray(s.data) for s in shards])
out['ef_asarray'] = np.asarray(o1['ef']['w'])
d = {ckpt!r}
Checkpointer(d).save(1, (p1, o1))
out['ef_saved'] = np.load(os.path.join(d, 'step_000001', 'arrays.npz'))['1/ef/w']
out['ef_sharding'] = str(o1['ef']['w'].sharding.spec)
# a bf16 parameter: adamw_init's master copy, and the state after a step
pb = {{'w': jnp.zeros(4, jnp.bfloat16)}}
ob = init_opt(pb)
_, ob1, _ = jax.jit(step)(pb, ob, {{'x': jnp.asarray(X), 'y': jnp.asarray(Y)}})
keys = {{'init_keys_bf16': sorted(ob), 'step_keys_bf16': sorted(ob1)}}
np.savez({dump!r}, **{{k: v for k, v in out.items() if k != 'ef_sharding'}})
print(json.dumps({{'ef_sharding': out['ef_sharding'], **keys}}))
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("collectives")
    dump = str(d / "ref.npz")
    code = REF.format(tests=os.path.join(ROOT, "tests"), ckpt=str(d / "ckpt"), dump=dump)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], env=env,
                       capture_output=True, text=True, timeout=420)
    assert r.returncode == 0, r.stderr[-4000:]
    out = dict(np.load(dump))
    out.update(json.loads(r.stdout.strip().splitlines()[-1]))
    return out


def _u32(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.uint32) if a.dtype.itemsize == 4 else a


def test_pack4_unpack4_bitwise():
    v = np.random.default_rng(3).integers(-8, 8, 8 * 129).astype(np.int8)
    want = RC.pack4(jnp.asarray(v))
    got = C.pack4(torch.from_numpy(v))
    assert got.dtype == torch.int32
    assert np.array_equal(_u32(got), np.asarray(want))
    for n in (len(v), len(v) - 5):
        back = C.unpack4(got, n)
        assert np.array_equal(back.numpy(), np.asarray(RC.unpack4(want, n)))
        assert np.array_equal(back.numpy(), v[:n])


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_words_and_scales_bitwise(bits):
    x, _, _ = _inputs(5)
    xp = x.reshape(-1)[: 6 * C.BLOCK]
    q, s = C._quantize(torch.from_numpy(xp), bits)
    rq, rs = RC._quantize(jnp.asarray(xp), bits)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert np.array_equal(_u32(s), _u32(rs))
    assert np.array_equal(_u32(C._dequantize(q, s)), _u32(RC._dequantize(rq, rs)))
    # half-way values round to even, as jnp.round does
    h = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5] + [127.0] + [0.0] * (C.BLOCK - 6))
    assert C._quantize(h, 8)[0][:5].tolist() == [0, 2, 2, 0, -2]


@pytest.mark.parametrize("bits", [8, 4])
def test_compressed_allreduce_flat_matches_reference(ref, bits):
    x, _, _ = _inputs()
    xs = [torch.from_numpy(x[r]) for r in range(R)]
    outs, res = C.compressed_allreduce_flat(xs, bits=bits)
    # phase 1 bitwise: every rank's words and scales are the reference's
    for r in range(R):
        xp = C._pad_to(xs[r], R * C.BLOCK)
        q, s = C._quantize(xp, bits)
        rq, rs = RC._quantize(RC._pad_to(jnp.asarray(x[r]), R * C.BLOCK), bits)
        assert np.array_equal(q.numpy(), np.asarray(rq)) and np.array_equal(_u32(s), _u32(rs))
        if bits == 4:
            assert np.array_equal(_u32(C.pack4(q)), np.asarray(RC.pack4(rq)))
    want, want_res = ref[f"red{bits}"], ref[f"res{bits}"]
    qmax = (1 << (bits - 1)) - 1
    npad = -(-N // (R * C.BLOCK)) * R * C.BLOCK
    pad = np.zeros(npad - N, np.float32)
    step = np.repeat(np.abs(np.concatenate([want[0], pad])).reshape(-1, C.BLOCK).max(1)
                     / qmax, C.BLOCK)[:N] * (1 + 1e-6)
    for r in range(R):
        got = outs[r].numpy()
        assert np.array_equal(got, outs[0].numpy())        # every rank the same
        assert np.all(np.abs(got - want[r]) <= step)
        assert np.all(np.abs(res[r].numpy() - want_res[r]) <= R * step + 1e-7)
    got = outs[0].numpy()
    differ = int((got != want[0]).sum())
    # beyond 4 ulps: a phase-2 word itself differs (not only its scale)
    words = int((np.abs(got - want[0]) > 4 * np.spacing(np.abs(want[0]))).sum())
    print(f"bits {bits}: {differ} of {N} output values differ from the "
          f"reference's, {words} by a phase-2 word")
    assert words <= N // 100
    exact = x.mean(axis=0)
    err = np.abs(got - exact).max()
    ref_err = np.abs(want[0] - exact).max()
    assert err <= ref_err * (1 + 1e-5)
    if bits == 8:                       # the reference test's bound (int8)
        assert err < 0.05 * (np.abs(exact).max() + 1e-6), err


@pytest.mark.parametrize("bits", [8, 4])
def test_compressed_psum_mean_with_error_feedback(ref, bits):
    _, tree, ef = _inputs()
    trees = [{k: torch.from_numpy(v[r]) for k, v in tree.items()} for r in range(R)]
    efs = [{k: torch.from_numpy(v[r]) for k, v in ef.items()} for r in range(R)]
    reds, new_ef = C.compressed_psum_mean(trees, bits=bits, error_feedback=efs)
    for k in ("a", "b"):
        want, want_ef = ref[f"tree{bits}_{k}"], ref[f"ef{bits}_{k}"]
        scale = np.abs(want).max() / ((1 << (bits - 1)) - 1)
        for r in range(R):
            assert reds[r][k].shape == trees[r][k].shape
            assert np.abs(reds[r][k].numpy() - want[r]).max() <= scale * 1.001
            assert np.abs(new_ef[r][k].numpy() - want_ef[r]).max() <= R * scale * 1.001
        exact = (tree[k] + ef[k]).mean(axis=0)
        assert np.abs(reds[0][k].numpy() - exact).max() < 0.05 * np.abs(exact).max() * (
            16 if bits == 4 else 1)


def test_reference_ef_is_per_device_under_a_replicated_spec(ref):
    """The reference's ``ef`` out_spec is replicated (``PS()``), but each
    device keeps its own residual; reading the array (and so a checkpoint)
    gives device 0's alone.  The port keeps one residual per rank."""
    shards = ref["ef_shards"]
    assert ref["ef_sharding"] == "PartitionSpec()"
    assert shards.shape == (R, 4)
    assert len({s.tobytes() for s in shards}) > 1          # devices differ
    assert np.array_equal(ref["ef_asarray"], shards[0])
    assert np.array_equal(ref["ef_saved"], shards[0])


def test_compressed_dp_step_keeps_the_reference_opt_keys(ref):
    """The reference's compressed step returns m, v, step and ef alone:
    adamw_init's fp32 master copy of a bf16 parameter does not outlive
    the first step.  The port's state after a step has the same keys, so
    no stale master reaches a checkpoint."""
    from repro_torch.models.specs import _Tree
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime.trainer import make_compressed_dp_train_step

    rng = np.random.default_rng(1)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    y = x @ np.asarray([1., -2., 3., .5], np.float32)
    model = _Tree({"w": torch.zeros(4, dtype=torch.bfloat16)})
    loss = lambda m, b: (torch.mean((b["x"] @ m.w.float() - b["y"]) ** 2), {})
    step, init_opt = make_compressed_dp_train_step(
        loss, AdamWConfig(warmup_steps=0), ranks=R, bits=8)
    opt = init_opt(model)
    assert sorted(opt) == ref["init_keys_bf16"] == ["ef", "m", "master", "step", "v"]
    model, opt, _ = step(model, opt, {"x": x, "y": y})
    assert sorted(opt) == ref["step_keys_bf16"] == ["ef", "m", "step", "v"]
    assert model.w.dtype == torch.bfloat16 and bool(model.w.abs().sum() > 0)


def test_a_mesh_lists_one_device_a_rank():
    x, _, _ = _inputs(2)
    xs = [torch.from_numpy(x[r]) for r in range(R)]
    with pytest.raises(ValueError, match="mesh of 7 devices for 8 ranks"):
        C.compressed_allreduce_flat(xs, bits=8, mesh=[torch.device("cpu")] * (R - 1))


def test_wire_bytes():
    n = 134_515_008
    assert C.wire_bytes(n, 8, None) == 2 * 7 * 4 * n // 8
    ring = C.wire_bytes(n, 8, None)
    for bits, ratio in ((8, 4), (4, 8)):
        w = C.wire_bytes(n, 8, bits)
        npad = -(-n // (8 * C.BLOCK)) * 8 * C.BLOCK
        assert w == 2 * 7 * (npad * bits // 8 + npad // C.BLOCK * 4) // 8
        assert 0.9 * ratio < ring / w <= ratio


@pytest.mark.parametrize("bits", [8, 4])
def test_one_rank_a_device_equals_logical_ranks(bits):
    """``mesh`` (a device a rank, ``launch.mesh.serving_mesh``'s list)
    moves each payload to its receiving rank's device: the same words and
    values as the ranks on one device."""
    x, _, _ = _inputs(2)
    xs = [torch.from_numpy(x[r]) for r in range(R)]
    outs, res = C.compressed_allreduce_flat(xs, bits=bits)
    mouts, mres = C.compressed_allreduce_flat(xs, bits=bits,
                                              mesh=[torch.device("cpu")] * R)
    for a, b in zip(outs + res, mouts + mres):
        assert torch.equal(a, b)
