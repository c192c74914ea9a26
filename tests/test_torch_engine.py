"""The slice as a whole: the port's ``plan``/``execute`` in mode ``and`` on
the host, device and fused placements against the JAX package's engine, on
``synth.make_corpus("gov2")`` with queries shaped like
``benchmarks/bench_query.make_queries`` (2-3 terms of the 120 most
frequent); the device-resident counters; one tombstone's epoch; the legacy
``and_many`` through kernel B5; and the package importing with jax
blocked."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.data import synth as ref_synth
from repro.index.engine import QueryBatch as RefBatch
from repro.index.engine import QueryEngine as RefEngine
from repro.index.invindex import InvertedIndex as RefIndex
from repro_torch.data import synth
from repro_torch.index.engine import QueryBatch, QueryEngine
from repro_torch.index.invindex import InvertedIndex

N_QUERIES = 48


def _queries(postings: dict, n: int, seed: int = 3) -> list:
    rng = np.random.default_rng(seed)
    terms = sorted(postings)
    return [rng.choice(terms[:120], size=rng.integers(2, 4),
                       replace=False).tolist() for _ in range(n)]


@pytest.fixture(scope="module")
def gov2():
    doclen, postings = synth.make_corpus("gov2")
    ref_doclen, ref_postings = ref_synth.make_corpus("gov2")
    np.testing.assert_array_equal(doclen, ref_doclen)
    for t, (ids, tfs) in ref_postings.items():
        np.testing.assert_array_equal(postings[t][0], ids)
        np.testing.assert_array_equal(postings[t][1], tfs)
    queries = _queries(postings, N_QUERIES) + [[0, 10_000], [5]]
    ref = RefIndex.build(doclen, postings, codec="group_simple")
    want = RefEngine(ref).execute(RefBatch(queries, mode="and"))
    return InvertedIndex.build(doclen, postings), queries, want


@pytest.mark.parametrize("placement", ["host", "device", "fused"])
def test_and_plan_execute_matches_reference(gov2, placement):
    idx, queries, want = gov2
    eng = QueryEngine(idx, cache_blocks=1 << 20)
    if placement != "host":
        eng.to_device(fused=placement == "fused", torch_device="cpu")
    plan = eng.plan(QueryBatch(queries, mode="and"), placement=placement)
    assert plan.placement == placement
    got = eng.execute(plan)
    assert len(got) == len(want)
    for q, a, b in zip(queries, got, want):
        assert a.dtype == np.uint32
        np.testing.assert_array_equal(a, b, err_msg=str(q))
    if placement == "host":
        return
    st = eng.dev_stats
    assert st["cand_syncs"] == 0 and st["final_syncs"] == 1
    assert st["resident_rounds"] >= 1 and st["blocks_dense"] > 0
    # at most one decode per hot block: every decode is a distinct key
    hot = {k for k in eng.cache.keys() if k[1] >= 0}
    assert st["worklist_decodes"] + st["fallback_decodes"] == len(hot)
    if placement == "fused":
        assert eng.arena.stats["fused_calls"] > 0


def test_auto_placement_and_unported_paths_raise(gov2):
    idx, queries, _ = gov2
    eng = QueryEngine(idx).to_device(fused=True, torch_device="cpu")
    assert eng.plan(QueryBatch(queries[:1])).placement == "host"
    assert eng.plan(QueryBatch(queries)).placement == "fused"
    for mode in ("or", "and_scored"):           # the ranked modes plan too
        assert eng.plan(QueryBatch(queries, mode=mode)).placement == "fused"
    with pytest.raises(ValueError, match="did you mean 'and'"):
        eng.plan(QueryBatch(queries, mode="adn"))
    # a 2-shard engine plans the batch over its shards
    sh = QueryEngine(idx).to_device(shards=2, torch_device="cpu")
    assert "sharded x2" in sh.plan(QueryBatch(queries)).note


def test_mutated_index_and_missing_card_raise():
    """A one-tombstone index plans and serves ``and`` as the reference
    does (the plan pins the epoch), and ``to_device()`` with no card
    raises."""
    doclen, postings = synth.make_corpus("wikipedia")
    sub = dict(list(postings.items())[:5])
    idx = InvertedIndex.build(doclen, sub)
    ref = RefIndex.build(doclen, sub, codec="group_simple")
    dead = int(sub[0][0][0])            # a doc that holds term 0
    idx.delete(dead)
    ref.delete(dead)
    queries = [[0, 1], [0], [2, 3, 4], [1, 9_999]]
    want = RefEngine(ref).execute(RefBatch(queries, mode="and"))
    assert dead not in want[1]
    for placement in ("host", "device", "fused"):
        eng = QueryEngine(idx)
        if placement != "host":
            eng.to_device(fused=placement == "fused", torch_device="cpu")
        plan = eng.plan(QueryBatch(queries, mode="and"), placement=placement)
        assert plan.ctx.mutated and "1 tombstone(s)" in plan.note
        for q, a, b in zip(queries, eng.execute(plan), want):
            np.testing.assert_array_equal(a, b, err_msg=f"{placement} {q}")
        if placement != "host":
            assert eng.dev_stats["tomb_gates"] == 1
            assert eng.dev_stats["cand_syncs"] == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            QueryEngine(idx).to_device()


def test_legacy_and_many_through_b5_matches_host(gov2):
    idx, queries, want = gov2
    eng = QueryEngine(idx).to_device(fused=True, torch_device="cpu")
    calls = eng.arena.stats["fused_calls"]
    got = eng.and_many(queries)
    assert eng.arena.stats["fused_calls"] > calls
    assert eng.dev_stats["cand_syncs"] > 0          # the legacy loop syncs
    for q, a, b in zip(queries, got, want):
        np.testing.assert_array_equal(a, b, err_msg=str(q))
    # and the one-query host entry point
    np.testing.assert_array_equal(eng.and_query(queries[0]), want[0])


def test_port_imports_without_jax():
    """The port never imports jax (nor ml_dtypes, nor the JAX package
    ``repro``): every module loads with all three blocked, and none starts
    a ``torch.distributed`` process group."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.index.engine, repro_torch.index.device\n"
        "import repro_torch.kernels.intersect_rounds\n"
        "import repro_torch.kernels.topk, repro_torch.index.scores\n"
        "import repro_torch.data.synth, repro_torch.obs\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.ref\n"
        "import repro_torch.kernels.intersect, repro_torch.core.bp_tpu\n"
        "import repro_torch.core.bits, repro_torch.core.frames\n"
        "import repro_torch.core.bp128, repro_torch.core.group_afor\n"
        "import repro_torch.core.group_vse, repro_torch.core.group_pfd\n"
        "import repro_torch.core.group_scheme, repro_torch.core.scalar\n"
        "import repro_torch.index.shards, repro_torch.index.serve\n"
        "import repro_torch.distributed.sharding\n"
        "import repro_torch.distributed.collectives\n"
        "import repro_torch.launch.mesh, repro_torch.launch.serve\n"
        "import repro_torch.index.query, repro_torch.data.pipeline\n"
        "import repro_torch.models.common, repro_torch.models.specs\n"
        "import repro_torch.models.attention, repro_torch.models.moe\n"
        "import repro_torch.models.transformer\n"
        "import repro_torch.configs, repro_torch.configs.base\n"
        "import repro_torch.configs.smollm_135m\n"
        "import repro_torch.configs.starcoder2_3b\n"
        "import repro_torch.configs.starcoder2_7b\n"
        "import repro_torch.configs.deepseek_v2_lite_16b\n"
        "import repro_torch.configs.mixtral_8x22b\n"
        "import repro_torch.configs.din, repro_torch.configs.dien\n"
        "import repro_torch.configs.dlrm_rm2, repro_torch.configs.wide_deep\n"
        "import repro_torch.configs.egnn\n"
        "import repro_torch.models.embedding, repro_torch.models.recsys\n"
        "import repro_torch.models.egnn, repro_torch.models.sampler\n"
        "import repro_torch.launch.batches, repro_torch.launch.serve\n"
        "import repro_torch.core.dgap, repro_torch.core.layout\n"
        "import repro_torch.core.group_simple\n"
        "import repro_torch.optim, repro_torch.optim.adamw\n"
        "import repro_torch.runtime, repro_torch.runtime.trainer\n"
        "import repro_torch.runtime.train_loop\n"
        "import repro_torch.checkpoint, repro_torch.checkpoint.checkpointer\n"
        "import repro_torch.launch.train\n"
        "import repro_torch.distributed.collectives\n"
        "import repro_torch.distributed.pipeline\n"
        "import repro_torch.launch.dryrun, repro_torch.launch.census\n"
        "import repro_torch.launch.roofline_report\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "from repro_torch import configs\n"
        "assert len(configs.ARCHS) == 10 and not configs.PENDING\n"
        "from repro_torch.core import codec\n"
        "assert len(codec.names()) == 31\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and "
        "(m == 'repro' "
        "or m.startswith(('repro.', 'jax.', 'ml_dtypes')))]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
