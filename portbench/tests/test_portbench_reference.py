"""The reference and its control on small hand cases, the frozen corpus
generator against the port's own, and the traffic generator's streams."""

import numpy as np
import pytest
import torch

from portbench import corpus, generator
from portbench.reference import oracles

POSTINGS = {
    0: (np.array([1, 3, 5, 7, 40, 70], np.uint32), np.array([1, 2, 1, 3, 1, 1], np.uint32)),
    1: (np.array([3, 5, 6, 41, 70], np.uint32), np.array([2, 1, 1, 1, 5], np.uint32)),
    2: (np.array([5, 70, 99], np.uint32), np.array([1, 1, 2], np.uint32)),
}
def test_gaps_and_their_control():
    gaps = oracles.gap_lists(POSTINGS, [0])[0]
    assert gaps.tolist() == [1, 2, 2, 2, 33, 30]
    g = torch.tensor([1] * 200 + [1000] * 10 + [3] * 46, dtype=torch.int64)
    cut = oracles.unpatched_gaps(g)
    assert torch.equal(cut[:200], g[:200])
    assert (cut != g).sum() == 10           # the exceptions lose high bits
    assert torch.equal(oracles.unpatched_gaps(torch.arange(1, 129)),
                       torch.arange(1, 129) & 127)


@pytest.mark.parametrize("seed", [0, 12345678901])
def test_frozen_corpus_equals_the_ports(seed):
    from repro_torch.data import synth
    cfg = {"corpus": "gov2", "n_docs": 30_000, "n_terms_sampled": 2000,
           "avg_doclen": 778, "zipf_s": 1.15, "n_lists": 200}
    dl, post = corpus.make_corpus(cfg, seed)
    dl2, post2 = synth.make_corpus("gov2", seed=seed, n_docs=30_000)
    assert np.array_equal(dl, dl2) and post.keys() == post2.keys()
    for t in post:
        assert np.array_equal(post[t][0], post2[t][0])
        assert np.array_equal(post[t][1], post2[t][1])


def test_streams_are_seeded():
    traffic = {"lists_per_request": "all"}
    a = generator.requests(2**31 + 7, generator.WINDOW, traffic, 50)
    b = generator.requests(2**31 + 7, generator.WINDOW, traffic, 50)
    first = [next(a) for _ in range(3)]
    assert first == [next(b) for _ in range(3)]
    # each request a pass over every list, in a fresh order
    assert all(sorted(r) == list(range(50)) for r in first)
    assert first[0] != first[1]
    c = generator.requests(2**31 + 7, generator.WARMUP, traffic, 50)
    assert next(c) != first[0]


def test_passes_cut_into_requests():
    d = generator.requests(3, generator.WINDOW, {"lists_per_request": 4}, 10)
    reqs = [next(d) for _ in range(6)]
    assert [len(r) for r in reqs] == [4, 4, 2, 4, 4, 2]
    assert sorted(sum(reqs[:3], [])) == list(range(10))
    assert sorted(sum(reqs[3:], [])) == list(range(10))


def test_narrowed_docids_lose_the_widest_gaps_top_bit():
    ids = torch.tensor([3, 4, 20, 21, 22], dtype=torch.int64)
    # gaps 3, 1, 16, 1, 1: the widest needs 5 bits, cut to 4: 16 -> 0
    assert oracles.narrowed_docids(ids).tolist() == [3, 4, 4, 5, 6]


# ---- the model cells' inputs and reference ------------------------------ #


def _lm_config():
    from tiny import SMOKE_LM
    from portbench import harness
    return dict(harness.resolve("dsv2lite-decode-conv").config, **SMOKE_LM)


def test_weights_are_seeded_and_shaped_as_the_ports():
    from repro_torch.models import transformer
    from portbench.reference import lm_weights
    from portbench.drivers import lm_decode
    cfg = _lm_config()
    a = lm_weights.draw(cfg, 2**31 + 3, "cpu")
    b = lm_weights.draw(cfg, 2**31 + 3, "cpu")
    c = lm_weights.draw(cfg, 2**31 + 4, "cpu")
    got = dict(transformer.LM(lm_decode.port_config(cfg), a)
               .named_parameters())
    want = transformer.abstract(lm_decode.port_config(cfg))
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in
        transformer.LM(lm_decode.port_config(cfg), want).named_parameters()}
    assert all(torch.equal(got[k], v) for k, v in
               transformer.LM(lm_decode.port_config(cfg), b)
               .named_parameters())
    assert not torch.equal(a["embed"], c["embed"])
    # the init law: norms 1, output projections narrower than the rest
    assert torch.all(a["final_norm"] == 1)
    layers = cfg["num_hidden_layers"]
    assert float(a["moe_layers"]["ffn"]["w1"].std()) == pytest.approx(
        0.02, rel=0.05)
    assert float(a["moe_layers"]["ffn"]["w2"].std()) == pytest.approx(
        0.02 / np.sqrt(2 * layers), rel=0.05)
    p = lm_weights.prompts(cfg, 2, 64, 9)
    assert p.shape == (2, 64) and p.max() < cfg["vocab_size"]
    assert np.array_equal(p, lm_weights.prompts(cfg, 2, 64, 9))


@pytest.mark.parametrize("seed", [1, 2**31 + 9])
def test_port_decode_agrees_with_the_reference(seed):
    """At the smoke sizes with the cell's init law, the port's prefill and
    then its decode through the cache agree with the reference's full
    forward, and with the port's own forward, within float32 round-off."""
    from tiny import tiny_cell
    from portbench import lm_depth
    got = lm_depth.compare(tiny_cell("dsv2lite-decode-conv"), seed, 32, 6,
                           torch.device("cpu"))
    assert max(got.values()) < 1e-5, got


def test_fp8_control_rounds_each_matrix():
    from portbench.reference import deepseek_v2_lite as ref
    w = torch.randn(64, 64) * 0.02
    q = ref.fp8(w)
    assert not torch.equal(q, w)
    # float8_e4m3fn keeps 3 mantissa bits: within 1/16 of each magnitude
    # above the scaled subnormals
    big = w.abs() > w.abs().amax() / 8
    assert torch.all((q - w).abs()[big] <= w.abs()[big] / 16 + 1e-12)
    assert float(q.abs().amax()) == pytest.approx(float(w.abs().amax()))


# ---- the published arithmetic, one configuration away --------------------- #

YARN = {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
        "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
        "type": "yarn"}


def test_yarn_keeps_fast_rotations_and_slows_the_rest():
    """The published model's YaRN at its rope width 64: dimensions 0-10
    (below the correction range, by hand: floor 10.47) rotate as plain
    RoPE, 23-31 (above it: ceil 22.51) at a fortieth; the scores' scale
    takes mscale squared.  At factor 1 YaRN is plain RoPE."""
    from portbench.reference import deepseek_v2_lite as ref
    cfg = dict(_lm_config(), rope_theta=10000, rope_scaling=None)
    plain, m = ref.rope_freqs(cfg, 64, "cpu")
    assert m == 1.0
    yarn, m = ref.rope_freqs(dict(cfg, rope_scaling=YARN), 64, "cpu")
    assert m == pytest.approx(1.0)
    assert torch.equal(yarn[:11], plain[:11])
    assert torch.allclose(yarn[23:], plain[23:] / 40, rtol=1e-6)
    assert torch.all(yarn[11:23] < plain[11:23])
    assert torch.all(yarn[11:23] > plain[11:23] / 40)
    one, m = ref.rope_freqs(dict(cfg, rope_scaling=dict(YARN, factor=1)),
                            64, "cpu")
    assert torch.equal(one, plain) and m == 1.0
    base = ref.softmax_scale(cfg)
    assert ref.softmax_scale(dict(cfg, rope_scaling=YARN)) == pytest.approx(
        base * (0.1 * 0.707 * np.log(40) + 1) ** 2)


def test_the_file_keeps_the_published_rope_group():
    """The configuration states the port's plain RoPE as the published
    YaRN group at factor 1, every other key of the group as published."""
    from portbench import harness
    from portbench.drivers import lm_decode
    cfg = harness.resolve("dsv2lite-decode-conv").config
    published = cfg["source_values"]["rope_scaling"]
    assert cfg["rope_scaling"] == dict(published, factor=1)
    assert lm_decode.rope_plain(cfg["rope_scaling"])
    assert not lm_decode.rope_plain(published)


def test_untied_head_and_unnormalised_gates():
    """With ``tie_word_embeddings`` false the reference reads ``lm_head``
    (the embedding's copy gives the tied logits, another head others);
    with ``norm_topk_prob`` false the routed experts' sum is the
    renormalised one times each token's top-k probability mass, then
    times ``routed_scaling_factor``."""
    from portbench.reference import deepseek_v2_lite as ref
    from portbench.reference import lm_weights
    cfg = _lm_config()
    untied = dict(cfg, tie_word_embeddings=False)
    w = lm_weights.draw(untied, 7, "cpu")
    assert w["lm_head"].shape == w["embed"].shape
    tokens = torch.as_tensor(lm_weights.prompts(cfg, 2, 12, 7))
    tied, _ = ref.run(w, cfg, tokens, 0)
    own, _ = ref.run(w, untied, tokens, 0)
    assert not torch.allclose(own, tied)
    same, _ = ref.run(dict(w, lm_head=w["embed"].clone()), untied, tokens, 0)
    assert torch.equal(same, tied)
    p = {k: v[0] if not isinstance(v, dict) else
         {kk: vv[0] for kk, vv in v.items()}
         for k, v in w["moe_layers"]["ffn"].items()}
    p["shared"] = {k: torch.zeros_like(v) for k, v in p["shared"].items()}
    h = torch.randn(5, cfg["hidden_size"])
    mass = torch.softmax(h @ p["router"], -1).topk(
        cfg["num_experts_per_tok"], -1).values.sum(-1, keepdim=True)
    normed = ref._experts(p, h, cfg, ref._same)
    raw = ref._experts(p, h, dict(cfg, norm_topk_prob=False,
                                  routed_scaling_factor=2.5), ref._same)
    assert torch.allclose(raw, normed * mass * 2.5, rtol=1e-5, atol=1e-7)


def test_the_port_refuses_the_published_arithmetic():
    """The configuration's published values (``source_values``) are not
    the port's: the driver refuses them rather than serve another model."""
    from portbench.drivers import lm_decode
    cfg = _lm_config()
    lm_decode.port_config(cfg)
    for k, v in cfg["source_values"].items():
        with pytest.raises(ValueError, match=k):
            lm_decode.port_config(dict(cfg, **{k: v}))
