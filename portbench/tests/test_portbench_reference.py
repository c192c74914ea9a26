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
