"""A cell of ``BENCHMARK.json`` cut to a size a CPU test run holds: 20,000
documents, 40 lists, a short window."""

from __future__ import annotations

import time

TINY_DOCS = 20_000
TINY_LISTS = 40


def tiny_cell(name: str, n_docs: int = TINY_DOCS):
    from portbench import harness
    cell = harness.resolve(name)
    cell.config = dict(cell.config, n_docs=n_docs, n_terms_sampled=TINY_LISTS,
                       n_lists=TINY_LISTS)
    # a short window serves a few passes: half of the later lists are checked
    cell.traffic = dict(cell.traffic,
                        check_share=max(cell.traffic.get("check_share", 1.0),
                                        0.5))
    return cell


def tiny_run(name: str, seed: int = 5, seconds: float = 0.5, device="cpu",
             trace: bool = False) -> dict:
    import torch
    from portbench import harness
    return harness.run(tiny_cell(name), seed, seconds, trace,
                       torch.device(device), time.perf_counter(),
                       log=lambda msg: None)
