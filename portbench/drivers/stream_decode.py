"""Driver ``stream_decode``: whole posting lists decoded on the device by
the port's stream codec (``kernels/ops.py``), the lists' d-gaps packed
from the benchmark's corpus at set-up.

Set-up uploads each list's d-gaps, takes its frames' bit widths
(``ops.select_bw``, B9) and packs the list at the widest of them
(``ops.pack_stream``, B7a); all packed lists stay on the device, and their
words over their postings are the cell's ``bits_per_posting``.  A request
decodes its lists one after another with the fused unpack and prefix sum
(``ops.unpack_delta_stream``, B6), straight to docids, and ends in a
synchronise after the last.  What is kept and how it is checked is
``list_decode``'s, against the corpus's docids; the control packs each
list one bit narrower than its widest gap needs.  Configuration and
traffic keys as ``list_decode``'s, without ``codec``.
"""

from __future__ import annotations

import time

import numpy as np

from portbench.drivers import list_decode
from portbench.reference import oracles

LIMITS = list_decode.LIMITS
CHECKED = list_decode.CHECKED
FAILED = list_decode.FAILED
ATTEMPTED = list_decode.ATTEMPTED


class Driver(list_decode.Driver):
    def setup(self, corpus) -> None:
        import torch
        from repro_torch.kernels import ops
        _, postings = corpus
        gaps = oracles.gap_lists(postings, sorted(postings))
        self.ops = ops
        self.args, self.n, self.nbytes = {}, {}, {}
        t0 = time.perf_counter()
        for t, g in gaps.items():
            x = torch.as_tensor(g.view(np.int32), device=self.device)
            bw = int(ops.select_bw(x).max())
            packed = ops.pack_stream(x, bw)
            self.args[t] = (packed, bw, len(g))
            self.n[t], self.nbytes[t] = len(g), 4 * packed.numel()
        total = sum(self.n.values())
        self.bits_per_posting = 8 * sum(self.nbytes.values()) / total
        self.log(f"packed {len(gaps)} lists, {total} postings, "
                 f"{self.bits_per_posting:.4f} bits a posting, in "
                 f"{time.perf_counter() - t0:.2f} s")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def serve(self, request: list) -> list:
        import torch
        out = [self.ops.unpack_delta_stream(*self.args[t]) for t in request]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def expected(self, postings: dict, t: int) -> np.ndarray:
        """What a decode of list ``t`` must give: its docids."""
        return postings[t][0]

    def control_output(self, want):
        return oracles.narrowed_docids(want)
