"""Driver ``list_decode``: whole posting lists decoded on the device by the
port's codec (``codec.get(<codec>).torch.vec``), the lists' d-gaps encoded
from the benchmark's corpus at set-up.

A request decodes its lists one after another and ends in a synchronise
after the last: the paper's measure, integers decoded a second, over the
whole index.  Configuration keys: ``codec``, ``n_lists``.  Traffic keys:
``lists_per_request`` (see ``portbench/generator.py``), ``warmup``
(requests before the window), ``check_share``.

Set-up encodes every list of the configuration on the host and puts all
of them on the device; their encoded size over their postings is the
cell's ``bits_per_posting``.  The outputs kept for the check stay on the
device until the window has closed: every list of the window's first
request, and of the later ones each list with probability
``check_share``, drawn from the seed.
"""

from __future__ import annotations

import time

import numpy as np

from portbench import bytecount
from portbench.reference import oracles

LIMITS = {"postings_wrong": 0, "lists_wrong": 0}     # a decode is lossless
CHECKED = "postings_checked"
FAILED = "lists_wrong"
ATTEMPTED = "lists"


class Driver:
    def __init__(self, config: dict, traffic: dict, device, log,
                 seed: int = None):
        self.config, self.traffic, self.device, self.log = (
            config, traffic, device, log)

    def prepare(self) -> None:
        pass

    def setup(self, corpus) -> None:
        import torch
        from repro_torch.core import codec as codec_lib
        _, postings = corpus
        c = codec_lib.get(self.config["codec"])
        gaps = oracles.gap_lists(postings, sorted(postings))
        self.vec = c.torch.vec
        self.args, self.n, self.nbytes = {}, {}, {}
        t0 = time.perf_counter()
        for t, g in gaps.items():
            enc = c.encode(g)
            self.args[t] = c.torch.args(enc, self.device)
            self.n[t], self.nbytes[t] = len(g), enc.nbytes()
        total = sum(self.n.values())
        self.bits_per_posting = 8 * sum(self.nbytes.values()) / total
        self.log(f"encoded {len(gaps)} lists, {total} postings, "
                 f"{self.bits_per_posting:.4f} bits a posting, in "
                 f"{time.perf_counter() - t0:.2f} s")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def serve(self, request: list) -> list:
        import torch
        out = [self.vec(**self.args[t]) for t in request]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def units(self, request: list) -> dict:
        return {"postings": sum(self.n[t] for t in request),
                "lists": len(request),
                "min_bytes": sum(bytecount.decode_bytes(self.nbytes[t],
                                                        self.n[t])
                                 for t in request)}

    def keep(self, request: list, outs: list, sample, share: float,
             whole: bool) -> list:
        """(term, output) pairs to check: all of them where ``whole``,
        else each with probability ``share`` from ``sample``.  The
        outputs stay where they are: no copy inside the window.  A list
        with no output is kept with None, which the check counts wrong."""
        outs = list(outs) + [None] * (len(request) - len(outs))
        return [(t, o) for t, o in zip(request, outs)
                if whole or sample.random() < share]

    def fixed(self) -> dict:
        return {"bits_per_posting": self.bits_per_posting}

    def teardown(self) -> None:
        del self.args

    # ---- the check ------------------------------------------------------ #

    def expected(self, postings: dict, t: int) -> np.ndarray:
        """What a decode of list ``t`` must give: its d-gaps."""
        return oracles.gap_lists(postings, [t])[t]

    def control_output(self, want):
        """The control's output in the program's place."""
        return oracles.unpatched_gaps(want)

    def check(self, corpus, kept: list, control: bool = False) -> dict:
        """{number: value} of the decoded lists in ``kept`` ((term, output)
        pairs) held against the corpus (:meth:`expected`); with
        ``control`` the control's outputs (:meth:`control_output`) stand
        in for the program's."""
        import torch
        _, postings = corpus
        want = {}
        wrong = checked = lists_wrong = 0
        for t, got in kept:
            if t not in want:
                want[t] = torch.as_tensor(
                    self.expected(postings, t).astype(np.int64),
                    device=self.device)
            w = want[t]
            if control:
                got = self.control_output(w)
            checked += w.numel()
            if got is None or got.numel() != w.numel():
                bad = w.numel()
            else:
                # the program's int32 words are the values' uint32 bits
                got = got.to(self.device, torch.int64) & 0xFFFFFFFF
                bad = int((got != w).sum())
            wrong += bad
            lists_wrong += bad > 0
        return {"postings_wrong": wrong, "lists_wrong": lists_wrong,
                "postings_checked": checked}
