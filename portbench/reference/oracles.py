"""Plain references for the benchmark's cells, and their controls.

numpy and plain torch only: nothing here imports the program or the JAX
package, and nothing takes what the program made.  Every answer is worked
out again from the benchmark's own corpus (``portbench/corpus.py``).  The
torch parts run on the device they are given, after the program's state
is freed.

* ``gap_lists`` and ``unpatched_gaps``: the d-gaps a decode must give, and
  a lossy control that keeps each gap to the bit width 90 % of its frame
  of 128 fit (a frame of reference with its exceptions left out).
* ``narrowed_docids``: the control of a stream decode, each gap packed one
  bit narrower than the list's widest gap needs.
"""

from __future__ import annotations

import numpy as np
import torch


def gap_lists(postings: dict, terms) -> dict:
    """{term: d-gaps as uint32} of ``terms`` (the first gap the first
    docid)."""
    out = {}
    for t in terms:
        g = np.asarray(postings[t][0], np.uint32).copy()
        g[1:] = g[1:] - g[:-1]
        out[t] = g
    return out


def unpatched_gaps(gaps: torch.Tensor, frame: int = 128,
                   keep: float = 0.9) -> torch.Tensor:
    """The control of a decode: each gap (int64) cut to its low ``b`` bits,
    ``b`` the bit width that the ``keep`` share of its frame of ``frame``
    gaps fits."""
    n = gaps.numel()
    pad = torch.zeros((-n) % frame, dtype=gaps.dtype, device=gaps.device)
    frames = torch.cat([gaps, pad]).reshape(-1, frame)
    q = torch.sort(frames, dim=1).values[:, int(np.ceil(keep * frame)) - 1]
    bits = torch.ceil(torch.log2(q.double() + 1)).long().clamp(min=1)
    cut = frames & ((1 << bits) - 1)[:, None]
    return cut.reshape(-1)[:n]


def narrowed_docids(docids: torch.Tensor) -> torch.Tensor:
    """The control of a stream decode: the docids (int64, ascending) again
    from their d-gaps cut to one bit less than the widest gap's bit length,
    the width a list packed at one width a list needs."""
    gaps = docids.clone()
    gaps[1:] -= docids[:-1]
    bw = int(gaps.max()).bit_length()
    cut = gaps & ((1 << max(bw - 1, 0)) - 1)
    return torch.cumsum(cut, 0) & 0xFFFFFFFF
