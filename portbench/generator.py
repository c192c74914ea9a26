"""The one traffic generator: requests drawn from a seed and a traffic
file's parameters (``portbench/traffic/<name>.json``).

A request is a list of posting lists (term ids, which are frequency
ranks) for the traffic's ``driver`` to serve.  The lists come in passes:
each pass is a permutation of all the configuration's lists, drawn anew
from the seed, cut into requests of ``lists_per_request`` lists (``"all"``:
one request a pass).  So every seed asks for the same lists, as often, in
another order.  The loop is closed: the next request starts when the last
one has its answer.

Streams are independent: the warm-up, the window and the check sample draw
from their own generators, each seeded by (seed, stream), so the window's
requests do not depend on how many warm-up requests ran.
"""

from __future__ import annotations

import numpy as np

WARMUP, WINDOW, SAMPLE = 1, 2, 3


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


def requests(seed: int, stream: int, traffic: dict, n_lists: int):
    """The endless request stream ``stream`` of ``seed`` over ``n_lists``
    lists."""
    g = rng(seed, stream)
    per = traffic["lists_per_request"]
    per = n_lists if per == "all" else int(per)
    while True:
        order = g.permutation(n_lists).tolist()
        for i in range(0, n_lists, per):
            yield order[i:i + per]
