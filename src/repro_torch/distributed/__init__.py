"""Distribution helpers of the port (counterpart of the JAX package's
``distributed``), for doc-range sharded serving:

  * ``sharding.balanced_range_bounds``: mass-balanced contiguous cuts;
  * ``collectives.merge_topk_stats``: the one top-k merge per ranked batch.

The LM sharding plans and the compressed gradient all-reduce are training
code and are not ported yet (``ROADMAP.md`` step A.13).
"""
