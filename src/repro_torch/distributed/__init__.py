"""Distribution helpers of the port (counterpart of the JAX package's
``distributed``):

  * ``sharding.balanced_range_bounds``: mass-balanced contiguous cuts;
  * ``collectives.merge_topk_stats``: the one top-k merge per ranked batch
    of doc-range sharded serving;
  * ``collectives.compressed_psum_mean``: the compressed gradient
    all-reduce of data-parallel training.

The LM sharding plans wait for ``ROADMAP.md`` step A.13.5.
"""
