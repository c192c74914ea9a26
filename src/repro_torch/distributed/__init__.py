"""Distribution layer of the port (counterpart of the JAX package's
``distributed``):

  * ``sharding``: logical-axis plans (``Plan``, ``activate``,
    ``spec_for``, ``shard``, the five plans), their ``DTensor`` layouts
    and the sharded forms of the models' products and gathers;
    ``balanced_range_bounds``, mass-balanced contiguous cuts;
  * ``collectives``: the compressed gradient all-reduce of data-parallel
    training, over a process group or a list of ranks, and
    ``merge_topk_stats``, the one top-k merge per ranked batch of
    doc-range sharded serving;
  * ``pipeline``: ``pipeline_2stage``, a 2-stage GPipe over "pod".
"""
