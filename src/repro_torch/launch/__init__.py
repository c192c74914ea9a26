"""Entry points of the port (counterpart of the JAX package's ``launch``):
``mesh`` (the process group, the host and production meshes, and
``serving_mesh``, which places doc-range shards on cards), ``train`` and
``serve`` (``python -m repro_torch.launch.serve --index`` for the index
serving loop), ``dryrun`` (every cell on the production meshes, no
card), ``census`` and ``roofline_report``."""
