"""Entry points of the port (counterpart of the JAX package's ``launch``):
``mesh.serving_mesh`` places doc-range shards on cards, ``serve`` runs the
index serving loop (``python -m repro_torch.launch.serve --index``)."""
