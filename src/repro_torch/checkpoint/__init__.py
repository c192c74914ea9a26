"""Checkpoints of the port (counterpart of the JAX package's
``checkpoint``), in the reference's on-disk layout."""

from .checkpointer import Checkpointer, latest_step  # noqa: F401
