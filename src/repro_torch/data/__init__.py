"""Synthetic corpora with paper-matched statistics (``synth``) and the
compressed data stores (``pipeline``)."""

from . import pipeline, synth  # noqa: F401
