"""Synthetic corpora with paper-matched statistics."""
