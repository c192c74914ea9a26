"""Model substrate of the port (counterpart of the JAX package's
``models``): the dense decoder-only LM and its serving path.

  * ``common``: RMSNorm, RoPE, cross-entropy.
  * ``specs``: parameter specs with logical axes, materialized from one
    ``torch.Generator``.
  * ``attention``: chunked online-softmax attention (GQA, sliding window)
    and the one-token decode forms (GQA, absorbed MLA).
  * ``transformer``: ``LMConfig``, the ``LM`` module, ``trunk``,
    ``prefill`` and ``decode_step``.

No Pallas kernel of the reference sits on this path: its attention is plain
``jnp`` under ``lax.scan``, so the port's is plain torch.  MoE, the
recsys and EGNN models and the sampler wait for later slices (ROADMAP.md,
steps A.13.2 and A.13.3).
"""
