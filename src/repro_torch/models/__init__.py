"""Model substrate of the port (counterpart of the JAX package's
``models``): the decoder-only LM (dense and mixture-of-experts) and its
serving path.

  * ``common``: RMSNorm, RoPE, cross-entropy.
  * ``specs``: parameter specs with logical axes, materialized from one
    ``torch.Generator``.
  * ``attention``: chunked online-softmax attention (GQA, sliding window)
    and the one-token decode forms (GQA, absorbed MLA).
  * ``moe``: group-local top-k routing with capacity dropping
    (``route_group``) and the expert FFN (``moe_ffn``).
  * ``transformer``: ``LMConfig``, the ``LM`` module, ``trunk``,
    ``prefill`` and ``decode_step``.

No Pallas kernel of the reference sits on this path: its attention and its
MoE are plain ``jnp``, so the port's are plain torch.  The recsys and EGNN
models and the sampler wait for a later slice (ROADMAP.md, step A.13.3).
"""

from . import attention, common, moe, specs, transformer

__all__ = ["attention", "common", "moe", "specs", "transformer"]
