"""Model substrate of the port (counterpart of the JAX package's
``models``): the decoder-only LM (dense and mixture-of-experts), the four
recsys models and EGNN, and their serving paths.

  * ``common``: RMSNorm, RoPE, cross-entropy.
  * ``specs``: parameter specs with logical axes, materialized from one
    ``torch.Generator``; the module form every model shares (``_Tree``)
    and the copy of the reference's weights (``load_reference_params``).
  * ``attention``: chunked online-softmax attention (GQA, sliding window)
    and the one-token decode forms (GQA, absorbed MLA).
  * ``moe``: group-local top-k routing with capacity dropping
    (``route_group``) and the expert FFN (``moe_ffn``).
  * ``transformer``: ``LMConfig``, the ``LM`` module, ``trunk``,
    ``prefill`` and ``decode_step``.
  * ``embedding``: table lookups and EmbeddingBag, the plain path (the
    expert-parallel one waits for ROADMAP.md step A.13.5).
  * ``recsys``: DLRM, Wide&Deep, DIN and DIEN: ``forward``, ``serve``,
    ``loss_fn``'s value and ``retrieval_topk``, in row chunks.
  * ``egnn``: the EGNN forward and its two losses' values, in edge chunks.
  * ``sampler``: the host CSR neighbour sampler (numpy).

No Pallas kernel of the reference sits on these paths: its attention, MoE,
lookups, GRU scan and message passing are plain ``jnp``, so the port's are
plain torch.  Training waits for ROADMAP.md step A.13.4.
"""

from . import (attention, common, egnn, embedding, moe, recsys, sampler,
               specs, transformer)

__all__ = ["attention", "common", "egnn", "embedding", "moe", "recsys",
           "sampler", "specs", "transformer"]
