"""Model substrate of the port (counterpart of the JAX package's
``models``): the decoder-only LM (dense and mixture-of-experts), the four
recsys models and EGNN: their serving paths and their losses, which
train (``runtime.trainer``).

  * ``common``: RMSNorm, RoPE, cross-entropy.
  * ``specs``: parameter specs with logical axes, materialized from one
    ``torch.Generator``; the module form every model shares (``_Tree``)
    and the copy of the reference's weights (``load_reference_params``).
  * ``attention``: chunked online-softmax attention (GQA, sliding window)
    and the one-token decode forms (GQA, absorbed MLA).
  * ``moe``: group-local top-k routing with capacity dropping
    (``route_group``) and the expert FFN (``moe_ffn``).
  * ``transformer``: ``LMConfig``, the ``LM`` module, ``trunk``,
    ``loss_fn`` (the chunked cross entropy), ``prefill`` and
    ``decode_step``.
  * ``embedding``: table lookups and EmbeddingBag, the plain path and the
    expert-parallel one (rows over "model" under a plan).
  * ``recsys``: DLRM, Wide&Deep, DIN and DIEN: ``forward``, ``serve``,
    ``loss_fn`` and ``retrieval_topk``, in row chunks.
  * ``egnn``: the EGNN forward and its two losses, in edge chunks.
  * ``sampler``: the host CSR neighbour sampler (numpy).

No Pallas kernel of the reference sits on these paths: its attention, MoE,
lookups, GRU scan and message passing are plain ``jnp``, so the port's are
plain torch.  Under autograd the models recompute in backward where the
reference runs ``jax.checkpoint`` (``specs.grad_on``).  Under a sharding
plan (``distributed.sharding.plan_scope``) the same code runs on
``DTensor`` parameters and inputs, laid out by the reference's
``shard(...)`` calls.
"""

from . import (attention, common, egnn, embedding, moe, recsys, sampler,
               specs, transformer)

__all__ = ["attention", "common", "egnn", "embedding", "moe", "recsys",
           "sampler", "specs", "transformer"]
