"""dien [arXiv:1809.03672]: embed_dim=18, seq_len=100, interest-extractor GRU
(hidden 108) + attentional AUGRU, final MLP 200-80.  (DIEN's auxiliary
next-item loss is omitted — noted in DESIGN.md.)"""

from ..models.recsys import RecConfig
from .base import (ArchSpec, RECSYS_SHAPES, recsys_batch_axes,
                   recsys_input_specs, recsys_plan_for)


def make_config() -> RecConfig:
    return RecConfig(
        name="dien", model="dien", embed_dim=18, seq_len=100, gru_dim=108,
        attn_mlp=(80, 40), mlp=(200, 80),
        item_vocab=1 << 20, cate_vocab=1 << 14, n_profile=2,
        profile_vocab=1 << 16, table_rows=1 << 20)


def make_smoke_config() -> RecConfig:
    return RecConfig(
        name="dien-smoke", model="dien", embed_dim=8, seq_len=10, gru_dim=12,
        attn_mlp=(8, 4), mlp=(16, 8), item_vocab=128, cate_vocab=32,
        n_profile=2, profile_vocab=32, table_rows=64)


ARCH = ArchSpec(
    arch_id="dien", family="recsys",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=RECSYS_SHAPES, plan_for=recsys_plan_for,
    input_specs=recsys_input_specs, batch_axes=recsys_batch_axes,
)
