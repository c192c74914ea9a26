"""din [arXiv:1706.06978]: embed_dim=18, behaviour seq_len=100, target
attention MLP 80-40, final MLP 200-80."""

from ..models.recsys import RecConfig
from .base import ArchSpec, RECSYS_SHAPES, recsys_input_specs


def make_config() -> RecConfig:
    return RecConfig(
        name="din", model="din", embed_dim=18, seq_len=100,
        attn_mlp=(80, 40), mlp=(200, 80),
        item_vocab=1 << 20, cate_vocab=1 << 14, n_profile=2,
        profile_vocab=1 << 16, table_rows=1 << 20)


def make_smoke_config() -> RecConfig:
    return RecConfig(
        name="din-smoke", model="din", embed_dim=8, seq_len=10,
        attn_mlp=(8, 4), mlp=(16, 8), item_vocab=128, cate_vocab=32,
        n_profile=2, profile_vocab=32, table_rows=64)


ARCH = ArchSpec(
    arch_id="din", family="recsys",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=RECSYS_SHAPES, plan_for=None,
    input_specs=recsys_input_specs, batch_axes=None,
)
