"""dlrm-rm2 [arXiv:1906.00091]: 13 dense + 26 sparse features, embed_dim=64,
bot MLP 13-512-256-64, top MLP 512-512-256-1, dot interaction.  Tables:
26 x 2^20 rows (1.7B embedding params), row-sharded over "model" (EP)."""

from ..models.recsys import RecConfig
from .base import ArchSpec, RECSYS_SHAPES, recsys_input_specs


def make_config() -> RecConfig:
    return RecConfig(
        name="dlrm-rm2", model="dlrm", n_dense=13, n_sparse=26, embed_dim=64,
        table_rows=1 << 20, bot_mlp=(512, 256, 64), top_mlp=(512, 512, 256, 1))


def make_smoke_config() -> RecConfig:
    return RecConfig(
        name="dlrm-smoke", model="dlrm", n_dense=13, n_sparse=6, embed_dim=8,
        table_rows=64, bot_mlp=(16, 8), top_mlp=(16, 8, 1))


ARCH = ArchSpec(
    arch_id="dlrm-rm2", family="recsys",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=RECSYS_SHAPES, plan_for=None,
    input_specs=recsys_input_specs, batch_axes=None,
    notes="multi-hot id bags in the input pipeline are sorted -> d-gapped -> "
          "Group-compressed (paper integration point)",
)
