"""wide-deep [arXiv:1606.07792]: 40 sparse features, embed_dim=32,
deep MLP 1024-512-256, wide = linear over sparse ids, concat interaction."""

from ..models.recsys import RecConfig
from .base import ArchSpec, RECSYS_SHAPES, recsys_input_specs


def make_config() -> RecConfig:
    return RecConfig(
        name="wide-deep", model="wide_deep", n_dense=0, n_sparse=40,
        embed_dim=32, table_rows=1 << 20, top_mlp=(1024, 512, 256, 1))


def make_smoke_config() -> RecConfig:
    return RecConfig(
        name="wide-deep-smoke", model="wide_deep", n_dense=0, n_sparse=10,
        embed_dim=8, table_rows=64, top_mlp=(16, 8, 1))


ARCH = ArchSpec(
    arch_id="wide-deep", family="recsys",
    make_config=make_config, make_smoke_config=make_smoke_config,
    shapes=RECSYS_SHAPES, plan_for=None,
    input_specs=recsys_input_specs, batch_axes=None,
)
