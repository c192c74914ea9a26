"""AdamW of the port (counterpart of the JAX package's ``optim``)."""

from . import adamw  # noqa: F401
from .adamw import (AdamWConfig, adamw_init, adamw_update,  # noqa: F401
                    cosine_lr, global_norm)
