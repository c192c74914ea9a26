"""Training runtime of the port (counterpart of the JAX package's
``runtime``): the train-step factories (``trainer``) and the
fault-tolerant loop (``train_loop``)."""

from . import train_loop, trainer  # noqa: F401
