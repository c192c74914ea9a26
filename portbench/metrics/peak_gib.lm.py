"""peak_gib.lm: the largest device memory allocated in the LM decode's
window (``torch.cuda.max_memory_allocated``, reset at its start), in GiB:
the weights, the sessions' caches, a step's transients and the kept
logits."""

from portbench import trace_read


def read(rec: dict):
    return trace_read.peak_gib(rec)
