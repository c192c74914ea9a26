"""peak_gib.decode: the largest device memory allocated in the window
(``torch.cuda.max_memory_allocated``, reset at its start), in GiB."""

from portbench import trace_read


def read(rec: dict):
    return trace_read.peak_gib(rec)
