"""device_idle.decode: the share of the profiled part in which the device
ran no operation (kernel, copy or memset)."""

from portbench import trace_read


def read(rec: dict):
    return trace_read.idle_pct(rec)
