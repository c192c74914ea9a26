"""device_idle.lm: the share of an untraced decode step in which the
device ran no operation: one minus the device's busy seconds a step in
the profiled part (kernels, copies and memsets, from the profiler's
record) over the wall seconds a step in the window's untraced second
half.  The profiler's own cost on the step's thousands of launches
stretches the profiled part's wall time (about 2.7 times, PERF.md
section 5) but not the device's work, so the idle share of the profiled
part itself, which ``device`` gives, reads high."""


def read(rec: dict):
    prof, plain = rec.get("profiled"), rec.get("untraced")
    if not prof or not plain or prof["busy_s"] <= 0:
        return None
    steps, plain_steps = prof["totals"].get("steps"), plain["totals"].get(
        "steps")
    if not steps or not plain_steps or plain["window_s"] <= 0:
        return None
    busy = prof["busy_s"] / steps
    return 100.0 * (1.0 - busy / (plain["window_s"] / plain_steps))
