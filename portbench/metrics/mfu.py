"""mfu: the model's work in the window (``portbench/flops.py``: the
published model's operations at each token's position, whatever
implements them) over its seconds, as a share of the H100's dense bf16
peak."""

from portbench import flops


def read(rec: dict):
    if "totals" not in rec or rec["window_s"] <= 0:
        return None
    work = rec["totals"].get("model_flops")
    if work is None:
        return None
    return 100.0 * work / rec["window_s"] / flops.PEAK_BF16_FLOPS
