"""lm_launches_per_step: kernels the device ran a decode step (all
sessions' one token) in the profiled part (copies and memsets not
counted): the host's dispatch of a step."""


def read(rec: dict):
    prof = rec.get("profiled")
    if not prof or not prof["launches"] or not prof["totals"].get("steps"):
        return None
    return prof["launches"] / prof["totals"]["steps"]
