"""pfd_launches_per_list: kernels the device ran a decoded list in the
profiled part (copies and memsets not counted), in any codec's decode
cell."""


def read(rec: dict):
    prof = rec.get("profiled")
    if not prof or not prof["launches"] or not prof["totals"].get("lists"):
        return None
    return prof["launches"] / prof["totals"]["lists"]
