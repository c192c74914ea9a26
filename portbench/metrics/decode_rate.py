"""decode_rate: the postings decoded in the window over its seconds, from
its start to the synchronise after the last request's last list."""


def read(rec: dict):
    if "totals" not in rec or rec["window_s"] <= 0:
        return None
    return rec["totals"]["postings"] / rec["window_s"]
