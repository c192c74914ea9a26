"""lm_tokens_per_s: the tokens generated in the window (one a session a
decode step) over its seconds, from its start to the synchronise that
ends its last request."""


def read(rec: dict):
    if "totals" not in rec or rec["window_s"] <= 0:
        return None
    tokens = rec["totals"].get("tokens")
    return None if tokens is None else tokens / rec["window_s"]
