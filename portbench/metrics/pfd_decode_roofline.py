"""pfd_decode_roofline: a whole-list decode against the HBM roofline: each
decoded list's encoded bytes read once and 4 B a posting written
(``bytecount.decode_bytes``), at the H100's 3.35 TB/s, over the device's
busy time in the profiled part (all of it the decode's).  The driver
gives the bytes, so one reader serves every codec's decode cell: the
Group-PFD decoder's and the stream codec's."""

from portbench import bytecount


def read(rec: dict):
    prof = rec.get("profiled")
    if not prof or prof["busy_s"] <= 0:
        return None
    nbytes = prof["totals"].get("min_bytes", 0)
    return 100.0 * bytecount.seconds_at_peak(nbytes) / prof["busy_s"]
