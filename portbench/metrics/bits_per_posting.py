"""bits_per_posting: the encoded size of all the configuration's d-gap
lists, in bits, over their postings; fixed at set-up."""


def read(rec: dict):
    return rec["fixed"].get("bits_per_posting")
