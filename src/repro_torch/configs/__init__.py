"""Architecture registry of the port (``--arch <id>``): the two
mixture-of-experts LMs (deepseek-v2-lite-16b with MLA, mixtral-8x22b with
a sliding window) and the three dense GQA LMs, in the reference's order.
The reference's other architectures are named in ``PENDING`` with the
ROADMAP.md step that ports each; :func:`get` raises ``KeyError`` naming it."""

from . import (deepseek_v2_lite_16b, mixtral_8x22b, smollm_135m,
               starcoder2_3b, starcoder2_7b)

ARCHS = {
    m.ARCH.arch_id: m.ARCH
    for m in (deepseek_v2_lite_16b, mixtral_8x22b, starcoder2_3b,
              starcoder2_7b, smollm_135m)
}

PENDING = {
    "egnn": "EGNN serving (ROADMAP.md, step A.13.3)",
    "din": "recsys serving (ROADMAP.md, step A.13.3)",
    "dien": "recsys serving (ROADMAP.md, step A.13.3)",
    "wide-deep": "recsys serving (ROADMAP.md, step A.13.3)",
    "dlrm-rm2": "recsys serving (ROADMAP.md, step A.13.3)",
}


def get(arch_id: str):
    if arch_id in PENDING:
        raise KeyError(f"{arch_id}: not ported yet, waits for "
                       f"{PENDING[arch_id]}")
    return ARCHS[arch_id]


def all_cells(include_skipped: bool = True):
    """Yield (arch_id, shape_name, cell) for the ported architectures."""
    for aid, spec in ARCHS.items():
        for sname, cell in spec.shapes.items():
            if not include_skipped and cell.skip_reason:
                continue
            yield aid, sname, cell
