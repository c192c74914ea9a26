"""Architecture registry of the port (``--arch <id>``): the reference's 10
architectures in its order, the LMs (dense and mixture-of-experts), EGNN
and the four recsys models.  ``PENDING`` names an architecture that is not
ported yet with the ROADMAP.md step that ports it (none is left);
:func:`get` raises ``KeyError`` naming it."""

from . import (deepseek_v2_lite_16b, dien, din, dlrm_rm2, egnn, mixtral_8x22b,
               smollm_135m, starcoder2_3b, starcoder2_7b, wide_deep)

ARCHS = {
    m.ARCH.arch_id: m.ARCH
    for m in (deepseek_v2_lite_16b, mixtral_8x22b, starcoder2_3b,
              starcoder2_7b, smollm_135m, egnn, din, wide_deep, dlrm_rm2, dien)
}

PENDING: dict = {}


def get(arch_id: str):
    if arch_id in PENDING:
        raise KeyError(f"{arch_id}: not ported yet, waits for "
                       f"{PENDING[arch_id]}")
    return ARCHS[arch_id]


def all_cells(include_skipped: bool = True):
    """Yield (arch_id, shape_name, cell) for the full 40-cell matrix."""
    for aid, spec in ARCHS.items():
        for sname, cell in spec.shapes.items():
            if not include_skipped and cell.skip_reason:
                continue
            yield aid, sname, cell
