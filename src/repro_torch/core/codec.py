"""Codec protocol: capability-declaring codecs, the registry the index, the
device arenas and the tests discover codecs through.

Counterpart of the JAX package's ``core/codec.py``, with the same 31 codecs
under the same names, categories, ``max_bits``, ``is_group`` flags and arena
layouts: the scalar baselines (host only), Stream VByte, the paper's Group
family (Group-Simple, the 10 Group-Scheme variants, Group-AFOR, Group-VSE,
Group-PFD, Group-OptPFD, BP128, Group-PackedBinary), the dense-bitmap
blocks and the stream codec's host codec ``bp_tpu``.  Any other name raises
a ``KeyError`` with the nearest-name hint.

A :class:`Codec` provides the host surface

  encode(np.uint32[N]) -> Encoded
  decode_np(Encoded)   -> np.uint32[N]          (numpy oracle)

and may declare

  * :class:`TorchDecode` (``Codec.torch``), where the reference declares
    ``JaxDecode``: ``args(Encoded, device=...)`` packs the keyword
    arguments with the tensors on an explicit device, ``scalar(**kw)`` is
    the paper's one-quadruple-a-step routine (a loop where the reference
    has ``lax.scan``) and ``vec(**kw)`` its vectorized decode of a whole
    list (the Table VII rows);
  * :class:`ArenaLayout`: N named padded columns (:class:`ArenaColumn`) per
    posting block plus a batched ``decode_block(*column_slices,
    *column_lens, n_valid)`` in torch.  Where the reference decodes one
    block under ``vmap``, each slice here is a ``(P, width)`` int32 tensor
    and each length a ``(P,)`` tensor, so one call decodes a whole
    work-list, with no host sync.
"""

from __future__ import annotations

import dataclasses
import difflib
import functools
from typing import Any, Callable, Optional

import numpy as np

from . import bp128, group_afor, group_pfd, group_scheme, group_simple, scalar
from . import bp_tpu, dense_bitmap, group_vse, stream_vbyte
from .encoded import Encoded
from ..obs.trace import codec_tracer

# One posting block of the inverted index is at most this many integers; all
# declared arena widths are padded maxima for a block of this size.
ARENA_BLOCK = 512


@dataclasses.dataclass(frozen=True)
class TorchDecode:
    """Device decode capability: argument packing on an explicit device,
    and the scalar and vectorized whole-list decoders (int32 words)."""

    args: Callable[..., dict]
    scalar: Callable[..., Any]
    vec: Callable[..., Any]


def _block_ctrl_default(enc: Encoded) -> np.ndarray:
    return np.asarray(enc.control).reshape(-1)


def _block_data_default(enc: Encoded) -> np.ndarray:
    return np.asarray(enc.data, np.uint32).reshape(-1)


def _supports_default(enc: Encoded) -> bool:
    return True


@dataclasses.dataclass(frozen=True)
class ArenaColumn:
    """One named padded stream of an :class:`ArenaLayout`.

    name: column role (``"ctrl"``, ``"data"``, ...).
    width: padded per-block maximum (flat words); slack past a block's own
        words may hold the *next* block's words, so ``decode_block`` masks
        everything past the column's dynamic length.
    extract(enc): pull one encoded block's words for this column (host side,
        at arena build time).
    dtype: the numpy dtype the column's words are extracted as; on the device
        every column is held as int32 bit patterns.
    """

    name: str
    width: int
    extract: Callable[[Encoded], np.ndarray] = _block_data_default
    dtype: Any = np.uint32


@dataclasses.dataclass(frozen=True)
class ArenaLayout:
    """Fixed-shape device-arena contract for one posting block.

    columns: the declared :class:`ArenaColumn` streams, in ``decode_block``
        argument order.
    out_width: static length of ``decode_block``'s rows (zero-padded past
        ``n_valid``).
    decode_block(*column_slices, *column_lens, n_valid) -> (P, out_width)
        int32 words; slices are ``(P, width)``, lengths and ``n_valid`` are
        ``(P,)``.
    supports(enc): per-block eligibility for this layout.
    max_n: largest block the widths are sized for (the index block size).
    bitmap_words / is_bitmap: a layout whose blocks may be raw docid bitmaps
        declares the window size (words) and a per-block predicate; the arena
        then also stages those blocks for the word-parallel rounds.
    """

    columns: tuple
    out_width: int
    decode_block: Callable[..., Any]
    supports: Callable[[Encoded], bool] = _supports_default
    max_n: int = ARENA_BLOCK
    bitmap_words: int = 0
    is_bitmap: Optional[Callable[[Encoded], bool]] = None

    @classmethod
    def two_column(cls, ctrl_width: int, data_width: int, out_width: int,
                   decode_block: Callable[..., Any],
                   block_ctrl: Callable[[Encoded], np.ndarray] = _block_ctrl_default,
                   block_data: Callable[[Encoded], np.ndarray] = _block_data_default,
                   supports: Callable[[Encoded], bool] = _supports_default,
                   ctrl_dtype: Any = np.int32,
                   max_n: int = ARENA_BLOCK) -> "ArenaLayout":
        """The (ctrl, data) form: ``decode_block`` keeps the
        ``(ctrl, data, ctrl_len, n_valid)`` signature."""
        return cls(
            columns=(ArenaColumn("ctrl", ctrl_width, block_ctrl, ctrl_dtype),
                     ArenaColumn("data", data_width, block_data, np.uint32)),
            out_width=out_width,
            decode_block=_adapt_two_column(decode_block),
            supports=supports, max_n=max_n)

    @property
    def ctrl_width(self) -> int:
        return self.columns[0].width

    @property
    def data_width(self) -> int:
        return self.columns[1].width

    @property
    def ctrl_dtype(self) -> Any:
        return self.columns[0].dtype

    @property
    def block_ctrl(self) -> Callable[[Encoded], np.ndarray]:
        return self.columns[0].extract

    @property
    def block_data(self) -> Callable[[Encoded], np.ndarray]:
        return self.columns[1].extract


def _adapt_two_column(fn: Callable[..., Any]) -> Callable[..., Any]:
    """Bind a ``(ctrl, data, ctrl_len, n_valid)`` decoder to the generic
    N-column ``(*slices, *lens, n_valid)`` contract."""

    def decode(ctrl, data, ctrl_len, data_len, n_valid):
        return fn(ctrl, data, ctrl_len, n_valid)

    return decode


@dataclasses.dataclass(frozen=True)
class Codec:
    """A registered codec: required host surface + declared capabilities."""

    name: str
    category: str                  # bit | byte | word | frame
    encode: Callable[[np.ndarray], Encoded]
    decode_np: Callable[[Encoded], np.ndarray]
    max_bits: int = 32             # values above 2**max_bits-1 unsupported
    is_group: bool = False         # uses the paper's Group approach
    torch: Optional[TorchDecode] = None
    arena: Optional[ArenaLayout] = None

    @property
    def decode(self) -> Callable[[Encoded], np.ndarray]:
        return self.decode_np


REGISTRY: dict[str, Codec] = {}


def _in_span(span: str, lane: str, fn: Callable,
             counts: Callable) -> Callable:
    """``fn`` in a codec-layer span named ``span``, its args ``counts`` of
    the call's arguments; the bare call unless the codec spans are on."""

    @functools.wraps(fn)
    def traced(*args, **kw):
        tracer = codec_tracer()
        if not tracer.enabled:
            return fn(*args, **kw)
        with tracer.span(span, lane=lane, **counts(*args, **kw)):
            return fn(*args, **kw)
    return traced


def _encode_counts(x, *args, **kw) -> dict:
    return {"n": len(x)}


def _vec_counts(**kw) -> dict:
    """A whole-list decode's postings, and its exceptions where the codec
    has them (``torch_args`` gives their total)."""
    if "total_exc" in kw:
        return {"n": kw["n"], "exc": kw["total_exc"]}
    return {"n": kw["n"]}


def register(spec: Codec) -> Codec:
    """Register ``spec`` under its name, its encoder and whole-list decoder
    each in a span of that name (``encode/<name>``, ``decode_list/<name>``;
    codecs that share a module keep their own), a no-op unless the
    tracer's codec spans are on (``enable_tracing(codec=True)``)."""
    torch_dec = spec.torch
    if torch_dec is not None:
        torch_dec = dataclasses.replace(torch_dec, vec=_in_span(
            f"decode_list/{spec.name}", "device", torch_dec.vec, _vec_counts))
    spec = dataclasses.replace(spec, torch=torch_dec, encode=_in_span(
        f"encode/{spec.name}", "host", spec.encode, _encode_counts))
    REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> Codec:
    try:
        return REGISTRY[name]
    except KeyError:
        known = names()
        near = difflib.get_close_matches(str(name), known, n=1)
        hint = f" (did you mean {near[0]!r}?)" if near else ""
        raise KeyError(
            f"unknown codec {name!r}{hint}; registered codecs: {', '.join(known)}"
        ) from None


def names(category: str | None = None, group_only: bool = False) -> list[str]:
    """Registered codec names, deterministically sorted."""
    return sorted(
        k for k, s in REGISTRY.items()
        if (category is None or s.category == category)
        and (not group_only or s.is_group)
    )


# --------------------------------------------------------------------------- #
# arena layouts: thin shims binding each codec module's batched decoder to
# the uniform column contract, created once at registration
# --------------------------------------------------------------------------- #

_GS_PMAX = ARENA_BLOCK // 4            # max Group-Simple vectors per block


def _gs_block_ctrl(enc: Encoded) -> np.ndarray:
    return np.asarray(enc.meta["sels"], np.int32)


def _gs_decode_block(ctrl, data, ctrl_len, n_valid):
    return group_simple.decode_arena_block(
        ctrl, data.reshape(data.shape[0], -1, 4), ctrl_len, n_valid)


_GS_ARENA = ArenaLayout.two_column(
    ctrl_width=_GS_PMAX, data_width=4 * _GS_PMAX, out_width=ARENA_BLOCK,
    decode_block=_gs_decode_block, block_ctrl=_gs_block_ctrl)

_BP_WMAX = ARENA_BLOCK // 4            # max data words per component per block


def _bp_block_ctrl(enc: Encoded) -> np.ndarray:
    return np.asarray(enc.control, np.int32)


def _bp_decode_block(ctrl, data, ctrl_len, n_valid, *, frame_quads):
    return bp128.decode_arena_block(
        ctrl, data.reshape(data.shape[0], -1, 4), n_valid, frame_quads)


def _bp_supports(enc: Encoded, *, frame_quads) -> bool:
    # the layout's frame size is baked into its fixed shapes; a block encoded
    # at any other frame size takes the host oracle
    return enc.meta.get("frame_quads") == frame_quads


def _bp_arena(frame_quads: int) -> ArenaLayout:
    return ArenaLayout.two_column(
        ctrl_width=-(-_BP_WMAX // frame_quads),
        data_width=4 * (_BP_WMAX + 2),
        out_width=ARENA_BLOCK,
        decode_block=functools.partial(_bp_decode_block,
                                       frame_quads=frame_quads),
        block_ctrl=_bp_block_ctrl,
        supports=functools.partial(_bp_supports, frame_quads=frame_quads))


def _svb_block_data(enc: Encoded) -> np.ndarray:
    # payload bytes widened to one word each
    return np.asarray(enc.data, np.uint32)


_SVB_ARENA = ArenaLayout.two_column(
    ctrl_width=ARENA_BLOCK // 4,               # one control byte per quadruple
    data_width=4 * ARENA_BLOCK + 4,            # worst-case payload + gather slack
    out_width=ARENA_BLOCK,
    decode_block=stream_vbyte.decode_arena_block,
    block_ctrl=_block_ctrl_default,            # control bytes, one per word
    block_data=_svb_block_data,
    ctrl_dtype=np.uint32)


def _gsch_arena(variant: str) -> ArenaLayout:
    return ArenaLayout.two_column(
        ctrl_width=group_scheme.arena_ctrl_width(variant),
        data_width=4 * (ARENA_BLOCK // 4 + 2),
        out_width=ARENA_BLOCK,
        decode_block=functools.partial(group_scheme.decode_arena_block,
                                       variant=variant),
        block_ctrl=group_scheme.arena_block_ctrl,
        ctrl_dtype=np.uint32)


# ---- frame-family layouts (AFOR / VSE / PFD): shared vertical data stream -- #

_FR_WMAX = ARENA_BLOCK // 4        # max data words per component per block
_FR_DATA = 4 * (_FR_WMAX + 2)      # flat words incl. the unpack slack rows


def _ctrl_col(width: int) -> ArenaColumn:
    return ArenaColumn("ctrl", width, _block_ctrl_default, np.int32)


_AFOR_ARENA = ArenaLayout(
    columns=(_ctrl_col(group_afor.ARENA_F), ArenaColumn("data", _FR_DATA)),
    out_width=ARENA_BLOCK, decode_block=group_afor.decode_arena_block)

_VSE_ARENA = ArenaLayout(
    columns=(_ctrl_col(2 * group_vse.ARENA_F), ArenaColumn("data", _FR_DATA)),
    out_width=ARENA_BLOCK, decode_block=group_vse.decode_arena_block)


def _pfd_block_exc(enc: Encoded) -> np.ndarray:
    exc = enc.exceptions
    return np.zeros(0, np.uint32) if exc is None else np.asarray(exc, np.uint32)


_PFD_ARENA = ArenaLayout(
    columns=(_ctrl_col(2 * group_pfd.ARENA_F), ArenaColumn("data", _FR_DATA),
             ArenaColumn("exceptions", group_pfd.ARENA_EXC_WORDS + 2,
                         _pfd_block_exc)),
    out_width=ARENA_BLOCK, decode_block=group_pfd.decode_arena_block)


def _dense_block_ctrl(enc: Encoded) -> np.ndarray:
    return np.asarray(enc.control, np.uint32).reshape(-1)


# dense-bitmap blocks: ctrl = [fmt, base]; bitmap format stores exactly the
# 128 window words, the raw fallback stores up to ARENA_BLOCK verbatim values
_DENSE_ARENA = ArenaLayout(
    columns=(ArenaColumn("ctrl", 2, _dense_block_ctrl, np.uint32),
             ArenaColumn("data", ARENA_BLOCK)),
    out_width=ARENA_BLOCK,
    decode_block=dense_bitmap.decode_arena_block,
    bitmap_words=dense_bitmap.WINDOW_WORDS,
    is_bitmap=dense_bitmap.is_bitmap)


def _torch_of(module) -> TorchDecode:
    return TorchDecode(module.torch_args, module.decode_torch_scalar,
                       module.decode_torch_vec)


# --------------------------------------------------------------------------- #
# registry: every codec module registered through the protocol
# --------------------------------------------------------------------------- #

# ---- scalar baselines ------------------------------------------------------ #
register(Codec("varbyte", "byte", scalar.vb_encode, scalar.vb_decode))
register(Codec("stream_vbyte", "byte", stream_vbyte.encode,
               stream_vbyte.decode_np, torch=_torch_of(stream_vbyte),
               arena=_SVB_ARENA))
register(Codec("gvb", "byte", scalar.gvb_encode, scalar.gvb_decode))
register(Codec("g8iu", "byte", scalar.g8iu_encode, scalar.g8iu_decode))
register(Codec("g8cu", "byte", scalar.g8cu_encode, scalar.g8cu_decode))
register(Codec("simple9", "word", scalar.simple9_encode, scalar.simple9_decode,
               max_bits=28))
register(Codec("simple16", "word", scalar.simple16_encode,
               scalar.simple16_decode, max_bits=28))
register(Codec("rice", "bit", scalar.rice_encode, scalar.rice_decode))
register(Codec("gamma", "bit", scalar.gamma_encode, scalar.gamma_decode,
               max_bits=31))
register(Codec("pfordelta", "frame", scalar.pfd_encode, scalar.pfd_decode))
register(Codec("afor", "frame", scalar.afor_encode, scalar.afor_decode))
register(Codec("packed_binary", "frame", scalar.packedbinary_encode,
               scalar.packedbinary_decode))

# ---- Group family (this paper) --------------------------------------------- #
register(Codec("group_simple", "word", group_simple.encode,
               group_simple.decode_np, is_group=True,
               torch=_torch_of(group_simple), arena=_GS_ARENA))

for _v in group_scheme.VARIANTS:
    register(Codec(
        f"group_scheme_{_v}", "bit" if int(_v.split("-")[0]) < 8 else "byte",
        functools.partial(group_scheme.encode, variant=_v),
        group_scheme.decode_np, is_group=True,
        torch=_torch_of(group_scheme), arena=_gsch_arena(_v)))

register(Codec("group_afor", "frame", group_afor.encode, group_afor.decode_np,
               is_group=True, torch=_torch_of(group_afor), arena=_AFOR_ARENA))
register(Codec("group_vse", "frame", group_vse.encode, group_vse.decode_np,
               is_group=True, torch=_torch_of(group_vse), arena=_VSE_ARENA))
register(Codec("group_pfd", "frame", group_pfd.encode, group_pfd.decode_np,
               is_group=True, torch=_torch_of(group_pfd), arena=_PFD_ARENA))
register(Codec("group_optpfd", "frame",
               functools.partial(group_pfd.encode, opt=True),
               group_pfd.decode_np, is_group=True,
               torch=_torch_of(group_pfd),
               arena=_PFD_ARENA))       # same block format -> shared layout
register(Codec("bp128", "frame", bp128.encode, bp128.decode_np, is_group=True,
               torch=_torch_of(bp128), arena=_bp_arena(32)))
register(Codec("bp_tpu", "frame", bp_tpu.encode, bp_tpu.decode_np,
               is_group=True))
register(Codec("dense_bitmap", "word", dense_bitmap.encode,
               dense_bitmap.decode_np, arena=_DENSE_ARENA))
register(Codec("g_packed_binary", "frame", bp128.encode_packed_binary,
               bp128.decode_np, is_group=True, torch=_torch_of(bp128),
               arena=_bp_arena(128)))
