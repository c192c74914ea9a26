"""Core library: the codecs, host encoders in numpy and device decoders in
torch (counterpart of the JAX package's ``core``).

  codec.REGISTRY / codec.get / codec.names: all 31 codecs (Table VI)
  Encoded: compressed stream container with exact bit accounting
  bits: the int32-bit-pattern word rules every torch module follows
  dgap: d-gap transform (paper §2.1.1)
  layout: k-way vertical layout + quad-max (paper §3.1/§4.4)
  frames: the frame codecs' shared pack/unpack (paper §6)
"""

from . import (bits, bp128, bp_tpu, codec, dense_bitmap, dgap, frames,
               group_afor, group_pfd, group_scheme, group_simple, group_vse,
               layout, scalar, stream_vbyte)
from .encoded import Encoded

__all__ = [
    "bits", "bp128", "bp_tpu", "codec", "dense_bitmap", "dgap", "frames",
    "group_afor", "group_pfd", "group_scheme", "group_simple", "group_vse",
    "layout", "scalar", "stream_vbyte", "Encoded",
]
