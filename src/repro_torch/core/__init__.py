"""Core library: the codecs of the inverted index, host encoders in numpy and
device-arena decoders in torch (counterpart of the JAX package's ``core``).

  codec.REGISTRY / codec.get / codec.names: the registered codecs
  Encoded: compressed stream container with exact bit accounting
  bits: the int32-bit-pattern word rules every torch module follows
"""

from . import (bits, bp_tpu, codec, dense_bitmap, dgap, group_simple, layout,
               stream_vbyte)
from .encoded import Encoded

__all__ = ["bits", "bp_tpu", "codec", "dense_bitmap", "dgap", "group_simple",
           "layout", "stream_vbyte", "Encoded"]
