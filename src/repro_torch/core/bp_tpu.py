"""BP-TPU: the wide vertical layout codec (counterpart of the JAX package's
``core/bp_tpu.py``).

Generalizes SIMD-BP128's 4-lane frames to the kernel tile: a frame is 4096
integers in a (32, 128) tile, packed at the frame's OR-pseudo-max bit width
into exactly (bw, 128) words, the layout the stream kernels consume
(``kernels/bitpack`` B7a/B7b, ``kernels/unpack_delta`` B6).  Ratio cost vs
BP128: one bit width covers 4096 ints instead of 128, in exchange for
full-width decode with no per-group control flow.

A host codec: encode and ``decode_np`` run the torch oracles of
``kernels/ref.py`` on the CPU, as the reference runs its ``ref.py``; the
same words feed the stream kernels on the card unchanged.  ``meta`` holds
``bws`` (one width per frame) and ``parts`` ((bw, frame indices) per
distinct width, in the order ``data`` concatenates them).
"""

from __future__ import annotations

import numpy as np

from ..kernels import ref     # attributes read at call time: ref imports core
from .bits import ebw_np, from_np, to_np
from .encoded import Encoded


def encode(x: np.ndarray) -> Encoded:
    x = np.asarray(x, dtype=np.uint32)
    n = len(x)
    if n == 0:
        return Encoded("bp_tpu", 0, np.zeros(0, np.uint8), np.zeros(0, np.uint32),
                       header_bits=32, meta={"bws": np.zeros(0, np.int32)})
    f = -(-n // ref.FRAME_INTS)
    xp = np.concatenate([x, np.zeros(f * ref.FRAME_INTS - n, np.uint32)])
    tiles = xp.reshape(f, ref.FRAME_ROWS, ref.LANES)
    # OR pseudo-max per frame (paper §4.4 on the tile)
    bws = np.maximum(ebw_np(np.bitwise_or.reduce(tiles.reshape(f, -1), axis=1)), 1)
    parts = []
    for bw in np.unique(bws):
        sel = np.flatnonzero(bws == bw)
        packed = ref.pack_frames_ref(
            from_np(tiles[sel].reshape(-1, ref.LANES)), int(bw))
        parts.append((int(bw), sel, to_np(packed)))
    data = np.concatenate([p[2].reshape(-1) for p in parts])
    return Encoded(
        "bp_tpu", n, bws.astype(np.uint8), data,
        control_bits=f * 8, data_bits=int((bws.astype(np.int64) * ref.FRAME_INTS).sum()),
        header_bits=32,
        meta={"bws": bws, "parts": [(p[0], p[1]) for p in parts]},
    )


def decode_np(enc: Encoded) -> np.ndarray:
    if enc.n == 0:
        return np.zeros(0, np.uint32)
    bws = enc.meta["bws"]
    f = len(bws)
    out = np.zeros((f, ref.FRAME_ROWS, ref.LANES), np.uint32)
    off = 0
    for bw, sel in enc.meta["parts"]:
        words = bw * ref.LANES * len(sel)
        packed = enc.data[off:off + words].reshape(-1, ref.LANES)
        off += words
        tiles = to_np(ref.unpack_frames_ref(from_np(packed), int(bw)))
        out[sel] = tiles.reshape(len(sel), ref.FRAME_ROWS, ref.LANES)
    return out.reshape(-1)[: enc.n]
