"""Compressed data pipeline: the paper's codecs as a first-class storage layer.

Counterpart of the JAX package's ``data/pipeline.py``, over the port's codec
registry and ``core/dgap.py``.  The stores are host numpy, as in the
reference: they encode on build and decode on read on the host and return
numpy arrays; a caller moves a batch to its device.

Three integer-stream stores:
  * TokenStore    — LM token streams, blocked + Group-compressed; the loader
    decodes blocks on the fly.
  * AdjacencyStore — GNN CSR adjacency: per-row sorted column ids -> d-gap ->
    codec.  Reconstructing a row is decode + prefix-sum.
  * BagStore      — recsys multi-hot id bags: sorted ids per bag -> d-gap.

All stores report exact compressed/raw byte ratios.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import codec as codec_lib
from ..core.dgap import dgap_decode_np, dgap_encode_np


@dataclasses.dataclass
class TokenStore:
    codec: str
    block: int
    blocks: list
    n: int

    @staticmethod
    def build(tokens: np.ndarray, codec: str = "bp128", block: int = 65536) -> "TokenStore":
        spec = codec_lib.get(codec)
        tokens = np.asarray(tokens, np.uint32)
        blocks = [spec.encode(tokens[i:i + block]) for i in range(0, len(tokens), block)]
        return TokenStore(codec, block, blocks, len(tokens))

    def read(self, start: int, count: int) -> np.ndarray:
        spec = codec_lib.get(self.codec)
        b0, b1 = start // self.block, (start + count - 1) // self.block
        parts = [spec.decode(self.blocks[b]) for b in range(b0, b1 + 1)]
        flat = np.concatenate(parts)
        off = start - b0 * self.block
        return flat[off:off + count]

    def compressed_bytes(self) -> int:
        return sum(e.nbytes() for e in self.blocks)

    @property
    def raw_bytes(self) -> int:
        return self.n * 4


@dataclasses.dataclass
class AdjacencyStore:
    codec: str
    rows: list                    # Encoded per row (or raw for tiny rows)
    indptr: np.ndarray
    n_nodes: int
    n_edges: int

    @staticmethod
    def build(indptr: np.ndarray, indices: np.ndarray, codec: str = "group_pfd",
              min_compress: int = 64) -> "AdjacencyStore":
        spec = codec_lib.get(codec)
        vb = codec_lib.get("varbyte")
        rows = []
        for r in range(len(indptr) - 1):
            cols = np.sort(indices[indptr[r]:indptr[r + 1]]).astype(np.uint32)
            gaps = dgap_encode_np(cols)
            rows.append((spec if len(cols) >= min_compress else vb).encode(gaps))
        return AdjacencyStore(codec, rows, np.asarray(indptr), len(indptr) - 1, len(indices))

    def neighbors(self, r: int) -> np.ndarray:
        enc = self.rows[r]
        gaps = codec_lib.get(enc.codec).decode(enc)
        return dgap_decode_np(gaps)

    def compressed_bytes(self) -> int:
        return sum(e.nbytes() for e in self.rows)

    @property
    def raw_bytes(self) -> int:
        return self.n_edges * 4


@dataclasses.dataclass
class BagStore:
    codec: str
    bags: list
    n_ids: int

    @staticmethod
    def build(bags: list, codec: str = "group_scheme_8-IU") -> "BagStore":
        spec = codec_lib.get(codec)
        enc = []
        n = 0
        for b in bags:
            ids = np.sort(np.asarray(b, np.uint32))
            n += len(ids)
            enc.append(spec.encode(dgap_encode_np(ids)))
        return BagStore(codec, enc, n)

    def read(self, i: int) -> np.ndarray:
        enc = self.bags[i]
        return dgap_decode_np(codec_lib.get(enc.codec).decode(enc))

    def compressed_bytes(self) -> int:
        return sum(e.nbytes() for e in self.bags)

    @property
    def raw_bytes(self) -> int:
        return self.n_ids * 4


def lm_batch_iter(store: TokenStore, batch: int, seq: int):
    """Deterministic loader over a compressed token stream; the cursor is the
    checkpointable data position (a loader resumed at a cursor yields the
    same batches)."""
    per = batch * (seq + 1)

    def next_batch(cursor: int):
        start = (cursor * per) % max(store.n - per, 1)
        flat = store.read(start, per).astype(np.int64).reshape(batch, seq + 1)
        return {"tokens": flat[:, :-1].astype(np.int32),
                "labels": flat[:, 1:].astype(np.int32)}, cursor + 1

    return next_batch
