"""Compressed inverted index + batched AND serving (counterpart of the JAX
package's ``index``).

  * ``invindex``: per-term blocked storage, d-gapped docids + TFs compressed
    through the codec registry; ``InvertedIndex.from_state`` serves an index
    exported from plain numpy arrays.
  * ``segments``: the delta segment and tombstones of the mutable handle.
  * ``device``: device-resident posting arenas (torch tensors) and the fused
    tile arenas the CUDA kernels read.
  * ``engine``: ``plan``/``execute`` of AND batches on the host, device and
    fused placements.
  * ``scores``: the BM25 formula the index build needs.
"""
