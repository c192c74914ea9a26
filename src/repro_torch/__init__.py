"""PyTorch/CUDA port of the ``repro`` package: the compressed inverted index
and its device-resident AND serving path on an NVIDIA Hopper GPU.

The layout mirrors ``repro`` module for module (``repro_torch/x/y.py`` is the
counterpart of ``repro/x/y.py``).  The package imports torch and numpy only:
never jax, and nothing of ``repro``.  Plain tensor code is torch; every
Pallas kernel on the ported path is a CUDA C++ kernel for ``sm_90a`` under
``kernels/csrc``, built with ``nvcc`` at first use.  Entry points run on the
card unless the caller asks for the CPU.
"""
