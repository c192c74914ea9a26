"""Build the port's CUDA kernels with ``nvcc`` at first use and bind them
with ``ctypes``.

Every ``kernels/csrc/<name>.cu`` is compiled on its own into a shared library
with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \\
         -Xcompiler -fPIC -o build/repro_torch_kernels/<name>-<hash>.so <name>.cu

into ``build/repro_torch_kernels/`` at the repository root (``<hash>`` is the
source's content hash, so an edited source rebuilds and a stale library is
never loaded).  No source includes PyTorch's headers, which keeps a build at
seconds.  :func:`build` starts one ``nvcc`` per source, all at once.  Each C
entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises when that is not 0.  There is no
fallback: without ``nvcc``, or when a build fails, the caller gets an error.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
_fns: dict = {}


def build_dir() -> str:
    """``build/repro_torch_kernels`` under the repository root."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(CSRC)))   # .../src
    return os.path.join(os.path.dirname(src), "build", "repro_torch_kernels")


def sources() -> list:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(os.path.splitext(os.path.basename(p))[0]
                  for p in glob.glob(os.path.join(CSRC, "*.cu")))


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "CUDA kernels of repro_torch are built at first use")
    return path


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(build_dir(), f"{name}-{digest}.so")


def build(names=None, verbose: bool = False) -> dict:
    """Compile the named sources (default: all) that have no library yet,
    one ``nvcc`` process per source, all started together.  Returns
    {name: seconds spent compiling it} (0.0 where the library existed).
    Raises with the compiler's output when any build fails."""
    names = sources() if names is None else list(names)
    os.makedirs(build_dir(), exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[name] = (out, tmp, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    took = {name: 0.0 for name in names}
    failed = []
    for name, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode}):\n{log}")
            if os.path.exists(tmp):
                os.remove(tmp)
            continue
        os.replace(tmp, out)          # atomic: concurrent builds agree
        if verbose:
            print(f"[nvcc] {name}.cu built in {took[name]:.1f} s\n{log}",
                  flush=True)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return took


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(_lib_path(name))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
        return lib


def function(name: str, symbol: str, argtypes: list):
    """A C entry point of ``csrc/<name>.cu`` with its argument types set
    (``ctypes.c_void_p`` for pointers and the stream, ``c_longlong`` or
    ``c_int`` for sizes); it returns a ``cudaError_t`` as int."""
    key = (name, symbol)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def check(err: int, name: str, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err != 0:
        msg = library(name).repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(t) -> int:
    """The current CUDA stream of tensor ``t``'s device, as an int (the raw
    getter: no ``torch.cuda.Stream`` object is made, which saves host time
    on every launch)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(t.get_device())
