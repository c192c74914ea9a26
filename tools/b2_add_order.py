#!/usr/bin/env python3
"""Time thread mappings of kernel B2's add form on one NVIDIA GPU.

The port's kernel (``repro_torch.kernels.accumulate.scatter_add``: one
block per 256 consecutive lanes of one entry, a lane a thread) against the
mappings of ``tools/b2_add_order.cu``, which compute the same function and
differ only in which thread issues which atomic: one thread per lane from a
flat index with a 64-bit division a lane (the form the port's kernel
replaced), one warp per entry with uint4 loads, and one warp per 128 lanes
with uint4 loads handed across through shared memory.  Inputs: the
ranked accumulator of 256 queries at GOV2's 25,205,179 docs (256 x
25,206,784 words), P entries of 512 lanes sorted by query, non-zero u8
contributions, and five id patterns per query: spread evenly over the row
(as ``chip_smoke.py``'s synthetic ranked case), and 1, 8, 16 and 32 words
apart.  Every mapping's accumulator is checked equal to the port's on the
spread pattern.  Then the port's masked entry point
(``scatter_add_masked``) and the last mapping with the same mask, on the
spread pattern, with every lane alive and with 0.5 % alive (about an
``and_scored`` round's share).  Prints one line a case (each mapping's
least and largest of two medians, each the median CUDA-event ms of 10
calls queued behind a spin of the card), the card's name and power limit,
and a JSON line.  Usage::

    python3 tools/b2_add_order.py [--entries 187481] [--seed 0]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {"flat_div64": 0, "warp_uint4": 1, "warp128_uint4_shared": 2}
QUERIES, WIDTH, LANES = 256, 25_206_784, 512
RUNS = 10


def build() -> ctypes.CDLL:
    """Compile ``tools/b2_add_order.cu`` with the port's nvcc and flags into
    ``build/b2_add_order/``."""
    from repro_torch.kernels import cuda_build
    out = os.path.join(ROOT, "build", "b2_add_order")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "b2_add_order.so")
    proc = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                           so, os.path.join(ROOT, "tools", "b2_add_order.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(so)
    lib.b2_add_variant.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                                   + [ctypes.c_longlong] * 4
                                   + [ctypes.c_void_p])
    lib.b2_add_variant.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--entries", type=int, default=187_481)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this tool times kernels on the card")
        return 2
    from repro_torch.kernels import accumulate

    lib = build()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    p = args.entries
    qslot = torch.sort(torch.randint(0, QUERIES, (p,), generator=gen,
                                     device=dev)).values.to(torch.int32)
    rank = torch.arange(p, device=dev) - torch.searchsorted(qslot, qslot)
    n_max = int(torch.bincount(qslot.long(), minlength=QUERIES).max())
    pos = rank[:, None] * LANES + torch.arange(LANES, device=dev)
    step = max(1, WIDTH // (n_max * LANES))
    offset = (qslot.long()[:, None] * 7919) % step
    patterns = {f"spread {step}": (pos * step + offset) % WIDTH,
                **{f"{k} apart": pos * k % WIDTH for k in (1, 8, 16, 32)}}
    contrib = torch.randint(1, 256, (p, LANES), generator=gen, device=dev,
                            dtype=torch.int32)
    alive = torch.ones((p, LANES), dtype=torch.bool, device=dev)
    acc = torch.zeros((QUERIES, WIDTH), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def runner(name, ids, mask=None):
        if name == "port":
            if mask is None:
                return lambda: accumulate.scatter_add(acc, ids, qslot, contrib)
            return lambda: accumulate.scatter_add_masked(acc, ids, qslot,
                                                         contrib, mask)

        def call():
            err = lib.b2_add_variant(
                VARIANTS[name], acc.data_ptr(), ids.data_ptr(),
                qslot.data_ptr(), contrib.data_ptr(),
                None if mask is None else mask.data_ptr(), p, LANES, QUERIES,
                WIDTH, stream)
            if err:
                raise RuntimeError(f"{name}: CUDA error {err}")
        return call

    def ms(fn):
        fn()
        fn()
        times = []
        for _ in range(RUNS):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(2_000_000)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return sorted(times)[RUNS // 2]

    names = ["port", *VARIANTS]
    spread = patterns[f"spread {step}"].to(torch.int32)
    sparse = torch.rand((p, LANES), generator=gen, device=dev) < 0.005
    runner("port", spread)()
    want = acc.clone()
    for name in names[1:]:
        acc.zero_()
        runner(name, spread)()
        if not torch.equal(acc, want):
            raise AssertionError(f"{name} differs from the port's kernel")
    masked = ["port", "warp128_uint4_shared"]
    for mask in (alive, sparse):
        want.zero_()
        accumulate.scatter_add(want, spread, qslot,
                               torch.where(mask, contrib, 0))
        for name in masked:
            acc.zero_()
            runner(name, spread, mask)()
            if not torch.equal(acc, want):
                raise AssertionError(f"{name} masked differs")
    del want
    result = {}
    suites = [(pat, ids.to(torch.int32), None, names)
              for pat, ids in patterns.items()]
    suites += [(f"spread {step}, masked, {what}", spread, mask, masked)
               for what, mask in (("all alive", alive),
                                  ("0.5 % alive", sparse))]
    for label, ids, mask, who in suites:
        got = {}
        for name in who + who[::-1]:          # each mapping twice, in turn
            got.setdefault(name, []).append(ms(runner(name, ids, mask)))
        result[label] = {n: sorted(v) for n, v in got.items()}
        print(f"{label}: " + "  ".join(f"{n} {min(v):.4f}/{max(v):.4f}"
                                       for n, v in got.items()), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    print(json.dumps({"entries": p, "lanes": LANES, "queries": QUERIES,
                      "width": WIDTH, "n_max": n_max, "card": smi,
                      "ms": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
