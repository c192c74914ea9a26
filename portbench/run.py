#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on the card this machine has.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout of the repository.  The cell, its
configuration, traffic, driver and metrics are found by name from
``BENCHMARK.json`` (see ``portbench/harness.py``).  The program under test
is the PyTorch and CUDA port, ``src/repro_torch``; its kernels build into
``build/repro_torch_kernels`` inside the checkout on a first run.

Standard error carries progress and, as its last lines, each number the
check compared beside its limit.  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, then ``host`` (the host's
speed beside the run), ``card`` (name and power limit from nvidia-smi)
and ``checks`` last.  Exits 2 without a result where there is no card,
too few cards, or no program; 3 where a module of JAX or of the JAX
package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one process with few threads: the cells are host-bound, and the numeric
# libraries' worker threads would only contend with the one that dispatches
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"


def card_info() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def fail(msg: str, code: int) -> int:
        print(f"portbench: {msg}", file=sys.stderr, flush=True)
        return code

    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    # fixed cache directories inside the checkout, for any library that
    # compiles kernels (the port's own nvcc builds go to build/ as well)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                      "torch_extensions")
    from portbench import harness
    cell = harness.resolve(args.workload)
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        return fail("no program: src/repro_torch is not in this checkout", 2)
    import torch
    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: the benchmark "
                    "runs on the card", 2)
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{cell.name} needs {cell.chips} cards, "
                    f"{torch.cuda.device_count()} seen", 2)
    card = card_info()
    out = harness.run(cell, args.seed % 2**64, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    found = harness.forbidden_modules()
    if found:
        return fail(f"modules of JAX or the JAX package were loaded: "
                    f"{', '.join(found)}", 3)
    line, notes = result_line(out, card)
    print("\n".join(notes), file=sys.stderr, flush=True)
    print(line, flush=True)
    return 0


def result_line(out: dict, card: str) -> tuple:
    """(the result's JSON line, with ``card`` before ``checks``, which
    comes last; the lines for standard error that end it: ``correct``,
    then each number compared beside its limit)."""
    out = dict(out)
    checks = out.pop("checks")
    out["card"] = card
    out["checks"] = checks
    notes = [f"correct: {out['correct']}"]
    for name, c in checks.items():
        bound = (f"at most {c['at_most']}" if "at_most" in c
                 else f"at least {c['at_least']}")
        notes.append(f"check {name}: {c['value']} ({bound})")
    return json.dumps(out), notes


if __name__ == "__main__":
    sys.exit(main())
