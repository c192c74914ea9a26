#!/usr/bin/env python3
"""Run a cell's control: the reference with the configuration's guarantee
broken, put in the program's place, and held to the cell's check.  It has
to come out as not correct.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \\
        --requests <n>

For each seed: the corpus where the configuration names one, the first
``n`` requests of the window's stream, what a run keeps of them for the
check (all of the first, a sample drawn from the seed of the rest), then
the traffic's check (``Driver.check`` in ``portbench/drivers/``) with the
control's outputs.  A driver with ``CONTROL_ON_SERVED`` has the program
serve those requests first: its control is read on the prompts and
tokens the program served.  Prints one JSON line a seed: the numbers
compared, their limits and whether the control failed them.  The
benchmark's own runs never run it.

The controls (``portbench/reference/``): of a Group-PFD decode, each gap
cut to the bit width 90 % of its frame of 128 fits (a frame of reference
with its exceptions left out); of a stream decode, each gap cut to one
bit less than its list's widest; both break losslessness.  Of an LM
decode, the reference with its weights rounded to float8_e4m3fn, a
precision below the configuration's bfloat16, on the served tokens.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control(cell, seed: int, n_requests: int, device) -> dict:
    """The control's numbers for one seed, and whether they fail."""
    from portbench import generator, harness
    corpus = harness.make_corpus(cell, seed)
    drv = cell.driver.Driver(cell.config, cell.traffic, device,
                             lambda msg: None, seed)
    stream = harness.requests(drv, seed, generator.WINDOW, cell)
    sample = generator.rng(seed, generator.SAMPLE)
    share = cell.traffic.get("check_share", 1.0)
    served = getattr(cell.driver, "CONTROL_ON_SERVED", False)
    if served:
        drv.setup(corpus)
    kept = []
    for i in range(n_requests):
        r = next(stream)
        outs = drv.serve(r) if served else [None] * len(r)
        kept += drv.keep(r, outs, sample, share, whole=i == 0)
    if served:
        drv.teardown()
    numbers = drv.check(corpus, kept, control=True)
    limits = cell.driver.LIMITS
    return {"seed": seed, "numbers": numbers, "limits": limits,
            "failed": any(numbers[k] > v for k, v in limits.items())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--requests", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    from portbench import harness
    cell = harness.resolve(args.workload)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else (
        torch.device("cpu"))
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = control(cell, seed, args.requests, device)
        out.update(workload=cell.name, device=str(device),
                   seconds=time.perf_counter() - t0)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
