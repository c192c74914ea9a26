"""The smoke's mesh phase alone (``chip_smoke.mesh_phase``), on every card
of the machine: one rank a card with 2 or more cards, else a world of 1.

  python3 tools/mesh_phase.py [--out FILE.json]

Prints the card's name and power limit, the phase's log and its figures
as one JSON line (also written to ``--out``).
"""

import argparse
import json
import os
import sys
import time

if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, os.path.join(root, "src"))
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    if not torch.cuda.is_available():
        sys.exit("needs a card: torch.cuda.is_available() is False")
    smi = cs.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"])
    print(smi, flush=True)
    print("torch", torch.__version__, "cuda", torch.version.cuda, "python",
          sys.version.split()[0], "cards", torch.cuda.device_count(), flush=True)
    t0 = time.perf_counter()
    res = cs.mesh_phase(args.seed, smi, np, torch)
    res["phase_s"] = time.perf_counter() - t0
    res["card"] = smi
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f)
