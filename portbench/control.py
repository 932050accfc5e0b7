"""The control and the lower readings that the check's limits are set from.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 ... --seconds 3 --out FILE

For each seed, in one process: one run of the cell (a short window at the
cell's own load and sizes), the program's readings against the reference,
and the control's: the reference itself, its family's forward's products in float8
e4m3 (the precision below the configuration's bfloat16), in the program's
place on the same snapshots. One JSON line a seed. The benchmark's own
runs (run.py) never run the control. Needs the card, as run.py does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("portbench control: no CUDA device", file=sys.stderr)
        return 2
    from portbench import harness

    with open(args.out, "a") as f:
        for seed in args.seeds:
            out = harness.run_cell(args.workload, seed, args.seconds, False, "cuda", time.perf_counter(), control=True)
            row = {"workload": args.workload, "seed": seed, "correct": out["correct"],
                   "program": {k: v["value"] for k, v in out["checks"].items()},
                   "control": out["control"], "compared": out["notes"]["compared"],
                   "largest_at": out["notes"]["largest_at"], "summary": out["notes"]["gaps_p50_p90_max"]}
            print(json.dumps(row), file=f, flush=True)
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
