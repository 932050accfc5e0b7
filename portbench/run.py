"""Run one benchmark cell once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Exits with a code other than 0, printing no
result, when there is no CUDA card, fewer cards than the cell asks for, a
card that is not an H100, or no program to run (the package
``vitparticlefiltertracker_tpu_torch`` beside this folder), or when JAX or
the JAX package was loaded by the time the window closed. The compared
numbers and their limits are the last lines on standard error and the last
key of the result line.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "portbench_cache"


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().replace("\n", "; ")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # Every build and kernel cache in the checkout, at fixed paths.
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    sys.path.insert(0, str(ROOT))
    wl_path = ROOT / "portbench" / "workloads" / f"{args.workload}.json"
    if not wl_path.exists():
        print(f"portbench: no cell {args.workload!r} ({wl_path})", file=sys.stderr)
        return 2
    chips = json.loads(wl_path.read_text())["chips"]

    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs only on the card", file=sys.stderr)
        return 2
    if chips != 1:
        print(f"portbench: the cell asks for {chips} cards; this harness runs cells on one card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} cards, {torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    kind = torch.cuda.get_device_name(0)
    if "H100" not in kind:
        print(f"portbench: the cell is defined on an NVIDIA H100, this card is {kind!r}", file=sys.stderr)
        return 2
    try:
        import vitparticlefiltertracker_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program under test is missing: {e}", file=sys.stderr)
        return 3
    print(f"portbench: {args.workload} seed {args.seed} on {_power_limit()}, torch {torch.__version__}",
          file=sys.stderr)

    import faulthandler

    # A run that has not ended well inside the check's time limit prints
    # every thread's stack on standard error, once.
    faulthandler.dump_traceback_later(300, exit=False)

    from portbench import harness

    out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: loaded in the measured process: {bad}", file=sys.stderr)
        return 4
    print(json.dumps(out["notes"]), file=sys.stderr)
    for name, row in out["checks"].items():
        print(f"check {name}: {row['value']!r} (limit {row['limit']!r})", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
