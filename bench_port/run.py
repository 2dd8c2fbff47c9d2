"""Run one cell of the benchmark once and print its result as the last line
of standard output.

    python3 bench_port/run.py --workload p2d_scaled.pallas --seed 7 --seconds 10 --trace 0

from the root of a checkout.  --trace 0 reports the cell's end-to-end
metrics, --trace 1 its per-layer metrics from a device trace of a shorter
window.  It needs as many CUDA cards as the cell's chips; with fewer it
exits with code 2 and prints no result.  The numbers that decide `correct`
are printed beside their limits as the last lines of standard error.
"""

from __future__ import annotations

import time

T0 = time.monotonic()  # the start of set-up: before torch and the program are imported

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def power_limit() -> str:
    """The cards' names and power limits as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"not read: {err}"
    return "; ".join(sorted(set(out.stdout.strip().splitlines()))) or f"not read: {out.stderr.strip()}"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from bench_port import cell as cells

    cell = cells.load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell['chips']} CUDA cards; this machine has {count}", file=sys.stderr)
        return 2
    seed = args.seed % 2**63
    runs = cells.execute(cell, seed, args.seconds, bool(args.trace), T0)
    result, lines = cells.summarize(cell, runs, bool(args.trace))
    result["device"]["power_limit"] = power_limit()
    found = sorted(set(cells.banned_modules()).union(*(r["banned"] for r in runs)))
    if found:
        print(f"the run loaded {found}: the benchmark measures the PyTorch port alone", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
