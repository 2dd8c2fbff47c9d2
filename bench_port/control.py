"""The readings that a cell's limits (bench_port/workloads/<cell>.json) are
set from, beside the program's own, on the chip.  For each seed, compared
with the float64 reference as a run compares the program:

  control      the reference in the program's place, computed in TF32
               (float32 tensors, TF32 products), the precision below the
               configuration's float32
  half_batch   the reference in the program's place in float32, its
               weak-form loss over half the elements, doubled
  --fault F    the program itself with fault F of bench_port/faults.py
               planted, run as the benchmark runs it (a short window)

    python3 bench_port/control.py --workload p2d_scaled.pallas --seeds 11 12 13 [--fault no_exchange]

The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench_port import cell as cells  # noqa: E402
from bench_port import check, faults  # noqa: E402


def in_place(cell: dict, seed: int, device, tf32: bool, half: bool) -> dict:
    """The numbers of the reference in the program's place (float32, TF32
    products where `tf32`, the half-batch fault where `half`) against the
    float64 reference, from the seed's weights and inputs."""
    fields, members = cell["config"]["program"]["fields"], cell["traffic"]["members"]
    given = cells.reference_module(cell).inputs(fields, np.random.default_rng(seed))
    w_host = [(W.double().cpu(), b.double().cpu()) for W, b in cells.weights(fields["layers"], members, seed, device)]
    expected = cells.reference_readings(cell, w_host, given, device)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        got = cells.reference_readings(cell, w_host, given, device, dtype=torch.float32, half=half)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    return check.worst(list(zip(got, expected)))


def with_fault(cell: dict, seed: int, fault: str, seconds: float = 1.0) -> dict:
    """The numbers of the program run with `fault` planted."""
    t0 = time.monotonic()
    if cell["traffic"]["ranks"] > 1:
        runs = cells.execute(cell, seed, seconds, False, t0, target=functools.partial(faults.rank_with, fault))
    else:
        with faults.FAULTS[fault]():
            runs = cells.execute(cell, seed, seconds, False, t0)
    return cells.summarize(cell, runs, False)[0]["checks"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = parser.parse_args(argv)
    cell = cells.load(args.workload)
    if not torch.cuda.is_available():
        print("control.py reads the control on a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        row = {"workload": args.workload, "seed": seed,
               "control": in_place(cell, seed, device, tf32=True, half=False),
               "half_batch": in_place(cell, seed, device, tf32=False, half=True)}
        if args.fault:
            row[args.fault] = with_fault(cell, seed, args.fault)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
