"""B1's share of its roofline: the fields' forward FLOPs and bytes of one
call (bench_port/work.py) against the larger of the card's two bounds,
over the device time of B1's kernels a call.  B1 runs once a network in
every step and once more in each chunk's metrics."""

import re

from bench_port import work

KERNELS = re.compile(r"(fused_fields_kernel|fused_fields_staged_kernel)(<|$)")


def read(run):
    trace = run["trace"]
    if trace is None:
        return None
    us = sum(v[0] for k, v in trace["kernels"].items() if KERNELS.match(k))
    if us <= 0:
        return None
    s = run["shapes"]
    calls = (trace["steps"] + trace["chunks"]) * run["members"]
    return 100.0 * work.bound_s(*work.fields_fwd(s["layers"], s["points"], s["n_dirs"], s["second"])) * calls / (us * 1e-6)
