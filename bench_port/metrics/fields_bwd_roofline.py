"""B2's share of its roofline, with its block sum: the backward's own FLOPs
and bytes of one call (bench_port/work.py, no replayed forward) against the
larger of the card's two bounds, over the device time of B2's kernels (any
form) and the block sum a call.  They run once a network in every step."""

import re

from bench_port import work

KERNELS = re.compile(r"(fused_fields_bwd_kernel|fused_fields_bwd_firsts_kernel|bwd_layered_\w+|block_sum_kernel)(<|$)")


def read(run):
    trace = run["trace"]
    if trace is None:
        return None
    us = sum(v[0] for k, v in trace["kernels"].items() if KERNELS.match(k))
    if us <= 0:
        return None
    s = run["shapes"]
    calls = trace["steps"] * run["members"]
    return 100.0 * work.bound_s(*work.fields_bwd(s["layers"], s["points"], s["n_dirs"], s["second"])) * calls / (us * 1e-6)
