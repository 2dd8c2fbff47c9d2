"""Device µs a network-step of every kernel that is not B1, B2, the block
sum or NCCL's: the contractions, the loss, Adam and the step's copies; the
metrics' kernels once a chunk included.  NCCL's kernels spin while they
wait for the other ranks and are read by allreduce_us_per_step alone, so
each layer is counted once."""

from bench_port.metrics import fields_bwd_roofline, fields_fwd_roofline


def read(run):
    trace = run["trace"]
    if trace is None:
        return None
    ours = (fields_fwd_roofline.KERNELS, fields_bwd_roofline.KERNELS)
    us = sum(v[0] for k, v in trace["kernels"].items()
             if "nccl" not in k.lower() and not any(p.match(k) for p in ours))
    return us / (trace["steps"] * run["members"])
