"""Device µs a global step of NCCL's kernels on a rank, the mean over the
ranks: the all-reduce of the gradients inside the captured step and the
metrics' once a chunk.  A collective's kernel runs from its launch on this
rank until every rank has joined, so its time holds the wait for the
slowest rank as well as the exchange, and the profiler's slower launches
lengthen that wait."""


def read(run):
    trace = run["trace"]
    if trace is None:
        return None
    us = sum(v[0] for k, v in trace["kernels"].items() if "nccl" in k.lower())
    return us / trace["steps"] if us > 0 else None
