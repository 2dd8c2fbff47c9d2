"""The share of the timed window in which the card computed nothing:
1 - (the device's busy time a step) x (the timed window's steps a second).
The busy time a step is the union of the device's activity intervals in
the traced window, NCCL's kernels left out (they spin while they wait for
the other ranks: bench_port/metrics/allreduce_us_per_step.py reads them),
over that window's steps.  The step rate is the timed window's, since the
profiler slows each graph launch on the host and so idles the device more
than an untraced run does."""


def read(run):
    trace = run["trace"]
    if trace is None:
        return None
    busy_s_a_step = trace["busy_but_collectives_us"] * 1e-6 / trace["steps"]
    return 100.0 * (1.0 - busy_s_a_step * run["steps"] / run["window_s"])
