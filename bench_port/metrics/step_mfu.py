"""The whole training step's share of the card's fp32 peak: the model
FLOPs of a network-step (bench_port/work.py: the fields' forward and twice
that for the backward, nothing replayed) times the network-steps a second
of the run's timed window, over the peak of the cards in use.  Read in a
traced run, from its timed window, which runs before the profiler starts:
under the profiler each graph launch costs the host more."""

from bench_port import work


def read(run):
    if run["trace"] is None:
        return None
    s = run["shapes"]
    flops = work.step_flops(s["layers"], s["points"], s["n_dirs"], s["second"])
    return 100.0 * flops * run["net_steps"] / run["window_s"] / work.PEAK_FP32_FLOPS
