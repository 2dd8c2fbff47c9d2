"""Tracing and timing utilities.

Counterpart of hpvpinns_tpu/utils/profiling.py:

  * `trace(logdir)`: a context manager around torch.profiler that writes a
    TensorBoard/Perfetto-loadable trace of the host and, on the card, the
    device;
  * `time_fn`: steady-state timing of any callable, after a warm-up, with a
    device sync after each call where CUDA is in use (none on the CPU);
  * `device_memory_stats`: the CUDA caching allocator's counters.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a profile into `logdir` (view with TensorBoard or Perfetto);
    yields the torch.profiler.profile object."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)
    ) as prof:
        yield prof


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, iters: int = 100, warmup: int = 5) -> dict:
    """Steady-state timing of `fn(*args)`, each call ended by a device sync
    when CUDA is in use (the host clock then spans the device's work).

    Returns {'mean_s', 'p50_s', 'best_s', 'iters_per_sec'}.
    """
    for _ in range(warmup):
        fn(*args)
    _sync()

    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    mean = sum(times) / len(times)
    return {
        "mean_s": mean,
        "p50_s": times[len(times) // 2],
        "best_s": times[0],
        "iters_per_sec": 1.0 / mean,
    }


def device_memory_stats() -> dict:
    """The caching allocator's counters on the current CUDA device
    (torch.cuda.memory_stats: allocated, reserved, peak bytes, ...); {} with
    no CUDA device."""
    return dict(torch.cuda.memory_stats()) if torch.cuda.is_available() else {}
