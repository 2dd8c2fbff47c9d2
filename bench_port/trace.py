"""The device trace of a window: torch.profiler (CUPTI) over the window's
chunks, reduced to what the per-layer readers take.

The window is a `record_function` span around the chunks and the sync
after the last one.  Every device activity (kernels, copies, sets) inside
it counts as busy; the device's idle gaps are labelled by the innermost
host event that was running at each gap's middle.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

import torch

WINDOW = "bench_port.window"
TOP = 10


def profile():
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def window_span():
    return torch.profiler.record_function(WINDOW)


def short_name(name: str) -> str:
    """A kernel's function name and template arguments, without its
    parameter list and return type."""
    m = re.search(r"(\w+)(<[^()]*>)?\(", name)
    return ((m.group(1) + (m.group(2) or "")).replace(" ", "") if m else name)[:120]


def _merged(intervals):
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def reduce(prof) -> dict:
    """{"window_us", "busy_us", "busy_but_collectives_us", "kernels":
    {name: [device µs, count]}, "device_ops": [[name, s]], "idle_gaps":
    [[host event, s]]} of the profiled window; "busy_us" 0 where the trace
    holds no device activity.  A collective's kernel spins while it waits
    for the other ranks, so "busy_but_collectives_us" leaves NCCL's out."""
    events = prof.events()
    span = [e for e in events if e.name == WINDOW and e.device_type == torch.autograd.DeviceType.CPU]
    if len(span) != 1:
        raise RuntimeError(f"the trace holds {len(span)} window spans")
    w0, w1 = span[0].time_range.start, span[0].time_range.end
    device, host = [], []
    for e in events:
        if e.name == WINDOW or getattr(e, "is_user_annotation", False):
            continue
        start, end = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if end <= start:
            continue
        (device if e.device_type == torch.autograd.DeviceType.CUDA else host).append((start, end, e.name))
    kernels = defaultdict(lambda: [0.0, 0])
    for start, end, name in device:
        k = kernels[short_name(name)]
        k[0] += end - start
        k[1] += 1
    busy = _merged((s, e) for s, e, _ in device)
    computing = _merged((s, e) for s, e, name in device if "nccl" not in name.lower())
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    return {
        "window_us": w1 - w0,
        "busy_us": sum(e - s for s, e in busy),
        "busy_but_collectives_us": sum(e - s for s, e in computing),
        "kernels": dict(kernels),
        "device_ops": [[n, v[0] * 1e-6] for n, v in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]],
        "idle_gaps": _gap_labels(gaps, host),
    }


def _gap_labels(gaps, host) -> list:
    """The idle time by what the host was doing: each gap's length added to
    the innermost host event (the latest to start) covering its middle, the
    TOP largest sums as [[event name, s]]."""
    mids = sorted(((a + b) / 2, b - a) for a, b in gaps)
    keys = [m for m, _ in mids]
    owner = [None] * len(mids)  # (start, name) of the innermost covering event
    for start, end, name in host:
        for i in range(bisect.bisect_left(keys, start), bisect.bisect_right(keys, end)):
            if owner[i] is None or start > owner[i][0]:
                owner[i] = (start, name)
    sums = defaultdict(float)
    for (_, length), o in zip(mids, owner):
        sums["(no host event)" if o is None else o[1][:120]] += length * 1e-6
    return [[n, s] for n, s in sorted(sums.items(), key=lambda kv: -kv[1])[:TOP]]
