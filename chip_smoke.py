#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py [--bwd-only [UNTILED_BWD_SOURCE] | --fwd-only [EARLIER_FWD_SOURCE] | --quality SEED...
                           | --advdiff-only | --advdiff-quality SEED...]

Run from the root of the repository.  It imports `hpvpinns_tpu_torch` (never
JAX or `hpvpinns_tpu`), builds the fused field kernel csrc/fused_fields.cu
(B1) and the backward kernels csrc/fused_fields_bwd.cu (B2 and its block
sum) with nvcc for sm_90a, and then, one line per phase:

  1. prints the card (nvidia-smi name and power limit), torch/CUDA versions
     and both TF32 flags;
  2. builds both libraries (one nvcc each, started together) and prints the
     build seconds and ptxas's report;
  3. holds B1 against its plain PyTorch version on the card, at the first
     slice's shapes, at ragged sin shapes with second derivatives and at the
     second-derivative shapes phases 8-10 train on (rtol 2e-5, atol 1e-6),
     at four shapes above width 64, which take the staged form (rtol 5e-5,
     atol 2e-6: sums of up to 256 terms in another order than cuBLAS's),
     and the firsts-only gradient against autograd through the plain
     version (rtol 2e-4, atol 1e-5; 5e-4, 1e-4 above width 64); checks
     ops/fused_fields.py::fwd_plan against the kernel's own shared-memory
     count and, up to width 64, the staged form forced on the same inputs
     bit for bit against the resident one; times both: ms per call over 50
     back-to-back calls (CUDA events; at these sizes the host's launch rate
     bounds it), device µs per call (torch.profiler, the kernels' own
     time), and B1's C function alone, arguments prepared once, by
     torch.profiler, by CUDA events over 50 launches from the host, and by
     replaying a CUDA graph of 50 launches (the device's own rate: the host
     takes longer to launch B1 than the card to run it);
  4. builds poisson2d_scaled twice, deriv_mode "taylor" and "pallas", and
     checks the loss (rtol 1e-5) and gradients (rtol 1e-3, atol 1e-4) agree;
  5. the main path, the trainer's Adam chunk as CUDA graphs: at
     poisson2d_scaled var_form 1 and 0 and poisson1d_of_record under
     "pallas", one chunk of check_every steps captured (_build_chunk) and
     eager (_build_stepwise_chunk) from the same params with the same
     capturable Adam must agree bit for bit (else within 1e-6 relative,
     printed), and the path's kernels must be nodes of the captured step
     (B1; B2 and the block sum where second derivatives run), counted by
     name in the graph's DOT dump; then poisson2d_scaled trains 200 steps
     through `train` (the loss must fall; the wrappers count their host
     launches, the warm-up and capture, since the steps replay the graph);
  6. trains poisson2d_quality ("taylor" and "pallas"), poisson1d_quality
     ("pallas") at their full schedules and poisson2d_quality(hard_bc=True)
     (the lifted ansatz on the JVP engine; its L-BFGS cut from 20k to 5k
     iterations), Adam then L-BFGS,
     and prints the rel-L2 error against its target and the JAX package's
     row, the final loss, each phase's wall seconds and the L-BFGS closure
     evaluations per iteration; the L-BFGS loss must not rise from one
     record to the next;
  7. holds B2 + block sum against its plain version (autograd through the
     plain forward) at the slice's shapes (advdiff_of_record's among them): gW, gb and gX within rtol 2e-4 /
     atol 1e-5 (5e-4 / 1e-4 at width 48), two runs bit-identical, B2's
     launch shape against ops/fused_fields.py::bwd_plan, and the block sum
     against torch's column sum, both on B2's partials and on partials of
     the shape B2 wrote before its redesign (one row per 16 points,
     n_params wide); times B2, the block sum, both together and the plain
     version as phase 3 does, and B2 and the block sum alone by CUDA events
     over 50 launches of their C functions, arguments prepared once; and
     the block sum on two streams at once (each launch has its own tickets)
     bit for bit against one stream;
  8. checks the loss (rtol 1e-5) and gradients (rtol 1e-3, atol 1e-4) under
     "taylor" and "pallas" for poisson1d_of_record forms 1/2/3 and
     poisson2d_quality forms 0 and "2c";
  9. trains poisson1d_of_record under "pallas" for its 1,001 Adam steps (the
     second slice's main path): the loss must fall, B1, B2 and the block sum
     must each launch (the warm-up and capture of the graphs the steps
     replay), and the rel-L2 error must be within 20% of the JAX package's
     f32 row, 0.2539;
 10. profiles the step under "taylor" and "pallas" at poisson1d_of_record,
     poisson2d_scaled var_form 0 and var_form 1 and advdiff_of_record: steps/s of 200 Adam steps
     a turn, in chunks of 10, in turns eager, graph, graph, eager; the
     captured step's nodes; its device µs per step and busy share
     (torch.profiler over 20 replayed steps); and for the eager step the
     median forward, backward and Adam ms of 50 steps, each part followed
     by a device sync, and from torch.profiler over 20 steps the kernels'
     device µs, kernel launches, busy share and five largest kernels.  On
     poisson2d_scaled var_form 0 and advdiff_of_record under "pallas" B1,
     B2 and the block sum must be in the captured step;
 11. builds poisson2d_scaled with the (2, 256, 256, 256, 1) network, checks
     the loss (rtol 1e-5) and gradients (rtol 1e-3, atol 1e-4) under "taylor"
     and "pallas", trains it 50 steps through `train` under "pallas" (the
     loss must fall; B1's staged form must be in the captured step), and
     times 50 Adam steps a turn in turns eager, graph, graph, eager under
     both modes;
 12. AdvDiff identification (phase12): loss and gradients, eps's included,
     under "taylor", "pallas" and "jvp" at advdiff_of_record forms 0/1/2 and
     with a quadratic eps and a linear V (loss rtol 1e-5, gradients rtol
     1e-3 / atol 1e-4), "pallas" in float64 raising; one chunk as graphs
     against the eager chunk bit for bit under "pallas" at form 0 (B1, B2
     and the block sum in the captured step) and under the hard-BC ansatz
     ("jvp"); advdiff_of_record's 1,501 Adam steps under "taylor" and
     "pallas" (eps must close at least 75% of its distance to the truth;
     eps and rel-L2 beside the JAX package's f32 row); the advdiff_lbfgs
     schedule (f32 "pallas") and advdiff_quality (f64 "taylor"), eps's
     relative error against its target and the JAX row.

With --advdiff-only it runs phases 1, 2 and 12 and prints no summary; with
--advdiff-quality SEED... phases 1 and 2, then phase 12's (d) and (e) once
for each seed given in place of the presets' (the spread of eps's error
over seeds; the seed also draws the data), and no summary.
With --quality SEED... it runs phases 1 and 2, then phase 6's
poisson2d_quality under "taylor" and "pallas" and with hard BC ("jvp", its
whole 20k L-BFGS) once for each seed given in place of the preset's (the
spread of rel-L2 over seeds), and prints no summary.
With --fwd-only it runs phases 1, 2 and 3 and prints no summary; given also
the path of an earlier csrc/fused_fields.cu whose C function takes the
network packed into one buffer (from a `git archive` of the commit before
B1's redesign), phase 3 holds this B1 bit for bit against it at every shape
of width up to 64 and times the two in turns.
With --bwd-only it runs phases 1, 2 and 7 and prints no summary; given
also the path of an earlier csrc/fused_fields_bwd.cu whose B2 has no tiles
argument (from a `git archive` of the commit before the tiled B2), phase 7
holds this B2 at one tile per block bit for bit against it on the same
inputs and times the two in turns.  The
tolerances are those of tests/test_pallas_fields.py.  It exits non-zero
at the first failure, and when no CUDA device is present.  Its last three
lines are the whole run's seconds, a JSON summary of the kernels and
`{"ok": true, "device": ...}`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

FIELD_TOL = dict(rtol=2e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=1e-5)
WIDE_GRAD_TOL = dict(rtol=5e-4, atol=1e-4)  # width 48 and above (tests/test_pallas_fields.py:132-147)
# Above width 64 a sum has up to 256 terms, added in input order here and in
# cuBLAS's blocked order in the plain version; the second-derivative streams
# cancel, so the difference shows against the result's size.
WIDE_FIELD_TOL = dict(rtol=5e-5, atol=2e-6)
SUM_TOL = dict(rtol=1e-5, atol=1e-6)
TIMED_CALLS = 50
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet (at 700 W)
FP32_FLOPS = 67e12  # fp32 outside the tensor cores, same source
JAX_P1D_RECORD_REL_L2 = 0.2539  # benchmarks/ACCURACY.json:3-11, JAX f32, 1,001 steps
BWD_CASES = [  # (name, layers, activation, P, n_dirs): the second slice's shapes
    ("p1d_record", (1, 20, 20, 20, 20, 1), "sin", 80, 1),
    ("p1d_quality", (1, 30, 30, 30, 1), "sin", 240, 1),
    ("p2d_scaled", (2, 20, 20, 20, 1), "tanh", 16384, 2),
    ("p2d_quality", (2, 48, 48, 48, 48, 1), "tanh", 4096, 2),
    ("ragged", (3, 48, 48, 48, 1), "sin", 1003, 3),
    ("advdiff_record", (2, 5, 5, 5, 1), "tanh", 100, 2),
]


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> float:
    """Max abs error; fail unless |got - want| <= atol + rtol |want| everywhere
    and both are finite."""
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        fail(f"{name}: non-finite values")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        fail(f"{name}: {int(bad.sum())} entries outside rtol {rtol} atol {atol}; max abs err {err.max().item():.3e}")
    return err.max().item()


def cuda_ms(fn) -> float:
    """Mean ms per call of TIMED_CALLS back-to-back calls (CUDA events), after
    a warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMED_CALLS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / TIMED_CALLS


def device_us(fn) -> float | None:
    """Mean device time per call (µs) of the kernels `fn` launches, summed
    from a torch.profiler trace of TIMED_CALLS calls; None when the profiler
    records no device activity."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(TIMED_CALLS):
            fn()
        torch.cuda.synchronize()
    total = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    return total / TIMED_CALLS if total > 0 else None


def graph_us(prepare) -> float:
    """µs per launch of TIMED_CALLS launches captured into one CUDA graph and
    replayed: the device's own rate, also where a launch from the host takes
    longer than the kernel.  `prepare()` returns the launch function, bound
    to the stream that is current when it is called."""
    prepare()()  # outside the capture: opts in to the shared memory
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        launch = prepare()
        for _ in range(TIMED_CALLS):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return 1e3 * start.elapsed_time(end) / TIMED_CALLS


def part_times(problem, params, opt, n: int = 50):
    """Median (forward, backward, Adam) ms of n training steps, each part
    followed by a device sync (host clock)."""
    parts = []
    for _ in range(n):
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss, _ = problem.loss_fn(params, problem.data)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        opt.step()
        torch.cuda.synchronize()
        parts.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3, (time.perf_counter() - t2) * 1e3))
    return [statistics.median(p[i] for p in parts) for i in range(3)]


def step_profile(problem, params, opt, n: int = 20):
    """Per training step, from a torch.profiler trace of n steps: the kernels'
    device µs, the kernel-launch API calls, the busy share (device time over
    the window's wall time) and the five largest kernels' µs."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            opt.zero_grad(set_to_none=True)
            loss, _ = problem.loss_fn(params, problem.data)
            loss.backward()
            opt.step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    kernels = [  # a user annotation (Optimizer.step#...) spans kernels it does not add to
        e for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
        and not getattr(e, "is_user_annotation", False)
    ]
    total = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return {
        "device_us": total / n,
        "launches": sum(e.count for e in events if "LaunchKernel" in e.key) / n,
        "busy": total / wall_us,
        "top": [(e.key[:60], e.self_device_time_total / n) for e in top],
    }


def bound_ms(n_bytes: float, flops: float):
    """(least ms, what bounds it): bytes over HBM bandwidth vs fp32 FLOPs
    over the non-tensor-core peak."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


KERNEL_NODES = {  # each wrapper's CUDA kernels, by the names in their graph nodes
    "fused_fields": ("fused_fields_kernel", "fused_fields_staged_kernel"),
    "fused_fields_bwd": ("fused_fields_bwd_kernel",),
    "block_sum": ("block_sum_kernel",),
}
GRAPH_DUMPS = "hpvpinns_tpu_torch/_build/graphs"


def graph_nodes(graph, name: str) -> dict:
    """Nodes of a CUDA graph captured in debug mode, from its DOT dump: all
    nodes, kernel nodes, and the kernel nodes of each wrapper of
    KERNEL_NODES."""
    import os
    import re

    os.makedirs(GRAPH_DUMPS, exist_ok=True)
    path = os.path.join(GRAPH_DUMPS, f"{name}.dot")
    graph.debug_dump(path)
    with open(path) as f:
        # a node is defined at the start of a line; an edge line goes on with "->"
        nodes = re.findall(r'^\s*"graph_\d+_node_\d+"\s*\[(.*?)\];?\s*$', f.read(), re.S | re.M)
    kernels = [n for n in nodes if "KERNEL" in n]
    out = {"nodes": len(nodes), "kernels": len(kernels)}
    for wrapper, names in KERNEL_NODES.items():
        out[wrapper] = sum(any(k in n for k in names) for n in kernels)
    return out


def zero_counts():
    from hpvpinns_tpu_torch.ops.fused_fields import block_sum_kernel, fused_fields_bwd_kernel, fused_fields_kernel

    for k in (fused_fields_kernel, fused_fields_bwd_kernel, block_sum_kernel):
        k.launches = 0


def read_counts() -> dict:
    from hpvpinns_tpu_torch.ops.fused_fields import block_sum_kernel, fused_fields_bwd_kernel, fused_fields_kernel

    return {"fused_fields": fused_fields_kernel.launches, "fused_fields_bwd": fused_fields_bwd_kernel.launches,
            "block_sum": block_sum_kernel.launches}


def fresh_state(prob, cfg):
    """The problem's initial params (seeded) as trainable copies, and a
    fresh optimizer over them (capturable on the card)."""
    from hpvpinns_tpu_torch.training.trainer import _copy_params, make_optimizer

    prm = _copy_params(prob.init_params(torch.Generator().manual_seed(cfg.train.seed)), as_parameters=True)
    return prm, make_optimizer(cfg.train, prm)


def chunk_rates(prob, cfg, steps: int, chunk: int = 10):
    """Adam steps/s of `steps` steps a turn, in chunks of `chunk`, each ended
    by a device sync (utils/profiling.py::time_fn), in turns eager, graph,
    graph, eager from the same initial params: ({"eager": [..],
    "graph": [..]}, the last graph chunk, its params).  The capture is
    outside the timed window, as the first chunk is in train's steps/s."""
    from functools import partial

    from hpvpinns_tpu_torch.training.trainer import _build_chunk, _build_stepwise_chunk
    from hpvpinns_tpu_torch.utils.profiling import time_fn

    rates, last = {"eager": [], "graph": []}, None
    for kind in ("eager", "graph", "graph", "eager"):
        prm, opt = fresh_state(prob, cfg)
        build = partial(_build_chunk, debug=True) if kind == "graph" else _build_stepwise_chunk
        ch = build(prob.loss_fn, opt, prm, prob.data)
        t = time_fn(ch, chunk, iters=steps // chunk, warmup=1)
        rates[kind].append(chunk * t["iters_per_sec"])
        if kind == "graph":
            last = (ch, prm)
    return rates, last


def graph_profile(ch, n_chunks: int = 2, chunk: int = 10):
    """Per Adam step of a graph chunk, from torch.profiler over n_chunks
    chunks (replays): device µs of the kernels and the busy share (their
    device time over the window's wall time); None where the profiler
    records no device activity."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            ch(chunk)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False))
    steps = n_chunks * chunk
    return (total / steps, total / wall_us) if total > 0 else (None, None)


def fwd_work(layers, P, n_dirs, second):
    """(bytes, FLOPs) B1 must move and do: X, the network and the fields
    once; 2 FLOPs per multiply-add of every stream through every layer
    (activations not counted)."""
    S = 1 + n_dirs * (2 if second else 1)
    n_params = sum(a * b + b for a, b in zip(layers[:-1], layers[1:]))
    macs = sum(a * b for a, b in zip(layers[:-1], layers[1:]))
    return 4 * (P * layers[0] + n_params + P * S), 2 * P * S * macs


def bwd_work(layers, P, n_dirs):
    """(bytes, FLOPs) of the second-derivative backward: X, g and the network
    read once, gX and the gradients written once; the replayed forward of the
    hidden layers, gW (the input layer's h_kk streams are zero) and gh (the
    value stream only below the input layer)."""
    S = 1 + 2 * n_dirs
    pairs = [a * b for a, b in zip(layers[:-1], layers[1:])]
    n_params = sum(a * b + b for a, b in zip(layers[:-1], layers[1:]))
    macs = S * sum(pairs[:-1]) + (1 + n_dirs) * pairs[0] + S * sum(pairs[1:]) + S * sum(pairs[1:]) + pairs[0]
    return 4 * (2 * P * layers[0] + P * S + 2 * n_params), 2 * P * macs


def random_net(spec, rng, dev):
    """Xavier-scaled normal weights and 0.1-scaled normal biases, from numpy."""
    from torch import nn

    return [
        {"W": nn.Parameter(torch.as_tensor(rng.standard_normal((a, b)) * math.sqrt(2.0 / (a + b)), dtype=torch.float32, device=dev)),
         "b": nn.Parameter(torch.as_tensor(0.1 * rng.standard_normal(b), dtype=torch.float32, device=dev))}
        for a, b in zip(spec.layers[:-1], spec.layers[1:])
    ]


def load_untiled_bwd(src: str):
    """Build `src`, an earlier fused_fields_bwd.cu whose B2 takes no tiles
    argument and writes partials [ceil(P / 16), n_params], under another
    library name, and return its launch function."""
    import ctypes

    from hpvpinns_tpu_torch.ops.cuda_build import build_library

    fn = build_library("fused_fields_bwd_untiled", [src]).lib.hp_fused_fields_bwd_f32
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes, fn.restype = [vp, vp, vp, vp, i32, i32, i32, i32, vp, vp, i32, vp], i32
    return fn


def against_untiled(fn, name, spec, net, X, g, nd):
    """The earlier, untiled B2 (`fn`) and this one on the same inputs: bit
    for bit at one tile per block (partials and gX), and both timed alone,
    C function by C function, in turns earlier, this, this, earlier (CUDA
    events) and by torch.profiler."""
    from hpvpinns_tpu_torch.ops.fused_fields import _ACTIVATION_CODE, fused_fields_bwd_kernel, pack_params

    P = X.shape[0]
    packed, widths = pack_params(spec, net)
    n = packed.numel()
    p_old, x_old = torch.empty(((P + 15) // 16, n), device=X.device), torch.empty_like(X)
    args = (X.data_ptr(), g.data_ptr(), packed.data_ptr(), widths.ctypes.data, spec.n_layers, P, nd,
            _ACTIVATION_CODE[spec.activation], p_old.data_ptr(), x_old.data_ptr(), X.device.index or 0,
            torch.cuda.current_stream(X.device).cuda_stream)

    def old():
        if fn(*args) != 0:
            fail(f"{name}: the earlier B2 did not launch")

    (a1, *k1), p1, x1 = fused_fields_bwd_kernel.prepare(spec, net, X, g, nd, tiles_per_block=1)
    (a, *k), _, _ = fused_fields_bwd_kernel.prepare(spec, net, X, g, nd)
    old()
    fused_fields_bwd_kernel.launch(*a1)
    torch.cuda.synchronize()
    same = torch.equal(x_old, x1) and torch.equal(p_old, p1[:, :n]) and bool((p1[:, n:] == 0).all())
    if not same:
        fail(f"{name}: B2 at one tile per block differs from the earlier B2")
    new = lambda: fused_fields_bwd_kernel.launch(*a)
    ev = [1e3 * cuda_ms(f) for f in (old, new, new, old)]
    dev_old, dev_new = device_us(old), device_us(new)
    print(f"phase 7 {name} against the earlier B2: one tile per block bit-identical; us/launch (CUDA events, "
          f"turns earlier, this, this, earlier) {ev[0]:.2f} {ev[1]:.2f} {ev[2]:.2f} {ev[3]:.2f}; device us earlier "
          + (f"{dev_old:.2f} this {dev_new:.2f}" if dev_old and dev_new else "not measured"), flush=True)


def phase7(dev, untiled_src=None):
    """B2 and its block sum against the plain backward at BWD_CASES: the
    largest error of B2 + block sum and of the block sum, and per case the ms
    and device µs of each timed function and the partials' shape.  With
    untiled_src (an earlier, untiled fused_fields_bwd.cu), also
    against_untiled at each case."""
    from hpvpinns_tpu_torch.models.mlp import MLP
    from hpvpinns_tpu_torch.ops.fused_fields import (
        block_sum_kernel,
        block_sum_reference,
        bwd_plan,
        fields_flat_bwd_reference,
        fused_fields_bwd,
        fused_fields_bwd_kernel,
    )

    untiled = load_untiled_bwd(untiled_src) if untiled_src else None
    rng = np.random.default_rng(1)
    bwd_err, sum_err, bwd_times = 0.0, 0.0, {}
    for name, layers, act, P, nd in BWD_CASES:
        spec = MLP(layers=layers, activation=act)
        net = random_net(spec, rng, dev)
        X = torch.as_tensor(rng.uniform(-1.0, 1.0, (P, layers[0])), dtype=torch.float32, device=dev)
        # Cotangents of a mean over the points (1/sqrt(P) scale): unit
        # cotangents at 16,384 points give gradient sums of ~1e2 whose f32
        # rounding, in either version, exceeds a 1e-5 atol.
        g = torch.as_tensor(rng.standard_normal((P, 1 + 2 * nd)) / math.sqrt(P), dtype=torch.float32, device=dev)
        tol = WIDE_GRAD_TOL if max(layers) >= 48 else GRAD_TOL
        got, got_x = fused_fields_bwd(spec, net, X, g, nd)
        again, again_x = fused_fields_bwd(spec, net, X, g, nd)
        want, want_x = fields_flat_bwd_reference(spec, net, X, g, nd)
        torch.cuda.synchronize()
        err = check_close(f"{name} gX", got_x, want_x, **tol)
        same = torch.equal(got_x, again_x)
        for l, (a, b, c) in enumerate(zip(got, want, again)):
            for k in ("W", "b"):
                err = max(err, check_close(f"{name} g{k}_{l}", a[k], b[k], **tol))
                same = same and torch.equal(a[k], c[k])
        if not same:
            fail(f"{name}: two runs of B2 + block sum differ")
        (b2_args, *b2_keep), partials, _ = fused_fields_bwd_kernel.prepare(spec, net, X, g, nd)
        fused_fields_bwd_kernel.launch(*b2_args)
        plan = bwd_plan(layers, nd, P)
        n_params = sum(a * b + b for a, b in zip(layers[:-1], layers[1:]))
        c_smem = fused_fields_bwd_kernel.load().lib.hp_fused_fields_bwd_smem_bytes(
            n_params, max(layers[:-1]), len(layers) - 1, nd)
        if c_smem != plan.smem_bytes or tuple(partials.shape) != (plan.n_blocks, plan.row_pitch):
            fail(f"{name}: bwd_plan {plan} disagrees with the kernel ({c_smem} B, partials {tuple(partials.shape)})")
        # The partials' shape before this redesign: one row per 16 points,
        # n_params wide (rows not 16-byte aligned unless n_params % 4 == 0).
        one, _ = fused_fields_bwd_kernel(spec, net, X, g, nd, tiles_per_block=1)
        old_rows = one[:, :n_params].contiguous()
        serr = 0.0
        for rows in (partials, old_rows):
            serr = max(serr, check_close(f"{name} block sum {list(rows.shape)}", block_sum_kernel(rows),
                                         block_sum_reference(rows), **SUM_TOL))
        bwd_err, sum_err = max(bwd_err, err), max(sum_err, serr)
        (sum_args, sum_keep), _ = block_sum_kernel.prepare(partials)
        (old_sum_args, old_sum_keep), _ = block_sum_kernel.prepare(old_rows)
        fns = {
            "plain": lambda: fields_flat_bwd_reference(spec, net, X, g, nd),
            "b2": lambda: fused_fields_bwd_kernel(spec, net, X, g, nd),
            "sum": lambda: block_sum_kernel(partials),
            "b2+sum": lambda: fused_fields_bwd(spec, net, X, g, nd),
            "torch.sum": lambda: partials.sum(dim=0),
            "sum_old_rows": lambda: block_sum_kernel(old_rows),
            "torch.sum_old_rows": lambda: old_rows.sum(dim=0),
        }
        ms = {k: cuda_ms(f) for k, f in fns.items() if k != "sum_old_rows" and k != "torch.sum_old_rows"}
        ms["plain"] = (ms["plain"] + cuda_ms(fns["plain"])) / 2  # plain first and last
        dev_us = {k: device_us(f) for k, f in fns.items()}
        # The kernels alone: their C functions, arguments prepared once, in
        # turns kernel, torch, torch, kernel for the sums
        c_fns = {
            "b2": lambda: fused_fields_bwd_kernel.launch(*b2_args),
            "sum": lambda: block_sum_kernel.launch(*sum_args),
            "torch.sum": fns["torch.sum"],
            "sum_old_rows": lambda: block_sum_kernel.launch(*old_sum_args),
            "torch.sum_old_rows": fns["torch.sum_old_rows"],
        }
        ev_us = {k: 1e3 * cuda_ms(f) for k, f in c_fns.items()}
        for k in ("sum", "sum_old_rows"):
            ev_us[k] = (ev_us[k] + 1e3 * cuda_ms(c_fns[k])) / 2
        bwd_times[name] = (ms, partials.shape, dev_us, ev_us)
        print(
            f"phase 7 {name}: layers {layers} {act} P={P} n_dirs={nd} tiles/block {plan.tiles_per_block} partials "
            f"{list(partials.shape)} (old rows {list(old_rows.shape)}) smem {plan.smem_bytes} B; max_abs_err {err:.3e} "
            f"(block sum {serr:.3e}), bit-identical repeat; ms/call "
            + " ".join(f"{k} {v:.4f}" for k, v in ms.items()) + "; device us/call (torch.profiler) "
            + " ".join(f"{k} {v:.2f}" if v else f"{k} not measured" for k, v in dev_us.items())
            + "; C-function us/launch (CUDA events, 50 launches) "
            + " ".join(f"{k} {v:.2f}" for k, v in ev_us.items()),
            flush=True,
        )
        if untiled:
            against_untiled(untiled, name, spec, net, X, g, nd)
    return bwd_err, sum_err, bwd_times


FWD_CASES = [  # (name, layers, activation, P, n_dirs, second)
    ("scaled", (2, 20, 20, 20, 1), "tanh", 16384, 2, False),
    ("quality", (2, 48, 48, 48, 48, 1), "tanh", 4096, 2, False),
    ("sin_d1_second", (1, 20, 20, 20, 1), "sin", 1000, 1, True),
    ("sin_d3_second", (3, 48, 48, 48, 1), "sin", 1003, 3, True),
    # the second-derivative shapes that phases 8-10 train on
    ("p1d_record", (1, 20, 20, 20, 20, 1), "sin", 80, 1, True),
    ("p1d_quality", (1, 30, 30, 30, 1), "sin", 240, 1, True),
    ("p2d_scaled_second", (2, 20, 20, 20, 1), "tanh", 16384, 2, True),
    ("p2d_quality_second", (2, 48, 48, 48, 48, 1), "tanh", 4096, 2, True),
    ("advdiff_record", (2, 5, 5, 5, 1), "tanh", 100, 2, True),  # var_form 0: u_yy computed, then dropped
    # above width 64: the staged form (phase 11 trains on the first)
    ("wide_scaled", (2, 256, 256, 256, 1), "tanh", 16384, 2, False),
    ("wide_one_layer", (2, 256, 1), "tanh", 1000, 2, True),
    ("wide_mixed", (1, 200, 40, 1), "tanh", 1000, 1, True),
    ("wide_sin_d3", (3, 128, 128, 128, 1), "sin", 1003, 3, True),
]


def load_parent_fwd(src: str):
    """Build `src`, an earlier fused_fields.cu whose C function takes the
    network packed into one buffer, under another library name, and return
    its launch function."""
    import ctypes

    from hpvpinns_tpu_torch.ops.cuda_build import build_library

    fn = build_library("fused_fields_parent", [src]).lib.hp_fused_fields_f32
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes, fn.restype = [vp, vp, vp, i32, i32, i32, i32, i32, vp, i32, vp], i32
    return fn


def against_parent_fwd(fn, name, spec, net, X, nd, second):
    """The earlier B1 (`fn`) and this one on the same inputs: bit for bit,
    and both timed alone, C function by C function, in turns earlier, this,
    this, earlier (replays of a CUDA graph of 50 launches; CUDA events around
    50 launches from the host) and by torch.profiler."""
    from hpvpinns_tpu_torch.ops.fused_fields import _ACTIVATION_CODE, fused_fields_kernel, pack_params

    P = X.shape[0]
    with torch.no_grad():
        packed, widths = pack_params(spec, net)
    out_old = torch.empty((P, 1 + nd * (2 if second else 1)), device=X.device)

    def prepare_old():
        args = (X.data_ptr(), packed.data_ptr(), widths.ctypes.data, spec.n_layers, P, nd, int(second),
                _ACTIVATION_CODE[spec.activation], out_old.data_ptr(), X.device.index or 0,
                torch.cuda.current_stream(X.device).cuda_stream)

        def launch():
            if fn(*args) != 0:
                fail(f"{name}: the earlier B1 did not launch")

        return launch

    def prepare_new():
        (a, *keep), _ = fused_fields_kernel.prepare(spec, net, X, nd, second)
        return lambda keep=keep: fused_fields_kernel.launch(*a)

    old = prepare_old()
    (a, *keep), out_new = fused_fields_kernel.prepare(spec, net, X, nd, second)
    new = lambda: fused_fields_kernel.launch(*a)
    old()
    new()
    torch.cuda.synchronize()
    if not torch.equal(out_old, out_new):
        fail(f"{name}: B1 differs from the earlier B1 (max abs diff {(out_old - out_new).abs().max().item():.3e})")
    ev = [1e3 * cuda_ms(f) for f in (old, new, new, old)]
    gr = [graph_us(f) for f in (prepare_old, prepare_new, prepare_new, prepare_old)]
    dev_old, dev_new = device_us(old), device_us(new)
    print(f"phase 3 {name} against the earlier B1: bit-identical; us/launch in turns earlier, this, this, earlier: "
          f"in a CUDA graph of {TIMED_CALLS} launches {gr[0]:.2f} {gr[1]:.2f} {gr[2]:.2f} {gr[3]:.2f}, from the host "
          f"(CUDA events) {ev[0]:.2f} {ev[1]:.2f} {ev[2]:.2f} {ev[3]:.2f}; device us (torch.profiler) earlier "
          + (f"{dev_old:.2f} this {dev_new:.2f}" if dev_old and dev_new else "not measured"), flush=True)


def phase3(dev, parent_src=None):
    """B1 against its plain version at FWD_CASES: the largest error at widths
    up to 64 and above, and per case (ms through the wrapper, plain ms, the C
    function's device us by torch.profiler and its us per launch in a CUDA
    graph, the plain version's device us).  With parent_src (an earlier
    fused_fields.cu), also against_parent_fwd at every case of width <= 64."""
    from hpvpinns_tpu_torch.models.mlp import MLP
    from hpvpinns_tpu_torch.ops.fused_fields import (
        FWD_RESIDENT_WIDTH,
        fields_flat,
        fields_flat_reference,
        fused_fields_kernel,
        fwd_plan,
    )

    parent = load_parent_fwd(parent_src) if parent_src else None
    rng = np.random.default_rng(0)
    max_err, wide_err, times = 0.0, 0.0, {}
    for name, layers, act, P, nd, second in FWD_CASES:
        spec = MLP(layers=layers, activation=act)
        params = random_net(spec, rng, dev)
        X = torch.as_tensor(rng.uniform(-1.0, 1.0, (P, layers[0])), dtype=torch.float32, device=dev)
        wide = max(layers) > FWD_RESIDENT_WIDTH
        with torch.no_grad():
            got = fused_fields_kernel(spec, params, X, nd, second)
            want = fields_flat_reference(spec, params, X, nd, second)
        torch.cuda.synchronize()
        err = check_close(f"{name} fields", got, want, **(WIDE_FIELD_TOL if wide else FIELD_TOL))
        if wide:
            wide_err = max(wide_err, err)
        else:
            max_err = max(max_err, err)
        # the plan against the kernel's own arithmetic
        plan = fwd_plan(layers, nd, second, P)
        widths = np.asarray(layers, dtype=np.int32)
        c_smem = fused_fields_kernel.load().lib.hp_fused_fields_smem_bytes(
            widths.ctypes.data, len(layers) - 1, nd, int(second), int(plan.staged), plan.block_points, plan.k_tile)
        if c_smem != plan.smem_bytes or plan.staged != wide or plan.n_blocks != -(-P // plan.block_points):
            fail(f"{name}: fwd_plan {plan} disagrees with the kernel ({c_smem} B) or with the width")
        line = (f"phase 3 {name}: layers {layers} {act} P={P} n_dirs={nd} second={second} "
                f"{'staged' if plan.staged else 'resident'} {plan.block_points} points x {plan.groups} groups, "
                f"{plan.n_blocks} blocks, smem {plan.smem_bytes} B; max_abs_err {err:.3e}")
        if not wide:  # the staged form adds in the same order: bit for bit
            with torch.no_grad():
                forced = fused_fields_kernel(spec, params, X, nd, second, plan=fwd_plan(layers, nd, second, P, staged=True))
            torch.cuda.synchronize()
            if not torch.equal(forced, got):
                fail(f"{name}: the staged form differs from the resident form")
            line += ", staged form bit-identical"
        if not second:
            g = torch.as_tensor(rng.standard_normal(got.shape), dtype=torch.float32, device=dev)
            leaves = [t for layer in params for t in (layer["W"], layer["b"])]
            gk = torch.autograd.grad((fields_flat(spec, params, X, nd, False) * g).sum(), leaves)
            gr = torch.autograd.grad((fields_flat_reference(spec, params, X, nd, False) * g).sum(), leaves)
            tol = WIDE_GRAD_TOL if wide else GRAD_TOL
            gerr = max(check_close(f"{name} grad {i}", a, b, **tol) for i, (a, b) in enumerate(zip(gk, gr)))
            line += f", grad max_abs_err {gerr:.3e}"
        with torch.no_grad():
            kernel = lambda: fused_fields_kernel(spec, params, X, nd, second)
            plain = lambda: fields_flat_reference(spec, params, X, nd, second)

            def prepare_c():
                (c_args, *c_keep), _ = fused_fields_kernel.prepare(spec, params, X, nd, second)
                return lambda c_keep=c_keep: fused_fields_kernel.launch(*c_args)

            c_fn = prepare_c()
            p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)
            k_dev, p_dev, c_dev = device_us(kernel), device_us(plain), device_us(c_fn)
            c_ev, c_graph = 1e3 * cuda_ms(c_fn), graph_us(prepare_c)
        bound, by = bound_ms(*fwd_work(layers, P, nd, second))
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2, c_dev, c_graph, p_dev)
        line += f"; ms/call kernel {k1:.4f} {k2:.4f} plain {p1:.4f} {p2:.4f}"
        line += "; device us/call " + (
            f"kernel {k_dev:.2f} plain {p_dev:.2f} C function {c_dev:.2f}" if k_dev and p_dev and c_dev
            else "not measured (no device events)"
        ) + (f"; C-function us/launch in a CUDA graph of {TIMED_CALLS} launches {c_graph:.2f}, from the host (CUDA "
             f"events) {c_ev:.2f}; bound {1e3 * bound:.3f} us ({by})")
        print(line, flush=True)
        if parent and not wide:
            against_parent_fwd(parent, name, spec, params, X, nd, second)
    return max_err, wide_err, times


GRAPH_CASES = (  # (label, preset, var_form or None, second derivatives): chunks held against the eager ones
    ("poisson2d_scaled var_form 1", "poisson2d_scaled", None, False),
    ("poisson2d_scaled var_form 0", "poisson2d_scaled", 0, True),
    ("poisson1d_of_record", "poisson1d_of_record", None, True),
)


def graph_against_eager(label: str, prob, c, need) -> dict:
    """One chunk of check_every Adam steps from the same params, once as CUDA
    graphs (_build_chunk) and once eagerly (_build_stepwise_chunk), both with
    the same capturable Adam: params and metrics bit for bit (else within
    1e-6 relative, reported; `need` empty: bit for bit only), and the
    kernels of `need` as nodes of the captured step (B1 also in the metrics
    graph).  Prints one line; returns the captured step's nodes."""
    from hpvpinns_tpu_torch.problems.base import parameters
    from hpvpinns_tpu_torch.training.trainer import _build_chunk, _build_stepwise_chunk

    n, slug, out = c.train.check_every, label.replace(" ", "_").replace(",", ""), {}
    for kind in ("graph", "eager"):
        prm, opt = fresh_state(prob, c)
        if kind == "graph":
            ch = _build_chunk(prob.loss_fn, opt, prm, prob.data, debug=True)
            step_nodes = graph_nodes(ch.graphs[0], f"{slug}_step")
            metric_nodes = graph_nodes(ch.graphs[1], f"{slug}_metrics")
        else:
            ch = _build_stepwise_chunk(prob.loss_fn, opt, prm, prob.data)
        aux = ch(n)
        torch.cuda.synchronize()
        out[kind] = [t.detach().clone() for t in parameters(prm)] + [aux[k].detach().clone() for k in sorted(aux)]
    same = all(torch.equal(a, b) for a, b in zip(out["graph"], out["eager"]))
    rel = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item() for a, b in zip(out["graph"], out["eager"]))
    if not same and (not need or not rel <= 1e-6):
        fail(f"{label}: the graph chunk differs from the eager chunk (max rel diff {rel:.3e})")
    if need and (min(step_nodes[k] for k in need) < 1 or metric_nodes["fused_fields"] < 1):
        fail(f"{label}: kernels missing from the captured graphs: step {step_nodes}, metrics {metric_nodes}")
    print(f"{label} {c.deriv_mode}: one chunk of {n} Adam steps as CUDA graphs against the eager chunk: params and "
          f"metrics " + ("bit-identical" if same else f"max rel diff {rel:.3e}") + f"; captured step "
          f"{step_nodes['nodes']} nodes, {step_nodes['kernels']} kernels (B1 {step_nodes['fused_fields']}, B2 "
          f"{step_nodes['fused_fields_bwd']}, block sum {step_nodes['block_sum']}); metrics graph "
          f"{metric_nodes['nodes']} nodes (B1 {metric_nodes['fused_fields']})", flush=True)
    return step_nodes


def phase5(dev):
    """The main path.  At GRAPH_CASES under "pallas": graph_against_eager,
    with the path's kernels as nodes of the captured step.  Then
    poisson2d_scaled trains 200 steps through `train`.  Returns (host
    launches by path, the captured step's nodes by path)."""
    import hpvpinns_tpu_torch as hv

    nodes = {}
    for label, preset, vf, second in GRAPH_CASES:
        c = dataclasses.replace(getattr(hv, preset)(), deriv_mode="pallas")
        if vf is not None:
            c = dataclasses.replace(c, var_form=vf)
        prob = hv.build(c, device=dev)
        nodes[label] = graph_against_eager(f"phase 5 {label}", prob, c, tuple(KERNEL_NODES) if second else ("fused_fields",))

    cfg = dataclasses.replace(hv.poisson2d_scaled(), deriv_mode="pallas")
    pp = hv.build(cfg, device=dev)
    tcfg = dataclasses.replace(cfg.train, iterations=200, check_every=10)
    zero_counts()
    res = hv.train(pp, tcfg, verbose=False)
    counts = read_counts()
    loss_hist = res.history["loss"]
    if not np.all(np.isfinite(loss_hist)) or not loss_hist[-1] < loss_hist[0]:
        fail(f"poisson2d_scaled loss did not fall: {loss_hist.tolist()}")
    if counts["fused_fields"] < 1:
        fail("poisson2d_scaled: B1 did not launch")
    u = hv.predict(pp, res.params)
    if u.shape != (pp.test_points.shape[0], 1) or not np.all(np.isfinite(u)):
        fail(f"prediction has shape {u.shape} or non-finite values")
    print(
        f"phase 5 train poisson2d_scaled pallas: {res.iterations_run} steps, loss {loss_hist[0]:.6e} -> "
        f"{loss_hist[-1]:.6e}, {res.steps_per_sec:.1f} steps/s (host clock, chunks end in a device sync, first "
        f"chunk excluded), B1 host launches {counts['fused_fields']} (warm-up and capture; the steps replay the graph)",
        flush=True,
    )
    return {"poisson2d_scaled var_form 1": counts}, nodes


def train_checked(prob, cfg, label: str, kernels=()):
    """Train `prob` through `train` (the counts zeroed just before, read just
    after) and evaluate its best snapshot: (result, host launches, the
    evaluation).  Fails on a short run (unless the threshold stopped it), a
    non-finite loss or rel-L2, an L-BFGS loss that rises from one record to
    the next, or a kernel of `kernels` that did not launch."""
    import hpvpinns_tpu_torch as hv

    zero_counts()
    res = hv.train(prob, verbose=False)
    counts = read_counts()
    tr = cfg.train
    it, loss = res.history["iteration"], res.history["loss"]
    ev = hv.evaluate_problem(prob, res.eval_params)
    if ((res.iterations_run != tr.iterations + tr.lbfgs_iterations and not res.stopped_early)
            or not np.all(np.isfinite(loss)) or not math.isfinite(ev["rel_l2"])):
        fail(f"{label}: {res.iterations_run} iterations, loss {loss.tolist()}, rel_l2 {ev['rel_l2']}")
    rise = float(np.max(np.diff(loss[it >= tr.iterations]), initial=0.0)) if tr.lbfgs_iterations else 0.0
    if rise > 0:
        fail(f"{label}: the L-BFGS loss rose by {rise:.3e} from one record to the next")
    if kernels and min(counts[k] for k in kernels) < 1:
        fail(f"{label}: host launches {counts}: a kernel of the path did not launch")
    return res, counts, ev


QUALITY = (  # (label, preset, its arguments, modes, target rel-L2, the JAX package's row, the kernels of its
    # "pallas" path, the L-BFGS iterations of the whole run (None: the preset's; --quality runs the preset's))
    ("poisson2d_quality", "poisson2d_quality", {}, ("taylor", "pallas"), 1e-3,
     "8.6e-4, benchmarks/ACCURACY.json:100-108", ("fused_fields",), None),
    ("poisson1d_quality", "poisson1d_quality", {}, ("pallas",), 1e-2,
     "4.9-6.1e-3 in f32, hpvpinns_tpu/config.py:704-710", tuple(KERNEL_NODES), None),
    # The hard-BC ansatz on the JVP engine, no kernel.  Its preset's 20k
    # L-BFGS iterations took 277 s on an NVIDIA H100 80GB HBM3 at 700.00 W
    # (4.5 closure evaluations an iteration), a third of the whole run: the
    # whole run cuts them to 5k.
    ("poisson2d_quality hard_bc", "poisson2d_quality", {"hard_bc": True}, ("jvp",), 1e-3,
     "3.1e-4 after 20k L-BFGS, hpvpinns_tpu/config.py:720-737", (), 5000),
)


def phase6(dev, seed=None):
    """The quality presets (Adam, then L-BFGS, f32) through build, train and
    evaluate: rel-L2 on the test grid against the target, the final loss,
    each phase's wall seconds and the L-BFGS closure evaluations per
    iteration.  It fails on a non-finite result, a short run or an L-BFGS
    loss that rises from one record to the next; a missed target is printed,
    not hidden.  `seed` replaces the presets' seed (the seeds study of
    --quality: poisson2d_quality, soft and hard BC, at the presets' whole
    schedules); without it the hard-BC run's L-BFGS is cut as QUALITY says.
    Returns {"<preset> <mode>": {"counts", "rel_l2"}}."""
    import hpvpinns_tpu_torch as hv

    out = {}
    for label, preset, preset_kw, modes, target, jax_row, kernels, lbfgs in (
            (QUALITY[0], QUALITY[2]) if seed is not None else QUALITY):
        for mode in modes:
            c = dataclasses.replace(getattr(hv, preset)(**preset_kw), deriv_mode=mode)
            if seed is not None:
                c = dataclasses.replace(c, train=dataclasses.replace(c.train, seed=seed))
            elif lbfgs is not None:
                c = dataclasses.replace(c, train=dataclasses.replace(c.train, lbfgs_iterations=lbfgs))
            prob = hv.build(c, device=dev)
            res, counts, ev = train_checked(prob, c, f"{label} {mode}", kernels if mode == "pallas" else ())
            loss = res.history["loss"]
            adam, lb = res.phases["adam"], res.phases["lbfgs"]
            out[f"{label} {mode}"] = {"counts": counts, "rel_l2": ev["rel_l2"]}
            print(
                f"phase 6 {label} {mode} seed {c.train.seed}: Adam {c.train.iterations} + L-BFGS "
                f"{c.train.lbfgs_iterations}{' (cut)' if seed is None and lbfgs else ''} (f32, layers "
                f"{c.layers}): rel_l2 {ev['rel_l2']:.4e} (target < {target:g}: "
                f"{'met' if ev['rel_l2'] < target else 'MISSED'}; JAX {jax_row}); final loss {loss[-1]:.6e}; wall s "
                f"Adam {adam['wall_s']:.2f} L-BFGS {lb['wall_s']:.2f}; L-BFGS closure evaluations per iteration "
                f"{lb['evaluations'] / lb['iterations']:.3f}; loss non-increasing over the L-BFGS records; host "
                f"launches {counts}",
                flush=True,
            )
    ratio = out["poisson2d_quality pallas"]["rel_l2"] / out["poisson2d_quality taylor"]["rel_l2"]
    print(f"phase 6 poisson2d_quality rel_l2 pallas / taylor {ratio:.3f} (within 1.5x: {'yes' if ratio <= 1.5 else 'NO'})",
          flush=True)
    return out


def two_streams(dev):
    """The block sum's tickets are each launch's own: the same partials
    summed on two streams at once, 20 rounds, bit-identical to one stream,
    at B2's p2d_scaled partials shape (8 slabs) and at 8,192 x 7,252 (128
    slabs)."""
    from hpvpinns_tpu_torch.ops.fused_fields import block_sum_kernel, block_sum_plan

    rng = np.random.default_rng(3)
    for rows, n in ((512, 924), (8192, 7252)):
        partials = torch.as_tensor(rng.standard_normal((rows, n)), dtype=torch.float32, device=dev)
        want = block_sum_kernel(partials)
        streams, outs = (torch.cuda.Stream(), torch.cuda.Stream()), []
        for s in streams:
            s.wait_stream(torch.cuda.current_stream())
        for _ in range(20):
            for s in streams:
                with torch.cuda.stream(s):
                    outs.append(block_sum_kernel(partials))
        for s in streams:
            torch.cuda.current_stream().wait_stream(s)
        torch.cuda.synchronize()
        if not all(torch.equal(o, want) for o in outs):
            fail(f"block sum of [{rows}, {n}] on two streams at once differs from one stream")
        print(f"phase 7 block sum [{rows}, {n}] ({block_sum_plan(rows, n)[2]} slabs): 40 sums on two streams at once "
              f"bit-identical to one stream", flush=True)


# The JAX package's AdvDiff rows (benchmarks/ACCURACY.json): advdiff_of_record
# f32 (:57-70), advdiff_lbfgs f32 (:85-98), advdiff_lbfgs f64 on the CPU (:168-181).
JAX_ADVDIFF_RECORD = {"epsilon": 0.0992, "rel_l2": 0.303}
JAX_ADVDIFF_LBFGS_F32_EPS_REL = 0.0255
JAX_ADVDIFF_LBFGS_F64_EPS_REL = 5.6e-4
ADVDIFF_FORMS = (  # phase 12 (a): (label, overrides of advdiff_of_record)
    ("var_form 0", {}),
    ("var_form 1", {"var_form": 1}),
    ("var_form 2", {"var_form": 2}),
    ("var_form 0, quadratic eps, linear V",
     {"epsilon_model": "quadratic", "velocity_trainable": True, "velocity_model": "linear"}),
)


def identify(prob, cfg, label: str, kernels=()) -> dict:
    """train_checked, then eps of the best snapshot against the truth: the
    run's numbers."""
    res, counts, ev = train_checked(prob, cfg, label, kernels)
    eps = float(prob.extras["eps_domain_mean"](res.eval_params))
    eps_true = prob.extras["eps_true"]
    return {"res": res, "counts": counts, "eps": eps, "eps_rel": abs(eps - eps_true) / eps_true,
            "closed": 1.0 - abs(eps - eps_true) / abs(cfg.epsilon_init - eps_true), "rel_l2": ev["rel_l2"],
            "final_loss": float(res.history["loss"][-1])}


def identification_schedules(dev, seed=None) -> dict:
    """Phase 12 (d) and (e): the advdiff_lbfgs schedule (Adam 5k + L-BFGS 10k,
    f32, "pallas") and advdiff_quality (the same in float64, "taylor"),
    eps's relative error against its target and the JAX package's row.
    `seed` replaces the presets' train seed (which draws the data and the
    init: the seeds study of --advdiff-quality).  Returns the host launches
    by path."""
    import hpvpinns_tpu_torch as hv

    paths = {}
    for label, c, target, jax_row, kernels in (
        ("advdiff_lbfgs pallas (f32)", dataclasses.replace(hv.advdiff_quality(), dtype="float32", deriv_mode="pallas"),
         0.10, JAX_ADVDIFF_LBFGS_F32_EPS_REL, tuple(KERNEL_NODES)),
        ("advdiff_quality taylor (f64)", hv.advdiff_quality(), 2.4e-2, JAX_ADVDIFF_LBFGS_F64_EPS_REL, ()),
    ):
        if seed is not None:
            c = dataclasses.replace(c, train=dataclasses.replace(c.train, seed=seed))
        r = identify(hv.build(c, device=dev), c, label, kernels)
        paths[label] = r["counts"]
        ph = r["res"].phases
        print(f"phase 12 ({'d' if c.dtype == 'float32' else 'e'}) {label}: Adam {c.train.iterations} + L-BFGS "
              f"{c.train.lbfgs_iterations}, seed {c.train.seed}: eps {r['eps']:.8g}, relative error "
              f"{r['eps_rel']:.4e} (target < {target:g}: {'met' if r['eps_rel'] < target else 'MISSED'}; JAX row "
              f"{jax_row:g}); rel_l2 {r['rel_l2']:.4e}; final "
              f"loss {r['final_loss']:.6e}; wall s Adam {ph['adam']['wall_s']:.2f} L-BFGS {ph['lbfgs']['wall_s']:.2f}; "
              f"L-BFGS closure evaluations per iteration {ph['lbfgs']['evaluations'] / ph['lbfgs']['iterations']:.3f}; "
              f"loss non-increasing over the L-BFGS records; host launches {r['counts']}", flush=True)
    return paths


def phase12(dev):
    """AdvDiff identification on the card.  (a) loss and gradients, eps's
    included, under "taylor", "pallas" and "jvp" at advdiff_of_record forms
    0/1/2 and with a quadratic eps and a linear V at form 0 (loss rtol 1e-5,
    gradients rtol 1e-3 / atol 1e-4 against "taylor"), and "pallas" in
    float64 raising; (b) graph_against_eager under "pallas" at form 0 (B1,
    B2 and the block sum in the captured step) and under the hard-BC
    ansatz ("jvp"); (c) advdiff_of_record's 1,501 Adam steps under "taylor"
    and "pallas": eps must close at least 75% of its distance from
    epsilon_init to the truth; (d) the advdiff_lbfgs schedule (Adam 5k +
    L-BFGS 10k, f32, "pallas") and (e) advdiff_quality (the same in float64
    under "taylor"): eps's relative error printed against its target and the
    JAX package's row (a miss is printed, not hidden).  Returns (host
    launches by path, the captured step's nodes by path)."""
    import hpvpinns_tpu_torch as hv
    from hpvpinns_tpu_torch.problems.base import parameters

    t0 = time.perf_counter()
    base = hv.advdiff_of_record()
    for label, kw in ADVDIFF_FORMS:
        c = dataclasses.replace(base, **kw)
        probs = {m: hv.build(dataclasses.replace(c, deriv_mode=m), device=dev) for m in ("taylor", "pallas", "jvp")}
        prm = probs["taylor"].init_params(torch.Generator().manual_seed(c.train.seed))
        out = {}
        for m, prob in probs.items():
            loss, aux = prob.loss_fn(prm, prob.data)
            out[m] = (loss.detach(), torch.autograd.grad(loss, parameters(prm)))
        lt, gt = out["taylor"]
        line = f"phase 12 (a) advdiff_of_record {label}: loss taylor {lt.item():.6e}"
        for m in ("pallas", "jvp"):
            lm, gm = out[m]
            check_close(f"advdiff {label} {m} loss", lm, lt, rtol=1e-5, atol=0.0)
            gerr = max(check_close(f"advdiff {label} {m} grad {i}", a, b, rtol=1e-3, atol=1e-4)
                       for i, (a, b) in enumerate(zip(gm, gt)))
            line += f", {m} {lm.item():.6e} (grad max_abs_err {gerr:.3e})"
        line += "; d loss / d pde " + " ".join(f"{g.reshape(-1)[0].item():.6e}" for g in gt[2 * (len(c.layers) - 1):])
        print(line, flush=True)
    q64 = hv.build(dataclasses.replace(hv.advdiff_quality(), deriv_mode="pallas"), device=dev)
    try:
        q64.loss_fn(q64.init_params(torch.Generator().manual_seed(0)), q64.data)
    except ValueError as e:
        print(f"phase 12 (a) advdiff_quality pallas (float64) raises: {e}", flush=True)
    else:
        fail("advdiff_quality under pallas (float64) ran: the kernels take float32 only")

    nodes = {}
    for label, c, need in (
        ("advdiff_of_record var_form 0", dataclasses.replace(base, deriv_mode="pallas"), tuple(KERNEL_NODES)),
        ("advdiff_of_record hard_bc", dataclasses.replace(base, hard_bc=True, deriv_mode="jvp"), ()),
    ):
        nodes[label] = graph_against_eager(f"phase 12 (b) {label}", hv.build(c, device=dev), c, need)

    paths = {}
    for mode in ("taylor", "pallas"):
        c = dataclasses.replace(base, deriv_mode=mode)
        r = identify(hv.build(c, device=dev), c, f"advdiff_of_record {mode}", tuple(KERNEL_NODES) if mode == "pallas" else ())
        paths[f"advdiff_of_record {mode}"] = r["counts"]
        if not r["closed"] >= 0.75:
            fail(f"advdiff_of_record {mode}: eps {r['eps']:.6g} closed {r['closed']:.3f} of its distance to the "
                 f"truth (need 0.75)")
        h = r["res"].history
        print(f"phase 12 (c) advdiff_of_record {mode}: {r['res'].iterations_run} Adam steps, loss {h['loss'][0]:.6e} -> "
              f"{r['final_loss']:.6e}, {r['res'].steps_per_sec:.1f} steps/s; eps {r['eps']:.6g} (true "
              f"{c.gamma / np.pi:.6g}, from {c.epsilon_init}: {100 * r['closed']:.1f}% of the distance closed, "
              f"relative error {r['eps_rel']:.4f}; JAX f32 row eps {JAX_ADVDIFF_RECORD['epsilon']}), rel_l2 "
              f"{r['rel_l2']:.4f} (JAX f32 row {JAX_ADVDIFF_RECORD['rel_l2']}); host launches {r['counts']}", flush=True)

    paths.update(identification_schedules(dev))
    print(f"phase 12 advdiff: {time.perf_counter() - t0:.1f} s", flush=True)
    return paths, nodes


def main() -> int:
    t_run = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a GPU only", file=sys.stderr)
        return 1
    import hpvpinns_tpu_torch as hv
    from hpvpinns_tpu_torch.models.mlp import use_ieee_fp32_matmuls
    from hpvpinns_tpu_torch.ops.fused_fields import fused_fields_bwd_kernel, fused_fields_kernel
    from hpvpinns_tpu_torch.problems.base import parameters

    dev = torch.device("cuda", 0)
    if any(name == "jax" or name.startswith(("jax.", "hpvpinns_tpu.")) or name == "hpvpinns_tpu"
           for name in sys.modules):
        fail("JAX or hpvpinns_tpu was imported")

    # 1. card and flags
    use_ieee_fp32_matmuls()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(
        f"phase 1 card: {torch.cuda.get_device_name(0)} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}",
        flush=True,
    )

    # 2. build both libraries, their two nvcc runs started together: the
    # build counts against the script's time limit
    with ThreadPoolExecutor(max_workers=2) as pool:
        builds = list(pool.map(lambda k: k.load(), (fused_fields_kernel, fused_fields_bwd_kernel)))
    for built in builds:
        ptxas = [ln.strip() for ln in built.log.splitlines() if "registers" in ln or "spill" in ln or "Compiling" in ln]
        print(f"phase 2 build: {built.path.name} in {built.build_seconds:.1f} s", flush=True)
        for ln in ptxas:
            print(f"  ptxas {ln}", flush=True)

    if sys.argv[1:2] == ["--bwd-only"]:  # for work on B2: phases 1, 2 and 7 only, no summary
        phase7(dev, sys.argv[2] if len(sys.argv) > 2 else None)
        return 0

    if sys.argv[1:2] == ["--quality"]:  # the seeds study: phases 1, 2 and 6 at each seed given, no summary
        for seed in sys.argv[2:]:
            phase6(dev, int(seed))
        return 0

    if sys.argv[1:2] == ["--fwd-only"]:  # for work on B1: phases 1, 2 and 3 only, no summary
        phase3(dev, sys.argv[2] if len(sys.argv) > 2 else None)
        return 0

    if sys.argv[1:2] == ["--advdiff-quality"]:  # the seeds study: phases 1, 2 and 12 (d), (e) at each seed given
        for seed in sys.argv[2:]:
            identification_schedules(dev, int(seed))
        return 0

    if sys.argv[1:2] == ["--advdiff-only"]:  # for work on AdvDiff: phases 1, 2 and 12 only, no summary
        phase12(dev)
        print(f"chip_smoke: {time.perf_counter() - t_run:.1f} s", flush=True)
        return 0

    # 3. B1 vs plain on the card
    max_err, wide_err, times = phase3(dev)

    # 4. the same loss both ways
    cfg = hv.poisson2d_scaled()
    pt = hv.build(dataclasses.replace(cfg, deriv_mode="taylor"), device=dev)
    pp = hv.build(dataclasses.replace(cfg, deriv_mode="pallas"), device=dev)
    params = pt.init_params(torch.Generator().manual_seed(cfg.train.seed))
    leaves = [t for layer in params["net"] for t in (layer["W"], layer["b"])]
    lt, _ = pt.loss_fn(params, pt.data)
    lp, _ = pp.loss_fn(params, pp.data)
    check_close("loss pallas vs taylor", lp.detach(), lt.detach(), rtol=1e-5, atol=0.0)
    gt = torch.autograd.grad(lt, leaves)
    gp = torch.autograd.grad(lp, leaves)
    gerr = max(check_close(f"loss grad {i}", a, b, rtol=1e-3, atol=1e-4) for i, (a, b) in enumerate(zip(gp, gt)))
    print(f"phase 4 loss: taylor {lt.item():.6e} pallas {lp.item():.6e}; grad max_abs_err {gerr:.3e}", flush=True)

    # 5. the main path: one chunk as CUDA graphs against the eager chunk, then
    # poisson2d_scaled trained through `train`
    paths, nodes = phase5(dev)

    # 6. both quality presets at their full schedules (Adam, then L-BFGS)
    quality = phase6(dev)
    for label, q in quality.items():
        paths[label] = q["counts"]

    # 7. B2 and its block sum against the plain backward; the block sum on two
    # streams at once
    bwd_err, sum_err, bwd_times = phase7(dev)
    two_streams(dev)

    # 8. the second-derivative losses both ways
    for base, forms in ((hv.poisson1d_of_record(), (1, 2, 3)), (hv.poisson2d_quality(), (0, "2c"))):
        for vf in forms:
            c = dataclasses.replace(base, var_form=vf)
            pt = hv.build(dataclasses.replace(c, deriv_mode="taylor"), device=dev)
            pp2 = hv.build(dataclasses.replace(c, deriv_mode="pallas"), device=dev)
            prm = pt.init_params(torch.Generator().manual_seed(c.train.seed))
            lt, _ = pt.loss_fn(prm, pt.data)
            lp, _ = pp2.loss_fn(prm, pp2.data)
            check_close(f"{type(c).__name__} form {vf} loss", lp.detach(), lt.detach(), rtol=1e-5, atol=0.0)
            gt = torch.autograd.grad(lt, parameters(prm))
            gp = torch.autograd.grad(lp, parameters(prm))
            gerr = max(check_close(f"form {vf} grad {i}", a, b, rtol=1e-3, atol=1e-4) for i, (a, b) in enumerate(zip(gp, gt)))
            print(f"phase 8 {type(c).__name__} var_form {vf}: loss taylor {lt.item():.6e} pallas {lp.item():.6e}; "
                  f"grad max_abs_err {gerr:.3e}", flush=True)

    # 9. the second slice's path: poisson1d_of_record on B1 + B2
    c1 = dataclasses.replace(hv.poisson1d_of_record(), deriv_mode="pallas")
    p1 = hv.build(c1, device=dev)
    zero_counts()
    r1 = hv.train(p1, verbose=False)
    counts = paths["poisson1d_of_record"] = read_counts()
    hist = r1.history["loss"]
    if r1.iterations_run != c1.train.iterations or not np.all(np.isfinite(hist)) or not hist[-1] < hist[0]:
        fail(f"poisson1d_of_record: {r1.iterations_run} steps, loss did not fall: {hist[[0, -1]].tolist()}")
    if min(counts.values()) < 1:
        fail(f"poisson1d_of_record: kernel launches {counts}")
    ev1 = hv.evaluate_problem(p1, r1.params)
    if not abs(ev1["rel_l2"] - JAX_P1D_RECORD_REL_L2) <= 0.2 * JAX_P1D_RECORD_REL_L2:
        fail(f"poisson1d_of_record rel-L2 {ev1['rel_l2']:.4e} is not within 20% of the JAX row {JAX_P1D_RECORD_REL_L2}")
    print(
        f"phase 9 train poisson1d_of_record pallas: {r1.iterations_run} steps, loss {hist[0]:.6e} -> {hist[-1]:.6e}, "
        f"rel_l2 {ev1['rel_l2']:.4e} (JAX f32 row {JAX_P1D_RECORD_REL_L2}), {r1.steps_per_sec:.1f} steps/s, "
        f"host launches {counts} (warm-up and capture; the steps replay the graph)",
        flush=True,
    )

    # 10. the step at three configurations, "taylor" and "pallas": steps/s of
    # the graph chunk against the eager one, the graph's device time and busy
    # share, and the eager step's parts and profile
    for label, c in (
        ("poisson1d_of_record", hv.poisson1d_of_record()),
        ("poisson2d_scaled var_form 0", dataclasses.replace(hv.poisson2d_scaled(), var_form=0)),
        ("poisson2d_scaled var_form 1", hv.poisson2d_scaled()),
        ("advdiff_of_record", hv.advdiff_of_record()),
    ):
        c = dataclasses.replace(c, train=dataclasses.replace(
            c.train, iterations=200, check_every=10, lbfgs_iterations=0, threshold=None))
        for mode in ("taylor", "pallas"):
            prob = hv.build(dataclasses.replace(c, deriv_mode=mode), device=dev)
            zero_counts()
            rates, (gch, _) = chunk_rates(prob, c, 200)
            counts = read_counts()
            gn = graph_nodes(gch.graphs[0], f"phase10_{label.replace(' ', '_')}_{mode}")
            g_us, g_busy = graph_profile(gch)
            g_rate = (rates["graph"][0] + rates["graph"][1]) / 2
            if mode == "pallas" and label in ("poisson2d_scaled var_form 0", "advdiff_of_record"):  # B1 + B2 at n_dirs 2
                if min(counts.values()) < 1 or min(gn[k] for k in KERNEL_NODES) < 1:
                    fail(f"{label}: host launches {counts}, graph nodes {gn}")
            prm, opt = fresh_state(prob, c)
            fwd, bwd, adam = part_times(prob, prm, opt)
            prof = step_profile(prob, prm, opt)
            e, g = rates["eager"], rates["graph"]
            print(
                f"phase 10 {label} {mode}: steps/s eager {e[0]!r} {e[1]!r} graph {g[0]!r} {g[1]!r} (200 steps a "
                f"turn in chunks of 10, turns e g g e; graph / eager {(g[0] + g[1]) / (e[0] + e[1]):.2f}x); graph: "
                f"{gn['nodes']} nodes a step ({gn['kernels']} kernels; B1 {gn['fused_fields']}, B2 "
                f"{gn['fused_fields_bwd']}, block sum {gn['block_sum']}), device us/step "
                + (f"{g_us!r}, busy {g_busy!r} in the profiler's window, {g_us * 1e-6 * g_rate!r} as device "
                   f"us/step x graph steps/s" if g_us else "not measured")
                + f"; eager: fwd / bwd / Adam ms {fwd!r} / {bwd!r} / {adam!r}; device us/step "
                f"{prof['device_us']!r}; launches/step {prof['launches']!r}; busy {prof['busy']!r}; top "
                + "; ".join(f"{name} {us!r}" for name, us in prof["top"]),
                flush=True,
            )

    # 11. the wide path: poisson2d_scaled with the 3 x 256 network, on the staged form of B1
    wcfg = dataclasses.replace(hv.poisson2d_scaled(), layers=(2, 256, 256, 256, 1))
    wcfg = dataclasses.replace(wcfg, train=dataclasses.replace(
        wcfg.train, iterations=50, check_every=10, lbfgs_iterations=0, threshold=None))
    wprobs = {m: hv.build(dataclasses.replace(wcfg, deriv_mode=m), device=dev) for m in ("taylor", "pallas")}
    wparams = wprobs["taylor"].init_params(torch.Generator().manual_seed(wcfg.train.seed))
    wleaves = [t for layer in wparams["net"] for t in (layer["W"], layer["b"])]
    lt, _ = wprobs["taylor"].loss_fn(wparams, wprobs["taylor"].data)
    lp, _ = wprobs["pallas"].loss_fn(wparams, wprobs["pallas"].data)
    check_close("wide loss pallas vs taylor", lp.detach(), lt.detach(), rtol=1e-5, atol=0.0)
    gt = torch.autograd.grad(lt, wleaves)
    gp = torch.autograd.grad(lp, wleaves)
    gerr = max(check_close(f"wide loss grad {i}", a, b, rtol=1e-3, atol=1e-4) for i, (a, b) in enumerate(zip(gp, gt)))
    zero_counts()
    rw = hv.train(wprobs["pallas"], verbose=False)
    wide_launches = read_counts()["fused_fields"]
    paths["poisson2d_scaled 3 x 256"] = {"fused_fields": wide_launches}
    hw = rw.history["loss"]
    if not np.all(np.isfinite(hw)) or not hw[-1] < hw[0]:
        fail(f"poisson2d_scaled 3 x 256 loss did not fall: {hw[[0, -1]].tolist()}")
    if wide_launches < 1:
        fail("poisson2d_scaled 3 x 256: B1 did not launch")
    wrates = {}
    for mode, prob in wprobs.items():
        wrates[mode], (gch, _) = chunk_rates(prob, wcfg, 50)
        if mode == "pallas" and graph_nodes(gch.graphs[0], "phase11_pallas")["fused_fields"] < 1:
            fail("poisson2d_scaled 3 x 256: B1 is not in the captured step")
    print(
        f"phase 11 poisson2d_scaled layers {wcfg.layers}: loss taylor {lt.item():.6e} pallas {lp.item():.6e}, grad "
        f"max_abs_err {gerr:.3e}; 50 Adam steps under pallas: loss {hw[0]:.6e} -> {hw[-1]:.6e}, B1 host launches "
        f"{wide_launches}; steps/s (50 steps a turn, turns e g g e) "
        + "; ".join(f"{m} eager {r['eager'][0]!r} {r['eager'][1]!r} graph {r['graph'][0]!r} {r['graph'][1]!r}"
                    for m, r in wrates.items()),
        flush=True,
    )

    # 12. AdvDiff identification: forms, graphs, the Adam and L-BFGS schedules
    adv_paths, adv_nodes = phase12(dev)
    paths.update(adv_paths)
    nodes.update(adv_nodes)

    ms, plain_ms, c_dev, c_graph, _ = times["scaled"]
    wide_ms, wide_plain_ms, wide_c_dev, wide_c_graph, wide_plain_dev = times["wide_scaled"]
    wide_bound = bound_ms(*fwd_work((2, 256, 256, 256, 1), 16384, 2, False))
    ms7, pshape, dev7, ev7 = bwd_times["p2d_scaled"]
    b1_bound = bound_ms(*fwd_work((2, 20, 20, 20, 1), 16384, 2, False))
    b2_bound = bound_ms(*bwd_work((2, 20, 20, 20, 1), 16384, 2))
    sum_bound = bound_ms(4 * (pshape[0] * pshape[1] + pshape[1]), pshape[0] * pshape[1])
    main_counts = paths["poisson2d_scaled var_form 1"]
    kernels = [
        {"name": "fused_fields", "route": "cuda", "source": "hpvpinns_tpu_torch/csrc/fused_fields.cu",
         "replaces": "hpvpinns_tpu/ops/pallas_fields.py:48", "launches": main_counts["fused_fields"],
         "max_abs_err": max_err,
         "ms": ms, "plain_ms": plain_ms, "bound_ms": b1_bound[0], "bound_by": b1_bound[1], "library_ms": None,
         "shape": "poisson2d_scaled firsts, P 16384", "device_us": c_dev, "c_function_graph_us": c_graph,
         "wide": {"shape": "(2, 256, 256, 256, 1) firsts, P 16384, the staged form", "max_abs_err": wide_err,
                  "ms": wide_ms, "plain_ms": wide_plain_ms, "bound_ms": wide_bound[0], "bound_by": wide_bound[1],
                  "device_us": wide_c_dev, "c_function_graph_us": wide_c_graph, "plain_device_us": wide_plain_dev}},
        {"name": "fused_fields_bwd", "route": "cuda", "source": "hpvpinns_tpu_torch/csrc/fused_fields_bwd.cu",
         "replaces": "hpvpinns_tpu/ops/pallas_fields.py:259", "launches": paths["poisson1d_quality pallas"]["fused_fields_bwd"],
         "max_abs_err": bwd_err, "ms": ms7["b2"], "plain_ms": ms7["plain"], "bound_ms": b2_bound[0],
         "bound_by": b2_bound[1], "library_ms": None, "shape": "poisson2d_scaled second, P 16384",
         "device_us": dev7["b2"], "c_function_us": ev7["b2"]},
        {"name": "block_sum", "route": "cuda", "source": "hpvpinns_tpu_torch/csrc/fused_fields_bwd.cu",
         "replaces": "hpvpinns_tpu/ops/pallas_fields.py:328", "launches": paths["poisson1d_quality pallas"]["block_sum"],
         "max_abs_err": sum_err, "ms": ms7["sum"], "plain_ms": ms7["torch.sum"], "bound_ms": sum_bound[0],
         "bound_by": sum_bound[1], "library_ms": ms7["torch.sum"], "shape": f"B2 partials {list(pshape)}",
         "device_us": dev7["sum"], "library_device_us": dev7["torch.sum"]},
    ]
    adv_fwd, adv_bwd = times["advdiff_record"], bwd_times["advdiff_record"]
    adv_sum_rows = adv_bwd[1]
    adv = {  # the advdiff_of_record var_form 0 shapes: P 100, (2,5,5,5,1) tanh, n_dirs 2, second derivatives
        "fused_fields": {"ms": adv_fwd[0], "plain_ms": adv_fwd[1], "device_us": adv_fwd[2], "c_function_graph_us": adv_fwd[3],
                         "bound_ms": bound_ms(*fwd_work((2, 5, 5, 5, 1), 100, 2, True))[0]},
        "fused_fields_bwd": {"ms": adv_bwd[0]["b2"], "plain_ms": adv_bwd[0]["plain"], "device_us": adv_bwd[2]["b2"],
                             "c_function_us": adv_bwd[3]["b2"], "bound_ms": bound_ms(*bwd_work((2, 5, 5, 5, 1), 100, 2))[0]},
        "block_sum": {"ms": adv_bwd[0]["sum"], "plain_ms": adv_bwd[0]["torch.sum"], "device_us": adv_bwd[2]["sum"],
                      "partials": list(adv_sum_rows),
                      "bound_ms": bound_ms(4 * (adv_sum_rows[0] * adv_sum_rows[1] + adv_sum_rows[1]),
                                           adv_sum_rows[0] * adv_sum_rows[1])[0]},
    }
    for k in kernels:
        k["launches_by_path"] = {path: c.get(k["name"], 0) for path, c in paths.items()}
        k["graph_nodes_by_path"] = {path: n.get(k["name"], 0) for path, n in nodes.items()}
        k["advdiff_of_record"] = adv[k["name"]]
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_run:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
