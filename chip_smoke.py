#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py

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
     and the firsts-only gradient against autograd through the
     plain version (rtol 2e-4, atol 1e-5); times both: ms per call over 50
     back-to-back calls (CUDA events; at these sizes the host's launch rate
     bounds it) and device µs per call (torch.profiler, the kernels' own
     time, the wrapper's parameter packing included);
  4. builds poisson2d_scaled twice, deriv_mode "taylor" and "pallas", and
     checks the loss (rtol 1e-5) and gradients (rtol 1e-3, atol 1e-4) agree;
  5. trains poisson2d_scaled under deriv_mode "pallas" for 200 Adam steps
     (the main path): the loss must be finite and fall, and the kernel must
     have launched at least 200 times;
  6. trains poisson2d_quality (Adam only) for 500 steps and prints the loss
     and the rel-L2 error on the 201 x 201 test grid;
  7. holds B2 + block sum against its plain version (autograd through the
     plain forward) at the slice's shapes: gW, gb and gX within rtol 2e-4 /
     atol 1e-5 (5e-4 / 1e-4 at width 48), two runs bit-identical, and the
     block sum against torch's column sum; times B2, the block sum, both
     together and the plain version as phase 3 does;
  8. checks the loss (rtol 1e-5) and gradients (rtol 1e-3, atol 1e-4) under
     "taylor" and "pallas" for poisson1d_of_record forms 1/2/3 and
     poisson2d_quality forms 0 and "2c";
  9. trains poisson1d_of_record under "pallas" for its 1,001 Adam steps (the
     second slice's main path): the loss must fall, B1, B2 and the block sum
     must each launch at least 1,001 times, and the rel-L2 error must be
     within 20% of the JAX package's f32 row, 0.2539;
 10. profiles one eager training step under "taylor" and "pallas" at
     poisson1d_of_record, poisson2d_scaled var_form 0 and var_form 1:
     steps/s of 200 Adam steps in turns "taylor", "pallas", "pallas",
     "taylor"; the median forward, backward and Adam ms of 50 steps, each
     part followed by a device sync; and, from torch.profiler over 20 steps,
     the kernels' device µs, kernel launches, busy share and five largest
     kernels per step.  On poisson2d_scaled var_form 0 under "pallas" the
     loss must fall and B1, B2 and the block sum must each launch at least
     200 times.

The tolerances are those of tests/test_pallas_fields.py.  It exits non-zero
at the first failure, and when no CUDA device is present.  Its last two
lines are a JSON summary of the kernels and `{"ok": true, "device": ...}`.
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
WIDE_GRAD_TOL = dict(rtol=5e-4, atol=1e-4)  # width 48 (tests/test_pallas_fields.py:132-147)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a GPU only", file=sys.stderr)
        return 1
    import hpvpinns_tpu_torch as hv
    from hpvpinns_tpu_torch.models.mlp import MLP, init_mlp, use_ieee_fp32_matmuls
    from hpvpinns_tpu_torch.ops.fused_fields import (
        block_sum_kernel,
        block_sum_reference,
        fields_flat,
        fields_flat_bwd_reference,
        fields_flat_reference,
        fused_fields_bwd,
        fused_fields_bwd_kernel,
        fused_fields_kernel,
    )
    from hpvpinns_tpu_torch.problems.base import parameters
    from hpvpinns_tpu_torch.training.trainer import make_optimizer

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

    # 3. kernel vs plain on the card
    cases = [  # (name, layers, activation, P, n_dirs, second)
        ("scaled", (2, 20, 20, 20, 1), "tanh", 16384, 2, False),
        ("quality", (2, 48, 48, 48, 48, 1), "tanh", 4096, 2, False),
        ("sin_d1_second", (1, 20, 20, 20, 1), "sin", 1000, 1, True),
        ("sin_d3_second", (3, 48, 48, 48, 1), "sin", 1003, 3, True),
        # the second-derivative shapes that phases 8-10 train on
        ("p1d_record", (1, 20, 20, 20, 20, 1), "sin", 80, 1, True),
        ("p1d_quality", (1, 30, 30, 30, 1), "sin", 240, 1, True),
        ("p2d_scaled_second", (2, 20, 20, 20, 1), "tanh", 16384, 2, True),
        ("p2d_quality_second", (2, 48, 48, 48, 48, 1), "tanh", 4096, 2, True),
    ]
    rng = np.random.default_rng(0)
    max_err = 0.0
    times = {}
    for name, layers, act, P, nd, second in cases:
        spec = MLP(layers=layers, activation=act)
        params = init_mlp(spec, torch.Generator().manual_seed(1), device=dev)
        X = torch.as_tensor(rng.uniform(-1.0, 1.0, (P, layers[0])), dtype=torch.float32, device=dev)
        with torch.no_grad():
            got = fused_fields_kernel(spec, params, X, nd, second)
            want = fields_flat_reference(spec, params, X, nd, second)
        torch.cuda.synchronize()
        err = check_close(f"{name} fields", got, want, **FIELD_TOL)
        max_err = max(max_err, err)
        line = f"phase 3 {name}: layers {layers} {act} P={P} n_dirs={nd} second={second} max_abs_err {err:.3e}"
        if not second:
            g = torch.as_tensor(rng.standard_normal(got.shape), dtype=torch.float32, device=dev)
            leaves = [t for layer in params for t in (layer["W"], layer["b"])]
            gk = torch.autograd.grad((fields_flat(spec, params, X, nd, False) * g).sum(), leaves)
            gr = torch.autograd.grad((fields_flat_reference(spec, params, X, nd, False) * g).sum(), leaves)
            gerr = max(check_close(f"{name} grad {i}", a, b, **GRAD_TOL) for i, (a, b) in enumerate(zip(gk, gr)))
            line += f", grad max_abs_err {gerr:.3e}"
        with torch.no_grad():
            kernel = lambda: fused_fields_kernel(spec, params, X, nd, second)
            plain = lambda: fields_flat_reference(spec, params, X, nd, second)
            p1, k1, k2, p2 = cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel), cuda_ms(plain)
            k_dev, p_dev = device_us(kernel), device_us(plain)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        line += f"; ms/call kernel {k1:.4f} {k2:.4f} plain {p1:.4f} {p2:.4f}"
        line += "; device us/call " + (
            f"kernel {k_dev:.2f} plain {p_dev:.2f}" if k_dev and p_dev else "not measured (no device events)"
        )
        print(line, flush=True)

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

    # 5. the main path: train poisson2d_scaled on the kernel
    tcfg = dataclasses.replace(cfg.train, iterations=200, check_every=10)
    fused_fields_kernel.launches = 0
    res = hv.train(pp, cfg=tcfg, params=params, verbose=False)
    launches = fused_fields_kernel.launches
    paths = {"poisson2d_scaled var_form 1": {"fused_fields": launches}}
    loss_hist = res.history["loss"]
    if not np.all(np.isfinite(loss_hist)) or not loss_hist[-1] < loss_hist[0]:
        fail(f"poisson2d_scaled loss did not fall: {loss_hist.tolist()}")
    if launches < tcfg.iterations:
        fail(f"kernel launched {launches} times in {tcfg.iterations} steps")
    u = hv.predict(pp, res.params)
    if u.shape != (pp.test_points.shape[0], 1) or not np.all(np.isfinite(u)):
        fail(f"prediction has shape {u.shape} or non-finite values")
    print(
        f"phase 5 train poisson2d_scaled pallas: {res.iterations_run} steps, loss "
        f"{loss_hist[0]:.6e} -> {loss_hist[-1]:.6e}, {res.steps_per_sec:.1f} steps/s "
        f"(host clock, chunks end in a device sync, first chunk excluded), kernel launches {launches}",
        flush=True,
    )

    # 6. poisson2d_quality, Adam only
    qcfg = hv.poisson2d_quality()
    qcfg = dataclasses.replace(
        qcfg, deriv_mode="pallas",
        train=dataclasses.replace(qcfg.train, iterations=500, lbfgs_iterations=0, check_every=100),
    )
    pq = hv.build(qcfg, device=dev)
    rq = hv.train(pq, verbose=False)
    ev = hv.evaluate_problem(pq, rq.params)
    if not all(math.isfinite(v) for v in ev.values()):
        fail(f"poisson2d_quality evaluation not finite: {ev}")
    print(
        f"phase 6 train poisson2d_quality pallas (Adam only): {rq.iterations_run} steps, loss "
        f"{rq.history['loss'][-1]:.6e}, rel_l2 {ev['rel_l2']:.4e}, {rq.steps_per_sec:.1f} steps/s",
        flush=True,
    )

    # 7. B2 and its block sum against the plain backward
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
        partials, _ = fused_fields_bwd_kernel(spec, net, X, g, nd)
        serr = check_close(f"{name} block sum", block_sum_kernel(partials), block_sum_reference(partials), **SUM_TOL)
        bwd_err, sum_err = max(bwd_err, err), max(sum_err, serr)
        fns = {
            "plain": lambda: fields_flat_bwd_reference(spec, net, X, g, nd),
            "b2": lambda: fused_fields_bwd_kernel(spec, net, X, g, nd),
            "sum": lambda: block_sum_kernel(partials),
            "b2+sum": lambda: fused_fields_bwd(spec, net, X, g, nd),
            "torch.sum": lambda: partials.sum(dim=0),
        }
        ms = {k: cuda_ms(f) for k, f in fns.items()}
        ms["plain"] = (ms["plain"] + cuda_ms(fns["plain"])) / 2  # plain first and last
        dev_us = {k: device_us(f) for k, f in fns.items()}
        bwd_times[name] = (ms, partials.shape)
        print(
            f"phase 7 {name}: layers {layers} {act} P={P} n_dirs={nd} blocks={partials.shape[0]} "
            f"max_abs_err {err:.3e} (block sum {serr:.3e}), bit-identical repeat; ms/call "
            + " ".join(f"{k} {v:.4f}" for k, v in ms.items()) + "; device us/call "
            + " ".join(f"{k} {v:.2f}" if v else f"{k} not measured" for k, v in dev_us.items()),
            flush=True,
        )

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

    # 9. the second slice's main path: poisson1d_of_record on B1 + B2
    c1 = dataclasses.replace(hv.poisson1d_of_record(), deriv_mode="pallas")
    p1 = hv.build(c1, device=dev)
    for k in (fused_fields_kernel, fused_fields_bwd_kernel, block_sum_kernel):
        k.launches = 0
    r1 = hv.train(p1, verbose=False)
    counts = {"fused_fields": fused_fields_kernel.launches, "fused_fields_bwd": fused_fields_bwd_kernel.launches,
              "block_sum": block_sum_kernel.launches}
    paths["poisson1d_of_record"] = counts
    hist = r1.history["loss"]
    if r1.iterations_run != c1.train.iterations or not np.all(np.isfinite(hist)) or not hist[-1] < hist[0]:
        fail(f"poisson1d_of_record: {r1.iterations_run} steps, loss did not fall: {hist[[0, -1]].tolist()}")
    if min(counts.values()) < c1.train.iterations:
        fail(f"poisson1d_of_record: kernel launches {counts} in {c1.train.iterations} steps")
    ev1 = hv.evaluate_problem(p1, r1.params)
    if not abs(ev1["rel_l2"] - JAX_P1D_RECORD_REL_L2) <= 0.2 * JAX_P1D_RECORD_REL_L2:
        fail(f"poisson1d_of_record rel-L2 {ev1['rel_l2']:.4e} is not within 20% of the JAX row {JAX_P1D_RECORD_REL_L2}")
    print(
        f"phase 9 train poisson1d_of_record pallas: {r1.iterations_run} steps, loss {hist[0]:.6e} -> {hist[-1]:.6e}, "
        f"rel_l2 {ev1['rel_l2']:.4e} (JAX f32 row {JAX_P1D_RECORD_REL_L2}), {r1.steps_per_sec:.1f} steps/s, "
        f"launches {counts}",
        flush=True,
    )

    # 10. one eager step under "taylor" and "pallas" at three configurations;
    # poisson2d_scaled var_form 0 is the path that trains on B2 at n_dirs 2
    for label, c in (
        ("poisson1d_of_record", hv.poisson1d_of_record()),
        ("poisson2d_scaled var_form 0", dataclasses.replace(hv.poisson2d_scaled(), var_form=0)),
        ("poisson2d_scaled var_form 1", hv.poisson2d_scaled()),
    ):
        tc = dataclasses.replace(c.train, iterations=200, check_every=10, lbfgs_iterations=0, threshold=None)
        probs = {m: hv.build(dataclasses.replace(c, deriv_mode=m), device=dev) for m in ("taylor", "pallas")}
        sps = {"taylor": [], "pallas": []}
        for turn, mode in enumerate(("taylor", "pallas", "pallas", "taylor")):
            for k in (fused_fields_kernel, fused_fields_bwd_kernel, block_sum_kernel):
                k.launches = 0
            r0 = hv.train(probs[mode], cfg=tc, verbose=False)
            sps[mode].append(r0.steps_per_sec)
            if turn == 1 and label == "poisson2d_scaled var_form 0":
                counts0 = {"fused_fields": fused_fields_kernel.launches,
                           "fused_fields_bwd": fused_fields_bwd_kernel.launches, "block_sum": block_sum_kernel.launches}
                paths[label] = counts0
                h0 = r0.history["loss"]
                if not np.all(np.isfinite(h0)) or not h0[-1] < h0[0]:
                    fail(f"{label} loss did not fall: {h0[[0, -1]].tolist()}")
                if min(counts0.values()) < tc.iterations:
                    fail(f"{label}: kernel launches {counts0} in {tc.iterations} steps")
                print(f"phase 10 {label} pallas: loss {h0[0]:.6e} -> {h0[-1]:.6e}, launches {counts0}", flush=True)
        for mode, prob in probs.items():
            prm = prob.init_params(torch.Generator().manual_seed(c.train.seed))
            opt = make_optimizer(tc, prm)
            fwd, bwd, adam = part_times(prob, prm, opt)
            prof = step_profile(prob, prm, opt)
            print(
                f"phase 10 {label} {mode}: steps/s {sps[mode][0]!r} {sps[mode][1]!r} (200 steps per turn, turns "
                f"t p p t); fwd / bwd / Adam ms {fwd!r} / {bwd!r} / {adam!r}; device us/step "
                f"{prof['device_us']!r}; launches/step {prof['launches']!r}; busy {prof['busy']!r}; top "
                + "; ".join(f"{name} {us!r}" for name, us in prof["top"]),
                flush=True,
            )

    ms, plain_ms = times["scaled"]
    ms7, pshape = bwd_times["p2d_scaled"]
    b1_bound = bound_ms(*fwd_work((2, 20, 20, 20, 1), 16384, 2, False))
    b2_bound = bound_ms(*bwd_work((2, 20, 20, 20, 1), 16384, 2))
    sum_bound = bound_ms(4 * (pshape[0] * pshape[1] + pshape[1]), pshape[0] * pshape[1])
    kernels = [
        {"name": "fused_fields", "route": "cuda", "source": "hpvpinns_tpu_torch/csrc/fused_fields.cu",
         "replaces": "hpvpinns_tpu/ops/pallas_fields.py:48", "launches": launches, "max_abs_err": max_err,
         "ms": ms, "plain_ms": plain_ms, "bound_ms": b1_bound[0], "bound_by": b1_bound[1], "library_ms": None,
         "shape": "poisson2d_scaled firsts, P 16384"},
        {"name": "fused_fields_bwd", "route": "cuda", "source": "hpvpinns_tpu_torch/csrc/fused_fields_bwd.cu",
         "replaces": "hpvpinns_tpu/ops/pallas_fields.py:259", "launches": counts["fused_fields_bwd"],
         "max_abs_err": bwd_err, "ms": ms7["b2"], "plain_ms": ms7["plain"], "bound_ms": b2_bound[0],
         "bound_by": b2_bound[1], "library_ms": None, "shape": "poisson2d_scaled second, P 16384"},
        {"name": "block_sum", "route": "cuda", "source": "hpvpinns_tpu_torch/csrc/fused_fields_bwd.cu",
         "replaces": "hpvpinns_tpu/ops/pallas_fields.py:328", "launches": counts["block_sum"],
         "max_abs_err": sum_err, "ms": ms7["sum"], "plain_ms": ms7["torch.sum"], "bound_ms": sum_bound[0],
         "bound_by": sum_bound[1], "library_ms": ms7["torch.sum"], "shape": f"B2 partials {list(pshape)}"},
    ]
    for k in kernels:
        k["launches_by_path"] = {path: c.get(k["name"], 0) for path, c in paths.items()}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
