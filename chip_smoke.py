#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py

Run from the root of the repository.  It imports `hpvpinns_tpu_torch` (never
JAX or `hpvpinns_tpu`), builds the fused field kernel csrc/fused_fields.cu
with nvcc for sm_90a, and then, one line per phase:

  1. prints the card (nvidia-smi name and power limit), torch/CUDA versions
     and both TF32 flags;
  2. builds the kernel and prints the build seconds and ptxas's report;
  3. holds the kernel against its plain PyTorch version on the card, at the
     slice's shapes and at ragged sin shapes with second derivatives
     (rtol 2e-5, atol 1e-6), and the gradient against autograd through the
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
     and the rel-L2 error on the 201 x 201 test grid.

The tolerances are those of tests/test_pallas_fields.py.  It exits non-zero
at the first failure, and when no CUDA device is present.  Its last two
lines are a JSON summary of the kernel and `{"ok": true, "device": ...}`.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys

import numpy as np
import torch

FIELD_TOL = dict(rtol=2e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=1e-5)
TIMED_CALLS = 50


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a GPU only", file=sys.stderr)
        return 1
    import hpvpinns_tpu_torch as hv
    from hpvpinns_tpu_torch.models.mlp import MLP, init_mlp, use_ieee_fp32_matmuls
    from hpvpinns_tpu_torch.ops.fused_fields import (
        fields_flat,
        fields_flat_reference,
        fused_fields_kernel,
    )

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

    # 2. build
    built = fused_fields_kernel.load()
    ptxas = [ln.strip() for ln in built.log.splitlines() if "registers" in ln or "spill" in ln]
    print(f"phase 2 build: {built.path.name} in {built.build_seconds:.1f} s", flush=True)
    for ln in ptxas:
        print(f"  ptxas {ln}", flush=True)

    # 3. kernel vs plain on the card
    cases = [  # (name, layers, activation, P, n_dirs, second)
        ("scaled", (2, 20, 20, 20, 1), "tanh", 16384, 2, False),
        ("quality", (2, 48, 48, 48, 48, 1), "tanh", 4096, 2, False),
        ("sin_d1_second", (1, 20, 20, 20, 1), "sin", 1000, 1, True),
        ("sin_d3_second", (3, 48, 48, 48, 1), "sin", 1003, 3, True),
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

    ms, plain_ms = times["scaled"]
    kernels = [{
        "name": "fused_fields",
        "route": "cuda",
        "source": "hpvpinns_tpu_torch/csrc/fused_fields.cu",
        "replaces": "hpvpinns_tpu/ops/pallas_fields.py:48",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
