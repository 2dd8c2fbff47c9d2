"""B2's firsts-only resident form on the card: launch shapes, and where one
block's time goes.

    mkdir -p _scratch/parent && git archive b60a35e hpvpinns_tpu_torch/csrc | tar -x -C _scratch/parent
    python3 tools/b2_firsts_probe.py [--parent _scratch/parent/hpvpinns_tpu_torch/csrc] [--no-sweep]
                                     [--variant NAME ...]

At chip_smoke.py's resident firsts shapes (BWD_FIRSTS_CASES without a form
forced, bwd_plan's resident form):

- the sweep: csrc/fused_fields_bwd_firsts.cu's C function at launch shapes
  around bwd_plan's (points a group, warps a block, groups a block), each
  held through the block sum against the plain version (phase 7's
  tolerances), timed alone and with its block sum by CUDA events over 50
  launches, in turns plan, shape, shape, plan; with --variant also copies
  of the kernel built with one change each (VARIANTS: four points a thread,
  gW's tile rows forced, gW's tiles dealt to the threads in order), at the
  plan's launch shape and at one warp a block;
- the stamps: a copy of the kernel's source (and with --parent, of the
  parent checkout's fused_fields_bwd.cu, whose firsts-only mode was the
  second-derivative kernel compiled without the kk streams) built under
  _build/ with a clock64() stamp at the kernel's entry, after every
  __syncthreads() and at its end, written by thread 0 of block 0: the SM
  cycles between stamps, phase by phase, of one block.  The copies are
  built here and never committed; the kernels in csrc/ carry no stamps.

It prints the card (nvidia-smi's name and power limit), one line a shape and
launch shape, the stamps' cycles, and last a JSON object of the numbers.
Needs one CUDA card; imports neither JAX nor the JAX package.
"""

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from hpvpinns_tpu_torch.ops import fused_fields as ff  # noqa: E402
from hpvpinns_tpu_torch.ops.cuda_build import BUILD_DIR, CSRC_DIR, build_library  # noqa: E402

PROBE = """
__device__ long long hp_probe_stamps[1024];
__device__ int hp_probe_n;
#define HP_PROBE_STAMP() do { if (threadIdx.x == 0 && blockIdx.x == 0 && hp_probe_n < 1024) \\
  hp_probe_stamps[hp_probe_n++] = clock64(); } while (0)
extern "C" int hp_probe_take(long long* out) {
  int n = 0;
  cudaMemcpyFromSymbol(&n, hp_probe_n, sizeof(int));
  cudaMemcpyFromSymbol(out, hp_probe_stamps, sizeof(long long) * (n < 1024 ? n : 1024));
  const int zero = 0;
  cudaMemcpyToSymbol(hp_probe_n, &zero, sizeof(int));
  return n;
}
"""


def stamped(src: Path, name: str, end_marks, edits=()) -> ctypes.CDLL:
    """`src` with clock64() stamps (at the kernel's entry, after every
    __syncthreads() and before each of `end_marks`) and the text `edits`
    ((old, new) pairs), built under _build/."""
    out_dir = BUILD_DIR / "probe" / name
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    for h in src.parent.glob("*.cuh"):
        shutil.copy(h, out_dir / h.name)
    text = src.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{src}: no single {old!r} to edit")
        text = text.replace(old, new)
    text = text.replace("#include <cuda_runtime.h>", "#include <cuda_runtime.h>\n" + PROBE, 1)
    text = text.replace("extern __shared__ __align__(16) float smem[];",
                        "extern __shared__ __align__(16) float smem[];\n  HP_PROBE_STAMP();", 1)
    text = re.sub(r"__syncthreads\(\);", "__syncthreads(); HP_PROBE_STAMP();", text)
    for mark in end_marks:
        if text.count(mark) != 1:
            raise RuntimeError(f"{src}: no single {mark!r} to stamp")
        text = text.replace(mark, "HP_PROBE_STAMP();\n" + mark)
    path = out_dir / src.name
    path.write_text(text)
    lib = build_library(f"probe_{name}", [path]).lib
    lib.hp_probe_take.argtypes, lib.hp_probe_take.restype = [ctypes.c_void_p], ctypes.c_int
    return lib


# Copies of csrc/fused_fields_bwd_firsts.cu with one design choice changed:
# (old, new) text edits.
VARIANTS = {
    "kTP=4": [("constexpr int kTP = 2;", "constexpr int kTP = 4;")],
    "TI=4": [("    net.tile[l] = 2;", "    net.tile[l] = 4;")],
    "tiles in order": [("    net.in_order[l] = (dout + 3) / 4 <= 8;", "    net.in_order[l] = true;")],
    "warp tiles": [("    net.in_order[l] = (dout + 3) / 4 <= 8;", "    net.in_order[l] = false;")],
}


def take(lib) -> list:
    buf = np.zeros(1024, dtype=np.int64)
    n = lib.hp_probe_take(buf.ctypes.data)
    return np.diff(buf[:n]).tolist()


def firsts_args(spec, net, X, g, nd, pb, warps, T, dev):
    """The firsts C function's arguments at a launch shape, and its outputs."""
    packed, widths = ff.pack_params(spec, net)
    P = X.shape[0]
    rows = -(-(-(-P // pb)) // T)
    partials = torch.empty((rows, ff._row_pitch(spec.layers)), dtype=torch.float32, device=dev)
    gX = torch.empty_like(X)
    args = (X.data_ptr(), g.data_ptr(), packed.data_ptr(), widths.ctypes.data, spec.n_layers, P, nd, 0,
            ff._ACTIVATION_CODE[spec.activation], pb, warps, T, partials.data_ptr(), gX.data_ptr(), dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream)
    return args, (packed, widths), partials, gX


def checked(name, spec, partials, gX, want, want_x, tol) -> float:
    got = ff.unpack_params(spec, ff.block_sum_kernel(partials))
    torch.cuda.synchronize()
    err = cs.check_close(f"{name} gX", gX, want_x, **tol)
    for l, (a, b) in enumerate(zip(got, want)):
        for k in ("W", "b"):
            err = max(err, cs.check_close(f"{name} g{k}_{l}", a[k], b[k], **tol))
    return err


def shapes_around(plan, layers, nd, P):
    """Launch shapes beside the plan's: other group sizes and warps a block
    whose block fits, and two groups a block where there are groups for it."""
    out = []
    for pb in (16, 8, 4):
        if ff.bwd_smem_bytes(layers, nd, False, pb) > ff.SMEM_PER_BLOCK:
            continue
        for warps in (1, 2, 4):
            for T in (1, 2):
                if T > 1 and (-(-P // pb) < 2 * ff.FWD_SMS or warps != plan.warps_per_block):
                    continue
                shape = (pb, warps, T)
                if shape != (plan.group_points, plan.warps_per_block, plan.tiles_per_block):
                    out.append(shape)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a parent checkout's csrc/ (its firsts-only resident kernel, stamped)")
    ap.add_argument("--no-sweep", action="store_true")
    ap.add_argument("--variant", action="append", default=[], choices=sorted(VARIANTS),
                    help="also time a copy of the kernel with this change")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("b2_firsts_probe: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    from hpvpinns_tpu_torch.models.mlp import use_ieee_fp32_matmuls

    use_ieee_fp32_matmuls()
    dev = torch.device("cuda", 0)
    lib = ff.fused_fields_bwd_kernel.load().lib
    new = stamped(CSRC_DIR / "fused_fields_bwd_firsts.cu", "firsts", ["}\n\nstruct FirstsArgs"])
    old = None
    if a.parent:
        old = stamped(Path(a.parent) / "fused_fields_bwd.cu", "parent",
                      ["}\n\n// out[k] = sum_b partials[b, k], b in a fixed order, in one launch."])
        old.hp_fused_fields_bwd_f32.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    new.hp_fused_fields_bwd_firsts_f32.argtypes = lib.hp_fused_fields_bwd_firsts_f32.argtypes
    variants = {"as built": lib}
    for k, vname in enumerate(a.variant):
        v = stamped(CSRC_DIR / "fused_fields_bwd_firsts.cu", f"variant{k}", [], VARIANTS[vname])
        v.hp_fused_fields_bwd_firsts_f32.argtypes = lib.hp_fused_fields_bwd_firsts_f32.argtypes
        variants[vname] = v
    rng = np.random.default_rng(74)
    report = {"card": smi, "sweep": {}, "stamps": {}}
    for name, layers, act, P, nd, forced in cs.BWD_FIRSTS_CASES:
        plan = ff.bwd_plan(layers, nd, P, second=False)
        if forced or plan.form != "resident":
            continue
        spec, net, X, g = cs.b2_inputs(layers, act, P, nd, rng, dev, second=False)
        tol = cs.WIDE_GRAD_TOL if max(layers) >= 48 else cs.GRAD_TOL
        want, want_x = ff.fields_flat_bwd_reference(spec, net, X, g, nd, second=False)
        base = (plan.group_points, plan.warps_per_block, plan.tiles_per_block)
        # the stamps: one launch of the stamped copies at the plan's shape (and the parent's plan)
        args, keep, partials, gX = firsts_args(spec, net, X, g, nd, *base, dev)
        new.hp_fused_fields_bwd_firsts_f32(*args)
        torch.cuda.synchronize()
        take(new)
        new.hp_fused_fields_bwd_firsts_f32(*args)
        torch.cuda.synchronize()
        report["stamps"][f"{name} this"] = take(new)
        if old is not None:
            tiles = max(1, min(8, -(-P // 16) // 512))
            old_p = torch.empty((-(-(-(-P // 16)) // tiles), partials.shape[1]), dtype=torch.float32, device=dev)
            old_args = args[:9] + (tiles, old_p.data_ptr(), gX.data_ptr()) + args[-2:]
            old.hp_fused_fields_bwd_f32(*old_args)
            torch.cuda.synchronize()
            take(old)
            old.hp_fused_fields_bwd_f32(*old_args)
            torch.cuda.synchronize()
            report["stamps"][f"{name} parent"] = take(old)
        for who in ("this", "parent"):
            st = report["stamps"].get(f"{name} {who}")
            if st:
                print(f"stamps {name} {who}: {len(st)} intervals, {sum(st)} cycles: {st}", flush=True)
        if a.no_sweep:
            continue
        rows = {}
        for vname, vlib in variants.items():
            shapes = shapes_around(plan, layers, nd, P) if vname == "as built" else [(base[0], 1, base[2])]
            for shape in [base] + [sh for sh in shapes if sh != base]:
                args, keep, partials, gX = firsts_args(spec, net, X, g, nd, *shape, dev)
                fn = lambda a=args, f=vlib.hp_fused_fields_bwd_firsts_f32: f(*a)  # noqa: E731
                if fn() != 0:
                    print(f"sweep {name} {vname} {shape}: refused", flush=True)
                    continue
                err = checked(f"sweep {name} {vname} {shape}", spec, partials, gX, want, want_x, tol)
                (sum_args, sum_keep), _ = ff.block_sum_kernel.prepare(partials)
                both = lambda a=args, s=sum_args, f=vlib.hp_fused_fields_bwd_firsts_f32: (f(*a), lib.hp_block_sum_f32(*s))  # noqa: E731
                rows[(vname, shape)] = (fn, both, err, list(partials.shape), sum_keep, keep)
        base_fn, base_both = rows[("as built", base)][0], rows[("as built", base)][1]
        out = {}
        for (vname, shape), (fn, both, err, pshape, *_k) in rows.items():
            ev = [1e3 * cs.cuda_ms(f) for f in (base_fn, fn, fn, base_fn)]
            evb = [1e3 * cs.cuda_ms(f) for f in (base_both, both, both, base_both)]
            out[f"{vname} {shape}"] = {"us": (ev[1] + ev[2]) / 2, "plan_us": (ev[0] + ev[3]) / 2,
                               "with_sum_us": (evb[1] + evb[2]) / 2, "plan_with_sum_us": (evb[0] + evb[3]) / 2,
                               "partials": pshape, "max_abs_err": err}
            plan_mark = " = plan" if (vname, shape) == ("as built", base) else ""
            print(f"sweep {name} {vname}: (points, warps, groups) {shape}{plan_mark}, partials "
                  f"{pshape}, max_abs_err {err:.3e}; C function us/launch (CUDA events, turns plan, this, this, "
                  f"plan) {ev[0]:.2f} {ev[1]:.2f} {ev[2]:.2f} {ev[3]:.2f}; with its block sum {evb[0]:.2f} "
                  f"{evb[1]:.2f} {evb[2]:.2f} {evb[3]:.2f}", flush=True)
        report["sweep"][name] = out
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
