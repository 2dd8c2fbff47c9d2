"""B2's retired wide form against the layered form that took its networks,
on the card.

The wide form (one kernel walking tiles of 16 points, each block's stash in
a slot of device memory) is no longer in the port; this builds it from the
csrc/ of a checkout that still has it, for instance the commit before its
removal:

    mkdir -p _scratch/before && git archive f303918 hpvpinns_tpu_torch/csrc | tar -x -C _scratch/before
    python3 tools/b2_retired_wide.py _scratch/before/hpvpinns_tpu_torch/csrc

At chip_smoke.py's MANY_INPUT_CASES (networks of more than three inputs,
the only ones bwd_plan gave the wide form by default) it holds the wide form
against B2's plain version (WIDE_GRAD_TOL, after this checkout's block sum)
and times the two C functions alone by CUDA events over 50 launches, in
turns wide, layered, layered, wide, beside the bound.  It prints the card
(nvidia-smi's name and power limit), one line a shape, and last a JSON
object of the numbers.  Needs one CUDA card; imports neither JAX nor the JAX
package.
"""

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def load_wide(src_dir: str):
    """The checkout's B2 library, built under another name, with the wide
    form's C functions' argument types set."""
    from hpvpinns_tpu_torch.ops.cuda_build import build_library

    lib = build_library("fused_fields_bwd_retired", [Path(src_dir) / "fused_fields_bwd.cu",
                                                     Path(src_dir) / "fused_fields_bwd_layered.cu"]).lib
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    run, scratch_bytes = lib.hp_fused_fields_bwd_wide_f32, lib.hp_fused_fields_bwd_wide_scratch_bytes
    run.argtypes, run.restype = [vp] * 4 + [i32] * 5 + [vp] * 3 + [i32, vp], i32
    scratch_bytes.argtypes, scratch_bytes.restype = [i32] * 4, ctypes.c_longlong
    return run, scratch_bytes


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("usage: python3 tools/b2_retired_wide.py CHECKOUT_CSRC (on a CUDA card)", file=sys.stderr)
        return 1
    from hpvpinns_tpu_torch.models.mlp import use_ieee_fp32_matmuls
    from hpvpinns_tpu_torch.ops.fused_fields import (
        _ACTIVATION_CODE,
        BWD_BLOCKS,
        BWD_MAX_TILES,
        BWD_TILE_POINTS,
        block_sum_kernel,
        bwd_plan,
        fields_flat_bwd_reference,
        fused_fields_bwd_layered_kernel,
        pack_params,
        unpack_params,
    )

    use_ieee_fp32_matmuls()
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)
    run, scratch_bytes = load_wide(sys.argv[1])
    stream = torch.cuda.current_stream(dev).cuda_stream
    rng = np.random.default_rng(156)
    out = {}
    for name, layers, act, P, nd in cs.MANY_INPUT_CASES:
        spec, net, X, g = cs.b2_inputs(layers, act, P, nd, rng, dev)
        # the wide form's plan: T tiles a block keep at least BWD_BLOCKS blocks, at most BWD_MAX_TILES
        n_tiles = -(-P // BWD_TILE_POINTS)
        tiles = max(1, min(BWD_MAX_TILES, n_tiles // BWD_BLOCKS))
        n_blocks = -(-n_tiles // tiles)
        wide_scratch = scratch_bytes(max(layers[:-1]), len(layers) - 1, nd, n_blocks)
        scratch = torch.empty(wide_scratch // 4, dtype=torch.float32, device=dev)
        partials = torch.empty((n_blocks, bwd_plan(layers, nd, P).row_pitch), dtype=torch.float32, device=dev)
        gX = torch.empty_like(X)
        packed, widths = pack_params(spec, net)
        args = (X.data_ptr(), g.data_ptr(), packed.data_ptr(), widths.ctypes.data, spec.n_layers, P, nd,
                _ACTIVATION_CODE[act], tiles, scratch.data_ptr(), partials.data_ptr(), gX.data_ptr(), 0, stream)

        def wide(a=args):
            if run(*a) != 0:
                cs.fail(f"{name}: the wide form did not launch")

        wide()
        got = unpack_params(spec, block_sum_kernel(partials))
        want, want_x = fields_flat_bwd_reference(spec, net, X, g, nd)
        err = cs.check_close(f"{name} wide gX", gX, want_x, **cs.WIDE_GRAD_TOL)
        for l, (a, b) in enumerate(zip(got, want)):
            for k in ("W", "b"):
                err = max(err, cs.check_close(f"{name} wide g{k}_{l}", a[k], b[k], **cs.WIDE_GRAD_TOL))
        (la, *keep), _, _ = fused_fields_bwd_layered_kernel.prepare(spec, net, X, g, nd)
        lay = lambda a=la: fused_fields_bwd_layered_kernel.launch(*a)  # noqa: E731
        ev = [1e3 * cs.cuda_ms(f) for f in (wide, lay, lay, wide)]
        bound, by = cs.bound_ms(*cs.bwd_work(layers, P, nd))
        w_us, l_us = (ev[0] + ev[3]) / 2, (ev[1] + ev[2]) / 2
        plan = bwd_plan(layers, nd, P)
        out[name] = {"layers": list(layers), "P": P, "n_dirs": nd, "wide_us": w_us, "layered_us": l_us,
                     "turns_us": ev, "wide_max_abs_err": err, "bound_ms": bound, "bound_by": by,
                     "wide_scratch_bytes": wide_scratch, "layered_scratch_bytes": plan.scratch_bytes,
                     "layered_chunks": -(-P // plan.chunk_points)}
        print(f"{name}: layers {layers} {act} P={P} n_dirs={nd}: the wide form ({n_blocks} blocks x {tiles} tiles, "
              f"scratch {wide_scratch} B) max_abs_err {err:.3e} against the plain version (rtol "
              f"{cs.WIDE_GRAD_TOL['rtol']} atol {cs.WIDE_GRAD_TOL['atol']}); the layered form in "
              f"{out[name]['layered_chunks']} chunk(s), scratch {plan.scratch_bytes} B; C functions us/launch (CUDA "
              f"events, 50 launches) in turns wide, layered, layered, wide {ev[0]:.2f} {ev[1]:.2f} {ev[2]:.2f} "
              f"{ev[3]:.2f} (layered / wide {l_us / w_us:.3f}); bound {1e3 * bound:.3f} us ({by})", flush=True)
        del scratch, partials
    print(json.dumps({"wide_against_layered": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
