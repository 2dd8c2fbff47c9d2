"""Command-line interface.

Counterpart of hpvpinns_tpu/cli.py: the same subcommands, flags, presets
and one-line JSON summaries, calling the port's modules.  The reference has
no CLI — hyperparameters are module constants edited in place
(Poisson-1D.py:231-240 etc.).  Here the three configurations of record are
shipped presets, overridable per flag:

    python -m hpvpinns_tpu_torch run poisson1d --plots --outdir results/p1d
    python -m hpvpinns_tpu_torch run poisson1d --grid -1,-0.1,0.1,1 --iterations 5000
    python -m hpvpinns_tpu_torch run poisson2d --scheme PINNs
    python -m hpvpinns_tpu_torch run advdiff --iterations 3000 --record out/adv
    python -m hpvpinns_tpu_torch run poisson1d --device cpu  # on the CPU
    python -m hpvpinns_tpu_torch presets

Every command that builds a problem or loads an artifact runs on the GPU
unless --device names another device (e.g. --device cpu); with no CUDA
device and no --device it raises.  --mesh on `run` and `march` shards the
elements over a mesh of ranks (parallel/sharding.py): alone, a one-rank
mesh; under torchrun, the world, one rank a card (NCCL), or on the CPU
with --device cpu (gloo); only rank 0 prints and writes:

    torchrun --nproc_per_node 2 -m hpvpinns_tpu_torch run poisson2d --mesh --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from hpvpinns_tpu_torch import config as cfgmod


def _add_train_flags(p: argparse.ArgumentParser):
    p.add_argument("--iterations", type=int, help="Adam iterations")
    p.add_argument("--lbfgs-iterations", type=int, help="L-BFGS phase iterations")
    p.add_argument("--gn-iterations", type=int, dest="gn_iterations",
                   help="Gauss-Newton/LM polish phase (accepted steps; "
                   "second-order residual optimizer, past the first-order "
                   "optimizers' plateau)")
    p.add_argument("--gn-solve", dest="gn_solve",
                   choices=("normal", "host", "qr", "cg", "lsqr"),
                   help="LM step kernel: damped normal equations, the same "
                   "in float64 (default below float64), QR of the augmented "
                   "system, matrix-free CG on jvp/vjp products (O(M+P) "
                   "memory), or matrix-free LSQR (cond(J)-stable twin of qr)")
    p.add_argument("--gn-cg-tol", type=float, dest="gn_cg_tol",
                   help="matrix-free LM kernels: relative forcing tolerance")
    p.add_argument("--gn-cg-maxiter", type=int, dest="gn_cg_maxiter",
                   help="matrix-free LM kernels: iteration cap "
                   "(default min(n_params, 2000))")
    p.add_argument("--gn-jac-chunk", type=int, dest="gn_jac_chunk",
                   help="dense LM kernels: vmapped passes per Jacobian "
                   "block, for large meshes where the whole-J vmap does "
                   "not fit (config.TrainConfig.gn_jac_chunk)")
    p.add_argument("--polish-f64", type=int, dest="polish_f64", metavar="N",
                   help="after training, run N accepted float64 LM steps in "
                   "this process on the problem's device "
                   "(training/hybrid.py::polish_f64): recovers the float64 "
                   "digits a float32 run cannot represent; reported under "
                   "summary['polish_f64'], exported params are the polished "
                   "ones")
    p.add_argument("--polish-solve", dest="polish_solve", default="normal",
                   choices=("normal", "qr", "cg", "lsqr"),
                   help="LM step kernel for --polish-f64 (float64: normal "
                   "is the right default; cg/lsqr stay matrix-free)")
    p.add_argument("--learning-rate", type=float)
    p.add_argument("--threshold", type=float, help="early-stop loss threshold")
    p.add_argument("--seed", type=int)
    p.add_argument("--checkpoint-dir")
    p.add_argument("--checkpoint-every", type=int)


def _add_device_flag(p: argparse.ArgumentParser):
    p.add_argument("--device", default=None,
                   help="torch device to build and run on (default: the GPU, "
                   "'cuda'; 'cpu' for the CPU)")


def _var_form_arg(s: str):
    """int forms plus the corrected twice-IBP 2D form '2c'."""
    return s if s == "2c" else int(s)


def _grid_arg(s: str):
    """Comma-separated non-uniform element boundaries."""
    return tuple(float(v) for v in s.split(","))


def _add_common_flags(p: argparse.ArgumentParser):
    p.add_argument(
        "--preset", choices=["record", "quality", "precision"], default="record",
        help="'record' = the reference configuration of record; 'quality' = "
        "the best time-to-accuracy configuration (Adam, then L-BFGS); "
        "'precision' = the Gauss-Newton accuracy frontier, shipped for every "
        "family (config.py)",
    )
    p.add_argument("--var-form", type=_var_form_arg, dest="var_form")
    p.add_argument("--dtype", choices=["float32", "float64", "bfloat16"])
    p.add_argument("--matmul-precision", choices=["default", "high", "highest"],
                   dest="matmul_precision",
                   help="the network's float32 products: 'highest' (IEEE fp32, "
                   "the accuracy default), 'high' and 'default' (TF32 on the "
                   "GPU; models/mlp.py)")
    p.add_argument("--layers", type=str, help="comma-separated widths, e.g. 1,20,20,1")
    p.add_argument("--n-quad", type=int, dest="n_quad")
    p.add_argument("--outdir", default=None, help="artifact directory")
    p.add_argument("--gap", action="store_true",
                   help="after training, print the VPINN-gap report: network vs "
                   "exact vs the spectral-element direct solve of the same weak "
                   "form (galerkin.vpinn_gap_*; float64 on the host)")
    p.add_argument("--plots", action="store_true", help="write the reference plot set")
    p.add_argument("--record", metavar="PATH", help="write a results record (.npz/.mat)")
    p.add_argument("--record-params", action="store_true",
                   help="include the trained parameter leaves in --record "
                   "(restorable via utils.records.params_from_record)")
    p.add_argument("--init-record", metavar="PATH", dest="init_record",
                   help="warm-start training from the parameters stored in a "
                   "record written with --record-params (same config family; "
                   "incompatible with --seeds > 1)")
    p.add_argument("--export", metavar="DIR", dest="export_dir",
                   help="write a self-contained serving artifact of the "
                   "trained ansatz (torch.export: model.pt2 + meta.json, "
                   "cpu+cuda platforms, symbolic batch; load with "
                   "`python -m hpvpinns_tpu_torch serve DIR`)")
    p.add_argument("--mesh", action="store_true", help="shard elements over all devices")
    p.add_argument("--seeds", type=int, default=None,
                   help="train N seeds as one vmapped ensemble (Adam phase; "
                   "reports per-seed metrics + best member)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--trace-out", metavar="PATH", dest="trace_out",
                   help="record the program's spans, each chunk's device "
                   "interval and the captured graphs' counters "
                   "(utils/profiling.py) and write them to PATH as "
                   "Chrome-trace JSON (Perfetto); on a mesh rank r > 0 "
                   "writes PATH.rank<r>")
    _add_train_flags(p)
    _add_device_flag(p)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="hpvpinns_tpu_torch", description=__doc__)
    sub = ap.add_subparsers(dest="command", required=True)

    run = sub.add_parser("run", help="train a problem preset")
    runsub = run.add_subparsers(dest="problem", required=True)

    p1 = runsub.add_parser("poisson1d", help="1D Poisson hp-VPINN (main/Poisson-1D)")
    p1.add_argument("--n-elements", type=int, dest="n_elements")
    p1.add_argument("--grid", type=str, help="comma-separated element boundaries")
    p1.add_argument("--n-test", type=int, dest="n_test")
    p1.add_argument("--lossb-weight", type=float, dest="lossb_weight")
    p1.add_argument("--hard-bc", action="store_const", const=True, default=None,
                    dest="hard_bc", help="lifted ansatz: boundary exact by construction")
    p1.add_argument("--activation")
    _add_common_flags(p1)

    p2 = runsub.add_parser("poisson2d", help="2D Poisson hp-VPINN / PINN (main/Poisson-2D)")
    p2.add_argument("--scheme", choices=["VPINNs", "PINNs"])
    p2.add_argument("--hard-bc", action="store_const", const=True, default=None,
                    dest="hard_bc", help="lifted ansatz: boundary exact by construction")
    p2.add_argument("--n-elements-x", type=int, dest="n_elements_x")
    p2.add_argument("--n-elements-y", type=int, dest="n_elements_y")
    p2.add_argument("--grid-x", type=_grid_arg, dest="grid_x",
                    help="non-uniform x element boundaries, e.g. -1,-0.1,0.1,1")
    p2.add_argument("--grid-y", type=_grid_arg, dest="grid_y")
    p2.add_argument("--n-test-x", type=int, dest="n_test_x")
    p2.add_argument("--n-test-y", type=int, dest="n_test_y")
    p2.add_argument("--n-bound", type=int, dest="n_bound")
    p2.add_argument("--n-residual", type=int, dest="n_residual")
    _add_common_flags(p2)

    p3d = runsub.add_parser("poisson3d", help="3D Poisson hp-VPINN (beyond reference)")
    for flag in ("x", "y", "z"):
        p3d.add_argument(f"--n-elements-{flag}", type=int, dest=f"n_elements_{flag}")
        p3d.add_argument(f"--n-test-{flag}", type=int, dest=f"n_test_{flag}")
    p3d.add_argument("--n-bound", type=int, dest="n_bound")
    p3d.add_argument("--hard-bc", action="store_const", const=True, default=None,
                     dest="hard_bc", help="lifted ansatz: all six Dirichlet faces exact")
    _add_common_flags(p3d)

    p3 = runsub.add_parser("advdiff", help="inverse advection-diffusion (main/AdvDiff-Identification)")
    p3.add_argument("--n-elements-x", type=int, dest="n_elements_x")
    p3.add_argument("--n-elements-t", type=int, dest="n_elements_t")
    p3.add_argument("--grid-x", type=_grid_arg, dest="grid_x",
                    help="non-uniform x element boundaries, e.g. -1,0.5,0.9,1")
    p3.add_argument("--grid-t", type=_grid_arg, dest="grid_t")
    p3.add_argument("--n-test-x", type=int, dest="n_test_x")
    p3.add_argument("--n-test-t", type=int, dest="n_test_t")
    p3.add_argument("--velocity", type=float)
    p3.add_argument("--gamma", type=float)
    p3.add_argument("--hard-bc", action="store_const", const=True, default=None,
                    dest="hard_bc", help="lifted space-time ansatz: IC/BC exact by construction")
    p3.add_argument("--epsilon-init", type=float, dest="epsilon_init")
    p3.add_argument("--epsilon-model", choices=["scalar", "quadratic", "mlp"],
                    dest="epsilon_model",
                    help="scalar eps (reference parity), quadratic eps(x) field, or a "
                    "neural eps(x) field (pair with --epsilon-reg)")
    p3.add_argument("--epsilon-reg", type=float, dest="epsilon_reg",
                    help="Tikhonov smoothness penalty for FIELD eps models")
    p3.add_argument("--forward", action="store_true", help="freeze epsilon at truth")
    p3.add_argument("--layer-feature", action="store_const", const=True, default=None,
                    dest="layer_feature",
                    help="append the outflow boundary-layer profile exp(V (x - x_out)/eps_true) "
                    "as an extra network input — the fix for the family's forward "
                    "max-abs limiter (requires --forward: the feature uses the TRUE eps)")
    p3.add_argument("--layer-feature-scale", type=float, dest="layer_feature_scale",
                    help="layer-width override for --layer-feature (default eps_true/|V|)")
    p3.add_argument("--identify-velocity", action="store_const", const=True, default=None,
                    dest="velocity_trainable", help="ALSO identify the advection velocity")
    p3.add_argument("--velocity-model", choices=["scalar", "linear", "quadratic"],
                    dest="velocity_model",
                    help="shape of the trainable velocity: scalar or polynomial field V(x)")
    p3.add_argument("--manufactured-velocity", dest="manufactured_velocity", metavar="C0,C1[,C2]",
                    help="pose the FORCED manufactured problem whose true velocity is the "
                    "polynomial c0 + c1 x (+ c2 x^2): data/forcing/exact from "
                    "problems.advdiff.make_manufactured (the analytic benchmark solution "
                    "only exists for constant V)")
    p3.add_argument("--manufactured-profile", choices=["sin", "cos"], default=None,
                    dest="manufactured_profile",
                    help="spatial profile of the manufactured solution; 'cos' has "
                    "nonvanishing u_xx everywhere (the observable choice for "
                    "coefficient-FIELD inversion)")
    p3.add_argument("--manufactured-epsilon", dest="manufactured_epsilon",
                    metavar="EPS | sin:A,B",
                    help="true diffusion of the manufactured problem: a scalar, or "
                    "'sin:A,B' for the non-polynomial field eps(x)=A(1+B sin(pi x)); "
                    "requires --manufactured-velocity")
    p3.add_argument("--fit-epsilon-field", dest="fit_epsilon_field", metavar="ORDER[,REG]",
                    help="after training, run the TWO-PHASE direct linear fit of "
                    "eps(x) (inverse.fit_epsilon_field): freeze the trained u and "
                    "solve the weak residual for a Legendre field of the given "
                    "order, with optional Tikhonov weight REG")
    _add_common_flags(p3)

    p4 = runsub.add_parser(
        "advdiff2d",
        help="2D space-time advection-diffusion, inverse eps (+velocity) "
        "identification on the 3D tensor machinery (beyond reference)",
    )
    p4.add_argument("--n-elements-x", type=int, dest="n_elements_x")
    p4.add_argument("--n-elements-y", type=int, dest="n_elements_y")
    p4.add_argument("--n-elements-t", type=int, dest="n_elements_t")
    p4.add_argument("--n-test-x", type=int, dest="n_test_x")
    p4.add_argument("--n-test-y", type=int, dest="n_test_y")
    p4.add_argument("--n-test-t", type=int, dest="n_test_t")
    p4.add_argument("--gamma", type=float)
    p4.add_argument("--epsilon-init", type=float, dest="epsilon_init")
    p4.add_argument("--forward", action="store_true", help="freeze epsilon at truth")
    p4.add_argument("--identify-velocity", action="store_const", const=True, default=None,
                    dest="velocity_trainable", help="ALSO identify the (vx, vy) vector")
    _add_common_flags(p4)

    pb = runsub.add_parser("burgers", help="viscous Burgers space-time hp-VPINN (nonlinear; beyond reference)")
    pb.add_argument("--n-elements-x", type=int, dest="n_elements_x")
    pb.add_argument("--n-elements-t", type=int, dest="n_elements_t")
    pb.add_argument("--grid-x", type=_grid_arg, dest="grid_x",
                    help="non-uniform x element boundaries (front clustering)")
    pb.add_argument("--n-test-x", type=int, dest="n_test_x")
    pb.add_argument("--n-test-t", type=int, dest="n_test_t")
    pb.add_argument("--nu", type=float)
    pb.add_argument("--hard-bc", action="store_const", const=True, default=None,
                    dest="hard_bc", help="lifted space-time ansatz: IC/BC exact by construction")
    pb.add_argument("--front-feature", action="store_const", const=True, default=None,
                    dest="front_feature",
                    help="append tanh(x/delta) as an extra network input — the x=0 viscous "
                    "front's length scale; a cautionary control (the weak objective "
                    "cannot see the interior scale)")
    pb.add_argument("--front-feature-scale", type=float, dest="front_feature_scale",
                    help="front-width override for --front-feature (default 2*nu)")
    pb.add_argument("--n-strong", type=int, dest="n_strong",
                    help="strong-form collocation points: hybrid weak+strong loss "
                    "(the pointwise pinning the weak objective's front quasi-null "
                    "directions need)")
    pb.add_argument("--strong-weight", type=float, dest="strong_weight")
    pb.add_argument("--strong-window", type=_grid_arg, dest="strong_window",
                    help="x-range to sample the collocation points in, e.g. -0.15,0.15")
    _add_common_flags(pb)

    ph = runsub.add_parser(
        "helmholtz2d",
        help="2D Helmholtz (Delta u + k^2 u = f) — oscillatory INDEFINITE "
        "operator, plane-wave benchmark driven entirely by its boundary "
        "trace (f = 0); optional wavenumber identification (beyond "
        "reference)",
    )
    ph.add_argument("--k", type=float, help="true wavenumber (default 9.0)")
    ph.add_argument("--wave-angle-deg", type=float, dest="wave_angle_deg",
                    help="plane-wave direction in degrees (default 30)")
    ph.add_argument("--wave-phase", type=float, dest="wave_phase")
    ph.add_argument("--n-elements-x", type=int, dest="n_elements_x")
    ph.add_argument("--n-elements-y", type=int, dest="n_elements_y")
    ph.add_argument("--grid-x", type=_grid_arg, dest="grid_x",
                    help="non-uniform x element boundaries")
    ph.add_argument("--grid-y", type=_grid_arg, dest="grid_y")
    ph.add_argument("--n-test-x", type=int, dest="n_test_x")
    ph.add_argument("--n-test-y", type=int, dest="n_test_y")
    ph.add_argument("--n-bound", type=int, dest="n_bound")
    ph.add_argument("--activation", help="'sin' is the matched prior for waves")
    ph.add_argument("--hard-bc", action="store_const", const=True, default=None,
                    dest="hard_bc",
                    help="lifted ansatz: Dirichlet trace exact by construction "
                    "(Coons interpolant of the exact boundary data + bubble "
                    "envelope)")
    ph.add_argument("--inverse", action="store_const", const=True, default=None,
                    dest="inverse",
                    help="trainable k^2 identified from interior sensors (the "
                    "Helmholtz twin of the reference's trainable epsilon, "
                    "AdvDiff.py:63)")
    ph.add_argument("--k-sq-init", type=float, dest="k_sq_init")
    ph.add_argument("--n-sensors", type=int, dest="n_sensors")
    ph.add_argument("--sensor-noise", type=float, dest="sensor_noise_std")
    _add_common_flags(ph)

    pk = runsub.add_parser(
        "kovasznay",
        help="steady incompressible Navier-Stokes, Kovasznay flow — the "
        "framework's first SYSTEM of coupled PDEs (3-output (u, v, p) "
        "ansatz; beyond reference)",
    )
    pk.add_argument("--re", type=float, help="Reynolds number (nu = 1/Re)")
    pk.add_argument("--n-elements-x", type=int, dest="n_elements_x")
    pk.add_argument("--n-elements-y", type=int, dest="n_elements_y")
    pk.add_argument("--grid-x", type=_grid_arg, dest="grid_x",
                    help="non-uniform x element boundaries")
    pk.add_argument("--grid-y", type=_grid_arg, dest="grid_y")
    pk.add_argument("--n-test-x", type=int, dest="n_test_x")
    pk.add_argument("--n-test-y", type=int, dest="n_test_y")
    pk.add_argument("--n-bound", type=int, dest="n_bound")
    pk.add_argument("--no-bc-pressure", action="store_const", const=False,
                    default=None, dest="bc_pressure",
                    help="velocity-only Dirichlet BC + a single-point pressure "
                    "anchor (the classical gauge fix) instead of prescribing "
                    "p on the boundary")
    pk.add_argument("--inverse", action="store_const", const=True, default=None,
                    dest="inverse",
                    help="trainable viscosity identified from interior (u, v) "
                    "sensors — the NS twin of the reference's trainable-epsilon "
                    "problem (AdvDiff.py:63,165,173)")
    pk.add_argument("--hard-bc", action="store_const", const=True, default=None,
                    dest="hard_bc",
                    help="lifted ansatz: velocity Dirichlet BC exact by "
                    "construction (Coons trace interpolant + bubble "
                    "envelope; p soft on the boundary)")
    pk.add_argument("--eq-weights", type=_grid_arg, dest="eq_weights",
                    metavar="WX,WY,WC",
                    help="per-equation residual weights (x-momentum, "
                    "y-momentum, continuity): the v-rebalancing knob, "
                    "e.g. 1,6,1")
    pk.add_argument("--nu-init", type=float, dest="nu_init")
    pk.add_argument("--n-sensors", type=int, dest="n_sensors")
    pk.add_argument("--sensor-noise", type=float, dest="sensor_noise")
    _add_common_flags(pk)

    pt = runsub.add_parser(
        "taylorgreen",
        help="UNSTEADY incompressible Navier-Stokes, Taylor-Green vortex — "
        "the time-dependent PDE system on the space-time tensor machinery "
        "(3-input/3-output ansatz; beyond reference)",
    )
    pt.add_argument("--re", type=float, help="Reynolds number (nu = 1/Re)")
    for flag in ("x", "y", "t"):
        pt.add_argument(f"--n-elements-{flag}", type=int, dest=f"n_elements_{flag}")
        pt.add_argument(f"--n-test-{flag}", type=int, dest=f"n_test_{flag}")
        pt.add_argument(f"--grid-{flag}", type=_grid_arg, dest=f"grid_{flag}")
    pt.add_argument("--n-bound", type=int, dest="n_bound")
    pt.add_argument("--no-bc-pressure", action="store_const", const=False,
                    default=None, dest="bc_pressure",
                    help="velocity-only walls + a pressure anchor CURVE "
                    "(one spatial point across LHS times — the unsteady "
                    "gauge freedom is a free function of t)")
    pt.add_argument("--hard-bc", action="store_const", const=True, default=None,
                    dest="hard_bc",
                    help="lifted ansatz: velocity exact on the 5 data faces "
                    "(side walls at all t + the t=0 face) by construction "
                    "via the space-time transfinite interpolant; p soft on "
                    "the walls (gauge)")
    pt.add_argument("--eq-weights", type=_grid_arg, dest="eq_weights",
                    metavar="WX,WY,WC",
                    help="per-equation residual weights (same contract as "
                    "the kovasznay knob)")
    pt.add_argument("--p-zero-mean", type=float, dest="p_zero_mean_weight",
                    metavar="W",
                    help="zero-mean-per-time-slice pressure gauge penalty "
                    "weight (pins the spatial quadrature mean of p to the "
                    "exact slice mean at --n-zero-mean-t times; attacks "
                    "the unsteady gauge — the family's p limiter)")
    pt.add_argument("--n-zero-mean-t", type=int, dest="n_zero_mean_t")
    pt.add_argument("--p-test-enrich", type=int, dest="p_test_enrich",
                    metavar="E",
                    help="raise the tensor test orders by E for the "
                    "MOMENTUM equations only (the rows that see grad p); "
                    "continuity keeps the base orders")
    pt.add_argument("--inverse", action="store_const", const=True, default=None,
                    dest="inverse",
                    help="trainable viscosity identified from interior "
                    "space-time (u, v) sensors")
    pt.add_argument("--nu-init", type=float, dest="nu_init")
    pt.add_argument("--n-sensors", type=int, dest="n_sensors")
    pt.add_argument("--sensor-noise", type=float, dest="sensor_noise")
    _add_common_flags(pt)

    sub.add_parser("presets", help="print the shipped configurations of record")

    sv = sub.add_parser(
        "serve",
        help="load a torch.export serving artifact (run ... --export DIR) "
        "and evaluate it — no model-building code needed, on the GPU or "
        "the CPU",
    )
    sv.add_argument("artifact", help="artifact directory written by run --export")
    sv.add_argument("--points", metavar="NPZ",
                    help=".npz with array 'X' of evaluation points "
                    "(default: the problem's dense test grid, rebuilt from "
                    "the stored config)")
    sv.add_argument("--out", metavar="NPZ", help="write X/Y predictions to .npz")
    sv.add_argument("--check", action="store_true",
                    help="rebuild the problem from the stored config and "
                    "report rel-L2 of the served artifact vs the exact "
                    "solution on the dense test grid")
    _add_device_flag(sv)

    ad = sub.add_parser("adapt", help="adaptive h-refinement (solve-estimate-mark-refine)")
    ad.add_argument(
        "problem",
        choices=["poisson1d", "poisson2d", "helmholtz2d", "burgers", "advdiff", "advdiff2d",
                 "kovasznay", "taylorgreen"],
    )
    ad.add_argument("--rounds", type=int, default=3)
    ad.add_argument("--theta", type=float, default=None,
                    help="Dörfler bulk fraction (default 0.5; 0.7 for "
                    "--solver galerkin — ties must be fully marked)")
    ad.add_argument("--mode", choices=["h", "p", "hp"], default="h",
                    help="h: bisect marked elements; p: raise their test "
                    "order; hp: alternate h (even rounds) and p (odd rounds)")
    ad.add_argument("--axes", choices=["x", "xt"], default="x",
                    help="space-time families: mark the space axis only (default) "
                    "or BOTH axes (moving fronts / sharp transients)")
    ad.add_argument("--solver", choices=["vpinn", "galerkin"], default="vpinn",
                    help="'galerkin' runs the classical direct-solver loop "
                    "(poisson1d/2d, advdiff, burgers; monotone energy error, "
                    "float64 direct solves on the host) instead of the "
                    "warm-started VPINN loop")
    ad.add_argument("--budget-growth", type=float, default=1.0, dest="budget_growth",
                    help="scale the per-round optimization budget by this factor each "
                    "round (refined meshes are harder to optimize; a growth above 1 "
                    "keeps rounds comparable)")
    ad.add_argument("--iterations", type=int)
    ad.add_argument("--lbfgs-iterations", type=int)
    ad.add_argument("--gn-iterations", type=int, dest="gn_iterations")
    ad.add_argument("--n-quad", type=int, dest="n_quad")
    ad.add_argument("--n-test", type=int, dest="n_test",
                    help="test functions per element (per axis for 2D/space-time)")
    ad.add_argument("--hard-bc", action="store_const", const=True, default=None,
                    dest="hard_bc", help="lifted ansatz (where the family supports it)")
    ad.add_argument("--n-elements", type=int, dest="n_elements",
                    help="starting elements (1D; space axis for burgers)")
    ad.add_argument("--dtype", choices=["float32", "float64", "bfloat16"])
    ad.add_argument("--outdir", default="results/adapt")
    _add_device_flag(ad)

    mr = sub.add_parser(
        "march",
        help="slab-sequential time marching for the unsteady families: "
        "split [t_start, t_final] into S slabs, train each as its own "
        "space-time solve, hand the network state at each slab end to the "
        "next slab as its initial condition (training/timemarch.py; no "
        "reference analog — the reference trains single space-time domains "
        "only, AdvDiff.py:35-53)",
    )
    mr.add_argument("problem", choices=["burgers", "advdiff", "taylorgreen"])
    mr.add_argument("--slabs", type=int, required=True, help="number of time slabs")
    mr.add_argument("--edges", type=_grid_arg,
                    help="explicit slab boundaries (slabs+1 ascending times "
                    "spanning [t_start, t_final]); default uniform")
    mr.add_argument("--ic", choices=["net", "exact"], default="net",
                    help="'net' hands each slab the previous network's state "
                    "(honest marching; errors propagate); 'exact' restarts "
                    "every slab from the analytic solution (per-slab-capacity "
                    "control)")
    mr.add_argument("--fresh-start", action="store_true",
                    help="fresh Xavier init per slab instead of warm-starting "
                    "from the previous slab's trained parameters")
    mr.add_argument("--budget-weights", type=_grid_arg, dest="budget_weights",
                    help="per-slab training-budget multipliers (S positive "
                    "floats, normalized to mean 1 — total budget unchanged); "
                    "front-load the first slab, which owns the IC transient")
    mr.add_argument("--hard-bc", action="store_const", const=True, default=None,
                    dest="hard_bc",
                    help="lifted ansatz per slab: walls exact by construction "
                    "and each slab's lift interpolates the PREDICTED "
                    "interface state (burgers/taylorgreen; "
                    "training/timemarch.py::_hard_bc_slab_kwargs)")
    mr.add_argument("--preset", choices=["record", "quality", "precision"],
                    default="record")
    mr.add_argument("--t-final", type=float, dest="t_final",
                    help="horizon end (the march splits [0, t_final])")
    mr.add_argument("--n-elements-x", type=int, dest="n_elements_x")
    mr.add_argument("--n-elements-y", type=int, dest="n_elements_y",
                    help="taylorgreen only")
    mr.add_argument("--n-elements-t", type=int, dest="n_elements_t",
                    help="time elements PER SLAB")
    mr.add_argument("--n-test-x", type=int, dest="n_test_x")
    mr.add_argument("--n-test-y", type=int, dest="n_test_y",
                    help="taylorgreen only")
    mr.add_argument("--n-test-t", type=int, dest="n_test_t")
    mr.add_argument("--layers", type=str, help="comma-separated MLP widths")
    mr.add_argument("--dtype", choices=["float32", "float64", "bfloat16"])
    mr.add_argument("--iterations", type=int, help="Adam iterations PER SLAB")
    mr.add_argument("--lbfgs-iterations", type=int)
    mr.add_argument("--gn-iterations", type=int, dest="gn_iterations")
    mr.add_argument("--gn-solve", dest="gn_solve",
                    choices=("normal", "host", "qr", "cg", "lsqr"))
    mr.add_argument("--mesh", action="store_true",
                    help="shard each slab's elements over all devices")
    mr.add_argument("--plots", action="store_true",
                    help="write the stitched solution/error space-time panel")
    mr.add_argument("--outdir", default="results/march")
    mr.add_argument("--quiet", action="store_true")
    _add_device_flag(mr)

    idf = sub.add_parser(
        "identify",
        help="NETWORK-FREE coefficient identification (advdiff): 'reduced' "
        "Brent-searches a scalar eps with the exact Galerkin forward solver "
        "in the loop; 'als' alternates two linear solves for a FIELD eps(x) "
        "— both float64, the solves on the host (inverse.py)",
    )
    idf.add_argument(
        "problem",
        choices=["advdiff", "advdiff2d", "burgers", "helmholtz2d", "kovasznay",
                 "taylorgreen"],
    )
    idf.add_argument("--method", choices=["reduced", "als"], default="reduced")
    idf.add_argument("--eps-order", type=int, default=None, dest="eps_order",
                     help="Legendre modes (als field fit; default 8)")
    idf.add_argument("--stations", type=int, default=None,
                     help="N sensor stations on a uniform interior grid "
                     "(default: the reference's 3-station layout)")
    idf.add_argument("--sensors-per-station", type=int, dest="sensors_per_station")
    idf.add_argument("--noise", type=float, dest="sensor_noise_std")
    idf.add_argument("--manufactured-velocity", dest="manufactured_velocity",
                     metavar="C0,C1[,C2]")
    idf.add_argument("--manufactured-epsilon", dest="manufactured_epsilon",
                     metavar="EPS | sin:A,B")
    idf.add_argument("--manufactured-profile", choices=["sin", "cos"],
                     default=None, dest="manufactured_profile")
    idf.add_argument("--identify-velocity", action="store_true",
                     dest="identify_velocity",
                     help="reduced method: ALSO identify the scalar advection "
                     "velocity (joint Nelder-Mead over exact solves)")
    idf.add_argument("--uncertainty", action="store_true",
                     help="attach error bars: closed-form Gauss-Newton/Fisher "
                     "CI for the reduced routes, residual bootstrap for als "
                     "(uncertainty.py)")
    idf.add_argument("--boot", type=int, default=12,
                     help="bootstrap replicates for --uncertainty with als")
    idf.add_argument("--plots", action="store_true",
                     help="write the recovered-vs-true eps(x) panel")
    idf.add_argument("--record", metavar="PATH",
                     help="write the identified coefficients + eps(x) curve "
                     "as an .npz record")
    idf.add_argument("--outdir", default="results/identify")
    _add_device_flag(idf)

    sw = sub.add_parser("sweep", help="h/p-refinement convergence sweep")
    sw.add_argument("problem", choices=["poisson1d", "poisson2d", "poisson3d",
                                        "helmholtz2d", "advdiff", "advdiff2d",
                                        "burgers", "kovasznay", "taylorgreen"])
    sw.add_argument("--axis", choices=["h", "p"], required=True)
    sw.add_argument("--values", required=True, help="comma-separated sweep values")
    sw.add_argument("--iterations", type=int)
    sw.add_argument("--lbfgs-iterations", type=int)
    sw.add_argument("--gn-iterations", type=int, dest="gn_iterations")
    sw.add_argument("--n-quad", type=int, dest="n_quad")
    sw.add_argument("--dtype", choices=["float32", "float64", "bfloat16"])
    sw.add_argument("--outdir", default="results/sweep")
    sw.add_argument("--plots", action="store_true")
    _add_device_flag(sw)
    return ap


_PRESETS = {
    "poisson1d": cfgmod.poisson1d_of_record,
    "poisson2d": cfgmod.poisson2d_of_record,
    "poisson3d": cfgmod.Poisson3DConfig,
    "advdiff": cfgmod.advdiff_of_record,
    "advdiff2d": cfgmod.AdvDiff2DConfig,
    "burgers": cfgmod.BurgersConfig,
    "helmholtz2d": cfgmod.Helmholtz2DConfig,
    "kovasznay": cfgmod.KovasznayConfig,
    "taylorgreen": cfgmod.TaylorGreenConfig,
}

_QUALITY_PRESETS = {
    "poisson1d": cfgmod.poisson1d_quality,
    "poisson2d": cfgmod.poisson2d_quality,
    "poisson3d": cfgmod.poisson3d_quality,
    "advdiff": cfgmod.advdiff_quality,
    "advdiff2d": cfgmod.AdvDiff2DConfig,
    "burgers": cfgmod.burgers_quality,
    "helmholtz2d": cfgmod.helmholtz2d_quality,
    "kovasznay": cfgmod.kovasznay_quality,
    "taylorgreen": cfgmod.taylorgreen_quality,
}

# The Gauss-Newton accuracy-frontier points (config.py), one per family.
_PRECISION_PRESETS = {
    "poisson1d": cfgmod.poisson1d_precision,
    "poisson2d": cfgmod.poisson2d_precision,
    "advdiff": cfgmod.advdiff_precision,
    "burgers": cfgmod.burgers_precision,
    "poisson3d": cfgmod.poisson3d_precision,
    "advdiff2d": cfgmod.advdiff2d_precision,  # FORWARD
    "helmholtz2d": cfgmod.helmholtz2d_precision,
    "kovasznay": cfgmod.kovasznay_precision,
    "taylorgreen": cfgmod.taylorgreen_precision,
}

_TRAIN_KEYS = (
    "iterations", "lbfgs_iterations", "gn_iterations", "gn_solve",
    "gn_cg_tol", "gn_cg_maxiter", "gn_jac_chunk",
    "learning_rate", "threshold", "seed", "checkpoint_dir", "checkpoint_every",
)


def _config_from_args(args) -> object:
    tier = getattr(args, "preset", "record")
    if tier == "precision":
        if args.problem not in _PRECISION_PRESETS:
            raise SystemExit(
                f"--preset precision is shipped for "
                f"{sorted(_PRECISION_PRESETS)} only (the families with a "
                f"Gauss-Newton preset); got '{args.problem}'"
            )
        table = _PRECISION_PRESETS
    else:
        table = _QUALITY_PRESETS if tier == "quality" else _PRESETS
    cfg = table[args.problem]()
    if tier == "precision" and args.problem == "advdiff" and getattr(args, "forward", False):
        # the FORWARD frontier (layer_feature + clustered grid + QR LM); the
        # plain precision preset is the eps-identification point
        cfg = cfgmod.advdiff_forward_precision()
    if getattr(args, "preset", "record") == "quality" and getattr(args, "hard_bc", None):
        # the hard-BC quality points of record (config.py)
        if args.problem == "poisson2d":
            cfg = cfgmod.poisson2d_quality(hard_bc=True)
        elif args.problem == "poisson3d":
            cfg = cfgmod.poisson3d_quality(hard_bc=True)
    cfg_overrides = {}
    names = {f.name for f in dataclasses.fields(cfg)}
    for key, val in vars(args).items():
        if val is None or key in ("command", "problem"):
            continue
        if key == "layers":
            cfg_overrides["layers"] = tuple(int(w) for w in val.split(","))
        elif key == "grid":
            cfg_overrides["grid"] = tuple(float(g) for g in val.split(","))
            cfg_overrides.setdefault("n_elements", len(cfg_overrides["grid"]) - 1)
        elif key == "forward" and val:
            cfg_overrides["inverse"] = False
        elif key in names and key not in _TRAIN_KEYS:
            cfg_overrides[key] = val
    train_overrides = {k: v for k, v in vars(args).items() if k in _TRAIN_KEYS and v is not None}
    train = dataclasses.replace(cfg.train, **train_overrides)
    return dataclasses.replace(cfg, train=train, **cfg_overrides)


def _sin(x):
    """sin of a tensor or an array: a manufactured field is evaluated on
    the host (numpy) and in the weak form (torch)."""
    import numpy as np
    import torch

    return torch.sin(x) if isinstance(x, torch.Tensor) else np.sin(x)


def _cos(x):
    import numpy as np
    import torch

    return torch.cos(x) if isinstance(x, torch.Tensor) else np.cos(x)


def _advdiff_problem_from_args(cfg, args):
    """Build the (possibly manufactured) problem for run/identify on
    --device: the --manufactured-velocity/epsilon/profile flags pose the
    FORCED equation with a known truth; otherwise the benchmark problem is
    built."""
    from hpvpinns_tpu_torch.problems import build

    device = getattr(args, "device", None)
    manu = getattr(args, "manufactured_velocity", None)
    if getattr(args, "manufactured_epsilon", None) and not manu:
        raise SystemExit("--manufactured-epsilon requires --manufactured-velocity")
    if not manu:
        return build(cfg, device=device)
    from hpvpinns_tpu_torch.problems import advdiff as _advdiff

    coef = tuple(float(c) for c in manu.split(","))
    vfn = lambda x: sum(c * x**i for i, c in enumerate(coef))  # noqa: E731
    eps_spec = getattr(args, "manufactured_epsilon", None)
    eps_arg, eps_field_fn = None, None
    if eps_spec:
        if eps_spec.startswith("sin:"):
            import math

            a, b = (float(c) for c in eps_spec[4:].split(","))
            eps_field_fn = lambda x: a * (1.0 + b * _sin(math.pi * x))  # noqa: E731
            eps_arg = eps_field_fn
        else:
            eps_arg = float(eps_spec)
            # fold the scalar truth into gamma so eps_true (= gamma/pi) and
            # every downstream report reflect the SUPPLIED truth, not the
            # benchmark default
            import math

            cfg = dataclasses.replace(cfg, gamma=eps_arg * math.pi)
    profile = getattr(args, "manufactured_profile", None) or "sin"
    u_fn, f_fn = _advdiff.make_manufactured(cfg, vfn, epsilon=eps_arg, profile=profile)
    return _advdiff.build(
        cfg, u_fn=u_fn, f_fn=f_fn, velocity_fn=vfn, epsilon_fn=eps_field_fn, device=device
    )


def _identify2d_map_als(args) -> int:
    """identify advdiff2d --method als: network-free 2D diffusivity-MAP
    recovery on the family's manufactured map benchmark
    eps(x, y) = (0.1/pi)(1 + 0.3 sin(pi x) cos(pi y/2)), in float64 (size
    rule: test orders must exceed the u-basis orders)."""
    import math
    import time as _time

    import numpy as np

    import hpvpinns_tpu_torch as hv
    from hpvpinns_tpu_torch.inverse import als_identify2d
    from hpvpinns_tpu_torch.problems import advdiff2d

    eps_map = lambda X, Y: (0.1 / math.pi) * (  # noqa: E731
        1.0 + 0.3 * _sin(math.pi * X) * _cos(math.pi * Y / 2)
    )
    n_st = args.stations or 7
    st = [
        (float(a), float(b))
        for a in np.linspace(-0.8, 0.8, n_st)
        for b in np.linspace(-0.8, 0.8, n_st)
    ]
    cfg = hv.AdvDiff2DConfig(
        dtype="float64", n_quad=16, n_test_x=12, n_test_y=12, n_test_t=10,
        sensor_stations=tuple(st),
        n_sensors_per_station=args.sensors_per_station or 20,
        sensor_noise_std=args.sensor_noise_std or 0.0,
    )
    prob = advdiff2d.build(cfg, epsilon_fn=eps_map, device=args.device)
    order = args.eps_order or 5
    t0 = _time.perf_counter()
    u_fn, coef, eps_fn, info = als_identify2d(prob, eps_order=order, iters=4)
    xs = np.linspace(-1, 1, 101)
    XG, YG = np.meshgrid(xs, xs, indexing="ij")
    ET = np.asarray(eps_map(XG, YG))
    EH = np.asarray(eps_fn(XG, YG))
    rel = float(np.linalg.norm(EH - ET) / np.linalg.norm(ET))
    summary = {
        "problem": "advdiff2d", "method": "als (2D map)",
        "eps_order": order, "n_sensors": len(st) * (args.sensors_per_station or 20),
        "eps_map_rel_l2": rel,
        "wall_time_s": round(_time.perf_counter() - t0, 2),
    }
    print(json.dumps(summary))
    if getattr(args, "record", None):
        import os

        os.makedirs(os.path.dirname(args.record) or ".", exist_ok=True)
        path = args.record if args.record.endswith(".npz") else args.record + ".npz"
        np.savez(path, coef=np.asarray(coef), x=xs, y=xs, eps=EH, eps_true=ET)
        print(json.dumps({"record": path}))
    if args.plots:
        from hpvpinns_tpu_torch import viz

        path = viz.plot_identified_map2d(
            eps_fn, args.outdir, eps_true_fn=eps_map,
            domain_x=cfg.domain_x, domain_y=cfg.domain_y,
        )
        print(json.dumps({"plots": [path]}))
    return 0


def cmd_identify(args) -> int:
    import numpy as np

    import hpvpinns_tpu_torch as hv
    from hpvpinns_tpu_torch.problems import build

    if args.problem == "burgers":
        if args.method != "reduced":
            raise SystemExit("identify burgers supports --method reduced (viscosity)")
        cfgb = hv.BurgersConfig(dtype="float64")
        import time as _time

        from hpvpinns_tpu_torch.inverse import reduced_identify_burgers

        probb = build(cfgb, device=args.device)
        t0 = _time.perf_counter()
        nu_hat, info = reduced_identify_burgers(
            probb, noise=args.sensor_noise_std or 0.0
        )
        print(json.dumps({
            "problem": "burgers", "method": "reduced",
            "nu": nu_hat, "nu_true": cfgb.nu,
            "nu_rel_err": abs(nu_hat - cfgb.nu) / cfgb.nu,
            "n_forward_solves": info["n_solves"],
            "n_sensors": info["n_sensors"],
            "wall_time_s": round(_time.perf_counter() - t0, 2),
        }))
        return 0
    if args.problem == "helmholtz2d":
        if args.method != "reduced":
            raise SystemExit(
                "identify helmholtz2d supports --method reduced (wavenumber)"
            )
        cfgh = hv.Helmholtz2DConfig(dtype="float64", inverse=True)
        if args.sensor_noise_std is not None:
            cfgh = dataclasses.replace(cfgh, sensor_noise_std=args.sensor_noise_std)
        if getattr(args, "stations", None):
            cfgh = dataclasses.replace(cfgh, n_sensors=args.stations)
        import time as _time

        from hpvpinns_tpu_torch.inverse import reduced_identify_helmholtz

        probh = build(cfgh, device=args.device)
        t0 = _time.perf_counter()
        k_sq_hat, info = reduced_identify_helmholtz(probh)
        k_sq_t = probh.extras["k_sq_true"]
        summary_h = {
            "problem": "helmholtz2d", "method": "reduced",
            "k_sq": k_sq_hat, "k_sq_true": k_sq_t,
            "k_sq_rel_err": abs(k_sq_hat - k_sq_t) / k_sq_t,
            "n_forward_solves": info["n_solves"],
            "n_sensors": info["n_sensors"],
        }
        if getattr(args, "uncertainty", False):
            from hpvpinns_tpu_torch import uncertainty as uq

            ci = uq.reduced_helmholtz_ci(
                probh, k_sq_hat, noise_std=args.sensor_noise_std or None
            )
            summary_h["uncertainty"] = {
                "std": ci["std"][0], "ci95": ci["ci95"][0],
                "sigma": ci["sigma"], "crlb": ci["crlb"],
            }
            summary_h["truth_covered"] = bool(
                ci["ci95"][0][0] <= k_sq_t <= ci["ci95"][0][1]
            )
        summary_h["wall_time_s"] = round(_time.perf_counter() - t0, 2)
        print(json.dumps(summary_h))
        return 0
    if args.problem == "kovasznay":
        if args.method != "reduced":
            raise SystemExit("identify kovasznay supports --method reduced (viscosity)")
        cfgk = hv.KovasznayConfig(dtype="float64", inverse=True)
        if args.sensor_noise_std is not None:
            cfgk = dataclasses.replace(cfgk, sensor_noise=args.sensor_noise_std)
        import time as _time

        from hpvpinns_tpu_torch.inverse import reduced_identify_kovasznay

        probk = build(cfgk, device=args.device)
        t0 = _time.perf_counter()
        nu_hat, info = reduced_identify_kovasznay(probk)
        nu_t = probk.extras["nu_true"]
        summary_k = {
            "problem": "kovasznay", "method": "reduced",
            "nu": nu_hat, "nu_true": nu_t,
            "nu_rel_err": abs(nu_hat - nu_t) / nu_t,
            "n_forward_solves": info["n_solves"],
            "n_sensors": info["n_sensors"],
        }
        if getattr(args, "uncertainty", False):
            from hpvpinns_tpu_torch import uncertainty as uq

            ci = uq.reduced_ns_ci(
                probk, nu_hat, noise_std=args.sensor_noise_std or None
            )
            summary_k["uncertainty"] = {
                "method": "gauss-newton (fd-sensitivity, steady-NS solves)"
                + (" CRLB @ declared noise" if ci["crlb"] else ""),
                "params": ci["params"],
                "std": ci["std"],
                "ci95": ci["ci95"],
                "sigma_est": ci["sigma"],
                "truth_covered": bool(ci["ci95"][0][0] <= nu_t <= ci["ci95"][0][1]),
            }
        summary_k["wall_time_s"] = round(_time.perf_counter() - t0, 2)
        print(json.dumps(summary_k))
        return 0
    if args.problem == "taylorgreen":
        if args.method != "reduced":
            raise SystemExit("identify taylorgreen supports --method reduced (viscosity)")
        cfgt = hv.TaylorGreenConfig(dtype="float64", inverse=True)
        if args.sensor_noise_std is not None:
            cfgt = dataclasses.replace(cfgt, sensor_noise=args.sensor_noise_std)
        import time as _time

        from hpvpinns_tpu_torch.inverse import reduced_identify_taylorgreen

        probt = build(cfgt, device=args.device)
        t0 = _time.perf_counter()
        nu_hat, info = reduced_identify_taylorgreen(probt)
        nu_t = probt.extras["nu_true"]
        summary_t = {
            "problem": "taylorgreen", "method": "reduced",
            "nu": nu_hat, "nu_true": nu_t,
            "nu_rel_err": abs(nu_hat - nu_t) / nu_t,
            "n_forward_solves": info["n_solves"],
            "n_sensors": info["n_sensors"],
        }
        if getattr(args, "uncertainty", False):
            from hpvpinns_tpu_torch import uncertainty as uq

            ci = uq.reduced_ns_unsteady_ci(
                probt, nu_hat, p=info["p"], n_steps=info["n_steps"],
                noise_std=args.sensor_noise_std or None,
            )
            summary_t["uncertainty"] = {
                "method": "gauss-newton (fd-sensitivity, BDF2 unsteady-NS "
                "solves) + Richardson debias"
                + (" CRLB @ declared noise" if ci["crlb"] else ""),
                "params": ci["params"],
                "std": ci["std"],
                "ci95": ci["ci95"],
                "sigma_est": ci["sigma"],
                "truth_covered": bool(ci["ci95"][0][0] <= nu_t <= ci["ci95"][0][1]),
            }
            if "debiased" in ci:
                # the O(dt^2) time-stepping bias removed by Richardson
                # extrapolation (uncertainty.reduced_ns_unsteady_ci)
                nu_db = ci["debiased"][0]
                summary_t["nu_debiased"] = nu_db
                summary_t["nu_debiased_rel_err"] = abs(nu_db - nu_t) / nu_t
        summary_t["wall_time_s"] = round(_time.perf_counter() - t0, 2)
        print(json.dumps(summary_t))
        return 0
    if args.problem == "advdiff2d":
        if getattr(args, "manufactured_velocity", None):
            raise SystemExit(
                "identify advdiff2d runs on the family's own manufactured "
                "benchmark (no --manufactured-velocity)"
            )
        if args.method == "als":
            return _identify2d_map_als(args)
        cfg2 = hv.AdvDiff2DConfig(dtype="float64")
        if args.sensor_noise_std is not None:
            cfg2 = dataclasses.replace(cfg2, sensor_noise_std=args.sensor_noise_std)
        import time as _time

        from hpvpinns_tpu_torch.inverse import reduced_identify2d

        prob2 = build(cfg2, device=args.device)
        t0 = _time.perf_counter()
        coef, info = reduced_identify2d(prob2)
        et = prob2.extras["eps_true"]
        vx_t, vy_t = cfg2.velocity
        summary2 = {
            "problem": "advdiff2d", "method": "reduced",
            "epsilon": float(coef[0]), "epsilon_rel_err": abs(float(coef[0]) - et) / et,
            "vx": float(coef[1]), "vy": float(coef[2]),
            "vx_rel_err": abs(float(coef[1]) - vx_t) / abs(vx_t),
            "vy_rel_err": abs(float(coef[2]) - vy_t) / abs(vy_t),
            "n_forward_solves": info["n_solves"],
        }
        if getattr(args, "uncertainty", False):
            from hpvpinns_tpu_torch import uncertainty as uq

            # a declared --noise level is KNOWN noise: the CRLB mode, else
            # the residual-estimated sigma
            ci = uq.reduced_scalar_ci2d(
                prob2, coef, noise_std=args.sensor_noise_std or None
            )
            summary2["uncertainty"] = {
                "method": "gauss-newton (fd-sensitivity, 2d)"
                + (" CRLB @ declared noise" if ci["crlb"] else ""),
                "params": ci["params"],
                "std": ci["std"],
                "ci95": ci["ci95"],
                "sigma_est": ci["sigma"],
                "truth_covered": bool(
                    ci["ci95"][0][0] <= et <= ci["ci95"][0][1]
                ),
                # the eps interval from a RESIDUAL-estimated sigma is
                # anti-conservative (small-n sigma anti-correlates with the
                # eps error); a declared noise level calibrates it
                "eps_calibration": (
                    "crlb @ declared noise" if ci["crlb"]
                    else "anti-conservative — widen the interval or pass --noise"
                ),
            }
        summary2["wall_time_s"] = round(_time.perf_counter() - t0, 2)
        print(json.dumps(summary2))
        return 0
    cfg = hv.advdiff_of_record()
    over = {"dtype": "float64"}
    if args.method == "als":
        # the spectral u-solve needs a test space rich enough to constrain
        # its 16x12 tensor basis (the of-record 5x5 space cannot)
        over.update(n_quad=24, n_test_x=14, n_test_t=10)
    if args.stations:
        over["sensor_stations"] = tuple(
            float(s) for s in np.linspace(-0.95, 0.95, args.stations)
        )
    if args.sensors_per_station:
        over["n_sensors_per_station"] = args.sensors_per_station
    if args.sensor_noise_std is not None:
        over["sensor_noise_std"] = args.sensor_noise_std
    cfg = dataclasses.replace(cfg, **over)
    prob = _advdiff_problem_from_args(cfg, args)

    import time as _time

    t0 = _time.perf_counter()
    summary = {"problem": "advdiff", "method": args.method}
    if args.method == "reduced":
        from hpvpinns_tpu_torch.inverse import reduced_identify

        order = args.eps_order or 1
        if order > 1 and not getattr(args, "identify_velocity", False):
            # FIELD eps(x): the differentiable (exact-gradient) route — the
            # derivative-free outer loop stalls on a field
            from hpvpinns_tpu_torch.inverse import reduced_identify_field

            coef, eps_fn, info = reduced_identify_field(prob, eps_order=order)
            summary.update(
                method="reduced-field (lbfgsb-adjoint)",
                log_eps_coef=[float(c) for c in coef],
                n_gradient_evals=info["n_evals"],
                misfit=info["misfit"],
            )
            if getattr(args, "uncertainty", False):
                from hpvpinns_tpu_torch import uncertainty as uq

                ci = uq.reduced_field_ci(coef, info, domain=cfg.domain_x)
                xs_b = np.linspace(*cfg.domain_x, 257)
                band = ci["std_fn"](xs_b)
                summary["uncertainty"] = {
                    "method": "fisher (exact-jacobian)",
                    "sigma_est": ci["sigma"],
                    "eps_band_std_mean": float(np.mean(band)),
                    "eps_band_std_max": float(np.max(band)),
                }
        else:
            coef, eps_fn, info = reduced_identify(
                prob, eps_order=order,
                identify_velocity=getattr(args, "identify_velocity", False),
            )
            summary.update(
                epsilon=float(coef[0]) if order == 1 else None,
                eps_coef=[float(c) for c in coef],
                n_forward_solves=info["n_solves"],
                misfit=info["misfit"],
            )
        if "velocity" in info:
            summary["velocity"] = info["velocity"]
            summary["velocity_true"] = prob.extras["velocity_true"]
        if order == 1:
            et = prob.extras["eps_true"]
            summary["epsilon_true"] = et
            summary["epsilon_rel_err"] = abs(float(coef[0]) - et) / et
            if getattr(args, "uncertainty", False):
                from hpvpinns_tpu_torch import uncertainty as uq

                ci = uq.reduced_scalar_ci(
                    prob, coef, velocity=info.get("velocity")
                )
                summary["uncertainty"] = {
                    "method": "gauss-newton (fd-sensitivity)",
                    "params": ci["params"],
                    "std": ci["std"],
                    "ci95": ci["ci95"],
                    "sigma_est": ci["sigma"],
                    "truth_covered": bool(
                        ci["ci95"][0][0] <= et <= ci["ci95"][0][1]
                    ),
                }
    else:
        from hpvpinns_tpu_torch.inverse import als_identify

        order = args.eps_order or 8
        u_fn, coef, eps_fn, info = als_identify(prob, eps_order=order)
        summary["eps_coef"] = [float(c) for c in coef]
        if getattr(args, "uncertainty", False):
            from hpvpinns_tpu_torch import uncertainty as uq

            boot = uq.als_bootstrap(
                prob, coef, u_fn, n_boot=args.boot, eps_order=order
            )
            xs_b = np.linspace(*cfg.domain_x, 257)
            band = boot["std_fn"](xs_b)
            summary["uncertainty"] = {
                "method": f"residual-bootstrap (B={args.boot})",
                "coef_std": [float(s) for s in boot["coef_std"]],
                "eps_band_std_mean": float(np.mean(band)),
                "eps_band_std_max": float(np.max(band)),
            }
    efn = prob.extras.get("epsilon_fn")
    if efn is not None:
        xs = np.linspace(*cfg.domain_x, 513)
        et_x = np.asarray(efn(xs)).reshape(-1)
        eh = np.asarray(eps_fn(xs)).reshape(-1)
        summary["eps_field_rel_l2"] = float(
            np.linalg.norm(eh - et_x) / np.linalg.norm(et_x)
        )
    summary["wall_time_s"] = round(_time.perf_counter() - t0, 2)
    print(json.dumps(summary))
    if getattr(args, "record", None):
        import os

        xs_rec = np.linspace(*cfg.domain_x, 513)
        rec = {
            "coef": np.asarray(coef),
            "x": xs_rec,
            "eps": np.asarray(eps_fn(xs_rec)).reshape(-1),
            "method": np.asarray(summary["method"]),
        }
        efn_r = prob.extras.get("epsilon_fn")
        if efn_r is not None:
            rec["eps_true"] = np.asarray(efn_r(xs_rec)).reshape(-1)
        os.makedirs(os.path.dirname(args.record) or ".", exist_ok=True)
        path = args.record if args.record.endswith(".npz") else args.record + ".npz"
        np.savez(path, **rec)
        print(json.dumps({"record": path}))
    if args.plots:
        from hpvpinns_tpu_torch import viz

        path = viz.plot_identified_field(
            eps_fn, args.outdir, eps_true_fn=efn, domain=cfg.domain_x
        )
        print(json.dumps({"plots": [path]}))
    return 0


def _maybe_polish_f64(args, cfg, prob, params, summary):
    """--polish-f64 N: float64 LM polish of the trained params in this
    process, on --device (training/hybrid.py).  Returns the polished params
    (cast back to the run dtype) and records both the f64-evaluated and the
    cast-back metrics in summary; no-op without the flag."""
    n = getattr(args, "polish_f64", None)
    if not n:
        return params
    import hpvpinns_tpu_torch as hv
    from hpvpinns_tpu_torch.training.hybrid import polish_f64

    pr = polish_f64(cfg, params, iterations=n,
                    solve=getattr(args, "polish_solve", "normal"),
                    verbose=not args.quiet, device=getattr(args, "device", None))
    summary["polish_f64"] = {
        "iterations": n, "solve": getattr(args, "polish_solve", "normal"),
        "loss": pr.loss, "accepted": pr.accepted, "stopped": pr.stopped,
        "wall_s": pr.wall_s,
        "metrics_f64": pr.metrics, "metrics_f64_start": pr.metrics_start,
        "castback": hv.evaluate_problem(prob, pr.params),
    }
    return pr.params


def _mesh_from_args(args):
    """--mesh: the element mesh over the world (one rank alone, every rank
    under torchrun) on --device (default this rank's card), made before the
    problem is built, so that the problem lands on the rank's card; None
    without --mesh."""
    if not args.mesh:
        return None
    from hpvpinns_tpu_torch.parallel.sharding import element_mesh

    return element_mesh(device=getattr(args, "device", None))


def cmd_run(args) -> int:
    trace_out = getattr(args, "trace_out", None)
    if trace_out is None:
        return _cmd_run(args)
    import torch.distributed as dist

    from hpvpinns_tpu_torch.utils import profiling

    profiling.enable()
    try:
        return _cmd_run(args)
    finally:
        profiling.disable()
        rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
        profiling.export_chrome(trace_out if rank == 0 else f"{trace_out}.rank{rank}")


def _cmd_run(args) -> int:
    import hpvpinns_tpu_torch as hv

    cfg = _config_from_args(args)
    mesh = _mesh_from_args(args)
    prob = _advdiff_problem_from_args(cfg, args)
    init_params = None
    if getattr(args, "init_record", None):
        if getattr(args, "seeds", None) and args.seeds > 1:
            print("error: --init-record warm-starts ONE network; it cannot "
                  "seed a --seeds ensemble (every member would collapse to "
                  "the same start)", file=sys.stderr)
            return 2
        from hpvpinns_tpu_torch.utils.records import load_record, params_from_record

        init_params = params_from_record(prob, load_record(args.init_record))
    if getattr(args, "seeds", None) and args.seeds > 1:
        # Seed-fleet study: one vmapped run over S stacked networks
        # (training/ensemble.py), reporting per-seed metrics + the best
        # member as the run result.
        import numpy as _np

        ens = hv.train_ensemble(
            prob, cfg.train, seeds=range(args.seeds), verbose=not args.quiet,
            mesh=mesh,
        )
        per_seed = []
        for i in range(args.seeds):
            m = hv.evaluate_problem(prob, ens.member(i))
            m["seed"] = i
            m["final_loss"] = float(ens.final_aux["loss"][i])
            per_seed.append(m)
        rel = _np.asarray([m["rel_l2"] for m in per_seed])
        summary = {
            "problem": prob.name, "seeds": args.seeds,
            "iterations": ens.iterations_run,
            "wall_time_s": round(ens.wall_time_s, 3),
            "steps_per_sec": round(ens.steps_per_sec, 1),
            "seed_steps_per_sec": round(ens.seed_steps_per_sec, 1),
            "rel_l2_min": float(rel.min()), "rel_l2_median": float(_np.median(rel)),
            "rel_l2_max": float(rel.max()),
            "best_seed": int(_np.argmin(rel)),
            "per_seed": per_seed,
        }
        res_p = None
        if cfg.train.lbfgs_iterations > 0 or cfg.train.gn_iterations > 0:
            # Phase-2 polish of the BEST member only: the ensemble settles
            # the seed lottery under Adam; L-BFGS/Gauss-Newton then refine
            # one winner instead of S.
            best = ens.member(int(_np.argmin(rel)))
            polish_cfg = dataclasses.replace(cfg.train, iterations=0)
            res_p = hv.train(prob, polish_cfg, params=best, mesh=mesh,
                             verbose=not args.quiet)
        if mesh is not None and not mesh.is_root:  # the collective work is done; rank 0 reports
            return 0
        if res_p is not None:
            mp = hv.evaluate_problem(prob, res_p.eval_params)
            summary["polished"] = {
                "seed": int(_np.argmin(rel)),
                "lbfgs_iterations": cfg.train.lbfgs_iterations,
                "gn_iterations": cfg.train.gn_iterations,
                **mp,
            }
        # winner = the phase-2-polished member if one ran, else the best
        final_params = (
            res_p.eval_params if "polished" in summary
            else ens.member(int(_np.argmin(rel)))
        )
        final_params = _maybe_polish_f64(args, cfg, prob, final_params, summary)
        print(json.dumps(summary))
        _maybe_export(args, prob, final_params)
        return 0
    res = hv.train(prob, mesh=mesh, params=init_params, verbose=not args.quiet)
    if mesh is not None and not mesh.is_root:  # the collective work is done; rank 0 reports
        return 0
    metrics = hv.evaluate_problem(prob, res.eval_params)
    summary = {
        "problem": prob.name,
        "iterations": res.iterations_run,
        "wall_time_s": round(res.wall_time_s, 3),
        "steps_per_sec": round(res.steps_per_sec, 1),
        "final_loss": res.final_aux.get("loss"),
        **metrics,
    }
    if "epsilon" in res.final_aux:
        # Report the coefficient belonging to the SAME params as the metrics.
        # eps_domain_mean handles every epsilon_model (the pde tree holds
        # "eps_coef", not "epsilon", for the quadratic field).
        summary["epsilon"] = float(prob.extras["eps_domain_mean"](res.eval_params))
        summary["epsilon_true"] = prob.extras["eps_true"]
    if "nu" in res.final_aux:
        # Kovasznay trainable viscosity (the NS twin of the epsilon report)
        summary["nu"] = float(res.eval_params["pde"]["nu"])
        summary["nu_true"] = prob.extras["nu_true"]
        summary["nu_rel_err"] = abs(summary["nu"] - summary["nu_true"]) / summary["nu_true"]
    if "k_sq" in res.final_aux:
        # Helmholtz trainable squared wavenumber; the closed-form
        # network-free refinement (linear in k^2) is reported alongside
        summary["k_sq"] = float(res.eval_params["pde"]["k_sq"])
        summary["k_sq_true"] = prob.extras["k_sq_true"]
        summary["k_sq_rel_err"] = (
            abs(summary["k_sq"] - summary["k_sq_true"]) / summary["k_sq_true"]
        )
        from hpvpinns_tpu_torch.problems.helmholtz import closed_form_k_sq

        k2c = closed_form_k_sq(prob, res.eval_params)
        summary["k_sq_closed_form"] = k2c
        summary["k_sq_closed_form_rel_err"] = (
            abs(k2c - summary["k_sq_true"]) / summary["k_sq_true"]
        )
    if "velocity" in res.final_aux:
        # domain mean covers every velocity_model ("vel_coef" leaf for the
        # polynomial fields); families without the extra (advdiff2d's |V|)
        # report the aux value
        vdm = prob.extras.get("vel_domain_mean")
        summary["velocity"] = (
            float(vdm(res.eval_params)) if vdm else float(res.final_aux["velocity"])
        )
        summary["velocity_true"] = prob.extras["velocity_true"]
        if "vel_coef" in res.eval_params["pde"]:
            summary["vel_coef"] = res.eval_params["pde"]["vel_coef"].detach().cpu().tolist()
    fit_spec = getattr(args, "fit_epsilon_field", None)
    fit_eps_fn = None
    if fit_spec:
        import numpy as _np

        from hpvpinns_tpu_torch.inverse import fit_epsilon_field

        parts = fit_spec.split(",")
        order = int(parts[0])
        reg = float(parts[1]) if len(parts) > 1 else 0.0
        coef, eps_hat, info = fit_epsilon_field(prob, res.eval_params, order=order, reg=reg)
        fit_eps_fn = eps_hat
        summary["fit_eps_coef"] = _np.asarray(coef).tolist()
        summary["fit_eps_residual"] = [info["residual_before"], info["residual_after"]]
        efn = prob.extras.get("epsilon_fn")
        if efn is not None:
            xs = _np.linspace(*cfg.domain_x, 513)
            et = _np.asarray(efn(xs)).reshape(-1)
            eh = _np.asarray(eps_hat(xs)).reshape(-1)
            summary["fit_eps_field_rel_l2"] = float(
                _np.linalg.norm(eh - et) / _np.linalg.norm(et)
            )
    polished = _maybe_polish_f64(args, cfg, prob, res.eval_params, summary)
    if "polish_f64" in summary:
        # downstream consumers (gap/plots/record/export) see the polished
        # network as the run result; the history stays the training one
        res = dataclasses.replace(res, params=polished, best_params=None)
    print(json.dumps(summary))

    if getattr(args, "gap", False):
        from hpvpinns_tpu_torch import galerkin as _gk

        gap_fns = {
            "poisson1d": _gk.vpinn_gap_1d,
            "poisson2d": _gk.vpinn_gap_2d,
            "poisson3d": _gk.vpinn_gap_3d,
            "advdiff": _gk.vpinn_gap_advdiff,
            "advdiff2d": _gk.vpinn_gap_advdiff2d,
            "burgers": _gk.vpinn_gap_burgers,
            "helmholtz2d": _gk.vpinn_gap_helmholtz2d,
            "kovasznay": _gk.vpinn_gap_kovasznay,
            "taylorgreen": _gk.vpinn_gap_taylorgreen,
        }
        gfn = gap_fns.get(prob.name)
        if gfn is None:
            print(json.dumps({"gap": f"no direct solver for {prob.name}"}))
        else:
            print(json.dumps({"gap": gfn(prob, res.eval_params)}))

    outdir = args.outdir or f"results/{prob.name}"
    if args.plots:
        from hpvpinns_tpu_torch import viz

        paths = viz.standard_report(prob, res, outdir, fit_eps_fn=fit_eps_fn)
        print(json.dumps({"plots": paths}))
    if args.record:
        from hpvpinns_tpu_torch.utils.records import save_record

        written = save_record(prob, res, args.record,
                              include_params=getattr(args, "record_params", False))
        print(json.dumps({"record": written}))
    _maybe_export(args, prob, res.eval_params)
    return 0


def cmd_presets() -> int:
    for name, factory in _PRESETS.items():
        print(f"== {name} (record) ==")
        print(json.dumps(dataclasses.asdict(factory()), indent=1, default=str))
    for name, factory in _QUALITY_PRESETS.items():
        print(f"== {name} (quality) ==")
        print(json.dumps(dataclasses.asdict(factory()), indent=1, default=str))
    for name, factory in _PRECISION_PRESETS.items():
        print(f"== {name} (precision) ==")
        print(json.dumps(dataclasses.asdict(factory()), indent=1, default=str))
    print("== advdiff (precision, --forward) ==")
    print(json.dumps(
        dataclasses.asdict(cfgmod.advdiff_forward_precision()), indent=1, default=str
    ))
    return 0


def cmd_sweep(args) -> int:
    import os

    from hpvpinns_tpu_torch import sweep as sweepmod

    cfg = _PRESETS[args.problem]()
    over = {k: v for k, v in vars(args).items() if k in ("n_quad", "dtype") and v is not None}
    cfg = dataclasses.replace(cfg, **over)
    train_over = {
        k: v for k, v in vars(args).items()
        if k in ("iterations", "lbfgs_iterations", "gn_iterations") and v is not None
    }
    train = dataclasses.replace(cfg.train, **train_over) if train_over else cfg.train
    values = [int(v) for v in args.values.split(",")]
    fn = sweepmod.h_sweep if args.axis == "h" else sweepmod.p_sweep
    records = fn(cfg, values, train, device=args.device)
    os.makedirs(args.outdir, exist_ok=True)
    path = sweepmod.save_sweep(records, os.path.join(args.outdir, f"{args.axis}_sweep.json"))
    print(json.dumps({"sweep": records}))
    out = {"record": path}
    if args.plots:
        out["plot"] = sweepmod.plot_sweep(records, args.outdir)
    print(json.dumps(out))
    return 0


def cmd_adapt(args) -> int:
    import dataclasses as dc
    import functools
    import os

    from hpvpinns_tpu_torch import adaptive
    from hpvpinns_tpu_torch.problems import build

    build_fn = functools.partial(build, device=args.device)
    cfg = _PRESETS[args.problem]()
    if getattr(args, "solver", "vpinn") == "galerkin":
        fns = {
            "poisson1d": adaptive.adaptive_galerkin_1d,
            "poisson2d": adaptive.adaptive_galerkin_2d,
            "advdiff": adaptive.adaptive_galerkin_advdiff,
            "burgers": adaptive.adaptive_galerkin_burgers,
        }
        fn = fns.get(args.problem)
        if fn is None:
            raise SystemExit(
                "--solver galerkin supports poisson1d/poisson2d/advdiff/burgers"
            )
        cfg = dc.replace(cfg, dtype="float64")
        theta = args.theta if args.theta is not None else 0.7
        # The direct-solver loop has no optimizer and h-refines by
        # construction; say so instead of silently ignoring flags
        # (review finding: --mode p used to be dropped without a word).
        ignored = [
            name for name, flag in (
                ("mode", "--mode"), ("axes", "--axes"),
                ("iterations", "--iterations"),
                ("lbfgs_iterations", "--lbfgs-iterations"),
                ("gn_iterations", "--gn-iterations"),
                ("budget_growth", "--budget-growth"), ("n_quad", "--n-quad"),
                ("n_elements", "--n-elements"), ("hard_bc", "--hard-bc"),
                ("dtype", "--dtype"),
            )
            if getattr(args, name, None) not in (None, False, "h", "x", 1.0)
        ]
        if ignored:
            print(
                "note: --solver galerkin ignores "
                + ", ".join(ignored)
                + " (direct solves, h-refinement, float64 on the host; use "
                "--n-test for the solver's polynomial order)",
                file=sys.stderr,
            )
        kw = {"p": args.n_test} if getattr(args, "n_test", None) else {}
        if args.problem in ("poisson1d", "poisson2d"):
            kw["build_fn"] = build_fn
        elif args.problem == "advdiff":
            kw["device"] = args.device
        recs = fn(cfg, rounds=args.rounds, theta=theta, **kw)
        os.makedirs(args.outdir, exist_ok=True)
        path = os.path.join(args.outdir, "adapt_rounds.json")
        with open(path, "w") as f:
            json.dump(recs, f, indent=1)
        print(json.dumps({
            "solver": "galerkin",
            "rel_l2_trajectory": [r["rel_l2"] for r in recs],
            "n_elem_trajectory": [r["n_elem"] for r in recs],
            "record": path,
        }))
        return 0
    over = {k: v for k, v in vars(args).items()
            if k in ("n_quad", "dtype", "n_elements", "hard_bc", "n_test") and v is not None}
    if "n_elements" in over and not hasattr(cfg, "n_elements"):
        over["n_elements_x"] = over.pop("n_elements")  # space-time families
        # refine the space axis (adaptive._refined_config)
    if "n_test" in over and not hasattr(cfg, "n_test"):
        n_test = over.pop("n_test")  # per-axis counts on tensor families
        over.update({k: n_test for k in ("n_test_x", "n_test_y", "n_test_t")
                     if hasattr(cfg, k)})
    if "hard_bc" in over and not hasattr(cfg, "hard_bc"):
        over.pop("hard_bc")
    if over:
        cfg = dc.replace(cfg, **over)
    train_over = {
        k: v for k, v in vars(args).items()
        if k in ("iterations", "lbfgs_iterations", "gn_iterations") and v is not None
    }
    train = dc.replace(cfg.train, **train_over) if train_over else cfg.train
    out = adaptive.adaptive_solve(
        cfg, rounds=args.rounds,
        theta=args.theta if args.theta is not None else 0.5, train_cfg=train,
        build_fn=build_fn, mode=args.mode, axes=args.axes,
        budget_growth=args.budget_growth, verbose=True,
    )
    os.makedirs(args.outdir, exist_ok=True)
    path = os.path.join(args.outdir, "adapt_rounds.json")
    with open(path, "w") as f:
        json.dump(out.rounds, f, indent=1)
    print(json.dumps({
        "rel_l2_trajectory": out.rel_l2_trajectory,
        "n_elem_trajectory": [r["n_elem"] for r in out.rounds],
        "record": path,
    }))
    return 0


def _maybe_export(args, prob, params) -> None:
    """`run ... --export DIR`: write the torch.export serving artifact of
    the final parameters (serving.save_model)."""
    outdir = getattr(args, "export_dir", None)
    if not outdir:
        return
    from hpvpinns_tpu_torch import serving

    extra = None
    if getattr(args, "manufactured_velocity", None):
        # the manufactured u_fn/f_fn live outside the config; flag the
        # artifact so serve --check refuses the wrong-truth comparison
        extra = {"manufactured": True}
    meta = serving.save_model(outdir, prob, params, extra_meta=extra)
    print(json.dumps({
        "export": outdir,
        "platforms": meta["platforms"],
        "n_params": meta["n_params"],
        "dtype": meta["dtype"],
    }))


def cmd_march(args) -> int:
    import hpvpinns_tpu_torch as hv

    # Reuse the run-command config plumbing: march shares the preset tables
    # and override keys; advdiff marches the FORWARD problem (the inverse
    # problem's sensors live on the global horizon — identify first, then
    # march; timemarch.py enforces this).
    if args.problem == "advdiff":
        args.forward = True
    cfg = _config_from_args(args)
    mesh = _mesh_from_args(args)
    root = mesh is None or mesh.is_root

    def progress(k, m):
        if not args.quiet and root:
            print(
                f"[march] slab {k + 1}/{args.slabs} "
                f"[{m['t0']:.3f}, {m['t1']:.3f}]: rel_l2={m['rel_l2']:.3e} "
                f"loss={m['final_loss']:.3e}",
                file=sys.stderr,
            )

    res = hv.time_march(
        cfg,
        n_slabs=args.slabs,
        warm_start=not args.fresh_start,
        ic=args.ic,
        mesh=mesh,
        edges=args.edges,
        budget_weights=args.budget_weights,
        verbose=False,
        progress=progress,
        device=args.device,
    )
    if not root:  # the collective work is done; rank 0 reports
        return 0
    summary = {
        "problem": args.problem,
        "command": "march",
        "slabs": args.slabs,
        "ic": args.ic,
        "warm_start": not args.fresh_start,
        "budget_weights": (
            None if args.budget_weights is None
            else [float(w) for w in args.budget_weights]
        ),
        "edges": [float(e) for e in res.edges],
        "wall_time_s": round(res.wall_time_s, 3),
        "per_slab": [
            {k: v for k, v in m.items() if k != "per_element"}
            for m in res.per_slab
        ],
        **res.metrics,
    }
    print(json.dumps(summary))
    if args.plots:
        if args.problem == "taylorgreen":
            print(json.dumps({"plots": [], "note": "march panels are the "
                              "scalar space-time families' (2D (x, t) "
                              "grids); use run taylorgreen --plots for the "
                              "system's component slices"}))
        else:
            from hpvpinns_tpu_torch.viz import plot_march

            paths = plot_march(res, args.outdir)
            print(json.dumps({"plots": paths}))
    return 0


def cmd_serve(args) -> int:
    import time as _time

    import numpy as np

    from hpvpinns_tpu_torch import serving
    from hpvpinns_tpu_torch.evaluate import rel_l2

    model = serving.load_model(args.artifact, device=args.device)
    summary = {
        "artifact": args.artifact,
        "problem": model.meta["problem"],
        "platforms": model.meta["platforms"],
        "n_params": model.meta["n_params"],
        "d_in": model.meta["d_in"],
        "n_out": model.meta["n_out"],
        "dtype": model.meta["dtype"],
    }
    prob = None
    if args.points:
        X = np.asarray(np.load(args.points)["X"])
    else:
        prob = model.rebuild_problem()
        X = np.asarray(prob.test_points)
    t0 = _time.perf_counter()
    Y = model.predict(X)
    summary["n_points"] = int(X.shape[0])
    summary["wall_s"] = round(_time.perf_counter() - t0, 3)
    if args.check:
        if prob is None:
            prob = model.rebuild_problem()
        Yg = Y if not args.points else model.predict(np.asarray(prob.test_points))
        summary["rel_l2"] = rel_l2(Yg, np.asarray(prob.test_values))
        truth = np.asarray(prob.test_values)
        if truth.ndim == 2 and truth.shape[1] > 1 and Yg.shape == truth.shape:
            names = prob.extras.get(
                "component_names", tuple(f"c{i}" for i in range(truth.shape[1]))
            )
            for i, nm in enumerate(names):
                summary[f"rel_l2_{nm}"] = rel_l2(Yg[:, i], truth[:, i])
    if args.out:
        np.savez(args.out, X=X, Y=Y)
        summary["out"] = args.out
    print(json.dumps(summary))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "presets":
        return cmd_presets()
    if args.command == "sweep":
        return cmd_sweep(args)
    if args.command == "adapt":
        return cmd_adapt(args)
    if args.command == "march":
        return cmd_march(args)
    if args.command == "identify":
        return cmd_identify(args)
    if args.command == "serve":
        return cmd_serve(args)
    return cmd_run(args)


if __name__ == "__main__":
    sys.exit(main())
