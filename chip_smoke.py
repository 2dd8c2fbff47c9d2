#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py [--bwd-only [UNTILED_BWD_SOURCE] | --fwd-only [EARLIER_FWD_SOURCE] | --quality SEED...
                           | --adaptive-only | --adaptive [studies] [burgers] [sweep]
                           | --advdiff-only | --advdiff-quality SEED... | --volumetric-only
                           | --poisson3d-quality [SEED...] | --wide-only | --families-quality [SEED...]
                           | --gn-only | --precision [PRESET...] [SEED...] | --ns-only
                           | --ns-quality [SEED...] | --ns-jacobian [CHUNK...]
                           | --ns-precision-stage adam-lbfgs|lm PRESET [CHECKPOINT_DIR]
                           | --ensemble-only | --march-only | --march | --inverse-only]

Run from the root of the repository.  It imports `hpvpinns_tpu_torch` (never
JAX or `hpvpinns_tpu`), builds the fused field kernel csrc/fused_fields.cu
(B1) and the backward kernels csrc/fused_fields_bwd.cu (B2's resident and
wide forms, the block sum) and csrc/fused_fields_bwd_layered.cu (B2's
layered form) with nvcc for sm_90a, and then, one line per phase:

  1. prints the card (nvidia-smi name and power limit), torch/CUDA versions
     and both TF32 flags;
  2. builds both libraries (one nvcc a source, all started together) and
     prints the build seconds and ptxas's report;
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
     record to the next by more than optax's approximate decrease admits
     (1e-6 of |loss| an iteration) unless an iteration between the two took
     an unsafe step (no trial of sufficient decrease: optax takes the last
     one);
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
 13. Poisson-3D through the three-axis kernel path (phase13): (a)
     fused_fields_3d against its plain version at poisson3d_quality's
     points (P 8,000, (3,48,48,48,1) tanh), firsts and second derivatives
     (fields rtol 2e-5, gradients through B2 at phase 7's tolerance), each
     kernel's device us beside its bound and the plain version's, B2 at
     (3,52,52,52,1) (the resident form) and at (3,56,56,56,1) and
     (3,64,64,64,1) (the wide form: the resident form's shared memory is
     above the card's limit) against its plain version; (b) one chunk
     as graphs against the eager chunk bit for bit at form 0 "pallas" (B1,
     B2, block sum in the captured step), form 1 "pallas" and hard BC
     ("jvp"); (c) poisson3d_quality under "pallas" at its full schedule
     (rel-L2 beside the JAX row 1.34e-2), then graph steps/s of "pallas"
     and "taylor" in turns over 1,000 Adam steps each, with device us a
     step and busy share;
 14. AdvDiff-2D identification (phase14): (a) loss and gradients, eps's and
     the velocity's included, "taylor" vs "pallas" vs "jvp" at forms 0/1 of
     the joint row's configuration; (b) graph against eager bit for bit at
     form 0 "pallas"; (c) the JAX package's joint row ((3,24,24,24,1), eps
     and (vx, vy), Adam 5k + L-BFGS 5k) under "pallas": eps's and |V|'s
     relative errors beside 0.13% / 0.17%, rel-L2 beside 2.9e-2; (d)
     AdvDiff2DConfig() as it stands and under "pallas", 3,000 Adam steps.
 15. B2's wide and layered forms (phase15): (a) the wide form, forced,
     against its plain version (WIDE_GRAD_TOL) at (2,128,128,128,1) and
     (2,256,256,256,1) at P 16,384, n_dirs 2, the JAX test's (2,256,1) and
     (1,200,40,1), and (3,56,56,56,1) and (3,64,64,64,1) at
     poisson3d_quality's P 8,000, n_dirs 3; two runs bit-identical;
     bwd_plan's scratch against the kernel's own count; its device us
     beside its bound, the plain version's and the block sum's; (b) forced
     at (2,20,20,20,1) and (3,48,48,48,1), bit for bit against the resident
     form, both timed in turns; (e) the layered form's replay alone at (a)'s
     shapes: the last hidden layer's stash through the last layer against
     the plain fields (WIDE_FIELD_TOL), timed beside its share of the bound;
     (f) the layered form whole at (a)'s and (b)'s shapes against its plain
     version (WIDE_GRAD_TOL), and at (2,256,256,256,1), P 131,072 (its
     scratch 4x the wide form's there), two runs bit-identical, its plan
     against the kernel's scratch count, timed in turns with the wide form
     beside its bound, the block sum on its partials, the plain version and
     the "taylor" VJP (cuBLAS; a yardstick); (g) bwd_plan picks the layered
     form at (a)'s shapes and P 131,072, each faster than the wide form in
     (f); (h) the path that takes the wide form by default: fields_flat's
     VJP through autograd at (4,128,128,1), n_dirs 3, P 8,000 (four inputs,
     which the layered form does not take), counts zeroed just before, B1,
     the wide B2 and the block sum launched, against the plain version; (d)
     poisson2d_scaled var_form 0 with the (2,256,256,256,1) network: 50
     steps through `train` under "pallas" (the loss must fall; B1, the
     layered B2's kernels and the block sum nodes of the captured step, no
     resident or wide B2), graph steps/s of "pallas" and "taylor" in turns.
 16. Helmholtz-2D and Burgers (phase16): (a) loss and gradients, k^2's
     included, under "taylor", "pallas" and "jvp" at forms 0/1 of
     Helmholtz2DConfig(), its inverse and BurgersConfig(); (b) one chunk as
     graphs against the eager chunk bit for bit at form 0 "pallas" of both
     (B1, B2 and the block sum in the captured step); (c) BurgersConfig()
     under "pallas", 5,000 Adam steps, rel-L2 beside the JAX package's
     0.525 (within 20%, or printed as a miss); Helmholtz2DConfig() and its
     inverse under "pallas", 10,001 Adam steps: rel-L2, loss, k^2's
     relative error and closed_form_k_sq from the trained net.
 17. Gauss-Newton/LM (phase17): (a) one LM step of each solve ("normal",
     "host", "qr", "cg", "lsqr") in float64 on the card against the same
     step on the CPU (r and J, then delta, the predicted decrease and
     |J^T r|_inf at rtol 1e-9, CG/LSQR at the same iteration) at a dual
     Poisson-1D and a primal Poisson-2D; (b) the dual Jacobian under
     "pallas" (B1, then B2 and the block sum once for each cotangent)
     against "taylor" at advdiff_forward_precision's sizes in float32
     without its layer feature (which forces the JVP engine): J within 2e-4
     of each column's largest entry, the launches of one build (counts
     zeroed just before, read just after) and its seconds beside
     "taylor"'s, two LM steps on "pallas", and the forward-mode cases (the
     primal Jacobian of poisson2d_scaled, "cg") raising the documented
     TypeError; (c) helmholtz2d_quality whole (Adam 5k, L-BFGS 5k, the
     10-step QR LM tail): rel-L2 against 2.5e-3, JAX's 1.23e-3 and the
     port's 8.69e-3 without the tail, each phase's wall, the LM steps
     accepted and rejected, the final lambda and the LM records; (e)
     checkpoints of poisson2d_scaled under the graph (asynchronous, every
     100 steps, keep 2), the latest restored bit for bit, and a run
     resumed from step 100.
 18. The Navier-Stokes systems (phase18), on the JVP engine (their (u, v,
     p) output takes no kernel; a launch fails the phase): (a) the four
     presets (soft BC, hard BC, the zero-mean gauge) and both quality
     presets with a trainable nu and velocity-only boundary data, built on
     the card in float32 and on the CPU in float64 from the same params:
     the loss within rtol 1e-5, each gradient leaf within 1e-4 of its
     largest entry; (b) one chunk of 20 Adam steps as CUDA graphs against
     the eager chunk, bit for bit, at the four presets, with the captured
     step's nodes; (c) their graph and eager steps/s in turns, device us a
     step and the busy share; (d) kovasznay_quality with its schedule cut
     to 2,000 Adam + 500 L-BFGS iterations: rel-L2 and its u, v, p keys.
 19. Adaptive hp refinement (phase19): (a) each family's enriched
     indicator (adaptive.element_indicator) at its quality preset's sizes
     (AdvDiff2DConfig() for AdvDiff-2D), on the card in float32 ("pallas"
     where the preset has soft BC and one output: AdvDiff's and
     AdvDiff-2D's enriched fields run through B1) against the CPU in
     float64 from the same params: eta within ETA_TOL of the largest plus
     float32's floor, the Dörfler marks equal where no near-tie within
     that tolerance decides them; (b) adaptive_solve under "pallas" at
     full width, three rounds each cut to 1,000 Adam + 500 L-BFGS: the
     steep Poisson-1D (grid [-1, 0, 1], p15, q40, (1,20,20,20,1); B1
     second, B2 and the block sum) and the 2D tanh(10x) problem from 2 x 2
     elements ((2,30,30,30,1); B1 firsts); each round prints its shape,
     build and train seconds, steps/s, host launches (zeroed before its
     train), the captured step's nodes, rel-L2 beside the JAX row and the
     device memory (peak, reserved, still allocated), and fails if a
     kernel of its path did not launch or is not a node, or if the memory
     still allocated after train grows with the rounds; (d)
     adaptive_galerkin_1d (five rounds, p 12, theta 0.7) on the recorded
     trajectory.
 20. The network's last options, the seed ensemble and time marching
     (phase20): (a) matmul_precision "high"/"default" against "highest" at
     (2,256,256,256,1), P 16,384: mlp_apply, taylor_fields_2d and their
     gradients differ by TF32's rounding (nonzero, below TF32_REL_MAX);
     torch.profiler's kernel names: the network's products TF32 GEMMs in
     the forward and the backward, the contraction einsum and B1 not; a
     captured "high" step keeps TF32 GEMM nodes; poisson2d_quality "taylor"
     "high" against "highest" in turns at a cut schedule (graph steps/s,
     rel-L2); (b) gelu, swish and tanh with the adaptive slope, 500 Adam
     steps of poisson2d_scaled under "taylor" and "jvp" (the loss falls;
     the two engines' fields agree), "pallas" raising the JAX package's
     ValueErrors; (c) train_ensemble at poisson2d_scaled (2,20,20,20,1)
     var_form 1, S 1, 4 and 8, "taylor" against "pallas" in turns (steps/s,
     seed-steps/s), B1 S launches a step (an eager step's count and the
     captured step's nodes), one step of every member against its serial
     `train` twin; (d) var_form 0, S 4: B2 (resident) and the block sum S
     launches a step, each member's gradient against its own unbatched
     "pallas" gradient; (e) the wide point (2,256,256,256,1), S 4, var_form
     1 and 0 (the layered B2), "pallas" against "taylor" in turns with the
     peak device memory, and the block sum beside partials.sum(0) at the
     3 x 256 network's two large partial shapes; (f) time_march: burgers_quality (hard BC, S 2,
     ic "net" and "exact"), AdvDiffConfig(inverse=False,
     deriv_mode="pallas") (S 4, budget weights (2.2, 0.8, 0.5, 0.5); B1 +
     B2) and taylorgreen_quality (hard BC, S 2, "jvp") at cut schedules:
     per-slab and global rel-L2 beside MEASUREMENTS.md's rows, per-slab
     wall seconds and device memory (flat from slab to slab), and each
     slab's params unchanged by the slabs after it.
 21. The inverse suite (phase21): (a) MEASUREMENTS.md:270-271's `run
     advdiff` command (manufactured V 1.0, eps(x) = 0.0318 (1 + 0.5 sin
     pi x), the "cos" profile, a neural eps with epsilon_reg 1e-2; Adam
     2,000 + L-BFGS 2,000) under "pallas" (var_form 0: B1 second, B2
     resident, the block sum; their host launches in the kernels line) and
     "taylor" from the same draw, then inverse.fit_epsilon_field(6, 1e-3) on
     each trained u's fields on the card: the field rel-L2 beside the JAX
     rows, and the "pallas" fit against the same fit on the CPU from the
     same params (INV_CARD_CPU_TOL); bfloat16 Poisson-2D trains on
     "taylor" and "pallas" refuses it, swish's second derivatives run
     under no_grad on "jvp"; (b) the network-free routes in float64 on a
     problem built on the card and on one built on the CPU (the estimate's
     error beside the JAX test's bound and the README's figure, both wall
     times, the two estimates against each other), each with its interval
     (reduced_scalar_ci, reduced_field_ci, als_bootstrap,
     reduced_scalar_ci2d, reduced_ns_ci, reduced_ns_unsteady_ci,
     reduced_helmholtz_ci); (c) reduced_identify_field's misfit and
     gradient (autograd through matrix_exp) and reduced_field_ci's
     Jacobian (torch.func.jacfwd) on the card against the CPU
     (INV_F64_TOL), with torch.profiler's CUDA kernels of each.

Phases 6 and 12 print beside each L-BFGS row the numbers the same schedule
gave with torch.optim.LBFGS (TORCH_LBFGS_ROWS).  With --volumetric-only it runs phases 1, 2, 13 and 14
and prints no summary; with --poisson3d-quality [SEED...] phases 1 and 2,
then phase 13 (c)'s poisson3d_quality under "pallas" and with hard BC
("jvp") at their full schedules, once for each seed given (default: the
preset's).
With --wide-only it runs phases 1, 2 and 15 (B2's wide and layered forms)
and prints no summary; with
--families-quality [SEED...] phases 1 and 2, then burgers_quality (hard BC
on "jvp", Adam 10k + L-BFGS 20k; rel-L2 against its 1.3e-2 target and the
JAX row 8.6e-3) and helmholtz2d_quality with its LM tail cut
(gn_iterations=0; rel-L2 beside the JAX row 1.23e-3, which has the tail),
once for each seed given (default: the presets').
With --inverse-only it runs phases 1, 2 and 21, (b)'s routes at the
README's sizes (the whole run cuts them: INV_ROUTES), and prints no
summary.
With --ensemble-only it runs phases 1, 2 and 20 (a)-(e), with --march-only
phases 1, 2 and 20 (f), and prints no summary; with --march phases 1 and 2,
then 20 (f)'s marches at the study's equal-total schedules
(benchmarks/timemarch_study.py: every phase's budget split over the slabs,
burgers with its 40-step QR Gauss-Newton tail).
With --adaptive-only it runs phases 1, 2 and 19 and prints no summary;
with --adaptive [studies] [burgers] [sweep] phases 1 and 2, then the parts
of phase 19 (c) named (default all): (b)'s two studies at their recorded
budgets (four rounds of 3,000 + 2,000 and three of 4,000 + 3,000), the
README's `adapt burgers` command (hard BC on the JVP engine, four rounds,
budget growth 1.4) beside the JAX rows, and h_sweep on poisson1d_of_record
at p15 (E 1, 2, 4) beside benchmarks/sweep_p1d_h/h_sweep.json.
With --ns-only it runs phases 1, 2 and 18 and prints no summary; with
--ns-quality [SEED...] phases 1 and 2, then kovasznay_quality and
taylorgreen_quality at their whole schedules beside the JAX package's rows,
once for each seed given (default: the presets'); with --ns-jacobian
[CHUNK...] phases 1 and 2, then one Gauss-Newton Jacobian build of
kovasznay_precision and taylorgreen_precision at each block size given
(default: gauss_newton's rule), with its seconds and peak device memory;
with --ns-precision-stage STAGE PRESET [CHECKPOINT_DIR] phases 1 and 2,
then a precision preset's schedule in two calls: "adam-lbfgs" (Adam and
L-BFGS, the params checkpointed under chiprun_out/ns_stage/PRESET where
L-BFGS ends), then "lm" (the LM phase from that checkpoint, copied back
into the repository, e.g. under _scratch/).
With --gn-only it runs phases 1, 2 and 17 and prints no summary; with
--precision [PRESET...] [SEED...] phases 1 and 2, then phase 17 (d): the
Gauss-Newton presets named (default all: advdiff_precision,
poisson1d_precision, advdiff2d_precision, poisson2d_precision,
helmholtz2d_precision, burgers_precision, poisson3d_precision,
kovasznay_precision, taylorgreen_precision) at their whole schedules beside
the JAX rows (for the Navier-Stokes presets with the u, v, p errors, the
Jacobian's kind, shape, build seconds and peak memory, and train's progress
lines), after poisson2d_precision polish_f64 of its trained net (30
float64 LM steps on the card) beside poisson2d_hybrid_polish and after
kovasznay_precision polish_f64 of its net (50 steps) beside
kovasznay_hybrid_polish, once for each seed given (default: the
presets').
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
    "fused_fields_bwd_wide": ("fused_fields_bwd_wide_kernel",),
    "fused_fields_bwd_layered": ("bwd_layered_",),  # its seven kernels, one launch of the wrapper
    "block_sum": ("block_sum_kernel",),
}
SECOND_PATH = ("fused_fields", "fused_fields_bwd", "block_sum")  # second derivatives, B2's resident form
B2_WRAPPER = {"resident": "fused_fields_bwd", "wide": "fused_fields_bwd_wide", "layered": "fused_fields_bwd_layered"}
LAYERED_PATH = ("fused_fields", "fused_fields_bwd_layered", "block_sum")  # second derivatives, B2's layered form
GRAPH_DUMPS = "hpvpinns_tpu_torch/_build/graphs"


def dot_nodes(graph, name: str) -> list:
    """The node labels of a CUDA graph captured in debug mode, from its DOT
    dump (written under GRAPH_DUMPS as `name`.dot)."""
    import os
    import re

    os.makedirs(GRAPH_DUMPS, exist_ok=True)
    path = os.path.join(GRAPH_DUMPS, f"{name}.dot")
    graph.debug_dump(path)
    with open(path) as f:
        # a node is defined at the start of a line; an edge line goes on with "->"
        return re.findall(r'^\s*"graph_\d+_node_\d+"\s*\[(.*?)\];?\s*$', f.read(), re.S | re.M)


def graph_nodes(graph, name: str) -> dict:
    """Nodes of a CUDA graph captured in debug mode, from its DOT dump: all
    nodes, kernel nodes, and the kernel nodes of each wrapper of
    KERNEL_NODES."""
    nodes = dot_nodes(graph, name)
    kernels = [n for n in nodes if "KERNEL" in n]
    out = {"nodes": len(nodes), "kernels": len(kernels)}
    for wrapper, names in KERNEL_NODES.items():
        out[wrapper] = sum(any(k in n for k in names) for n in kernels)
    return out


def wrappers() -> dict:
    """Each kernel's wrapper by the name of KERNEL_NODES."""
    from hpvpinns_tpu_torch.ops import fused_fields as ff

    return {"fused_fields": ff.fused_fields_kernel, "fused_fields_bwd": ff.fused_fields_bwd_kernel,
            "fused_fields_bwd_wide": ff.fused_fields_bwd_wide_kernel,
            "fused_fields_bwd_layered": ff.fused_fields_bwd_layered_kernel, "block_sum": ff.block_sum_kernel}


def zero_counts():
    for k in wrappers().values():
        k.launches = 0


def read_counts() -> dict:
    return {name: k.launches for name, k in wrappers().items()}


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
          f"{step_nodes['fused_fields_bwd']}, wide B2 {step_nodes['fused_fields_bwd_wide']}, layered B2 "
          f"{step_nodes['fused_fields_bwd_layered']}, block sum "
          f"{step_nodes['block_sum']}); metrics graph "
          f"{metric_nodes['nodes']} nodes (B1 {metric_nodes['fused_fields']})", flush=True)
    return step_nodes


LBFGS_GRAPH_ITERS = 20


def lbfgs_graph_against_eager(label: str, prob, c) -> None:
    """LBFGS_GRAPH_ITERS L-BFGS iterations from the same params, once through
    the trainer's chunk (the closure and, from the second iteration on, the
    two-loop direction replayed as CUDA graphs) and once eagerly (the same
    closure as plain calls, `capture_direction` off): each iteration's
    value, trials and line-search errors, the params and the pair memory
    (S, Y, rho, x_prev, g_prev) must be bit-identical.  Prints one line."""
    from hpvpinns_tpu_torch.problems.base import parameters
    from hpvpinns_tpu_torch.training.trainer import _build_lbfgs_chunk, make_lbfgs

    out = {}
    for kind in ("graph", "eager"):
        prm, _ = fresh_state(prob, c)
        opt = make_lbfgs(prm)
        if kind == "graph":
            chunk = _build_lbfgs_chunk(prob.loss_fn, opt, prm, prob.data)
            step = lambda: chunk(1)  # noqa: E731
        else:
            opt.capture_direction = False

            def closure():
                opt.zero_grad(set_to_none=True)
                loss, _ = prob.loss_fn(prm, prob.data)
                loss.backward()
                return loss.detach()

            step = lambda: opt.step(closure)  # noqa: E731
        hist = []
        for _ in range(LBFGS_GRAPH_ITERS):
            step()
            i = opt.info
            hist.append((opt.value, opt.evaluations, i.num_linesearch_steps, i.decrease_error, i.curvature_error))
        torch.cuda.synchronize()
        if kind == "graph" and opt._graph is None:
            fail(f"{label}: the L-BFGS direction was not captured")
        mem = [opt._buffers[k].clone() for k in ("S", "Y", "rho", "x_prev", "g_prev")]
        out[kind] = (hist, [t.detach().clone() for t in parameters(prm)] + mem)
    (hg, tg), (he, te) = out["graph"], out["eager"]
    if hg != he or not all(torch.equal(a, b) for a, b in zip(tg, te)):
        rel = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item() for a, b in zip(tg, te))
        fail(f"{label}: the L-BFGS chunk as CUDA graphs differs from the eager one (records {hg} against {he}; "
             f"params and pair memory max rel diff {rel:.3e})")
    print(f"{label} {c.deriv_mode}: {LBFGS_GRAPH_ITERS} L-BFGS iterations as CUDA graphs (closure and direction) "
          f"against eager: values, trials, line-search errors, params and pair memory bit-identical; loss "
          f"{hg[0][0]:.6e} -> {hg[-1][0]:.6e}, {hg[-1][1]} evaluations", flush=True)


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
        nodes[label] = graph_against_eager(f"phase 5 {label}", prob, c, SECOND_PATH if second else ("fused_fields",))
        if vf == 0:
            lbfgs_graph_against_eager(f"phase 5 {label}", prob, c)

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


def train_checked(prob, cfg, label: str, kernels=(), verbose=False, params=None):
    """Train `prob` through `train` (the counts zeroed just before, read just
    after) and evaluate its best snapshot: (result, host launches, the
    evaluation).  Fails on a short run (unless the threshold stopped it), a
    non-finite loss or rel-L2, an L-BFGS loss that rises from one record to
    the next by more than optax's approximate decrease admits where no
    iteration between the two took an unsafe step, or a kernel of `kernels`
    that did not launch.  `verbose` prints train's progress lines; `params`
    are the initial params (default: the problem's seeded init)."""
    import hpvpinns_tpu_torch as hv
    from hpvpinns_tpu_torch.training.lbfgs import APPROX_DEC_RTOL

    zero_counts()
    res = hv.train(prob, params=params, verbose=verbose)
    counts = read_counts()
    tr = cfg.train
    it, loss = res.history["iteration"], res.history["loss"]
    ev = hv.evaluate_problem(prob, res.eval_params)
    n_gn = res.phases["gn"]["iterations"] if tr.gn_iterations else 0
    if ((res.iterations_run != tr.iterations + tr.lbfgs_iterations + n_gn and not res.stopped_early)
            or not np.all(np.isfinite(loss)) or not math.isfinite(ev["rel_l2"])):
        fail(f"{label}: {res.iterations_run} iterations, loss {loss.tolist()}, rel_l2 {ev['rel_l2']}")
    if tr.lbfgs_iterations:
        # optax's approximate-Wolfe test accepts a step whose loss is within
        # approx_dec_rtol |f_0| above f_0 (training/lbfgs.py): over n
        # iterations between two records at most (1 + 1e-6)^n - 1 of |loss|.
        # A failed search with no trial of sufficient decrease takes its last
        # trial whatever its loss, as optax does (an unsafe step): a larger
        # rise is admitted only between two records with an unsafe step
        # between them (phases["lbfgs"]["unsafe_at"], counted as the records).
        lb_it, lb_loss = it[it >= tr.iterations], loss[it >= tr.iterations]
        allowed = np.abs(lb_loss[:-1]) * ((1.0 + APPROX_DEC_RTOL) ** np.diff(lb_it) - 1.0)
        unsafe = np.asarray(res.phases["lbfgs"]["unsafe_at"], dtype=np.int64)
        excused = np.array([np.any((unsafe > a) & (unsafe <= b)) for a, b in zip(lb_it[:-1], lb_it[1:])], dtype=bool)
        over = np.where(excused, -np.inf, np.diff(lb_loss) - allowed)
        if np.any(over > 0):
            k = int(np.argmax(over))
            fail(f"{label}: the L-BFGS loss rose by {np.diff(lb_loss)[k]:.3e} from iteration {lb_it[k]} to "
                 f"{lb_it[k + 1]}, above the {allowed[k]:.3e} optax's approximate decrease admits, with no unsafe "
                 f"step between the two")
        res.phases["lbfgs"]["excused_records"] = int(np.sum(excused & (np.diff(lb_loss) > allowed)))
    if kernels and min(counts[k] for k in kernels) < 1:
        fail(f"{label}: host launches {counts}: a kernel of the path did not launch")
    return res, counts, ev


# Phases 6 and 12's rows with torch.optim.LBFGS (strong Wolfe) in place of
# optax's L-BFGS: (rel-L2 or eps's relative error, L-BFGS wall s or None where
# not recorded, closure evaluations an iteration), PERF.md sections 5-6
# (NVIDIA H100 80GB HBM3, 700.00 W).
TORCH_LBFGS_ROWS = {
    "poisson2d_quality taylor": (1.5448e-3, 30.1, 2.06),
    "poisson2d_quality pallas": (1.1575e-3, 30.9, 2.06),
    "poisson1d_quality pallas": (5.1039e-3, 38.7, 4.39),
    "poisson2d_quality hard_bc jvp": (2.8496e-4, None, 2.96),
    "advdiff_lbfgs pallas (f32)": (5.50e-2, 92.5, 4.79),
    "advdiff_quality taylor (f64)": (2.89e-2, 51.3, 2.13),
}


def beside_torch_lbfgs(label: str) -> str:
    """The row's numbers with torch.optim.LBFGS, for its printed line."""
    m, wall, ev = TORCH_LBFGS_ROWS[label]
    return (f"; with torch.optim.LBFGS: {m:.4e}, L-BFGS wall s {'not recorded' if wall is None else wall}, "
            f"{ev} evaluations an iteration")


def lbfgs_note(lb: dict) -> str:
    """The L-BFGS phase's evaluations an iteration and failed searches, for a
    printed line."""
    return (f"L-BFGS closure evaluations per iteration {lb['evaluations'] / lb['iterations']:.3f}, failed line "
            f"searches {lb['failed_searches']} (unsafe steps {len(lb['unsafe_at'])}); record-to-record rises above "
            f"optax's approximate decrease {lb.get('excused_records', 0)}, each over an unsafe step")


QUALITY = (  # (label, preset, its arguments, modes, target rel-L2, the JAX package's row, the kernels of its
    # "pallas" path, the L-BFGS iterations of the whole run (None: the preset's; --quality runs the preset's))
    ("poisson2d_quality", "poisson2d_quality", {}, ("taylor", "pallas"), 1e-3,
     "8.6e-4, benchmarks/ACCURACY.json:100-108", ("fused_fields",), None),
    ("poisson1d_quality", "poisson1d_quality", {}, ("pallas",), 1e-2,
     "4.9-6.1e-3 in f32, hpvpinns_tpu/config.py:704-710", SECOND_PATH, None),
    # The hard-BC ansatz on the JVP engine, no kernel.  Its preset's 20k
    # L-BFGS iterations took 296-379 s at seeds 0-3 on an NVIDIA H100 80GB
    # HBM3 at 700.00 W (12.6-15.6 closure evaluations an iteration: the
    # port's f32 line searches fail at the noise floor; optax's own f32
    # searches were not run beside them), more than the rest of the
    # run: the whole run cuts them to 5k (1.06 an iteration).
    ("poisson2d_quality hard_bc", "poisson2d_quality", {"hard_bc": True}, ("jvp",), 1e-3,
     "3.1e-4 after 20k L-BFGS, hpvpinns_tpu/config.py:720-737", (), 5000),
)


def phase6(dev, seed=None):
    """The quality presets (Adam, then L-BFGS, f32) through build, train and
    evaluate: rel-L2 on the test grid against the target, the final loss,
    each phase's wall seconds and the L-BFGS closure evaluations per
    iteration.  It fails on a non-finite result, a short run or an L-BFGS
    loss that rises from one record to the next by more than optax's
    approximate decrease admits with no unsafe step between the two; a missed target is printed,
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
                f"Adam {adam['wall_s']:.2f} L-BFGS {lb['wall_s']:.2f}; {lbfgs_note(lb)}; host "
                f"launches {counts}" + (beside_torch_lbfgs(f"{label} {mode}") if seed is None else ""),
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
         0.10, JAX_ADVDIFF_LBFGS_F32_EPS_REL, SECOND_PATH),
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
              f"{lbfgs_note(ph['lbfgs'])}; host launches {r['counts']}"
              + (beside_torch_lbfgs(label) if seed is None else ""), flush=True)
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
        ("advdiff_of_record var_form 0", dataclasses.replace(base, deriv_mode="pallas"), SECOND_PATH),
        ("advdiff_of_record hard_bc", dataclasses.replace(base, hard_bc=True, deriv_mode="jvp"), ()),
    ):
        nodes[label] = graph_against_eager(f"phase 12 (b) {label}", hv.build(c, device=dev), c, need)

    paths = {}
    for mode in ("taylor", "pallas"):
        c = dataclasses.replace(base, deriv_mode=mode)
        r = identify(hv.build(c, device=dev), c, f"advdiff_of_record {mode}", SECOND_PATH if mode == "pallas" else ())
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

# The JAX package's rows for the volumetric families (accuracy comparators
# only): poisson3d_quality f32 (benchmarks/MEASUREMENTS.md:677-682), with
# hard BC (ACCURACY.json poisson3d_quality_hardbc), and the AdvDiff-2D joint
# identification (MEASUREMENTS.md:584-597, ACCURACY.json advdiff2d_joint_f32_tpu).
JAX_P3D_QUALITY_REL_L2 = 1.34e-2
JAX_P3D_QUALITY_HARDBC_REL_L2 = 8.6e-3
JAX_ADVDIFF2D_JOINT = {"eps_rel": 1.3e-3, "velocity_rel": 1.7e-3, "rel_l2": 2.9e-2}
# B2 at n_dirs 3 from width 56 (241,504 B of shared memory in the resident
# form, above the opt-in limit): bwd_plan gives the wide form.
P3D_WIDE_B2 = ((3, 56, 56, 56, 1), (3, 64, 64, 64, 1))


def with_check_every(c, n: int):
    return dataclasses.replace(c, train=dataclasses.replace(c.train, check_every=n))


def advdiff2d_joint(**kw):
    """The JAX package's AdvDiff-2D joint identification row: (3,24,24,24,1),
    10^3 quadrature points, 6^3 test functions, eps and (vx, vy) trained
    from (1.0; 0.5, 0.25), Adam 5k + L-BFGS 5k, f32."""
    import hpvpinns_tpu_torch as hv

    return hv.AdvDiff2DConfig(
        layers=(3, 24, 24, 24, 1), n_quad=10, n_test_x=6, n_test_y=6, n_test_t=6, velocity_trainable=True,
        train=hv.TrainConfig(iterations=5000, lbfgs_iterations=5000, check_every=500, best_snapshot_fraction=0.9),
        **kw,
    )


def volumetric_kernels(dev):
    """Phase 13 (a): fused_fields_3d against its plain version
    (taylor_fields_3d) at poisson3d_quality's points (P 8,000, (3,48,48,48,1)
    tanh, random weights), firsts (form 1) and with second derivatives (form
    0): fields at FIELD_TOL, gradients (autograd through B1 firsts-only;
    B2 + block sum for second derivatives) at phase 7's tolerance for the
    width; each kernel's device us per call against its bound and the plain
    version's; B2 at width 52 (the resident form) and at P3D_WIDE_B2 (the
    wide form) against its plain version.  Returns {kernel: timings} for the
    kernels line."""
    import hpvpinns_tpu_torch as hv
    from hpvpinns_tpu_torch.models.mlp import MLP
    from hpvpinns_tpu_torch.ops.fused_fields import (
        block_sum_kernel,
        bwd_plan,
        fields_flat_bwd_reference,
        fused_fields_3d,
        fused_fields_bwd,
        fused_fields_bwd_kernel,
        fused_fields_kernel,
    )
    from hpvpinns_tpu_torch.ops.taylor import taylor_fields_3d

    c = dataclasses.replace(hv.poisson3d_quality(), deriv_mode="pallas")
    el = hv.build(c, device=dev).data["elements"]
    x, y, z = el.x, el.y, el.z
    X = torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], dim=-1).contiguous()
    P, layers = X.shape[0], c.layers
    spec = MLP(layers=layers, activation=c.activation)
    rng = np.random.default_rng(13)
    net = random_net(spec, rng, dev)
    leaves = [t for layer in net for t in (layer["W"], layer["b"])]
    tol = WIDE_GRAD_TOL if max(layers) >= 48 else GRAD_TOL
    out = {}
    for second in (False, True):
        got, want = fused_fields_3d(spec, net, x, y, z, second=second), taylor_fields_3d(spec, net, x, y, z, second=second)
        if list(got) != list(want):
            fail(f"fused_fields_3d keys {list(got)} != {list(want)}")
        ferr = max(check_close(f"poisson3d fields {k} second={second}", got[k], want[k], **FIELD_TOL) for k in want)
        g = {k: torch.as_tensor(rng.standard_normal(tuple(v.shape)) / math.sqrt(P), dtype=torch.float32, device=dev)
             for k, v in want.items()}
        gk = torch.autograd.grad(sum((got[k] * g[k]).sum() for k in got), leaves)
        gr = torch.autograd.grad(sum((want[k] * g[k]).sum() for k in want), leaves)
        gerr = max(check_close(f"poisson3d grad {i} second={second}", a, b, **tol) for i, (a, b) in enumerate(zip(gk, gr)))
        nd_cols = 7 if second else 4
        with torch.no_grad():
            kernel = lambda: fused_fields_kernel(spec, net, X, 3, second)  # noqa: E731
            plain = lambda: taylor_fields_3d(spec, net, x, y, z, second=second)  # noqa: E731
            k_ms, p_ms = cuda_ms(kernel), cuda_ms(plain)
            k_dev, p_dev = device_us(kernel), device_us(plain)
        bound, by = bound_ms(*fwd_work(layers, P, 3, second))
        name = "B1 second" if second else "B1 firsts"
        out[name] = {"ms": k_ms, "plain_ms": p_ms, "device_us": k_dev, "plain_device_us": p_dev, "bound_ms": bound,
                     "bound_by": by, "max_abs_err": ferr}
        print(f"phase 13 (a) fused_fields_3d {'second' if second else 'firsts'} at poisson3d_quality (P {P}, layers "
              f"{layers} tanh, {nd_cols} columns): fields max_abs_err {ferr:.3e}, grad max_abs_err {gerr:.3e} "
              f"({'B2 + block sum' if second else 'autograd through the plain firsts'}); B1 ms/call {k_ms:.4f}, "
              f"plain {p_ms:.4f}; device us/call B1 " + (f"{k_dev:.2f}" if k_dev else "not measured")
              + " plain " + (f"{p_dev:.2f}" if p_dev else "not measured") + f"; bound {1e3 * bound:.3f} us ({by})",
              flush=True)
    g7 = torch.as_tensor(rng.standard_normal((P, 7)) / math.sqrt(P), dtype=torch.float32, device=dev)
    (b2_args, *_keep), partials, _ = fused_fields_bwd_kernel.prepare(spec, net, X, g7, 3)
    fused_fields_bwd_kernel.launch(*b2_args)
    fns = {"b2": lambda: fused_fields_bwd_kernel(spec, net, X, g7, 3), "sum": lambda: block_sum_kernel(partials),
           "plain": lambda: fields_flat_bwd_reference(spec, net, X, g7, 3), "torch.sum": lambda: partials.sum(dim=0)}
    ms = {k: cuda_ms(f) for k, f in fns.items()}
    dev_us = {k: device_us(f) for k, f in fns.items()}
    b2_bound = bound_ms(*bwd_work(layers, P, 3))
    rows, cols = partials.shape
    sum_bound = bound_ms(4 * (rows * cols + cols), rows * cols)
    serr = check_close("poisson3d block sum", block_sum_kernel(partials), partials.sum(dim=0), **SUM_TOL)
    out["B2"] = {"ms": ms["b2"], "plain_ms": ms["plain"], "device_us": dev_us["b2"], "plain_device_us": dev_us["plain"],
                 "bound_ms": b2_bound[0], "bound_by": b2_bound[1]}
    out["block sum"] = {"ms": ms["sum"], "plain_ms": ms["torch.sum"], "library_ms": ms["torch.sum"],
                        "device_us": dev_us["sum"], "library_device_us": dev_us["torch.sum"], "partials": [rows, cols],
                        "bound_ms": sum_bound[0], "bound_by": sum_bound[1], "max_abs_err": serr}
    print(f"phase 13 (a) B2 + block sum at poisson3d_quality (P {P}, n_dirs 3, partials [{rows}, {cols}]): ms/call "
          + " ".join(f"{k} {v:.4f}" for k, v in ms.items()) + "; device us/call "
          + " ".join(f"{k} {v:.2f}" if v else f"{k} not measured" for k, v in dev_us.items())
          + f"; bound B2 {1e3 * b2_bound[0]:.3f} us ({b2_bound[1]}), block sum {1e3 * sum_bound[0]:.3f} us "
          f"({sum_bound[1]}); block sum max_abs_err {serr:.3e}", flush=True)
    for wide in ((3, 52, 52, 52, 1), *P3D_WIDE_B2):
        wspec = MLP(layers=wide, activation="tanh")
        wnet = random_net(wspec, rng, dev)
        form = bwd_plan(wide, 3, P).form
        if form != ("resident" if wide[1] <= 52 else "layered"):  # above the card's shared memory: layered
            fail(f"bwd_plan gives B2 at {wide}, n_dirs 3 the {form} form")
        zero_counts()
        got, got_x = fused_fields_bwd(wspec, wnet, X, g7, 3)
        counts = read_counts()
        if counts[B2_WRAPPER[form]] != 1 or counts["block_sum"] != 1 or sum(counts.values()) != 2:
            fail(f"B2 at {wide}, n_dirs 3: host launches {counts}")
        want, want_x = fields_flat_bwd_reference(wspec, wnet, X, g7, 3)
        werr = check_close(f"B2 {wide} gX", got_x, want_x, **WIDE_GRAD_TOL)
        for l, (a, b) in enumerate(zip(got, want)):
            for k in ("W", "b"):
                werr = max(werr, check_close(f"B2 {wide} g{k}_{l}", a[k], b[k], **WIDE_GRAD_TOL))
        print(f"phase 13 (a) B2 at {wide}, n_dirs 3, the {form} form: max_abs_err {werr:.3e} against its plain "
              f"version", flush=True)
    return out


def graph_rates(probs: dict, c, steps: int = 1000, chunk: int = 100):
    """Graph-chunk Adam steps/s of `steps` steps a turn (chunks of `chunk`, a
    device sync each), the modes of `probs` in turns a b b a from the same
    initial params, and per mode the device us a step and busy share of its
    last graph chunk (graph_profile)."""
    from hpvpinns_tpu_torch.training.trainer import _build_chunk
    from hpvpinns_tpu_torch.utils.profiling import time_fn

    a, b = list(probs)
    rates, prof = {a: [], b: []}, {}
    for mode in (a, b, b, a):
        prm, opt = fresh_state(probs[mode], c)
        ch = _build_chunk(probs[mode].loss_fn, opt, prm, probs[mode].data)
        rates[mode].append(chunk * time_fn(ch, chunk, iters=steps // chunk, warmup=1)["iters_per_sec"])
        prof[mode] = graph_profile(ch, n_chunks=1, chunk=chunk)
    return rates, prof


def poisson3d_quality_runs(dev, seed=None, hard_bc=False) -> dict:
    """Phase 13 (c): poisson3d_quality under "pallas" (form 1, B1
    firsts-only) at its full schedule through train, and with hard_bc the
    lifted ansatz on "jvp": rel-L2 against the JAX row, phase seconds and
    L-BFGS evaluations an iteration.  Returns the host launches by path."""
    import hpvpinns_tpu_torch as hv

    runs = [("poisson3d_quality pallas", dataclasses.replace(hv.poisson3d_quality(), deriv_mode="pallas"),
             JAX_P3D_QUALITY_REL_L2, ("fused_fields",))]
    if hard_bc:
        runs.append(("poisson3d_quality hard_bc jvp", dataclasses.replace(hv.poisson3d_quality(hard_bc=True),
                                                                         deriv_mode="jvp"),
                     JAX_P3D_QUALITY_HARDBC_REL_L2, ()))
    paths = {}
    for label, c, jax_row, kernels in runs:
        if seed is not None:
            c = dataclasses.replace(c, train=dataclasses.replace(c.train, seed=seed))
        res, counts, ev = train_checked(hv.build(c, device=dev), c, label, kernels)
        paths[label] = counts
        adam, lb = res.phases["adam"], res.phases["lbfgs"]
        print(f"phase 13 (c) {label} seed {c.train.seed}: Adam {c.train.iterations} + L-BFGS {c.train.lbfgs_iterations} "
              f"(f32, layers {c.layers}, P {c.n_elements_x * c.n_elements_y * c.n_elements_z * c.n_quad ** 3}): "
              f"rel_l2 {ev['rel_l2']:.4e} (JAX f32 row {jax_row:g}); final loss {res.history['loss'][-1]:.6e}; wall s "
              f"Adam {adam['wall_s']:.2f} L-BFGS {lb['wall_s']:.2f}; {res.steps_per_sec:.1f} steps/s over the run; "
              f"{lbfgs_note(lb)}; host launches {counts}", flush=True)
    return paths


def phase13(dev):
    """Poisson-3D through the three-axis kernel path.  (a) volumetric_kernels;
    (b) graph_against_eager (chunks of 10) at poisson3d_quality form 0
    "pallas" (B1, B2 and the block sum nodes of the captured step), form 1
    "pallas" (B1) and hard BC "jvp"; (c) poisson3d_quality_runs, then graph
    steps/s of "pallas" against "taylor" in turns over 1,000 Adam steps
    each, with device us a step and busy share.  Returns (per-kernel
    timings, host launches by path, the captured step's nodes by path)."""
    import hpvpinns_tpu_torch as hv

    t0 = time.perf_counter()
    times = volumetric_kernels(dev)
    base = hv.poisson3d_quality()
    nodes = {}
    for label, c, need in (
        ("poisson3d_quality var_form 0", dataclasses.replace(base, var_form=0, deriv_mode="pallas"), SECOND_PATH),
        ("poisson3d_quality var_form 1", dataclasses.replace(base, deriv_mode="pallas"), ("fused_fields",)),
        ("poisson3d_quality hard_bc", dataclasses.replace(hv.poisson3d_quality(hard_bc=True), deriv_mode="jvp"), ()),
    ):
        c = with_check_every(c, 10)
        nodes[label] = graph_against_eager(f"phase 13 (b) {label}", hv.build(c, device=dev), c, need)
    paths = poisson3d_quality_runs(dev)
    probs = {m: hv.build(dataclasses.replace(base, deriv_mode=m), device=dev) for m in ("pallas", "taylor")}
    rates, prof = graph_rates(probs, base)
    for m, r in rates.items():
        us, busy = prof[m]
        print(f"phase 13 (c) poisson3d_quality var_form 1 {m}: graph steps/s {r[0]!r} {r[1]!r} (1,000 Adam steps a "
              f"turn in chunks of 100, turns pallas taylor taylor pallas); device us/step "
              + (f"{us!r}, busy {busy!r} in the profiler's window, {us * 1e-6 * (r[0] + r[1]) / 2!r} as device us/step "
                 f"x steps/s" if us else "not measured"), flush=True)
    print(f"phase 13 poisson3d: {time.perf_counter() - t0:.1f} s", flush=True)
    return times, paths, nodes


def phase14(dev):
    """AdvDiff-2D identification through the three-axis kernel path.  (a) loss
    and gradients, eps's and the velocity's included, under "taylor",
    "pallas" and "jvp" at the joint row's configuration, forms 0 and 1
    (loss rtol 1e-5, gradients rtol 1e-3 / atol 1e-4); (b)
    graph_against_eager at form 0 "pallas" (B1, B2, block sum); (c) the
    joint row under "pallas" (form 1, B1 firsts-only): eps's and |V|'s
    relative errors and rel-L2 against the JAX row; (d) AdvDiff2DConfig() as
    it stands ("taylor") and under "pallas", 3,000 Adam steps.  Returns (host
    launches by path, the captured step's nodes by path)."""
    import hpvpinns_tpu_torch as hv
    from hpvpinns_tpu_torch.problems.base import parameters

    t0 = time.perf_counter()
    for vf in (0, 1):
        c = advdiff2d_joint(var_form=vf)
        probs = {m: hv.build(dataclasses.replace(c, deriv_mode=m), device=dev) for m in ("taylor", "pallas", "jvp")}
        prm = probs["taylor"].init_params(torch.Generator().manual_seed(c.train.seed))
        out = {}
        for m, prob in probs.items():
            loss, _ = prob.loss_fn(prm, prob.data)
            out[m] = (loss.detach(), torch.autograd.grad(loss, parameters(prm)))
        lt, gt = out["taylor"]
        line = f"phase 14 (a) advdiff2d joint var_form {vf}: loss taylor {lt.item():.6e}"
        for m in ("pallas", "jvp"):
            lm, gm = out[m]
            check_close(f"advdiff2d form {vf} {m} loss", lm, lt, rtol=1e-5, atol=0.0)
            gerr = max(check_close(f"advdiff2d form {vf} {m} grad {i}", a, b, rtol=1e-3, atol=1e-4)
                       for i, (a, b) in enumerate(zip(gm, gt)))
            line += f", {m} {lm.item():.6e} (grad max_abs_err {gerr:.3e})"
        line += "; d loss / d (eps, vx, vy) " + " ".join(f"{v:.6e}" for g in gt[-2:] for v in g.reshape(-1).tolist())
        print(line, flush=True)
    c = with_check_every(advdiff2d_joint(var_form=0, deriv_mode="pallas"), 10)
    prob = hv.build(c, device=dev)
    nodes = {"advdiff2d joint var_form 0": graph_against_eager("phase 14 (b) advdiff2d joint var_form 0", prob, c,
                                                               SECOND_PATH)}
    lbfgs_graph_against_eager("phase 14 (b) advdiff2d joint var_form 0", prob, c)
    paths = {}
    for label, c, kernels in (
        ("advdiff2d joint pallas", advdiff2d_joint(deriv_mode="pallas"), ("fused_fields",)),
        ("AdvDiff2DConfig() taylor", hv.AdvDiff2DConfig(), ()),
        ("AdvDiff2DConfig() pallas", hv.AdvDiff2DConfig(deriv_mode="pallas"), ("fused_fields",)),
    ):
        prob = hv.build(c, device=dev)
        r = identify(prob, c, label, kernels)
        paths[label] = r["counts"]
        v = float(prob.extras["v_of"](r["res"].eval_params)[0]), float(prob.extras["v_of"](r["res"].eval_params)[1])
        v_rel = abs(math.hypot(*v) - prob.extras["velocity_true"]) / prob.extras["velocity_true"]
        ph = r["res"].phases
        line = (f"phase 14 ({'c' if 'joint' in label else 'd'}) {label}: Adam {c.train.iterations} + L-BFGS "
                f"{c.train.lbfgs_iterations} (f32, layers {c.layers}, var_form {c.var_form}): eps {r['eps']:.8g}, "
                f"relative error {r['eps_rel']:.4e}")
        if c.velocity_trainable:
            line += f"; (vx, vy) ({v[0]:.6g}, {v[1]:.6g}), |V| relative error {v_rel:.4e}"
        line += f"; rel_l2 {r['rel_l2']:.4e}"
        if "joint" in label:
            line += (f" (JAX f32 row: eps {JAX_ADVDIFF2D_JOINT['eps_rel']:g}, |V| {JAX_ADVDIFF2D_JOINT['velocity_rel']:g}, "
                     f"rel_l2 {JAX_ADVDIFF2D_JOINT['rel_l2']:g})")
        line += (f"; final loss {r['final_loss']:.6e}; wall s Adam {ph['adam']['wall_s']:.2f}"
                 + (f" L-BFGS {ph['lbfgs']['wall_s']:.2f}; {lbfgs_note(ph['lbfgs'])}" if "lbfgs" in ph else "")
                 + f"; {r['res'].steps_per_sec:.1f} steps/s; host launches {r['counts']}")
        print(line, flush=True)
    print(f"phase 14 advdiff2d: {time.perf_counter() - t0:.1f} s", flush=True)
    return paths, nodes


WIDE_B2_CASES = [  # phase 15: (name, layers, activation, P, n_dirs), each on B2's wide form
    ("p2d_scaled 3 x 128", (2, 128, 128, 128, 1), "tanh", 16384, 2),
    ("p2d_scaled 3 x 256", (2, 256, 256, 256, 1), "tanh", 16384, 2),
    ("jax_one_layer", (2, 256, 1), "tanh", 1000, 2),  # tests/test_pallas_fields.py:131-151's shapes
    ("jax_mixed", (1, 200, 40, 1), "tanh", 1000, 1),
    ("p3d_quality 3 x 56", (3, 56, 56, 56, 1), "tanh", 8000, 3),  # poisson3d_quality's points
    ("p3d_quality 3 x 64", (3, 64, 64, 64, 1), "tanh", 8000, 3),
]
WIDE_FORCED_CASES = [  # phase 15: the wide form forced where the resident form runs
    ("p2d_scaled", (2, 20, 20, 20, 1), "tanh", 16384, 2),
    ("p3d_quality", (3, 48, 48, 48, 1), "tanh", 8000, 3),
]
# phase 15 (f), (g): the layered form at 8x p2d_scaled's points, where its
# scratch (every point's stash) is 4x the wide form's
LAYERED_LARGE_P_CASE = ("p2d_scaled 3 x 256 P 131072", (2, 256, 256, 256, 1), "tanh", 131072, 2)
# phase 15 (h): a network bwd_plan gives the wide form by default: four inputs
# (x, y, z, t), which the layered form does not take, wider than the resident form
WIDE_PATH_CASE = ("fields_flat VJP (4, 128, 128, 1)", (4, 128, 128, 1), "tanh", 8000, 3)


def b2_inputs(layers, act, P, nd, rng, dev):
    """A random network, points in [-1, 1]^d and the cotangents of a mean
    over the points (phase 7's)."""
    from hpvpinns_tpu_torch.models.mlp import MLP

    spec = MLP(layers=layers, activation=act)
    net = random_net(spec, rng, dev)
    X = torch.as_tensor(rng.uniform(-1.0, 1.0, (P, layers[0])), dtype=torch.float32, device=dev)
    g = torch.as_tensor(rng.standard_normal((P, 1 + 2 * nd)) / math.sqrt(P), dtype=torch.float32, device=dev)
    return spec, net, X, g


def forced_b2(kernel, spec, net, X, g, nd):
    """B2 through `kernel` (a form's wrapper, forced), then the block sum:
    what fused_fields_bwd runs where bwd_plan gives that form."""
    from hpvpinns_tpu_torch.ops.fused_fields import block_sum_kernel, unpack_params

    partials, gX = kernel(spec, net, X, g, nd)
    return unpack_params(spec, block_sum_kernel(partials)), gX


def wide_b2_kernels(dev) -> dict:
    """Phase 15 (a)-(c): B2's wide form against its plain version at
    WIDE_B2_CASES (WIDE_GRAD_TOL; two runs bit-identical; bwd_plan's form and
    scratch against the kernel's own count), then forced at
    WIDE_FORCED_CASES against the resident form (it adds in the same order:
    bit for bit), and its times: the C function alone by CUDA events over 50
    launches, device us by torch.profiler, the block sum on its partials, the
    plain version, and the bound.  Returns {case: numbers}."""
    from hpvpinns_tpu_torch.ops.fused_fields import (
        block_sum_kernel,
        bwd_plan,
        fields_flat_bwd_reference,
        fused_fields_bwd_kernel,
        fused_fields_bwd_wide_kernel,
    )

    rng = np.random.default_rng(15)
    out = {}
    for name, layers, act, P, nd in WIDE_B2_CASES:
        spec, net, X, g = b2_inputs(layers, act, P, nd, rng, dev)
        plan = bwd_plan(layers, nd, P, form="wide")
        c_scratch = fused_fields_bwd_wide_kernel.load().lib.hp_fused_fields_bwd_wide_scratch_bytes(
            max(layers[:-1]), len(layers) - 1, nd, plan.n_blocks)
        if plan.form != "wide" or c_scratch != plan.scratch_bytes:
            fail(f"{name}: bwd_plan {plan} (the kernel's scratch {c_scratch} B)")
        zero_counts()
        got, got_x = forced_b2(fused_fields_bwd_wide_kernel, spec, net, X, g, nd)
        again, again_x = forced_b2(fused_fields_bwd_wide_kernel, spec, net, X, g, nd)
        counts = read_counts()
        if counts["fused_fields_bwd_wide"] != 2 or counts["fused_fields_bwd"] != 0 or counts["block_sum"] != 2:
            fail(f"{name}: host launches {counts}")
        want, want_x = fields_flat_bwd_reference(spec, net, X, g, nd)
        torch.cuda.synchronize()
        err = check_close(f"{name} gX", got_x, want_x, **WIDE_GRAD_TOL)
        same = torch.equal(got_x, again_x)
        for l, (a, b, c) in enumerate(zip(got, want, again)):
            for k in ("W", "b"):
                err = max(err, check_close(f"{name} g{k}_{l}", a[k], b[k], **WIDE_GRAD_TOL))
                same = same and torch.equal(a[k], c[k])
        if not same:
            fail(f"{name}: two runs of the wide B2 + block sum differ")
        (args, *keep), partials, _ = fused_fields_bwd_wide_kernel.prepare(spec, net, X, g, nd)
        c_fn = lambda: fused_fields_bwd_wide_kernel.launch(*args)  # noqa: E731
        c_fn()
        plain = lambda: fields_flat_bwd_reference(spec, net, X, g, nd)  # noqa: E731
        sum_fn = lambda: block_sum_kernel(partials)  # noqa: E731
        ev = [1e3 * cuda_ms(f) for f in (c_fn, c_fn)]
        p_ms = cuda_ms(plain)
        b2_dev, sum_dev, p_dev = device_us(c_fn), device_us(sum_fn), device_us(plain)
        sum_us = 1e3 * cuda_ms(sum_fn)
        bound, by = bound_ms(*bwd_work(layers, P, nd))
        rows, cols = partials.shape
        s_bound, s_by = bound_ms(4 * (rows * cols + cols), rows * cols)
        out[name] = {"us": (ev[0] + ev[1]) / 2, "device_us": b2_dev, "plain_ms": p_ms, "plain_device_us": p_dev,
                     "forced_launches": counts["fused_fields_bwd_wide"],
                     "bound_ms": bound, "bound_by": by, "max_abs_err": err, "sum_us": sum_us, "sum_device_us": sum_dev,
                     "sum_bound_ms": s_bound, "partials": [rows, cols], "scratch_bytes": plan.scratch_bytes}
        print(f"phase 15 (a) wide B2 {name}: layers {layers} {act} P={P} n_dirs={nd}, {plan.n_blocks} blocks x "
              f"{plan.tiles_per_block} tiles, scratch {plan.scratch_bytes} B, partials [{rows}, {cols}]; max_abs_err "
              f"{err:.3e} (rtol {WIDE_GRAD_TOL['rtol']} atol {WIDE_GRAD_TOL['atol']}), two runs bit-identical; C function "
              f"us/launch (CUDA events, 50 launches) {ev[0]:.2f} {ev[1]:.2f}, device us (torch.profiler) "
              + (f"{b2_dev:.2f}" if b2_dev else "not measured") + f"; bound {1e3 * bound:.3f} us ({by}); plain ms/call "
              f"{p_ms:.4f}, device us " + (f"{p_dev:.2f}" if p_dev else "not measured") + f"; block sum us/call "
              f"{sum_us:.2f}, device us " + (f"{sum_dev:.2f}" if sum_dev else "not measured")
              + f", bound {1e3 * s_bound:.3f} us ({s_by})", flush=True)
    for name, layers, act, P, nd in WIDE_FORCED_CASES:
        spec, net, X, g = b2_inputs(layers, act, P, nd, rng, dev)
        res_p, res_x = fused_fields_bwd_kernel(spec, net, X, g, nd)
        wide_p, wide_x = fused_fields_bwd_wide_kernel(spec, net, X, g, nd)
        torch.cuda.synchronize()
        if not (torch.equal(res_p, wide_p) and torch.equal(res_x, wide_x)):
            d = max((res_p - wide_p).abs().max().item(), (res_x - wide_x).abs().max().item())
            fail(f"{name}: the wide form forced at {layers} differs from the resident form (max abs diff {d:.3e})")
        (ra, *rk), _, _ = fused_fields_bwd_kernel.prepare(spec, net, X, g, nd)
        (wa, *wk), _, _ = fused_fields_bwd_wide_kernel.prepare(spec, net, X, g, nd)
        res_fn = lambda: fused_fields_bwd_kernel.launch(*ra)  # noqa: E731
        wide_fn = lambda: fused_fields_bwd_wide_kernel.launch(*wa)  # noqa: E731
        ev = [1e3 * cuda_ms(f) for f in (res_fn, wide_fn, wide_fn, res_fn)]
        out[f"forced {name}"] = {"resident_us": (ev[0] + ev[3]) / 2, "wide_us": (ev[1] + ev[2]) / 2}
        print(f"phase 15 (b) the wide form forced at {name} {layers} P={P} n_dirs={nd}: partials and gX bit-identical "
              f"to the resident form; C function us/launch in turns resident, wide, wide, resident {ev[0]:.2f} "
              f"{ev[1]:.2f} {ev[2]:.2f} {ev[3]:.2f}", flush=True)
    return out


def stash_outputs(st: torch.Tensor, act: str, nd: int) -> torch.Tensor:
    """A hidden layer's output streams [S, P, w] from its stash [S, P, w]
    (t or z, z_k, z_kk): csrc/fused_fields_bwd_rules.cuh::outputs in torch."""
    v, zk, zkk = st[0], st[1:1 + nd], st[1 + nd:]
    if act == "tanh":
        a, d1 = v, 1.0 - v * v
        d2 = -2.0 * v * d1
    else:
        a, d1, d2 = torch.sin(v), torch.cos(v), -torch.sin(v)
    return torch.cat([a[None], d1 * zk, d2 * zk * zk + d1 * zkk])


def replay_work(layers, P, nd):
    """(bytes, FLOPs) of the layered form's replay: X and the network read
    once, every hidden layer's stash (S floats a neuron and point) written
    once; 2 FLOPs a multiply-add of the value stream into layer 0 and of
    every stream through the hidden layers above it."""
    S = 1 + 2 * nd
    n_params = sum(a * b + b for a, b in zip(layers[:-1], layers[1:]))
    macs = layers[0] * layers[1] + S * sum(a * b for a, b in zip(layers[1:-2], layers[2:-1]))
    return 4 * (P * layers[0] + n_params + S * P * sum(layers[1:-1])), 2 * P * macs


def layered_replay(dev) -> dict:
    """Phase 15 (e): the layered form's replay alone (its seed and one GEMM
    launch a hidden layer above the first, hp_fused_fields_bwd_layered_replay_f32)
    at WIDE_B2_CASES: the stash of the last hidden layer, its output streams
    pushed through the last layer (+ b on u), against the plain fields
    (fields_flat_reference) at WIDE_FIELD_TOL, and its time by CUDA events
    over 50 launches beside its share of the bound.  Returns {case: numbers}."""
    from hpvpinns_tpu_torch.ops.fused_fields import (
        _ACTIVATION_CODE,
        bwd_plan,
        fields_flat_reference,
        fused_fields_bwd_layered_kernel,
        pack_params,
    )

    lib = fused_fields_bwd_layered_kernel.load().lib
    rng = np.random.default_rng(151)
    out = {}
    for name, layers, act, P, nd in WIDE_B2_CASES:
        spec, net, X, _ = b2_inputs(layers, act, P, nd, rng, dev)
        plan = bwd_plan(layers, nd, P, form="layered")
        S, L, pitch = 1 + 2 * nd, len(layers) - 1, -(-max(layers[1:-1]) // 4) * 4
        scratch = torch.empty(plan.scratch_bytes // 4, dtype=torch.float32, device=dev)
        packed, widths = pack_params(spec, net)
        args = (X.data_ptr(), packed.data_ptr(), widths.ctypes.data, L, P, nd, _ACTIVATION_CODE[act],
                scratch.data_ptr(), dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)

        def replay():
            code = lib.hp_fused_fields_bwd_layered_replay_f32(*args)
            if code != 0:
                fail(f"{name}: the layered replay did not launch (CUDA error {code})")

        replay()
        torch.cuda.synchronize()
        with torch.no_grad():
            h = stash_outputs(scratch.view(L - 1, S, P, pitch)[L - 2, :, :, :layers[-2]], act, nd)
            got = (h @ net[-1]["W"])[..., 0].T.contiguous()
            got[:, 0] += net[-1]["b"]
            want = fields_flat_reference(spec, net, X, nd, True)
        err = check_close(f"{name} layered replay fields", got, want, **WIDE_FIELD_TOL)
        us = 1e3 * cuda_ms(replay)
        bound, by = bound_ms(*replay_work(layers, P, nd))
        out[name] = {"us": us, "bound_ms": bound, "bound_by": by, "max_abs_err": err}
        print(f"phase 15 (e) layered replay {name}: layers {layers} {act} P={P} n_dirs={nd}: the last stash through "
              f"W_last against the plain fields, max_abs_err {err:.3e} (rtol {WIDE_FIELD_TOL['rtol']} atol "
              f"{WIDE_FIELD_TOL['atol']}); us/launch (CUDA events, 50 launches) {us:.2f}; the replay's bound "
              f"{1e3 * bound:.3f} us ({by}), {1e3 * bound / us:.3f} of it", flush=True)
    return out


def taylor_vjp_us(spec, net, X, g, nd) -> float:
    """µs a call of the "taylor" VJP at these inputs: autograd's backward
    through ops/taylor.py's forward (cuBLAS), the forward taken once outside
    the timing.  A yardstick only: the kernel path never calls it."""
    from hpvpinns_tpu_torch.ops.fused_fields import fields_flat_reference

    with torch.enable_grad():
        Xd = X.detach().requires_grad_(True)
        leaves = [t.detach().requires_grad_(True) for layer in net for t in (layer["W"], layer["b"])]
        prm = [{"W": leaves[i], "b": leaves[i + 1]} for i in range(0, len(leaves), 2)]
        out = fields_flat_reference(spec, prm, Xd, nd, True)
        return 1e3 * cuda_ms(lambda: torch.autograd.grad(out, [Xd] + leaves, g, retain_graph=True))


def layered_b2(dev) -> dict:
    """Phase 15 (f): the layered form whole (its launches, then the block sum
    on its partials) against the plain version at WIDE_GRAD_TOL at
    WIDE_B2_CASES and, forced, at WIDE_FORCED_CASES; two runs bit-identical;
    bwd_plan's scratch and partial rows against the kernel's; then the C
    functions alone by CUDA events over 50 launches in turns v3, layered,
    layered, v3, beside the bound, the block sum on its partials, the plain
    version and the "taylor" VJP (taylor_vjp_us).  Returns {case: numbers}."""
    from hpvpinns_tpu_torch.ops.fused_fields import (
        block_sum_kernel,
        bwd_plan,
        fields_flat_bwd_reference,
        fused_fields_bwd_layered_kernel,
        fused_fields_bwd_wide_kernel,
    )

    lib = fused_fields_bwd_layered_kernel.load().lib
    rng = np.random.default_rng(152)
    out = {}
    cases = WIDE_B2_CASES + [LAYERED_LARGE_P_CASE] + [(f"forced {c[0]}", *c[1:]) for c in WIDE_FORCED_CASES]
    for name, layers, act, P, nd in cases:
        spec, net, X, g = b2_inputs(layers, act, P, nd, rng, dev)
        plan = bwd_plan(layers, nd, P, form="layered")
        c_scratch = lib.hp_fused_fields_bwd_layered_scratch_bytes(max(layers[1:-1]), len(layers) - 1, nd, P)
        if c_scratch != plan.scratch_bytes or plan.n_blocks != -(-P // (16 * plan.tiles_per_block)):
            fail(f"{name}: bwd_plan {plan} (the kernel's scratch {c_scratch} B)")
        zero_counts()
        got, got_x = forced_b2(fused_fields_bwd_layered_kernel, spec, net, X, g, nd)
        again, again_x = forced_b2(fused_fields_bwd_layered_kernel, spec, net, X, g, nd)
        counts = read_counts()
        if counts["fused_fields_bwd_layered"] != 2 or counts["block_sum"] != 2 or sum(counts.values()) != 4:
            fail(f"{name}: host launches {counts}")
        want, want_x = fields_flat_bwd_reference(spec, net, X, g, nd)
        torch.cuda.synchronize()
        err = check_close(f"{name} layered gX", got_x, want_x, **WIDE_GRAD_TOL)
        same = torch.equal(got_x, again_x)
        for l, (a, b, c) in enumerate(zip(got, want, again)):
            for k in ("W", "b"):
                err = max(err, check_close(f"{name} layered g{k}_{l}", a[k], b[k], **WIDE_GRAD_TOL))
                same = same and torch.equal(a[k], c[k])
        if not same:
            fail(f"{name}: two runs of the layered B2 + block sum differ")
        (la, *lk), partials, _ = fused_fields_bwd_layered_kernel.prepare(spec, net, X, g, nd)
        (wa, *wk), _, _ = fused_fields_bwd_wide_kernel.prepare(spec, net, X, g, nd)
        lay = lambda: fused_fields_bwd_layered_kernel.launch(*la)  # noqa: E731
        v3 = lambda: fused_fields_bwd_wide_kernel.launch(*wa)  # noqa: E731
        lay()
        ev = [1e3 * cuda_ms(f) for f in (v3, lay, lay, v3)]
        lay_dev = device_us(lay)
        sum_fn = lambda: block_sum_kernel(partials)  # noqa: E731
        sum_us, sum_dev = 1e3 * cuda_ms(sum_fn), device_us(sum_fn)
        p_ms = cuda_ms(lambda: fields_flat_bwd_reference(spec, net, X, g, nd))
        t_us = taylor_vjp_us(spec, net, X, g, nd)
        bound, by = bound_ms(*bwd_work(layers, P, nd))
        rows, cols = partials.shape
        s_bound, s_by = bound_ms(4 * (rows * cols + cols), rows * cols)
        us, v3_us = (ev[1] + ev[2]) / 2, (ev[0] + ev[3]) / 2
        out[name] = {"us": us, "v3_us": v3_us, "turns_us": ev, "device_us": lay_dev, "plain_ms": p_ms,
                     "taylor_vjp_us": t_us, "bound_ms": bound, "bound_by": by, "max_abs_err": err, "sum_us": sum_us,
                     "sum_device_us": sum_dev, "sum_bound_ms": s_bound, "partials": [rows, cols],
                     "scratch_bytes": plan.scratch_bytes, "layers": list(layers), "P": P, "n_dirs": nd}
        print(f"phase 15 (f) layered B2 {name}: layers {layers} {act} P={P} n_dirs={nd}, {rows} slices of "
              f"{16 * plan.tiles_per_block} points, scratch {plan.scratch_bytes} B, partials [{rows}, {cols}]; "
              f"max_abs_err {err:.3e} (rtol {WIDE_GRAD_TOL['rtol']} atol {WIDE_GRAD_TOL['atol']}), two runs "
              f"bit-identical; C functions us/launch (CUDA events, 50 launches) in turns v3, layered, layered, v3 "
              f"{ev[0]:.2f} {ev[1]:.2f} {ev[2]:.2f} {ev[3]:.2f} (layered / v3 {us / v3_us:.3f}); layered device us "
              + (f"{lay_dev:.2f}" if lay_dev else "not measured") + f"; bound {1e3 * bound:.3f} us ({by}), "
              f"{1e3 * bound / us:.3f} of it; plain ms/call {p_ms:.4f}; taylor VJP us/call {t_us:.2f}; block sum "
              f"us/call {sum_us:.2f}, device us " + (f"{sum_dev:.2f}" if sum_dev else "not measured")
              + f", bound {1e3 * s_bound:.3f} us ({s_by})", flush=True)
    return out


def plan_rule(lay: dict) -> None:
    """Phase 15 (g): bwd_plan picks the layered form at every WIDE_B2_CASES
    shape (the wide form's before) and at LAYERED_LARGE_P_CASE, and (f)
    showed it faster than the wide form there, in turns within this call."""
    from hpvpinns_tpu_torch.ops.fused_fields import bwd_plan

    for name, layers, _, P, nd in WIDE_B2_CASES + [LAYERED_LARGE_P_CASE]:
        form, r = bwd_plan(layers, nd, P).form, lay[name]
        if form != "layered" or not r["us"] < r["v3_us"]:
            fail(f"{name}: bwd_plan picks the {form} form; (f) layered {r['us']:.2f} us, wide {r['v3_us']:.2f} us")
        print(f"phase 15 (g) {name}: bwd_plan picks the layered form; (f) layered {r['us']:.2f} us against the wide "
              f"form's {r['v3_us']:.2f} ({r['us'] / r['v3_us']:.3f})", flush=True)


def wide_path(dev):
    """Phase 15 (h): the wide form on the path that takes it by default, the
    VJP of fields_flat (torch.autograd through B1 and B2) at WIDE_PATH_CASE.
    Counts zeroed just before, read just after: B1, the wide B2 and the block
    sum launch, no other form of B2.  The fields against the plain ones
    (WIDE_FIELD_TOL), gX and the gradients against the plain version
    (WIDE_GRAD_TOL).  Returns (host launches, max_abs_err)."""
    from hpvpinns_tpu_torch.ops.fused_fields import (
        bwd_plan,
        fields_flat,
        fields_flat_bwd_reference,
        fields_flat_reference,
    )

    name, layers, act, P, nd = WIDE_PATH_CASE
    spec, net, X, g = b2_inputs(layers, act, P, nd, np.random.default_rng(153), dev)
    plan = bwd_plan(layers, nd, P)
    if plan.form != "wide":
        fail(f"{name}: bwd_plan gives the {plan.form} form")
    leaves = [t for layer in net for t in (layer["W"], layer["b"])]
    Xg = X.clone().requires_grad_(True)
    zero_counts()
    fields = fields_flat(spec, net, Xg, nd, True)
    got_x, *got = torch.autograd.grad(fields, [Xg] + leaves, g)
    torch.cuda.synchronize()
    counts = read_counts()
    if (min(counts[k] for k in ("fused_fields", "fused_fields_bwd_wide", "block_sum")) < 1
            or counts["fused_fields_bwd"] or counts["fused_fields_bwd_layered"]):
        fail(f"{name}: host launches {counts}")
    with torch.no_grad():
        f_err = check_close(f"{name} fields", fields.detach(), fields_flat_reference(spec, net, X, nd, True),
                            **WIDE_FIELD_TOL)
    want, want_x = fields_flat_bwd_reference(spec, net, X, g, nd)
    err = check_close(f"{name} gX", got_x, want_x, **WIDE_GRAD_TOL)
    for i, t in enumerate(got):
        err = max(err, check_close(f"{name} grad {i}", t, want[i // 2]["Wb"[i % 2]], **WIDE_GRAD_TOL))
    print(f"phase 15 (h) {name} {act} P={P} n_dirs={nd}: bwd_plan gives the wide form ({plan.n_blocks} blocks, "
          f"scratch {plan.scratch_bytes} B); fields max_abs_err {f_err:.3e} (rtol {WIDE_FIELD_TOL['rtol']} atol "
          f"{WIDE_FIELD_TOL['atol']}), gX and gradients {err:.3e} (rtol {WIDE_GRAD_TOL['rtol']} atol "
          f"{WIDE_GRAD_TOL['atol']}); host launches {counts}", flush=True)
    return counts, err


def phase15(dev):
    """B2's wide and layered forms.  wide_b2_kernels ((a), (b)),
    layered_replay (e), layered_b2 (f), plan_rule (g), wide_path (h); then (d)
    poisson2d_scaled var_form 0 with the (2, 256, 256, 256, 1) network: 50
    steps through `train` under "pallas" (the loss must fall; B1, the
    layered B2 and the block sum launch and are nodes of the captured step,
    the resident and wide forms are not), and graph steps/s of "pallas" and
    "taylor" in turns.  Returns (timings, host launches by path, the captured
    step's nodes by path)."""
    import hpvpinns_tpu_torch as hv
    from hpvpinns_tpu_torch.training.trainer import _build_chunk

    t0 = time.perf_counter()
    times = wide_b2_kernels(dev)
    times["layered replay"] = layered_replay(dev)
    times["layered"] = layered_b2(dev)
    plan_rule(times["layered"])
    wide_counts, times["wide path"] = wide_path(dev)
    label = "poisson2d_scaled var_form 0 3 x 256"
    c = dataclasses.replace(hv.poisson2d_scaled(), layers=(2, 256, 256, 256, 1), var_form=0)
    c = dataclasses.replace(c, train=dataclasses.replace(c.train, iterations=50, check_every=10, lbfgs_iterations=0,
                                                         threshold=None))
    probs = {m: hv.build(dataclasses.replace(c, deriv_mode=m), device=dev) for m in ("pallas", "taylor")}
    zero_counts()
    res = hv.train(probs["pallas"], verbose=False)
    counts = read_counts()
    hist = res.history["loss"]
    if not np.all(np.isfinite(hist)) or not hist[-1] < hist[0]:
        fail(f"{label}: the loss did not fall: {hist.tolist()}")
    if min(counts[k] for k in LAYERED_PATH) < 1 or counts["fused_fields_bwd"] or counts["fused_fields_bwd_wide"]:
        fail(f"{label}: host launches {counts}")
    prm, opt = fresh_state(probs["pallas"], c)
    ch = _build_chunk(probs["pallas"].loss_fn, opt, prm, probs["pallas"].data, debug=True)
    gn = graph_nodes(ch.graphs[0], "phase15_pallas")
    if min(gn[k] for k in LAYERED_PATH) < 1 or gn["fused_fields_bwd"] or gn["fused_fields_bwd_wide"]:
        fail(f"{label}: the captured step's kernels: {gn}")
    rates, prof = graph_rates(probs, c, steps=100, chunk=10)
    print(f"phase 15 (d) {label} pallas: 50 Adam steps through train, loss {hist[0]:.6e} -> {hist[-1]:.6e}, "
          f"{res.steps_per_sec:.1f} steps/s; host launches {counts}; captured step {gn['nodes']} nodes (B1 "
          f"{gn['fused_fields']}, layered B2 {gn['fused_fields_bwd_layered']} (its kernels), wide B2 "
          f"{gn['fused_fields_bwd_wide']}, block sum {gn['block_sum']})", flush=True)
    for m, r in rates.items():
        us, busy = prof[m]
        print(f"phase 15 (d) {label} {m}: graph steps/s {r[0]!r} {r[1]!r} (100 Adam steps a turn in chunks of 10, "
              f"turns pallas taylor taylor pallas); device us/step "
              + (f"{us!r}, busy {busy!r} in the profiler's window" if us else "not measured"), flush=True)
    times["train"] = {"steps_per_s": {m: r for m, r in rates.items()}, "device_us_per_step": {m: v[0] for m, v in prof.items()}}
    print(f"phase 15 wide and layered B2: {time.perf_counter() - t0:.1f} s", flush=True)
    return times, {label: counts, WIDE_PATH_CASE[0]: wide_counts}, {label: gn}


# The JAX package's rows for Helmholtz-2D and Burgers (benchmarks/ACCURACY.json;
# accuracy comparators only): burgers_default_f32_tpu (:249-259),
# burgers_quality_f32_tpu (:260-270), helmholtz2d_quality_f32_tpu (:548-559,
# with its 10-step LM tail).
JAX_BURGERS_DEFAULT_REL_L2 = 0.525
JAX_BURGERS_QUALITY_REL_L2 = 8.6e-3
BURGERS_QUALITY_TARGET = 1.3e-2
JAX_HELMHOLTZ_QUALITY_REL_L2 = 1.23e-3


def family_configs() -> list:
    """Phase 16 (a)'s configurations: (label, config)."""
    import hpvpinns_tpu_torch as hv

    return [(f"{name} var_form {vf}", dataclasses.replace(c, var_form=vf))
            for name, c in (("Helmholtz2DConfig()", hv.Helmholtz2DConfig()),
                            ("Helmholtz2DConfig(inverse=True)", hv.Helmholtz2DConfig(inverse=True)),
                            ("BurgersConfig()", hv.BurgersConfig()))
            for vf in (0, 1)]


def families_quality(dev, seed=None) -> dict:
    """Phase 16 (d), behind --families-quality: burgers_quality (hard BC on
    "jvp", Adam 10k + L-BFGS 20k) against its target and the JAX row, and
    helmholtz2d_quality with its LM tail cut (gn_iterations=0; the JAX row
    includes the tail, so it is a comparator, not a target).  Returns the
    host launches by path."""
    import hpvpinns_tpu_torch as hv

    paths = {}
    for label, c, jax_row, target in (
        ("burgers_quality jvp", hv.burgers_quality(), JAX_BURGERS_QUALITY_REL_L2, BURGERS_QUALITY_TARGET),
        ("helmholtz2d_quality jvp (LM tail cut: gn_iterations=0)",
         dataclasses.replace(hv.helmholtz2d_quality(), train=dataclasses.replace(hv.helmholtz2d_quality().train,
                                                                                gn_iterations=0)),
         JAX_HELMHOLTZ_QUALITY_REL_L2, None),
    ):
        if seed is not None:
            c = dataclasses.replace(c, train=dataclasses.replace(c.train, seed=seed))
        res, counts, ev = train_checked(hv.build(c, device=dev), c, label)
        paths[label] = counts
        adam, lb = res.phases["adam"], res.phases["lbfgs"]
        verdict = (f"target < {target:g}: {'met' if ev['rel_l2'] < target else 'MISSED'}; " if target else
                   "a comparator: the JAX row has a 10-step LM tail; ")
        print(f"phase 16 (d) {label} seed {c.train.seed}: Adam {c.train.iterations} + L-BFGS "
              f"{c.train.lbfgs_iterations} (f32, layers {c.layers}): rel_l2 {ev['rel_l2']:.4e} ({verdict}JAX f32 row "
              f"{jax_row:g}); final loss {res.history['loss'][-1]:.6e}; wall s Adam {adam['wall_s']:.2f} L-BFGS "
              f"{lb['wall_s']:.2f}; {lbfgs_note(lb)}", flush=True)
    return paths


def phase16(dev):
    """Helmholtz-2D and Burgers through B1/B2.  (a) loss and gradients, k^2's
    included, under "taylor", "pallas" and "jvp" at forms 0 and 1 of
    Helmholtz2DConfig(), its inverse and BurgersConfig() (loss rtol 1e-5,
    gradients rtol 1e-3 / atol 1e-4 against "taylor"); (b)
    graph_against_eager at form 0 "pallas" of both families (B1, B2 and the
    block sum nodes of the captured step); (c) BurgersConfig() under
    "pallas" (5,000 Adam steps: rel-L2 beside the JAX row, within 20% or
    printed as a miss), Helmholtz2DConfig() and its inverse under "pallas"
    (10,001 Adam steps: rel-L2, loss, k^2's relative error and
    closed_form_k_sq from the trained net).  Returns (host launches by
    path, the captured step's nodes by path)."""
    import hpvpinns_tpu_torch as hv
    from hpvpinns_tpu_torch.problems.base import parameters
    from hpvpinns_tpu_torch.problems.helmholtz import closed_form_k_sq

    t0 = time.perf_counter()
    for label, c in family_configs():
        probs = {m: hv.build(dataclasses.replace(c, deriv_mode=m), device=dev) for m in ("taylor", "pallas", "jvp")}
        prm = probs["taylor"].init_params(torch.Generator().manual_seed(c.train.seed))
        out = {}
        for m, prob in probs.items():
            loss, _ = prob.loss_fn(prm, prob.data)
            out[m] = (loss.detach(), torch.autograd.grad(loss, parameters(prm)))
        lt, gt = out["taylor"]
        line = f"phase 16 (a) {label}: loss taylor {lt.item():.6e}"
        for m in ("pallas", "jvp"):
            lm, gm = out[m]
            check_close(f"{label} {m} loss", lm, lt, rtol=1e-5, atol=0.0)
            gerr = max(check_close(f"{label} {m} grad {i}", a, b, rtol=1e-3, atol=1e-4)
                       for i, (a, b) in enumerate(zip(gm, gt)))
            line += f", {m} {lm.item():.6e} (grad max_abs_err {gerr:.3e})"
        if getattr(c, "inverse", False):
            line += f"; d loss / d k_sq {gt[-1].item():.6e}"
        print(line, flush=True)
    nodes = {}
    for label, c in (("Helmholtz2DConfig() var_form 0", hv.Helmholtz2DConfig(var_form=0, deriv_mode="pallas")),
                     ("BurgersConfig() var_form 0", hv.BurgersConfig(var_form=0, deriv_mode="pallas"))):
        c = with_check_every(c, 10)
        nodes[label] = graph_against_eager(f"phase 16 (b) {label}", hv.build(c, device=dev), c, SECOND_PATH)
    paths = {}
    for label, c in (("BurgersConfig() pallas", hv.BurgersConfig(deriv_mode="pallas")),
                     ("Helmholtz2DConfig() pallas", hv.Helmholtz2DConfig(deriv_mode="pallas")),
                     ("Helmholtz2DConfig(inverse=True) pallas", hv.Helmholtz2DConfig(inverse=True, deriv_mode="pallas"))):
        prob = hv.build(c, device=dev)
        res, counts, ev = train_checked(prob, c, label, ("fused_fields",))
        paths[label] = counts
        line = (f"phase 16 (c) {label}: {res.iterations_run} Adam steps (f32, layers {c.layers}, var_form {c.var_form}, "
                f"P {prob.data['elements'].x.numel()}): rel_l2 {ev['rel_l2']:.4e}")
        if c.__class__.__name__ == "BurgersConfig":
            within = abs(ev["rel_l2"] - JAX_BURGERS_DEFAULT_REL_L2) <= 0.2 * JAX_BURGERS_DEFAULT_REL_L2
            line += (f" (JAX f32 row {JAX_BURGERS_DEFAULT_REL_L2}: within 20% "
                     + ("met" if within else "MISSED") + ")")
        if getattr(c, "inverse", False):
            k_sq = res.eval_params["pde"]["k_sq"].item()
            k_true = prob.extras["k_sq_true"]
            k_cf = closed_form_k_sq(prob, res.eval_params)
            line += (f"; k_sq {k_sq:.8g} (true {k_true:g}, from {c.k_sq_init:g}: relative error "
                     f"{abs(k_sq - k_true) / k_true:.4e}); closed_form_k_sq from the trained net {k_cf:.8g} "
                     f"(relative error {abs(k_cf - k_true) / k_true:.4e})")
        line += (f"; final loss {res.history['loss'][-1]:.6e}; wall s Adam {res.phases['adam']['wall_s']:.2f}; "
                 f"{res.steps_per_sec:.1f} steps/s; host launches {counts}")
        print(line, flush=True)
    print(f"phase 16 helmholtz and burgers: {time.perf_counter() - t0:.1f} s", flush=True)
    return paths, nodes


# Phase 17: the Gauss-Newton/LM phase, the float64 polish and checkpoints.
GN_STEP_RTOL = 1e-9  # (a): one LM step on the card in float64 against the CPU
GN_JAC_TOL = 2e-4  # (b): the kernels' gradient tolerance, against each column's largest entry
PORT_HELMHOLTZ_NO_TAIL_REL_L2 = 8.69e-3  # the port without the LM tail (PERF.md section 5, PR 9)
HELMHOLTZ_QUALITY_TARGET = 2.5e-3  # twice JAX's 1.23e-3
# (d): (preset, what JAX reached, where), benchmarks/ACCURACY.json; the
# shortest first (on an NVIDIA H100 80GB HBM3 at 700.00 W the six before
# poisson3d_precision take about 17 minutes, the three L-BFGS schedules of
# 10k-20k iterations 220-335 s each; poisson3d_precision's matrix-free CG
# did not end within the hour a call may take)
PRECISION_ROWS = (
    ("advdiff_precision", 1.51e-3, "ACCURACY.json:440, f64: eps's relative error"),
    ("poisson1d_precision", 1.09e-4, "ACCURACY.json:429, f64"),
    ("advdiff2d_precision", 1.86e-3, "ACCURACY.json:487, f32"),
    ("poisson2d_precision", 7.3e-5, "ACCURACY.json:454, f32"),
    ("helmholtz2d_precision", 3.41e-4, "ACCURACY.json:561, f32"),
    ("burgers_precision", 1.58e-3, "ACCURACY.json:465, f32"),
    ("poisson3d_precision", 1.06e-3, "ACCURACY.json:476, f32, cg"),
    ("kovasznay_precision", 5.61e-5, "ACCURACY.json:497-510, f32, u 5.13e-5 v 2.31e-4 p 7.19e-5, 549.6 s"),
    ("taylorgreen_precision", 2.09e-4, "hpvpinns_tpu/config.py:640-660, f32, u 1.06e-4 v 1.25e-4 p 5.72e-4, "
                                       "~15 min; ACCURACY.json:623 chip row 2.07e-4"),
)
JAX_P2D_POLISH = {"chip": 7.30e-5, "f64_eval": 4.38e-5, "polished": 3.42e-5}  # ACCURACY.json:513-523, 30 steps
JAX_KOV_POLISH = {"chip": 5.61e-5, "f64_eval": 3.91e-5, "polished": 2.87e-5}  # ACCURACY.json:524-535, 50 steps
CHECKPOINTS = "hpvpinns_tpu_torch/_build/checkpoints"


def gn_system(c, device, seed: int = 0, jac_chunk=None):
    """A problem built on `device` with its seeded initial params: (problem,
    theta, r_and_J, loss_of, the damped-step solves, M, P); the Jacobian in
    blocks of `jac_chunk` passes (None: gauss_newton's rule)."""
    import hpvpinns_tpu_torch as hv
    from hpvpinns_tpu_torch.training.gauss_newton import _build_kernels, make_residual_vector, ravel_params

    prob = hv.build(c, device=device)
    params = prob.init_params(torch.Generator().manual_seed(seed))
    theta, unravel = ravel_params(params)
    res = make_residual_vector(prob)
    with torch.no_grad():
        M, P = res(params, prob.data).numel(), theta.numel()
    r_and_J, loss_of, steps = _build_kernels(res, unravel, prob.data, P, M, jac_chunk=jac_chunk)
    return prob, theta, r_and_J, loss_of, steps, M, P


def gn_steps_on_the_card(dev):
    """Phase 17 (a): one LM step of each of the five solves in float64 on
    the card against the same step on the CPU, from the same params and
    data: r and J, then delta, the predicted decrease and |J^T r|_inf of
    each solve (rtol GN_STEP_RTOL; CG and LSQR stopping at the same
    iteration), at a dual Poisson-1D (M < P, lambda 1e-3) and a primal
    Poisson-2D (M > P, lambda 1).  The CPU is the reference the tests hold
    to the JAX package."""
    import hpvpinns_tpu_torch as hv

    cases = (
        ("Poisson-1D (1,8,8,1), dual", hv.Poisson1DConfig(layers=(1, 8, 8, 1), n_test=5, n_quad=12, dtype="float64"),
         1e-3),
        ("Poisson-2D 2x2 elements (2,8,8,1), primal",
         hv.Poisson2DConfig(n_elements_x=2, n_elements_y=2, n_quad=6, n_test_x=3, n_test_y=3, layers=(2, 8, 8, 1),
                            dtype="float64"), 1.0),
    )
    for label, c, lam in cases:
        out = []
        for d in (dev, torch.device("cpu")):
            _, theta, r_and_J, _, steps, M, P = gn_system(c, d)
            r, J = r_and_J(theta)
            lam_t = torch.tensor(lam, dtype=torch.float64, device=d)
            out.append({"r": r.cpu(), "J": J.cpu()})
            for name, step in steps.items():
                got = step(theta, lam_t) if name in ("cg", "lsqr") else step(r, J, lam_t)
                out[-1][name] = [g.cpu() if torch.is_tensor(g) else torch.tensor(g, dtype=torch.float64)
                                     for g in got[:3]] + ([got[3]] if len(got) > 3 else [])
        card, host = out
        errs = {k: check_close(f"{label} {k} card vs CPU", card[k], host[k], rtol=1e-12,
                               atol=1e-14 * host[k].abs().max().item()) for k in ("r", "J")}
        line = f"phase 17 (a) {label}, M {M}, P {P}, lambda {lam:g}: r/J max_abs_err {errs['r']:.2e} / {errs['J']:.2e}"
        for name in ("normal", "host", "qr", "cg", "lsqr"):
            a, b = card[name], host[name]
            derr = check_close(f"{label} {name} delta", a[0], b[0], rtol=GN_STEP_RTOL,
                               atol=GN_STEP_RTOL * b[0].abs().max().item())
            for k, what in ((1, "predicted decrease"), (2, "|J^T r|_inf")):
                check_close(f"{label} {name} {what}", a[k], b[k], rtol=GN_STEP_RTOL, atol=0.0)
            if len(a) > 3 and a[3] != b[3]:
                fail(f"{label} {name}: {a[3]} iterations on the card, {b[3]} on the CPU")
            line += f"; {name} delta max_abs_err {derr:.2e}" + (f" ({a[3]} iterations both)" if len(a) > 3 else "")
        print(line, flush=True)


def timed_jacobian(r_and_J, theta):
    """((r, J), seconds of the build, device sync included)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = r_and_J(theta)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def gn_pallas_jacobian(dev) -> dict:
    """Phase 17 (b): the dual (reverse-mode) Jacobian under "pallas" (B1 in
    the forward, B2 and the block sum once for each cotangent) against
    "taylor" at advdiff_forward_precision's network, grid and test space in
    float32 (P 2,241, M 555) without its layer feature, which forces the
    JVP engine (as in the JAX package) and so no kernel: r within the field
    tolerance, J within GN_JAC_TOL of each column's largest entry.  The
    counts are zeroed just before the "pallas" build and read just after;
    both builds are timed (the first of each includes one-time set-up, so
    each is built twice).  Then two LM steps (QR, the preset's solve) on
    "pallas", and the forward-mode cases raising the documented TypeError:
    the primal Jacobian (poisson2d_scaled, P 921 <= M 6,720) and "cg".
    Returns the launches and times for the kernels line."""
    import hpvpinns_tpu_torch as hv
    from hpvpinns_tpu_torch.ops.fused_fields import FORWARD_MODE_ERROR

    base = dataclasses.replace(hv.advdiff_forward_precision(), layer_feature=False)
    out, times = {}, {}
    for mode in ("taylor", "pallas"):
        c = dataclasses.replace(base, deriv_mode=mode)
        prob, theta, r_and_J, _, _, M, P = gn_system(c, dev, c.train.seed)
        timed_jacobian(r_and_J, theta)
        if mode == "pallas":
            zero_counts()
        out[mode], times[mode] = timed_jacobian(r_and_J, theta)
        if mode == "pallas":
            counts = read_counts()
    (rp, Jp), (rt, Jt) = out["pallas"], out["taylor"]
    if M >= P:
        fail(f"phase 17 (b): M {M} >= P {P}, not the dual Jacobian")
    rerr = check_close("phase 17 (b) r pallas vs taylor", rp, rt, rtol=FIELD_TOL["rtol"],
                       atol=FIELD_TOL["rtol"] * rt.abs().max().item())
    scale = Jt.abs().amax(dim=0).clamp_min(1e-30)
    jerr = check_close("phase 17 (b) J pallas vs taylor, column-scaled", Jp / scale, Jt / scale, rtol=0.0, atol=GN_JAC_TOL)
    if min(counts[k] for k in SECOND_PATH) < 1:
        fail(f"phase 17 (b): the Jacobian build's launches {counts}")
    c = dataclasses.replace(base, deriv_mode="pallas")
    prob = hv.build(c, device=dev)
    gn = hv.gauss_newton(prob, prob.init_params(torch.Generator().manual_seed(c.train.seed)), iterations=2,
                         solve=c.train.gn_solve, verbose=False)
    if gn.accepted != 2 or not np.all(np.diff(gn.history["loss"]) < 0):
        fail(f"phase 17 (b): LM on pallas: {gn.accepted} accepted, losses {gn.history.get('loss')}")
    raised = []
    for label, c2, solve in (("poisson2d_scaled primal", dataclasses.replace(hv.poisson2d_scaled(), deriv_mode="pallas"),
                              None), ("cg", c, "cg")):
        p2 = hv.build(c2, device=dev)
        try:
            hv.gauss_newton(p2, p2.init_params(torch.Generator().manual_seed(0)), iterations=1, solve=solve,
                            verbose=False)
        except TypeError as err:
            if str(err) != FORWARD_MODE_ERROR:
                fail(f"phase 17 (b) {label}: another TypeError: {err}")
            raised.append(label)
        else:
            fail(f"phase 17 (b) {label}: forward mode under pallas did not raise")
    print(
        f"phase 17 (b) advdiff_forward_precision without layer_feature (layers {base.layers}, f32), M {M}, P {P}: "
        f"r max_abs_err {rerr:.3e}; J column-scaled max err {jerr:.3e} (tolerance {GN_JAC_TOL}); host launches of "
        f"one pallas Jacobian build {counts} (M {M} cotangents); Jacobian build s pallas {times['pallas']!r} taylor "
        f"{times['taylor']!r}; LM on pallas (qr): 2 accepted, loss {gn.history['loss'].tolist()}; forward mode "
        f"raises the documented TypeError: {', '.join(raised)}",
        flush=True,
    )
    return {"counts": counts, "M": M, "P": P, "jacobian_s": times["pallas"], "taylor_jacobian_s": times["taylor"]}


def gn_note(res) -> str:
    """The LM phase of a run, for a printed line."""
    gn = res.phases["gn"]
    h = res.history
    lm = ~np.isnan(h["damping"])
    return (f"LM {gn['accepted']} accepted, {gn['rejected']} rejected, stopped '{gn['stopped']}', final lambda "
            f"{gn['damping']:.3e}, wall s {gn['wall_s']:.2f}; LM loss {h['loss'][lm][[0, -1]].tolist()} "
            f"(records: loss {h['loss'][lm].tolist()}, damping {h['damping'][lm].tolist()})")


def train_with_gn(prob, c, label: str, verbose=False) -> tuple:
    """train_checked, then the phases' walls and the LM phase's steps: (result,
    evaluation, printed summary)."""
    res, counts, ev = train_checked(prob, c, label, verbose=verbose)
    walls = ", ".join(f"{k} {v['wall_s']:.2f}" for k, v in res.phases.items())
    return res, ev, f"wall s {walls}; {gn_note(res)}"


def gn_helmholtz_quality(dev, seed=None) -> None:
    """Phase 17 (c): helmholtz2d_quality whole, (2,30,30,30,1) sin, hard BC
    on "jvp": Adam 5k, L-BFGS 5k and the 10-step QR LM tail.  rel-L2
    against HELMHOLTZ_QUALITY_TARGET, JAX's 1.23e-3 and the port's 8.69e-3
    without the tail (a miss is printed, not failed)."""
    import hpvpinns_tpu_torch as hv

    c = hv.helmholtz2d_quality()
    if seed is not None:
        c = dataclasses.replace(c, train=dataclasses.replace(c.train, seed=seed))
    res, ev, note = train_with_gn(hv.build(c, device=dev), c, "helmholtz2d_quality")
    verdict = "met" if ev["rel_l2"] < HELMHOLTZ_QUALITY_TARGET else "MISSED"
    print(f"phase 17 (c) helmholtz2d_quality seed {c.train.seed}: rel_l2 {ev['rel_l2']:.4e} (target < "
          f"{HELMHOLTZ_QUALITY_TARGET:g}: {verdict}; JAX f32 row {JAX_HELMHOLTZ_QUALITY_REL_L2:g}; the port without "
          f"the tail {PORT_HELMHOLTZ_NO_TAIL_REL_L2:g}); final loss {res.history['loss'][-1]:.6e}; {note}", flush=True)


def gn_precision(dev, seed=None, names=()) -> None:
    """Phase 17 (d), behind --precision: the GN presets (those in `names`,
    default all) at their whole schedules (rel-L2, or eps's relative error
    for advdiff_precision, beside the JAX row), and after
    poisson2d_precision polish_f64 of its trained net (30 float64 LM steps
    on the card, as the JAX row), beside poisson2d_hybrid_polish."""
    import hpvpinns_tpu_torch as hv
    from hpvpinns_tpu_torch.problems.base import parameters
    from hpvpinns_tpu_torch.training.hybrid import polish_f64

    for name, jax_row, where in PRECISION_ROWS:
        if names and name not in names:
            continue
        c = getattr(hv, name)()
        if seed is not None:
            c = dataclasses.replace(c, train=dataclasses.replace(c.train, seed=seed))
        if name in NS_JAC_CHUNK:
            c = dataclasses.replace(c, train=dataclasses.replace(c.train, gn_jac_chunk=NS_JAC_CHUNK[name]))
        t0 = time.perf_counter()
        prob = hv.build(c, device=dev)
        if name in NS_PRESETS:  # the Jacobian the LM phase builds, at the initial params
            print(f"phase 17 (d) {name}: {ns_jacobian_note(c, dev, c.train.gn_jac_chunk)}", flush=True)
        res, ev, note = train_with_gn(prob, c, name, verbose=name in NS_PRESETS)
        if name == "advdiff_precision":
            eps = prob.extras["eps_domain_mean"](res.eval_params)
            eps = float(eps.item() if torch.is_tensor(eps) else eps)
            got = f"eps {eps:.6g} (true {prob.extras['eps_true']:.6g}), relative error " \
                  f"{abs(eps - prob.extras['eps_true']) / prob.extras['eps_true']:.4e}; rel_l2 {ev['rel_l2']:.4e}"
        else:
            got = f"rel_l2 {ev['rel_l2']:.4e}" + "".join(
                f" {k[7:]} {v:.4e}" for k, v in ev.items() if k.startswith("rel_l2_"))
        print(f"phase 17 (d) {name} seed {c.train.seed} ({c.dtype}, layers {c.layers}, solve "
              f"{c.train.gn_solve or 'default'}): {got} (JAX {jax_row:g}, {where}); final loss "
              f"{res.history['loss'][-1]:.6e}; {note}; {time.perf_counter() - t0:.1f} s", flush=True)
        if name == "kovasznay_precision":
            pol = polish_f64(c, res.params, iterations=50, device=dev)
            print(f"phase 17 (d) polish_f64 of the kovasznay_precision net: rel_l2 f32 {ev['rel_l2']:.4e}, f64 "
                  f"evaluation {pol.metrics_start['rel_l2']:.4e}, polished {pol.metrics['rel_l2']:.4e} (components "
                  f"u {pol.metrics['rel_l2_u']:.4e} v {pol.metrics['rel_l2_v']:.4e} p {pol.metrics['rel_l2_p']:.4e}; "
                  f"JAX kovasznay_hybrid_polish {JAX_KOV_POLISH}); {pol.accepted} accepted, stopped '{pol.stopped}', "
                  f"loss {pol.loss:.6e}, {pol.wall_s:.1f} s", flush=True)
        if name == "poisson2d_precision":
            pol = polish_f64(c, res.params, iterations=30, device=dev)
            print(f"phase 17 (d) polish_f64 of the poisson2d_precision net: rel_l2 f32 {ev['rel_l2']:.4e}, f64 "
                  f"evaluation {pol.metrics_start['rel_l2']:.4e}, polished {pol.metrics['rel_l2']:.4e} (JAX "
                  f"{JAX_P2D_POLISH}); {pol.accepted} accepted, stopped '{pol.stopped}', loss {pol.loss:.6e}, "
                  f"{pol.wall_s:.1f} s; params {sorted({str(t.dtype) for t in parameters(pol.params)})}", flush=True)


def gn_checkpoints(dev) -> None:
    """Phase 17 (e): poisson2d_scaled under "pallas", 200 Adam steps under
    the graph with checkpoints every 100 (asynchronous, keep 2) into the
    build directory; the latest restored equals the result bit for bit,
    step 100 carries Adam's step count, and a run resumed from it trains."""
    import os
    import shutil

    import hpvpinns_tpu_torch as hv
    from hpvpinns_tpu_torch.problems.base import parameters
    from hpvpinns_tpu_torch.training.checkpoint import Checkpointer

    shutil.rmtree(CHECKPOINTS, ignore_errors=True)
    base = dataclasses.replace(hv.poisson2d_scaled(), deriv_mode="pallas")
    c = dataclasses.replace(base, train=dataclasses.replace(
        base.train, iterations=200, check_every=50, checkpoint_dir=CHECKPOINTS, checkpoint_every=100,
        checkpoint_keep_last=2, checkpoint_async=True))
    prob = hv.build(c, device=dev)
    res = hv.train(prob, verbose=False)
    saved = sorted(os.listdir(CHECKPOINTS))
    if saved != ["step_00000100", "step_00000200"]:
        fail(f"phase 17 (e): checkpoints {saved}")
    ck = Checkpointer(CHECKPOINTS)
    step, tree = ck.restore(like={"params": res.params, "opt_state": None})
    for a, b in zip(parameters(tree["params"]), parameters(res.params)):
        if a.device != b.device or not torch.equal(a, b.detach()):
            fail("phase 17 (e): the restored params are not the result's")
    step, tree = ck.restore(100, like={"params": res.params, "opt_state": None})
    if step != 100 or int(tree["opt_state"]["state"][0]["step"]) != 100:
        fail(f"phase 17 (e): step {step}, Adam's step {tree['opt_state']['state'][0]['step']}")
    c2 = dataclasses.replace(c, train=dataclasses.replace(c.train, iterations=100, checkpoint_dir=None))
    res2 = hv.train(prob, c2.train, params=tree["params"], verbose=False)
    h = res2.history["loss"]
    if not (np.all(np.isfinite(h)) and h[-1] < res.history["loss"][1]):
        fail(f"phase 17 (e): the resumed run's loss {h.tolist()}")
    print(f"phase 17 (e) checkpoints of poisson2d_scaled pallas under the graph: {saved}, the latest restored bit for "
          f"bit, step 100 with Adam's step 100; resumed 100 steps: loss {h[0]:.6e} -> {h[-1]:.6e} (the first run at "
          f"100 and 200: {res.history['loss'][1]:.6e}, {res.history['loss'][3]:.6e})", flush=True)
    shutil.rmtree(CHECKPOINTS, ignore_errors=True)


def phase17(dev) -> dict:
    """Phase 17, the Gauss-Newton/LM phase: (a), (b), (c) and (e); (d) runs
    behind --precision.  Returns (b)'s launches and times."""
    t0 = time.perf_counter()
    gn_steps_on_the_card(dev)
    jac = gn_pallas_jacobian(dev)
    gn_helmholtz_quality(dev)
    gn_checkpoints(dev)
    print(f"phase 17 gauss-newton: {time.perf_counter() - t0:.1f} s", flush=True)
    return jac


# Phase 18: the Navier-Stokes systems, Kovasznay and Taylor-Green, on the JVP
# engine (a (u, v, p) output: no kernel takes it, so this path launches none).
NS_PRESETS = ("kovasznay_quality", "kovasznay_precision", "taylorgreen_quality", "taylorgreen_precision")
NS_RATE_STEPS = {"taylorgreen_precision": 20}  # (c): steps a turn where not 50
NS_LOSS_RTOL = 1e-5  # (a): the f32 loss on the card against the f64 loss on the CPU
NS_GRAD_TOL = 1e-4  # (a): each gradient leaf, against its largest entry
NS_CUT = (2000, 500)  # (d): kovasznay_quality's Adam and L-BFGS iterations in the default run
# (f): the Jacobian's block size under --precision.  taylorgreen_precision's
# primal J (12,580 x 5,453, forward mode) took 27.33 / 14.62 / 10.88 s a build
# in blocks of 128 / 256 / 512 passes at a peak of 7.80 / 15.16 / 29.89 GiB on
# an NVIDIA H100 80GB HBM3 at 700.00 W (--ns-jacobian 128 256 512): 512
# fits beside the LM phase's J, QR and Q (~1 GiB) and is the fastest measured.
NS_JAC_CHUNK = {"taylorgreen_precision": 512}
# (e): the JAX package's f32 rows (rel-L2, then u, v, p), from the presets' docstrings
JAX_NS_QUALITY = {"kovasznay_quality": (7.1e-3, 6.5e-3, 3.0e-2, 8.7e-3),
                  "taylorgreen_quality": (6.6e-3, 3.2e-3, 4.3e-3, 1.8e-2)}


def ns_configs() -> list:
    """Phase 18 (a)'s configurations: the four presets (soft BC; hard BC;
    the zero-mean gauge at taylorgreen_precision) and each quality preset
    with a trainable nu and velocity-only boundary data (the anchor)."""
    import hpvpinns_tpu_torch as hv

    out = [(name, getattr(hv, name)()) for name in NS_PRESETS]
    for name in ("kovasznay_quality", "taylorgreen_quality"):
        out.append((f"{name}(inverse, bc_pressure=False)",
                    dataclasses.replace(getattr(hv, name)(), inverse=True, bc_pressure=False)))
    return out


def ns_card_against_cpu(dev) -> None:
    """Phase 18 (a): each configuration built on the card (f32) and on the
    CPU (f64) from the same params (the card's seeded init, widened): the
    loss within NS_LOSS_RTOL, every aux key printed, and each gradient leaf
    (nu's included) within NS_GRAD_TOL of its largest entry."""
    import hpvpinns_tpu_torch as hv
    from hpvpinns_tpu_torch.problems.base import parameters

    for label, c in ns_configs():
        card = hv.build(c, device=dev)
        host = hv.build(dataclasses.replace(c, dtype="float64"), device="cpu")
        p32 = card.init_params(torch.Generator().manual_seed(c.train.seed))
        p64 = hv.params_from_jax(hv.params_to_numpy(p32), dtype=torch.float64)
        out = {}
        for key, prob, prm in (("card", card, p32), ("cpu", host, p64)):
            loss, aux = prob.loss_fn(prm, prob.data)
            out[key] = (loss.detach().cpu().double(), {k: float(v.detach()) for k, v in aux.items()},
                        [g.cpu().double() for g in torch.autograd.grad(loss, parameters(prm))])
        (l32, a32, g32), (l64, a64, g64) = out["card"], out["cpu"]
        check_close(f"phase 18 (a) {label} loss", l32, l64, rtol=NS_LOSS_RTOL, atol=0.0)
        worst = 0.0
        for i, (a, b) in enumerate(zip(g32, g64)):
            scale = b.abs().max().clamp_min(1e-30)
            worst = max(worst, check_close(f"phase 18 (a) {label} grad {i}", a / scale, b / scale, rtol=0.0,
                                           atol=NS_GRAD_TOL))
        print(f"phase 18 (a) {label} (layers {c.layers}, P {card.data['elements'].x.numel()} points, hard_bc "
              f"{c.hard_bc}): loss card f32 {l32.item():.8e} CPU f64 {l64.item():.8e} (rel diff "
              f"{abs(l32.item() - l64.item()) / abs(l64.item()):.2e}); aux card {a32}; worst gradient leaf "
              f"{worst:.2e} of its largest entry (tolerance {NS_GRAD_TOL})", flush=True)


def ns_graphs_and_rates(dev) -> None:
    """Phase 18 (b) and (c) at the four presets: one chunk of 20 Adam steps
    as CUDA graphs against the eager chunk, bit for bit, with the captured
    step's nodes; then steps/s of the graph chunk and the eager one (50
    steps a turn, 20 at taylorgreen_precision whose eager step takes ~0.45 s,
    in chunks of 10, turns e g g e), device us a step and the
    busy share under the graph (torch.profiler over 20 replayed steps)."""
    import hpvpinns_tpu_torch as hv

    for name in NS_PRESETS:
        c = with_check_every(getattr(hv, name)(), 20)
        prob = hv.build(c, device=dev)
        step_nodes = graph_against_eager(f"phase 18 (b) {name}", prob, c, ())
        zero_counts()
        rates, (gch, _) = chunk_rates(prob, c, NS_RATE_STEPS.get(name, 50))
        counts = read_counts()
        if any(counts.values()) or any(step_nodes[k] for k in KERNEL_NODES):
            fail(f"phase 18 {name}: a kernel ran on the JVP path: host launches {counts}, nodes {step_nodes}")
        g_us, g_busy = graph_profile(gch)
        e, g = rates["eager"], rates["graph"]
        g_rate = (g[0] + g[1]) / 2
        print(f"phase 18 (c) {name}: steps/s eager {e[0]!r} {e[1]!r} graph {g[0]!r} {g[1]!r} (graph / eager "
              f"{(g[0] + g[1]) / (e[0] + e[1]):.2f}x); captured step {step_nodes['nodes']} nodes, "
              f"{step_nodes['kernels']} kernels; device us/step "
              + (f"{g_us!r}, busy {g_busy!r} in the profiler's window, {g_us * 1e-6 * g_rate!r} as device us/step x "
                 f"graph steps/s" if g_us else "not measured"), flush=True)


def ns_summary(res, ev) -> str:
    """rel-L2 with its components, the phases' walls and L-BFGS's behaviour."""
    walls = ", ".join(f"{k} {v['wall_s']:.2f}" for k, v in res.phases.items())
    out = (f"rel_l2 {ev['rel_l2']:.4e} (u {ev['rel_l2_u']:.4e}, v {ev['rel_l2_v']:.4e}, p {ev['rel_l2_p']:.4e}); "
           f"final loss {res.history['loss'][-1]:.6e}; wall s {walls}")
    if "lbfgs" in res.phases:
        out += f"; {lbfgs_note(res.phases['lbfgs'])}"
    return out


def ns_cut_schedule(dev) -> None:
    """Phase 18 (d): kovasznay_quality at its width, its schedule cut to
    NS_CUT (Adam, L-BFGS): train, evaluate (rel-L2 and its u, v, p keys);
    the loss must fall and no kernel may launch."""
    import hpvpinns_tpu_torch as hv

    base = hv.kovasznay_quality()
    c = dataclasses.replace(base, train=dataclasses.replace(base.train, iterations=NS_CUT[0],
                                                            lbfgs_iterations=NS_CUT[1], check_every=250))
    res, counts, ev = train_checked(hv.build(c, device=dev), c, "phase 18 (d) kovasznay_quality cut")
    h = res.history["loss"]
    if not h[-1] < h[0] or any(counts.values()):
        fail(f"phase 18 (d): loss {h[[0, -1]].tolist()}, host launches {counts}")
    print(f"phase 18 (d) kovasznay_quality cut to Adam {NS_CUT[0]} + L-BFGS {NS_CUT[1]} (layers {c.layers}, f32): "
          f"{ns_summary(res, ev)} (JAX's full 10k + 10k: {JAX_NS_QUALITY['kovasznay_quality'][0]:g})", flush=True)


def ns_quality(dev, seed=None) -> None:
    """Phase 18 (e), behind --ns-quality: kovasznay_quality and
    taylorgreen_quality at their whole schedules (Adam 10k + L-BFGS 10k),
    beside the JAX package's f32 rows."""
    import hpvpinns_tpu_torch as hv

    for name in ("kovasznay_quality", "taylorgreen_quality"):
        c = getattr(hv, name)()
        if seed is not None:
            c = dataclasses.replace(c, train=dataclasses.replace(c.train, seed=seed))
        t0 = time.perf_counter()
        res, _, ev = train_checked(hv.build(c, device=dev), c, name)
        j = JAX_NS_QUALITY[name]
        print(f"phase 18 (e) {name} seed {c.train.seed} (layers {c.layers}, f32): {ns_summary(res, ev)}; JAX f32 row "
              f"{j[0]:g} (u {j[1]:g}, v {j[2]:g}, p {j[3]:g}); {time.perf_counter() - t0:.1f} s", flush=True)


def ns_jacobian_note(c, dev, jac_chunk=None) -> str:
    """One build of the Gauss-Newton Jacobian of configuration `c` at its
    seeded initial params on the card, in blocks of `jac_chunk` passes (None:
    gauss_newton's rule): its kind, shape, seconds (device sync included)
    and the peak of allocated device memory during the build."""
    _, theta, r_and_J, _, _, M, P = gn_system(c, dev, c.train.seed, jac_chunk)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (r, J), secs = timed_jacobian(r_and_J, theta)
    peak = torch.cuda.max_memory_allocated() - base
    if tuple(J.shape) != (M, P) or not bool(torch.isfinite(J).all()):
        fail(f"{type(c).__name__}: J {tuple(J.shape)}, finite {bool(torch.isfinite(J).all())}")
    n_pass = min(M, P)
    chunk = jac_chunk or (n_pass if n_pass <= 2048 else 256)
    del r, J
    return (f"Jacobian {'primal (forward mode, vmapped JVPs)' if P <= M else 'dual (reverse mode, vmapped VJPs)'} "
            f"M {M} x P {P}, in blocks of {min(chunk, n_pass)} of {n_pass} passes: {secs:.2f} s, peak device memory "
            f"{peak / 2**30:.2f} GiB above the {base / 2**30:.2f} GiB held before")


def ns_jacobians(dev, chunks=()) -> None:
    """Behind --ns-jacobian [CHUNK...]: the precision presets' Jacobian builds
    at the given block sizes (default: gauss_newton's rule only), each with
    its seconds and peak device memory, the smallest first."""
    import hpvpinns_tpu_torch as hv

    for name in ("kovasznay_precision", "taylorgreen_precision"):
        c = getattr(hv, name)()
        for chunk in sorted(chunks) or [None]:
            print(f"phase 18 jacobian {name} jac_chunk {chunk}: {ns_jacobian_note(c, dev, chunk)}", flush=True)


NS_STAGE_DIR = "chiprun_out/ns_stage"


def ns_precision_stage(dev, stage: str, name: str, source=None) -> None:
    """Behind --ns-precision-stage: a precision preset's whole schedule in
    two calls, for a schedule longer than one call may take.  Stage
    "adam-lbfgs" runs its Adam and L-BFGS phases (gn_iterations=0),
    evaluates, and checkpoints the params where L-BFGS ends under
    NS_STAGE_DIR/NAME; stage "lm" restores them from the checkpoint
    directory `source` and runs the preset's LM phase (its Jacobian in
    blocks of NS_JAC_CHUNK), then evaluates beside the JAX row.  The LM
    phase starts from the params L-BFGS ended at, as in one run of the
    schedule."""
    import hpvpinns_tpu_torch as hv
    from hpvpinns_tpu_torch.training.checkpoint import Checkpointer

    preset = getattr(hv, name)()
    jax_row = dict((n, (r, w)) for n, r, w in PRECISION_ROWS)[name]
    t0 = time.perf_counter()
    if stage == "adam-lbfgs":
        c = dataclasses.replace(preset, train=dataclasses.replace(
            preset.train, gn_iterations=0, checkpoint_dir=f"{NS_STAGE_DIR}/{name}"))
        res, _, ev = train_checked(hv.build(c, device=dev), c, f"{name} {stage}", verbose=True)
    elif stage == "lm":
        c = dataclasses.replace(preset, train=dataclasses.replace(
            preset.train, iterations=0, lbfgs_iterations=0, gn_jac_chunk=NS_JAC_CHUNK.get(name)))
        prob = hv.build(c, device=dev)
        like = {"params": prob.init_params(torch.Generator().manual_seed(c.train.seed)), "opt_state": None}
        step, tree = Checkpointer(source).restore(like=like)
        print(f"phase 17 (d) {name} {stage}: from step {step} of {source}; "
              f"{ns_jacobian_note(c, dev, c.train.gn_jac_chunk)}", flush=True)
        res, _, ev = train_checked(prob, c, f"{name} {stage}", verbose=True, params=tree["params"])
    else:
        fail(f"--ns-precision-stage: unknown stage {stage!r} (adam-lbfgs or lm)")
    note = f"; {gn_note(res)}" if "gn" in res.phases else ""
    print(f"phase 17 (d) {name} {stage} seed {c.train.seed} ({c.dtype}, layers {c.layers}): {ns_summary(res, ev)}"
          f"{note} (JAX {jax_row[0]:g} after the whole schedule, {jax_row[1]}); {time.perf_counter() - t0:.1f} s",
          flush=True)


def phase18(dev) -> None:
    """Phase 18, the Navier-Stokes systems: (a), (b), (c) and (d); (e) runs
    behind --ns-quality and the precision presets behind --precision."""
    t0 = time.perf_counter()
    ns_card_against_cpu(dev)
    ns_graphs_and_rates(dev)
    ns_cut_schedule(dev)
    print(f"phase 18 navier-stokes: {time.perf_counter() - t0:.1f} s", flush=True)


# Phase 19, adaptive hp refinement.  The JAX package's rows are f32 runs on a
# TPU (benchmarks/MEASUREMENTS.md); they are comparators, not targets.
ETA_PRESETS = ("poisson1d_quality", "poisson2d_quality", "helmholtz2d_quality", "advdiff_quality", "AdvDiff2DConfig",
               "burgers_quality", "kovasznay_quality", "taylorgreen_quality")
ETA_PALLAS = ("poisson1d_quality", "poisson2d_quality", "advdiff_quality", "AdvDiff2DConfig")  # soft BC, kernel-able
ETA_TOL = 1e-3  # |eta f32 card - eta f64 CPU| over the largest eta, on top of f32's floor
ETA_NOISE = 30.0  # eta's f32 floor is (ETA_NOISE eps_f32 max|Res|)^2, Res the training-basis residual
ETA_W0_SCALE = 8.0  # the init's first layer scaled: an ansatz with content on the modes beyond the basis
ETA_THETA = 0.5
# (rounds, Adam, L-BFGS) a round: the whole run's cut and the recorded budget (--adaptive)
ADAPT_P1D_BUDGET = {"cut": (3, 1000, 500), "full": (4, 3000, 2000)}
ADAPT_P2D_BUDGET = {"cut": (3, 1000, 500), "full": (3, 4000, 3000)}
JAX_ADAPT_P1D = (7.9e-2, 0.30, 0.33, 0.79)  # MEASUREMENTS.md:526-531, baseline row, lr_decay 0.5
JAX_ADAPT_P2D = (1.12e-2, 7.3e-3, 5.1e-3)  # MEASUREMENTS.md:496-499
JAX_ADAPT_BURGERS = (5.5e-2, 3.6e-2, 3.4e-2, 5.9e-3)  # MEASUREMENTS.md:548-556, the README's command
BURGERS_README = (4, 1.4, 5000, 5000)  # rounds, budget growth, Adam, L-BFGS of the README's `adapt burgers` command
H_SWEEP = ((1, 2, 4), 5000)  # elements, Adam steps (benchmarks/sweep_p1d_h/h_sweep.json's 5,000)
GALERKIN_1D = (5.5e-2, 3.4e-3, 2.2e-3, 9.3e-5, 3.0e-5)  # MEASUREMENTS.md:503-507, f64 on the host
GALERKIN_RTOL = 0.03  # the recorded trajectory has two significant figures
ADAPT_MEM_GROWTH = 64 << 20  # device memory still allocated after a round's train, above round 0's


def eta_marks_comparable(eta: np.ndarray, tol_abs: float, theta: float = ETA_THETA) -> bool:
    """Whether Dörfler marking at `theta` is decided by more than `tol_abs`:
    the sorted eta's gap at the cut and the cumulative sums' distance from
    the cut both exceed it (an f32 eta can order a near-tie otherwise)."""
    s = np.sort(eta)[::-1]
    csum = np.cumsum(s)
    cut = theta * csum[-1]
    k = int(np.searchsorted(csum, cut)) + 1
    gap = s[k - 1] - s[k] if k < len(s) else np.inf
    margin = min(abs(csum[k - 1] - cut), abs(csum[k - 2] - cut) if k >= 2 else np.inf)
    return gap > 2 * tol_abs and margin > len(s) * tol_abs


def eta_card_against_cpu(dev) -> dict:
    """Phase 19 (a): each family's enriched indicator at its preset's sizes,
    built on the card in float32 and on the CPU in float64 from the same
    params (the card's seeded init with its first layer's weights scaled by
    ETA_W0_SCALE, widened; at the plain init a smooth ansatz's eta is below
    float32's floor in most families), "pallas" where the preset has
    soft BC and one output: eta within ETA_TOL of the largest eta plus
    float32's floor, (ETA_NOISE eps_f32 max|Res|)^2 with Res the
    training-basis residual (the enriched residual sums terms of that size:
    a smooth ansatz's projection on the modes beyond the basis can be below
    float32's resolution of them), and the Dörfler marks equal where no
    near-tie within that tolerance decides them.  Returns each preset's host
    launches."""
    import hpvpinns_tpu_torch as hv
    from hpvpinns_tpu_torch import adaptive as tad

    paths = {}
    for name in ETA_PRESETS:
        c = getattr(hv, name)()
        if name in ETA_PALLAS:
            c = dataclasses.replace(c, deriv_mode="pallas")
        card = hv.build(dataclasses.replace(c, dtype="float32"), device=dev)
        host = hv.build(dataclasses.replace(c, dtype="float64"), device="cpu")
        p32 = card.init_params(torch.Generator().manual_seed(c.train.seed))
        with torch.no_grad():
            p32["net"][0]["W"].mul_(ETA_W0_SCALE)
        p64 = hv.params_from_jax(hv.params_to_numpy(p32), dtype=torch.float64)
        zero_counts()
        t0 = time.perf_counter()
        e32 = tad.element_indicator(card, p32)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        counts = read_counts()
        e64 = tad.element_indicator(host, p64)
        with torch.no_grad():
            res_scale = float(host.extras["residual_fn"](p64, host.data).abs().max())
        floor = (ETA_NOISE * float(np.finfo(np.float32).eps) * res_scale) ** 2
        tol = ETA_TOL * float(e64.max()) + floor
        err = float(np.abs(e32.astype(np.float64) - e64).max())
        if e32.dtype != np.float32 or e32.shape != e64.shape or not np.all(np.isfinite(e32)) or err > tol:
            fail(f"phase 19 (a) {name}: eta card {e32.tolist()} against CPU {e64.tolist()} (max err {err:.3e})")
        comparable = eta_marks_comparable(e64, tol)
        if comparable and not np.array_equal(tad.dorfler_mark(e32, ETA_THETA), tad.dorfler_mark(e64, ETA_THETA)):
            fail(f"phase 19 (a) {name}: Dörfler marks differ with no near-tie: card {e32.tolist()} CPU {e64.tolist()}")
        if name in ("advdiff_quality", "AdvDiff2DConfig") and counts["fused_fields"] < 1:
            fail(f"phase 19 (a) {name}: the enriched fields did not run through B1: {counts}")
        paths[f"enriched eta {name}"] = counts
        print(f"phase 19 (a) {name} ({c.deriv_mode}, layers {c.layers}, E {e64.size}, P "
              f"{card.data['elements'].x.numel()}): eta max err {err / float(e64.max()):.2e} of the largest "
              f"(tolerance {ETA_TOL} of it + the f32 floor {floor:.2e} = {tol / float(e64.max()):.2e} of it); "
              f"marks at theta {ETA_THETA} "
              + ("equal" if comparable else "not compared (a near-tie decides them)")
              + f"; the largest eta {'above' if float(e64.max()) > floor else 'below'} the f32 floor"
              + f"; eta max/min {float(e64.max() / max(e64.min(), 1e-300)):.3e}; card {card_s * 1e3:.1f} ms; "
              f"host launches {counts}", flush=True)
    return paths


def adapt_p1d_config(budget):
    """The steep Poisson-1D study (MEASUREMENTS.md:526-531): grid [-1, 0, 1],
    p15, q40, the (1,20,20,20,1) sin net, var_form 1 (second derivatives:
    B1, B2 and the block sum) under "pallas"."""
    import hpvpinns_tpu_torch as hv

    _, adam, lbfgs = budget
    c = dataclasses.replace(hv.poisson1d_of_record(), grid=(-1.0, 0.0, 1.0), n_elements=2, n_test=15, n_quad=40,
                            layers=(1, 20, 20, 20, 1), deriv_mode="pallas")
    return dataclasses.replace(c, train=dataclasses.replace(c.train, iterations=adam, lbfgs_iterations=lbfgs,
                                                            check_every=100))


def adapt_p2d_config(budget):
    """The 2D tanh(10x) study (MEASUREMENTS.md:496-499): poisson2d_of_record
    with the (2,30,30,30,1) net from 2 x 2 elements, var_form 1 (firsts: B1)
    under "pallas"."""
    import hpvpinns_tpu_torch as hv

    _, adam, lbfgs = budget
    c = dataclasses.replace(hv.poisson2d_of_record(), n_elements_x=2, n_elements_y=2, layers=(2, 30, 30, 30, 1),
                            deriv_mode="pallas")
    return dataclasses.replace(c, train=dataclasses.replace(c.train, iterations=adam, lbfgs_iterations=lbfgs,
                                                            check_every=100))


def instrumented_adaptive(label: str, cfg, dev, kernels=(), jax_rows=(), **kw):
    """adaptive_solve (the port's entry point) with each round measured: the
    build's seconds; train's wall seconds, phases and steps/s; the wrappers'
    host launches (zeroed just before the round's train, read just after);
    peak allocated, reserved and still-allocated device memory; and the
    nodes of the round's captured Adam step (one capture of the round's
    problem in debug mode, after its train).  Fails on a round of `kernels`'
    path that launched or captured none of them, a non-finite rel-L2, or
    memory still allocated after a round's train more than ADAPT_MEM_GROWTH
    above round 0's (earlier rounds' graphs and pools must be freed).
    Returns (AdaptiveResult, per-round rows, launches summed over rounds)."""
    import hpvpinns_tpu_torch as hv
    from hpvpinns_tpu_torch import adaptive as tad
    from hpvpinns_tpu_torch.training.trainer import _build_chunk, _copy_params, make_optimizer

    rows, real_train = [], tad.train

    def build_fn(c):
        t0 = time.perf_counter()
        prob = hv.build(c, device=dev)
        rows.append({"build_s": time.perf_counter() - t0})
        return prob

    def train_fn(problem, tc, mesh=None, params=None, verbose=False):
        row = rows[-1]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        t0 = time.perf_counter()
        res = real_train(problem, tc, mesh=mesh, params=params, verbose=verbose)
        torch.cuda.synchronize()
        row.update(train_s=time.perf_counter() - t0, counts=read_counts(), res_phases=res.phases,
                   sps=res.steps_per_sec, peak=torch.cuda.max_memory_allocated(), reserved=torch.cuda.memory_reserved(),
                   allocated=torch.cuda.memory_allocated(), P=problem.data["elements"].x.numel())
        prm = _copy_params(res.params, as_parameters=True)
        ch = _build_chunk(problem.loss_fn, make_optimizer(tc, prm), prm, problem.data, debug=True)
        row["nodes"] = graph_nodes(ch.graphs[0], f"phase19_{'_'.join(label.split()[1:3])}_round{len(rows) - 1}")
        del ch, prm
        return res

    tad.train = train_fn
    try:
        out = tad.adaptive_solve(cfg, build_fn=build_fn, **kw)
    finally:
        tad.train = real_train
    total = {}
    for r, (rec, row) in enumerate(zip(out.rounds, rows)):
        counts, nodes = row["counts"], row["nodes"]
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        if kernels and (min(counts[k] for k in kernels) < 1 or min(nodes[k] for k in kernels) < 1):
            fail(f"phase 19 {label} round {r}: host launches {counts}, graph nodes {nodes}")
        if not math.isfinite(rec["rel_l2"]):
            fail(f"phase 19 {label} round {r}: rel_l2 {rec['rel_l2']}")
        if row["allocated"] - rows[0]["allocated"] > ADAPT_MEM_GROWTH:
            fail(f"phase 19 {label} round {r}: {row['allocated']} B allocated after train, round 0 "
                 f"{rows[0]['allocated']} B: memory grows with the rounds")
        ph = row["res_phases"]
        walls = ", ".join(f"{k} {v['wall_s']:.2f}" for k, v in ph.items())
        lb = f"; {lbfgs_note(ph['lbfgs'])}" if "lbfgs" in ph else ""
        jax = f" (JAX f32 TPU row {jax_rows[r]:g})" if r < len(jax_rows) else ""
        eta = np.asarray(rec["eta"])
        mib = 1 << 20
        print(f"phase 19 {label} round {r}: E {rec['n_elem']}, P {row['P']}, n_test {rec['n_test_per_elem']}, Adam "
              f"{rec['iterations']} + L-BFGS {rec['lbfgs_iterations']}; build {row['build_s']:.3f} s, train "
              f"{row['train_s']:.2f} s (wall s {walls}), {row['sps']:.1f} steps/s{lb}; host launches {counts}; "
              f"captured step {nodes['nodes']} nodes ({nodes['kernels']} kernels; B1 {nodes['fused_fields']}, B2 "
              f"{nodes['fused_fields_bwd']}, block sum {nodes['block_sum']}); rel_l2 {rec['rel_l2']:.4e}{jax}; "
              f"eta max/min {eta.max() / max(eta.min(), 1e-300):.3e}; device memory peak {row['peak'] / mib:.1f} "
              f"MiB, reserved {row['reserved'] / mib:.1f} MiB, allocated after train {row['allocated'] / mib:.1f} "
              f"MiB", flush=True)
    n_elem = [rec["n_elem"] for rec in out.rounds]
    if not all(b > a for a, b in zip(n_elem, n_elem[1:])):
        fail(f"phase 19 {label}: a round refined nothing: E {n_elem}")
    last = out.rounds[-1]
    grids = {k: [round(g, 6) for g in last[k]] for k in ("grid", "grid_x", "grid_y") if k in last}
    print(f"phase 19 {label}: rel-L2 {[f'{r:.4e}' for r in out.rel_l2_trajectory]}, best round {out.best_round}, "
          f"E {n_elem}, last grids {grids}", flush=True)
    return out, rows, total


def galerkin_loop(dev) -> None:
    """Phase 19 (d): adaptive_galerkin_1d (five rounds, p 12, theta 0.7) on
    poisson1d_of_record in float64: the recorded trajectory within
    GALERKIN_RTOL."""
    import hpvpinns_tpu_torch as hv
    from hpvpinns_tpu_torch import adaptive as tad

    t0 = time.perf_counter()
    recs = tad.adaptive_galerkin_1d(dataclasses.replace(hv.poisson1d_of_record(), dtype="float64"), rounds=5,
                                    theta=0.7, p=12, build_fn=lambda c: hv.build(c, device=dev))
    got = [r["rel_l2"] for r in recs]
    if not np.allclose(got, GALERKIN_1D, rtol=GALERKIN_RTOL, atol=0.0):
        fail(f"phase 19 (d) adaptive_galerkin_1d: rel-L2 {got} is not the recorded {list(GALERKIN_1D)}")
    print(f"phase 19 (d) adaptive_galerkin_1d (p 12, theta 0.7, f64 on the host): rel-L2 {[f'{v:.4e}' for v in got]} "
          f"(recorded {list(GALERKIN_1D)}), E {[r['n_elem'] for r in recs]}, {time.perf_counter() - t0:.1f} s",
          flush=True)


def phase19(dev) -> dict:
    """Phase 19, adaptive hp refinement: (a) the enriched indicators card
    against CPU, (b) the two network studies under "pallas" with each round
    cut to ADAPT_*_BUDGET["cut"], (d) the direct-solver loop.  Returns the
    host launches of each path."""
    t0 = time.perf_counter()
    paths = eta_card_against_cpu(dev)
    for label, make, budget, kernels, rows in (
            ("(b) steep poisson1d", adapt_p1d_config, ADAPT_P1D_BUDGET["cut"], SECOND_PATH, JAX_ADAPT_P1D),
            ("(b) poisson2d tanh(10x)", adapt_p2d_config, ADAPT_P2D_BUDGET["cut"], ("fused_fields",), JAX_ADAPT_P2D)):
        _, _, total = instrumented_adaptive(label, make(budget), dev, kernels, rows, rounds=budget[0], theta=0.5)
        paths[f"adaptive {label[4:]} ({budget[0]} rounds)"] = total
    galerkin_loop(dev)
    print(f"phase 19 adaptive: {time.perf_counter() - t0:.1f} s", flush=True)
    return paths


def adaptive_full(dev, parts=("studies", "burgers", "sweep")) -> None:
    """Phase 19 (c), behind --adaptive, the parts named: "studies", the two
    network studies at their recorded budgets; "burgers", the README's
    Burgers command (hard BC on the JVP engine, four rounds, budget growth
    1.4) beside the JAX row; "sweep", h_sweep on poisson1d_of_record at p15
    (E 1, 2, 4; 5,000 Adam steps under "pallas") beside
    benchmarks/sweep_p1d_h/h_sweep.json."""
    if "studies" in parts:
        for label, make, budget, kernels, rows in (
                ("(c) steep poisson1d", adapt_p1d_config, ADAPT_P1D_BUDGET["full"], SECOND_PATH, JAX_ADAPT_P1D),
                ("(c) poisson2d tanh(10x)", adapt_p2d_config, ADAPT_P2D_BUDGET["full"], ("fused_fields",),
                 JAX_ADAPT_P2D)):
            instrumented_adaptive(label, make(budget), dev, kernels, rows, rounds=budget[0], theta=0.5)
    if "burgers" in parts:
        burgers_readme(dev)
    if "sweep" in parts:
        p1d_h_sweep(dev)


def burgers_readme(dev) -> None:
    """The README's `adapt burgers` command through adaptive_solve."""
    import hpvpinns_tpu_torch as hv

    rounds, growth, adam, lbfgs = BURGERS_README
    bc = dataclasses.replace(hv.BurgersConfig(), hard_bc=True, n_test_x=10, n_test_t=10, n_quad=20)
    bc = dataclasses.replace(bc, train=dataclasses.replace(bc.train, iterations=adam, lbfgs_iterations=lbfgs))
    instrumented_adaptive("(c) burgers README command", bc, dev, (), JAX_ADAPT_BURGERS, rounds=rounds, theta=0.5,
                          budget_growth=growth)


def p1d_h_sweep(dev) -> None:
    """h_sweep on poisson1d_of_record at p15 beside the JAX package's record."""
    import hpvpinns_tpu_torch as hv
    from hpvpinns_tpu_torch import sweep as tsw

    with open("benchmarks/sweep_p1d_h/h_sweep.json") as f:
        jax_sweep = {r["n_elements"]: r for r in json.load(f)}
    sc = dataclasses.replace(hv.poisson1d_of_record(), n_test=15, deriv_mode="pallas")
    sc = dataclasses.replace(sc, train=dataclasses.replace(sc.train, iterations=H_SWEEP[1], check_every=100))
    t0 = time.perf_counter()
    for rec in tsw.h_sweep(sc, list(H_SWEEP[0])):
        j = jax_sweep[rec["n_elements"]]
        print(f"phase 19 (c) h_sweep poisson1d_of_record p15 pallas E {rec['n_elements']}: rel_l2 {rec['rel_l2']:.4e} "
              f"(JAX f32 TPU {j['rel_l2']:.4e}), max_abs_err {rec['max_abs_err']:.4e}, final loss "
              f"{rec['final_loss']:.4e}, {rec['steps_per_sec']:.1f} steps/s, per-element rel-L2 "
              f"{[f'{v:.3e}' for v in rec['per_element_rel_l2']]}", flush=True)
    print(f"phase 19 (c) h_sweep: {time.perf_counter() - t0:.1f} s", flush=True)


# Phase 20: the network's last options, the seed ensemble and slab time
# marching.
TF32_REL_MAX = 5e-2  # (a): "high" against "highest", max |diff| over max |highest|: TF32 rounding, well below this
ENS_SEEDS = (1, 4, 8)  # (c): ensemble sizes at record width
ENS_STEPS = 300  # (c), (e): Adam steps a turn (the first chunk, with the capture, is outside the rate)
ENS_CHECK = 50
ENS_STEP_TOL = dict(rtol=1e-5, atol=1e-6)  # (c): one step against the serial twin, f32
ENS_GRAD_TOL = dict(rtol=2e-4, atol=1e-5)  # (d): B2's tolerance, against each leaf's largest entry
WIDE_ENS_STEPS = 100  # (e)
ACT_STEPS = 500  # (b)
ACT_FIELD_TOL = dict(rtol=1e-4, atol=1e-5)  # (b): the JVP engine against the Taylor fields, f32
P2DQ_PRECISION_CUT = 2000  # (a): poisson2d_quality's Adam steps a turn, no L-BFGS
MARCH_MEM_GROWTH = 64 << 20  # (f): device memory still allocated after a slab's train, above slab 0's
# (f): the marches, each at a cut schedule (per slab), and the rows of
# benchmarks/MEASUREMENTS.md:1864-1926 beside them (accuracy comparators at
# their own, uncut budgets; not targets)
MARCH_CUT = {"burgers": (1000, 0), "advdiff": (1000, 0), "taylorgreen": (150, 0)}
JAX_MARCH_ROWS = {"burgers net": "2.87e-2 (hard BC, S 2)", "burgers exact": "4.07e-3 (hard BC, S 2)",
                  "advdiff net": "1.00e-2 (advdiff_forward_precision, S 4, the same weights)",
                  "taylorgreen net": "8.28e-3 (hard BC, S 2)"}


def tf32_gemm(name: str) -> bool:
    """A cuBLAS/CUTLASS GEMM kernel that runs float32 inputs on the tensor
    cores (TF32): its name says tf32, or it is a tensor-op float GEMM."""
    low = name.lower()
    return "tf32" in low or ("tensorop" in low and "gemm" in low and "_s" in low)


def gemm_kernel(name: str) -> bool:
    low = name.lower()
    return "gemm" in low or "xmma" in low or "cutlass" in low


def profiled_kernels(fn, n: int = 20, tries: int = 3) -> dict:
    """{kernel name: launches} of the CUDA kernels n calls of fn run, by
    torch.profiler.  Late in a whole run the profiler loses some of a
    window's device records (phase 7 reads "not measured" at times), so
    the checks on these counts ask only what a lost record cannot fake: a
    kernel's presence or absence.  A window with no device record at all is
    taken again, up to `tries` windows."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        out = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)}
        if out:
            return out
    return out


def rel_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def precision_checks(dev) -> dict:
    """Phase 20 (a): matmul_precision "high"/"default" against "highest" at
    (2,256,256,256,1), P 16,384: mlp_apply, taylor_fields_2d and their
    gradients differ by TF32's rounding (nonzero, below TF32_REL_MAX);
    torch.profiler shows the network's products as TF32 GEMMs in the
    forward and the backward and the contraction einsums and B1 as not; a
    captured "high" step keeps TF32 GEMM nodes; then poisson2d_quality
    "taylor" at "high" against "highest" in turns (graph steps/s, rel-L2) at
    a cut schedule."""
    import hpvpinns_tpu_torch as hv
    from hpvpinns_tpu_torch.models.mlp import MLP, _TF32Matmul, mlp_apply
    from hpvpinns_tpu_torch.ops.contract import contract_2d
    from hpvpinns_tpu_torch.ops.taylor import taylor_fields_2d
    from hpvpinns_tpu_torch.problems.base import parameters
    from hpvpinns_tpu_torch.training.trainer import _build_chunk

    t0 = time.perf_counter()
    rng = np.random.default_rng(20)
    layers = (2, 256, 256, 256, 1)
    net = random_net(MLP(layers=layers), rng, dev)
    X = torch.as_tensor(rng.uniform(-1, 1, (16384, 2)), dtype=torch.float32, device=dev)
    out = {}
    for prec in ("highest", "high", "default"):
        spec = MLP(layers=layers, precision=prec)
        u = mlp_apply(spec, net, X)
        f = taylor_fields_2d(spec, net, X[:, 0], X[:, 1])
        g = torch.autograd.grad(u.square().sum() + sum(v.square().sum() for v in f.values()),
                                parameters({"net": net, "pde": {}}))
        out[prec] = (u.detach(), {k: v.detach() for k, v in f.items()}, g)
        if torch.backends.cuda.matmul.allow_tf32:
            fail(f"phase 20 (a): TF32 left on after the {prec} products")
    u0, f0, g0 = out["highest"]
    diffs = {}
    for prec in ("high", "default"):
        u1, f1, g1 = out[prec]
        d = {"mlp_apply": rel_diff(u1, u0), **{f"fields {k}": rel_diff(f1[k], f0[k]) for k in f0},
             "grads": max(rel_diff(a, b) for a, b in zip(g1, g0))}
        bad = {k: v for k, v in d.items() if not 0.0 < v < TF32_REL_MAX}
        if bad:
            fail(f"phase 20 (a) {prec}: differences from highest outside (0, {TF32_REL_MAX}): {bad}")
        diffs[prec] = d
    A, W = X.new_empty((16384, 256)).uniform_(-1, 1), net[1]["W"].detach()
    tf32_k = profiled_kernels(lambda: _TF32Matmul.apply(A, W))
    ieee_k = profiled_kernels(lambda: A @ W)
    if not all(tf32_gemm(k) for k in tf32_k if gemm_kernel(k)) or not any(gemm_kernel(k) for k in tf32_k) \
            or any(tf32_gemm(k) for k in ieee_k):
        fail(f"phase 20 (a): the TF32 function ran {tf32_k}, the plain product {ieee_k}")
    # a training step of poisson2d_scaled at 3 x 256 ("taylor" at "highest" and
    # "high", "pallas" at "high"): the network's products TF32 forward and
    # backward at "high" only; B1 and the contractions never
    cfg = dataclasses.replace(hv.poisson2d_scaled(), layers=layers)
    steps = {}
    for label, mode, prec in (("taylor highest", "taylor", "highest"), ("taylor high", "taylor", "high"),
                              ("pallas high", "pallas", "high")):
        prob = hv.build(dataclasses.replace(cfg, deriv_mode=mode, matmul_precision=prec), device=dev)
        prm, opt = fresh_state(prob, cfg)

        def step():
            opt.zero_grad(set_to_none=True)
            prob.loss_fn(prm, prob.data)[0].backward()

        k = profiled_kernels(step, n=3)
        steps[label] = {"tf32": sum(v for n, v in k.items() if tf32_gemm(n)),
                        "ieee_gemm": sum(v for n, v in k.items() if gemm_kernel(n) and not tf32_gemm(n)),
                        "b1": sum(v for n, v in k.items() if "fused_fields" in n)}
    el, bx, by = prob.data["elements"], prob.data["basis_x"], prob.data["basis_y"]
    contraction_k = profiled_kernels(lambda: contract_2d(bx.wphi, by.wphi, el.x))
    # "pallas": the forward's products are in B1 (IEEE fp32), its firsts-only VJP is the plain Taylor
    # backward (TF32, as the JAX package's XLA VJP runs at the spec's precision)
    if (steps["taylor highest"]["tf32"] or not steps["taylor high"]["tf32"] or not steps["pallas high"]["b1"]
            or not steps["pallas high"]["tf32"] or any(tf32_gemm(n) for n in contraction_k)):
        fail(f"phase 20 (a): the training steps' kernels {steps}, the contraction's {contraction_k}")
    prob = hv.build(dataclasses.replace(cfg, deriv_mode="taylor", matmul_precision="high"), device=dev)
    prm, opt = fresh_state(prob, cfg)
    ch = _build_chunk(prob.loss_fn, opt, prm, prob.data, debug=True)
    names = [n for n in dot_nodes(ch.graphs[0], "phase20_high_step") if "KERNEL" in n]
    captured_tf32 = sum(tf32_gemm(n) for n in names)
    if captured_tf32 < 1:
        fail(f"phase 20 (a): the captured 'high' step has no TF32 GEMM node ({len(names)} kernel nodes)")
    del ch
    print(f"phase 20 (a) precision at {layers}, P 16384: max |diff| / max |highest| "
          + "; ".join(f"{p}: " + ", ".join(f"{k} {v:.3e}" for k, v in d.items()) for p, d in diffs.items())
          + f"; the TF32 function's kernels {sorted(tf32_k)}, the plain product's {sorted(ieee_k)}, the "
          f"contraction's {sorted(contraction_k)}; poisson2d_scaled 3 x 256 kernel launches in three forward + "
          f"backward steps {steps}; the captured 'high' step {len(names)} kernel nodes, {captured_tf32} TF32 GEMMs", flush=True)
    # poisson2d_quality "taylor" at "high" against "highest", in turns
    q = hv.poisson2d_quality()
    q = dataclasses.replace(q, train=dataclasses.replace(q.train, iterations=P2DQ_PRECISION_CUT, lbfgs_iterations=0,
                                                          check_every=200))
    rows = {"highest": [], "high": []}
    for prec in ("highest", "high", "high", "highest"):
        c = dataclasses.replace(q, matmul_precision=prec)
        prob = hv.build(c, device=dev)
        res = hv.train(prob, verbose=False)
        rows[prec].append((res.steps_per_sec, hv.evaluate_problem(prob, res.eval_params)["rel_l2"]))
    for prec, r in rows.items():
        if not all(math.isfinite(e) for _, e in r):
            fail(f"phase 20 (a) poisson2d_quality {prec}: rel-L2 {r}")
    print(f"phase 20 (a) poisson2d_quality taylor, Adam {P2DQ_PRECISION_CUT} (cut from 10k + 5k L-BFGS), turns "
          f"highest high high highest: " + "; ".join(
              f"{p} graph steps/s {[s for s, _ in r]} rel-L2 {[e for _, e in r]}" for p, r in rows.items())
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    return {"diffs": diffs, "steps": steps, "captured_tf32": captured_tf32, "p2d_quality": rows}


def activation_checks(dev) -> None:
    """Phase 20 (b): gelu, swish, and tanh with the adaptive slope, each
    trained ACT_STEPS Adam steps on poisson2d_scaled under "taylor" and
    "jvp": the loss falls, the two engines give the same fields at the
    trained params to f32 tolerance (ACT_FIELD_TOL, over each field's
    largest entry: the nested JVP and the Taylor propagation round
    differently), and "pallas" raises the JAX package's ValueError."""
    import hpvpinns_tpu_torch as hv
    from hpvpinns_tpu_torch.ops.fields import scalar_fields_2d
    from hpvpinns_tpu_torch.models.mlp import mlp_apply
    from hpvpinns_tpu_torch.ops.taylor import taylor_fields_2d

    t0 = time.perf_counter()
    base = hv.poisson2d_scaled()
    base = dataclasses.replace(base, train=dataclasses.replace(base.train, iterations=ACT_STEPS,
                                                               check_every=ACT_STEPS // 5))
    for label, kw, message in (
            ("gelu", {"activation": "gelu"}, "pallas fields kernel supports sin/tanh activations; got 'gelu'"),
            ("swish", {"activation": "swish"}, "pallas fields kernel supports sin/tanh activations; got 'swish'"),
            ("tanh + slope", {"adaptive_slope": True},
             "deriv_mode='pallas' does not support adaptive_slope; use 'taylor'")):
        rows = {}
        for mode in ("taylor", "jvp"):
            c = dataclasses.replace(base, deriv_mode=mode, **kw)
            prob = hv.build(c, device=dev)
            res = hv.train(prob, verbose=False)
            loss = res.history["loss"]
            if not (np.all(np.isfinite(loss)) and loss[-1] < loss[0]):
                fail(f"phase 20 (b) {label} {mode}: loss {loss.tolist()}")
            rows[mode] = (res, prob, loss)
        res, prob, _ = rows["taylor"]
        el = prob.data["elements"]
        x, y = el.x.reshape(-1), el.y.reshape(-1)
        with torch.no_grad():
            ft = taylor_fields_2d(prob.spec, res.params["net"], x, y)
        fj = scalar_fields_2d(lambda Z: mlp_apply(prob.spec, res.params["net"], Z), x, y)
        err = max(check_close(f"phase 20 (b) {label} {k}", fj[k].detach() / ft[k].abs().max(),
                              ft[k] / ft[k].abs().max(), **ACT_FIELD_TOL) for k in ft)
        slopes = [float(layer["s"].detach()) for layer in res.params["net"][:-1] if "s" in layer]
        pp = hv.build(dataclasses.replace(base, deriv_mode="pallas", **kw), device=dev)
        try:
            pp.loss_fn(pp.init_params(torch.Generator().manual_seed(0)), pp.data)
            fail(f"phase 20 (b) {label}: 'pallas' did not raise")
        except ValueError as e:
            if str(e) != message:
                fail(f"phase 20 (b) {label}: 'pallas' raised {e!r}")
        print(f"phase 20 (b) {label}: {ACT_STEPS} Adam steps, loss taylor {rows['taylor'][2][0]:.4e} -> "
              f"{rows['taylor'][2][-1]:.4e} ({rows['taylor'][0].steps_per_sec:.1f} steps/s), jvp "
              f"{rows['jvp'][2][0]:.4e} -> {rows['jvp'][2][-1]:.4e} ({rows['jvp'][0].steps_per_sec:.1f} steps/s); "
              f"fields jvp vs taylor at the trained params, max abs err over the field's largest {err:.3e}"
              + (f"; trained slopes {slopes}" if slopes else "") + "; pallas raises JAX's ValueError", flush=True)
    print(f"phase 20 (b): {time.perf_counter() - t0:.1f} s", flush=True)


def ens_config(var_form: int, layers=None, iterations: int = ENS_STEPS, check: int = ENS_CHECK):
    import hpvpinns_tpu_torch as hv

    c = dataclasses.replace(hv.poisson2d_scaled(), var_form=var_form)
    if layers is not None:
        c = dataclasses.replace(c, layers=layers)
    return dataclasses.replace(c, train=dataclasses.replace(c.train, iterations=iterations, check_every=check,
                                                            threshold=None))


def replay_profile(ch, n_chunks: int = 2, chunk: int = 10) -> dict:
    """Per step of a graph chunk, from torch.profiler over n_chunks chunks:
    the kernels' device µs, the busy share (their device time over the
    window's wall time) and the five largest kernels' µs."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    ch(chunk)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            ch(chunk)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0 and not getattr(e, "is_user_annotation", False)]
    total, steps = sum(e.self_device_time_total for e in kernels), n_chunks * chunk
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return {"device_us": total / steps, "busy": total / wall_us,
            "top": [(e.key[:70], round(e.self_device_time_total / steps, 2), e.count // steps) for e in top]}


def ensemble_step_launches(prob, seeds, label: str, profile: bool = False) -> tuple:
    """One eager ensemble step (its launches counted) and the captured step's
    nodes: (host launches of one step, graph nodes of the captured step,
    and with `profile` the chunk's replay_profile, else None)."""
    from hpvpinns_tpu_torch.training import ensemble as ens
    from hpvpinns_tpu_torch.training.trainer import make_optimizer

    stack = ens.init_ensemble(prob, seeds)
    opt = make_optimizer(prob.config.train, stack)
    step = ens._ensemble_step(prob.loss_fn, opt, stack, prob.data)
    zero_counts()
    step()
    torch.cuda.synchronize()
    counts = read_counts()
    ch = ens._build_ens_chunk(prob.loss_fn, opt, stack, prob.data, debug=True)
    nodes = graph_nodes(ch.graphs[0], f"phase20_{label}")
    prof = replay_profile(ch) if profile else None
    del ch
    return counts, nodes, prof


def ensemble_rates(probs: dict, seeds, label: str) -> dict:
    """train_ensemble's steps/s (after its first chunk) and peak device
    memory, the modes of `probs` in turns a b b a, each run's kernel launches
    counted (zeroed just before, read just after): {mode: [(steps/s,
    seed-steps/s, peak MiB, launches), ...]}."""
    import hpvpinns_tpu_torch as hv

    a, b = list(probs)
    out = {a: [], b: []}
    for mode in (a, b, b, a):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        res = hv.train_ensemble(probs[mode], seeds=seeds, verbose=False)
        counts = read_counts()
        loss = res.history["loss"]
        if not (np.all(np.isfinite(loss)) and np.all(loss[-1] < loss[0])):
            fail(f"phase 20 {label} {mode}: member losses {loss[0].tolist()} -> {loss[-1].tolist()}")
        out[mode].append((res.steps_per_sec, res.seed_steps_per_sec, torch.cuda.max_memory_allocated() / 2**20,
                          counts))
    return out


def ensemble_record_width(dev) -> dict:
    """Phase 20 (c): poisson2d_scaled (2,20,20,20,1) var_form 1, S in
    ENS_SEEDS, "taylor" and "pallas": steps/s and seed-steps/s in turns; B1
    launches S a step (an eager step's count and the captured step's
    nodes); after one step every member equals its serial `train` twin
    (ENS_STEP_TOL, f32; an entry whose twin gradient is below 1e-3 of its
    leaf's largest is excused, where Adam's first step is lr x sign(g) and
    the sign is rounding).  Returns the launches of each path."""
    import hpvpinns_tpu_torch as hv
    from hpvpinns_tpu_torch.problems.base import parameters

    t0 = time.perf_counter()
    paths = {}
    for S in ENS_SEEDS:
        seeds = tuple(range(S))
        probs = {m: hv.build(dataclasses.replace(ens_config(1), deriv_mode=m), device=dev) for m in ("taylor", "pallas")}
        counts, nodes, _ = ensemble_step_launches(probs["pallas"], seeds, f"p2d_scaled_f1_S{S}")
        if counts["fused_fields"] != S or nodes["fused_fields"] != S:
            fail(f"phase 20 (c) S {S}: B1 launched {counts['fused_fields']} times in a step, {nodes['fused_fields']} "
                 f"nodes in the captured step; expected {S}")
        rates = ensemble_rates(probs, seeds, f"(c) S {S}")
        paths[f"ensemble p2d_scaled f1 S={S} pallas"] = rates["pallas"][0][3]
        print(f"phase 20 (c) poisson2d_scaled (2,20,20,20,1) var_form 1 S {S}: B1 {counts['fused_fields']} launches "
              f"an eager step, {nodes['fused_fields']} nodes in the captured step ({nodes['nodes']} nodes); "
              f"{ENS_STEPS} steps a run, turns taylor pallas pallas taylor: "
              + "; ".join(f"{m} steps/s {[r[0] for r in v]} seed-steps/s {[r[1] for r in v]}" for m, v in rates.items())
              + f"; host launches of a pallas run {rates['pallas'][0][3]}", flush=True)
    # where an S 4 step's device time goes, both modes (replays of the captured chunk)
    for mode in ("taylor", "pallas"):
        prob = hv.build(dataclasses.replace(ens_config(1), deriv_mode=mode), device=dev)
        _, nodes, prof = ensemble_step_launches(prob, (0, 1, 2, 3), f"p2d_scaled_f1_S4_{mode}", profile=True)
        print(f"phase 20 (c) S 4 {mode}, the captured step ({nodes['nodes']} nodes): device us/step "
              f"{prof['device_us']!r}, busy {prof['busy']!r}; top kernels (us/step, launches/step) {prof['top']}",
              flush=True)
    # one step against the serial twins, S 4, both modes
    for mode in ("taylor", "pallas"):
        c = ens_config(1, iterations=1, check=1)
        prob = hv.build(dataclasses.replace(c, deriv_mode=mode), device=dev)
        res = hv.train_ensemble(prob, seeds=(0, 1, 2, 3), verbose=False)
        worst, excused = 0.0, 0
        for i in range(4):
            twin = hv.train(prob, dataclasses.replace(c.train, seed=i), verbose=False)
            init = prob.init_params(torch.Generator().manual_seed(i))
            loss, _ = prob.loss_fn(init, prob.data)
            grads = torch.autograd.grad(loss, parameters(init))
            for a, b, g in zip(parameters(res.member(i)), parameters(twin.params), grads):
                b = b.detach()
                err = (a - b).abs()
                ok = (err <= ENS_STEP_TOL["atol"] + ENS_STEP_TOL["rtol"] * b.abs()) | (g.abs() <= 1e-3 * g.abs().max())
                if not ok.all():
                    fail(f"phase 20 (c) {mode} member {i}: one step differs from its serial twin by "
                         f"{err.max().item():.3e}")
                excused += int(((err > ENS_STEP_TOL["atol"] + ENS_STEP_TOL["rtol"] * b.abs()) & ok).sum())
                worst = max(worst, float((err / (b.abs() + 1e-30)).masked_fill(~ok | (b.abs() < 1e-6), 0).max()))
            check_close(f"phase 20 (c) {mode} member {i} loss", torch.tensor(res.final_aux["loss"][i]),
                        torch.tensor(twin.final_aux["loss"]), rtol=1e-5, atol=0.0)
        print(f"phase 20 (c) {mode}: one ensemble step (S 4) against each member's serial train: max relative "
              f"difference {worst:.3e} (rtol {ENS_STEP_TOL['rtol']}, atol {ENS_STEP_TOL['atol']}; {excused} entries "
              f"excused at a rounding-level gradient); losses after the step within 1e-5", flush=True)
    print(f"phase 20 (c): {time.perf_counter() - t0:.1f} s", flush=True)
    return paths


def ensemble_through_b2(dev) -> dict:
    """Phase 20 (d): var_form 0, S 4, "pallas": B2 (resident) and the block
    sum launch S times a step (an eager step's count and the captured
    step's nodes); each member's vmapped gradient against its own unbatched
    "pallas" gradient (ENS_GRAD_TOL: the same kernels on the same member
    parameters, but the vmapped loss's contractions add in another order,
    so B2's cotangent differs by rounding)."""
    import hpvpinns_tpu_torch as hv
    from hpvpinns_tpu_torch.problems.base import parameters
    from hpvpinns_tpu_torch.training import ensemble as ens

    t0 = time.perf_counter()
    S, seeds = 4, (0, 1, 2, 3)
    prob = hv.build(dataclasses.replace(ens_config(0), deriv_mode="pallas"), device=dev)
    counts, nodes, _ = ensemble_step_launches(prob, seeds, "p2d_scaled_f0_S4")
    for k in SECOND_PATH:
        if counts[k] != S or nodes[k] != S:
            fail(f"phase 20 (d): {k} launched {counts[k]} times in a step, {nodes[k]} nodes; expected {S}")
    stack = ens.init_ensemble(prob, seeds)
    zero_counts()
    grads, _ = torch.func.vmap(torch.func.grad_and_value(lambda p: prob.loss_fn(p, prob.data), has_aux=True))(
        ens._detached(stack))
    vm_counts = read_counts()
    worst = 0.0
    for i in range(S):
        member = prob.init_params(torch.Generator().manual_seed(i))
        loss, _ = prob.loss_fn(member, prob.data)
        own = torch.autograd.grad(loss, parameters(member))
        for j, (a, b) in enumerate(zip(parameters(grads), own)):
            scale = b.abs().max()
            worst = max(worst, check_close(f"phase 20 (d) member {i} leaf {j}", a[i] / scale, b / scale,
                                           **ENS_GRAD_TOL))
    rates = ensemble_rates({"taylor": hv.build(dataclasses.replace(ens_config(0), deriv_mode="taylor"), device=dev),
                            "pallas": prob}, seeds, "(d)")
    print(f"phase 20 (d) poisson2d_scaled var_form 0 S 4 pallas: an eager step launches {counts} (the captured step's "
          f"nodes {nodes}); the vmapped gradient's launches {vm_counts}; each member's gradient against its own "
          f"unbatched pallas gradient, max abs err over the leaf's largest {worst:.3e} (rtol {ENS_GRAD_TOL['rtol']}, "
          f"atol {ENS_GRAD_TOL['atol']}); turns: "
          + "; ".join(f"{m} steps/s {[r[0] for r in v]} seed-steps/s {[r[1] for r in v]}" for m, v in rates.items())
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
    return {"ensemble p2d_scaled f0 S=4 pallas": rates["pallas"][0][3]}


def ensemble_wide_point(dev) -> dict:
    """Phase 20 (e): the JAX package's wide ensemble operating point
    (bench.py::measure_wide_point): poisson2d_scaled at (2,256,256,256,1),
    S 4, P 16,384; var_form 1 and var_form 0 (the layered B2, S launches a
    step), "pallas" against "taylor" in turns: graph steps/s, seed-steps/s
    and peak device memory."""
    import hpvpinns_tpu_torch as hv

    t0 = time.perf_counter()
    layers, seeds, paths = (2, 256, 256, 256, 1), (0, 1, 2, 3), {}
    for vf in (1, 0):
        c = ens_config(vf, layers=layers, iterations=WIDE_ENS_STEPS, check=WIDE_ENS_STEPS // 2)
        probs = {m: hv.build(dataclasses.replace(c, deriv_mode=m), device=dev) for m in ("pallas", "taylor")}
        path = SECOND_PATH[:1] + ("fused_fields_bwd_layered", "block_sum") if vf == 0 else ("fused_fields",)
        counts, nodes, _ = ensemble_step_launches(probs["pallas"], seeds, f"wide_f{vf}_S4")
        # the layered B2 is one wrapper call of several kernels: its nodes are a multiple of S
        if any(counts[k] != 4 or nodes[k] % 4 or nodes[k] < 4 or (nodes[k] != 4 and k != "fused_fields_bwd_layered")
               for k in path):
            fail(f"phase 20 (e) var_form {vf}: an eager step launched {counts}, the captured step's nodes {nodes}")
        rates = ensemble_rates(probs, seeds, f"(e) var_form {vf}")
        paths[f"ensemble p2d_scaled 3 x 256 f{vf} S=4 pallas"] = rates["pallas"][0][3]
        print(f"phase 20 (e) poisson2d_scaled {layers} var_form {vf} S 4, P 16384: an eager pallas step launches "
              f"{ {k: counts[k] for k in path} }; {WIDE_ENS_STEPS} steps a run, turns pallas taylor taylor pallas: "
              + "; ".join(f"{m} steps/s {[r[0] for r in v]} seed-steps/s {[r[1] for r in v]} peak MiB "
                          f"{[round(r[2], 1) for r in v]}" for m, v in rates.items()), flush=True)
    block_sum_beside_torch(dev)
    print(f"phase 20 (e): {time.perf_counter() - t0:.1f} s", flush=True)
    return paths


def block_sum_beside_torch(dev) -> dict:
    """Phase 20 (e): the block sum against `partials.sum(0)` at the two
    large partial shapes of the 3 x 256 network (v3's 512 rows and the
    layered form's 128 rows of 132,612 columns): device µs (torch.profiler)
    and ms a call (CUDA events), the results within SUM_TOL of the largest
    column sum.  Returns
    {shape: {kernel: (device µs, ms)}}."""
    from hpvpinns_tpu_torch.ops.fused_fields import block_sum_kernel

    out = {}
    rng = np.random.default_rng(15)
    for rows in (512, 128):
        partials = torch.as_tensor(rng.standard_normal((rows, 132612)), dtype=torch.float32, device=dev)
        want = partials.sum(0)
        scale = want.abs().max()  # random partials: a column's sum can cancel to ~0, so against the largest
        err = check_close(f"phase 20 (e) block sum {rows} x 132612", block_sum_kernel(partials) / scale, want / scale,
                          **SUM_TOL)
        out[f"{rows} x 132612"] = {name: (device_us(fn), cuda_ms(fn)) for name, fn in (
            ("block_sum", lambda: block_sum_kernel(partials)), ("torch.sum", lambda: partials.sum(0)))}
        b = bound_ms(4 * (rows * 132612 + 132612), rows * 132612)
        print(f"phase 20 (e) block sum against partials.sum(0) at {rows} x 132612: max abs err {err:.3e}; "
              + "; ".join(f"{k} device us {v[0]!r} ms {v[1]!r}" for k, v in out[f"{rows} x 132612"].items())
              + f"; bound {b[0] * 1e3:.2f} us ({b[1]})", flush=True)
    return out


def march_configs(full: bool = False) -> list:
    """Phase 20 (f)'s marches: (label, config, time_march arguments, the
    kernels of its path).  Cut schedules (MARCH_CUT, per slab) unless
    `full`, which runs the study's equal-total arms
    (benchmarks/timemarch_study.py: every phase's budget split over the
    slabs, burgers with its GN-40 QR tail)."""
    import hpvpinns_tpu_torch as hv

    def cut(c, family, s):
        """The study's per-slab shape (the single arm's time elements split
        over the slabs), at its equal-total schedule or the cut one."""
        c = dataclasses.replace(c, n_elements_t=max(1, c.n_elements_t // s))
        t = c.train
        if full:
            return dataclasses.replace(c, train=dataclasses.replace(
                t, iterations=max(1, t.iterations // s), lbfgs_iterations=t.lbfgs_iterations // s,
                gn_iterations=t.gn_iterations // s, check_every=max(1, t.check_every // s)))
        adam, lbfgs = MARCH_CUT[family]
        return dataclasses.replace(c, train=dataclasses.replace(t, iterations=adam, lbfgs_iterations=lbfgs,
                                                                gn_iterations=0, check_every=100))

    bq = hv.burgers_quality()
    bq = dataclasses.replace(bq, n_elements_t=2, train=dataclasses.replace(bq.train, gn_iterations=40, gn_solve="qr"))
    adv = dataclasses.replace(hv.AdvDiffConfig(inverse=False, deriv_mode="pallas"), n_elements_t=4)
    adv = dataclasses.replace(adv, train=dataclasses.replace(adv.train, iterations=4 * adv.train.iterations))
    tg = dataclasses.replace(hv.taylorgreen_quality(), hard_bc=True, p_zero_mean_weight=10.0)
    return [
        ("burgers net", cut(bq, "burgers", 2), dict(n_slabs=2, ic="net"), ()),
        ("burgers exact", cut(bq, "burgers", 2), dict(n_slabs=2, ic="exact"), ()),
        ("advdiff net", cut(adv, "advdiff", 4), dict(n_slabs=4, ic="net", budget_weights=(2.2, 0.8, 0.5, 0.5)),
         SECOND_PATH),
        ("taylorgreen net", cut(tg, "taylorgreen", 2), dict(n_slabs=2, ic="net"), ()),
    ]


def marches(dev, full: bool = False) -> dict:
    """Phase 20 (f): each march of march_configs through `time_march`, each
    slab's `train` measured (wall s, device memory still allocated after
    it, the kernels' host launches) and its params snapshotted: per-slab and
    global rel-L2 beside MEASUREMENTS.md's rows; fails on a non-finite
    rel-L2, memory still allocated after a slab's train more than
    MARCH_MEM_GROWTH above slab 0's, a kernel of the path that did not
    launch, or a slab's params changed by the slabs after it."""
    import hpvpinns_tpu_torch as hv
    from hpvpinns_tpu_torch.problems.base import map_params, parameters
    from hpvpinns_tpu_torch.training import timemarch as tm

    t_all = time.perf_counter()
    paths = {}
    real_train = tm.train
    for label, c, kw, kernels in march_configs(full):
        rows = []

        def train_fn(problem, tc=None, mesh=None, params=None, verbose=False):
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            res = real_train(problem, tc, mesh=mesh, params=params, verbose=verbose)
            torch.cuda.synchronize()
            rows.append({"wall_s": time.perf_counter() - t0, "allocated": torch.cuda.memory_allocated(),
                         "counts": read_counts(), "iterations": res.iterations_run,
                         "snapshot": map_params(lambda t: t.detach().clone(), res.eval_params)})
            return res

        tm.train = train_fn
        try:
            t0 = time.perf_counter()
            res = hv.time_march(c, verbose=False, device=dev, **kw)
            wall = time.perf_counter() - t0
        finally:
            tm.train = real_train
        total = {}
        for k, row in enumerate(rows):
            for name, v in row["counts"].items():
                total[name] = total.get(name, 0) + v
            if kernels and min(row["counts"][n] for n in kernels) < 1:
                fail(f"phase 20 (f) {label} slab {k}: host launches {row['counts']}")
            if row["allocated"] - rows[0]["allocated"] > MARCH_MEM_GROWTH:
                fail(f"phase 20 (f) {label} slab {k}: {row['allocated']} B allocated after its train, slab 0 "
                     f"{rows[0]['allocated']} B: memory grows with the slabs")
            for a, b in zip(parameters(res.params[k]), parameters(row["snapshot"])):
                if not torch.equal(a.detach(), b):
                    fail(f"phase 20 (f) {label}: slab {k}'s params changed after it trained")
        per = [m["rel_l2"] for m in res.per_slab]
        if not (all(math.isfinite(e) for e in per) and math.isfinite(res.metrics["rel_l2"])):
            fail(f"phase 20 (f) {label}: rel-L2 {per}, global {res.metrics['rel_l2']}")
        if kernels:
            paths[f"march {label}"] = total
        jax = JAX_MARCH_ROWS.get(label)
        extra = ", ".join(f"{k} {v:.4e}" for k, v in res.metrics.items() if k.startswith("rel_l2_"))
        t = c.train
        print(f"phase 20 (f) {label}: {kw['n_slabs']} slabs, a slab Adam {t.iterations} + L-BFGS "
              f"{t.lbfgs_iterations} + GN {t.gn_iterations}{' x weights ' + str(kw['budget_weights']) if 'budget_weights' in kw else ''}"
              f" ({'the study arm' if full else 'cut'}); per-slab rel-L2 {[f'{e:.4e}' for e in per]}, global "
              f"{res.metrics['rel_l2']:.4e}" + (f" ({extra})" if extra else "")
              + (f" (MEASUREMENTS.md row {jax} at its own budget)" if jax else "")
              + f"; per-slab wall s {[round(r['wall_s'], 2) for r in rows]}; device MiB allocated after each slab "
              f"{[round(r['allocated'] / 2**20, 1) for r in rows]}; host launches {total}; {wall:.1f} s", flush=True)
    print(f"phase 20 (f): {time.perf_counter() - t_all:.1f} s", flush=True)
    return paths


def phase20(dev, parts=("precision", "activations", "ensemble", "march")) -> dict:
    """Phase 20, the parts named: (a) precision and (b) activations
    ("precision", "activations"), (c)-(e) the ensemble ("ensemble"), (f)
    the marches ("march").  Returns the ensemble's and the marches' host
    launches by path."""
    t0 = time.perf_counter()
    paths = {}
    if "precision" in parts:
        precision_checks(dev)
    if "activations" in parts:
        activation_checks(dev)
    if "ensemble" in parts:
        paths.update(ensemble_record_width(dev))
        paths.update(ensemble_through_b2(dev))
        paths.update(ensemble_wide_point(dev))
    if "march" in parts:
        paths.update(marches(dev))
    print(f"phase 20: {time.perf_counter() - t0:.1f} s", flush=True)
    return paths


# Phase 21: the inverse suite (inverse.py, uncertainty.py) on the card.
INV_TWO_PHASE_STEPS = (2000, 2000)  # (a): Adam, L-BFGS (MEASUREMENTS.md:270-271's `run advdiff` command)
INV_FIT = (6, 1e-3)  # (a): the fit's Legendre order and Tikhonov weight (`--fit-epsilon-field 6,1e-3`)
INV_EPS = (0.0318, 0.5)  # (a), (b): the manufactured truth eps(x) = a (1 + b sin(pi x)) (`sin:0.0318,0.5`)
# (a): the fit's field rel-L2 on an Adam + L-BFGS u (INVERSE.md:30) and in the
# data-rich regime (MEASUREMENTS.md:264-266): accuracy comparators, not targets
JAX_FIT_ROWS = "0.120 (Adam + L-BFGS u), 0.064-0.118 (data-rich)"
# (a): the fit on the card's fields against the same fit on the CPU's, both
# float32 from the same trained params, as the rel-L2 of the two fields.  The
# u fields differ by float32 rounding (a few ulps through three JVP levels of
# a 4-layer network: ~1e-6 of their size) and the field error is ~130 x the u
# error (MEASUREMENTS.md:250-254), so ~1.3e-4; 1e-3 leaves a factor ~8 for the
# float32 contractions and the cancellation in the rhs.
INV_CARD_CPU_TOL = 1e-3
INV_F64_TOL = 1e-9  # (b), (c): float64 on the card against the CPU, over the largest entry
INV_BOOT = 4  # (b): als_bootstrap's replicates (default 16)
# (b): the card's estimate against the CPU's, over the largest entry: 1e-12
# for the host-only routes (the same numpy/scipy on the same data); ALS's
# lstsq on contractions that round differently, 1e-8; the field route as the
# rel-L2 of the two fields (L-BFGS-B's paths may part on rounding; its own
# accuracy is 2.4e-2), 1e-4
INV_AGREE = {"als_identify": 1e-8, "reduced_identify_field": 1e-4}
# (b): each route's sizes under --inverse-only (the README's and the JAX
# tests': 502.4 s for (b) with both twins on an NVIDIA H100 80GB HBM3 host)
# and in the whole run (cut so that phase 21 adds ~150 s: a larger p or
# maxiter moves the estimate by less than the bound, as the CPU measured
# them), the bound the JAX package's own test holds the route to (met at
# both sizes), and the README's figure (README.md:117-145, verify notes).
INV_ROUTES = {
    "reduced_identify": (dict(p=40), dict(p=40), 1e-6, "eps ~1e-8 (1.3e-8)"),
    "reduced_identify (eps, V)": (dict(p=36), dict(p=28, maxiter=80), 1e-5, "(eps, V) ~1e-8 (3.6e-8, 1.5e-10)"),
    "reduced_identify_field": (dict(eps_order=8, p=24), dict(eps_order=8, p=20), 0.06,
                               "field 2.4e-2 from 35 sensors"),
    "als_identify": (dict(eps_order=8), dict(eps_order=8), 2e-3, "field 4e-4"),
    "reduced_identify2d": (dict(p=10), dict(p=10, maxiter=100), 1e-3, "3 scalars ~1e-7 (at p 12)"),
    "reduced_identify_burgers": (dict(p=16, n_steps=300), dict(p=16, n_steps=300), 1e-3,
                                 "nu ~6e-7 (at p 20, n_steps 600)"),
    "reduced_identify_kovasznay": ({}, {}, 1e-6, "nu 3e-8"),
    "reduced_identify_taylorgreen": ({}, dict(n_steps=30), 5e-4, "nu 4.6e-5 raw, 2.7e-7 debiased (n_steps 60)"),
    "reduced_identify_helmholtz": ({}, dict(p=10, n_scan=31), 1e-5, "k^2 1.8e-9 (p 14, n_scan 61)"),
}


def inv_eps(x):
    """The manufactured truth eps(x), numpy or torch."""
    a, b = INV_EPS
    return a * (1.0 + b * (torch.sin if isinstance(x, torch.Tensor) else np.sin)(np.pi * x))


def inv_manufactured(c, device):
    """The `run advdiff --manufactured-velocity 1.0 --manufactured-epsilon
    sin:0.0318,0.5 --manufactured-profile cos` problem of config c."""
    from hpvpinns_tpu_torch.problems import advdiff

    def vfn(x):
        return 1.0 + 0.0 * x

    u_fn, f_fn = advdiff.make_manufactured(c, vfn, epsilon=inv_eps, profile="cos")
    return advdiff.build(c, u_fn=u_fn, f_fn=f_fn, velocity_fn=vfn, epsilon_fn=inv_eps, device=device)


def field_rel(fn, truth=inv_eps) -> float:
    xs = np.linspace(-1.0, 1.0, 513)
    t = np.asarray(truth(xs)).reshape(-1)
    return float(np.linalg.norm(np.asarray(fn(xs)).reshape(-1) - t) / np.linalg.norm(t))


def synced(fn):
    """(fn(), wall seconds to the card's end)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def inverse_two_phase(dev) -> dict:
    """Phase 21 (a): MEASUREMENTS.md:270-271's command on the card, trained
    under "pallas" (var_form 0: B1 with second derivatives, B2's resident
    form, the block sum) and under "taylor" from the same draw, Adam then
    L-BFGS; then inverse.fit_epsilon_field on each trained u's fields on the
    card, and the "pallas" fit again on the CPU from the same params.  Also
    the two repairs of this slice on the card: bfloat16 trains Poisson-2D on
    "taylor" and "pallas" refuses it; swish's nested JVPs under no_grad (a
    "jvp" Poisson-1D run's metrics).  Returns the "pallas" run's host
    launches."""
    import hpvpinns_tpu_torch as hv
    from hpvpinns_tpu_torch import inverse as inv

    order, reg = INV_FIT
    fits, paths = {}, {}
    for mode in ("pallas", "taylor"):
        c = hv.AdvDiffConfig(epsilon_model="mlp", epsilon_reg=1e-2, deriv_mode=mode)
        c = dataclasses.replace(c, train=dataclasses.replace(
            c.train, iterations=INV_TWO_PHASE_STEPS[0], lbfgs_iterations=INV_TWO_PHASE_STEPS[1]))
        prob = inv_manufactured(c, dev)
        label = f"inverse two-phase fit {mode}"
        (res, counts, ev), train_s = synced(lambda: train_checked(prob, c, label, SECOND_PATH if mode == "pallas" else ()))
        if mode == "pallas":
            paths["inverse two-phase fit (manufactured advdiff, mlp eps)"] = counts
        (coef, eps_hat, info), fit_s = synced(lambda: inv.fit_epsilon_field(prob, res.eval_params, order=order, reg=reg))
        err = field_rel(eps_hat)
        if not (math.isfinite(err) and info["residual_after"] <= info["residual_before"]):
            fail(f"phase 21 (a) {mode}: field rel-L2 {err}, residuals {info['residual_before']} -> {info['residual_after']}")
        fits[mode] = (err, ev["rel_l2"])
        line = (f"phase 21 (a) {mode}: Adam {c.train.iterations} + L-BFGS {c.train.lbfgs_iterations} in {train_s:.1f} s "
                f"({res.iterations_run} iterations; {lbfgs_note(res.phases['lbfgs'])}), u rel-L2 {ev['rel_l2']:.4e}, "
                f"net eps mean {float(prob.extras['eps_domain_mean'](res.eval_params)):.5f} (truth "
                f"{prob.extras['eps_true']:.5f}); fit_epsilon_field({order}, {reg}) on the card's fields in "
                f"{fit_s * 1e3:.1f} ms: field rel-L2 {err:.4e} (JAX rows {JAX_FIT_ROWS}), residual "
                f"{info['residual_before']:.4e} -> {info['residual_after']:.4e}; host launches {counts}")
        if mode == "pallas":
            cpu = inv_manufactured(c, "cpu")
            p_cpu = hv.params_from_jax(hv.params_to_numpy(res.eval_params), dtype=torch.float32)
            (_, eps_cpu, _), cpu_s = synced(lambda: inv.fit_epsilon_field(cpu, p_cpu, order=order, reg=reg))
            gap = field_rel(eps_hat, eps_cpu)
            ut, ux = inv._u_fields(prob, res.eval_params)
            ut_c, ux_c = inv._u_fields(cpu, p_cpu)
            du = max(float((a.cpu() - b).abs().max() / b.abs().max()) for a, b in ((ut, ut_c), (ux, ux_c)))
            if not gap <= INV_CARD_CPU_TOL:
                fail(f"phase 21 (a): the card's fit differs from the CPU's by {gap:.3e} (rel-L2), above {INV_CARD_CPU_TOL}")
            line += (f"; the same fit on the CPU's fields ({cpu_s * 1e3:.1f} ms): fields differ by {gap:.3e} rel-L2 "
                     f"(tolerance {INV_CARD_CPU_TOL}; u_t, u_x card vs CPU {du:.2e} of their largest, x 130 = "
                     f"{130 * du:.2e})")
        print(line, flush=True)
    print(f"phase 21 (a): field rel-L2 pallas {fits['pallas'][0]:.4e} taylor {fits['taylor'][0]:.4e} from one draw; "
          f"u rel-L2 pallas {fits['pallas'][1]:.4e} taylor {fits['taylor'][1]:.4e}", flush=True)

    # the repairs: bfloat16 (C18) and swish's nested JVPs (C17) on the card
    b16 = hv.Poisson2DConfig(dtype="bfloat16", n_quad=5, layers=(2, 6, 1), train=hv.TrainConfig(iterations=30, check_every=10))
    rb = hv.train(hv.build(b16, device=dev), verbose=False)
    bp = hv.build(dataclasses.replace(b16, deriv_mode="pallas"), device=dev)
    try:
        bp.loss_fn(bp.init_params(torch.Generator().manual_seed(0)), bp.data)
        fail("phase 21 (a): a bfloat16 'pallas' loss ran on the card; the kernels take float32 only")
    except ValueError as e:
        refusal = str(e)
    sw = hv.Poisson1DConfig(activation="swish", deriv_mode="jvp", var_form=1, n_elements=2, n_test=6, n_quad=12,
                            layers=(1, 8, 8, 1), train=hv.TrainConfig(iterations=20, check_every=5))
    rs = hv.train(hv.build(sw, device=dev), verbose=False)
    losses = (float(rb.final_aux["loss"]), float(rs.final_aux["loss"]))
    if not all(math.isfinite(v) for v in losses):
        fail(f"phase 21 (a): bfloat16 / swish runs ended at losses {losses}")
    print(f"phase 21 (a) repairs: Poisson-2D bfloat16 'taylor' 30 steps on the card, loss {losses[0]:.4e}; bfloat16 "
          f"'pallas' refused: {refusal!r}; swish Poisson-1D 'jvp' (second derivatives, metrics under no_grad) "
          f"20 steps, loss {losses[1]:.4e}", flush=True)
    return paths


def inverse_routes(dev, full: bool) -> dict:
    """Phase 21 (b): the network-free routes and their intervals, each on a
    float64 problem built on the card and again on one built on the CPU
    (the torch work runs on the problem's device; the rest is host
    numpy/scipy either way): the estimate's error beside the bound of the
    JAX package's own test and the README's figure, the wall time on each,
    and the two estimates against each other; at the README's sizes when
    `full`, else at the whole run's (INV_ROUTES).  Returns the field route's
    problems and info for (c)."""
    import hpvpinns_tpu_torch as hv
    from hpvpinns_tpu_torch import inverse as inv
    from hpvpinns_tpu_torch import uncertainty as uq

    f64 = dict(dtype="float64")
    rec = hv.AdvDiffConfig(**f64)
    field_cfg = dataclasses.replace(rec, sensor_stations=tuple(float(s) for s in np.linspace(-0.95, 0.95, 7)))
    als_cfg = dataclasses.replace(rec, n_quad=24, n_test_x=14, n_test_t=10, n_sensors_per_station=20,
                                  sensor_stations=tuple(float(s) for s in np.linspace(-0.95, 0.95, 19)))
    size = {route: row[0 if full else 1] for route, row in INV_ROUTES.items()}
    builders = {  # route -> (build on a device, run the route on a problem)
        "reduced_identify": (lambda d: hv.build(rec, device=d), lambda p: inv.reduced_identify(p, **size["reduced_identify"])),
        "reduced_identify (eps, V)": (lambda d: hv.build(rec, device=d), lambda p: inv.reduced_identify(
            p, identify_velocity=True, **size["reduced_identify (eps, V)"])),
        "reduced_identify_field": (lambda d: inv_manufactured(field_cfg, d),
                                   lambda p: inv.reduced_identify_field(p, **size["reduced_identify_field"])),
        "als_identify": (lambda d: inv_manufactured(als_cfg, d), lambda p: inv.als_identify(p, **size["als_identify"])),
        "reduced_identify2d": (lambda d: hv.build(hv.AdvDiff2DConfig(**f64), device=d),
                               lambda p: inv.reduced_identify2d(p, **size["reduced_identify2d"])),
        "reduced_identify_burgers": (lambda d: hv.build(hv.BurgersConfig(**f64), device=d),
                                     lambda p: inv.reduced_identify_burgers(p, **size["reduced_identify_burgers"])),
        "reduced_identify_kovasznay": (lambda d: hv.build(hv.KovasznayConfig(inverse=True, **f64), device=d),
                                       lambda p: inv.reduced_identify_kovasznay(p, **size["reduced_identify_kovasznay"])),
        "reduced_identify_taylorgreen": (lambda d: hv.build(hv.TaylorGreenConfig(inverse=True, **f64), device=d),
                                         lambda p: inv.reduced_identify_taylorgreen(
                                             p, **size["reduced_identify_taylorgreen"])),
        "reduced_identify_helmholtz": (lambda d: hv.build(hv.Helmholtz2DConfig(inverse=True, **f64), device=d),
                                       lambda p: inv.reduced_identify_helmholtz(p, **size["reduced_identify_helmholtz"])),
    }

    def errors(route, prob, out):
        """{name: relative error} of a route's estimate against the truth."""
        if route == "reduced_identify":
            return {"eps": abs(out[0][0] - prob.extras["eps_true"]) / prob.extras["eps_true"]}
        if route == "reduced_identify (eps, V)":
            return {"eps": abs(out[0][0] - prob.extras["eps_true"]) / prob.extras["eps_true"],
                    "V": abs(out[2]["velocity"] - 1.0)}
        if route in ("reduced_identify_field", "als_identify"):
            return {"field": field_rel(out[1] if route == "reduced_identify_field" else out[2])}
        if route == "reduced_identify2d":
            vx, vy = prob.config.velocity
            return {"eps": abs(out[0][0] - prob.extras["eps_true"]) / prob.extras["eps_true"],
                    "vx": abs(out[0][1] - vx), "vy": abs(out[0][2] - vy)}
        truth = {"reduced_identify_burgers": lambda: prob.config.nu,
                 "reduced_identify_helmholtz": lambda: prob.extras["k_sq_true"]}.get(route, lambda: prob.extras["nu_true"])()
        return {"estimate": abs(out[0] - truth) / truth}

    def estimate(route, out) -> np.ndarray:
        if route in ("reduced_identify", "reduced_identify (eps, V)", "reduced_identify_field"):
            return np.atleast_1d(np.asarray(out[0], dtype=np.float64))
        if route == "als_identify":
            return np.asarray(out[1], dtype=np.float64)
        if route == "reduced_identify2d":
            return np.asarray(out[0], dtype=np.float64)
        return np.atleast_1d(float(out[0]))

    keep = {}
    t_all = time.perf_counter()
    for route, (build, run) in builders.items():
        setup = ", ".join(f"{k} {v}" for k, v in size[route].items()) or "the route's defaults"
        bound, figure = INV_ROUTES[route][2:]
        card, cpu = build(dev), build("cpu")
        out, card_s = synced(lambda: run(card))
        out_cpu, cpu_s = synced(lambda: run(cpu))
        err = errors(route, card, out)
        if route == "reduced_identify_field":  # the fields, after L-BFGS-B paths that rounding may part
            agree = field_rel(out[1], out_cpu[1])
        else:
            a, b = estimate(route, out), estimate(route, out_cpu)
            agree = float(np.abs(a - b).max() / np.abs(b).max())
        if not all(math.isfinite(v) and v <= bound for v in err.values()):
            fail(f"phase 21 (b) {route} ({setup}): errors {err} above the JAX test's bound {bound}")
        if not agree <= INV_AGREE.get(route, 1e-12):
            fail(f"phase 21 (b) {route}: the card's estimate and the CPU's differ by {agree:.2e}")
        extra = ""
        if route == "reduced_identify (eps, V)":
            ci, ci_s = synced(lambda: uq.reduced_scalar_ci(card, out[0], p=size[route]["p"], velocity=out[2]["velocity"]))
            extra = f"; reduced_scalar_ci std {ci['std']} (eps, V), covers eps {covers(ci, 0, card.extras['eps_true'])} ({ci_s:.2f} s)"
        elif route == "reduced_identify_field":
            keep.update(field=(card, cpu, out, out_cpu))
            ci, ci_s = synced(lambda: uq.reduced_field_ci(out[0], out[2], domain=card.config.domain_x))
            band = ci["std_fn"](np.linspace(-1.0, 1.0, 257))
            extra = f"; reduced_field_ci sigma {ci['sigma']:.3e}, band mean {band.mean():.3e} max {band.max():.3e} ({ci_s:.2f} s)"
        elif route == "als_identify":
            bs, bs_s = synced(lambda: uq.als_bootstrap(card, out[1], out[0], n_boot=INV_BOOT, **size[route]))
            extra = f"; als_bootstrap {INV_BOOT} replicates: coef std max {bs['coef_std'].max():.3e} ({bs_s:.1f} s)"
        elif route == "reduced_identify2d":
            ci, ci_s = synced(lambda: uq.reduced_scalar_ci2d(card, out[0], p=size[route]["p"]))
            extra = f"; reduced_scalar_ci2d std {[f'{s:.2e}' for s in ci['std']]} ({ci_s:.2f} s)"
        elif route == "reduced_identify_kovasznay":
            ci, ci_s = synced(lambda: uq.reduced_ns_ci(card, out[0]))
            extra = f"; reduced_ns_ci std {ci['std'][0]:.3e}, covers {covers(ci, 0, card.extras['nu_true'])} ({ci_s:.2f} s)"
        elif route == "reduced_identify_taylorgreen":
            ci, ci_s = synced(lambda: uq.reduced_ns_unsteady_ci(card, out[0], p=out[1]["p"], n_steps=out[1]["n_steps"]))
            nu_t = card.extras["nu_true"]
            extra = (f"; reduced_ns_unsteady_ci debiased nu rel err {abs(ci['debiased'][0] - nu_t) / nu_t:.3e}, covers "
                     f"{covers(ci, 0, nu_t)} ({ci_s:.2f} s)")
        elif route == "reduced_identify_helmholtz":
            ci, ci_s = synced(lambda: uq.reduced_helmholtz_ci(card, out[0], p=out[1]["p"]))
            extra = f"; reduced_helmholtz_ci std {ci['std'][0]:.3e}, covers {covers(ci, 0, card.extras['k_sq_true'])} ({ci_s:.2f} s)"
        print(f"phase 21 (b) {route} ({setup}): errors " + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
              + f" (JAX test bound {bound}; README {figure}); card {card_s:.2f} s, CPU {cpu_s:.2f} s; card vs CPU "
              f"estimate {agree:.2e}" + extra, flush=True)
    print(f"phase 21 (b) ({'the README sizes' if full else 'the whole run cut'}): {time.perf_counter() - t_all:.1f} s",
          flush=True)
    return keep


def covers(ci, i, truth) -> bool:
    lo, hi = ci["ci95"][i]
    return bool(lo <= truth <= hi)


def inverse_torch_on_card(keep) -> None:
    """Phase 21 (c): reduced_identify_field's torch work on the card against
    the CPU in float64, each within INV_F64_TOL of its largest entry, with
    torch.profiler's CUDA kernels of each on the card: the prediction
    (matrix_exp over the sensor times) and reduced_field_ci's Jacobian
    (torch.func.jacfwd under no_grad) at the route's estimate, and the
    misfit with its gradient (autograd through matrix_exp) at the route's
    start, log eps = log 0.1 flat.  At the estimate the misfit's residuals
    are ~1e-5 (the data's own floor), a difference of O(1) predictions:
    there rounding alone parts card and CPU by ~1e-6 of the gradient."""
    card, cpu, out, out_cpu = keep["field"]
    s_hat = out[0]
    s0 = np.zeros_like(s_hat)
    s0[0] = np.log(0.1)
    pc, ph = out[2]["predict"], out_cpu[2]["predict"]
    ds = out[2]["sensor_values"]

    def prediction(predict, device):
        with torch.no_grad():
            return predict(torch.tensor(s_hat, dtype=torch.float64, device=device))

    def misfit_grad(predict, device):
        z = torch.tensor(s0, dtype=torch.float64, device=device, requires_grad=True)
        m = torch.sum((predict(z) - torch.as_tensor(ds, device=device)) ** 2)
        return torch.cat([m.detach()[None], torch.autograd.grad(m, z)[0]])

    def jac(predict, device):
        with torch.no_grad():
            return torch.func.jacfwd(predict)(torch.tensor(s_hat, dtype=torch.float64, device=device))

    lines = []
    dev = card.data["xb"].device
    for name, fn in (("prediction at the estimate", prediction), ("misfit and gradient at the start", misfit_grad),
                     ("jacfwd Jacobian at the estimate", jac)):
        got, want = fn(pc, dev), fn(ph, "cpu")
        err = float((got.cpu() - want).abs().max() / want.abs().max())
        kern = profiled_kernels(lambda: fn(pc, dev), n=3)
        if got.device.type != "cuda" or not kern:
            fail(f"phase 21 (c) {name}: ran on {got.device}, CUDA kernels {kern}")
        if not err <= INV_F64_TOL:
            fail(f"phase 21 (c) {name}: card against CPU {err:.3e} of the largest entry, above {INV_F64_TOL}")
        top = sorted(kern.items(), key=lambda kv: -kv[1])[:3]
        lines.append(f"{name} {err:.2e} of the largest (tolerance {INV_F64_TOL}), {len(kern)} CUDA kernels "
                     f"(top {', '.join(f'{k[:40]} x{v}' for k, v in top)})")
    print("phase 21 (c) reduced_identify_field on the card: " + "; ".join(lines), flush=True)


def phase21(dev, full: bool = False) -> dict:
    """Phase 21: (a) the two-phase field fit after "pallas" and "taylor"
    trainings and the two repairs, (b) the network-free routes and their
    intervals on the card and the CPU (at the README's sizes when `full`),
    (c) the field route's torch work on the card.  Returns (a)'s host
    launches."""
    t0 = time.perf_counter()
    paths = inverse_two_phase(dev)
    inverse_torch_on_card(inverse_routes(dev, full))
    print(f"phase 21: {time.perf_counter() - t0:.1f} s", flush=True)
    return paths


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

    if sys.argv[1:2] == ["--wide-only"]:  # for work on B2's wide form: phases 1, 2 and 15 only, no summary
        phase15(dev)
        print(f"chip_smoke: {time.perf_counter() - t_run:.1f} s", flush=True)
        return 0

    if sys.argv[1:2] == ["--families-quality"]:  # phase 16 (d) at each seed given (default: the presets')
        for seed in sys.argv[2:] or [None]:
            families_quality(dev, None if seed is None else int(seed))
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

    if sys.argv[1:2] == ["--volumetric-only"]:  # for work on the 3-axis path: phases 1, 2, 13 and 14, no summary
        phase13(dev)
        phase14(dev)
        print(f"chip_smoke: {time.perf_counter() - t_run:.1f} s", flush=True)
        return 0

    if sys.argv[1:2] == ["--poisson3d-quality"]:  # phase 13 (c) with hard BC too, at each seed given
        for seed in sys.argv[2:] or [None]:
            poisson3d_quality_runs(dev, None if seed is None else int(seed), hard_bc=True)
        return 0

    if sys.argv[1:2] == ["--gn-only"]:  # for work on Gauss-Newton: phases 1, 2 and 17 only, no summary
        phase17(dev)
        print(f"chip_smoke: {time.perf_counter() - t_run:.1f} s", flush=True)
        return 0

    if sys.argv[1:2] == ["--precision"]:  # phase 17 (d): the presets named (default all), each seed given
        names = [a for a in sys.argv[2:] if not a.isdigit()]
        for seed in [int(a) for a in sys.argv[2:] if a.isdigit()] or [None]:
            gn_precision(dev, seed, names)
        print(f"chip_smoke: {time.perf_counter() - t_run:.1f} s", flush=True)
        return 0

    if sys.argv[1:2] == ["--ns-only"]:  # for work on the Navier-Stokes systems: phases 1, 2 and 18, no summary
        phase18(dev)
        print(f"chip_smoke: {time.perf_counter() - t_run:.1f} s", flush=True)
        return 0

    if sys.argv[1:2] == ["--ns-quality"]:  # phase 18 (e) at each seed given (default: the presets')
        for seed in sys.argv[2:] or [None]:
            ns_quality(dev, None if seed is None else int(seed))
        print(f"chip_smoke: {time.perf_counter() - t_run:.1f} s", flush=True)
        return 0

    if sys.argv[1:2] == ["--ns-precision-stage"]:  # STAGE NAME [CHECKPOINT_DIR]: a schedule in two calls
        ns_precision_stage(dev, sys.argv[2], sys.argv[3], sys.argv[4] if len(sys.argv) > 4 else None)
        print(f"chip_smoke: {time.perf_counter() - t_run:.1f} s", flush=True)
        return 0

    if sys.argv[1:2] == ["--ns-jacobian"]:  # the precision presets' Jacobian builds at the block sizes given
        ns_jacobians(dev, [int(a) for a in sys.argv[2:]])
        print(f"chip_smoke: {time.perf_counter() - t_run:.1f} s", flush=True)
        return 0

    if sys.argv[1:2] == ["--adaptive-only"]:  # for work on the adaptive loop: phases 1, 2 and 19, no summary
        phase19(dev)
        print(f"chip_smoke: {time.perf_counter() - t_run:.1f} s", flush=True)
        return 0

    if sys.argv[1:2] == ["--adaptive"]:  # phase 19 (c): the parts named (default all) at their recorded budgets
        adaptive_full(dev, sys.argv[2:] or ("studies", "burgers", "sweep"))
        print(f"chip_smoke: {time.perf_counter() - t_run:.1f} s", flush=True)
        return 0

    if sys.argv[1:2] == ["--ensemble-only"]:  # for work on the options and the ensemble: phases 1, 2, 20 (a)-(e)
        phase20(dev, ("precision", "activations", "ensemble"))
        print(f"chip_smoke: {time.perf_counter() - t_run:.1f} s", flush=True)
        return 0

    if sys.argv[1:2] == ["--march-only"]:  # for work on time marching: phases 1, 2 and 20 (f), no summary
        phase20(dev, ("march",))
        print(f"chip_smoke: {time.perf_counter() - t_run:.1f} s", flush=True)
        return 0

    if sys.argv[1:2] == ["--march"]:  # phase 20 (f)'s marches at the study's equal-total schedules
        marches(dev, full=True)
        print(f"chip_smoke: {time.perf_counter() - t_run:.1f} s", flush=True)
        return 0

    if sys.argv[1:2] == ["--inverse-only"]:  # for work on the inverse suite: phases 1, 2 and 21, no summary
        phase21(dev, full=True)
        print(f"chip_smoke: {time.perf_counter() - t_run:.1f} s", flush=True)
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
    if min(counts[k] for k in SECOND_PATH) < 1:
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
                if min(counts[k] for k in SECOND_PATH) < 1 or min(gn[k] for k in SECOND_PATH) < 1:
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

    # 13. Poisson-3D through the three-axis kernel path: fused_fields_3d and
    # B2 at n_dirs 3, graphs, poisson3d_quality's full schedule
    p3d_times, p3d_paths, p3d_nodes = phase13(dev)
    paths.update(p3d_paths)
    nodes.update(p3d_nodes)

    # 14. AdvDiff-2D identification: modes, graphs, the joint row
    a2_paths, a2_nodes = phase14(dev)
    paths.update(a2_paths)
    nodes.update(a2_nodes)

    # 15. B2's wide form: against its plain version and the resident form,
    # then poisson2d_scaled var_form 0 with the 3 x 256 network
    wide_times, w_paths, w_nodes = phase15(dev)
    paths.update(w_paths)
    nodes.update(w_nodes)

    # 16. Helmholtz-2D and Burgers: modes, graphs, the default runs
    f_paths, f_nodes = phase16(dev)
    paths.update(f_paths)
    nodes.update(f_nodes)

    # 17. Gauss-Newton/LM: one step of each solve on the card against the
    # CPU, the dual Jacobian through B1/B2, helmholtz2d_quality with its LM
    # tail, checkpoints under the graph
    gn_jac = phase17(dev)
    paths["gn jacobian, advdiff_forward_precision without layer_feature"] = gn_jac["counts"]

    # 18. the Navier-Stokes systems on the JVP engine: card against CPU,
    # graphs against eager, rates, kovasznay_quality's cut schedule
    phase18(dev)

    # 19. adaptive hp refinement: the enriched indicators card against CPU,
    # adaptive_solve under "pallas" round by round, the direct-solver loop
    paths.update(phase19(dev))

    # 20. the network's last options (TF32 precision, gelu/swish, the
    # adaptive slope), the seed ensemble with the kernels under vmap, and
    # slab time marching
    ens_paths = phase20(dev)

    # 21. the inverse suite: the two-phase field fit after a "pallas"
    # training, the network-free routes and their intervals in float64, the
    # field route's torch work on the card
    paths.update(phase21(dev))

    ms, plain_ms, c_dev, c_graph, _ = times["scaled"]
    wide_ms, wide_plain_ms, wide_c_dev, wide_c_graph, wide_plain_dev = times["wide_scaled"]
    wide_bound = bound_ms(*fwd_work((2, 256, 256, 256, 1), 16384, 2, False))
    ms7, pshape, dev7, ev7 = bwd_times["p2d_scaled"]
    b1_bound = bound_ms(*fwd_work((2, 20, 20, 20, 1), 16384, 2, False))
    b2_bound = bound_ms(*bwd_work((2, 20, 20, 20, 1), 16384, 2))
    sum_bound = bound_ms(4 * (pshape[0] * pshape[1] + pshape[1]), pshape[0] * pshape[1])
    main_counts = paths["poisson2d_scaled var_form 1"]
    lay = wide_times["layered"]
    lay_main = lay["p2d_scaled 3 x 256"]
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
        {"name": "fused_fields_bwd_wide", "route": "cuda", "source": "hpvpinns_tpu_torch/csrc/fused_fields_bwd.cu",
         "replaces": "hpvpinns_tpu/ops/pallas_fields.py:259",
         # launches from phase 15 (h)'s path, the one that takes it by default; phase 15 (a)'s
         # forced checks apart
         "launches": paths[WIDE_PATH_CASE[0]]["fused_fields_bwd_wide"],
         "forced_check_launches": sum(wide_times[name]["forced_launches"] for name, *_ in WIDE_B2_CASES),
         "max_abs_err": max([wide_times["wide path"]] + [wide_times[name]["max_abs_err"] for name, *_ in WIDE_B2_CASES]),
         "ms": wide_times["p2d_scaled 3 x 256"]["us"] * 1e-3, "plain_ms": wide_times["p2d_scaled 3 x 256"]["plain_ms"],
         "bound_ms": wide_times["p2d_scaled 3 x 256"]["bound_ms"], "bound_by": wide_times["p2d_scaled 3 x 256"]["bound_by"],
         "library_ms": None, "shape": "(2, 256, 256, 256, 1) second, P 16384 (C function, CUDA events)",
         "device_us": wide_times["p2d_scaled 3 x 256"]["device_us"],
         "by_shape": {k: v for k, v in wide_times.items() if k not in ("train", "layered", "layered replay", "wide path")},
         "train": wide_times["train"]},
        {"name": "fused_fields_bwd_layered", "route": "cuda",
         "source": "hpvpinns_tpu_torch/csrc/fused_fields_bwd_layered.cu",
         "replaces": "hpvpinns_tpu/ops/pallas_fields.py:259",
         "launches": paths["poisson2d_scaled var_form 0 3 x 256"]["fused_fields_bwd_layered"],
         "max_abs_err": max(v["max_abs_err"] for v in lay.values()), "ms": lay_main["us"] * 1e-3,
         "plain_ms": lay_main["plain_ms"], "bound_ms": lay_main["bound_ms"], "bound_by": lay_main["bound_by"],
         "library_ms": None, "shape": "(2, 256, 256, 256, 1) second, P 16384 (C function, CUDA events)",
         "device_us": lay_main["device_us"], "v3_ms": lay_main["v3_us"] * 1e-3,
         "taylor_vjp_ms": lay_main["taylor_vjp_us"] * 1e-3, "block_sum_us": lay_main["sum_us"],
         "block_sum_bound_ms": lay_main["sum_bound_ms"], "partials": lay_main["partials"],
         "replay": wide_times["layered replay"], "by_shape": lay},
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
        if k["name"] in SECOND_PATH:
            k["gn_jacobian"] = {"launches": gn_jac["counts"][k["name"]], "M": gn_jac["M"], "P": gn_jac["P"],
                                "jacobian_s": gn_jac["jacobian_s"], "taylor_jacobian_s": gn_jac["taylor_jacobian_s"],
                                "shape": "advdiff_forward_precision without layer_feature, f32, one reverse build"}
        k["launches_by_path"] = {path: c.get(k["name"], 0) for path, c in paths.items()}
        # phase 20's train_ensemble runs (S members: the warm-up and capture of the step and of the
        # metrics, S launches each) and the "pallas" AdvDiff march, counted apart from `launches`
        k["ensemble_launches"] = {path: c.get(k["name"], 0) for path, c in ens_paths.items()
                                  if path.startswith("ensemble") and c.get(k["name"], 0)}
        k["march_launches"] = {path: c.get(k["name"], 0) for path, c in ens_paths.items()
                               if path.startswith("march") and c.get(k["name"], 0)}
        k["graph_nodes_by_path"] = {path: n.get(k["name"], 0) for path, n in nodes.items()}
        if k["name"] in adv:
            k["advdiff_of_record"] = adv[k["name"]]
            k["poisson3d_quality"] = {  # P 8,000, (3,48,48,48,1) tanh, n_dirs 3
                "fused_fields": {"firsts": p3d_times["B1 firsts"], "second": p3d_times["B1 second"]},
                "fused_fields_bwd": p3d_times["B2"], "block_sum": p3d_times["block sum"],
            }[k["name"]]
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_run:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
