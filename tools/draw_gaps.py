"""The accuracy gaps held against the JAX package from its own initial draws.

One table, read by both halves: `tools/jax_draws.py` (JAX on the CPU, which
saves each draw and trains from it) and `tools/draw_parity.py` (the port,
which trains from the saved draw and from its own).  A config is built from
whichever package is handed in: both packages name their presets and config
classes alike.  This module imports neither package and no array library.

Each gap: the config, its dtype, the seeds, the metric that decides it and
the port's derivative modes.  `metrics` reads a trained run in either
package into plain floats.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
import os
from typing import Callable, NamedTuple, Tuple

DRAWS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "draws")
JAX_RESULTS = os.path.join(DRAWS_DIR, "jax_cpu.json")
PORT_RESULTS = os.path.join(DRAWS_DIR, "port_h100.json")


def _joint(hv):
    """The AdvDiff-2D joint identification row (ACCURACY.json
    advdiff2d_joint_f32_tpu): (3,24,24,24,1), 10^3 quadrature points, 6^3
    test functions, eps and (vx, vy) trained, Adam 5k + L-BFGS 5k, f32."""
    return hv.AdvDiff2DConfig(
        layers=(3, 24, 24, 24, 1), n_quad=10, n_test_x=6, n_test_y=6, n_test_t=6, velocity_trainable=True,
        train=hv.TrainConfig(iterations=5000, lbfgs_iterations=5000, check_every=500, best_snapshot_fraction=0.9),
    )


class Gap(NamedTuple):
    name: str  # the config's name: the draws' file stem
    make: Callable  # package -> config
    dtype: str
    seeds: Tuple[int, ...]
    metric: str  # the key of `metrics` that decides the gap
    port_modes: Tuple[str, ...]  # the port's deriv_mode runs


GAPS = {
    "C7": Gap("advdiff_quality", lambda hv: hv.advdiff_quality(), "float64", (1234, 0, 1, 2, 3), "eps_rel",
              ("taylor",)),
    "C14": Gap("advdiff_precision", lambda hv: hv.advdiff_precision(), "float64", (1234, 0, 1, 2, 3), "eps_rel",
               ("taylor",)),
    "C8": Gap("advdiff2d_joint", _joint, "float32", (1234, 0, 1, 2, 3), "eps_rel", ("taylor", "pallas")),
    "C9": Gap("poisson2d_quality", lambda hv: hv.poisson2d_quality(), "float32", (1234, 0, 1, 2, 3), "rel_l2",
              ("taylor", "pallas")),
    "C10": Gap("helmholtz2d_inverse", lambda hv: hv.Helmholtz2DConfig(inverse=True), "float32", (1234, 0, 1, 2, 3),
               "k_sq_rel", ("taylor",)),
    "C11": Gap("helmholtz2d_quality", lambda hv: hv.helmholtz2d_quality(), "float32", (1234, 0, 1, 2, 3), "rel_l2",
               ("taylor",)),
    "C13": Gap("helmholtz2d_precision", lambda hv: hv.helmholtz2d_precision(), "float32", (1234, 0, 1), "rel_l2",
               ("taylor",)),
    "C12": Gap("burgers_precision", lambda hv: hv.burgers_precision(), "float32", (1234, 0, 1), "rel_l2",
              ("taylor",)),
}


def config(gap: str, hv, seed: int, **kw):
    """The gap's config from package `hv` with its train seed set to `seed`
    (the seed draws the problem's data and the initial parameters in both
    packages); `kw` replaces config fields (the port's deriv_mode)."""
    c = GAPS[gap].make(hv)
    assert c.dtype == GAPS[gap].dtype, (gap, c.dtype)
    return dataclasses.replace(c, train=dataclasses.replace(c.train, seed=seed), **kw)


def draw_path(gap: str, seed: int) -> str:
    return os.path.join(DRAWS_DIR, f"{GAPS[gap].name}_s{seed}.npz")


def _float(x) -> float:
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return float(x)


def metrics(gap: str, hv, prob, res) -> dict:
    """The trained run's numbers: rel-L2 of the reported parameters, the
    final loss, and eps / |V| / k^2 with their relative errors where the
    config identifies them."""
    p = res.eval_params
    out = {"rel_l2": float(hv.evaluate_problem(prob, p)["rel_l2"]), "final_loss": float(res.history["loss"][-1])}
    if "eps_domain_mean" in prob.extras and getattr(prob.config, "inverse", False):
        eps, eps_true = _float(prob.extras["eps_domain_mean"](p)), float(prob.extras["eps_true"])
        out.update(eps=eps, eps_rel=abs(eps - eps_true) / eps_true)
    if getattr(prob.config, "velocity_trainable", False):
        v = prob.extras["v_of"](p)
        speed = math.hypot(_float(v[0]), _float(v[1]))
        out.update(velocity=speed, velocity_rel=abs(speed - prob.extras["velocity_true"]) / prob.extras["velocity_true"])
    if "k_sq_true" in prob.extras and getattr(prob.config, "inverse", False):
        k, k_true = _float(p["pde"]["k_sq"]), float(prob.extras["k_sq_true"])
        closed = importlib.import_module(hv.__name__ + ".problems.helmholtz").closed_form_k_sq(prob, p)
        out.update(k_sq=k, k_sq_rel=abs(k - k_true) / k_true, k_sq_closed_form=float(closed))
    out["metric"] = out[GAPS[gap].metric]
    return out


def phases(cfg, res) -> dict:
    """The phases' counts as both packages record them: Adam steps, L-BFGS
    iterations (both as configured, unless the run stopped early) and the
    accepted LM steps (the history records that carry a damping)."""
    damping = res.history.get("damping")
    lm = 0 if damping is None else int(sum(1 for d in damping if d == d))
    return {"adam": cfg.train.iterations, "lbfgs": cfg.train.lbfgs_iterations, "lm_accepted": lm,
            "iterations_run": int(res.iterations_run), "stopped_early": bool(res.stopped_early)}


def history(res) -> dict:
    """The history as JSON lists (NaN as null)."""
    return {k: [None if v != v else float(v) for v in vals] for k, vals in res.history.items()}


KEPT = ("iteration", "loss", "epsilon", "vx", "vy", "k_sq", "damping")


def stored(run: dict) -> dict:
    """A run as the results files keep it: of the history the iterations,
    the loss, the coefficients and the damping, in a float32 gap at most
    about 100 records (evenly spaced, the last kept: float32 is judged on
    the final metric), and no history at all for a seed beyond the gap's
    own (those only widen (ii), which reads the final metric)."""
    run, gap = dict(run), GAPS[run["gap"]]
    if run["seed"] not in gap.seeds:
        run.pop("history", None)
    elif "history" in run:
        h = {k: v for k, v in run["history"].items() if k in KEPT}
        n = len(h["iteration"])
        if gap.dtype == "float32" and n > 100:
            keep = sorted(set(range(0, n, -(-n // 100))) | {n - 1})
            h = {k: [v[i] for i in keep] for k, v in h.items()}
        run["history"] = h
    return run


def dump_runs(f, runs) -> None:
    """Write `runs` (each as `stored` keeps it) to the open file `f` as a
    JSON list, one run a line."""
    f.write("[\n" + ",\n".join(json.dumps(stored(r), separators=(",", ":")) for r in runs) + "\n]\n")
