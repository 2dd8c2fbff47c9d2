"""Slab-sequential time marching for the unsteady space-time families.

Counterpart of hpvpinns_tpu/training/timemarch.py.  The horizon
[t_start, t_final] is split into slabs solved one after another: each slab
is an ordinary problem of its family (`replace(cfg, t_start=a, t_final=b)`,
built with `ic_fn=`), trained by `train`, optionally warm-started from the
previous slab's parameters, and handed the previous slab's state at its
start time as its initial condition.  Burgers, AdvDiff (soft BC, forward
problems) and the Taylor-Green system march; Burgers and Taylor-Green march
with hard BC too, each slab's lift interpolating the predicted interface
state (`_hard_bc_slab_kwargs`).

Each slab's `train` builds its own chunks and graphs and frees them when it
ends.  A slab's lift closes over the previous slab's ansatz, held as
detached tensors: slab k's training reaches neither their values nor their
gradients, and slab k's lift evaluates a chain of k networks a point, as in
the JAX package.  Problems are built on the card unless the caller passes
device="cpu".
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from hpvpinns_tpu_torch.config import AdvDiffConfig, BurgersConfig, TaylorGreenConfig
from hpvpinns_tpu_torch.evaluate import evaluate, predict, rel_l2
from hpvpinns_tpu_torch.problems import advdiff, burgers, taylorgreen
from hpvpinns_tpu_torch.problems.base import Problem, map_params
from hpvpinns_tpu_torch.training.trainer import train


@dataclass
class TimeMarchResult:
    edges: np.ndarray  # slab boundaries in time, [S+1]
    problems: List[Problem]  # one per slab (each carries its own test grid)
    params: List[Any]  # trained eval-params per slab
    per_slab: List[dict]  # per-slab metrics (rel_l2 vs exact on the slab)
    metrics: dict  # global metrics over the concatenated horizon grid
    wall_time_s: float = 0.0
    history: List[Any] = field(default_factory=list)

    def slab_of(self, t: np.ndarray) -> np.ndarray:
        """Owning slab index for each time (interface points go to the
        EARLIER slab, whose network matched data there)."""
        idx = np.searchsorted(self.edges[1:-1], np.asarray(t), side="left")
        return np.clip(idx, 0, len(self.problems) - 1)

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Piecewise prediction over the full horizon: each point by the
        network of the slab that owns its time.  [P, C], C the problem's
        component count (1 for the scalar families, 3 for (u, v, p))."""
        X = np.asarray(X)
        owner = self.slab_of(X[:, -1])
        n_comp = np.asarray(self.problems[0].test_values).reshape(len(self.problems[0].test_points), -1).shape[1]
        out = np.zeros((X.shape[0], n_comp), dtype=np.float64)
        for k, (prob, p) in enumerate(zip(self.problems, self.params)):
            m = owner == k
            if m.any():
                out[m] = np.asarray(predict(prob, p, X[m])).reshape(-1, n_comp)
        return out


def _slab_builder(cfg):
    """Family dispatch: the slab-capable builders take ic_fn."""
    if isinstance(cfg, BurgersConfig):
        return burgers.build
    if isinstance(cfg, (AdvDiffConfig, TaylorGreenConfig)):
        if cfg.inverse:
            raise ValueError(
                "time_march solves forward problems (the sensors of an "
                "inverse run live on the GLOBAL horizon; identify the "
                "coefficient first, then march the forward solve)"
            )
        if isinstance(cfg, AdvDiffConfig) and getattr(cfg, "hard_bc", False):
            raise ValueError(
                "hard-BC slab marching is implemented for burgers and "
                "taylorgreen (the families with measured march arms); "
                "advdiff marches soft-BC"
            )
        return advdiff.build if isinstance(cfg, AdvDiffConfig) else taylorgreen.build
    raise TypeError(
        f"time_march supports the slab-capable unsteady families "
        f"(BurgersConfig, AdvDiffConfig, TaylorGreenConfig); "
        f"got {type(cfg).__name__}"
    )


def _at_time(x: torch.Tensor, t: float) -> torch.Tensor:
    """Spatial columns x [n, d] with the time column t appended."""
    return torch.cat([x, torch.full_like(x[:, :1], t)], dim=-1)


def _hard_bc_slab_kwargs(cfg, scfg, k, ic, prev_prob, prev_params):
    """Per-slab build arguments that keep a hard-BC ansatz exact on the
    slab's own data faces when marching (the JAX package's, timemarch.py:
    105-169).  Burgers: a constant-in-t lift from the slab's start-face state
    (problems/burgers.py::make_interface_lift), the previous slab's trained
    ansatz at the interface time for ic="net", the Cole-Hopf solution
    (u_exact_torch) for ic="exact" and for slab 0 of a shifted horizon.
    Taylor-Green: the space-time Coons lift with the predicted (u, v)
    initial face (problems/taylorgreen.py::coons_lift_spacetime's g_ic_fn
    hook); the side walls stay analytic.  `prev_params` are detached."""
    if not getattr(cfg, "hard_bc", False):
        return {}
    if isinstance(cfg, BurgersConfig):
        if k == 0 and scfg.t_start == 0.0:
            return {}  # the default lift is the analytic IC
        t_if = scfg.t_start
        if k > 0 and ic == "net":
            def u0_fn(x, _prob=prev_prob, _params=prev_params, _t=t_if):
                return _prob.apply(_params, _at_time(x, _t))
        else:
            def u0_fn(x, _nu=cfg.nu, _t=t_if):
                return burgers.u_exact_torch(x, _t, _nu)
        return {"lift_fn": burgers.make_interface_lift(u0_fn, cfg.domain_x)}
    if isinstance(cfg, TaylorGreenConfig):
        if k == 0 or ic == "exact":
            return {}  # the generalized Coons lift is analytic at t_start
        t_if = scfg.t_start

        def _component(i):
            def g_ic(x, y, _prob=prev_prob, _params=prev_params, _t=t_if, _i=i):
                return _prob.apply(_params, _at_time(torch.cat([x, y], dim=-1), _t))[:, _i : _i + 1]

            return g_ic

        return {"ic_lift_fns": (_component(0), _component(1))}
    return {}


def time_march(
    cfg,
    n_slabs: int,
    train_cfg=None,
    warm_start: bool = True,
    ic: str = "net",
    mesh=None,
    edges=None,
    budget_weights=None,
    verbose: bool = True,
    progress: Optional[Callable[[int, dict], None]] = None,
    *,
    device=None,
) -> TimeMarchResult:
    """Solve cfg's problem over [cfg.t_start, cfg.t_final] in `n_slabs`
    sequential time slabs, with the JAX package's arguments.

    cfg: a slab-capable unsteady config; its n_elements_t and iteration
        budget are PER SLAB.
    ic: "net" hands each slab the previous slab's trained network state;
        "exact" uses the analytic solution at every slab start.
    warm_start: start each slab's network at the previous slab's trained
        parameters (`train` copies them) instead of a fresh draw.
    edges: explicit slab boundaries (n_slabs + 1, ascending); default
        uniform.
    budget_weights: per-slab multipliers (n_slabs, > 0) of the training
        budget (Adam, L-BFGS and Gauss-Newton iterations), normalized to
        mean 1 so the march's total budget is unchanged.
    device: where the slabs' problems are built (default the card; "cpu"
        for the CPU).  `mesh` is not ported.
    """
    if n_slabs < 1:
        raise ValueError("n_slabs must be >= 1")
    if ic not in ("net", "exact"):
        raise ValueError(f"ic must be 'net' or 'exact', got {ic!r}")
    if mesh is not None:
        raise NotImplementedError(
            "time_march: mesh (multi-device training) is not ported yet (ROADMAP.md, queue A item 24)")
    build = _slab_builder(cfg)
    t0 = float(getattr(cfg, "t_start", 0.0))
    edges = np.linspace(t0, cfg.t_final, n_slabs + 1) if edges is None else np.asarray(edges, dtype=np.float64)
    if len(edges) != n_slabs + 1 or not np.all(np.diff(edges) > 0):
        raise ValueError("edges must be n_slabs+1 ascending times")
    weights = None
    if budget_weights is not None:
        weights = np.asarray(budget_weights, dtype=np.float64)
        if len(weights) != n_slabs or np.any(weights <= 0):
            raise ValueError(f"budget_weights must be {n_slabs} positive multipliers")
        weights = weights * (n_slabs / weights.sum())  # mean 1: total fixed

    t_begin = time.perf_counter()
    problems: List[Problem] = []
    params_list: List[Any] = []
    per_slab: List[dict] = []
    histories: List[Any] = []
    prev_prob, prev_params = None, None
    for k in range(n_slabs):
        scfg = dataclasses.replace(cfg, t_start=float(edges[k]), t_final=float(edges[k + 1]))
        ic_fn = None
        if k > 0 and ic == "net":
            def ic_fn(x, _prob=prev_prob, _params=prev_params, _t=float(edges[k])):
                # x: the spatial columns ([n, 1] scalar families, [n, 2]
                # systems); the full state [n, C] at the interface time, of
                # which the family's builder takes what its IC face needs
                x = np.asarray(x)
                X = np.hstack([x, np.full((len(x), 1), _t)])
                return np.asarray(predict(_prob, _params, X)).reshape(len(x), -1)

        prob = build(scfg, ic_fn=ic_fn, **_hard_bc_slab_kwargs(cfg, scfg, k, ic, prev_prob, prev_params),
                     device=device)
        init = prev_params if (warm_start and prev_params is not None) else None
        tc_k = train_cfg
        if weights is not None:
            base = train_cfg if train_cfg is not None else cfg.train
            w = float(weights[k])
            tc_k = dataclasses.replace(
                base,
                iterations=max(1, int(round(base.iterations * w))),
                lbfgs_iterations=int(round(base.lbfgs_iterations * w)),
                gn_iterations=int(round(base.gn_iterations * w)),
            )
        res = train(prob, tc_k, params=init, verbose=verbose)
        m = evaluate(prob, res.eval_params)
        loss = res.final_aux.get("loss")
        m = {"slab": k, "t0": float(edges[k]), "t1": float(edges[k + 1]), "iterations": res.iterations_run,
             "final_loss": None if loss is None else float(loss), **m}
        per_slab.append(m)
        if progress is not None:
            progress(k, m)
        problems.append(prob)
        params_list.append(res.eval_params)
        histories.append(res.history)
        prev_prob, prev_params = prob, map_params(lambda t: t.detach(), res.eval_params)

    # Global metrics: every slab's own dense test grid, concatenated; the
    # interface rows appear once for each adjacent slab, each evaluated by
    # its own network.
    preds, exacts = [], []
    for prob, p in zip(problems, params_list):
        n_pts = len(prob.test_points)
        preds.append(np.asarray(predict(prob, p)).reshape(n_pts, -1))
        exacts.append(np.asarray(prob.test_values).reshape(n_pts, -1))
    u_pred, u_true = np.concatenate(preds), np.concatenate(exacts)
    err = u_pred - u_true
    metrics = {
        "rel_l2": float(np.linalg.norm(err) / np.linalg.norm(u_true)),
        "max_abs_err": float(np.max(np.abs(err))),
        "mean_abs_err": float(np.mean(np.abs(err))),
    }
    if u_true.shape[1] > 1:
        names = problems[0].extras.get("component_names", tuple(f"c{i}" for i in range(u_true.shape[1])))
        for i, name in enumerate(names):
            metrics[f"rel_l2_{name}"] = rel_l2(u_pred[:, i], u_true[:, i])
    return TimeMarchResult(
        edges=edges,
        problems=problems,
        params=params_list,
        per_slab=per_slab,
        metrics=metrics,
        wall_time_s=time.perf_counter() - t_begin,
        history=histories,
    )
