"""Generic trainer: full-batch Adam in chunks of `check_every` steps.

Counterpart of hpvpinns_tpu/training/trainer.py (the Adam phase).  Each
chunk runs `check_every` optimizer steps without reading anything back, then
evaluates the metrics at the updated parameters (as the JAX chunk does,
trainer.py:170-175) and brings them to the host in one sync.  Threshold
early stop, loss history and the best-parameter snapshot behave as in the
JAX package, so the history matches it step for step.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from hpvpinns_tpu_torch.config import TrainConfig
from hpvpinns_tpu_torch.models.mlp import use_ieee_fp32_matmuls
from hpvpinns_tpu_torch.problems.base import Problem, parameters


@dataclass
class TrainResult:
    params: Any
    history: Dict[str, np.ndarray]  # 'iteration', 'loss', 'lossb', 'lossv'
    iterations_run: int
    wall_time_s: float
    steps_per_sec: float
    stopped_early: bool
    best_params: Optional[Any] = None
    final_aux: Dict[str, float] = field(default_factory=dict)

    @property
    def eval_params(self):
        """The best snapshot when one was kept, otherwise the final params."""
        return self.best_params if self.best_params is not None else self.params


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Adam:
    """Adam with the optax/TF1 defaults (betas 0.9/0.999, eps 1e-8) and the
    configured learning rate, over every leaf of `params`."""
    return torch.optim.Adam(parameters(params), lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8)


def _copy_params(params, as_parameters: bool):
    def copy(t):
        t = t.detach().clone()
        return nn.Parameter(t) if as_parameters else t

    return {
        "net": [{k: copy(v) for k, v in layer.items()} for layer in params["net"]],
        "pde": {k: copy(v) for k, v in params["pde"].items()},
    }


def _check_supported(cfg: TrainConfig, mesh) -> None:
    unported = {
        "lbfgs_iterations > 0 (the L-BFGS phase)": cfg.lbfgs_iterations > 0,
        "gn_iterations > 0 (the Gauss-Newton/LM phase)": cfg.gn_iterations > 0,
        "checkpoint_dir (checkpointing)": cfg.checkpoint_dir is not None,
        "mesh (multi-device training)": mesh is not None,
    }
    for what, bad in unported.items():
        if bad:
            raise NotImplementedError(f"train: {what} is not ported yet (ROADMAP.md)")


def train(
    problem: Problem,
    cfg: Optional[TrainConfig] = None,
    params=None,
    verbose: bool = True,
    mesh=None,
) -> TrainResult:
    """Adam on problem.loss_fn.  `params` (default: problem.init_params from
    a CPU torch.Generator seeded with cfg.seed) are copied, never updated in
    place."""
    cfg = cfg or problem.config.train
    _check_supported(cfg, mesh)
    use_ieee_fp32_matmuls()
    loss_fn, data = problem.loss_fn, problem.data
    if params is None:
        params = problem.init_params(torch.Generator().manual_seed(cfg.seed))
    params = _copy_params(params, as_parameters=True)
    opt = make_optimizer(cfg, params)

    check = max(1, cfg.check_every)
    records: List[Dict[str, float]] = []
    stopped = False
    best_params = None
    min_loss = np.inf
    snap_after = (
        cfg.best_snapshot_fraction * cfg.iterations
        if cfg.best_snapshot_fraction is not None
        else None
    )

    t0 = t_log = time.perf_counter()
    t_warm, it_warm = None, 0
    it = 0
    aux_host: Dict[str, float] = {}
    while it < cfg.iterations:
        n = min(check, cfg.iterations - it)
        for _ in range(n):
            opt.zero_grad(set_to_none=True)
            loss, _ = loss_fn(params, data)
            loss.backward()
            opt.step()
        with torch.no_grad():  # metrics at the UPDATED params
            _, aux = loss_fn(params, data)
        keys = list(aux)
        values = torch.stack([aux[k].detach() for k in keys]).tolist()  # one device sync
        aux_host = dict(zip(keys, values))
        it += n
        if t_warm is None:  # the first chunk carries one-time build/warm-up costs
            t_warm, it_warm = time.perf_counter(), it
        records.append({"iteration": it, **aux_host})
        loss_value = aux_host["loss"]

        if snap_after is not None and it > snap_after and loss_value < min_loss:
            min_loss = loss_value
            best_params = _copy_params(params, as_parameters=False)
        if cfg.threshold is not None and loss_value < cfg.threshold:
            if verbose:
                print(f"It: {it}, Loss: {loss_value:.3e} (threshold reached)")
            stopped = True
            break
        if verbose and it % cfg.log_every < check:
            now = time.perf_counter()
            parts = ", ".join(f"{k}: {v:.3e}" for k, v in aux_host.items() if k != "loss")
            print(f"It: {it}, Loss: {loss_value:.3e}, {parts}, Time: {now - t_log:.2f}")
            t_log = now

    t_end = time.perf_counter()
    wall = t_end - t0
    if t_warm is not None and it > it_warm and t_end > t_warm:
        sps = (it - it_warm) / (t_end - t_warm)
    else:
        sps = it / wall if wall > 0 else float("nan")

    keys = sorted({k for r in records for k in r})
    history = {k: np.asarray([r.get(k, np.nan) for r in records]) for k in keys}
    return TrainResult(
        params=params,
        history=history,
        iterations_run=it,
        wall_time_s=wall,
        steps_per_sec=sps,
        stopped_early=stopped,
        best_params=best_params,
        final_aux=aux_host,
    )
