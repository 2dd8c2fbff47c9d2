"""The float64 Gauss-Newton/LM polish of float32-trained parameters.

Counterpart of hpvpinns_tpu/training/hybrid.py.  The JAX package trains in
float32 on a chip without float64 and polishes on the host: a subprocess
on the CPU rebuilds the problem in float64 from a JSON spec of its config
(_polish_worker.py).  The H100 computes in float64, so here the polish runs
in this process, on the device the caller names (the card by default): it
rebuilds the problem with dtype="float64", warm-starts `gauss_newton` from
the given parameters and returns them polished, cast back, with the float64
metrics before and after.  `_polish_worker.py` has no counterpart.  Under
deriv_mode="pallas" on the card the float64 rebuild meets the kernels'
float64 refusal and raises (ROADMAP.md, queue C): nothing switches mode.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Optional

import torch

from hpvpinns_tpu_torch import config as config_mod
from hpvpinns_tpu_torch.config import TrainConfig
from hpvpinns_tpu_torch.evaluate import evaluate
from hpvpinns_tpu_torch.problems import build
from hpvpinns_tpu_torch.problems.base import map_params, parameters
from hpvpinns_tpu_torch.training.gauss_newton import gauss_newton

__all__ = [
    "PolishResult",
    "config_from_spec",
    "config_to_spec",
    "polish_f64",
]


def config_to_spec(cfg) -> dict:
    """A frozen problem config as a JSON-safe dict: the class name and every
    field (config_from_spec turns the lists JSON makes of tuples back)."""
    if not dataclasses.is_dataclass(cfg):
        raise TypeError(f"not a config dataclass: {type(cfg).__name__}")
    return {"family": type(cfg).__name__, "fields": dataclasses.asdict(cfg)}


def _tuplify(value):
    if isinstance(value, list):
        return tuple(_tuplify(v) for v in value)
    return value


def config_from_spec(spec: dict):
    """The config that config_to_spec described."""
    cls = getattr(config_mod, spec["family"], None)
    if cls is None or not dataclasses.is_dataclass(cls):
        raise ValueError(f"unknown config family: {spec['family']!r}")
    fields = {k: _tuplify(v) for k, v in spec["fields"].items()}
    if isinstance(fields.get("train"), dict):
        fields["train"] = TrainConfig(**{k: _tuplify(v) for k, v in fields["train"].items()})
    return cls(**fields)


@dataclass(frozen=True)
class PolishResult:
    """The outcome of a float64 LM polish.

    `params` is the polished tree cast back to the dtype and device of each
    leaf the caller gave; `params_f64` keeps the float64 leaves.  `metrics`
    is the float64 evaluation of the polished network (rel-L2 and the
    pointwise errors), `metrics_start` that of the incoming parameters."""

    params: dict
    params_f64: dict
    loss: float
    accepted: int
    stopped: str
    wall_s: float
    metrics: dict
    metrics_start: dict


def polish_f64(
    cfg,
    params,
    iterations: int = 50,
    solve: str = "normal",
    damping_init: float = 1e-3,
    ftol: float = 0.0,
    gtol: float = 0.0,
    cg_tol: float = 1e-3,
    cg_maxiter: Optional[int] = None,
    jac_chunk: Optional[int] = 128,
    timeout: Optional[float] = None,
    verbose: bool = False,
    python: Optional[str] = None,
    *,
    device=None,
) -> PolishResult:
    """Polish `params` with a float64 Gauss-Newton/LM phase.

    `cfg` is the problem's config (usually float32); the problem is rebuilt
    from it with dtype="float64" on `device` (default: the card).
    `iterations` counts accepted LM steps, as in gauss_newton;
    solve="normal" is its own choice at float64.  `jac_chunk=128` builds the
    float64 Jacobian in blocks of 128 passes (the whole-J vmap took more
    than 30 GB in the JAX package on poisson2d_precision); None restores
    gauss_newton's own rule.  `timeout` and `python` belong to the JAX
    package's subprocess and are not used."""
    del timeout, python
    prob = build(dataclasses.replace(cfg, dtype="float64"), device=device)
    dev = prob.data["xb"].device
    params_f64 = map_params(lambda t: t.detach().to(device=dev, dtype=torch.float64), params)
    metrics_start = evaluate(prob, params_f64)
    t0 = time.perf_counter()
    gn = gauss_newton(prob, params_f64, iterations=iterations, solve=solve, damping_init=damping_init, ftol=ftol,
                      gtol=gtol, cg_tol=cg_tol, cg_maxiter=cg_maxiter, jac_chunk=jac_chunk, verbose=verbose)
    wall = time.perf_counter() - t0
    cast = {id(t): new.to(device=t.device, dtype=t.dtype) for t, new in zip(parameters(params), parameters(gn.params))}
    return PolishResult(
        params=map_params(lambda t: cast[id(t)], params),
        params_f64=gn.params,
        loss=float(gn.final_aux["loss"]),
        accepted=gn.accepted,
        stopped=gn.stopped,
        wall_s=wall,
        metrics=evaluate(prob, gn.params),
        metrics_start=metrics_start,
    )
