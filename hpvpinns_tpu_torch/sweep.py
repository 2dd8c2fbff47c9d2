"""h/p-refinement sweeps: the hp-convergence studies of the method.

Counterpart of hpvpinns_tpu/sweep.py, with the same names and signatures
(and a keyword `device`).  h-refinement (the element count) and
p-refinement (the per-element test orders) run as programmatic sweeps; each
point retrains from the same seed through `train` (on the card unless
`device` names another) and reports rel-L2 against the analytic solution,
throughput and the per-element error, as one record.  `plot_sweep` renders the log-error
convergence curve (matplotlib, imported only there).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence

from hpvpinns_tpu_torch.config import TrainConfig
from hpvpinns_tpu_torch.evaluate import evaluate as evaluate_problem
from hpvpinns_tpu_torch.evaluate import per_element_rel_l2
from hpvpinns_tpu_torch.problems import build
from hpvpinns_tpu_torch.training import train


def _with(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


def _run_point(cfg, train_cfg, mesh=None, verbose=False, device=None) -> dict:
    # the module-level `build` is the sweep's hook (it may take the config
    # alone); `device` goes to it only when one is named
    prob = build(cfg) if device is None else build(cfg, device=device)
    res = train(prob, train_cfg, mesh=mesh, verbose=verbose)
    metrics = evaluate_problem(prob, res.eval_params)
    return {
        "rel_l2": metrics["rel_l2"],
        "max_abs_err": metrics["max_abs_err"],
        "final_loss": res.final_aux.get("loss"),
        "steps_per_sec": res.steps_per_sec,
        "iterations": res.iterations_run,
        # where in the mesh the error lives
        "per_element_rel_l2": [float(v) for v in per_element_rel_l2(prob, res.eval_params)],
    }


def _family_fields(cfg, prefix):
    """Field names matching the config-wide mesh/test naming convention
    (`n_elements[_x|_y|_z|_t]`, `n_test[_x|_y|_z|_t]`, `grid[_x|_y|_t]`):
    every problem config follows it, so sweeps are family-generic."""
    return [
        f.name for f in dataclasses.fields(cfg)
        if (f.name == prefix or f.name.startswith(prefix + "_"))
        and not f.name.endswith("_per_elem")
    ]


def h_sweep(
    base_cfg,
    n_elements: Sequence[int],
    train_cfg: Optional[TrainConfig] = None,
    mesh=None,
    verbose: bool = False,
    *,
    device=None,
):
    """Refine in h (element count, uniform over every mesh axis), holding
    the per-element order fixed.  Explicit `grid*` tuples and per-element
    test orders are cleared: they pin the mesh the sweep is varying.
    `device`: where each point's problem is built (default the card)."""
    elem_fields = _family_fields(base_cfg, "n_elements")
    if not elem_fields:
        raise TypeError(f"h_sweep: {type(base_cfg).__name__} has no n_elements fields")
    reset = {name: None for name in _family_fields(base_cfg, "grid")}
    reset.update({
        f.name: None for f in dataclasses.fields(base_cfg)
        if f.name.endswith("_per_elem")
    })
    records = []
    for ne in n_elements:
        cfg = _with(base_cfg, **{name: ne for name in elem_fields}, **reset)
        rec = {"axis": "h", "n_elements": ne, **_run_point(cfg, train_cfg, mesh, verbose, device)}
        records.append(rec)
    return records


def p_sweep(
    base_cfg,
    n_tests: Sequence[int],
    train_cfg: Optional[TrainConfig] = None,
    mesh=None,
    verbose: bool = False,
    *,
    device=None,
):
    """Refine in p (test-function order, uniform over every tensor axis),
    holding the element grid fixed.  `device` as in h_sweep."""
    test_fields = _family_fields(base_cfg, "n_test")
    if not test_fields:
        raise TypeError(f"p_sweep: {type(base_cfg).__name__} has no n_test fields")
    reset = {
        f.name: None for f in dataclasses.fields(base_cfg)
        if f.name.endswith("_per_elem")
    }
    records = []
    for nt in n_tests:
        cfg = _with(base_cfg, **{name: nt for name in test_fields}, **reset)
        rec = {"axis": "p", "n_test": nt, **_run_point(cfg, train_cfg, mesh, verbose, device)}
        records.append(rec)
    return records


def save_sweep(records, path: str):
    with open(path, "w") as f:
        json.dump(records, f, indent=1)
    return path


def plot_sweep(records, outdir: str, fmt: str = "pdf"):
    """Log-scale rel-L2 convergence curve over the swept axis."""
    import os

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(outdir, exist_ok=True)
    axis = records[0]["axis"]
    key = "n_elements" if axis == "h" else "n_test"
    xs = [r[key] for r in records]
    ys = [r["rel_l2"] for r in records]
    fig, ax = plt.subplots(figsize=(7, 5))
    ax.loglog(xs, ys, "o-")
    ax.set_xlabel("number of elements" if axis == "h" else "test functions per element")
    ax.set_ylabel("relative $L_2$ error")
    ax.grid(True, which="both", alpha=0.4)
    path = os.path.join(outdir, f"{axis}_convergence.{fmt}")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return path
