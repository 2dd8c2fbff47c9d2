"""Visualization — the reference's plot set (C16), reproduced per problem.

Counterpart of hpvpinns_tpu/viz.py, with the same functions, file names and
formats.  The data come from the port's `evaluate.predict` and
`per_element_rel_l2` (numpy on the host, whatever the problem's device).

Covers: quadrature/training-point maps and prediction/error plots for 1D
(Poisson-1D.py:339-429), loss history on log scale (:386-397), 2D contour
prediction/error (Poisson-2D.py:437-534), AdvDiff per-time slices with L-inf
annotation (AdvDiff.py:660-696) and the epsilon-convergence trajectory
(AdvDiff.py:539-551).  All figures are written to an output directory as PDF
or PNG, mirroring the reference's Results/ artifacts.

matplotlib is an optional dependency; import errors surface only when a plot
function is called.
"""

from __future__ import annotations

import os

import numpy as np

import torch

from hpvpinns_tpu_torch.evaluate import per_element_rel_l2, predict
from hpvpinns_tpu_torch.problems.base import Problem
from hpvpinns_tpu_torch.training.trainer import TrainResult


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _host(a) -> np.ndarray:
    """numpy of a tensor on any device, or of an array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _on_problem(problem: Problem, a: np.ndarray) -> torch.Tensor:
    """Host points as a tensor on the problem's device, in its dtype."""
    xb = problem.data["xb"]
    return torch.as_tensor(a).to(device=xb.device, dtype=xb.dtype)


def _save(fig, outdir: str, name: str, fmt: str):
    os.makedirs(outdir, exist_ok=True)
    path = os.path.join(outdir, f"{name}.{fmt}")
    fig.savefig(path, bbox_inches="tight")
    return path


def plot_loss_history(result: TrainResult, outdir: str, fmt: str = "pdf"):
    """Log-scale loss history (Poisson-1D.py:386-397)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(11, 5.5))
    ax.set_xlabel("iteration")
    ax.set_ylabel("loss values")
    ax.set_yscale("log")
    ax.grid(True)
    for key in ("loss", "lossb", "lossv", "lossp"):
        if key in result.history:
            ax.plot(result.history["iteration"], result.history[key], label=key)
    ax.legend()
    path = _save(fig, outdir, "loss", fmt)
    plt.close(fig)
    return path


def plot_1d_solution(problem: Problem, params, outdir: str, fmt: str = "pdf", pnt_skip: int = 25):
    """Prediction vs exact + log pointwise error with element boundaries
    (Poisson-1D.py:400-429)."""
    plt = _plt()
    x = problem.test_points.reshape(-1)
    u_true = problem.test_values.reshape(-1)
    u_pred = predict(problem, params).reshape(-1)
    grid = problem.extras["mesh"].grid

    fig, ax = plt.subplots(figsize=(11, 5.5))
    ax.axhline(0, linewidth=0.8, color="gray")
    for xc in grid:
        ax.axvline(x=xc, linewidth=2, ls="--")
    ax.plot(x, u_true, linewidth=1, color="r", label="exact")
    ax.plot(x[::pnt_skip], u_pred[::pnt_skip], "k*", label="VPINN")
    ax.set_xlabel("$x$")
    ax.set_ylabel("$u$")
    ax.legend(loc="upper left")
    p1 = _save(fig, outdir, "prediction", fmt)
    plt.close(fig)

    fig, ax = plt.subplots(figsize=(11, 5.5))
    ax.set_yscale("log")
    for xc in grid:
        ax.axvline(x=xc, linewidth=2, ls="--")
    ax.plot(x, np.abs(u_true - u_pred), "k")
    ax.set_xlabel("$x$")
    ax.set_ylabel("point-wise error")
    p2 = _save(fig, outdir, "error", fmt)
    plt.close(fig)
    return [p1, p2]


def plot_2d_solution(problem: Problem, params, outdir: str, fmt: str = "png"):
    """Contour plots of prediction, exact, and pointwise error over the dense
    test grid, with element grid lines (Poisson-2D.py:437-534)."""
    plt = _plt()
    ny, nx = problem.extras["test_grid_shape"]
    X = problem.test_points[:, 0].reshape(ny, nx)
    Y = problem.test_points[:, 1].reshape(ny, nx)
    u_true = problem.test_values.reshape(ny, nx)
    u_pred = predict(problem, params).reshape(ny, nx)
    mesh = problem.extras["mesh"]

    paths = []
    for name, Z in (
        ("prediction", u_pred),
        ("exact", u_true),
        ("pointwise_error", np.abs(u_true - u_pred)),
    ):
        fig, ax = plt.subplots(figsize=(8, 6.5))
        cs = ax.contourf(X, Y, Z, levels=100, cmap="jet")
        fig.colorbar(cs)
        for xc in mesh.axis_x.grid:
            ax.axvline(x=xc, linewidth=1, ls="--", color="w")
        for yc in mesh.axis_y.grid:
            ax.axhline(y=yc, linewidth=1, ls="--", color="w")
        ax.set_xlabel("$x$")
        ax.set_ylabel("$y$")
        ax.set_title(name.replace("_", " "))
        paths.append(_save(fig, outdir, name, fmt))
        plt.close(fig)
    return paths


def plot_vector_solution(problem: Problem, params, outdir: str, fmt: str = "png"):
    """Per-component contour triptych (prediction / exact / error) for
    2D PDE SYSTEMS — the multi-component generalization of
    plot_2d_solution (Poisson-2D.py:437-534 convention), one row per
    component of e.g. the Navier-Stokes (u, v, p) triple."""
    plt = _plt()
    ny, nx = problem.extras["test_grid_shape"]
    names = problem.extras["component_names"]
    c = len(names)
    X = problem.test_points[:, 0].reshape(ny, nx)
    Y = problem.test_points[:, 1].reshape(ny, nx)
    w_true = np.asarray(problem.test_values).reshape(ny, nx, c)
    w_pred = predict(problem, params).reshape(ny, nx, c)
    mesh = problem.extras["mesh"]

    fig, axes = plt.subplots(c, 3, figsize=(16, 4.6 * c))
    for i, comp in enumerate(names):
        for j, (title, Z) in enumerate((
            (f"${comp}$ prediction", w_pred[..., i]),
            (f"${comp}$ exact", w_true[..., i]),
            (f"${comp}$ pointwise error", np.abs(w_true[..., i] - w_pred[..., i])),
        )):
            ax = axes[i, j] if c > 1 else axes[j]
            cs = ax.contourf(X, Y, Z, levels=100, cmap="jet")
            fig.colorbar(cs, ax=ax)
            for xc in mesh.axis_x.grid:
                ax.axvline(x=xc, linewidth=0.8, ls="--", color="w")
            for yc in mesh.axis_y.grid:
                ax.axhline(y=yc, linewidth=0.8, ls="--", color="w")
            ax.set_title(title)
            ax.set_xlabel("$x$")
            ax.set_ylabel("$y$")
    path = _save(fig, outdir, "fields", fmt)
    plt.close(fig)
    return path


def plot_vector_slices(problem: Problem, params, outdir: str, times=(0.0, 0.5, 1.0), fmt: str = "png"):
    """Fixed-t contour slices of an unsteady SYSTEM's components with
    L-inf error annotation — the vector twin of plot_3d_slices /
    plot_advdiff_slices (AdvDiff.py:660-696 convention).  One row per
    component, one column per requested time."""
    plt = _plt()
    nt, ny, nx = problem.extras["test_grid_shape"]
    names = problem.extras["component_names"]
    c = len(names)
    pts = problem.test_points
    X = pts[:, 0].reshape(nt, ny, nx)
    Y = pts[:, 1].reshape(nt, ny, nx)
    T = pts[:, 2].reshape(nt, ny, nx)
    w_true = np.asarray(problem.test_values).reshape(nt, ny, nx, c)
    w_pred = predict(problem, params).reshape(nt, ny, nx, c)
    tvals = T[:, 0, 0]

    fig, axes = plt.subplots(c, len(times), figsize=(4.8 * len(times), 4.2 * c))
    axes = np.atleast_2d(axes)
    for i, comp in enumerate(names):
        for j, t in enumerate(times):
            k = int(np.argmin(np.abs(tvals - t)))
            linf = np.max(np.abs(w_true[k, ..., i] - w_pred[k, ..., i]))
            ax = axes[i, j]
            cs = ax.contourf(X[k], Y[k], w_pred[k, ..., i], levels=60, cmap="jet")
            fig.colorbar(cs, ax=ax)
            ax.set_title(f"${comp}$  t = {tvals[k]:.2f},  $L_\\infty$ = {linf:.1e}")
            ax.set_xlabel("$x$")
            ax.set_ylabel("$y$")
    path = _save(fig, outdir, "component_slices", fmt)
    plt.close(fig)
    return path


def plot_coefficient_history(
    result: TrainResult, key: str, true_value: float, outdir: str,
    label: str | None = None, fmt: str = "pdf",
):
    """Recovered-coefficient trajectory vs truth for ANY scalar aux key
    (the generic form of plot_epsilon_history; e.g. the Navier-Stokes
    trainable viscosity `nu`)."""
    plt = _plt()
    label = label or key
    fig, ax = plt.subplots(figsize=(11, 5.5))
    ax.plot(result.history["iteration"], result.history[key], "b",
            label=f"estimated ${label}$")
    ax.axhline(true_value, color="r", ls="--", label=f"true ${label}$")
    ax.set_xlabel("iteration")
    ax.set_ylabel(f"${label}$")
    ax.legend()
    path = _save(fig, outdir, f"{key}_convergence", fmt)
    plt.close(fig)
    return path


def plot_advdiff_slices(problem: Problem, params, outdir: str, times=(0.25, 0.5, 0.75, 1.0), fmt: str = "pdf"):
    """Per-time solution slices with L-inf error annotation
    (AdvDiff.py:660-696)."""
    plt = _plt()
    ny, nx = problem.extras["test_grid_shape"]
    X = problem.test_points[:, 0].reshape(ny, nx)
    T = problem.test_points[:, 1].reshape(ny, nx)
    u_true = problem.test_values.reshape(ny, nx)
    u_pred = predict(problem, params).reshape(ny, nx)
    tvals = T[:, 0]

    fig, axes = plt.subplots(1, len(times), figsize=(4.5 * len(times), 4), sharey=True)
    for ax, t in zip(np.atleast_1d(axes), times):
        j = int(np.argmin(np.abs(tvals - t)))
        linf = np.max(np.abs(u_true[j] - u_pred[j]))
        ax.plot(X[j], u_true[j], "r-", label="exact")
        ax.plot(X[j][::8], u_pred[j][::8], "k*", label="VPINN")
        ax.set_title(f"t = {tvals[j]:.2f},  $L_\\infty$ = {linf:.2e}")
        ax.set_xlabel("$x$")
    np.atleast_1d(axes)[0].set_ylabel("$u$")
    np.atleast_1d(axes)[0].legend()
    path = _save(fig, outdir, "time_slices", fmt)
    plt.close(fig)
    return path


def plot_epsilon_history(result: TrainResult, eps_true: float, outdir: str, fmt: str = "pdf"):
    """Recovered-coefficient trajectory vs truth (AdvDiff.py:539-551)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(11, 5.5))
    ax.plot(result.history["iteration"], result.history["epsilon"], "b", label="estimated $\\epsilon$")
    ax.axhline(eps_true, color="r", ls="--", label="true $\\epsilon$")
    ax.set_xlabel("iteration")
    ax.set_ylabel("$\\epsilon$")
    ax.legend()
    path = _save(fig, outdir, "epsilon_convergence", fmt)
    plt.close(fig)
    return path


def plot_velocity_history(result: TrainResult, v_true: float, outdir: str, fmt: str = "pdf"):
    """Recovered advection-velocity trajectory vs truth (joint eps + V
    identification — beyond the reference)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(11, 5.5))
    ax.plot(result.history["iteration"], result.history["velocity"], "b", label="estimated $V$")
    ax.axhline(v_true, color="r", ls="--", label="true $V$")
    ax.set_xlabel("iteration")
    ax.set_ylabel("$V$")
    ax.legend()
    path = _save(fig, outdir, "velocity_convergence", fmt)
    plt.close(fig)
    return path


def plot_coefficient_field(
    problem: Problem, params, outdir: str, fmt: str = "pdf", fit_eps_fn=None
):
    """Recovered vs true coefficient PROFILES over x for space-dependent
    inverse models (eps(x) quadratic/neural field, V(x) polynomial field —
    both beyond the reference, whose coefficient is a single scalar
    AdvDiff.py:63).  One panel per field leaf present in params['pde'].
    `fit_eps_fn` overlays a two-phase direct linear fit
    (inverse.fit_epsilon_field) on the eps panel."""
    plt = _plt()
    cfg = problem.config
    xs = np.linspace(*cfg.domain_x, 512)[:, None]
    panels = []
    if "eps_coef" in params["pde"] or "eps_net" in params["pde"]:
        with torch.no_grad():
            eps_hat = _host(problem.extras["eps_of"](params, _on_problem(problem, xs))).reshape(-1)
        efn = problem.extras.get("epsilon_fn")
        eps_true = (
            np.asarray(efn(xs)).reshape(-1)
            if efn is not None
            else np.full(xs.shape[0], problem.extras["eps_true"])
        )
        panels.append(("$\\epsilon(x)$", eps_hat, eps_true))
    if "vel_coef" in params["pde"]:
        with torch.no_grad():
            v_hat = _host(problem.extras["v_of"](params, _on_problem(problem, xs))).reshape(-1)
        vfn = problem.extras.get("velocity_fn")
        v_true = (
            np.asarray(vfn(xs)).reshape(-1)
            if vfn is not None
            else np.full(xs.shape[0], problem.extras["velocity_true"])
        )
        panels.append(("$V(x)$", v_hat, v_true))
    if not panels:
        return None
    fig, axes = plt.subplots(1, len(panels), figsize=(6.5 * len(panels), 5.0), squeeze=False)
    for ax, (label, hat, true) in zip(axes[0], panels):
        ax.plot(xs.reshape(-1), hat, "b", label=f"recovered {label}")
        ax.plot(xs.reshape(-1), true, "r--", label=f"true {label}")
        if fit_eps_fn is not None and label.startswith("$\\epsilon"):
            fit = np.asarray(fit_eps_fn(xs)).reshape(-1)
            ax.plot(xs.reshape(-1), fit, "g-.", label="two-phase linear fit")
        ax.set_xlabel("$x$")
        ax.set_ylabel(label)
        ax.legend()
    path = _save(fig, outdir, "coefficient_fields", fmt)
    plt.close(fig)
    return path


def plot_training_points(problem: Problem, outdir: str, fmt: str = "pdf"):
    """Quadrature / boundary-training point maps (Poisson-1D.py:342-381,
    Poisson-2D 2D scatter equivalents)."""
    plt = _plt()
    xb = _host(problem.data["xb"])
    el = problem.data["elements"]
    fig, ax = plt.subplots(figsize=(8, 5))
    if xb.shape[1] == 1:
        xq = _host(el.x).reshape(-1)
        ax.scatter(xq, np.ones_like(xq), color="green", s=8, label="quadrature")
        ax.scatter(xb[:, 0], np.full(len(xb), 1.1), color="blue", label="training")
        ax.set_yticks([])
    else:
        xq = _host(el.x).reshape(-1)
        yq = _host(el.y).reshape(-1)
        ax.scatter(xq, yq, color="green", s=4, label="quadrature")
        ax.scatter(xb[:, 0], xb[:, 1], color="blue", s=8, label="boundary/data")
        ax.set_ylabel("$y$")
    ax.set_xlabel("$x$")
    ax.legend()
    path = _save(fig, outdir, "train_quad_points", fmt)
    plt.close(fig)
    return path


def plot_per_element_error(problem: Problem, params, outdir: str, fmt: str = "png"):
    """Per-element rel-L2 error map over the hp-decomposition — the working,
    every-dimension version of the reference's intended subdomain errors
    (dead predict_subdomain, Poisson-1D.py:185-195).

    1D: bar chart per element; 2D: Ex x Ey heatmap; 3D: one heatmap per
    z-layer.  Values annotated in scientific notation."""
    plt = _plt()
    errs = np.asarray(per_element_rel_l2(problem, params))
    mesh = problem.extras["mesh"]

    def _annotate(ax, grid):  # grid: [nx, ny] imshow-oriented values
        for (i, j), v in np.ndenumerate(grid):
            ax.text(j, i, f"{v:.1e}", ha="center", va="center", fontsize=7, color="w")

    if not hasattr(mesh, "shape"):  # Interval1D
        fig, ax = plt.subplots(figsize=(8, 4))
        ax.bar(np.arange(len(errs)), errs)
        ax.set_yscale("log")
        ax.set_xlabel("element")
        ax.set_ylabel("relative $L_2$ error")
    elif len(mesh.shape) == 2:
        Ex, Ey = mesh.shape
        grid = errs.reshape(Ex, Ey).T  # rows = y (imshow origin lower)
        fig, ax = plt.subplots(figsize=(1.1 * Ex + 2.5, 1.1 * Ey + 2))
        im = ax.imshow(grid, origin="lower", cmap="viridis")
        fig.colorbar(im)
        _annotate(ax, grid)
        ax.set_xlabel("element index (x)")
        ax.set_ylabel("element index (y)")
    else:
        Ex, Ey, Ez = mesh.shape
        cube = errs.reshape(Ex, Ey, Ez)
        fig, axes = plt.subplots(1, Ez, figsize=(1.1 * Ex * Ez + 3, 1.1 * Ey + 2))
        for ez, ax in enumerate(np.atleast_1d(axes)):
            grid = cube[:, :, ez].T
            im = ax.imshow(grid, origin="lower", cmap="viridis")
            _annotate(ax, grid)
            ax.set_title(f"z-layer {ez}")
            ax.set_xlabel("element index (x)")
        np.atleast_1d(axes)[0].set_ylabel("element index (y)")
        fig.colorbar(im, ax=list(np.atleast_1d(axes)))
    ax0 = fig.axes[0]
    ax0.set_title("per-element relative $L_2$ error")
    path = _save(fig, outdir, "per_element_error", fmt)
    plt.close(fig)
    return path


def standard_report(
    problem: Problem, result: TrainResult, outdir: str, fit_eps_fn=None
) -> list:
    """The full per-problem artifact set, dispatched on problem name.
    `fit_eps_fn` overlays a two-phase linear coefficient fit on the
    eps(x) panel (cli --fit-epsilon-field)."""
    paths = [plot_loss_history(result, outdir), plot_training_points(problem, outdir)]
    params = result.eval_params
    if problem.name == "poisson1d":
        paths += plot_1d_solution(problem, params, outdir)
    elif problem.name == "poisson2d":
        paths += plot_2d_solution(problem, params, outdir)
    elif problem.name == "poisson3d":
        paths += plot_3d_slices(problem, params, outdir)
    elif problem.name == "advdiff":
        paths += plot_2d_solution(problem, params, outdir)
        paths.append(plot_advdiff_slices(problem, params, outdir))
        if "epsilon" in result.history:
            paths.append(plot_epsilon_history(result, problem.extras["eps_true"], outdir))
        if "velocity" in result.history:
            paths.append(plot_velocity_history(result, problem.extras["velocity_true"], outdir))
        field_plot = plot_coefficient_field(
            problem, params, outdir, fit_eps_fn=fit_eps_fn
        )
        if field_plot is not None:
            paths.append(field_plot)
    elif problem.name == "helmholtz2d":
        paths += plot_2d_solution(problem, params, outdir)
    elif problem.name == "advdiff2d":
        paths += plot_3d_slices(problem, params, outdir)  # fixed-t contours
        if "epsilon" in result.history:
            paths.append(plot_epsilon_history(result, problem.extras["eps_true"], outdir))
    elif problem.name == "burgers":
        paths += plot_2d_solution(problem, params, outdir)
        paths.append(plot_advdiff_slices(problem, params, outdir))
    elif problem.name == "kovasznay":
        paths.append(plot_vector_solution(problem, params, outdir))
        if "nu" in result.history:
            paths.append(plot_coefficient_history(
                result, "nu", problem.extras["nu_true"], outdir, label="\\nu"
            ))
    elif problem.name == "taylorgreen":
        paths.append(plot_vector_slices(problem, params, outdir))
        if "nu" in result.history:
            paths.append(plot_coefficient_history(
                result, "nu", problem.extras["nu_true"], outdir, label="\\nu"
            ))
    paths.append(plot_per_element_error(problem, params, outdir))
    return paths


def plot_3d_slices(problem: Problem, params, outdir: str, z_values=None, fmt: str = "png"):
    """Contour slices of the 3D prediction and pointwise error at fixed z
    (defaults: the domain_z quartiles, so slices stay inside the domain)."""
    plt = _plt()
    if z_values is None:
        # space-time families (advdiff2d): the slowest axis is time
        zl, zu = getattr(
            problem.config, "domain_z", (0.0, getattr(problem.config, "t_final", 1.0))
        )
        z_values = tuple(zl + f * (zu - zl) for f in (0.25, 0.5, 0.75))
    nx = 81
    xs = np.linspace(*problem.config.domain_x, nx)
    ys = np.linspace(*problem.config.domain_y, nx)
    XG, YG = np.meshgrid(xs, ys)
    paths = []
    fig, axes = plt.subplots(2, len(z_values), figsize=(4.6 * len(z_values), 8))
    for j, zv in enumerate(z_values):
        pts = np.stack([XG.reshape(-1), YG.reshape(-1), np.full(XG.size, zv)], axis=-1)
        u_pred = predict(problem, params, pts).reshape(nx, nx)
        u_true = np.asarray(
            problem.exact(pts[:, 0:1], pts[:, 1:2], pts[:, 2:3])
        ).reshape(nx, nx)
        cs = axes[0, j].contourf(XG, YG, u_pred, levels=60, cmap="jet")
        fig.colorbar(cs, ax=axes[0, j])
        axes[0, j].set_title(f"prediction, z = {zv:.2f}")
        cs = axes[1, j].contourf(XG, YG, np.abs(u_true - u_pred), levels=60, cmap="jet")
        fig.colorbar(cs, ax=axes[1, j])
        axes[1, j].set_title(f"|error|, z = {zv:.2f}")
        for ax in (axes[0, j], axes[1, j]):
            ax.set_xlabel("$x$")
            ax.set_ylabel("$y$")
    path = _save(fig, outdir, "z_slices", fmt)
    plt.close(fig)
    paths.append(path)
    return paths


def plot_identified_map2d(
    eps_fn, outdir: str, eps_true_fn=None,
    domain_x=(-1.0, 1.0), domain_y=(-1.0, 1.0), fmt: str = "pdf",
):
    """Recovered eps(x, y) map — and, when the truth is known, the truth and
    the pointwise |error| — as contour panels (the 2D-map twin of
    plot_identified_field; contour-plot parity convention Poisson-2D.py:
    437-534).  Used by cli `identify advdiff2d --plots`."""
    plt = _plt()
    xs = np.linspace(*domain_x, 201)
    ys = np.linspace(*domain_y, 201)
    XG, YG = np.meshgrid(xs, ys, indexing="ij")
    EH = np.asarray(eps_fn(XG, YG)).reshape(XG.shape)
    n_panels = 3 if eps_true_fn is not None else 1
    fig, axes = plt.subplots(1, n_panels, figsize=(6 * n_panels, 5))
    axes = np.atleast_1d(axes)
    cs = axes[0].contourf(XG, YG, EH, levels=60, cmap="jet")
    fig.colorbar(cs, ax=axes[0])
    axes[0].set_title("identified $\\epsilon(x, y)$")
    if eps_true_fn is not None:
        ET = np.asarray(eps_true_fn(XG, YG)).reshape(XG.shape)
        cs = axes[1].contourf(XG, YG, ET, levels=60, cmap="jet")
        fig.colorbar(cs, ax=axes[1])
        axes[1].set_title("true $\\epsilon(x, y)$")
        cs = axes[2].contourf(XG, YG, np.abs(EH - ET), levels=60, cmap="jet")
        fig.colorbar(cs, ax=axes[2])
        rel = np.linalg.norm(EH - ET) / np.linalg.norm(ET)
        axes[2].set_title(f"$|\\epsilon - \\hat\\epsilon|$ (rel-L2 {rel:.2e})")
    for ax in axes:
        ax.set_xlabel("$x$")
        ax.set_ylabel("$y$")
    path = _save(fig, outdir, "identified_map2d", fmt)
    plt.close(fig)
    return path


def plot_identified_field(eps_fn, outdir: str, eps_true_fn=None, domain=(-1.0, 1.0), fmt: str = "pdf"):
    """Recovered eps(x) (and the truth, when known) for the network-free
    identification routes (cli `identify --plots`)."""
    plt = _plt()
    xs = np.linspace(*domain, 512)
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot(xs, np.asarray(eps_fn(xs)).reshape(-1), "b", label="identified $\\epsilon(x)$")
    if eps_true_fn is not None:
        ax.plot(xs, np.asarray(eps_true_fn(xs)).reshape(-1), "r--", label="true $\\epsilon(x)$")
    ax.set_xlabel("$x$")
    ax.set_ylabel("$\\epsilon$")
    ax.legend()
    path = _save(fig, outdir, "identified_field", fmt)
    plt.close(fig)
    return path


def plot_march(result, outdir: str, fmt: str = "png"):
    """Stitched space-time panels for a time-marching run
    (training/timemarch.py): predicted u(x, t), exact u, and pointwise
    |error| over the full horizon, with the slab interfaces drawn as
    vertical lines.  Each slab's stripe is evaluated by its OWN network on
    its own dense test grid (the same data the global rel-L2 uses).
    Contour-panel parity convention: AdvDiff.py:520-560's space-time plots.
    """
    plt = _plt()
    stripes_p, stripes_t, stripes_time = [], [], []
    nx = None
    for prob, params in zip(result.problems, result.params):
        X = np.asarray(prob.test_points)
        ts = np.unique(X[:, 1])
        nx = X.shape[0] // len(ts)
        up = np.asarray(predict(prob, params)).reshape(len(ts), nx)
        ut = np.asarray(prob.test_values).reshape(len(ts), nx)
        if stripes_p:  # drop the duplicated interface row (owned by the
            up, ut, ts = up[1:], ut[1:], ts[1:]  # earlier slab)
        stripes_p.append(up)
        stripes_t.append(ut)
        stripes_time.append(ts)
    UP = np.vstack(stripes_p)
    UT = np.vstack(stripes_t)
    tt = np.concatenate(stripes_time)
    xs = np.linspace(
        result.problems[0].test_points[:, 0].min(),
        result.problems[0].test_points[:, 0].max(),
        nx,
    )
    fig, axes = plt.subplots(1, 3, figsize=(18, 5))
    for ax, Z, title in zip(
        axes,
        (UP, UT, np.abs(UP - UT)),
        ("marched $\\hat u(x, t)$", "exact $u(x, t)$", "$|\\hat u - u|$"),
    ):
        cs = ax.pcolormesh(tt, xs, Z.T, cmap="jet", shading="nearest")
        fig.colorbar(cs, ax=ax)
        for e in result.edges[1:-1]:
            ax.axvline(float(e), color="w", lw=0.8, ls="--")
        ax.set_xlabel("$t$")
        ax.set_ylabel("$x$")
        ax.set_title(title)
    path = _save(fig, outdir, "march", fmt)
    plt.close(fig)
    return [path]
