"""Results records — the reference's persistence behavior.

Counterpart of hpvpinns_tpu/utils/records.py, with the same functions,
arguments and record keys.  AdvDiff dumps a .mat record of test grids,
predictions, loss/epsilon history and train time via scipy.io.savemat
(AdvDiff.py:500-508).  `save_record` reproduces that artifact (always a
compressed ``.npz``, and ``.mat`` when scipy is present) for any problem, and
`load_record` reads either back.  The parameter leaves (``param_leaf_i``)
are numbered in the JAX package's tree-leaf order (`problems.base.parameters`),
so a record written by either package restores in the other.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from hpvpinns_tpu_torch.evaluate import predict
from hpvpinns_tpu_torch.problems.base import Problem, map_params, parameters
from hpvpinns_tpu_torch.training.trainer import TrainResult


def build_record(problem: Problem, result: TrainResult,
                 include_params: bool = False) -> dict:
    rec = {
        "x_test": problem.test_points,
        "u_test": problem.test_values,
        "u_pred": predict(problem, result.eval_params),
        "total_time_train": np.asarray(result.wall_time_s),
        "iterations": result.history["iteration"],
    }
    for key, val in result.history.items():
        if key != "iteration":
            rec[f"history_{key}"] = val
    if include_params:
        # flattened parameter leaves so the trained network itself is
        # restorable from the record (the reference's .mat keeps only
        # predictions, AdvDiff.py:500-508 — a record without the weights
        # cannot seed a polish/serving step; see params_from_record)
        for i, leaf in enumerate(parameters(result.eval_params)):
            rec[f"param_leaf_{i}"] = leaf.detach().cpu().numpy()
    mesh = problem.extras.get("mesh")
    if mesh is not None:
        if hasattr(mesh, "axis_x"):  # tensor-product mesh
            rec["grid_x"] = mesh.axis_x.grid
            rec["grid_y"] = mesh.axis_y.grid
            if hasattr(mesh, "axis_z"):
                rec["grid_z"] = mesh.axis_z.grid
        else:
            rec["grid"] = mesh.grid
    return rec


def save_record(problem: Problem, result: TrainResult, path: str,
                include_params: bool = False) -> list:
    """Write <path>.npz (always) and <path>.mat (if scipy is available).

    Returns the list of files written.  ``include_params=True`` adds the
    flattened parameter leaves (``param_leaf_i``) so the record can seed
    :func:`params_from_record`.
    """
    rec = build_record(problem, result, include_params=include_params)
    base, ext = os.path.splitext(path)
    if ext in (".mat", ".npz"):
        path = base
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    written = []
    np.savez_compressed(path + ".npz", **rec)
    written.append(path + ".npz")
    try:
        import scipy.io

        scipy.io.savemat(path + ".mat", rec)
        written.append(path + ".mat")
    except ImportError:
        pass
    return written


def params_from_record(problem: Problem, record: dict):
    """Rebuild the trained parameter tree from a record written with
    ``include_params=True``: `nn.Parameter` leaves on the problem's device
    and in its dtype, shaped as the problem's own (a ``.mat`` file stores a
    vector as a matrix).  The leaf order is the problem's flatten order, so
    the record is portable across processes and packages but tied to the
    config that built the problem."""
    keys = sorted(
        (k for k in record if k.startswith("param_leaf_")),
        key=lambda k: int(k.rsplit("_", 1)[1]),
    )
    if not keys:
        raise ValueError(
            "record has no param_leaf_* entries "
            "(written without include_params=True)"
        )
    template = problem.init_params(torch.Generator().manual_seed(0))
    leaves = parameters(template)
    if len(keys) != len(leaves):
        raise ValueError(
            f"record has {len(keys)} param leaves, problem expects "
            f"{len(leaves)} — config mismatch"
        )
    new = {
        id(leaf): nn.Parameter(
            torch.as_tensor(np.asarray(record[k])).reshape(leaf.shape).to(device=leaf.device, dtype=leaf.dtype))
        for k, leaf in zip(keys, leaves)
    }
    return map_params(lambda t: new[id(t)], template)


def load_record(path: str) -> dict:
    if path.endswith(".mat"):
        import scipy.io

        return scipy.io.loadmat(path)
    with np.load(path) as data:
        return dict(data)
