"""Deployment/serving tier: model artifacts via `torch.export`.

Counterpart of hpvpinns_tpu/serving.py, with the same names and the same
`meta.json`.  The reference has NO deployment story — its trained networks
die with the TF1 session process (Poisson-1D.py:201-224 trains and plots in
one script; no saver, no export).  Here a trained ansatz (plain MLP,
composite hard-BC lift, input-feature network, the Navier-Stokes triple) is
traced ONCE into a `torch.export` program with a *symbolic batch
dimension*, so it can be

- saved/loaded without any model-building Python (the program carries the
  weights as its parameters and the full ansatz computation as ATen ops),
- called at any batch size without retracing,
- served on the card or on the CPU: the stored program is host-resident
  and `load_model` moves it to the device asked for
  (`torch.export.passes.move_to_device_pass`).

Artifact layout (a directory):
    model.pt2   -- torch.export.save of the program
    meta.json   -- problem name, full config (reconstructible), i/o
                   signature, dtype, platforms, param count, torch version

`meta.json` makes the artifact self-describing: `load_model` returns a
`ServedModel` whose `.predict(X)` is the ansatz, and `rebuild_problem`
reconstructs the exact `Problem` (grid, quadrature, exact solution) for
validation — the CLI's `serve --check` compares the served artifact
against the rebuilt problem's exact solution on its dense test grid.

This module imports only torch, numpy and json when it loads and when it
serves; `rebuild_problem` and `config_from_meta` alone import the package.
A network trained at matmul_precision "high"/"default" (TF32 on the card,
models/mlp.py; the config in meta.json says which) is served with TF32 on
around the program's call: the flag is not part of a traced program.

Exporting from a saved checkpoint (no retraining) is a library one-liner on
top of this module:

    from hpvpinns_tpu_torch.training.checkpoint import Checkpointer
    step, tree = Checkpointer(ckpt_dir).restore()
    tv.save_model(out_dir, problem, tree["params"])
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.export.passes import move_to_device_pass

_FORMAT_VERSION = 1
_MODEL_FILE = "model.pt2"
_META_FILE = "meta.json"


def _compute_dtype(params) -> torch.dtype:
    """The ansatz compute dtype = the network weights' dtype."""
    return params["net"][0]["W"].dtype


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


class _Ansatz(nn.Module):
    """problem.apply with detached copies of the leaves as this module's
    parameters, so that they travel in the program's state."""

    def __init__(self, problem, params):
        from hpvpinns_tpu_torch.problems.base import map_params, parameters

        super().__init__()
        self.problem = problem
        leaves = parameters(params)
        self.leaves = nn.ParameterList([nn.Parameter(t.detach().clone(), requires_grad=False) for t in leaves])
        index = {id(t): i for i, t in enumerate(leaves)}
        self._tree = lambda: map_params(lambda t: self.leaves[index[id(t)]], params)

    def forward(self, X):
        return self.problem.apply(self._tree(), X)


def export_model(problem, params, *, platforms: Tuple[str, ...] = ("cpu", "cuda")):
    """Trace the trained ansatz into a `torch.export.ExportedProgram` with a
    symbolic batch axis, stored on the host.

    The parameters are the program's own state — the artifact is
    self-contained.  Works for every ansatz the framework builds (plain
    MLP, hard-BC composite lift+envelope, feature-augmented inputs): the
    export traces `problem.apply(params, X)` itself, on the device of the
    parameters; the program is then moved to the CPU.  `platforms` is
    kept for JAX's signature: `save_model` writes it into the metadata,
    and every platform keeps float64 (the H100 runs it)."""
    del platforms
    leaf = params["net"][0]["W"]
    d_in = int(problem.test_points.shape[1])
    x = torch.as_tensor(np.asarray(problem.test_points[:2])).to(device=leaf.device, dtype=leaf.dtype)
    batch = torch.export.Dim("b", min=1)
    program = torch.export.export(_Ansatz(problem, params), (x.reshape(-1, d_in),),
                                  dynamic_shapes=({0: batch},), strict=False)
    return move_to_device_pass(program, "cpu")


def save_model(
    path: str,
    problem,
    params,
    *,
    platforms: Tuple[str, ...] = ("cpu", "cuda"),
    extra_meta: Optional[dict] = None,
) -> dict:
    """Export + write the artifact directory; returns the metadata dict."""
    from hpvpinns_tpu_torch.problems.base import parameters

    exported = export_model(problem, params, platforms=platforms)
    os.makedirs(path, exist_ok=True)
    torch.export.save(exported, os.path.join(path, _MODEL_FILE))

    leaf = params["net"][0]["W"]
    with torch.no_grad():
        probe = problem.apply(params, torch.as_tensor(np.asarray(problem.test_points[:1])).to(
            device=leaf.device, dtype=leaf.dtype))
    meta = {
        "format_version": _FORMAT_VERSION,
        "problem": problem.name,
        "config_class": type(problem.config).__name__,
        "config": dataclasses.asdict(problem.config),
        "d_in": int(problem.test_points.shape[1]),
        "n_out": int(probe.shape[-1]),
        "dtype": _dtype_name(_compute_dtype(params)),
        "platforms": list(platforms),
        "n_params": sum(int(t.numel()) for t in parameters(params)),
        "torch_version": torch.__version__,
    }
    if extra_meta:
        meta.update(extra_meta)
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump(meta, f, indent=1, default=str)
    return meta


@contextlib.contextmanager
def _matmul_precision(precision: str, device: torch.device):
    """TF32 on around the call for a "high"/"default" network on the card
    (models/mlp.py's rule, restated: serving imports no package code)."""
    if precision == "highest" or device.type != "cuda":
        yield
        return
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


@dataclass
class ServedModel:
    """A loaded artifact: `.predict(X)` is the ansatz, batch-size agnostic,
    on `device`."""

    exported: Any
    meta: dict
    path: str
    device: torch.device = torch.device("cpu")

    def __post_init__(self):
        self._fn = self.exported.module()

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X)
        if X.ndim != 2 or X.shape[1] != self.meta["d_in"]:
            raise ValueError(
                f"expected points of shape [n, {self.meta['d_in']}], got {X.shape}"
            )
        if self.device.type not in self.meta["platforms"]:
            raise ValueError(
                f"artifact is tagged for platforms {self.meta['platforms']}; "
                f"it was loaded on {self.device.type!r}"
            )
        x = torch.as_tensor(X).to(device=self.device, dtype=getattr(torch, self.meta["dtype"]))
        precision = self.meta["config"].get("matmul_precision", "highest")
        with torch.no_grad(), _matmul_precision(precision, self.device):
            y = self._fn(x)
        return (y.float() if y.dtype == torch.bfloat16 else y).cpu().numpy()

    def rebuild_problem(self):
        """Reconstruct the exact `Problem` this artifact was trained on
        (grid, quadrature, exact solution) from the stored config, on the
        device the artifact was loaded on."""
        from hpvpinns_tpu_torch.problems import build

        if self.meta.get("manufactured"):
            raise ValueError(
                "artifact was trained on a --manufactured-* problem whose "
                "u_fn/f_fn are not stored in the config; rebuild_problem "
                "would compare against the WRONG truth.  predict() remains "
                "fully usable (the artifact is self-contained)."
            )
        return build(config_from_meta(self.meta), device=self.device)


def load_model(path: str, device=None) -> ServedModel:
    """Load an artifact directory onto `device`: the card unless it is
    asked for another (e.g. "cpu"); with no CUDA device and no `device`
    it raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: artifacts are served on the GPU by default; "
                "pass device='cpu' to serve on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    with open(os.path.join(path, _META_FILE)) as f:
        meta = json.load(f)
    if meta.get("format_version", 0) > _FORMAT_VERSION:
        raise ValueError(
            f"artifact format {meta['format_version']} is newer than this "
            f"library ({_FORMAT_VERSION})"
        )
    exported = torch.export.load(os.path.join(path, _MODEL_FILE))
    if device.type != "cpu":
        exported = move_to_device_pass(exported, str(device))
    return ServedModel(exported=exported, meta=meta, path=path, device=device)


def config_from_meta(meta: dict):
    """Rebuild the frozen config dataclass from the JSON round trip
    (lists back to the tuples the dataclasses declare; nested TrainConfig)."""
    from hpvpinns_tpu_torch import config as cfgmod

    cls = getattr(cfgmod, meta["config_class"])

    def detuple(v):
        if isinstance(v, list):
            return tuple(detuple(x) for x in v)
        return v

    d = {k: detuple(v) for k, v in dict(meta["config"]).items()}
    if isinstance(d.get("train"), dict):
        d["train"] = cfgmod.TrainConfig(**{k: detuple(v) for k, v in d["train"].items()})
    return cls(**d)
