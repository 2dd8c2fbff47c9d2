"""The per-rank side of the port's multi-process tests.

tests/test_torch_sharding.py, tests/test_torch_parallel.py and
tests/test_torch_gauss_newton_point_mesh.py (suites "sharding", "parallel"
and "gn_points") each spawn one gloo world on the CPU
(hpvpinns_tpu_torch.parallel.multihost_check.spawn):

    python tests/torch_mesh_cases.py SUITE PORT RANK N OUT DEVICE BACKEND

Every rank runs the SUITE's cases on its shard and writes their numbers to
OUT as JSON; the tests hold them against the unsharded references they
compute themselves (the JAX package's and the port's).  This module imports
torch, numpy and the port only.  The configurations are the JAX tests'
(tests/test_sharding.py).
"""

import importlib
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import hpvpinns_tpu_torch as tv  # noqa: E402
from hpvpinns_tpu_torch.parallel import distributed  # noqa: E402
from hpvpinns_tpu_torch.parallel.multihost_check import jax_modules  # noqa: E402
from hpvpinns_tpu_torch.parallel.sharding import (  # noqa: E402
    AXIS,
    allreduce_grads,
    element_mesh,
    element_point_mesh,
    once,
    psum,
    shard_problem,
)
from hpvpinns_tpu_torch.problems.base import parameters  # noqa: E402

F64 = torch.float64
gn_module = importlib.import_module("hpvpinns_tpu_torch.training.gauss_newton")


def p2d_config(**kw):
    """tests/test_sharding.py's fixture: E 12 (4 x 3), n_quad 6, 4 x 4 tests."""
    return tv.Poisson2DConfig(**{**dict(dtype="float64", n_elements_x=4, n_elements_y=3, n_quad=6, n_test_x=4,
                                        n_test_y=4), **kw})


def p1d_config(**kw):
    """E 3, Q 10, 5 tests (tests/test_sharding.py:121-134)."""
    return tv.Poisson1DConfig(**{**dict(dtype="float64", n_elements=3, n_quad=10, n_test=5), **kw})


# The space-time families of tests/test_sharding.py:164-201 (E 6 each), and
# Poisson-3D and Kovasznay, tiny.
FAMILIES = {
    "burgers": ("BurgersConfig", dict(n_elements_x=3, n_elements_t=2, n_quad=5, n_test_x=3, n_test_t=3,
                                      layers=(2, 6, 1))),
    "advdiff": ("AdvDiffConfig", dict(n_elements_x=3, n_elements_t=2, n_quad=5, n_test_x=3, n_test_t=3,
                                      layers=(2, 6, 1), velocity_trainable=True)),
    "advdiff_linear": ("AdvDiffConfig", dict(n_elements_x=3, n_elements_t=2, n_quad=5, n_test_x=3, n_test_t=3,
                                             layers=(2, 6, 1), velocity_trainable=True, velocity_model="linear")),
    "advdiff_reg": ("AdvDiffConfig", dict(n_elements_x=3, n_elements_t=2, n_quad=5, n_test_x=3, n_test_t=3,
                                          layers=(2, 6, 1), epsilon_model="quadratic", epsilon_reg=0.1)),
    # eps a network: a quadratic eps starts flat, where the Tikhonov term and its gradient vanish
    "advdiff_reg_mlp": ("AdvDiffConfig", dict(n_elements_x=3, n_elements_t=2, n_quad=5, n_test_x=3, n_test_t=3,
                                              layers=(2, 6, 1), epsilon_model="mlp", epsilon_reg=0.1)),
    "advdiff2d": ("AdvDiff2DConfig", dict(n_elements_x=3, n_elements_y=2, n_elements_t=1, n_quad=4, n_test_x=3,
                                          n_test_y=3, n_test_t=3, layers=(3, 6, 1), velocity_trainable=True)),
    "helmholtz2d": ("Helmholtz2DConfig", dict(n_elements_x=3, n_elements_y=2, n_quad=5, n_test_x=3, n_test_y=3,
                                              layers=(2, 6, 1), inverse=True, n_sensors=6)),
    "poisson1d": ("Poisson1DConfig", dict(n_elements=3, n_quad=8, n_test=4, layers=(1, 6, 6, 1))),
    "poisson3d": ("Poisson3DConfig", dict(n_elements_x=3, n_elements_y=1, n_elements_z=1, n_quad=4, n_test_x=2,
                                          n_test_y=2, n_test_z=2, layers=(3, 6, 1))),
    "kovasznay": ("KovasznayConfig", dict(n_elements_x=3, layers=(2, 8, 3), n_quad=5, n_test_x=3, n_test_y=3,
                                          n_bound=5, n_sensors=6, inverse=True)),
}

# The element x point meshes: (label, config, mesh shape), padding on both
# axes where the label says so; the edge fluxes of var_form 3 and "2c"; and
# AdvDiff's Tikhonov term, a sum over the points outside the contractions,
# with Q 5 padded to 6.
POINT_CASES = {
    "p2d_2x2": (lambda: p2d_config(), (2, 2)),
    "p2d_2x2_padded_2c": (lambda: p2d_config(n_elements_x=3, n_quad=5, var_form="2c"), (2, 2)),
    "p1d_1x4": (lambda: p1d_config(), (1, 4)),
    "p1d_1x4_form3": (lambda: p1d_config(var_form=3), (1, 4)),
    "advdiff_reg_2x2_padded": (lambda: family_config("advdiff_reg_mlp"), (2, 2)),
}

TRAIN = dict(iterations=20, check_every=10)

# Gauss-Newton on the element x point mesh (2, 2) ("gn_points"): Poisson-2D
# with Q 5 padded to 6 and a network wider than a rank's 116 rows (P 205),
# so that the Jacobian is built in reverse mode; each solve's accepted steps.
GN_P2D = dict(n_quad=5, n_bound=5, layers=(2, 12, 12, 1))
GN_SOLVES = {"normal": 3, "host": 3, "qr": 3, "cg": 3, "lsqr": 3}
# P 25 <= M: the forward build; var_form "2c" (edge fluxes through `once`
# over the points) under "cg" (forward-mode products on every rank)
GN_FORWARD = dict(n_quad=5, n_bound=5, layers=(2, 6, 1))
GN_FLUX = dict(n_elements_x=3, n_quad=5, n_bound=5, layers=(2, 12, 12, 1), var_form="2c")
GN_TRAIN = dict(iterations=40, check_every=20, gn_iterations=3, gn_solve="cg")


def family_config(name):
    cls, kw = FAMILIES[name]
    return getattr(tv, cls)(**{**kw, "dtype": "float64"})


def shared_tree(prob, seed=0):
    """tests/test_torch_parity.py::shared_params: the port's init with its
    biases drawn too, as numpy arrays."""
    tree = tv.params_to_numpy(prob.init_params(torch.Generator().manual_seed(seed)))
    rng = np.random.default_rng(seed)
    for layer in tree["net"]:
        layer["b"] = layer["b"] + 0.1 * rng.standard_normal(layer["b"].shape)
    return tree


def flat(tensors):
    return torch.cat([t.detach().reshape(-1) for t in tensors]).double().tolist()


def loss_and_grads(prob, mesh=None, data=None):
    """The loss, aux and gradients (flat, in `parameters` order) at the
    shared params; on `mesh` this rank's shard, the shares summed."""
    params = tv.params_from_jax(shared_tree(prob), dtype=F64)
    if mesh is None:
        loss, aux = prob.loss_fn(params, prob.data if data is None else data)
        grads = torch.autograd.grad(loss, parameters(params), allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(parameters(params), grads)]
        return {"loss": float(loss), "aux": {k: float(v) for k, v in aux.items()}, "grads": flat(grads)}
    axis = mesh.axis(AXIS)
    loss, aux = prob.loss_fn(params, shard_problem(prob.data, mesh), axis_name=axis)
    loss.backward()
    allreduce_grads(parameters(params), axis)
    return {"loss": float(loss), "aux": {k: float(v) for k, v in aux.items()},
            "grads": flat([p.grad for p in parameters(params)])}


def build(cfg):
    return tv.build(cfg, device="cpu")


def train_losses(prob, mesh, cfg):
    res = tv.train(prob, cfg, mesh=mesh, params=tv.params_from_jax(shared_tree(prob), dtype=F64), verbose=False)
    return {"loss": res.history["loss"].tolist(), "final": res.final_aux["loss"], "chunk_mode": res.chunk_mode,
            "phases": sorted(res.phases)}


def psum_rule(mesh):
    """x.grad on every rank of y = psum(c_r x) + once(x^2), c_r = rank + 1:
    the shares, which sum to the global gradient sum_r c_r + 2x."""
    axis = mesh.axis(AXIS)
    x = torch.tensor(2.0, dtype=F64, requires_grad=True)
    y = psum((axis.index + 1.0) * x, axis) + once(x * x, axis)
    y.backward()
    share = float(x.grad)
    allreduce_grads([x], axis)
    return {"y": float(y), "share": share, "summed": float(x.grad)}


def suite_sharding(mesh):
    out = {"psum_rule": psum_rule(mesh)}
    out["p2d"] = loss_and_grads(build(p2d_config()), mesh)
    out["p1d_padded"] = loss_and_grads(build(p1d_config()), mesh)
    p2d = build(p2d_config())
    out["adam"] = train_losses(p2d, mesh, tv.TrainConfig(**TRAIN))
    out["train_gn"] = train_losses(p2d, mesh, tv.TrainConfig(iterations=40, check_every=20, gn_iterations=3,
                                                            gn_solve="cg"))
    params = tv.params_from_jax(shared_tree(p2d), dtype=F64)
    for solve, its in (("cg", 5), ("qr", 3), ("normal", 3), ("lsqr", 3)):
        gn = tv.gauss_newton(p2d, params, iterations=its, solve=solve, mesh=mesh, verbose=False)
        out[f"gn_{solve}"] = {"loss": gn.final_aux["loss"], "accepted": gn.accepted, "params": flat(parameters(gn.params))}
    # "qr" with the rows unweighted (no `own`), the arrangement before the
    # element x point mesh: on an element mesh its parameters are bit for bit
    # those of the weighted rows
    weights = gn_module._row_weights
    gn_module._row_weights = lambda *args: None
    try:
        gn = tv.gauss_newton(p2d, params, iterations=3, solve="qr", mesh=mesh, verbose=False)
    finally:
        gn_module._row_weights = weights
    out["gn_qr_unweighted"] = {"params": flat(parameters(gn.params))}
    reg = build(family_config("advdiff_reg"))
    gn = tv.gauss_newton(reg, tv.params_from_jax(shared_tree(reg), dtype=F64), iterations=2, solve="qr", mesh=mesh,
                         verbose=False)
    out["gn_advdiff_reg"] = {"loss": gn.final_aux["loss"], "accepted": gn.accepted}
    ens = tv.train_ensemble(p2d, tv.TrainConfig(**TRAIN), seeds=(0, 1, 2), verbose=False, mesh=mesh)
    out["ensemble"] = {"loss": np.asarray(ens.final_aux["loss"]).tolist()}
    return out


def gn_case(prob, mesh, solve, iterations):
    gn = tv.gauss_newton(prob, tv.params_from_jax(shared_tree(prob), dtype=F64), iterations=iterations, solve=solve,
                         mesh=mesh, verbose=False)
    return {"loss": gn.final_aux["loss"], "accepted": gn.accepted, "params": flat(parameters(gn.params))}


def suite_gn_points(_):
    mesh = element_point_mesh((2, 2), device="cpu")
    p2d = build(p2d_config(**GN_P2D))
    out = {f"gn_{solve}": gn_case(p2d, mesh, solve, its) for solve, its in GN_SOLVES.items()}
    out["gn_forward"] = gn_case(build(p2d_config(**GN_FORWARD)), mesh, "normal", 3)
    out["gn_flux_cg"] = gn_case(build(p2d_config(**GN_FLUX)), mesh, "cg", 2)
    for name in ("advdiff_reg", "advdiff_reg_mlp"):
        out[f"gn_{name}"] = gn_case(build(family_config(name)), mesh, "qr", 2)
    out["train_gn"] = train_losses(p2d, mesh, tv.TrainConfig(**GN_TRAIN))
    return out


def suite_parallel(mesh):
    out = {name: loss_and_grads(build(family_config(name)), mesh) for name in FAMILIES}
    for label, (cfg, shape) in POINT_CASES.items():
        out[label] = loss_and_grads(build(cfg()), element_point_mesh(shape, device="cpu"))
    out["p2d_2x2_adam"] = train_losses(build(p2d_config()), element_point_mesh((2, 2), device="cpu"),
                                       tv.TrainConfig(**TRAIN))
    return out


def main(argv):
    suite, port, rank, n, out_path = argv[:5]
    torch.set_num_threads(1)
    topo = distributed.initialize(coordinator_address=f"localhost:{port}", num_processes=int(n),
                                  process_id=int(rank), device="cpu")
    mesh = element_mesh(device="cpu")
    suites = {"sharding": suite_sharding, "parallel": suite_parallel, "gn_points": suite_gn_points}
    result = {"topology": topo, "mesh": mesh.shape, **suites[suite](mesh),
              "jax_modules": jax_modules()}
    with open(out_path, "w") as f:
        json.dump(result, f)
    distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])
