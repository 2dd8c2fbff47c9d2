"""Port parity, Gauss-Newton on an element x point mesh
(hpvpinns_tpu_torch/training/gauss_newton.py on parallel/sharding.py's
element_point_mesh), in float64 on the CPU.

One gloo world of four processes on the (2, 2) mesh (tests/torch_mesh_cases.py,
suite "gn_points") runs every case once; the tests here hold each rank's
numbers against the unsharded runs computed in this process: the port's,
and the JAX package's where it says so (never JAX on a mesh: its GN rows
for AdvDiff's Tikhonov term count the padded points).  The fixture is
Poisson-2D, E 12 (4 x 3), 4 x 4 tests, with Q 5 padded to 6 over the point
axis and a network (2, 12, 12, 1) whose 205 parameters exceed a rank's 116
rows, so that J is built in reverse mode and its element rows are summed
over the point group.  Tolerances are tests/test_torch_sharding.py's: the
loss to 1e-8 for the dense solves and 1e-5 for CG and LSQR, the parameters
to 1e-6 dense and rtol 1e-2 / atol 1e-4 for the Krylov iterates, the
trainer's GN phase to 1e-4.
"""

import concurrent.futures
import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import hpvpinns_tpu as jv  # noqa: E402
import hpvpinns_tpu_torch as tv  # noqa: E402
from hpvpinns_tpu_torch.parallel.multihost_check import spawn  # noqa: E402
from hpvpinns_tpu_torch.problems.base import parameters  # noqa: E402
from test_torch_parity import named_leaves, one_torch_thread, tnp, to_jax  # noqa: E402
from torch_mesh_cases import (  # noqa: E402
    GN_FLUX,
    GN_FORWARD,
    GN_P2D,
    GN_SOLVES,
    GN_TRAIN,
    family_config,
    p2d_config,
    shared_tree,
)

CASES = str(Path(__file__).resolve().parent / "torch_mesh_cases.py")
F64 = torch.float64
KRYLOV = ("cg", "lsqr")
CONFIGS = {"p2d": lambda: p2d_config(**GN_P2D), "forward": lambda: p2d_config(**GN_FORWARD),
           "flux": lambda: p2d_config(**GN_FLUX), "advdiff_reg": lambda: family_config("advdiff_reg"),
           "advdiff_reg_mlp": lambda: family_config("advdiff_reg_mlp")}


@functools.lru_cache(maxsize=None)
def port_problem(key):
    return tv.build(CONFIGS[key](), device="cpu")


@functools.lru_cache(maxsize=None)
def port_unsharded(key, solve, iterations):
    """The port's unsharded LM from the shared params: (loss, accepted, flat params)."""
    prob = port_problem(key)
    with one_torch_thread():
        gn = tv.gauss_newton(prob, tv.params_from_jax(shared_tree(prob), dtype=F64), iterations=iterations,
                             solve=solve, verbose=False)
    return gn.final_aux["loss"], gn.accepted, tnp(torch.cat([t.reshape(-1) for t in parameters(gn.params)]))


@functools.lru_cache(maxsize=None)
def jax_unsharded(key, solve, iterations):
    """The JAX package's unsharded LM from the same numpy params, its
    parameters flattened in the port's `parameters` order."""
    tcfg = CONFIGS[key]()
    cls = getattr(jv, type(tcfg).__name__)
    names = {f.name for f in dataclasses.fields(cls)} - {"train"}
    jprob = jv.build(cls(**{f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg) if f.name in names}))
    gn = jv.gauss_newton(jprob, to_jax(shared_tree(port_problem(key))), iterations=iterations, solve=solve,
                         verbose=False)
    flat = np.concatenate([np.ravel(np.asarray(leaf)) for _, leaf in named_leaves(gn.params)])
    return float(gn.final_aux["loss"]), gn.accepted, flat


@functools.lru_cache(maxsize=None)
def port_train():
    """The port's unsharded three-phase `train` (Adam, then GN "cg")."""
    prob = port_problem("p2d")
    with one_torch_thread():
        return tv.train(prob, tv.TrainConfig(**GN_TRAIN), params=tv.params_from_jax(shared_tree(prob), dtype=F64),
                        verbose=False)


# The unsharded runs the tests read: (source, config, solve, accepted steps)
REFERENCES = [("port", "p2d", solve, its) for solve, its in GN_SOLVES.items()] + [
    ("jax", "p2d", "normal", GN_SOLVES["normal"]), ("jax", "p2d", "cg", GN_SOLVES["cg"]),
    ("port", "forward", "normal", 3), ("port", "flux", "cg", 2),
    ("jax", "advdiff_reg", "qr", 2), ("jax", "advdiff_reg_mlp", "qr", 2)]


@pytest.fixture(scope="module")
def world():
    """The four ranks' results of the "gn_points" suite; the unsharded
    references are computed (and cached) while the ranks run."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, [sys.executable, CASES, "gn_points"], 4, timeout_s=300)
        for source, key, solve, its in REFERENCES:
            (port_unsharded if source == "port" else jax_unsharded)(key, solve, its)
        port_train()
        yield ranks.result()


def assert_matches(got, want, solve, iterations):
    loss, accepted, params = want
    rtol = 1e-5 if solve in KRYLOV else 1e-8
    ptol = dict(rtol=1e-2, atol=1e-4) if solve in KRYLOV else dict(rtol=1e-6, atol=1e-9)
    assert got["accepted"] == accepted == iterations
    np.testing.assert_allclose(got["loss"], loss, rtol=rtol)
    np.testing.assert_allclose(got["params"], params, **ptol)


@pytest.mark.parametrize("solve", sorted(GN_SOLVES))
def test_solves_on_the_point_mesh_match_unsharded(world, solve):
    """Each solve with the rows on the (2, 2) mesh, the points padded and J
    built in reverse mode (the element rows summed over the point group,
    each counted on the group's index 0): the port's unsharded LM."""
    want = port_unsharded("p2d", solve, GN_SOLVES[solve])
    for r in world:
        assert_matches(r[f"gn_{solve}"], want, solve, GN_SOLVES[solve])


@pytest.mark.parametrize("solve", ["normal", "cg"])
def test_solves_on_the_point_mesh_match_jax_unsharded(world, solve):
    """"normal" and "cg" on the (2, 2) mesh against the JAX package's
    unsharded gauss_newton from the same numpy parameters."""
    want = jax_unsharded("p2d", solve, GN_SOLVES[solve])
    for r in world:
        assert_matches(r[f"gn_{solve}"], want, solve, GN_SOLVES[solve])


def test_forward_build_on_the_point_mesh(world):
    """P 25 <= M: J by vmapped JVPs, whose tangents the contractions sum
    over the point group (one all-reduce a batch), under "normal"."""
    for r in world:
        assert_matches(r["gn_forward"], port_unsharded("forward", "normal", 3), "normal", 3)


def test_edge_fluxes_under_cg_on_the_point_mesh(world):
    """var_form "2c": the edge fluxes pass `once` over the point axis, whose
    tangent reaches every rank, so that J v and its VJP shares agree across
    a point group; "cg", two accepted steps, against the port unsharded."""
    for r in world:
        assert_matches(r["gn_flux_cg"], port_unsharded("flux", "cg", 2), "cg", 2)


@pytest.mark.parametrize("name", ["advdiff_reg", "advdiff_reg_mlp"])
def test_tikhonov_rows_on_padded_points_match_jax_unsharded(world, name):
    """AdvDiff's Tikhonov term, a row a quadrature point, on the (2, 2)
    mesh with Q 5 padded to 6 (eps quadratic, and a network): each rank's
    own rows, the padded columns zero, under "qr" against the JAX package's
    UNSHARDED run (JAX on a padded mesh counts the padded points)."""
    for r in world:
        assert_matches(r[f"gn_{name}"], jax_unsharded(name, "qr", 2), "qr", 2)


def test_trainer_gn_phase_on_the_point_mesh(world):
    """train(..., gn_iterations=3, gn_solve="cg") on the (2, 2) mesh: the
    trainer hands its shard to gauss_newton, and the result matches the
    port's unsharded three-phase run."""
    for r in world:
        assert r["train_gn"]["phases"] == ["adam", "gn"]
        np.testing.assert_allclose(r["train_gn"]["final"], port_train().final_aux["loss"], rtol=1e-4)


def test_ranks_agree_and_import_no_jax(world):
    """The four ranks report the world in order, the same parameters and
    losses bit for bit (every rank takes the same LM branches), and no JAX
    module."""
    assert [r["topology"]["process_index"] for r in world] == [0, 1, 2, 3]
    assert all(r["jax_modules"] == [] for r in world)
    keys = [k for k in world[0] if k.startswith("gn_")]
    assert len(keys) == len(GN_SOLVES) + 4
    for r in world[1:]:
        for key in keys:
            assert r[key] == world[0][key], key
        assert r["train_gn"]["loss"] == world[0]["train_gn"]["loss"]
