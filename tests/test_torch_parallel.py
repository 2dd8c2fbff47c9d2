"""Port parity, the families on the element mesh at world 4 and the element
x point mesh (hpvpinns_tpu_torch/parallel/sharding.py), the two-process
check (parallel/multihost_check.py) and the dry run (parallel/dryrun.py,
the torch twin of __graft_entry__.py), in float64 (float32 where the JAX
package's check is float32) on the CPU.

One gloo world of four processes (tests/torch_mesh_cases.py, suite
"parallel") runs the cases: the space-time families of
tests/test_sharding.py:164-201 (E 6, padded to 8), AdvDiff with its
Tikhonov term (eps quadratic, and a network), Poisson-1D/3D and Kovasznay,
each against the JAX package's unsharded loss and gradients (1e-10; 1e-8 /
1e-12); the element x point meshes (2, 2) on Poisson-2D, also padded on
both axes with var_form "2c"'s edge fluxes, (1, 4) on Poisson-1D (Q 10
padded to 12), var_form 3's flux too, and (2, 2) on AdvDiff with the
Tikhonov term over a network eps (Q 5 padded to 6); and 20 Adam steps on
the (2, 2) mesh against the port's unsharded run (1e-8).
"""

import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import hpvpinns_tpu as jv  # noqa: E402
import hpvpinns_tpu_torch as tv  # noqa: E402
from hpvpinns_tpu_torch.parallel.dryrun import dryrun_multichip, entry  # noqa: E402
from hpvpinns_tpu_torch.parallel.multihost_check import (  # noqa: E402
    assert_multiprocess_matches,
    run_multiprocess_check,
    spawn,
)
from test_torch_parity import jax_loss_and_grads, named_leaves, one_torch_thread, shared_params, to_jax  # noqa: E402
from torch_mesh_cases import FAMILIES, POINT_CASES, TRAIN, family_config, p2d_config, shared_tree  # noqa: E402

CASES = str(Path(__file__).resolve().parent / "torch_mesh_cases.py")
LOSS_TOL = dict(rtol=1e-10)
GRAD_TOL = dict(rtol=1e-8, atol=1e-12)


@pytest.fixture(scope="module")
def world():
    """The four ranks' results of the "parallel" suite."""
    return spawn([sys.executable, CASES, "parallel"], 4, timeout_s=300)


def jax_config(tcfg):
    cls = getattr(jv, type(tcfg).__name__)
    names = {f.name for f in dataclasses.fields(cls)} - {"train"}
    return cls(**{f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg) if f.name in names})


@functools.lru_cache(maxsize=None)
def jax_reference(label):
    """JAX's unsharded (aux, flat gradients) at the shared params."""
    tcfg = family_config(label) if label in FAMILIES else POINT_CASES[label][0]()
    tprob = tv.build(tcfg, device="cpu")
    aux, grads = jax_loss_and_grads(jv.build(jax_config(tcfg)), to_jax(shared_params(tprob)))
    return {k: float(v) for k, v in aux.items()}, np.concatenate([np.ravel(g) for _, g in named_leaves(grads)])


def check_against_jax(world, label):
    jaux, jgrads = jax_reference(label)
    for r in world:
        got = r[label]
        np.testing.assert_allclose(got["loss"], jaux["loss"], **LOSS_TOL, err_msg=label)
        assert sorted(got["aux"]) == sorted(jaux)
        for k, v in jaux.items():
            np.testing.assert_allclose(got["aux"][k], v, **LOSS_TOL, err_msg=f"{label} {k}")
        np.testing.assert_allclose(got["grads"], jgrads, **GRAD_TOL, err_msg=label)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_sharded_equals_jax_unsharded(world, family):
    """Each family's loss (lossv summed over the ranks, the replicated
    terms counted once), its aux and its gradients on four ranks, padded
    elements included, against JAX's unsharded problem."""
    check_against_jax(world, family)


@pytest.mark.parametrize("label", list(POINT_CASES))
def test_element_point_mesh_equals_jax_unsharded(world, label):
    """The fast quadrature axis split too: the contractions' partial sums
    all-reduced over the point group before the square, the edge fluxes
    counted once; Q and E padded where they do not divide."""
    check_against_jax(world, label)


def test_element_point_mesh_trains_as_unsharded(world):
    """20 Adam steps on the (2, 2) mesh: the gradient shares of all four
    ranks summed in one all-reduce, against the port's unsharded run."""
    prob = tv.build(p2d_config(), device="cpu")
    with one_torch_thread():
        ref = tv.train(prob, tv.TrainConfig(**TRAIN), params=tv.params_from_jax(shared_tree(prob),
                                                                                dtype=torch.float64), verbose=False)
    for r in world:
        np.testing.assert_allclose(r["p2d_2x2_adam"]["loss"], ref.history["loss"], rtol=1e-8)
    assert [r["topology"]["process_index"] for r in world] == [0, 1, 2, 3]
    assert all(r["jax_modules"] == [] for r in world)


def test_two_process_check_matches_single_process():
    """Two processes on the element mesh over a localhost TCP store: the
    loss and the gradient norm of the tiny float32 Poisson-2D to 1e-6, and
    Gauss-Newton "cg" to 2 accepted steps to 1e-4, against the same problem
    unsharded in this process; the children are ranks 0 and 1 and load no
    JAX module."""
    with one_torch_thread():
        result = run_multiprocess_check(timeout_s=300)
    assert_multiprocess_matches(result)
    assert sorted(c["process_index"] for c in result["children"]) == [0, 1]


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n, capsys):
    """The torch twin of __graft_entry__.dryrun_multichip: every leg agrees
    with its unsharded twin in every rank; the 2-D mesh leg from 4 ranks."""
    dryrun_multichip(n)
    out = capsys.readouterr().out
    assert "dryrun_multichip OK" in out
    assert ("2d-mesh" in out) == (n >= 4)


def test_entry_takes_one_step():
    """`entry()`: one Adam step of the flagship Poisson-2D, as
    __graft_entry__.entry's (tests/test_graft_entry.py)."""
    fn, args = entry(device="cpu")
    with one_torch_thread():
        params, opt, loss = fn(*args)
    assert float(loss) > 0 and opt.state
