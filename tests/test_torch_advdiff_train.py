"""Port parity, AdvDiff on the trainer: the nested and 0-d PDE leaves
(a JAX eps-network tree through `convert`, `parameters`' order, the port's
own init) and the Adam and L-BFGS phases over them, against the JAX
package, in float64 on the CPU, at the small size of tests/test_torch_parity.py.

Tolerances: 10 Adam steps rtol 1e-8 (Adam's division by sqrt(v) amplifies
roundoff), as tests/test_torch_poisson2d.py holds its trainer; conversions
bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import hpvpinns_tpu as jv  # noqa: E402
import hpvpinns_tpu_torch as tv  # noqa: E402
from hpvpinns_tpu_torch.problems.base import parameters  # noqa: E402
from test_torch_parity import ADV, named_leaves, shared_params, tnp, to_jax  # noqa: E402


def configs(**kw):
    kw = {**ADV, **kw}
    tkw = kw.pop("train", dict(iterations=10, check_every=5))
    return (jv.AdvDiffConfig(**kw, train=jv.TrainConfig(**tkw)),
            tv.AdvDiffConfig(**kw, train=tv.TrainConfig(**tkw)))


def test_nested_pde_leaves_round_trip_and_order():
    """A JAX epsilon_model="mlp" tree (a network under pde["eps_net"], next
    to a velocity vector) round-trips through params_from_jax /
    params_to_numpy, and `parameters` lists every leaf once in a fixed order."""
    jcfg, _ = configs(epsilon_model="mlp", velocity_trainable=True, velocity_model="linear")
    tree = jax.tree.map(np.asarray, jv.build(jcfg).init_params(jax.random.key(0)))
    assert isinstance(tree["pde"]["eps_net"], list) and len(tree["pde"]["eps_net"]) == 3
    tparams = tv.params_from_jax(tree, dtype=torch.float64)
    back = tv.params_to_numpy(tparams)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    leaves = parameters(tparams)
    assert len(leaves) == len({id(t) for t in leaves}) == len(jax.tree.leaves(tree)) == 6 + 6 + 1
    assert all(isinstance(t, torch.nn.Parameter) for t in leaves)
    assert [tuple(t.shape) for t in leaves[6:]] == [(1, 8), (8,), (8, 8), (8,), (8, 1), (1,), (2,)]


def test_port_init_of_the_pde_leaves():
    """The port's own init: eps scalar 0-d at epsilon_init, the quadratic and
    velocity vectors, and the eps network near-flat at epsilon_init from the
    train seed + 101 (drawn on the CPU generator, the same on every call)."""
    _, tcfg = configs(epsilon_model="mlp", velocity_trainable=True)
    prob = tv.build(tcfg, device="cpu")
    p1, p2 = (prob.init_params(torch.Generator().manual_seed(0)) for _ in range(2))
    for a, b in zip(parameters(p1), parameters(p2)):
        np.testing.assert_array_equal(tnp(a), tnp(b))
    eps = prob.extras["eps_domain_mean"](p1)
    assert abs(eps.item() - 1.0) < 0.05 and tnp(p1["pde"]["velocity"]).item() == 0.5
    assert p1["pde"]["velocity"].dim() == 0
    scalar = tv.build(configs()[1], device="cpu").init_params(torch.Generator().manual_seed(0))
    assert scalar["pde"]["epsilon"].dim() == 0 and scalar["pde"]["epsilon"].item() == 1.0


@pytest.fixture(scope="module")
def jax_trained():
    jcfg, _ = configs()
    jprob = jv.build(jcfg)
    tree = shared_params(tv.build(configs()[1], device="cpu"))
    return jprob, tree, jv.train(jprob, params=to_jax(tree), verbose=False)


def test_adam_moves_epsilon_and_matches_jax(jax_trained):
    """10 Adam steps (records every 5) from the same parameters: the history,
    eps included, and every leaf within rtol 1e-8 of the JAX trainer's; eps
    has moved from its start."""
    jprob, tree, jres = jax_trained
    _, tcfg = configs()
    start = tv.params_from_jax(tree, dtype=torch.float64)
    res = tv.train(tv.build(tcfg, device="cpu"), params=start, verbose=False)
    assert "epsilon" in res.history and res.iterations_run == 10
    np.testing.assert_array_equal(res.history["iteration"], [5, 10])
    for k in ("loss", "lossb", "lossv", "epsilon"):
        np.testing.assert_allclose(res.history[k], jres.history[k], rtol=1e-8, err_msg=k)
    assert res.history["epsilon"][-1] < 1.0 - 1e-3
    for (name, j), t in zip(named_leaves(jres.params), parameters(res.params)):
        np.testing.assert_allclose(tnp(t), np.asarray(j), rtol=1e-8, atol=1e-12, err_msg=name)
    assert tnp(start["pde"]["epsilon"]).item() == 1.0  # the caller's params are not updated
    # the 256 x 31 test grid: the same prediction and errors
    tev = tv.evaluate_problem(tv.build(tcfg, device="cpu"), res.params)
    jev = jv.evaluate_problem(jprob, jres.params)
    for k in ("rel_l2", "max_abs_err", "mean_abs_err"):
        np.testing.assert_allclose(tev[k], jev[k], rtol=1e-8, err_msg=k)


def test_lbfgs_takes_the_nested_and_scalar_leaves():
    """Adam 4 + L-BFGS 4 with the eps network and a trainable velocity: both
    phases run over every leaf, the L-BFGS loss does not rise, and the best
    snapshot keeps the nesting."""
    _, tcfg = configs(epsilon_model="mlp", velocity_trainable=True,
                      train=dict(iterations=4, lbfgs_iterations=4, check_every=2, best_snapshot_fraction=0.5))
    prob = tv.build(tcfg, device="cpu")
    res = tv.train(prob, verbose=False)
    np.testing.assert_array_equal(res.history["iteration"], [2, 4, 6, 8])
    assert np.all(np.diff(res.history["loss"][1:]) <= 0) and set(res.history) >= {"epsilon", "velocity"}
    assert isinstance(res.best_params["pde"]["eps_net"], list) and len(parameters(res.best_params)) == 6 + 6 + 1
    assert res.history["velocity"][-1] != 0.5
