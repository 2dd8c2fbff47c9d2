"""Helpers shared by the port's parity tests (tests/test_torch_*.py): the
same numpy parameters for both packages, and the comparison of a problem's
loss, aux and gradients between the JAX package and the PyTorch port; one
tiny configuration per family with builders that start from a JAX draw
(the adaptive and Galerkin tests); and the test that the comparison's leaf
order is that of both packages."""

import contextlib
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import hpvpinns_tpu as jv  # noqa: E402
import hpvpinns_tpu_torch as tv  # noqa: E402
from hpvpinns_tpu_torch.problems.base import parameters  # noqa: E402

TIGHT = dict(rtol=1e-10, atol=1e-13)
# A small AdvDiff problem: one 6 x 6-point element, 3 x 3 test functions, a
# (2,6,6,1) tanh net, t_final 0.3 and a 50-term series.
ADV = dict(n_quad=6, n_test_x=3, n_test_t=3, layers=(2, 6, 6, 1), t_final=0.3, fourier_terms=50, n_bound=10,
           dtype="float64")


def tnp(t):
    return t.detach().cpu().numpy()


def shared_params(tprob, seed=0):
    """The same numpy parameters for both packages: the port's init, biases
    drawn too, as a JAX-shaped tree of numpy arrays."""
    tree = tv.params_to_numpy(tprob.init_params(torch.Generator().manual_seed(seed)))
    rng = np.random.default_rng(seed)
    for layer in tree["net"]:
        layer["b"] = layer["b"] + 0.1 * rng.standard_normal(layer["b"].shape)
    return tree


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def named_leaves(tree):
    """[(name, leaf)] of a params tree, net then pde by sorted key, a network
    value layer by layer, W, b and an adaptive slope s: the order of
    `parameters`."""
    out = [(f"net.{i}.{k}", layer[k]) for i, layer in enumerate(tree["net"]) for k in ("W", "b", "s") if k in layer]
    for key in sorted(tree["pde"]):
        v = tree["pde"][key]
        if isinstance(v, (list, tuple)):
            out += [(f"pde.{key}.{i}.{k}", layer[k]) for i, layer in enumerate(v) for k in ("W", "b")]
        else:
            out.append((f"pde.{key}", v))
    return out


def jax_loss_and_grads(prob, params):
    (_, aux), grads = jax.jit(jax.value_and_grad(prob.loss_fn, has_aux=True))(params, prob.data)
    return aux, grads


def compare_loss_and_grads(jprob, tprob, tree=None, dtype=torch.float64, tight=TIGHT, jax_out=None):
    """Loss, every aux key (each a 0-d tensor of `dtype` in the port) and
    the gradient of every net and PDE leaf, by name, at the same numpy
    parameters `tree` (default: shared_params(tprob)).  `jax_out` is JAX's
    (aux, grads) at `tree` where the caller has them already (jprob is then
    not run).  Returns the port's params."""
    tree = shared_params(tprob) if tree is None else tree
    tparams = tv.params_from_jax(tree, dtype=dtype)
    tloss, taux = tprob.loss_fn(tparams, tprob.data)
    tgrads = torch.autograd.grad(tloss, parameters(tparams))
    jaux, jgrads = jax_out if jax_out is not None else jax_loss_and_grads(jprob, to_jax(tree))
    assert sorted(taux) == sorted(jaux)
    for k, v in taux.items():
        assert v.dim() == 0 and v.dtype == dtype, k
        np.testing.assert_allclose(tnp(v), float(jaux[k]), **tight, err_msg=k)
    jnamed = named_leaves(jgrads)
    assert [n for n, _ in jnamed] == [n for n, _ in named_leaves(tparams)]
    for (name, j), t in zip(jnamed, tgrads):
        np.testing.assert_allclose(tnp(t), np.asarray(j), **tight, err_msg=name)
    return tparams


def option_matches_default(tcfg, **cfg_kw):
    """The network options the port once refused (an adaptive slope, the
    matmul precision "high"/"default") build and run on the CPU: at the
    initial slope s = 1, and with no TF32 on the CPU, the loss and the
    gradients of W and b equal the default's (to rounding: the JVP engine's
    backward may add its terms in another order), and every slope's
    gradient is finite.  Returns the option's problem."""
    base, prob = tv.build(tcfg, device="cpu"), tv.build(dataclasses.replace(tcfg, **cfg_kw), device="cpu")
    out = []
    for p in (base, prob):
        params = p.init_params(torch.Generator().manual_seed(0))
        loss, _ = p.loss_fn(params, p.data)
        out.append((loss, dict(zip([n for n, _ in named_leaves(params)],
                                   torch.autograd.grad(loss, parameters(params))))))
    (lb, gb), (lo, go) = out
    np.testing.assert_allclose(tnp(lo), tnp(lb), rtol=1e-13)
    for name, g in go.items():
        if name.endswith(".s"):
            assert cfg_kw.get("adaptive_slope") and torch.isfinite(g), name
        else:
            np.testing.assert_allclose(tnp(g), tnp(gb[name]), rtol=1e-13, atol=1e-15, err_msg=name)
    assert any(n.endswith(".s") for n in go) == bool(cfg_kw.get("adaptive_slope"))
    return prob


@contextlib.contextmanager
def one_torch_thread():
    """One intra-op torch thread inside: the port's tests run small tensors,
    and pytest-xdist's workers share the cores, where more threads spin on
    each other's cores (measured: 2-10x slower under the tier-1 command)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def train_gn_tail(prob, adam: int = 10, gn: int = 2):
    """Train `prob` on its preset's schedule cut to `adam` Adam steps, no
    L-BFGS and `gn` accepted Gauss-Newton/LM steps with the preset's solve:
    the LM phase runs, its records go on from the Adam count (offset + the
    accepted step), and its loss falls at every one."""
    check = 5
    cfg = dataclasses.replace(prob.config.train, iterations=adam, lbfgs_iterations=0, gn_iterations=gn,
                              check_every=check, best_snapshot_fraction=None)
    with one_torch_thread():
        res = tv.train(prob, cfg, verbose=False)
    assert res.phases["gn"]["accepted"] == gn and res.iterations_run == adam + res.phases["gn"]["iterations"]
    n_adam = adam // check
    np.testing.assert_array_equal(res.history["iteration"], np.r_[np.arange(check, adam + 1, check),
                                                                  adam + np.arange(1, gn + 1)])
    assert np.all(np.diff(res.history["loss"][n_adam - 1:]) < 0)
    return res


def mlp_pair(layers, seed=0):
    """One tanh net of random numpy weights as two apply functions over the
    same numbers: the port's (torch tensors) and the JAX package's."""
    from hpvpinns_tpu.models.mlp import MLP as JMLP
    from hpvpinns_tpu.models.mlp import mlp_apply as jmlp_apply
    from hpvpinns_tpu_torch.models.mlp import MLP, mlp_apply

    rng = np.random.default_rng(seed)
    tree = [{"W": rng.standard_normal((a, b)) / np.sqrt(a), "b": 0.1 * rng.standard_normal(b)}
            for a, b in zip(layers[:-1], layers[1:])]
    tspec, jspec = MLP(layers=layers), JMLP(layers=layers)
    tnet = [{k: torch.tensor(v) for k, v in layer.items()} for layer in tree]
    jnet = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in tree]
    return (lambda X: mlp_apply(tspec, tnet, X)), (lambda X: jmlp_apply(jspec, jnet, X))


def velocity_field(x):
    """A true velocity field for manufactured AdvDiff problems (generic operators)."""
    return 1.0 + 0.3 * x


def epsilon_field(x):
    """A true diffusion field eps(x) for manufactured AdvDiff problems."""
    return 0.03 + 0.01 * x + 0.02 * x * x


# One tiny float64 configuration per family (the keyword arguments are
# those of both packages' config classes), plus hard BC on Poisson-2D.
FAMILIES = {
    "poisson1d": ("Poisson1DConfig", dict(grid=(-1.0, -0.1, 0.1, 1.0), n_elements=3, n_quad=12, n_test=5,
                                          layers=(1, 8, 8, 1))),
    "poisson2d": ("Poisson2DConfig", dict(n_elements_x=2, n_elements_y=2, n_quad=6, n_test_x=3, n_test_y=3,
                                          layers=(2, 8, 8, 1))),
    "poisson2d_hard_bc": ("Poisson2DConfig", dict(n_elements_x=2, n_elements_y=2, n_quad=6, n_test_x=3,
                                                  n_test_y=3, layers=(2, 8, 8, 1), hard_bc=True)),
    "helmholtz2d": ("Helmholtz2DConfig", dict(grid_x=(-1.0, 0.25, 1.0), n_elements_y=1, n_quad=5, n_test_x=3,
                                              n_test_y=3, layers=(2, 6, 6, 1), n_bound=6, n_sensors=7,
                                              inverse=True)),
    "advdiff": ("AdvDiffConfig", dict(n_elements_x=2, n_quad=6, n_test_x=3, n_test_t=3, layers=(2, 6, 6, 1),
                                      t_final=0.3, fourier_terms=50, n_bound=10)),
    "advdiff2d": ("AdvDiff2DConfig", dict(grid_x=(-1.0, 0.2, 1.0), n_quad=4, n_test_x=3, n_test_y=3, n_test_t=3,
                                          layers=(3, 6, 6, 1))),
    "burgers": ("BurgersConfig", dict(grid_x=(-1.0, -0.2, 0.3, 1.0), n_elements_t=1, n_quad=5, n_test_x=3,
                                      n_test_t=3, layers=(2, 6, 6, 1), n_bound=6, t_final=0.5)),
    "kovasznay": ("KovasznayConfig", dict(n_elements_x=2, layers=(2, 8, 8, 3), n_quad=5, n_test_x=3, n_test_y=3,
                                          n_bound=5, n_sensors=6, inverse=True)),
    "taylorgreen": ("TaylorGreenConfig", dict(n_elements_x=2, layers=(3, 8, 8, 3), n_quad=4, n_test_x=2,
                                              n_test_y=2, n_test_t=2, n_bound=5, n_sensors=6, n_anchor=4,
                                              n_zero_mean_t=3)),
}


def family_configs(family, train=None, **kw):
    """(JAX config, port config) of `family`; `train` the keyword arguments
    of both TrainConfigs (default: the config's own)."""
    name, base = FAMILIES[family]
    kw = {**base, "dtype": "float64", **kw}
    if train is None:
        return getattr(jv, name)(**kw), getattr(tv, name)(**kw)
    return getattr(jv, name)(**kw, train=jv.TrainConfig(**train)), getattr(tv, name)(**kw, train=tv.TrainConfig(**train))


@functools.lru_cache(maxsize=None)
def family_case(family):
    """(JAX problem, JAX params, port problem, port params): the port's
    params are the JAX draw at key 0, converted."""
    jcfg, tcfg = family_configs(family)
    jprob = jv.build(jcfg)
    jparams = jprob.init_params(jax.random.key(0))
    tprob = tv.build(tcfg, device="cpu")
    tparams = tv.params_from_jax(jax.tree.map(np.asarray, jparams), dtype=torch.float64)
    return jprob, jparams, tprob, tparams


def draw_of(jcfg):
    """JAX's draw at the train seed, its biases drawn too (numpy, seed 0):
    from zero biases on these odd-symmetric problems the gradient of the
    first layer's biases is zero up to rounding (~1e-17), and Adam's
    normalized step turns that rounding into a full step of either sign."""
    draw = jax.tree.map(np.asarray, jv.build(jcfg).init_params(jax.random.key(jcfg.train.seed)))
    rng = np.random.default_rng(0)
    for layer in draw["net"]:
        layer["b"] = layer["b"] + 0.1 * rng.standard_normal(layer["b"].shape)
    return draw


def draw_builds(draw):
    """(JAX build_fn, port build_fn on the CPU) whose init_params give `draw`."""
    jbuild = jv.build

    def jax_build(cfg):
        prob = jbuild(cfg)
        prob.init_params = lambda key: jax.tree.map(jax.numpy.asarray, draw)
        return prob

    def port_build(cfg):
        prob = tv.build(cfg, device="cpu")
        prob.init_params = lambda generator: tv.params_from_jax(draw, dtype=torch.float64)
        return prob

    return jax_build, port_build


def test_named_leaves_follow_both_packages_orders():
    """named_leaves of an eps-network tree beside a velocity vector lists the
    port's `parameters` order, which is JAX's tree-leaf order."""
    prob = tv.build(tv.AdvDiffConfig(**ADV, epsilon_model="mlp", velocity_trainable=True, velocity_model="linear"),
                    device="cpu")
    tree = shared_params(prob)
    tparams = tv.params_from_jax(tree, dtype=torch.float64)
    names = [n for n, _ in named_leaves(tree)]
    assert names[6:] == [f"pde.eps_net.{i}.{k}" for i in range(3) for k in ("W", "b")] + ["pde.vel_coef"]
    for (_, a), t, j in zip(named_leaves(tree), parameters(tparams), jax.tree.leaves(to_jax(tree))):
        np.testing.assert_array_equal(a, tnp(t))
        np.testing.assert_array_equal(a, np.asarray(j))
    jparams = jv.build(jv.AdvDiffConfig(**ADV, epsilon_model="mlp")).init_params(jax.random.key(0))
    assert jax.tree.structure(jparams) == jax.tree.structure(shared_params(tv.build(
        tv.AdvDiffConfig(**ADV, epsilon_model="mlp"), device="cpu")))
