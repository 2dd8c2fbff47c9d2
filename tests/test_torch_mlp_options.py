"""Port parity, the network's last options: gelu and swish, the adaptive
slope, the matmul precision "high"/"default" and `__version__`
(models/mlp.py, ops/taylor.py, problems/base.py, convert.py) against the JAX
package, in float64 on the CPU, from the same numpy parameters.

Tolerances: the activation tables and the Taylor fields to 1e-12 (the
port's gelu derivatives are closed forms where JAX takes them by autodiff);
the slope's fields and gradients to 1e-10.  On the CPU there is no TF32, so
"high" and "default" equal "highest": the forward bit for bit, the
gradients to 1e-13 (the JVP engine's backward adds in another order)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import hpvpinns_tpu as jv  # noqa: E402
import hpvpinns_tpu_torch as tv  # noqa: E402
from hpvpinns_tpu.models.mlp import MLP as JMLP  # noqa: E402
from hpvpinns_tpu.ops.taylor import act_derivs as jact_derivs  # noqa: E402
from hpvpinns_tpu.ops.taylor import taylor_fields_2d as jfields2d  # noqa: E402
from hpvpinns_tpu_torch.models.mlp import MLP, _TF32Matmul, mlp_apply  # noqa: E402
from hpvpinns_tpu_torch.ops.fields import scalar_fields_2d  # noqa: E402
from hpvpinns_tpu_torch.ops.fused_fields import fields_flat  # noqa: E402
from hpvpinns_tpu_torch.ops.taylor import act_derivs, taylor_fields_2d  # noqa: E402
from hpvpinns_tpu_torch.problems.base import parameters  # noqa: E402
from test_torch_parity import named_leaves, tnp  # noqa: E402

TOL = dict(rtol=1e-12, atol=1e-12)
SLOPE_TOL = dict(rtol=1e-10, atol=1e-12)
LAYERS = (2, 7, 6, 1)
PANEL = dict(n_elements_x=2, n_elements_y=2, n_quad=6, n_test_x=3, n_test_y=3, layers=(2, 8, 8, 1), dtype="float64")


def tree_of(activation, slope, seed=0):
    """Numpy parameters for both packages (Xavier-scaled weights, small
    biases, and slopes about 1 where `slope`) and the points."""
    rng = np.random.default_rng(seed)
    net = []
    for i, (a, b) in enumerate(zip(LAYERS[:-1], LAYERS[1:])):
        layer = {"W": rng.standard_normal((a, b)) * np.sqrt(2.0 / (a + b)), "b": 0.1 * rng.standard_normal(b)}
        if slope and i < len(LAYERS) - 2:
            layer["s"] = np.asarray(1.0 + 0.3 * rng.standard_normal())
        net.append(layer)
    return {"net": net, "pde": {}}, rng.uniform(-1.0, 1.0, 40), rng.uniform(-1.0, 1.0, 40)


@pytest.mark.parametrize("activation", ["gelu", "swish"])
def test_activation_tables_match_jax(activation):
    """(act, act', act'') against the JAX package's (gelu's by autodiff
    there, in closed form here) to 1e-12, and the activation itself is
    jax.nn.gelu's tanh form (the erf form differs by ~1e-3)."""
    z = np.linspace(-6.0, 6.0, 241)
    for j, t in zip(jact_derivs(activation, jnp.asarray(z)), act_derivs(activation, torch.tensor(z))):
        np.testing.assert_allclose(tnp(t), np.asarray(j), **TOL)
    one = {"W": torch.ones((1, 1), dtype=torch.float64), "b": torch.zeros(1, dtype=torch.float64)}
    spec = MLP(layers=(1, 1, 1), activation=activation)  # the output is act(x)
    jact = jax.nn.gelu if activation == "gelu" else jax.nn.swish
    got = mlp_apply(spec, [one, one], torch.tensor(z[:, None]))[:, 0]
    np.testing.assert_allclose(tnp(got), np.asarray(jact(jnp.asarray(z))), **TOL)


@pytest.mark.parametrize("activation,slope,precision", [
    ("gelu", False, "highest"), ("swish", False, "default"), ("tanh", True, "highest"), ("gelu", True, "high"),
])
def test_fields_and_gradients_match_jax(activation, slope, precision):
    """taylor_fields_2d and the JVP engine on mlp_apply against JAX's
    taylor_fields_2d, and the gradient of the fields' sum with respect to
    every leaf (W, b and s, in JAX's leaf order), with the slopes chained
    into the derivatives as s and s^2."""
    tree, x, y = tree_of(activation, slope)
    jspec = JMLP(layers=LAYERS, activation=activation, adaptive_slope=slope)
    spec = MLP(layers=LAYERS, activation=activation, adaptive_slope=slope, precision=precision)
    jnet = jax.tree.map(jnp.asarray, tree["net"])
    tparams = tv.params_from_jax(tree, dtype=torch.float64)
    tol = SLOPE_TOL if slope else TOL

    def jsum(net):
        return sum(v.sum() for v in jfields2d(jspec, net, jnp.asarray(x), jnp.asarray(y)).values())

    jf, jgrads = jax.jit(lambda net: (jfields2d(jspec, net, jnp.asarray(x), jnp.asarray(y)), jax.grad(jsum)(net)))(jnet)
    jgrads = [np.asarray(g) for g in jax.tree.leaves(jgrads)]
    tx, ty = torch.tensor(x), torch.tensor(y)
    for engine in ("taylor", "jvp"):
        if engine == "taylor":
            tf = taylor_fields_2d(spec, tparams["net"], tx, ty)
        else:
            tf = scalar_fields_2d(lambda X: mlp_apply(spec, tparams["net"], X), tx, ty)
        assert sorted(tf) == sorted(jf)
        for k in jf:
            np.testing.assert_allclose(tnp(tf[k]), np.asarray(jf[k]), **tol, err_msg=f"{engine} {k}")
        tgrads = torch.autograd.grad(sum(v.sum() for v in tf.values()), parameters(tparams))
        assert len(tgrads) == len(jgrads)
        for (name, _), t, j in zip(named_leaves(tree), tgrads, jgrads):
            np.testing.assert_allclose(tnp(t), j, **tol, err_msg=f"{engine} {name}")


def test_slope_round_trips_in_jax_leaf_order():
    """`s` comes through params_from_jax and back unchanged, in JAX's leaf
    order (W, b, s a layer), and init_mlp makes s = 1 on hidden layers only,
    with the JAX draw's structure."""
    jprob = jv.build(jv.Poisson2DConfig(**PANEL, adaptive_slope=True))
    jparams = jprob.init_params(jax.random.key(0))
    tree = jax.tree.map(np.asarray, jparams)
    tparams = tv.params_from_jax(tree, dtype=torch.float64)
    leaves = [np.asarray(a) for a in jax.tree.leaves(jparams)]
    assert [n for n, _ in named_leaves(tree)] == [f"net.{i}.{k}" for i in range(3) for k in ("W", "b", "s")][:-1]
    for a, t in zip(leaves, parameters(tparams), strict=True):
        np.testing.assert_array_equal(tnp(t), a)
    back = tv.params_to_numpy(tparams)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), leaves):
        np.testing.assert_array_equal(a, b)
    tprob = tv.build(tv.Poisson2DConfig(**PANEL, adaptive_slope=True), device="cpu")
    own = tv.params_to_numpy(tprob.init_params(torch.Generator().manual_seed(0)))
    assert jax.tree.structure(own) == jax.tree.structure(tree)
    assert [float(layer["s"]) for layer in own["net"][:-1]] == [1.0, 1.0]


def test_slope_problem_loss_and_gradients_match_jax():
    """A whole problem with the slope (Poisson-2D var_form 0, "taylor"): the
    loss, every aux key and the gradient of every leaf, s included, at JAX's
    draw with slopes moved off 1, to 1e-10."""
    from test_torch_parity import compare_loss_and_grads

    cfg = dict(PANEL, adaptive_slope=True, var_form=0, activation="swish")
    jprob = jv.build(jv.Poisson2DConfig(**cfg))
    tree = jax.tree.map(np.asarray, jprob.init_params(jax.random.key(0)))
    rng = np.random.default_rng(3)
    for layer in tree["net"]:
        layer["b"] = layer["b"] + 0.1 * rng.standard_normal(layer["b"].shape)
        if "s" in layer:
            layer["s"] = np.asarray(1.0 + 0.2 * rng.standard_normal())
    compare_loss_and_grads(jprob, tv.build(tv.Poisson2DConfig(**cfg), device="cpu"), tree, tight=SLOPE_TOL)


@pytest.mark.parametrize("precision", ["high", "default"])
def test_reduced_precision_equals_highest_on_the_cpu(precision):
    """No TF32 on the CPU: the network's products at "high"/"default" go
    through the TF32 function (forward, backward, JVP and vmap rules) and
    give what "highest" gives; under torch.func.vmap over stacked networks
    too (the ensemble's path)."""
    tree, x, y = tree_of("tanh", False)
    hi, lo = MLP(layers=LAYERS), MLP(layers=LAYERS, precision=precision)
    X = torch.tensor(np.stack([x, y], -1))
    outs = {}
    for spec in (hi, lo):
        net = tv.params_from_jax(tree, dtype=torch.float64)["net"]
        f = taylor_fields_2d(spec, net, X[:, 0], X[:, 1])
        j = scalar_fields_2d(lambda Z: mlp_apply(spec, net, Z), X[:, 0], X[:, 1])
        vals = [f[k] for k in sorted(f)] + [j[k] for k in sorted(j)]
        grads = torch.autograd.grad(sum(v.sum() for v in vals), parameters({"net": net, "pde": {}}))
        stacked = [{k: torch.stack([v.detach(), 2.0 * v.detach()]) for k, v in layer.items()} for layer in net]
        vm = torch.func.vmap(lambda n: mlp_apply(spec, n, X))(stacked)
        outs[spec.precision] = (vals, grads, vm)
    (va, ga, ma), (vb, gb, mb) = outs["highest"], outs[precision]
    calls = {"forward": 0, "backward": 0, "jvp": 0}

    def counted(name):
        real = getattr(_TF32Matmul, name)

        def rule(*args):
            calls[name] += 1
            return real(*args)

        return staticmethod(rule)

    with pytest.MonkeyPatch.context() as mp:  # the JVP engine and autograd go through the function's own rules
        for name in calls:
            mp.setattr(_TF32Matmul, name, counted(name))
        net = tv.params_from_jax(tree, dtype=torch.float64)["net"]
        f = scalar_fields_2d(lambda Z: mlp_apply(lo, net, Z), X[:, 0], X[:, 1])
        torch.autograd.grad(sum(v.sum() for v in f.values()), parameters({"net": net, "pde": {}}))
    assert min(calls.values()) > 0, calls
    for a, b in zip(va + [ma], vb + [mb]):
        assert torch.equal(a, b)
    for a, b in zip(ga, gb):
        np.testing.assert_allclose(tnp(b), tnp(a), rtol=1e-13, atol=1e-15)


@pytest.mark.parametrize("kw,message", [
    ({"adaptive_slope": True}, "deriv_mode='pallas' does not support adaptive_slope; use 'taylor'"),
    ({"activation": "gelu"}, "pallas fields kernel supports sin/tanh activations; got 'gelu'"),
    ({"activation": "swish"}, "pallas fields kernel supports sin/tanh activations; got 'swish'"),
])
def test_pallas_refuses_with_jax_messages_on_the_cpu(kw, message):
    """Under "pallas" the JAX package raises these ValueErrors on the CPU
    (interpret mode) too; the port raises them before its plain versions
    run, in fields_flat and through a problem's loss."""
    cfg = dict(PANEL, deriv_mode="pallas", dtype="float32", **kw)
    jprob = jv.build(jv.Poisson2DConfig(**cfg))
    with pytest.raises(ValueError) as jerr:
        jprob.loss_fn(jprob.init_params(jax.random.key(0)), jprob.data)
    assert str(jerr.value) == message
    tprob = tv.build(tv.Poisson2DConfig(**cfg), device="cpu")
    params = tprob.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError) as terr:
        tprob.loss_fn(params, tprob.data)
    assert str(terr.value) == message
    with pytest.raises(ValueError, match="pallas"):
        fields_flat(tprob.spec, params["net"], torch.zeros((4, 2)), 2, True)


def test_version():
    assert tv.__version__ == jv.__version__ == "0.1.0"


@pytest.mark.parametrize("grad_mode", [False, True])
def test_swish_nested_jvps_match_jax(grad_mode):
    """swish = z * sigmoid(z) against jax.nn.swish in float64: the value and
    the first and second derivatives by nested JVPs, with grad mode off
    (where F.silu's forward-mode rule raised) and on, to 1e-13."""
    from hpvpinns_tpu_torch.models.mlp import _ACTIVATIONS
    from hpvpinns_tpu_torch.ops.derivatives import value_and_dir_derivs2

    z = np.linspace(-8.0, 8.0, 161)

    def jfirst(x):
        return jax.jvp(jax.nn.swish, (x,), (jnp.ones_like(x),))

    (jv0, jv1), (_, jv2) = jax.jvp(jfirst, (jnp.asarray(z),), (jnp.ones_like(jnp.asarray(z)),))
    zt = torch.tensor(z)
    with torch.set_grad_enabled(grad_mode):
        got = value_and_dir_derivs2(_ACTIVATIONS["swish"], zt, torch.ones_like(zt))
    for t, j in zip(got, (jv0, jv1, jv2)):
        np.testing.assert_allclose(tnp(t), np.asarray(j), rtol=1e-13, atol=1e-14)


def _fuzz_rng(name, trial):
    """tests/test_fuzz_configs.py's per-test stream."""
    return np.random.default_rng([20260816, trial, sum(name.encode())])


def _fuzz_config(pkg, name, trial):
    """The config that tests/test_fuzz_configs.py draws for (name, trial),
    built from package `pkg`'s config classes, draw for draw."""
    RNG = _fuzz_rng(name, trial)

    def act():
        return str(RNG.choice(["sin", "tanh", "gelu", "swish"]))

    def tc():
        return pkg.TrainConfig(iterations=int(RNG.integers(5, 25)), check_every=5)

    if name == "p1d":
        n_elem = int(RNG.integers(1, 5))
        return pkg.Poisson1DConfig(
            dtype=str(RNG.choice(["float32", "float64"])), activation=act(),
            var_form=int(RNG.choice([1, 2, 3])), n_elements=n_elem, n_test=int(RNG.integers(2, 12)),
            n_quad=int(RNG.integers(4, 24)),
            layers=(1,) + tuple(int(RNG.integers(3, 12)) for _ in range(int(RNG.integers(1, 3)))) + (1,),
            adaptive_slope=bool(RNG.integers(0, 2)), deriv_mode=str(RNG.choice(["taylor", "jvp"])), train=tc(),
        )
    return pkg.Poisson2DConfig(
        dtype="float64", activation=act(), scheme=str(RNG.choice(["VPINNs", "PINNs"])),
        var_form=int(RNG.choice([0, 1, 2])), n_elements_x=int(RNG.integers(1, 4)),
        n_elements_y=int(RNG.integers(1, 4)), n_test_x=int(RNG.integers(2, 6)), n_test_y=int(RNG.integers(2, 6)),
        n_quad=int(RNG.integers(4, 10)), n_bound=int(RNG.integers(4, 30)), layers=(2, int(RNG.integers(3, 10)), 1),
        deriv_mode=str(RNG.choice(["taylor", "jvp"])), train=tc(),
    )


@pytest.mark.parametrize("name,trial", [("p1d", 5), ("p2d", 2)])
def test_swish_fuzz_configs_train_on_jvp(name, trial):
    """The two configs of tests/test_fuzz_configs.py that train swish on the
    JVP engine with second derivatives (test_fuzz_poisson1d[5],
    test_fuzz_poisson2d[2]): the port builds the same config and trains it
    (the metrics run under torch.no_grad), and the hierarchical indicator
    (adaptive.element_indicator, under no_grad too) is finite."""
    from hpvpinns_tpu_torch.adaptive import element_indicator

    jcfg, cfg = _fuzz_config(jv, name, trial), _fuzz_config(tv, name, trial)
    assert (cfg.activation, cfg.deriv_mode) == (jcfg.activation, jcfg.deriv_mode) == ("swish", "jvp")
    prob = tv.build(cfg, device="cpu")
    res = tv.train(prob, verbose=False)
    assert np.isfinite(float(res.final_aux["loss"]))
    assert np.isfinite(tv.evaluate_problem(prob, res.params)["rel_l2"])
    assert np.all(np.isfinite(element_indicator(prob, res.params)))


def test_bfloat16_trains():
    """The port's twin of tests/test_problems.py::test_bfloat16_trains: a
    bfloat16 Poisson-2D builds (the host build in float64, cast at the end
    to what JAX's cast gives, bit for bit) and trains 30 steps to a finite
    loss."""
    kw = dict(dtype="bfloat16", n_quad=5, layers=(2, 6, 1))
    jprob = jv.build(jv.Poisson2DConfig(**kw))
    prob = tv.build(tv.Poisson2DConfig(**kw, train=tv.TrainConfig(iterations=30, check_every=10)), device="cpu")
    assert prob.data["xb"].dtype == torch.bfloat16
    for key in ("xb", "ub"):
        np.testing.assert_array_equal(tnp(prob.data[key].float()), np.asarray(jprob.data[key], dtype=np.float32))
    np.testing.assert_array_equal(tnp(prob.data["elements"].f_proj.float()),
                                  np.asarray(jprob.data["elements"].f_proj, dtype=np.float32))
    res = tv.train(prob, verbose=False)
    assert np.isfinite(float(res.final_aux["loss"]))


@pytest.mark.parametrize("family", ["Poisson1DConfig", "AdvDiffConfig", "BurgersConfig", "Helmholtz2DConfig",
                                    "KovasznayConfig", "TaylorGreenConfig", "Poisson3DConfig", "AdvDiff2DConfig"])
def test_bfloat16_builds_in_every_family(family):
    """Every family takes dtype="bfloat16" on "taylor" and "jvp" (it raised
    a bare KeyError): the loss is finite and in bfloat16 under both."""
    for mode in ("taylor", "jvp"):
        prob = tv.build(getattr(tv, family)(dtype="bfloat16", deriv_mode=mode), device="cpu")
        loss, _ = prob.loss_fn(prob.init_params(torch.Generator().manual_seed(0)), prob.data)
        assert loss.dtype == torch.bfloat16 and torch.isfinite(loss)


def test_pallas_refuses_bfloat16():
    """The kernels take float32 only: their argument check raises a
    ValueError that names bfloat16 (on the card a bfloat16 "pallas" loss
    raises it, chip_smoke.py phase 21)."""
    from hpvpinns_tpu_torch.ops.fused_fields import check_kernel_args

    prob = tv.build(tv.Poisson2DConfig(dtype="bfloat16", deriv_mode="pallas", n_quad=5, layers=(2, 6, 1)),
                    device="cpu")
    params = prob.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="bfloat16"):
        check_kernel_args(prob.spec, params["net"], torch.zeros((4, 2), dtype=torch.bfloat16), 2)
