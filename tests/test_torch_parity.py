"""Helpers shared by the port's parity tests (tests/test_torch_*.py): the
same numpy parameters for both packages, and the comparison of a problem's
loss, aux and gradients between the JAX package and the PyTorch port; and
the test that the comparison's leaf order is that of both packages."""

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
    value layer by layer, W then b: the order of `parameters`."""
    out = [(f"net.{i}.{k}", layer[k]) for i, layer in enumerate(tree["net"]) for k in ("W", "b")]
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


def compare_loss_and_grads(jprob, tprob, tree=None, dtype=torch.float64, tight=TIGHT):
    """Loss, every aux key (each a 0-d tensor of `dtype` in the port) and
    the gradient of every net and PDE leaf, by name, at the same numpy
    parameters `tree` (default: shared_params(tprob)).  Returns the port's
    params."""
    tree = shared_params(tprob) if tree is None else tree
    tparams = tv.params_from_jax(tree, dtype=dtype)
    tloss, taux = tprob.loss_fn(tparams, tprob.data)
    tgrads = torch.autograd.grad(tloss, parameters(tparams))
    jaux, jgrads = jax_loss_and_grads(jprob, to_jax(tree))
    assert sorted(taux) == sorted(jaux)
    for k, v in taux.items():
        assert v.dim() == 0 and v.dtype == dtype, k
        np.testing.assert_allclose(tnp(v), float(jaux[k]), **tight, err_msg=k)
    jnamed = named_leaves(jgrads)
    assert [n for n, _ in jnamed] == [n for n, _ in named_leaves(tparams)]
    for (name, j), t in zip(jnamed, tgrads):
        np.testing.assert_allclose(tnp(t), np.asarray(j), **tight, err_msg=name)
    return tparams


def velocity_field(x):
    """A true velocity field for manufactured AdvDiff problems (generic operators)."""
    return 1.0 + 0.3 * x


def epsilon_field(x):
    """A true diffusion field eps(x) for manufactured AdvDiff problems."""
    return 0.03 + 0.01 * x + 0.02 * x * x


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
