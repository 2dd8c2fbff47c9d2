"""Port parity, network and Taylor fields: models/mlp.py and ops/taylor.py of
the PyTorch port against the JAX package, in float64 on the CPU, from the
same numpy-made parameters (given to the port through
convert.params_from_jax) and the same numpy inputs.  Different libraries sum in different orders, so the
tolerance is rtol 1e-12 (atol 1e-12 for entries that cancel to ~0)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hpvpinns_tpu.models.mlp import MLP as JMLP  # noqa: E402
from hpvpinns_tpu.models.mlp import mlp_apply as japply  # noqa: E402
from hpvpinns_tpu.ops.taylor import act_derivs3 as jderivs3  # noqa: E402
from hpvpinns_tpu.ops.taylor import mlp_fields as jfields  # noqa: E402
from hpvpinns_tpu.ops.taylor import taylor_fields_2d as jfields2d  # noqa: E402
from hpvpinns_tpu_torch.convert import params_from_jax, params_to_numpy  # noqa: E402
from hpvpinns_tpu_torch.models.mlp import MLP, init_mlp, mlp_apply  # noqa: E402
from hpvpinns_tpu_torch.ops.taylor import act_derivs3, mlp_fields, taylor_fields_2d  # noqa: E402

TOL = dict(rtol=1e-12, atol=1e-12)


def make(layers, act, seed=0):
    """One network for both packages: Xavier-scaled normal weights and small
    biases from numpy, handed to JAX as arrays and to the port through
    params_from_jax."""
    rng = np.random.default_rng(seed)
    tree = {"net": [
        {"W": (rng.standard_normal((a, b)) * np.sqrt(2.0 / (a + b))).astype(np.float64),
         "b": (0.1 * rng.standard_normal(b)).astype(np.float64)}
        for a, b in zip(layers[:-1], layers[1:])
    ], "pde": {}}
    jp = jax.tree.map(jnp.asarray, tree["net"])
    tp = params_from_jax(tree, dtype=torch.float64)["net"]
    return JMLP(layers=layers, activation=act), jp, MLP(layers=layers, activation=act), tp


def inputs(P, d, seed=1):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (P, d))


def close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **(tol or TOL))


@pytest.mark.parametrize("act", ["tanh", "sin"])
def test_mlp_apply_matches_jax(act):
    jspec, jp, spec, tp = make((2, 16, 16, 1), act)
    X = inputs(60, 2)
    close(mlp_apply(spec, tp, torch.as_tensor(X)), japply(jspec, jp, jnp.asarray(X)))


@pytest.mark.parametrize("second", [False, True])
@pytest.mark.parametrize("d", [1, 2, 3])
@pytest.mark.parametrize("act", ["tanh", "sin"])
def test_mlp_fields_matches_jax(act, d, second):
    jspec, jp, spec, tp = make((d, 12, 12, 1), act, seed=d)
    X = inputs(50, d, seed=d)
    dirs = tuple(range(d))
    tu, tf, ts = mlp_fields(spec, tp, torch.as_tensor(X), dirs, second=second)
    ju, jf, js = jfields(jspec, jp, jnp.asarray(X), dirs, second=second)
    close(tu, ju)
    assert len(tf) == len(jf) == d and len(ts) == len(js) == (d if second else 0)
    for t, j in zip(tf + ts, jf + js):
        close(t, j)


@pytest.mark.parametrize("act", ["tanh", "sin"])
def test_act_derivs3_matches_jax(act):
    z = np.linspace(-3.0, 3.0, 41)
    for t, j in zip(act_derivs3(act, torch.as_tensor(z)), jderivs3(act, jnp.asarray(z))):
        close(t, j)


@pytest.mark.parametrize("kw", [{"firsts_only": True}, {}, {"first_y_only": True}, {"second_y": False}])
def test_taylor_fields_2d_matches_jax(kw):
    jspec, jp, spec, tp = make((2, 10, 10, 1), "tanh")
    x, y = inputs(24, 2).T.reshape(2, 4, 6)
    tf = taylor_fields_2d(spec, tp, torch.as_tensor(x), torch.as_tensor(y), **kw)
    jf = jfields2d(jspec, jp, jnp.asarray(x), jnp.asarray(y), **kw)
    assert sorted(tf) == sorted(jf)
    for k in tf:
        assert tf[k].shape == (4, 6)
        close(tf[k], jf[k])


def test_init_mlp_statistics_and_roundtrip():
    spec = MLP(layers=(2, 48, 48, 1), activation="tanh")
    p1 = init_mlp(spec, torch.Generator().manual_seed(0), dtype=torch.float64)
    p2 = init_mlp(spec, torch.Generator().manual_seed(0), dtype=torch.float64)
    for l, layer in enumerate(p1):
        std = np.sqrt(2.0 / (spec.layers[l] + spec.layers[l + 1]))
        W = layer["W"].detach().numpy()
        assert isinstance(layer["W"], torch.nn.Parameter) and W.shape == spec.layers[l : l + 2]
        assert np.abs(W).max() <= 2.0 * std and not np.any(layer["b"].detach().numpy())
        np.testing.assert_array_equal(W, p2[l]["W"].detach().numpy())  # same seed, same net
    back = params_to_numpy({"net": p1, "pde": {}})
    again = params_from_jax(back, dtype=torch.float64)
    for a, b in zip(p1, again["net"]):
        np.testing.assert_array_equal(a["W"].detach().numpy(), b["W"].detach().numpy())


def test_unported_options_raise():
    """The options the port once refused are ported (precision "high" and
    "default", the adaptive slope, gelu and swish); what neither package
    takes still raises ValueError."""
    for kw in ({"precision": "high"}, {"precision": "default"}, {"adaptive_slope": True},
               {"activation": "gelu"}, {"activation": "swish"}):
        spec = MLP(layers=(2, 4, 1), **kw)
        net = init_mlp(spec, torch.Generator().manual_seed(0), dtype=torch.float64)
        assert mlp_apply(spec, net, torch.zeros((3, 2), dtype=torch.float64)).shape == (3, 1)
        assert [sorted(layer) for layer in net] == ([["W", "b", "s"], ["W", "b"]] if "adaptive_slope" in kw
                                                    else [["W", "b"]] * 2)
    with pytest.raises(ValueError, match="unknown activation"):
        MLP(layers=(2, 4, 1), activation="relu")
    with pytest.raises(ValueError, match="matmul precision"):
        MLP(layers=(2, 4, 1), precision="bf16")
