"""Port parity, the second-derivative backward (B2, ops/fused_fields.py).

On the CPU the gradient of fields_flat(..., second=True) is B2's plain
version, fields_flat_bwd_reference (autograd through the plain forward).  It
is held against the JAX package's backward kernel _pallas_fields_bwd, run in
interpret mode as tests/test_pallas_fields.py runs it, and against jax.grad
of the JAX fields_flat (whose custom VJP is that kernel), in float32 at that
file's tolerance: rtol 2e-4 / atol 1e-5 (the kernels sum over points in
another order than autograd).  The CUDA kernel itself runs only on a GPU
(chip_smoke.py holds it against the same plain version there)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hpvpinns_tpu.models.mlp import MLP as JMLP  # noqa: E402
from hpvpinns_tpu.ops.pallas_fields import _pallas_fields_bwd  # noqa: E402
from hpvpinns_tpu.ops.pallas_fields import fields_flat as jfields_flat  # noqa: E402
from hpvpinns_tpu.ops.pallas_fields import pallas_fields_1d  # noqa: E402
from hpvpinns_tpu_torch.convert import params_from_jax  # noqa: E402
from hpvpinns_tpu_torch.models.mlp import MLP, init_mlp  # noqa: E402
from hpvpinns_tpu_torch.ops.fused_fields import (  # noqa: E402
    block_sum_kernel,
    fields_flat,
    fields_flat_bwd_reference,
    fused_fields_1d,
    fused_fields_bwd_kernel,
    pack_params,
    unpack_params,
)

GRAD_TOL = dict(rtol=2e-4, atol=1e-5)
# One point count (and the JAX kernels' default blocks) for every test, and
# jitted JAX gradients: compiling the interpret-mode kernels takes most of
# this file's time, and the tests of one network then share compilations.
P = 70
SHAPES = [  # (layers, activation, n_dirs)
    ((1, 12, 12, 1), "sin", 1),
    ((2, 16, 16, 1), "tanh", 2),
    ((3, 16, 16, 1), "sin", 3),
    ((2, 8, 24, 5, 1), "tanh", 2),  # mixed widths
]


def make(layers, act, seed=0):
    """One network for both packages: Xavier-scaled normal weights and small
    biases from numpy."""
    rng = np.random.default_rng(seed)
    tree = {"net": [
        {"W": (rng.standard_normal((a, b)) * np.sqrt(2.0 / (a + b))).astype(np.float32),
         "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
        for a, b in zip(layers[:-1], layers[1:])
    ], "pde": {}}
    jp = jax.tree.map(jnp.asarray, tree["net"])
    tp = params_from_jax(tree, dtype=torch.float32)["net"]
    return JMLP(layers=layers, activation=act), jp, MLP(layers=layers, activation=act), tp


def inputs(P, d, n_fields, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1.0, 1.0, (P, d)).astype(np.float32)
    return X, rng.standard_normal((P, n_fields)).astype(np.float32)


def assert_grads(tgrads, tgx, jgrads, jgx):
    for t, j in zip(tgrads, jgrads):
        for k in ("W", "b"):
            np.testing.assert_allclose(t[k].detach().numpy(), np.asarray(j[k]), **GRAD_TOL, err_msg=k)
    np.testing.assert_allclose(tgx.detach().numpy(), np.asarray(jgx), **GRAD_TOL, err_msg="X")


@pytest.mark.parametrize("layers,act,n_dirs", SHAPES)
def test_plain_backward_matches_jax_backward_kernel(layers, act, n_dirs):
    jspec, jp, spec, tp = make(layers, act)
    X, g = inputs(P, layers[0], 1 + 2 * n_dirs)
    tgrads, tgx = fields_flat_bwd_reference(spec, tp, torch.as_tensor(X), torch.as_tensor(g), n_dirs)
    jgrads, jgx = _pallas_fields_bwd(jspec, jp, jnp.asarray(X), jnp.asarray(g), n_dirs)
    assert_grads(tgrads, tgx, jgrads, jgx)


@pytest.mark.parametrize("layers,act,n_dirs", SHAPES)
def test_fields_flat_gradient_matches_jax_grad(layers, act, n_dirs):
    """Autograd through the port's fields_flat (second=True, so B2's path)
    against jax.grad of the JAX fields_flat."""
    jspec, jp, spec, tp = make(layers, act, seed=2)
    X, g = inputs(P, layers[0], 1 + 2 * n_dirs, seed=3)
    Xt = torch.as_tensor(X).requires_grad_(True)
    leaves = [t for layer in tp for t in (layer["W"], layer["b"])]
    grads = torch.autograd.grad((fields_flat(spec, tp, Xt, n_dirs, True) * torch.as_tensor(g)).sum(), leaves + [Xt])
    jgrads, jgx = jax.jit(jax.grad(
        lambda p, x: (jfields_flat(jspec, p, x, n_dirs, True) * g).sum(), argnums=(0, 1)
    ))(jp, jnp.asarray(X))
    assert_grads(unpack_params(spec, torch.cat([t.reshape(-1) for t in grads[:-1]])), grads[-1], jgrads, jgx)


def test_fused_fields_1d_matches_jax():
    jspec, jp, spec, tp = make((1, 12, 12, 1), "sin", seed=4)
    x = np.random.default_rng(5).uniform(-1.0, 1.0, (2, P // 2)).astype(np.float32)
    xt = torch.as_tensor(x)
    tf = fused_fields_1d(spec, tp, xt)
    jf = pallas_fields_1d(jspec, jp, jnp.asarray(x))
    for t, j in zip(tf, jf):
        assert t.shape == (2, P // 2)
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=2e-5, atol=1e-6)
    w = np.random.default_rng(6).standard_normal((3, 2, P // 2)).astype(np.float32)
    leaves = [t for layer in tp for t in (layer["W"], layer["b"])]
    tg = torch.autograd.grad(sum((f * torch.as_tensor(c)).sum() for f, c in zip(tf, w)), leaves)
    jg = jax.jit(jax.grad(lambda p: sum((f * c).sum() for f, c in zip(pallas_fields_1d(jspec, p, jnp.asarray(x)), w))))(jp)
    assert_grads(unpack_params(spec, torch.cat([t.reshape(-1) for t in tg])), torch.zeros(1), jg, np.zeros(1))


def test_unpack_params_inverts_pack_params():
    spec = MLP(layers=(3, 7, 5, 1))
    tp = init_mlp(spec, torch.Generator().manual_seed(0))
    packed, _ = pack_params(spec, tp)
    for a, b in zip(unpack_params(spec, packed), tp):
        for k in ("W", "b"):
            assert a[k].shape == b[k].shape
            torch.testing.assert_close(a[k], b[k].detach(), rtol=0, atol=0)


def test_backward_kernels_reject_what_they_do_not_take():
    """Both wrappers raise before any launch on a CPU tensor (the plain
    version is taken only by fields_flat's backward, never by the kernels)."""
    spec = MLP(layers=(2, 8, 1))
    tp = init_mlp(spec, torch.Generator().manual_seed(0))
    X, g = (torch.as_tensor(a) for a in inputs(4, 2, 5))
    with pytest.raises(ValueError, match="CUDA"):
        fused_fields_bwd_kernel(spec, tp, X, g, 2)
    with pytest.raises(ValueError, match="CUDA"):
        block_sum_kernel(torch.zeros(3, 4))
    assert fused_fields_bwd_kernel.launches == 0 and block_sum_kernel.launches == 0
