"""Port parity, fused field kernel (ops/fused_fields.py).

On the CPU, `fields_flat` runs the kernel's plain PyTorch version; it is held
against the JAX package's `fields_flat`, whose Pallas kernel runs in
interpret mode here exactly as tests/test_pallas_fields.py runs it.  float32,
with that file's tolerances: rtol 2e-5 / atol 1e-6 for fields, rtol 2e-4 /
atol 1e-5 for gradients.  The CUDA kernel itself runs only on a GPU
(chip_smoke.py holds it against the same plain version there)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hpvpinns_tpu.models.mlp import MLP as JMLP  # noqa: E402
from hpvpinns_tpu.ops.pallas_fields import fields_flat as jfields_flat  # noqa: E402
from hpvpinns_tpu.ops.pallas_fields import pallas_fields_2d  # noqa: E402
from hpvpinns_tpu_torch.convert import params_from_jax  # noqa: E402
from hpvpinns_tpu_torch.models.mlp import MLP, init_mlp  # noqa: E402
from hpvpinns_tpu_torch.ops.fused_fields import (  # noqa: E402
    MAX_WIDTH,
    check_kernel_args,
    fields_flat,
    fields_flat_reference,
    fused_fields_2d,
    fused_fields_kernel,
    pack_params,
)

FIELD_TOL = dict(rtol=2e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=1e-5)
SLICE = (2, 20, 20, 20, 1)


def make(layers, act, seed=0):
    """One network for both packages: Xavier-scaled normal weights and small
    biases from numpy, handed to JAX as arrays and to the port through
    params_from_jax."""
    rng = np.random.default_rng(seed)
    tree = {"net": [
        {"W": (rng.standard_normal((a, b)) * np.sqrt(2.0 / (a + b))).astype(np.float32),
         "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
        for a, b in zip(layers[:-1], layers[1:])
    ], "pde": {}}
    jp = jax.tree.map(jnp.asarray, tree["net"])
    tp = params_from_jax(tree, dtype=torch.float32)["net"]
    return JMLP(layers=layers, activation=act), jp, MLP(layers=layers, activation=act), tp


def inputs(P, d, seed=1):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (P, d)).astype(np.float32)


@pytest.mark.parametrize(
    "layers,act,n_dirs,second",
    [
        (SLICE, "tanh", 2, False),  # the slice: var_form 1, d = 2
        ((1, 12, 12, 1), "sin", 1, True),
        ((3, 16, 16, 1), "sin", 3, True),
    ],
)
def test_fields_flat_matches_jax_pallas(layers, act, n_dirs, second):
    jspec, jp, spec, tp = make(layers, act)
    X = inputs(150, layers[0])
    got = fields_flat(spec, tp, torch.as_tensor(X), n_dirs, second)
    want = np.asarray(jfields_flat(jspec, jp, jnp.asarray(X), n_dirs, second))
    assert got.shape == want.shape == (150, 1 + n_dirs * (2 if second else 1))
    np.testing.assert_allclose(got.detach().numpy(), want, **FIELD_TOL)


def test_fields_flat_gradient_matches_jax():
    """second=False backward (autograd through the Taylor propagation) vs
    jax.grad of the JAX fields_flat (its XLA-Taylor VJP)."""
    jspec, jp, spec, tp = make(SLICE, "tanh", seed=3)
    X = inputs(150, 2, seed=4)
    g = np.random.default_rng(5).standard_normal((150, 3)).astype(np.float32)
    Xt = torch.as_tensor(X).requires_grad_(True)
    (fields_flat(spec, tp, Xt, 2, False) * torch.as_tensor(g)).sum().backward()
    jg_p, jg_x = jax.grad(
        lambda p, x: (jfields_flat(jspec, p, x, 2, False) * g).sum(), argnums=(0, 1)
    )(jp, jnp.asarray(X))
    np.testing.assert_allclose(Xt.grad.numpy(), np.asarray(jg_x), **GRAD_TOL)
    for t, j in zip(tp, jg_p):
        for k in ("W", "b"):
            np.testing.assert_allclose(t[k].grad.numpy(), np.asarray(j[k]), **GRAD_TOL)


def test_fused_fields_2d_contract_matches_jax():
    jspec, jp, spec, tp = make(SLICE, "tanh", seed=6)
    x, y = inputs(150, 2, seed=7).T.reshape(2, 3, 50)
    for kw in ({"firsts_only": True}, {}, {"first_y_only": True}):
        tf = fused_fields_2d(spec, tp, torch.as_tensor(x), torch.as_tensor(y), **kw)
        jf = pallas_fields_2d(jspec, jp, jnp.asarray(x), jnp.asarray(y), **kw)
        assert sorted(tf) == sorted(jf)
        for k in tf:
            np.testing.assert_allclose(tf[k].detach().numpy(), np.asarray(jf[k]), **FIELD_TOL, err_msg=k)


def test_second_derivative_backward_is_b2_and_raises():
    spec = MLP(layers=(1, 8, 1), activation="sin")
    tp = init_mlp(spec, torch.Generator().manual_seed(0))
    X = torch.as_tensor(inputs(10, 1))
    out = fields_flat(spec, tp, X, 1, True)
    with pytest.raises(NotImplementedError, match="B2"):
        out.sum().backward()


def test_plain_version_is_the_taylor_propagation_in_f64():
    """fields_flat on a CPU tensor keeps the caller's dtype (float64 here) and
    equals fields_flat_reference exactly."""
    spec = MLP(layers=(2, 8, 8, 1), activation="tanh")
    tp = init_mlp(spec, torch.Generator().manual_seed(0), dtype=torch.float64)
    X = torch.as_tensor(inputs(20, 2)).double()
    out = fields_flat(spec, tp, X, 2, False)
    assert out.dtype == torch.float64
    torch.testing.assert_close(out, fields_flat_reference(spec, tp, X, 2, False), rtol=0, atol=0)


def test_pack_params_layout():
    spec = MLP(layers=(2, 5, 3, 1))
    tp = init_mlp(spec, torch.Generator().manual_seed(0))
    packed, widths = pack_params(spec, tp)
    assert widths.dtype == np.int32 and widths.tolist() == [2, 5, 3, 1]
    assert packed.is_contiguous() and packed.numel() == 2 * 5 + 5 + 5 * 3 + 3 + 3 * 1 + 1
    off = 0
    for layer in tp:  # W_l [in, out] row-major, then b_l
        for t in (layer["W"], layer["b"]):
            np.testing.assert_array_equal(packed[off : off + t.numel()].detach().numpy(), t.detach().reshape(-1).numpy())
            off += t.numel()


def test_kernel_rejects_what_it_does_not_take():
    """The kernel wrapper raises before any launch: on a CPU tensor (the
    plain version is taken only by fields_flat, never by the kernel), above
    the widest width, and for a non-scalar output."""
    spec = MLP(layers=(2, 8, 1))
    tp = init_mlp(spec, torch.Generator().manual_seed(0))
    X = torch.as_tensor(inputs(4, 2))
    with pytest.raises(ValueError, match="CUDA"):
        fused_fields_kernel(spec, tp, X, 2, False)
    assert fused_fields_kernel.launches == 0
    wide = MLP(layers=(2, MAX_WIDTH + 1, 1))
    with pytest.raises(ValueError, match=f"widths <= {MAX_WIDTH}"):
        check_kernel_args(wide, [], X, 2)
    with pytest.raises(ValueError, match="scalar output"):
        check_kernel_args(MLP(layers=(2, 8, 2)), [], X, 2)
    with pytest.raises(ValueError, match="n_dirs"):
        check_kernel_args(MLP(layers=(1, 8, 1)), [], X, 2)
