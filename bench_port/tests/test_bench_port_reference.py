"""The plain reference (bench_port/reference/poisson2d.py) against the
port's "taylor" path, in float64 on the CPU at small sizes: the quadrature,
the test basis, the right-hand side, the loss, its gradients and three Adam
steps.  Only this test imports both."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import hpvpinns_tpu_torch as tv
from bench_port import cell as cells
from bench_port.reference import poisson2d as ref
from hpvpinns_tpu_torch.problems import poisson2d as port_poisson2d
from hpvpinns_tpu_torch.problems.base import parameters
from hpvpinns_tpu_torch.spectral.basis import make_test_basis
from hpvpinns_tpu_torch.spectral.quadrature import gauss_lobatto_jacobi
from hpvpinns_tpu_torch.training.trainer import _build_chunk, make_optimizer

# uneven element counts, so that a mix-up of the element order shows
FIELDS = dict(layers=[2, 8, 8, 1], activation="tanh", var_form=1, n_elements_x=3, n_elements_y=2, n_test_x=4,
              n_test_y=4, n_quad=7, n_bound=12, lossb_weight=10.0)
LR = 1e-3


def _setup(seed=3):
    given = ref.inputs(FIELDS, np.random.default_rng(seed))
    cfg = tv.Poisson2DConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in FIELDS.items()},
                             dtype="float64", deriv_mode="taylor", train=tv.TrainConfig(learning_rate=LR))
    prob = tv.build(cfg, device="cpu")
    for k, v in given.items():
        prob.data[k] = torch.as_tensor(v, dtype=torch.float64)
    w = [(W.double(), b.double()) for W, b in cells.weights(FIELDS["layers"], 1, seed, "cpu")]
    mine = ref.build(FIELDS, given["xb"])
    return prob, w, mine


def _port_params(w):
    return {"net": [{"W": torch.nn.Parameter(W[0].clone()), "b": torch.nn.Parameter(b[0].clone())} for W, b in w],
            "pde": {}}


@pytest.mark.parametrize("q", [3, 7, 16])
def test_quadrature_matches_the_port_and_is_exact(q):
    x, w = ref.gll(q)
    px, pw = gauss_lobatto_jacobi(q, 0.0, 0.0)
    np.testing.assert_allclose(x, px, rtol=0, atol=1e-14)
    np.testing.assert_allclose(w, pw, rtol=1e-13)
    for degree in range(2 * q - 2):  # exact to degree 2q - 3
        assert float(np.sum(w * x**degree)) == pytest.approx((1 + (-1) ** degree) / (degree + 1), abs=1e-13)


def test_test_basis_matches_the_port():
    x, _ = ref.gll(9)
    phi, dphi = ref.test_functions(6, x)
    tb = make_test_basis(6, x)
    np.testing.assert_allclose(phi, tb.phi, atol=1e-13)
    np.testing.assert_allclose(dphi, tb.dphi, atol=1e-12)
    np.testing.assert_allclose(phi[:, [0, -1]], 0.0, atol=1e-15)  # every test function vanishes at the ends


def test_data_matches_the_port():
    prob, _, mine = _setup()
    el = prob.data["elements"]
    np.testing.assert_allclose(mine.rhs.numpy(), el.f_proj.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(mine.jac_x.numpy(), el.jac_x.numpy())
    np.testing.assert_allclose(mine.jac_y.numpy(), el.jac_y.numpy())
    pts = np.stack([el.x.numpy().reshape(-1), el.y.numpy().reshape(-1)], axis=-1)
    np.testing.assert_allclose(mine.points.numpy(), pts, atol=1e-15)
    xy = np.random.default_rng(0).uniform(-1, 1, (50, 2))
    np.testing.assert_allclose(ref.u_exact(xy[:, :1], xy[:, 1:]), port_poisson2d.u_exact(xy[:, :1], xy[:, 1:]))
    np.testing.assert_allclose(ref.f_source(xy[:, :1], xy[:, 1:]), port_poisson2d.f_rhs(xy[:, :1], xy[:, 1:]),
                               rtol=1e-12, atol=1e-12)


def test_loss_and_gradients_match_the_port_taylor_path():
    prob, w, mine = _setup()
    params = _port_params(w)
    loss, _ = prob.loss_fn(params, prob.data)
    grads = torch.autograd.grad(loss, parameters(params))
    layers = [(W[0].clone().requires_grad_(True), b[0].clone().requires_grad_(True)) for W, b in w]
    value = ref.loss(mine, layers)
    want = torch.autograd.grad(value, [t for layer in layers for t in layer])
    assert float(value.detach()) == pytest.approx(float(loss.detach()), rel=1e-12)
    for g, h in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), h.numpy(), rtol=1e-9, atol=1e-12 * float(h.abs().max()))


def test_three_adam_steps_match_the_port():
    prob, w, mine = _setup(seed=8)
    params = _port_params(w)
    opt = make_optimizer(prob.config.train, params)
    chunk = _build_chunk(prob.loss_fn, opt, params, prob.data)
    start = [t.detach().clone() for t in parameters(params)]
    losses = [float(chunk(0)["loss"])] + [float(chunk(1)["loss"]) for _ in range(3)]
    r = ref.adam_readings(mine, [(W[0], b[0]) for W, b in w], LR, 3)
    np.testing.assert_allclose(losses, r["loss"], rtol=1e-12)
    for t, s, c in zip(parameters(params), start, r["change"]):
        np.testing.assert_allclose((t.detach() - s).numpy(), c.numpy(), rtol=1e-7, atol=1e-13)


def test_half_batch_fault_drops_half_the_elements():
    # |f| is even in x and the first half of the elements is the left half of the
    # domain, so the loss barely moves; its gradient does
    _, w, mine = _setup()
    whole, half = (ref.adam_readings(mine, [(W[0], b[0]) for W, b in w], LR, 1, half=h) for h in (False, True))
    gap = max(float(abs(a.norm() - b.norm()) / b.norm()) for a, b in zip(half["grad"], whole["grad"]))
    assert gap > 0.01  # rounding moves it by ~1e-15


def test_the_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "math", "dataclasses", "numpy", "numpy.polynomial", "torch"}
    for path in (Path(ref.__file__).parent).glob("*.py"):
        tree = ast.parse(path.read_text())
        names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
        assert names <= allowed, (path.name, names - allowed)
