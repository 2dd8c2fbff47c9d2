"""Port parity, host layer: the PyTorch port's offline f64 arrays equal the
JAX package's at poisson2d_scaled and poisson2d_quality.

Both sides run the same numpy arithmetic, so the tolerance is float64
roundoff: rtol 1e-13, atol 1e-14."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import hpvpinns_tpu as jv  # noqa: E402
import hpvpinns_tpu_torch as tv  # noqa: E402

jmesh = importlib.import_module("hpvpinns_tpu.geometry.mesh")
jbuild = importlib.import_module("hpvpinns_tpu.problems.build")
jp2d = importlib.import_module("hpvpinns_tpu.problems.poisson2d")
jbasis = importlib.import_module("hpvpinns_tpu.spectral.basis")
jjac = importlib.import_module("hpvpinns_tpu.spectral.jacobi")
jquad = importlib.import_module("hpvpinns_tpu.spectral.quadrature")
jsamp = importlib.import_module("hpvpinns_tpu.utils.sampling")
tmesh = importlib.import_module("hpvpinns_tpu_torch.geometry.mesh")
tbuild = importlib.import_module("hpvpinns_tpu_torch.problems.build")
tp2d = importlib.import_module("hpvpinns_tpu_torch.problems.poisson2d")
tbasis = importlib.import_module("hpvpinns_tpu_torch.spectral.basis")
tjac = importlib.import_module("hpvpinns_tpu_torch.spectral.jacobi")
tquad = importlib.import_module("hpvpinns_tpu_torch.spectral.quadrature")
tsamp = importlib.import_module("hpvpinns_tpu_torch.utils.sampling")

TOL = dict(rtol=1e-13, atol=1e-14)
PRESETS = {
    "poisson2d_scaled": (jv.poisson2d_scaled, tv.poisson2d_scaled),
    "poisson2d_quality": (jv.poisson2d_quality, tv.poisson2d_quality),
}


def close(a, b):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), **TOL)


@pytest.mark.parametrize("n,a,b,k", [(7, 0.0, 0.0, 1), (9, 1.0, 1.0, 2), (4, 2.0, 2.0, 1), (1, 0.0, 0.0, 3)])
def test_jacobi_matches_jax(n, a, b, k):
    x = np.linspace(-1.0, 1.0, 37)
    close(tjac.jacobi_all(n, a, b, x), jjac.jacobi_all(n, a, b, x))
    close(tjac.jacobi(n, a, b, x), jjac.jacobi(n, a, b, x))
    close(tjac.djacobi(n, a, b, x, k), jjac.djacobi(n, a, b, x, k))


@pytest.mark.parametrize("Q", [2, 6, 16, 40])
def test_quadrature_matches_jax(Q):
    for t, j in zip(tquad.gauss_lobatto_jacobi(Q, 0.0, 0.0), jquad.gauss_lobatto_jacobi(Q, 0.0, 0.0)):
        close(t, j)
    for t, j in zip(tquad.gauss_lobatto_jacobi(Q, 1.0, 0.5), jquad.gauss_lobatto_jacobi(Q, 1.0, 0.5)):
        close(t, j)
    for t, j in zip(tquad.gauss_jacobi(Q, 0.0, 0.0), jquad.gauss_jacobi(Q, 0.0, 0.0)):
        close(t, j)


def test_sampling_matches_jax_bit_for_bit():
    t = tsamp.lhs_box([(-1.0, 1.0), (0.0, 2.0)], 50, np.random.default_rng(3))
    j = jsamp.lhs_box([(-1.0, 1.0), (0.0, 2.0)], 50, np.random.default_rng(3))
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("preset", sorted(PRESETS))
def test_offline_arrays_match_jax(preset):
    jcfg, tcfg = (f() for f in PRESETS[preset])
    xq_t, wq_t = tquad.gauss_lobatto_jacobi(tcfg.n_quad, 0.0, 0.0)
    xq_j, wq_j = jquad.gauss_lobatto_jacobi(jcfg.n_quad, 0.0, 0.0)
    close(xq_t, xq_j)
    close(wq_t, wq_j)

    tb, jb = tbasis.make_test_basis(tcfg.n_test_x, xq_t), jbasis.make_test_basis(jcfg.n_test_x, xq_j)
    for name in ("phi", "dphi", "d2phi", "phi_b", "dphi_b", "d2phi_b"):
        close(getattr(tb, name), getattr(jb, name))

    wt = tbuild.make_weighted_basis(tcfg.n_test_x, xq_t, wq_t, torch.float64)
    wj = jbuild.make_weighted_basis(jcfg.n_test_x, xq_j, wq_j, jnp.float64)
    for name in ("wphi", "wdphi", "wd2phi", "dphi_b"):
        close(getattr(wt, name), getattr(wj, name))

    mt = tmesh.TensorMesh2D.uniform(*tcfg.domain_x, tcfg.n_elements_x, *tcfg.domain_y, tcfg.n_elements_y)
    mj = jmesh.TensorMesh2D.uniform(*jcfg.domain_x, jcfg.n_elements_x, *jcfg.domain_y, jcfg.n_elements_y)
    ntx = np.full(tcfg.n_elements_x, tcfg.n_test_x)
    nty = np.full(tcfg.n_elements_y, tcfg.n_test_y)
    et = tbuild.build_elements_2d(mt, xq_t, wq_t, xq_t, wq_t, tp2d.f_rhs, ntx, nty, torch.float64)
    ej = jbuild.build_elements_2d(mj, xq_j, wq_j, xq_j, wq_j, jp2d.f_rhs, ntx, nty, jnp.float64)
    for name in ("x", "y", "bounds_x", "bounds_y", "jac_x", "jac_y", "f_proj", "mask", "n_test"):
        close(getattr(et, name), getattr(ej, name))
    assert et.x.shape == (tcfg.n_elements_x * tcfg.n_elements_y, tcfg.n_quad, tcfg.n_quad)

    Xb_t, ub_t = tp2d.boundary_points(tcfg, np.random.default_rng(tcfg.train.seed))
    Xb_j, ub_j = jp2d.boundary_points(jcfg, np.random.default_rng(jcfg.train.seed))
    np.testing.assert_array_equal(Xb_t, Xb_j)
    close(ub_t, ub_j)


def test_test_mask_matches_jax():
    nt = np.array([3, 5, 1, 4])
    for t, j in zip(tbuild._test_mask(nt, 5), jbuild._test_mask(nt, 5)):
        np.testing.assert_array_equal(t, j)


def test_nonuniform_mesh_matches_jax():
    grid = (-1.0, -0.1, 0.1, 1.0)
    mt = tmesh.TensorMesh2D(tmesh.Interval1D(np.array(grid)), tmesh.Interval1D.uniform(-1, 1, 2))
    mj = jmesh.TensorMesh2D(jmesh.Interval1D(np.array(grid)), jmesh.Interval1D.uniform(-1, 1, 2))
    xi = np.linspace(-1, 1, 5)
    for t, j in zip(mt.map_points(xi, xi), mj.map_points(xi, xi)):
        close(t, j)
    for t, j in zip(mt.jacobians(), mj.jacobians()):
        close(t, j)
    for t, j in zip(mt.element_bounds(), mj.element_bounds()):
        close(t, j)
