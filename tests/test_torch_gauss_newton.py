"""Port parity, the Gauss-Newton/LM phase (training/gauss_newton.py): the
residual vector, its Jacobian, the five damped solves and the LM loop
against the JAX package in float64 on the CPU, from the same numpy
parameters, at small sizes; and deriv_mode="pallas" under it.

Measured: r and J agree to ~1e-15 in every family, the dense solves to
~1e-12, five LM steps' records to ~1e-13.  CG and LSQR agree to ~1e-11 on
systems where they converge cleanly (below); where the damping leaves the
normal operator ill-conditioned (lambda 1e-3 on the 356 x 105 Poisson-2D
system) the two packages' iterates differ by ~1e-6 from rounding in the
Jacobian products, and on the dual 32 x 105 system LSQR stops after 22
iterations in the port and 25 in JAX.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

import hpvpinns_tpu as jv  # noqa: E402
import hpvpinns_tpu_torch as tv  # noqa: E402
from hpvpinns_tpu_torch.ops.fused_fields import FORWARD_MODE_ERROR  # noqa: E402
from hpvpinns_tpu_torch.problems.base import parameters  # noqa: E402
from test_torch_parity import ADV, one_torch_thread, shared_params, tnp, to_jax  # noqa: E402

jgn = importlib.import_module("hpvpinns_tpu.training.gauss_newton")
tgn = importlib.import_module("hpvpinns_tpu_torch.training.gauss_newton")

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


TIGHT = dict(rtol=1e-10, atol=1e-13)
SOLVE = 1e-9
P2 = dict(n_elements_x=2, n_elements_y=2, n_quad=6, n_test_x=3, n_test_y=3, layers=(2, 8, 8, 1), dtype="float64")
P1 = dict(layers=(1, 8, 8, 1), n_test=5, n_quad=12, dtype="float64")
BOX = dict(n_elements_y=1, n_quad=5, n_test_x=3, n_test_y=3, layers=(2, 6, 6, 1), n_bound=6, dtype="float64")
# (JAX config, port config, fields, whether M < P): every family, primal and dual
FAMILIES = {
    "poisson1d": ("Poisson1DConfig", P1, True),
    "poisson2d_hard_bc": ("Poisson2DConfig", dict(P2, layers=(2, 6, 6, 1), hard_bc=True), False),
    "poisson3d": ("Poisson3DConfig", dict(n_quad=4, n_test_x=2, n_test_y=2, n_test_z=2, n_elements_x=1,
                                          n_elements_y=1, n_elements_z=1, layers=(3, 5, 1), n_bound=6,
                                          dtype="float64"), False),
    "helmholtz2d_inverse": ("Helmholtz2DConfig", dict(BOX, n_sensors=7, inverse=True), True),
    "advdiff_scalar_eps": ("AdvDiffConfig", dict(ADV), True),
    "advdiff_eps_field": ("AdvDiffConfig", dict(ADV, epsilon_model="mlp", epsilon_reg=1e-2), True),
    "advdiff_layer_feature": ("AdvDiffConfig", dict(ADV, inverse=False, layer_feature=True), True),
    "advdiff2d": ("AdvDiff2DConfig", dict(n_quad=4, n_test_x=2, n_test_y=2, n_test_t=2, layers=(3, 5, 1), n_bound=6,
                                          n_sensors_per_station=3, t_final=0.5, dtype="float64"), False),
    "burgers_strong": ("BurgersConfig", dict(n_elements_x=2, n_elements_t=1, n_quad=5, n_test_x=3, n_test_t=3,
                                             layers=(2, 6, 6, 1), n_bound=6, n_strong=10, t_final=0.5,
                                             dtype="float64"), True),
}


def _config(family, **kw):
    name, cfg, _ = FAMILIES[family] if family in FAMILIES else (family, {}, None)
    return name, {**cfg, **kw}


def build_port(family, **kw):
    name, cfg = _config(family, **kw)
    return tv.build(getattr(tv, name)(**cfg), device="cpu")


def build_both(family, **kw):
    name, cfg = _config(family, **kw)
    return jv.build(getattr(jv, name)(**cfg)), build_port(family, **kw)


class System:
    """A problem in both packages at the same parameters, with each
    package's flat parameters, kernels and (r, J) there."""

    def __init__(self, jprob, tprob, **kernel_kw):
        self.jprob, self.tprob = jprob, tprob
        tree = shared_params(tprob)
        self.jparams, self.tparams = to_jax(tree), tv.params_from_jax(tree, dtype=torch.float64)
        self.jres, self.tres = jgn.make_residual_vector(jprob), tgn.make_residual_vector(tprob)
        self.jtheta, junravel = ravel_pytree(self.jparams)
        self.ttheta, self.tunravel = tgn.ravel_params(self.tparams)
        self.M, self.P = self.tres(self.tparams, tprob.data).numel(), int(self.jtheta.size)
        self.jk = jgn._build_kernels(self.jres, junravel, jprob.data, self.P, self.M, **kernel_kw)
        self.tk = tgn._build_kernels(self.tres, self.tunravel, tprob.data, self.P, self.M, **kernel_kw)
        self.jrJ = self.jk[0](self.jtheta, jprob.data)
        self.trJ = self.tk[0](self.ttheta)


@pytest.fixture(scope="module")
def systems():
    """"primal": Poisson-2D, M 356 > P 105 (J by forward mode); "dual":
    Poisson-1D, M 7 < P 97 (J by reverse mode)."""
    return {"primal": System(*build_both("Poisson2DConfig", **P2)), "dual": System(*build_both("poisson1d"))}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_residual_vector_and_jacobian_match_jax(family):
    """sum(r^2) is the loss (the identity gauss_newton checks), and r and J
    equal the JAX package's, column for column in its ravel_pytree order."""
    s = System(*build_both(family))
    assert (s.M < s.P) == FAMILIES[family][2]
    np.testing.assert_array_equal(tnp(s.ttheta), np.asarray(s.jtheta))
    r, J = s.trJ
    loss = s.tprob.loss_fn(s.tparams, s.tprob.data)[0]
    np.testing.assert_allclose(tnp(torch.sum(r * r)), tnp(loss), rtol=1e-12)
    jr, jJ = (np.asarray(a) for a in s.jrJ)
    np.testing.assert_allclose(tnp(r), jr, rtol=1e-10, atol=1e-13 * np.abs(jr).max())
    np.testing.assert_allclose(tnp(J), jJ, rtol=1e-10, atol=1e-13 * np.abs(jJ).max())


@pytest.mark.parametrize("kind", ["primal", "dual"])
def test_chunked_jacobian_equals_the_whole_one(systems, kind):
    s = systems[kind]
    r, J = tgn._build_kernels(s.tres, s.tunravel, s.tprob.data, s.P, s.M, jac_chunk=3)[0](s.ttheta)
    np.testing.assert_array_equal(tnp(r), tnp(s.trJ[0]))
    np.testing.assert_allclose(tnp(J), tnp(s.trJ[1]), rtol=1e-14, atol=1e-15)


def _close(got, want, err_msg=""):
    want = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), want, rtol=SOLVE,
                               atol=SOLVE * max(np.abs(want).max(), 1e-300), err_msg=err_msg)


@pytest.mark.parametrize("kind", ["primal", "dual"])
@pytest.mark.parametrize("solve", ["normal", "host", "qr"])
def test_dense_solves_match_jax(systems, kind, solve):
    """delta, the predicted decrease and |J^T r|_inf of one damped step on
    the same (r, J, lambda), to rtol 1e-9."""
    s = systems[kind]
    lam = 1e-3
    want = s.jk[2][solve](*s.jrJ, jnp.asarray(lam))
    got = s.tk[2][solve](*s.trJ, torch.tensor(lam, dtype=torch.float64))
    for name, g, w in zip(("delta", "pred_decrease", "grad_inf"), got, want):
        _close(tnp(g) if torch.is_tensor(g) else g, w, name)


@pytest.mark.parametrize("kind, lam", [("dual", 1e-3), ("dual", 1e-2), ("primal", 1.0)])
@pytest.mark.parametrize("solve", ["cg", "lsqr"])
def test_matrix_free_solves_match_jax(systems, solve, kind, lam):
    """CG and LSQR stop at JAX's iteration, with its delta, predicted
    decrease and |J^T r|_inf (rtol 1e-9), where the damped system is well
    enough conditioned for rounding not to steer the iterates (module
    docstring)."""
    s = systems[kind]
    want = s.jk[2][solve](s.jtheta, jnp.asarray(lam), s.jprob.data)
    got = s.tk[2][solve](s.ttheta, torch.tensor(lam, dtype=torch.float64))
    assert got[3] == int(want[3]) > 1
    for name, g, w in zip(("delta", "pred_decrease", "grad_inf"), got[:3], want[:3]):
        _close(tnp(g), w, name)


@pytest.mark.parametrize("kind, solve, steps", [("primal", None, 5), ("dual", None, 5), ("dual", "qr", 5),
                                                ("dual", "host", 5), ("dual", "cg", 1), ("dual", "lsqr", 1)])
def test_lm_records_match_jax(systems, kind, solve, steps):
    """Accepted LM steps: the accepted/rejected count, why it stopped, and
    every record (damping, loss, lossb, lossv; CG iterations for the
    matrix-free solves) to rtol 1e-8.  Five steps for the dense solves; one
    for CG and LSQR, whose iterates drift apart from rounding as the damping
    falls (module docstring; measured 4e-7 in the loss after five CG steps)."""
    s = systems[kind]
    kw = dict(iterations=steps, solve=solve, verbose=False)
    jres = jgn.gauss_newton(s.jprob, s.jparams, **kw)
    tres = tv.gauss_newton(s.tprob, s.tparams, **kw)
    assert (tres.accepted, tres.iterations_run, tres.stopped) == (jres.accepted, jres.iterations_run, jres.stopped)
    assert tres.accepted == steps and sorted(tres.history) == sorted(jres.history)
    for k in jres.history:
        np.testing.assert_allclose(tres.history[k], jres.history[k], rtol=1e-8, err_msg=k)
    loss = tres.history["loss"]
    assert np.all(np.diff(loss) < 0) and loss[0] < float(s.tprob.loss_fn(s.tparams, s.tprob.data)[0].detach())
    np.testing.assert_allclose(tres.final_aux["loss"], jres.final_aux["loss"], rtol=1e-8)
    for a, b in zip(jax.tree.leaves(jres.params), parameters(tres.params)):
        np.testing.assert_allclose(tnp(b), np.asarray(a), rtol=1e-7, atol=1e-9)


def test_failed_factorizations_reject_the_step(systems):
    """"host": a J that is not finite, or a damped system that is not
    positive definite, gives delta None in both packages (the loop then
    rejects and inflates lambda); "normal" gives a NaN step, which the loop
    rejects as JAX's does."""
    s = systems["dual"]
    (r, J), (jr, jJ) = s.trJ, s.jrJ
    bad_J, bad_jJ = J.clone(), np.array(jJ)
    bad_J[0, 0], bad_jJ[0, 0] = float("nan"), np.nan
    for (tr, tJ, jr_, jJ_), lam in (((r, bad_J, jr, jnp.asarray(bad_jJ)), 1e-3), ((r, J, jr, jJ), -1e3)):
        assert s.jk[2]["host"](jr_, jJ_, jnp.asarray(lam))[0] is None
        assert s.tk[2]["host"](tr, tJ, torch.tensor(lam, dtype=torch.float64)) == (None, 0.0, float("inf"))
    delta, pred, _ = s.tk[2]["normal"](r, J, torch.tensor(-1e3, dtype=torch.float64))
    assert torch.isnan(delta).all() and not bool(pred > 0)


@pytest.mark.parametrize("solve", [None, "cg", "lsqr"])
def test_pallas_forward_mode_raises_like_jax(solve):
    """Under deriv_mode="pallas" the forward-mode Jacobian (P <= M: here
    M 22, P 10) raises in JAX (jacfwd of a custom_vjp) and in the port
    (the kernels have no JVP); so do the port's matrix-free solves, which
    need J v, on a system whose dense Jacobian is the dual one."""
    cfg = dict(layers=(1, 3, 1), n_test=20, n_quad=30, deriv_mode="pallas", dtype="float32")
    if solve is None:
        jprob, tprob = jv.build(jv.Poisson1DConfig(**cfg)), tv.build(tv.Poisson1DConfig(**cfg), device="cpu")
        theta, unravel = ravel_pytree(jprob.init_params(jax.random.key(0)))
        res = jgn.make_residual_vector(jprob)
        r_and_J = jgn._build_kernels(res, unravel, jprob.data, theta.size, 22)[0]  # gauss_newton's J build
        with pytest.raises(TypeError, match="forward-mode"):
            r_and_J(theta, jprob.data)
    else:
        tprob = tv.build(tv.Poisson1DConfig(**dict(cfg, layers=(1, 8, 8, 1), n_test=5)), device="cpu")
    params = tprob.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(TypeError, match=FORWARD_MODE_ERROR[:40]):
        tv.gauss_newton(tprob, params, iterations=1, solve=solve, verbose=False)


@pytest.mark.parametrize("family, kw", [("poisson1d", {}), ("Poisson2DConfig", dict(P2, n_test_x=2, n_test_y=2,
                                                                                    n_bound=4))])
def test_pallas_dual_jacobian_equals_taylor(family, kw):
    """The reverse-mode Jacobian under "pallas" (B2 for each cotangent on the
    card; on the CPU its plain version, and for Poisson-2D's var_form 1 the
    firsts-only VJP) equals the "taylor" one, and an LM step runs on it."""
    out = {}
    for mode in ("taylor", "pallas"):
        tprob = build_port(family, **kw, deriv_mode=mode)
        params = tv.params_from_jax(shared_params(tprob), dtype=torch.float64)
        theta, unravel = tgn.ravel_params(params)
        res = tgn.make_residual_vector(tprob)
        M = res(params, tprob.data).numel()
        assert M < theta.numel()
        out[mode] = tgn._build_kernels(res, unravel, tprob.data, theta.numel(), M)[0](theta)
    for a, b in zip(out["pallas"], out["taylor"]):
        np.testing.assert_allclose(tnp(a), tnp(b), rtol=1e-10, atol=1e-13 * np.abs(tnp(b)).max())
    gn = tv.gauss_newton(tprob, params, iterations=2, verbose=False)
    assert gn.accepted == 2


def test_advdiff_precision_from_the_jax_draw_lands_on_jax():
    """advdiff_precision whole (float64: Adam 1,500, then 150 LM steps), the
    port from the JAX package's own initial draw: every record and the
    identified eps equal JAX's to rtol 1e-7 (measured ~1e-9).  So the port's
    miss on the card from its own draw (ROADMAP C14) is the draw's."""
    jcfg, tcfg = jv.advdiff_precision(), tv.advdiff_precision()
    jprob, tprob = jv.build(jcfg), tv.build(tcfg, device="cpu")
    p0 = jprob.init_params(jax.random.key(jcfg.train.seed))
    jres = jv.train(jprob, params=p0, verbose=False)
    tres = tv.train(tprob, params=tv.params_from_jax(jax.tree.map(np.asarray, p0), dtype=torch.float64),
                    verbose=False)
    assert tres.iterations_run == jres.iterations_run and tres.phases["gn"]["accepted"] == 150
    for k in ("iteration", "loss", "epsilon"):
        np.testing.assert_allclose(tres.history[k], jres.history[k], rtol=1e-7, err_msg=k)
    eps, jeps = float(tprob.extras["eps_domain_mean"](tres.eval_params).detach()), float(
        jprob.extras["eps_domain_mean"](jres.eval_params))
    np.testing.assert_allclose(eps, jeps, rtol=1e-7)
