"""Port parity, the trainer: Adam then L-BFGS, the reference's argument
orders and manufactured solutions, the CPU chunk and the profiling helpers,
against the JAX package in float64 on the CPU, at a small size (2x2
elements, 6 quadrature points, 3x3 test functions, a (2,8,8,1) tanh net),
from the same JAX-initialised parameters.

The Adam phase is the same arithmetic in both packages: its records agree
to rtol 1e-12 (measured ~1e-16).  The L-BFGS phase is not: torch's strong
Wolfe line search and first step differ from optax's zoom line search and
initial scaling, so it is held to its structure (the iteration count
carried on across phases, a loss that does not increase from record to
record, an end below the end of Adam) and to the final loss within 0.05 in
log10 of JAX's (measured 0.012 after 20 + 20 iterations).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import hpvpinns_tpu as jv  # noqa: E402
import hpvpinns_tpu_torch as tv  # noqa: E402
from hpvpinns_tpu.problems import poisson1d as jp1d  # noqa: E402
from hpvpinns_tpu.problems import poisson2d as jp2d  # noqa: E402
from hpvpinns_tpu.utils import profiling as jprof  # noqa: E402
from hpvpinns_tpu_torch.problems import poisson1d as tp1d  # noqa: E402
from hpvpinns_tpu_torch.problems import poisson2d as tp2d  # noqa: E402
from hpvpinns_tpu_torch.problems.base import parameters  # noqa: E402
from hpvpinns_tpu_torch.training.trainer import _build_chunk, _build_stepwise_chunk, make_optimizer  # noqa: E402
from hpvpinns_tpu_torch.utils import profiling as tprof  # noqa: E402

SMALL = dict(
    n_elements_x=2, n_elements_y=2, n_quad=6, n_test_x=3, n_test_y=3,
    layers=(2, 8, 8, 1), dtype="float64",
)
N_ADAM, N_LBFGS, CHECK = 20, 20, 10
LOG10_LOSS_TOL = 0.05


def configs(**train):
    kw = {"iterations": N_ADAM, "lbfgs_iterations": N_LBFGS, "check_every": CHECK, **train}
    return (jv.Poisson2DConfig(**SMALL, train=jv.TrainConfig(**kw)),
            tv.Poisson2DConfig(**SMALL, train=tv.TrainConfig(**kw)))


def tnp(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def jax_run():
    """JAX's two-phase run from its own init, with best_snapshot_fraction
    1.0: (problem, numpy params it started from, result)."""
    jcfg, _ = configs(best_snapshot_fraction=1.0)
    prob = jv.build(jcfg)
    params = prob.init_params(jax.random.key(0))
    return prob, jax.tree.map(np.asarray, params), jv.train(prob, params=params, verbose=False)


def port_run(np_params, **train):
    _, tcfg = configs(**train)
    prob = tv.build(tcfg, device="cpu")
    return prob, tv.train(prob, params=tv.params_from_jax(np_params, dtype=torch.float64), verbose=False)


def test_two_phase_structure_matches_jax(jax_run):
    _, np_params, jres = jax_run
    _, res = port_run(np_params, best_snapshot_fraction=1.0)
    want = np.arange(CHECK, N_ADAM + N_LBFGS + 1, CHECK)
    np.testing.assert_array_equal(res.history["iteration"], want)
    np.testing.assert_array_equal(jres.history["iteration"], want)
    assert res.iterations_run == jres.iterations_run == N_ADAM + N_LBFGS
    adam = N_ADAM // CHECK
    for k in ("loss", "lossb", "lossv"):
        np.testing.assert_allclose(res.history[k][:adam], jres.history[k][:adam], rtol=1e-12, err_msg=k)
    loss, jloss = res.history["loss"], jres.history["loss"]
    assert np.all(np.diff(loss[adam - 1:]) <= 0), loss  # L-BFGS: never up, from the end of Adam on
    assert loss[-1] < loss[adam - 1] and jloss[-1] < jloss[adam - 1]
    assert abs(np.log10(loss[-1]) - np.log10(jloss[-1])) <= LOG10_LOSS_TOL, (loss[-1], jloss[-1])
    assert res.phases["adam"]["iterations"] == N_ADAM and res.phases["lbfgs"]["iterations"] == N_LBFGS
    assert res.phases["lbfgs"]["evaluations"] >= 2 * N_LBFGS  # the step's own and at least one trial each


def test_snapshot_counts_the_lbfgs_iterations(jax_run):
    """snap_after = fraction x (iterations + lbfgs_iterations), as in JAX: at
    fraction 1.0 no record is eligible in either package (with the Adam
    iterations alone, records 30 and 40 would be); at 0.75 only the last."""
    _, np_params, jres = jax_run
    _, res = port_run(np_params, best_snapshot_fraction=1.0)
    assert res.best_params is None and jres.best_params is None
    _, res = port_run(np_params, best_snapshot_fraction=0.75)
    for b, p in zip(res.best_params["net"], res.params["net"]):
        np.testing.assert_array_equal(tnp(b["W"]), tnp(p["W"]))


def test_train_takes_the_reference_argument_order(jax_run):
    """train(problem, cfg, mesh, params, verbose): a positional warm start
    starts where a keyword one does, and where JAX's run started."""
    _, np_params, jres = jax_run
    _, tcfg = configs(lbfgs_iterations=0)
    prob = tv.build(tcfg, device="cpu")
    warm = tv.params_from_jax(np_params, dtype=torch.float64)
    positional = tv.train(prob, tcfg.train, None, warm, False)
    keyword = tv.train(prob, cfg=tcfg.train, params=warm, verbose=False)
    np.testing.assert_array_equal(positional.history["loss"], keyword.history["loss"])
    np.testing.assert_allclose(positional.history["loss"][0], jres.history["loss"][0], rtol=1e-12)


def _manufactured(dim):
    """(JAX problem, port problem) of u = sin(pi x) [sin(pi y)] with its
    forcing, through both packages' build with positional arguments."""
    if dim == 2:
        cfg = dict(SMALL)
        u = lambda x, y: np.sin(np.pi * x) * np.sin(np.pi * y)  # noqa: E731
        f = lambda x, y: -2 * np.pi**2 * np.sin(np.pi * x) * np.sin(np.pi * y)  # f = Delta u  # noqa: E731
        return (jp2d.build(jv.Poisson2DConfig(**cfg), None, u, f),
                tp2d.build(tv.Poisson2DConfig(**cfg), None, u, f, device="cpu"))
    cfg = dict(grid=(-1.0, -0.1, 0.1, 1.0), n_elements=3, n_quad=12, n_test=5, layers=(1, 8, 8, 1), dtype="float64")
    u = lambda x: np.sin(np.pi * x)  # noqa: E731
    f = lambda x: np.pi**2 * np.sin(np.pi * x)  # f = -u''  # noqa: E731
    return (jp1d.build(jv.Poisson1DConfig(**cfg), u, f, None),
            tp1d.build(tv.Poisson1DConfig(**cfg), u, f, None, device="cpu"))


@pytest.mark.parametrize("dim", [1, 2])
def test_build_takes_a_manufactured_solution(dim):
    jprob, tprob = _manufactured(dim)
    np.testing.assert_allclose(tnp(tprob.data["elements"].f_proj), np.asarray(jprob.data["elements"].f_proj),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(tnp(tprob.data["ub"]), np.asarray(jprob.data["ub"]))
    np.testing.assert_array_equal(tprob.test_values, jprob.test_values)
    assert tprob.exact is jprob.exact
    params = jprob.init_params(jax.random.key(1))
    jloss = float(jax.jit(jprob.loss_fn)(params, jprob.data)[0])
    tloss = tprob.loss_fn(tv.params_from_jax(jax.tree.map(np.asarray, params), dtype=torch.float64), tprob.data)[0]
    np.testing.assert_allclose(tnp(tloss), jloss, rtol=1e-12)


def test_unported_build_arguments_raise():
    """build's lift_fn (Poisson-2D) and hard_bc (Poisson-1D) arguments build
    the hard-BC ansatz; what still raises is enriched_residual_fn, which
    waits for adaptive.py."""
    probs = (tp2d.build(tv.Poisson2DConfig(**SMALL), None, None, None, lambda X: X[:, :1], device="cpu"),
             tp1d.build(tv.Poisson1DConfig(layers=(1, 4, 1)), None, None, True, device="cpu"))
    for prob in probs:
        assert prob.apply_override is not None
        params = prob.init_params(torch.Generator().manual_seed(0))
        assert torch.isfinite(prob.loss_fn(params, prob.data)[0])
        with pytest.raises(NotImplementedError, match="not ported"):
            prob.extras["enriched_residual_fn"](params)


def test_cpu_chunk_is_the_stepwise_chunk(jax_run):
    """On CPU tensors _build_chunk runs the eager steps: no graph, and the
    same parameters and metrics, bit for bit, as _build_stepwise_chunk."""
    _, np_params, _ = jax_run
    _, tcfg = configs(lbfgs_iterations=0)
    prob = tv.build(tcfg, device="cpu")
    out = []
    for build in (_build_chunk, _build_stepwise_chunk):
        params = tv.params_from_jax(np_params, dtype=torch.float64)
        opt = make_optimizer(tcfg.train, params)
        assert not opt.defaults["capturable"]
        chunk = build(prob.loss_fn, opt, params, prob.data)
        assert chunk.graphs == ()
        aux = chunk(3)
        out.append([tnp(t) for t in parameters(params)] + [tnp(aux["loss"])])
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


def test_profiling_helpers_match_the_jax_ones(tmp_path):
    x = torch.ones(8, dtype=torch.float64)
    got = tprof.time_fn(lambda v: (v * 2).sum(), x, iters=3, warmup=1)
    want = jprof.time_fn(jax.jit(lambda v: (v * 2).sum()), jnp.ones(8), iters=3, warmup=1)
    assert sorted(got) == sorted(want)
    assert 0 < got["best_s"] <= got["p50_s"] and got["iters_per_sec"] == pytest.approx(1 / got["mean_s"])
    if not torch.cuda.is_available():
        assert tprof.device_memory_stats() == {}
    with tprof.trace(str(tmp_path)):
        (x * 2).sum()
    assert any(tmp_path.iterdir())


def test_lbfgs_alone_continues_from_the_given_params(jax_run):
    """iterations=0: the L-BFGS phase alone, its records from CHECK on."""
    _, np_params, _ = jax_run
    _, res = port_run(np_params, iterations=0)
    np.testing.assert_array_equal(res.history["iteration"], np.arange(CHECK, N_LBFGS + 1, CHECK))
    assert list(res.phases) == ["lbfgs"] and np.all(np.diff(res.history["loss"]) <= 0)
