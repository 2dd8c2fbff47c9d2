"""Port parity, the trainer: Adam then L-BFGS, the reference's argument
orders and manufactured solutions, the CPU chunk and the profiling helpers,
against the JAX package in float64 on the CPU, at a small size (2x2
elements, 6 quadrature points, 3x3 test functions, a (2,8,8,1) tanh net),
from the same JAX-initialised parameters.

The Adam phase is the same arithmetic in both packages: its records agree
to rtol 1e-12 (measured ~1e-16).  The L-BFGS phase is optax.lbfgs() in both
(training/lbfgs.py): its records agree to rtol 1e-8 (measured ~2e-11 after
20 + 20 iterations; the dot products sum in another order, and the
difference grows from rounding), and it evaluates the loss as often as
optax's own state counts.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import hpvpinns_tpu as jv  # noqa: E402
import hpvpinns_tpu_torch as tv  # noqa: E402
from hpvpinns_tpu.problems import poisson1d as jp1d  # noqa: E402
from hpvpinns_tpu.problems import poisson2d as jp2d  # noqa: E402
from hpvpinns_tpu.utils import profiling as jprof  # noqa: E402
from hpvpinns_tpu_torch.problems import poisson1d as tp1d  # noqa: E402
from hpvpinns_tpu_torch.problems import poisson2d as tp2d  # noqa: E402
from hpvpinns_tpu_torch.problems.base import parameters  # noqa: E402
from hpvpinns_tpu_torch.training import lbfgs  # noqa: E402
from hpvpinns_tpu_torch.training.checkpoint import Checkpointer  # noqa: E402
from hpvpinns_tpu_torch.training.trainer import _build_chunk, _build_stepwise_chunk, make_optimizer  # noqa: E402
from hpvpinns_tpu_torch.utils import profiling as tprof  # noqa: E402
from test_torch_parity import one_torch_thread  # noqa: E402

SMALL = dict(
    n_elements_x=2, n_elements_y=2, n_quad=6, n_test_x=3, n_test_y=3,
    layers=(2, 8, 8, 1), dtype="float64",
)
N_ADAM, N_LBFGS, CHECK = 20, 20, 10


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


def optax_evaluations(prob, params):
    """Loss evaluations of N_LBFGS iterations of optax.lbfgs() from `params`,
    as the JAX trainer runs it: one at the start (value_and_grad_from_state),
    then num_linesearch_steps per iteration."""
    f = lambda p: prob.loss_fn(p, prob.data)[0]  # noqa: E731
    opt, value_and_grad = optax.lbfgs(), optax.value_and_grad_from_state(f)

    @jax.jit
    def step(p, state):
        value, grad = value_and_grad(p, state=state)
        updates, state = opt.update(grad, state, p, value=value, grad=grad, value_fn=f)
        return optax.apply_updates(p, updates), state, optax.tree.get(state, "num_linesearch_steps")

    state, n = opt.init(params), 1
    for _ in range(N_LBFGS):
        params, state, steps = step(params, state)
        n += int(steps)
    return n


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
        np.testing.assert_allclose(res.history[k][adam:], jres.history[k][adam:], rtol=1e-8, err_msg=k)
    loss, jloss = res.history["loss"], jres.history["loss"]
    assert np.all(np.diff(loss[adam - 1:]) <= 0), loss  # L-BFGS: never up, from the end of Adam on
    assert loss[-1] < loss[adam - 1] and jloss[-1] < jloss[adam - 1]
    assert res.phases["adam"]["iterations"] == N_ADAM and res.phases["lbfgs"]["iterations"] == N_LBFGS
    jprob, _, _ = jax_run
    jcfg, _ = configs(lbfgs_iterations=0)
    adam_end = jv.train(jprob, jcfg.train, params=jax.tree.map(jnp.asarray, np_params), verbose=False).params
    assert res.phases["lbfgs"]["evaluations"] == optax_evaluations(jprob, adam_end)


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


@pytest.mark.parametrize("max_steps", [1, 2])
def test_lbfgs_loss_rises_only_after_an_unsafe_step(jax_run, max_steps, monkeypatch):
    """With the search cut to `max_steps` trials some searches fail with no
    trial of sufficient decrease and take their last one (optax's unsafe
    step).  Recorded every iteration, the loss rises by more than optax's
    approximate decrease (1e-6 |f_0|) at exactly the iterations that
    phases["lbfgs"]["unsafe_at"] lists, counted as history["iteration"]."""
    monkeypatch.setattr(lbfgs, "MAX_LINESEARCH_STEPS", max_steps)
    _, np_params, _ = jax_run
    _, res = port_run(np_params, lbfgs_iterations=40, check_every=1)
    it, loss = res.history["iteration"], res.history["loss"]
    lb = it >= N_ADAM
    rose = it[lb][1:][np.diff(loss[lb]) > lbfgs.APPROX_DEC_RTOL * np.abs(loss[lb][:-1])]
    unsafe = res.phases["lbfgs"]["unsafe_at"]
    assert unsafe and rose.tolist() == unsafe
    assert len(unsafe) <= res.phases["lbfgs"]["failed_searches"]


@pytest.fixture
def one_thread():
    with one_torch_thread():
        yield


def test_gauss_newton_phase_matches_jax(jax_run, one_thread):
    """Adam 20 then three Gauss-Newton/LM steps (float64: the "normal"
    solve): the LM records go on from the Adam count (21, 22, 23), carry
    the damping, and equal JAX's to rtol 1e-8; iterations_run grows by the
    LM iterations, accepted or not; the best snapshot Adam kept is dropped,
    since the LM phase ends below it; final_aux is the LM phase's."""
    jprob, np_params, _ = jax_run
    kw = dict(lbfgs_iterations=0, gn_iterations=3, best_snapshot_fraction=0.5)
    jcfg, _ = configs(**kw)
    jres = jv.train(jprob, jcfg.train, params=jax.tree.map(jnp.asarray, np_params), verbose=False)
    _, res = port_run(np_params, **kw)
    np.testing.assert_array_equal(res.history["iteration"], jres.history["iteration"])
    np.testing.assert_array_equal(res.history["iteration"], [10, 20, 21, 22, 23])
    assert res.iterations_run == jres.iterations_run == N_ADAM + res.phases["gn"]["iterations"]
    assert res.phases["gn"]["accepted"] == 3 and res.phases["gn"]["stopped"] == "iterations"
    assert sorted(res.history) == sorted(jres.history)
    for k in res.history:
        np.testing.assert_allclose(res.history[k], jres.history[k], rtol=1e-8, err_msg=k)  # NaN where absent in both
    assert res.phases["gn"]["damping"] == res.history["damping"][-1]
    assert res.best_params is None and jres.best_params is None
    assert sorted(res.final_aux) == sorted(jres.final_aux)
    for k, v in res.final_aux.items():
        np.testing.assert_allclose(v, jres.final_aux[k], rtol=1e-8, err_msg=k)
    np.testing.assert_allclose(res.final_aux["loss"], res.history["loss"][-1], rtol=1e-14)


@pytest.mark.parametrize("use_async", [False, True])
def test_checkpoints_round_trip_retention_cadence_and_resume(jax_run, tmp_path, use_async, one_thread):
    """Adam 40 with records every 10: checkpoint_every 10 saves at every
    record (and once at the end), keep_last 2 keeps 30 and 40; every 15
    saves at 20 and 40 (the first records 15 or more past the last save).
    A restore gives the params and Adam state of its step, on the device and
    in the dtype of `like`; a run resumed from step 30's params trains as
    JAX's train does from the same params (a warm start, Adam afresh)."""
    _, np_params, _ = jax_run
    base = dict(lbfgs_iterations=0, iterations=40, checkpoint_async=use_async)
    _, res = port_run(np_params, **base, checkpoint_dir=str(tmp_path / "a"), checkpoint_every=10,
                      checkpoint_keep_last=2)
    port_run(np_params, **base, checkpoint_dir=str(tmp_path / "b"), checkpoint_every=15, checkpoint_keep_last=0)
    assert sorted(os.listdir(tmp_path / "a")) == ["step_00000030", "step_00000040"]
    assert sorted(os.listdir(tmp_path / "b")) == ["step_00000020", "step_00000040"]

    ckpt = Checkpointer(str(tmp_path / "a"))
    assert ckpt.latest_step() == 40
    step, tree = ckpt.restore()
    assert step == 40 and int(tree["opt_state"]["state"][0]["step"]) == 40
    for a, b in zip(parameters(tree["params"]), parameters(res.params)):
        np.testing.assert_array_equal(tnp(a), tnp(b))
    like = {"params": tv.params_from_jax(np_params, dtype=torch.float32), "opt_state": None}
    step, tree = ckpt.restore(30, like=like)
    _, at30 = port_run(np_params, lbfgs_iterations=0, iterations=30)
    for a, b, c in zip(parameters(tree["params"]), parameters(at30.params), parameters(like["params"])):
        assert a.dtype == torch.float32 and a.device == c.device
        np.testing.assert_array_equal(tnp(a), tnp(b).astype(np.float32))
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore()

    _, tree = Checkpointer(str(tmp_path / "a")).restore(30)
    resumed = tv.train(port_run(np_params)[0], configs(lbfgs_iterations=0)[1].train, params=tree["params"],
                       verbose=False)
    jprob = jax_run[0]
    jcfg, _ = configs(lbfgs_iterations=0)
    jres = jv.train(jprob, jcfg.train, params=jax.tree.map(jnp.asarray, tv.params_to_numpy(tree["params"])),
                    verbose=False)
    np.testing.assert_allclose(resumed.history["loss"], jres.history["loss"], rtol=1e-12)
