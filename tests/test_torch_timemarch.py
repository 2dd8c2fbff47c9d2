"""Port parity, slab time marching (training/timemarch.py) and Burgers'
interface lift (problems/burgers.py::make_interface_lift), against the JAX
package, in float64 on the CPU, on the small Burgers, AdvDiff and
Taylor-Green configurations of tests/test_timemarch.py.

Both packages start slab 0 (and a fresh-start slab) from the same draw:
JAX's at the train seed with its biases perturbed (test_torch_parity.py::
draw_of), given to each package by patching its family's `build` in the
test.  Tolerances: the per-slab final losses and rel-L2 and the global
metrics to 1e-8 after a short Adam run in float64 (measured ~1e-15 on
these configurations); the interface lift to 1e-12; every validation
message equal to JAX's."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import hpvpinns_tpu as jv  # noqa: E402
import hpvpinns_tpu.problems.advdiff as jadvdiff  # noqa: E402
import hpvpinns_tpu.problems.burgers as jburgers  # noqa: E402
import hpvpinns_tpu.problems.taylorgreen as jtaylorgreen  # noqa: E402
import hpvpinns_tpu_torch as tv  # noqa: E402
from hpvpinns_tpu.training.timemarch import _hard_bc_slab_kwargs as j_slab_kwargs  # noqa: E402
from hpvpinns_tpu_torch.problems import advdiff, burgers, taylorgreen  # noqa: E402
from hpvpinns_tpu_torch.problems.base import map_params, parameters  # noqa: E402
from hpvpinns_tpu_torch.training import timemarch  # noqa: E402
from test_torch_parity import draw_of, one_torch_thread, tnp  # noqa: E402

MARCH_TOL = dict(rtol=1e-8, atol=1e-12)
LIFT_TOL = dict(rtol=1e-12, atol=1e-12)
TRAIN = dict(iterations=20, check_every=10, lbfgs_iterations=0)
FAMILY = {  # config class, its test_timemarch.py sizes, the two packages' builder modules
    "burgers": ("BurgersConfig", dict(n_elements_x=3, n_elements_t=2, n_test_x=5, n_test_t=5, n_quad=10, n_bound=16,
                                      layers=(2, 10, 10, 1)), jburgers, burgers),
    "advdiff": ("AdvDiffConfig", dict(n_elements_x=2, n_elements_t=2, n_test_x=4, n_test_t=4, n_quad=10, n_bound=12,
                                      n_sensors_per_station=4, inverse=False, fourier_terms=200, layers=(2, 8, 8, 1)),
                jadvdiff, advdiff),
    "taylorgreen": ("TaylorGreenConfig", dict(n_elements_x=1, n_elements_y=1, n_elements_t=2, n_test_x=4, n_test_y=4,
                                              n_test_t=4, n_quad=6, n_bound=12, layers=(3, 10, 10, 3)),
                    jtaylorgreen, taylorgreen),
}


def tiny(family, pkg, **kw):
    name, base, *_ = FAMILY[family]
    train = {**TRAIN, **kw.pop("train", {})}
    return getattr(pkg, name)(**{**base, "dtype": "float64", **kw}, train=pkg.TrainConfig(**train))


def patch_draws(mp, family):
    """Every slab of both packages starts (or a fresh start restarts) from
    one draw: each family `build` hands its problem init_params returning
    it."""
    _, _, jmod, tmod = FAMILY[family]
    draw = draw_of(tiny(family, jv))
    jbuild, tbuild = jmod.build, tmod.build

    def jax_build(*args, **kw):
        prob = jbuild(*args, **kw)
        prob.init_params = lambda key: jax.tree.map(jnp.asarray, draw)
        return prob

    def port_build(*args, **kw):
        prob = tbuild(*args, **kw)
        prob.init_params = lambda generator: tv.params_from_jax(draw, dtype=torch.float64)
        return prob

    mp.setattr(jmod, "build", jax_build)
    mp.setattr(tmod, "build", port_build)


MARCHES = {  # label: (family, config overrides, time_march arguments)
    "burgers hard net": ("burgers", {"hard_bc": True}, {}),
    "burgers hard exact": ("burgers", {"hard_bc": True}, {"ic": "exact"}),
    "advdiff exact fresh edges": ("advdiff", {}, {"ic": "exact", "warm_start": False, "edges": [0.0, 0.3, 1.0]}),
    "advdiff budget": ("advdiff", {}, {"budget_weights": [3.0, 1.0, 2.0], "n_slabs": 3}),
    "taylorgreen soft net": ("taylorgreen", {}, {}),
}


@pytest.mark.parametrize("label", list(MARCHES))
def test_time_march_matches_jax(label):
    """Each slab's iterations, final loss and metrics, the global metrics
    and the edges against JAX's time_march from the same draw."""
    family, over, kw = MARCHES[label]
    kw = {"n_slabs": 2, **kw}
    with pytest.MonkeyPatch.context() as mp, one_torch_thread():
        patch_draws(mp, family)
        jres = jv.time_march(tiny(family, jv, **over), verbose=False, **kw)
        res = tv.time_march(tiny(family, tv, **over), verbose=False, device="cpu", **kw)
    np.testing.assert_array_equal(res.edges, jres.edges)
    assert len(res.per_slab) == len(jres.per_slab) == kw["n_slabs"]
    for mine, ref in zip(res.per_slab, jres.per_slab):
        assert sorted(mine) == sorted(ref)
        for k, v in ref.items():
            if isinstance(v, float):
                np.testing.assert_allclose(mine[k], v, **MARCH_TOL, err_msg=f"slab {ref['slab']} {k}")
            else:
                assert mine[k] == v, k
    assert sorted(res.metrics) == sorted(jres.metrics)
    for k, v in jres.metrics.items():
        np.testing.assert_allclose(res.metrics[k], v, **MARCH_TOL, err_msg=k)
    if "budget_weights" in kw:  # [3, 1, 2] normalized to [1.5, 0.5, 1]: 30 + 10 + 20 of the uniform 3 x 20
        assert [m["iterations"] for m in res.per_slab] == [30, 10, 20]
    X = np.stack([np.linspace(-0.9, 0.9, 5), np.linspace(0.05, 0.95, 5)], -1)
    if family != "taylorgreen":
        np.testing.assert_allclose(res.predict(X), jres.predict(X), **MARCH_TOL)
        np.testing.assert_array_equal(res.slab_of(X[:, 1]), jres.slab_of(X[:, 1]))


def test_hard_bc_burgers_march_is_exact_at_walls_and_handoff():
    """Hard-BC slabs chain exactly: the ansatz is zero on both walls in both
    slabs, and slab 1 at the interface time equals slab 0's prediction
    (tests/test_timemarch.py::test_time_march_hard_bc_burgers)."""
    with one_torch_thread():
        res = tv.time_march(tiny("burgers", tv, hard_bc=True), 2, verbose=False,
                            device="cpu")
    tw = np.linspace(0.0, 1.0, 7)
    for xw in (-1.0, 1.0):
        np.testing.assert_allclose(res.predict(np.stack([np.full(7, xw), tw], -1)), 0.0, atol=1e-14)
    Xi = np.stack([np.linspace(-1, 1, 11), np.full(11, 0.5)], -1)
    u0 = tv.predict(res.problems[0], res.params[0], Xi)
    np.testing.assert_allclose(tv.predict(res.problems[1], res.params[1], Xi), u0, atol=1e-13)


def test_previous_slab_params_unchanged_by_the_next_slab():
    """Slab k's lift closes over slab k-1's trained ansatz and a warm start
    begins from it: after slab k trains, slab k-1's eval_params are what
    its own `train` returned, bit for bit, and carry no gradient."""
    snapshots = []
    real_train = timemarch.train

    def recording_train(*args, **kw):
        res = real_train(*args, **kw)
        snapshots.append(map_params(lambda t: t.detach().clone(), res.eval_params))
        return res

    with pytest.MonkeyPatch.context() as mp, one_torch_thread():
        mp.setattr(timemarch, "train", recording_train)
        res = tv.time_march(tiny("burgers", tv, hard_bc=True), 3, verbose=False,
                            device="cpu")
    assert len(snapshots) == 3
    for k in range(3):
        for a, b in zip(parameters(res.params[k]), parameters(snapshots[k]), strict=True):
            assert torch.equal(a.detach(), b) and a.grad is None


def test_interface_lift_matches_jax():
    """make_interface_lift against JAX's, from an analytic start face and
    from the Cole-Hopf solution at t0 (u_exact_torch / u_exact_jnp), to
    1e-12: zero on both walls, u0 minus its wall interpolant inside."""
    X = np.stack([np.linspace(-1.0, 1.0, 13), np.linspace(0.3, 0.9, 13)], -1)
    for tfn, jfn in ((lambda x: torch.cos(2.0 * x) + x, lambda x: jnp.cos(2.0 * x) + x),
                     (lambda x: burgers.u_exact_torch(x, 0.4, 0.01 / np.pi),
                      lambda x: jburgers.u_exact_jnp(x, jnp.asarray(0.4, dtype=x.dtype), 0.01 / np.pi))):
        got = burgers.make_interface_lift(tfn, (-1.0, 1.0))(torch.tensor(X))
        want = jburgers.make_interface_lift(jfn, (-1.0, 1.0))(jnp.asarray(X))
        np.testing.assert_allclose(tnp(got), np.asarray(want), **LIFT_TOL)
        np.testing.assert_allclose(tnp(got)[[0, -1]], 0.0, atol=1e-15)


def test_taylorgreen_predicted_face_lift_matches_jax():
    """The hard-BC Taylor-Green hand-off (the g_ic_fn hook) at slab 1 from
    the same slab-0 network: the slab-1 ansatz against JAX's at any slab-1
    parameters to 1e-12, and its (u, v) at the interface equal to slab 0's
    (tests/test_timemarch.py::test_tg_predicted_face_lift_exactness)."""
    cfg = tiny("taylorgreen", tv, hard_bc=True)
    jcfg = tiny("taylorgreen", jv, hard_bc=True)
    s0, s1 = (dict(t_start=0.0, t_final=0.5, n_elements_t=1), dict(t_start=0.5, t_final=1.0, n_elements_t=1))
    p0 = taylorgreen.build(dataclasses.replace(cfg, **s0), device="cpu")
    jp0 = jtaylorgreen.build(dataclasses.replace(jcfg, **s0))
    draw0, draw1 = draw_of(jcfg), draw_of(dataclasses.replace(jcfg, train=jv.TrainConfig(seed=9)))
    prev = map_params(lambda t: t.detach(), tv.params_from_jax(draw0, dtype=torch.float64))
    kw = timemarch._hard_bc_slab_kwargs(cfg, dataclasses.replace(cfg, **s1), 1, "net", p0, prev)
    jkw = j_slab_kwargs(jcfg, dataclasses.replace(jcfg, **s1), 1, "net", jp0, jax.tree.map(jnp.asarray, draw0))
    assert set(kw) == set(jkw) == {"ic_lift_fns"}
    p1 = taylorgreen.build(dataclasses.replace(cfg, **s1), ic_lift_fns=kw["ic_lift_fns"], device="cpu")
    jp1 = jtaylorgreen.build(dataclasses.replace(jcfg, **s1), ic_lift_fns=jkw["ic_lift_fns"])
    rng = np.random.default_rng(7)
    Xi = np.stack([rng.uniform(0, np.pi, 13), rng.uniform(0, np.pi, 13), np.full(13, 0.5)], -1)
    X = np.stack([rng.uniform(0, np.pi, 13), rng.uniform(0, np.pi, 13), rng.uniform(0.5, 1.0, 13)], -1)
    p1_params = tv.params_from_jax(draw1, dtype=torch.float64)
    for pts in (Xi, X):
        got = tnp(p1.apply(p1_params, torch.tensor(pts)))
        np.testing.assert_allclose(got, np.asarray(jp1.apply(jax.tree.map(jnp.asarray, draw1), jnp.asarray(pts))),
                                   **LIFT_TOL)
    w0 = tnp(p0.apply(prev, torch.tensor(Xi)))
    np.testing.assert_allclose(tnp(p1.apply(p1_params, torch.tensor(Xi)))[:, :2], w0[:, :2], atol=1e-13)


def _message(fn):
    with pytest.raises((ValueError, TypeError)) as err:
        fn()
    return type(err.value), str(err.value)


@pytest.mark.parametrize("case", [
    "n_slabs", "ic", "edges order", "edges length", "inverse advdiff", "inverse taylorgreen", "hard advdiff",
    "family", "weights length", "weights sign",
])
def test_validation_messages_match_jax(case):
    """Every refusal of time_march (timemarch.py:80-110, 226-247) raises the
    JAX package's exception type and message, before any training."""
    def args(pkg):
        return {
            "n_slabs": (tiny("burgers", pkg), dict(n_slabs=0)),
            "ic": (tiny("burgers", pkg), dict(n_slabs=2, ic="both")),
            "edges order": (tiny("burgers", pkg), dict(n_slabs=2, edges=[0.0, 0.7, 0.5])),
            "edges length": (tiny("burgers", pkg), dict(n_slabs=2, edges=[0.0, 1.0])),
            "inverse advdiff": (tiny("advdiff", pkg, inverse=True), dict(n_slabs=2)),
            "inverse taylorgreen": (tiny("taylorgreen", pkg, inverse=True), dict(n_slabs=2)),
            "hard advdiff": (tiny("advdiff", pkg, hard_bc=True), dict(n_slabs=2)),
            "family": (pkg.Poisson2DConfig(), dict(n_slabs=2)),
            "weights length": (tiny("burgers", pkg), dict(n_slabs=2, budget_weights=[1.0])),
            "weights sign": (tiny("burgers", pkg), dict(n_slabs=2, budget_weights=[1.0, -1.0])),
        }[case]

    jcfg, kw = args(jv)
    tcfg, _ = args(tv)
    assert _message(lambda: tv.time_march(tcfg, device="cpu", **kw)) == _message(lambda: jv.time_march(jcfg, **kw))
    with pytest.raises(NotImplementedError, match="queue A item 24"):
        tv.time_march(tiny("burgers", tv), 2, mesh=object(), device="cpu")
