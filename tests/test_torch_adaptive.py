"""Port parity, adaptive refinement (hpvpinns_tpu_torch/adaptive.py and
sweep.py): every family's enriched residual, the element indicator, the
refined configs and the network loop, against the JAX package in float64
on the CPU, at a tiny size, from one JAX parameter draw converted by
params_from_jax.

The enriched residuals and the indicators agree to rtol 1e-10 (the same
arithmetic through the JVP engine or the Taylor fields on both sides); the
refined configs are equal field for field; two rounds of `adaptive_solve`
(20 Adam steps each, warm-started) give the same grids, and the same eta and
rel-L2 to rtol 1e-8; a sweep point gives JAX's record keys and rel-L2.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")


import hpvpinns_tpu as jv  # noqa: E402
import hpvpinns_tpu_torch as tv  # noqa: E402
from hpvpinns_tpu import adaptive as jad  # noqa: E402
from hpvpinns_tpu import sweep as jsw  # noqa: E402
from hpvpinns_tpu_torch import adaptive as tad  # noqa: E402
from hpvpinns_tpu_torch import sweep as tsw  # noqa: E402
from test_torch_parity import FAMILIES, draw_builds, draw_of, family_case, one_torch_thread, tnp  # noqa: E402
from test_torch_parity import family_configs as configs  # noqa: E402

RES = dict(rtol=1e-10)
LOOP = dict(rtol=1e-8)

@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def close(actual, desired, tol):
    desired = np.asarray(desired)
    np.testing.assert_allclose(actual, desired, atol=1e-12 * max(np.abs(desired).max(), 1e-300), **tol)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_enriched_residual_matches_jax(family):
    """The residual against the modes beyond the training basis, at each
    family's default enrich: JAX's shape, its trained block zero, its
    values; and the enriched arrays are built once per enrich."""
    jprob, jparams, tprob, tparams = family_case(family)
    want = np.asarray(jprob.extras["enriched_residual_fn"](jparams))
    with torch.no_grad():
        got = tprob.extras["enriched_residual_fn"](tparams)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    assert tuple(got.shape) == want.shape
    assert np.abs(want).max() > 0
    close(tnp(got), want, RES)
    assert (tnp(got) == 0).sum() == (want == 0).sum()  # the same trained block zeroed
    with torch.no_grad():
        again = tprob.extras["enriched_residual_fn"](tparams)
    assert torch.equal(got, again)


@pytest.mark.parametrize("enrich", [0, 4])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_element_indicator_matches_jax(family, enrich):
    """eta [E] against JAX's, enriched (4) and plain (0); at enrich 0 the
    indicators sum to the loss's lossv."""
    jprob, jparams, tprob, tparams = family_case(family)
    got = tad.element_indicator(tprob, tparams, enrich=enrich)
    want = jad.element_indicator(jprob, jparams, enrich=enrich)
    assert isinstance(got, np.ndarray) and got.shape == want.shape == (tprob.extras["mesh"].n_elem,)
    close(got, want, RES)
    if enrich == 0:
        _, aux = tprob.loss_fn(tparams, tprob.data)
        np.testing.assert_allclose(got.sum(), tnp(aux["lossv"]), rtol=1e-12)


# _refined_config: every config group, h and p, the space axes or space and
# time, with and without per-element test orders (split on bisection).
REFINE = {
    "poisson1d": ("Poisson1DConfig", dict(grid=(-1.0, -0.1, 0.1, 1.0), n_elements=3, n_test=5),
                  dict(n_test_per_elem=(5, 6, 5))),
    "poisson2d": ("Poisson2DConfig", dict(n_elements_x=3, n_elements_y=2, n_test_x=3, n_test_y=4),
                  dict(n_test_x_per_elem=(3, 4, 3), n_test_y_per_elem=(4, 5))),
    "helmholtz2d": ("Helmholtz2DConfig", dict(n_elements_x=2, n_elements_y=3, n_test_x=3, n_test_y=3),
                    dict(n_test_x_per_elem=(3, 4), n_test_y_per_elem=(3, 3, 4))),
    "kovasznay": ("KovasznayConfig", dict(n_elements_x=3, n_elements_y=2, n_test_x=3, n_test_y=3),
                  dict(n_test_x_per_elem=(3, 3, 4), n_test_y_per_elem=(4, 3))),
    "advdiff": ("AdvDiffConfig", dict(n_elements_x=3, n_elements_t=2, n_test_x=3, n_test_t=3, fourier_terms=10),
                dict(n_test_x_per_elem=(3, 4, 3), n_test_t_per_elem=(3, 4))),
    "burgers": ("BurgersConfig", dict(n_elements_x=3, n_elements_t=2, n_test_x=3, n_test_t=3),
                dict(n_test_x_per_elem=(4, 3, 3), n_test_t_per_elem=(3, 5))),
    "advdiff2d": ("AdvDiff2DConfig", dict(n_elements_x=2, n_elements_y=2, n_elements_t=2, n_test_x=3,
                                          n_test_y=3, n_test_t=3),
                  dict(n_test_x_per_elem=(3, 4), n_test_y_per_elem=(4, 3), n_test_t_per_elem=(3, 3))),
    "taylorgreen": ("TaylorGreenConfig", dict(n_elements_x=2, n_elements_y=2, n_elements_t=2, n_test_x=2,
                                              n_test_y=2, n_test_t=2),
                    dict(n_test_x_per_elem=(2, 3), n_test_y_per_elem=(2, 2), n_test_t_per_elem=(3, 2))),
}


def config_fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "train"}


@pytest.mark.parametrize("per_elem", [False, True], ids=["uniform", "per_elem"])
@pytest.mark.parametrize("axes", ["x", "xt"])
@pytest.mark.parametrize("mode", ["h", "p"])
@pytest.mark.parametrize("family", sorted(REFINE))
def test_refined_config_matches_jax(family, mode, axes, per_elem):
    """The next round's config from the same seeded eta on the same mesh:
    every field equal to JAX's (JAX's function reads only the mesh's
    grids, so it is handed the port's mesh and builds nothing)."""
    name, kw, orders = REFINE[family]
    kw = {**kw, **(orders if per_elem else {}), "dtype": "float64"}
    jcfg, tcfg = getattr(jv, name)(**kw), getattr(tv, name)(**kw)
    mesh = tv.build(tcfg, device="cpu").extras["mesh"]
    holder = types.SimpleNamespace(extras={"mesh": mesh})
    n_elem = int(np.prod(mesh.shape)) if hasattr(mesh, "shape") else mesh.n_elem
    eta = np.random.default_rng(sum(map(ord, family + mode + axes))).exponential(size=n_elem)
    eta[n_elem // 2] *= 20.0  # one dominant element
    want = jad._refined_config(jcfg, holder, eta, 0.5, mode=mode, p_step=3, axes=axes)
    got = tad._refined_config(tcfg, holder, eta, 0.5, mode=mode, p_step=3, axes=axes)
    assert type(got) is type(tcfg)
    assert config_fields(got) == config_fields(want)
    assert got.train == tcfg.train
    assert config_fields(got) != config_fields(tcfg)  # something was refined
    if family == "poisson1d" and mode == "h" and per_elem:
        # as in JAX, Poisson-1D's bisection keeps n_test_per_elem as it was,
        # one order short of the new grid (ROADMAP.md, queue C)
        with pytest.raises(ValueError, match="broadcast"):
            tv.build(got, device="cpu")
    else:
        tv.build(got, device="cpu")  # the refined config builds


def test_refined_config_rejects_other_configs():
    cfg = tv.Poisson3DConfig()
    with pytest.raises(TypeError, match="adaptive refinement supports"):
        tad._refined_config(cfg, types.SimpleNamespace(extras={"mesh": None}), np.ones(1), 0.5)


@pytest.mark.parametrize("mode", ["h", "p"])
def test_adaptive_solve_matches_jax(mode):
    """Two rounds of solve-estimate-mark-refine on Poisson-1D (20 Adam steps
    a round, the learning rate halved and the budget doubled in round 1),
    warm-started from the JAX draw: the same grids and test orders, eta and
    rel-L2 to rtol 1e-8, the same best round."""
    jcfg, tcfg = configs("poisson1d", layers=(1, 8, 1), train=dict(iterations=20, lbfgs_iterations=0, check_every=10))
    jbuild, tbuild = draw_builds(draw_of(jcfg))
    want = jad.adaptive_solve(jcfg, rounds=2, theta=0.5, mode=mode, budget_growth=2.0, build_fn=jbuild)
    got = tad.adaptive_solve(tcfg, rounds=2, theta=0.5, mode=mode, budget_growth=2.0, build_fn=tbuild)
    assert [r["n_elem"] for r in got.rounds] == [r["n_elem"] for r in want.rounds]
    for g, w in zip(got.rounds, want.rounds):
        assert sorted(g) == sorted(w)
        for key in ("round", "n_elem", "grid", "n_test_per_elem", "iterations", "lbfgs_iterations"):
            assert g[key] == w[key], key
        close(np.asarray(g["eta"]), w["eta"], LOOP)
        for key in ("rel_l2", "max_abs_err", "mean_abs_err", "final_loss"):
            np.testing.assert_allclose(g[key], w[key], err_msg=key, **LOOP)
    assert got.rounds[1]["iterations"] == 40
    assert got.best_round == want.best_round
    assert got.problem.extras["mesh"].n_elem == got.rounds[-1]["n_elem"]
    assert got.best_problem is (got.problem if got.best_round == 1 else got.best_problem)
    assert got.rel_l2_trajectory == [r["rel_l2"] for r in got.rounds]


def test_adaptive_solve_tracks_epsilon_like_jax():
    """The inverse AdvDiff loop records the identified eps and its truth
    per round, as JAX's does."""
    jcfg, tcfg = configs("advdiff", train=dict(iterations=10, lbfgs_iterations=0, check_every=5))
    jbuild, tbuild = draw_builds(draw_of(jcfg))
    want = jad.adaptive_solve(jcfg, rounds=2, axes="xt", build_fn=jbuild)
    got = tad.adaptive_solve(tcfg, rounds=2, axes="xt", build_fn=tbuild)
    for g, w in zip(got.rounds, want.rounds):
        assert g["grid_x"] == w["grid_x"] and g["grid_y"] == w["grid_y"]
        np.testing.assert_allclose(g["epsilon"], w["epsilon"], **LOOP)
        assert g["eps_true"] == w["eps_true"]
        np.testing.assert_allclose(g["rel_l2"], w["rel_l2"], **LOOP)


@pytest.mark.parametrize("axis", ["h", "p"])
def test_sweep_point_matches_jax(axis, monkeypatch):
    """One h_sweep / p_sweep point on Poisson-1D from the JAX draw: JAX's
    record keys and values (steps/s aside), and save_sweep writes them."""
    jcfg, tcfg = configs("poisson1d", layers=(1, 8, 1), train=dict(iterations=10, lbfgs_iterations=0, check_every=5))
    jbuild, tbuild = draw_builds(draw_of(jcfg))
    monkeypatch.setattr(jv, "build", jbuild)  # what JAX's sweep builds with
    monkeypatch.setattr(tsw, "build", tbuild)
    if axis == "h":
        want, got = jsw.h_sweep(jcfg, [2]), tsw.h_sweep(tcfg, [2])
    else:
        want, got = jsw.p_sweep(jcfg, [4]), tsw.p_sweep(tcfg, [4])
    assert len(got) == len(want) == 1
    assert sorted(got[0]) == sorted(want[0])
    for key in ("axis", "n_elements", "n_test", "iterations"):
        assert got[0].get(key) == want[0].get(key), key
    for key in ("rel_l2", "max_abs_err", "final_loss", "per_element_rel_l2"):
        np.testing.assert_allclose(got[0][key], want[0][key], err_msg=key, **LOOP)
    assert tsw._family_fields(tcfg, "n_test") == jsw._family_fields(jcfg, "n_test")


def test_sweep_save_and_errors(tmp_path):
    import json

    path = tsw.save_sweep([{"axis": "h", "n_elements": 2, "rel_l2": 0.5}], str(tmp_path / "s.json"))
    assert json.load(open(path)) == [{"axis": "h", "n_elements": 2, "rel_l2": 0.5}]
    with pytest.raises(TypeError, match="no n_elements fields"):
        tsw.h_sweep(tv.TrainConfig(), [1])
    with pytest.raises(TypeError, match="no n_test fields"):
        tsw.p_sweep(tv.TrainConfig(), [1])
