"""Port parity, results records and the plot set
(hpvpinns_tpu_torch/utils/records.py and viz.py), against the JAX package in
float64 on the CPU, at a tiny size, with no training in either package.

The trained state is a TrainResult built by hand from the same numpy
parameters in both packages (the JAX draw, converted by params_from_jax).
A record written by either package restores in the other (`.npz` and
`.mat`): the restored network predicts what the writer's does to rtol/atol
1e-12, and the test points, exact values, grids and history agree exactly.
`standard_report` writes the same file names as JAX's for Poisson-1D,
AdvDiff, Poisson-2D and Poisson-3D.
"""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("scipy.io")

import jax  # noqa: E402

import hpvpinns_tpu as jv  # noqa: E402
import hpvpinns_tpu_torch as tv  # noqa: E402
from hpvpinns_tpu import viz as jviz  # noqa: E402
from hpvpinns_tpu.training.trainer import TrainResult as JTrainResult  # noqa: E402
from hpvpinns_tpu.utils import records as jrec  # noqa: E402
from hpvpinns_tpu_torch import viz as tviz  # noqa: E402
from hpvpinns_tpu_torch.problems.base import parameters  # noqa: E402
from hpvpinns_tpu_torch.training.trainer import TrainResult as TTrainResult  # noqa: E402
from hpvpinns_tpu_torch.utils import records as trec  # noqa: E402
from test_torch_parity import family_case, one_torch_thread  # noqa: E402

EXACT = dict(rtol=1e-12, atol=1e-12)
P3D = dict(dtype="float64", n_quad=4, n_test_x=2, n_test_y=2, n_test_z=2, layers=(3, 6, 1))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def history(keys=()):
    """A hand-made training history: three records, the loss and `keys`."""
    h = {"iteration": np.array([10, 20, 30]), "loss": np.array([3.0, 2.0, 1.5])}
    for i, k in enumerate(keys):
        h[k] = np.array([0.5, 0.2, 0.1]) + i
    return h


def results(jparams, tparams, keys=()):
    """(JAX TrainResult, port TrainResult) of the same parameters and history."""
    kw = dict(history=history(keys), iterations_run=30, wall_time_s=1.25, steps_per_sec=24.0, stopped_early=False)
    return JTrainResult(params=jparams, **kw), TTrainResult(params=tparams, **kw)


def case(family):
    """(JAX problem, port problem, JAX result, port result) at the JAX draw."""
    jprob, jparams, tprob, tparams = family_case(family)
    return (jprob, tprob) + results(jparams, tparams, ("epsilon",) if family == "advdiff" else ())


def poisson3d_case():
    jprob = jv.build(jv.Poisson3DConfig(**P3D))
    jparams = jprob.init_params(jax.random.key(0))
    tprob = tv.build(tv.Poisson3DConfig(**P3D), device="cpu")
    tparams = tv.params_from_jax(jax.tree.map(np.asarray, jparams), dtype=torch.float64)
    return (jprob, tprob) + results(jparams, tparams)


@pytest.mark.parametrize("ext", ["npz", "mat"])
@pytest.mark.parametrize("family", ["poisson1d", "advdiff"])
def test_jax_record_restores_in_the_port(tmp_path, family, ext):
    """JAX's save_record(include_params=True) -> the port's load_record and
    params_from_record: nn.Parameter leaves on the problem's device and
    dtype, predicting what JAX's network does."""
    jprob, tprob, jres, _ = case(family)
    written = jrec.save_record(jprob, jres, str(tmp_path / "rec"), include_params=True)
    path = next(w for w in written if w.endswith(ext))
    params = trec.params_from_record(tprob, trec.load_record(path))
    for t in parameters(params):
        assert isinstance(t, torch.nn.Parameter) and t.dtype == torch.float64 and t.device.type == "cpu"
    np.testing.assert_allclose(tv.predict(tprob, params), np.asarray(jv.predict(jprob, jres.params)), **EXACT)


@pytest.mark.parametrize("ext", ["npz", "mat"])
@pytest.mark.parametrize("family", ["poisson1d", "advdiff"])
def test_port_record_restores_in_jax(tmp_path, family, ext):
    """The port's save_record -> JAX's params_from_record: the leaf order is
    JAX's tree-leaf order, so JAX's network predicts what the port's does."""
    jprob, tprob, _, tres = case(family)
    written = trec.save_record(tprob, tres, str(tmp_path / "rec"), include_params=True)
    assert written == [str(tmp_path / "rec.npz"), str(tmp_path / "rec.mat")]
    params = jrec.params_from_record(jprob, jrec.load_record(next(w for w in written if w.endswith(ext))))
    np.testing.assert_allclose(np.asarray(jv.predict(jprob, params)), tv.predict(tprob, tres.params), **EXACT)


@pytest.mark.parametrize("family", ["poisson1d", "advdiff", "poisson2d"])
def test_records_agree_key_for_key(family):
    """build_record of both packages: the same keys; the test points, exact
    values, grids, history and leaves equal exactly, u_pred to 1e-12."""
    jprob, tprob, jres, tres = case(family)
    want = jrec.build_record(jprob, jres, include_params=True)
    got = trec.build_record(tprob, tres, include_params=True)
    assert sorted(got) == sorted(want)
    for key in want:
        if key == "u_pred":
            np.testing.assert_allclose(got[key], np.asarray(want[key]), **EXACT)
        else:
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]), err_msg=key)
    assert any(k.startswith("grid") for k in want)


def test_record_without_params_refuses(tmp_path):
    _, tprob, _, tres = case("poisson1d")
    plain = trec.load_record(trec.save_record(tprob, tres, str(tmp_path / "rec0.npz"))[0])
    assert "history_loss" in plain and not any(k.startswith("param_leaf_") for k in plain)
    with pytest.raises(ValueError, match="include_params"):
        trec.params_from_record(tprob, plain)
    leaves = trec.load_record(trec.save_record(tprob, tres, str(tmp_path / "rec1"), include_params=True)[0])
    del leaves["param_leaf_0"]
    with pytest.raises(ValueError, match="config mismatch"):
        trec.params_from_record(tprob, leaves)


@pytest.mark.parametrize("family", ["poisson1d", "advdiff", "poisson2d", "poisson3d"])
def test_standard_report_writes_jax_file_names(tmp_path, family, monkeypatch):
    """The port writes every file; JAX's report draws every figure and
    names its file but does not write it (its own tests do)."""
    jprob, tprob, jres, tres = poisson3d_case() if family == "poisson3d" else case(family)
    monkeypatch.setattr(jviz, "_save", lambda fig, outdir, name, fmt: os.path.join(outdir, f"{name}.{fmt}"))
    want = jviz.standard_report(jprob, jres, str(tmp_path / "jax"))
    got = tviz.standard_report(tprob, tres, str(tmp_path / "port"))
    assert sorted(os.path.basename(p) for p in got) == sorted(os.path.basename(p) for p in want)
    assert all(os.path.getsize(p) > 0 for p in got)


def test_coefficient_field_plot(tmp_path):
    """A field model (quadratic eps, linear V) gets the profile panel; a
    scalar model gets None, as in JAX."""
    from hpvpinns_tpu_torch.problems import advdiff

    def vfn(x):
        return 1.0 + 0.3 * x

    cfg = tv.AdvDiffConfig(dtype="float64", velocity_trainable=True, velocity_model="linear",
                           epsilon_model="quadratic", layers=(2, 6, 1), n_quad=6, n_test_x=3, n_test_t=3)
    u_fn, f_fn = advdiff.make_manufactured(cfg, vfn)
    prob = advdiff.build(cfg, u_fn=u_fn, f_fn=f_fn, velocity_fn=vfn, device="cpu")
    params = prob.init_params(torch.Generator().manual_seed(0))
    path = tviz.plot_coefficient_field(prob, params, str(tmp_path), fit_eps_fn=lambda x: 0.03 + 0.0 * x)
    assert path is not None and os.path.getsize(path) > 0
    scalar = tv.build(dataclasses.replace(cfg, velocity_trainable=False, epsilon_model="scalar"), device="cpu")
    assert tviz.plot_coefficient_field(scalar, scalar.init_params(torch.Generator().manual_seed(0)),
                                       str(tmp_path)) is None
