"""Port parity, the float64 polish (training/hybrid.py): the config spec
round trip over every preset the port has, against the JAX package's spec
of the same preset, and polish_f64 on the CPU (the card is its default
device)."""

import dataclasses
import inspect
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import hpvpinns_tpu as jv  # noqa: E402
import hpvpinns_tpu_torch as tv  # noqa: E402
from hpvpinns_tpu.training import hybrid as jhy  # noqa: E402
from hpvpinns_tpu_torch import config as tconfig  # noqa: E402
from hpvpinns_tpu_torch.problems.base import parameters  # noqa: E402
from hpvpinns_tpu_torch.training import hybrid as thy  # noqa: E402
from test_torch_parity import one_torch_thread  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


PRESETS = sorted(
    name for name, fn in vars(tconfig).items()
    if inspect.isfunction(fn) and fn.__module__ == tconfig.__name__ and name in tconfig.__all__
)


def test_every_preset_is_listed_and_unknown_families_raise():
    assert len(PRESETS) == 22 and {"poisson1d_precision", "poisson2d_precision", "kovasznay_precision",
                                   "taylorgreen_precision"} <= set(PRESETS)
    with pytest.raises(ValueError, match="unknown config family"):
        thy.config_from_spec({"family": "StokesConfig", "fields": {}})


@pytest.mark.parametrize("name", PRESETS)
def test_spec_round_trip(name):
    """config_from_spec(JSON of config_to_spec(cfg)) == cfg, and the spec is
    the JAX package's spec of the same preset."""
    cfg = getattr(tv, name)()
    spec = json.loads(json.dumps(thy.config_to_spec(cfg)))
    assert thy.config_from_spec(spec) == cfg
    assert spec == json.loads(json.dumps(jhy.config_to_spec(getattr(jv, name)())))


def test_polish_f64_lowers_the_loss_and_keeps_the_dtype():
    """A float32 net after 50 Adam steps, polished by 4 float64 LM steps:
    the float64 loss and rel-L2 fall, params keep each leaf's dtype and
    params_f64 is float64, and the metrics are those of the float64 problem
    before and after.  timeout and python are accepted and unused."""
    cfg = tv.Poisson2DConfig(n_elements_x=2, n_elements_y=2, n_quad=6, n_test_x=3, n_test_y=3, layers=(2, 8, 8, 1),
                             train=tv.TrainConfig(iterations=50, check_every=50))
    prob = tv.build(cfg, device="cpu")
    params = tv.train(prob, verbose=False).params
    out = thy.polish_f64(cfg, params, iterations=4, timeout=1.0, python="unused", device="cpu")
    assert out.accepted == 4 and out.stopped == "iterations"
    assert all(t.dtype == torch.float32 for t in parameters(out.params))
    assert all(t.dtype == torch.float64 for t in parameters(out.params_f64))
    prob64 = tv.build(dataclasses.replace(cfg, dtype="float64"), device="cpu")
    start = float(prob64.loss_fn(thy.map_params(lambda t: t.detach().double(), params), prob64.data)[0])
    np.testing.assert_allclose(out.loss, float(prob64.loss_fn(out.params_f64, prob64.data)[0]), rtol=1e-12)
    assert out.loss < start
    assert out.metrics_start == tv.evaluate_problem(prob64, thy.map_params(lambda t: t.detach().double(), params))
    assert out.metrics == tv.evaluate_problem(prob64, out.params_f64)
    assert out.metrics["rel_l2"] < out.metrics_start["rel_l2"]
    for a, b in zip(parameters(out.params), parameters(out.params_f64)):
        np.testing.assert_array_equal(a.numpy(), b.numpy().astype(np.float32))
