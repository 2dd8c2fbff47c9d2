"""The serving tier of the port (hpvpinns_tpu_torch/serving.py): torch.export
artifacts, on the CPU in float64.

export -> save -> load -> predict reproduces the live ansatz to 1e-12 at
batch sizes 1, 13 and 200 (a symbolic batch axis) for a plain MLP, the
hard-BC Kovasznay triple, Burgers' input-feature ansatz and a TF32-precision
network with an adaptive slope; the artifact directory is self-describing
(its config rebuilds the same Problem, and a meta.json written by the JAX
package's save_model reads into the port's equal config); a float64
artifact keeps the "cuda" platform (the H100 runs float64; JAX drops "tpu"
there); a fresh interpreter loads and serves an artifact without the
package.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import hpvpinns_tpu_torch as tv  # noqa: E402
from hpvpinns_tpu_torch import serving  # noqa: E402
from hpvpinns_tpu_torch.problems.base import parameters  # noqa: E402
from test_torch_parity import one_torch_thread  # noqa: E402

EXACT = dict(rtol=1e-12, atol=1e-12)
# Small float64 configurations whose ansatzes differ: the plain MLP, the
# Coons-lifted (u, v, p) triple, the input-feature network and TF32
# precision with an adaptive slope.
CASES = {
    "poisson1d": tv.Poisson1DConfig(dtype="float64", layers=(1, 8, 8, 1), n_quad=12, n_test=5),
    "kovasznay_hard_bc": tv.KovasznayConfig(dtype="float64", hard_bc=True, layers=(2, 8, 8, 3), n_quad=5,
                                            n_test_x=3, n_test_y=3),
    "burgers_front_feature": tv.BurgersConfig(dtype="float64", front_feature=True, layers=(2, 6, 6, 1), n_quad=5,
                                              n_test_x=3, n_test_t=3),
    "poisson2d_high_slope": tv.Poisson2DConfig(dtype="float64", matmul_precision="high", adaptive_slope=True,
                                               layers=(2, 8, 8, 1), n_quad=6, n_test_x=3, n_test_y=3),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def trained(cfg, seed=0):
    """A problem on the CPU and parameters away from the init (biases drawn
    too, so no leaf is zero)."""
    prob = tv.build(cfg, device="cpu")
    params = prob.init_params(torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for layer in params["net"]:
            layer["b"].add_(0.1 * torch.randn(layer["b"].shape, generator=gen, dtype=layer["b"].dtype))
    return prob, params


def live(prob, params, X):
    with torch.no_grad():
        return prob.apply(params, torch.as_tensor(X)).numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_artifact_reproduces_live_ansatz_at_any_batch(tmp_path, name):
    prob, params = trained(CASES[name])
    meta = serving.save_model(str(tmp_path / "art"), prob, params)
    assert sorted(os.listdir(tmp_path / "art")) == ["meta.json", "model.pt2"]
    model = serving.load_model(str(tmp_path / "art"), device="cpu")
    assert model.meta == json.loads(json.dumps(meta))
    rng = np.random.default_rng(0)
    lo, hi = prob.test_points.min(0), prob.test_points.max(0)
    for n in (1, 13, 200):
        X = lo + (hi - lo) * rng.random((n, meta["d_in"]))
        got = model.predict(X)
        assert got.shape == (n, meta["n_out"]) and got.dtype == np.float64
        np.testing.assert_allclose(got, live(prob, params, X), **EXACT)


def test_meta_and_rebuilt_problem(tmp_path):
    prob, params = trained(CASES["kovasznay_hard_bc"])
    meta = tv.save_model(str(tmp_path / "art"), prob, params)
    assert meta["problem"] == "kovasznay" and meta["config_class"] == "KovasznayConfig"
    assert (meta["d_in"], meta["n_out"], meta["dtype"]) == (2, 3, "float64")
    assert meta["n_params"] == sum(t.numel() for t in parameters(params)) == 2 * 8 + 8 + 8 * 8 + 8 + 8 * 3 + 3
    assert meta["torch_version"] == torch.__version__ and "jax_version" not in meta
    model = tv.load_model(str(tmp_path / "art"), device="cpu")
    prob2 = model.rebuild_problem()
    assert prob2.name == prob.name and prob2.config == prob.config
    assert prob2.data["xb"].device.type == "cpu"
    np.testing.assert_array_equal(prob2.test_points, prob.test_points)
    np.testing.assert_allclose(model.predict(prob.test_points), live(prob, params, prob.test_points), **EXACT)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_config_from_meta_reads_either_package(tmp_path, writer):
    """meta.json written by JAX's save_model reads into the port's equal
    config, and the port's into JAX's."""
    import dataclasses

    import jax

    import hpvpinns_tpu as jv
    from hpvpinns_tpu import serving as jserving

    kw = dict(grid=(-1.0, -0.1, 0.1, 1.0), n_elements=3, layers=(1, 6, 1), n_quad=12, n_test=5, dtype="float64",
              hard_bc=True)
    tcfg = tv.Poisson1DConfig(**kw, train=tv.TrainConfig(iterations=7, gn_iterations=2, gn_solve="qr"))
    jcfg = jv.Poisson1DConfig(**kw, train=jv.TrainConfig(iterations=7, gn_iterations=2, gn_solve="qr"))
    if writer == "jax":
        jprob = jv.build(jcfg)
        jv.save_model(str(tmp_path / "a"), jprob, jprob.init_params(jax.random.key(0)), platforms=("cpu",))
    else:
        prob, params = trained(tcfg)
        tv.save_model(str(tmp_path / "a"), prob, params)
    with open(tmp_path / "a" / "meta.json") as f:
        meta = json.load(f)
    assert serving.config_from_meta(meta) == tcfg
    assert jserving.config_from_meta(meta) == jcfg
    assert dataclasses.asdict(serving.config_from_meta(meta)) == dataclasses.asdict(jserving.config_from_meta(meta))


def test_refusals(tmp_path):
    """A manufactured artifact predicts but refuses rebuild_problem; the
    wrong input width, a platform the artifact is not tagged for, and the
    card's default with no card all raise."""
    prob, params = trained(CASES["poisson1d"])
    tv.save_model(str(tmp_path / "m"), prob, params, extra_meta={"manufactured": True})
    model = tv.load_model(str(tmp_path / "m"), device="cpu")
    assert model.predict(np.zeros((3, 1))).shape == (3, 1)
    with pytest.raises(ValueError, match="manufactured"):
        model.rebuild_problem()
    with pytest.raises(ValueError, match="expected points"):
        model.predict(np.zeros((4, 2)))
    tv.save_model(str(tmp_path / "c"), prob, params, platforms=("cuda",))
    with pytest.raises(ValueError, match="platforms"):
        tv.load_model(str(tmp_path / "c"), device="cpu").predict(np.zeros((2, 1)))


def test_load_without_a_device_needs_the_card(tmp_path, monkeypatch):
    prob, params = trained(CASES["poisson1d"])
    tv.save_model(str(tmp_path / "a"), prob, params)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tv.load_model(str(tmp_path / "a"))


def test_float64_artifact_keeps_the_cuda_platform(tmp_path):
    """The port's twin of JAX's test_f64_artifact_drops_tpu_platform_tag:
    JAX drops "tpu" from a float64 artifact because the TPU rejects x64
    programs; the H100 runs float64, so the port keeps "cuda"."""
    prob, params = trained(CASES["poisson1d"])
    assert serving._compute_dtype(params) == torch.float64
    meta = tv.save_model(str(tmp_path / "a"), prob, params)
    assert meta["platforms"] == ["cpu", "cuda"] and meta["dtype"] == "float64"


def test_fresh_interpreter_serves_without_the_package(tmp_path):
    """serving.py alone, beside the artifact in a directory with nothing else
    of the repository: load_model and predict import torch, numpy and json
    only, and no module of the package (the program carries the ansatz,
    TF32 precision and the adaptive slope included)."""
    prob, params = trained(CASES["poisson2d_high_slope"])
    tv.save_model(str(tmp_path / "art"), prob, params)
    X = prob.test_points[:13]
    np.save(tmp_path / "X.npy", X)
    np.save(tmp_path / "want.npy", live(prob, params, X))
    shutil.copy(serving.__file__, tmp_path / "served.py")
    code = (
        "import sys, numpy as np, served\n"
        "model = served.load_model('art', device='cpu')\n"
        "np.testing.assert_allclose(model.predict(np.load('X.npy')), np.load('want.npy'), rtol=1e-12, atol=1e-12)\n"
        "bad = sorted(m for m in sys.modules if m.startswith(('hpvpinns_tpu', 'jax', 'matplotlib')))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
