"""The committed JAX draws (tools/draws/, written by tools/jax_draws.py) and
the port's start from them: (a) each saved draw is, bit for bit, what the
JAX package's `init_params(jax.random.key(seed))` gives for its config and
seed, and the port's loader rebuilds it with the port's own leaf shapes and
dtype; (b) advdiff_quality in float64 from the seed-1234 draw: the port's
first 500 Adam steps on the CPU land on the JAX package's first history
record (tools/draws/jax_cpu.json) to rtol 1e-9 (measured ~5e-16).
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import hpvpinns_tpu as jv  # noqa: E402
import hpvpinns_tpu_torch as tv  # noqa: E402
from hpvpinns_tpu_torch.convert import flatten_tree, load_draw, unflatten_tree  # noqa: E402
from hpvpinns_tpu_torch.problems.base import parameters  # noqa: E402
from test_torch_parity import one_torch_thread  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tools.draw_gaps import DRAWS_DIR, GAPS, JAX_RESULTS, config, draw_path  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with one_torch_thread():
        yield


def committed_seeds(gap):
    """The seeds of the gap's committed draws (the gap's own and any more)."""
    stem = GAPS[gap].name + "_s"
    return sorted(int(f[len(stem):-4]) for f in os.listdir(DRAWS_DIR) if f.startswith(stem) and f.endswith(".npz"))


@pytest.mark.parametrize("gap", list(GAPS))
def test_draw_is_jax_init_bit_for_bit(gap):
    g = GAPS[gap]
    seeds = committed_seeds(gap)
    assert set(g.seeds) <= set(seeds)
    jprob = jv.build(config(gap, jv, g.seeds[0]))
    tprob = tv.build(config(gap, tv, g.seeds[0]), device="cpu")
    template = parameters(tprob.init_params(torch.Generator().manual_seed(0)))
    for seed in seeds:
        want = flatten_tree(jax.tree.map(np.asarray, jprob.init_params(jax.random.key(seed))))
        with np.load(draw_path(gap, seed)) as f:
            saved = dict(f)
        assert sorted(saved) == sorted(want), (gap, seed)
        for k, v in want.items():
            assert saved[k].dtype == v.dtype == np.dtype(g.dtype) and np.array_equal(saved[k], v), (gap, seed, k)
        assert flatten_tree(unflatten_tree(saved)).keys() == want.keys()
        got = parameters(load_draw(draw_path(gap, seed), device="cpu", dtype=getattr(torch, g.dtype)))
        assert [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype) for t in template], (gap, seed)
        assert all(isinstance(t, torch.nn.Parameter) for t in got)


def test_advdiff_quality_first_record_from_the_jax_draw():
    with open(JAX_RESULTS) as f:
        run = next(r for r in json.load(f) if r["gap"] == "C7" and r["seed"] == 1234)
    h = run["history"]
    n = int(h["iteration"][0])
    assert n == 500
    cfg = config("C7", tv, 1234)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, iterations=n, lbfgs_iterations=0))
    prob = tv.build(cfg, device="cpu")
    res = tv.train(prob, params=load_draw(draw_path("C7", 1234), device="cpu", dtype=torch.float64), verbose=False)
    assert res.history["iteration"].tolist() == [n]
    for k in ("loss", "epsilon"):
        np.testing.assert_allclose(res.history[k][0], h[k][0], rtol=1e-9, err_msg=k)


def test_own_draws_are_distributed_as_jax():
    """The port's own initial draw (torch.Generator) and the JAX package's
    (jax.random) at the widest gap network, (2,48,48,48,48,1), over 16 seeds
    each: every layer's weights pass a two-sample Kolmogorov-Smirnov test
    (p > 1e-3) and lie inside the truncation at 2 std, the biases are zero.
    So where the port's own draws land apart from JAX's, it is the draws'
    sampling, not their distribution."""
    from scipy import stats

    from hpvpinns_tpu.models import mlp as jmlp
    from hpvpinns_tpu_torch.models import mlp as tmlp

    layers = (2, 48, 48, 48, 48, 1)
    jd = [jmlp.init_mlp(jmlp.MLP(layers), jax.random.key(s)) for s in range(16)]
    td = [tmlp.init_mlp(tmlp.MLP(layers), torch.Generator().manual_seed(s)) for s in range(16)]
    for i, (n_in, n_out) in enumerate(zip(layers[:-1], layers[1:])):
        bound = 2 * np.sqrt(2.0 / (n_in + n_out)) * (1 + 1e-6)
        a = np.concatenate([np.asarray(d[i]["W"]).ravel() for d in jd])
        b = np.concatenate([d[i]["W"].detach().numpy().ravel() for d in td])
        assert np.abs(a).max() <= bound and np.abs(b).max() <= bound, i
        assert stats.ks_2samp(a, b).pvalue > 1e-3, i
        assert not any(np.asarray(d[i]["b"]).any() for d in jd) and not any(d[i]["b"].any() for d in td)
