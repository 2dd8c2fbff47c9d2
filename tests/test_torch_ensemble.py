"""Port parity, the seed ensemble (training/ensemble.py) and the
fused-fields kernels' vmap rules (ops/fused_fields.py), against the JAX
package, in float64 on the CPU.

Tolerances: the stacked init bit for bit against the serial draws; the
vmapped gradient to 1e-10 against JAX's vmapped gradient (under "pallas"
the port runs the kernels' plain versions through the new vmap rules, and
is held to JAX's "taylor", since JAX's backward kernel refuses float64);
a few train_ensemble steps against JAX's from the same stacked draw to 1e-8
(measured ~1e-15)."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import hpvpinns_tpu as jv  # noqa: E402
import hpvpinns_tpu_torch as tv  # noqa: E402
from hpvpinns_tpu.training.ensemble import init_ensemble as jinit_ensemble  # noqa: E402
from hpvpinns_tpu_torch.ops import fused_fields as ff  # noqa: E402
from hpvpinns_tpu_torch.problems.base import parameters  # noqa: E402
from hpvpinns_tpu_torch.training import ensemble  # noqa: E402
from test_torch_parity import FAMILIES, named_leaves, one_torch_thread, tnp  # noqa: E402

GRAD_TOL = dict(rtol=1e-10, atol=1e-13)
STEP_TOL = dict(rtol=1e-8, atol=1e-12)
SEEDS = (0, 7)
PANEL = dict(n_elements_x=2, n_elements_y=2, n_quad=6, n_test_x=3, n_test_y=3, layers=(2, 8, 8, 1), dtype="float64")


def configs(var_form, mode="taylor", **train):
    kw = dict(PANEL, var_form=var_form)
    if not train:
        return jv.Poisson2DConfig(**kw), tv.Poisson2DConfig(**kw, deriv_mode=mode)
    return (jv.Poisson2DConfig(**kw, train=jv.TrainConfig(**train)),
            tv.Poisson2DConfig(**kw, deriv_mode=mode, train=tv.TrainConfig(**train)))


@functools.lru_cache(maxsize=None)
def jax_case(var_form):
    """JAX's problem, its stacked draw at SEEDS (numpy) and its vmapped
    gradient and aux there; shared by the "taylor" and "pallas" cases."""
    jprob = jv.build(configs(var_form)[0])
    stack = jinit_ensemble(jprob, SEEDS)
    grads, aux = jax.jit(jax.vmap(jax.grad(lambda p: jprob.loss_fn(p, jprob.data), has_aux=True)))(stack)
    return jprob, jax.tree.map(np.asarray, stack), jax.tree.map(np.asarray, grads), jax.tree.map(np.asarray, aux)


def test_init_ensemble_members_are_the_serial_draws():
    """Member i of the stack is bit for bit the draw `train` starts from at
    seed i, and EnsembleResult.member hands it back as a detached copy."""
    prob = tv.build(configs(1)[1], device="cpu")
    stack = ensemble.init_ensemble(prob, SEEDS)
    assert all(isinstance(t, torch.nn.Parameter) and t.shape[0] == len(SEEDS) for t in parameters(stack))
    res = tv.EnsembleResult(stack, list(SEEDS), {}, 0, 0.0, 0.0, 0.0, {"loss": np.array([2.0, 1.0])})
    for i, seed in enumerate(SEEDS):
        serial = prob.init_params(torch.Generator().manual_seed(seed))
        member = res.member(i)
        for a, b in zip(parameters(member), parameters(serial), strict=True):
            assert torch.equal(a, b) and not a.requires_grad
    i, best = res.best_member()
    assert i == 1 and torch.equal(parameters(best)[0], parameters(stack)[0][1])


@pytest.mark.parametrize("var_form", [0, 1])
@pytest.mark.parametrize("mode", ["taylor", "pallas"])
def test_vmapped_gradient_matches_jax(var_form, mode):
    """vmap(grad_and_value(loss)) over the stacked leaves, the data shared,
    against JAX's vmapped gradient at the same stack; under "pallas" every
    field goes through _FieldsFlat's and _FieldsFlatVjp's vmap rules (with
    second derivatives at var_form 0), and no rule falls back to "taylor"."""
    jprob, stack, jgrads, jaux = jax_case(var_form)
    prob = tv.build(configs(var_form, mode)[1], device="cpu")
    tstack = ensemble._detached(tv.params_from_jax(stack, dtype=torch.float64))
    calls = {"fwd": 0, "vjp": 0, "b2": 0}

    def count(name, fn, wrap=staticmethod):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)

        return wrap(wrapped)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ff._FieldsFlat, "vmap", count("fwd", ff._FieldsFlat.vmap))
        mp.setattr(ff._FieldsFlatVjp, "vmap", count("vjp", ff._FieldsFlatVjp.vmap))
        mp.setattr(ff, "fields_flat_bwd_reference", count("b2", ff.fields_flat_bwd_reference, lambda f: f))
        with one_torch_thread():
            grads, (loss, aux) = torch.func.vmap(torch.func.grad_and_value(
                lambda p: prob.loss_fn(p, prob.data), has_aux=True))(tstack)
    # one rule call a field evaluation, B2's plain version once for each member with second derivatives
    b2 = len(SEEDS) if var_form == 0 else 0
    assert calls == ({"fwd": 1, "vjp": 1, "b2": b2} if mode == "pallas" else {"fwd": 0, "vjp": 0, "b2": 0})
    for k, v in aux.items():
        np.testing.assert_allclose(tnp(v), jaux[k], **GRAD_TOL, err_msg=k)
    np.testing.assert_allclose(tnp(loss), jaux["loss"], **GRAD_TOL)
    for (name, j), t in zip(named_leaves(jgrads), parameters(grads), strict=True):
        np.testing.assert_allclose(tnp(t), j, **GRAD_TOL, err_msg=name)


def test_vjp_rule_batched_over_parameters_is_each_members_vjp():
    """_FieldsFlatVjp's vmap rule with the parameters (and the cotangent)
    batched: each member's VJP equals the unbatched VJP of that member, bit
    for bit (the same plain version runs once for each member), with X
    batched or shared, firsts and second derivatives."""
    spec = tv.build(configs(0)[1], device="cpu").spec
    rng = np.random.default_rng(5)
    nets = [[{"W": torch.tensor(rng.standard_normal((a, b))), "b": torch.tensor(rng.standard_normal(b))}
             for a, b in zip(spec.layers[:-1], spec.layers[1:])] for _ in range(3)]
    flat = [torch.stack(ts) for ts in zip(*(ff._flatten(n) for n in nets))]
    X = torch.tensor(rng.uniform(-1, 1, (3, 11, 2)))
    for second in (True, False):
        F = 5 if second else 3
        g = torch.tensor(rng.standard_normal((3, 11, F)))
        for x_dim in (0, None):
            Xb = X if x_dim == 0 else X[0]
            got = torch.func.vmap(lambda gi, xi, *fi: ff._FieldsFlatVjp.apply(spec, 2, second, True, gi, xi, *fi),
                                  in_dims=(0, x_dim) + (0,) * len(flat))(g, Xb, *flat)
            for i in range(3):
                want = ff._fields_flat_vjp(spec, 2, second, True, g[i], X[i] if x_dim == 0 else X[0], ff._flatten(nets[i]))
                for a, b in zip(got, want, strict=True):
                    assert torch.equal(a[i], b)
            out = torch.func.vmap(lambda xi, *fi: ff._FieldsFlat.apply(spec, 2, second, xi, *fi),
                                  in_dims=(x_dim,) + (0,) * len(flat))(Xb, *flat)
            for i in range(3):
                want = ff.fields_flat_reference(spec, nets[i], X[i] if x_dim == 0 else X[0], 2, second)
                assert torch.equal(out[i], want)


@pytest.mark.parametrize("mode", ["taylor", "pallas"])
def test_train_ensemble_steps_match_jax(mode):
    """Three train_ensemble steps, a record each, from JAX's stacked draw
    (the port's init_ensemble patched to return it): the stacked params and
    every history entry against JAX's train_ensemble to 1e-8, the history
    [n_records, S], seed_steps_per_sec = steps/s x S, and best_member."""
    train = dict(iterations=3, check_every=1)
    jprob, stack, _, _ = jax_case(0)
    jres = _jax_train_ensemble(train)
    prob = tv.build(configs(0, mode, **train)[1], device="cpu")
    with pytest.MonkeyPatch.context() as mp, one_torch_thread():
        mp.setattr(ensemble, "init_ensemble", lambda p, seeds: tv.params_from_jax(stack, dtype=torch.float64))
        res = tv.train_ensemble(prob, seeds=SEEDS, verbose=False)
    assert res.iterations_run == 3 and res.seeds == list(SEEDS)
    for (name, j), t in zip(named_leaves(jax.tree.map(np.asarray, jres.params_stack)), parameters(res.params_stack),
                            strict=True):
        np.testing.assert_allclose(tnp(t), j, **STEP_TOL, err_msg=name)
    assert sorted(res.history) == sorted(jres.history)
    for k, v in jres.history.items():
        assert res.history[k].shape == v.shape == (3, 2)
        np.testing.assert_allclose(res.history[k], v, **STEP_TOL, err_msg=k)
    assert res.seed_steps_per_sec == res.steps_per_sec * 2
    i, best = res.best_member()
    assert i == int(np.argmin(res.final_aux["loss"]))
    np.testing.assert_allclose(tnp(prob.loss_fn(best, prob.data)[0]), res.final_aux["loss"][i], rtol=1e-12)


_JAX_ENSEMBLES = {}


def _jax_train_ensemble(train):
    key = tuple(sorted(train.items()))
    if key not in _JAX_ENSEMBLES:
        _JAX_ENSEMBLES[key] = jv.train_ensemble(jv.build(configs(0, **train)[0]), seeds=SEEDS, verbose=False)
    return _JAX_ENSEMBLES[key]


def test_one_member_step_equals_its_serial_train():
    """After one step every member equals its serial `train` twin at the
    same seed (the JAX package's test_ensemble_single_step_matches_serial),
    and a threshold above the largest loss stops the run at its first
    record; `mesh` raises."""
    prob = tv.build(configs(1, iterations=1, check_every=1)[1], device="cpu")
    with one_torch_thread():
        res = tv.train_ensemble(prob, seeds=SEEDS, verbose=False)
        for i, seed in enumerate(SEEDS):
            serial = tv.train(prob, tv.TrainConfig(iterations=1, check_every=1, seed=seed), verbose=False)
            for a, b in zip(parameters(res.member(i)), parameters(serial.params), strict=True):
                np.testing.assert_allclose(tnp(a), tnp(b), rtol=1e-12, atol=1e-15)
            np.testing.assert_allclose(res.final_aux["loss"][i], serial.final_aux["loss"], rtol=1e-12)
        stopped = tv.train_ensemble(prob, tv.TrainConfig(iterations=5, check_every=1, threshold=1e9),
                                    seeds=SEEDS, verbose=False)
    assert stopped.iterations_run == 1 and stopped.history["loss"].shape == (1, 2)
    with pytest.raises(NotImplementedError, match="queue A item 24"):
        tv.train_ensemble(prob, seeds=SEEDS, verbose=False, mesh=object())


@pytest.mark.parametrize("family", ["kovasznay", "taylorgreen"])
def test_system_family_ensembles_train(family):
    """The vector-output NS systems (the JVP engine) train as a stacked
    fleet: every member's loss finite and falling (the JAX package's
    test_ensemble_system_families)."""
    name, base = FAMILIES[family]
    cfg = getattr(tv, name)(**dict(base, dtype="float64", inverse=False),
                            train=tv.TrainConfig(iterations=20, check_every=10))
    with one_torch_thread():
        res = tv.train_ensemble(tv.build(cfg, device="cpu"), seeds=(0, 1), verbose=False)
    losses, first = res.final_aux["loss"], res.history["loss"][0]
    assert losses.shape == (2,) and np.all(np.isfinite(losses)) and np.all(losses < first), (losses, first)


def test_reduced_precision_and_slope_ensemble():
    """An ensemble under matmul precision "high" with an adaptive slope (the
    TF32 function's generated vmap rule, the slope's leaves stacked): on the
    CPU its records equal the "highest" ensemble's."""
    out = {}
    for prec in ("highest", "high"):
        cfg = dataclasses.replace(configs(1, iterations=4, check_every=2)[1], matmul_precision=prec,
                                  adaptive_slope=True, activation="gelu")
        with one_torch_thread():
            out[prec] = tv.train_ensemble(tv.build(cfg, device="cpu"), seeds=SEEDS, verbose=False)
    assert parameters(out["high"].params_stack)[2].shape == (2,)  # the first layer's slope, one a member
    for k, v in out["highest"].history.items():
        np.testing.assert_allclose(out["high"].history[k], v, rtol=1e-12, err_msg=k)


def test_member_slices_are_views_the_pointer_table_reads():
    """The vmap rules hand each member's launch the member's own slices of
    the stacked leaves: contiguous views whose data_ptr is the stack's plus
    i times the member's stride, which B1's LayerPointers table holds (the
    table is built the same way on the card; here on CPU tensors)."""
    prob = tv.build(dataclasses.replace(configs(1)[1], dtype="float32"), device="cpu")
    flat = ff._flatten(ensemble.init_ensemble(prob, (0, 1, 2))["net"])
    for i in range(3):
        member = [ff._member(t, 0, i) for t in flat]
        table = ff.layer_pointers(prob.spec, ff._unflatten(member), torch.device("cpu"))
        for l in range(prob.spec.n_layers):
            W, b = flat[2 * l], flat[2 * l + 1]
            assert table.W[l] == W.data_ptr() + i * W.stride(0) * W.element_size() == member[2 * l].data_ptr()
            assert table.b[l] == b.data_ptr() + i * b.stride(0) * b.element_size() == member[2 * l + 1].data_ptr()
