"""Port parity, Poisson-3D: the mesh, the element arrays, the boundary points
and the test grid, the loss, aux and gradients in forms 0/1 and with the
hard-BC ansatz, the three-axis fused fields and a short two-phase training
run, against the JAX package on the CPU at a tiny size (2x1x1 elements,
4 quadrature points, 3^3 test functions, a (3,6,6,1) tanh net), from the same
numpy parameters.

Tolerances: host arrays to 1e-12; the f64 loss, aux and gradients against
JAX "taylor" (forms 0/1) and "jvp" (hard BC) to rtol 1e-12; the port's
"pallas" on the CPU (the kernels' plain versions) against JAX "taylor" to
1e-10; in float32 against JAX "pallas" (interpret mode) the loss at rtol
1e-6 and each gradient leaf at 2e-4 of its largest entry, as
tests/test_torch_advdiff.py holds the f32 kernels.  The solution is steep
in x only, so a transposed axis would not pass.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import hpvpinns_tpu as jv  # noqa: E402
import hpvpinns_tpu_torch as tv  # noqa: E402
from hpvpinns_tpu.ops.pallas_fields import pallas_fields_3d  # noqa: E402
from hpvpinns_tpu.problems import poisson3d as jp3d  # noqa: E402
from hpvpinns_tpu_torch.ops.fields import scalar_fields_3d  # noqa: E402
from hpvpinns_tpu_torch.ops.fused_fields import fused_fields_3d  # noqa: E402
from hpvpinns_tpu_torch.models.mlp import mlp_apply  # noqa: E402
from hpvpinns_tpu_torch.problems import poisson3d as tp3d  # noqa: E402
from hpvpinns_tpu_torch.problems.base import parameters  # noqa: E402
from test_torch_parity import (  # noqa: E402
    compare_loss_and_grads, jax_loss_and_grads, named_leaves, shared_params, tnp, to_jax, train_gn_tail,
)

TINY = dict(n_elements_x=2, n_elements_y=1, n_elements_z=1, n_quad=4, n_test_x=3, n_test_y=3, n_test_z=3,
            layers=(3, 6, 6, 1), n_bound=8, dtype="float64")
F64 = dict(rtol=1e-12, atol=1e-14)


def configs(**kw):
    kw = {**TINY, **kw}
    tkw = kw.pop("train", dict(iterations=10, check_every=5))
    return (jv.Poisson3DConfig(**kw, train=jv.TrainConfig(**tkw)),
            tv.Poisson3DConfig(**kw, train=tv.TrainConfig(**tkw)))


def build_both(**kw):
    jcfg, tcfg = configs(**kw)
    return jv.build(jcfg), tv.build(tcfg, device="cpu")


def test_presets_match_jax_fields():
    for name in ("poisson3d_quality", "poisson3d_precision"):
        for hard_bc in (False, True):
            t, j = getattr(tv, name)(hard_bc=hard_bc), getattr(jv, name)(hard_bc=hard_bc)
            assert dataclasses.asdict(t) == dataclasses.asdict(j), name
    assert dataclasses.asdict(tv.Poisson3DConfig()) == dataclasses.asdict(jv.Poisson3DConfig())
    train_gn_tail(tv.build(dataclasses.replace(tv.poisson3d_precision(), **TINY), device="cpu"))


def test_mesh_elements_boundary_and_test_grid_match_jax():
    jprob, tprob = build_both(n_test_x_per_elem=(3, 2))
    jm, tm = jprob.extras["mesh"], tprob.extras["mesh"]
    assert tm.shape == jm.shape == (2, 1, 1) and tm.n_elem == jm.n_elem
    for a, b in zip(tm.jacobians(), jm.jacobians()):
        np.testing.assert_array_equal(a, b)
    xi = np.linspace(-1, 1, 4)
    for a, b in zip(tm.map_points(xi, xi[:3], xi[:2]), jm.map_points(xi, xi[:3], xi[:2])):
        np.testing.assert_array_equal(a, b)
    for key in ("elements", "basis_x", "basis_y", "basis_z"):
        t, j = tprob.data[key], jprob.data[key]
        for f in dataclasses.fields(t):
            np.testing.assert_allclose(tnp(getattr(t, f.name)), np.asarray(getattr(j, f.name)), **F64, err_msg=f.name)
    np.testing.assert_array_equal(tnp(tprob.data["xb"]), np.asarray(jprob.data["xb"]))
    np.testing.assert_allclose(tnp(tprob.data["ub"]), np.asarray(jprob.data["ub"]), **F64)
    assert tprob.data["xb"].shape == (6 * 8, 3)
    np.testing.assert_array_equal(tprob.test_points, jprob.test_points)
    np.testing.assert_allclose(tprob.test_values, jprob.test_values, **F64)
    assert tprob.test_points.shape == (41**3, 3) and tprob.extras["test_grid_shape"] == (41, 41, 41)
    assert sorted(tprob.extras) == sorted(jprob.extras)


@pytest.mark.parametrize("case", ["form0", "form1", "jvp_form0", "hard_bc_form0", "hard_bc_form1"])
def test_loss_aux_and_gradients_match_jax(case):
    kw = {"var_form": int(case[-1]), "hard_bc": case.startswith("hard_bc")}
    if case.startswith("jvp"):
        kw["deriv_mode"] = "jvp"
    jprob, tprob = build_both(**kw)
    compare_loss_and_grads(jprob, tprob, tight=F64)


@pytest.mark.parametrize("var_form", [0, 1])
def test_pallas_on_the_cpu_is_taylor(var_form):
    jprob, _ = build_both(var_form=var_form)
    _, tprob = build_both(var_form=var_form, deriv_mode="pallas")
    compare_loss_and_grads(jprob, tprob)


@pytest.mark.parametrize("var_form", [0, 1])
def test_pallas_f32_matches_jax_pallas(var_form):
    """float32 under "pallas": the port's plain versions against the JAX
    kernels in interpret mode (form 0's gradient is B2's in JAX)."""
    jprob, tprob = build_both(var_form=var_form, deriv_mode="pallas", dtype="float32")
    tree = jax.tree.map(lambda a: a.astype(np.float32), shared_params(tprob))
    tparams = tv.params_from_jax(tree, dtype=torch.float32)
    tloss, _ = tprob.loss_fn(tparams, tprob.data)
    tgrads = torch.autograd.grad(tloss, parameters(tparams))
    jaux, jgrads = jax_loss_and_grads(jprob, to_jax(tree))
    np.testing.assert_allclose(tnp(tloss), float(jaux["loss"]), rtol=1e-6)
    for (name, j), t in zip(named_leaves(jgrads), tgrads):
        j = np.asarray(j)
        np.testing.assert_allclose(tnp(t), j, rtol=0, atol=2e-4 * np.abs(j).max(), err_msg=name)


@pytest.mark.parametrize("second", [True, False])
def test_fused_fields_3d_contract_matches_jax(second):
    """Keys in pallas_fields_3d's order, and values: against JAX "pallas" in
    float32 and, in float64, against the JVP engine on distinct x, y, z
    (so that each column is its own axis's derivative)."""
    _, tprob = build_both()
    tree = shared_params(tprob)
    rng = np.random.default_rng(2)
    x, y, z = (rng.uniform(-1, 1, (2, 3, 4)) for _ in range(3))
    t32 = tv.params_from_jax(tree, dtype=torch.float32)
    got = fused_fields_3d(tprob.spec, t32["net"], *(torch.tensor(a, dtype=torch.float32) for a in (x, y, z)),
                          second=second)
    want = pallas_fields_3d(tprob.spec, to_jax(jax.tree.map(lambda a: a.astype(np.float32), tree))["net"],
                            *(jnp.asarray(a, jnp.float32) for a in (x, y, z)), second=second)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(tnp(got[k]), np.asarray(want[k]), rtol=2e-5, atol=2e-5, err_msg=k)
    t64 = tv.params_from_jax(tree, dtype=torch.float64)
    xyz = [torch.tensor(a) for a in (x, y, z)]
    got = fused_fields_3d(tprob.spec, t64["net"], *xyz, second=second)
    ref = scalar_fields_3d(lambda X: mlp_apply(tprob.spec, t64["net"], X), *xyz, second=second)
    assert sorted(got) == sorted(ref)
    for k in got:
        np.testing.assert_allclose(tnp(got[k]), tnp(ref[k]), rtol=1e-12, atol=1e-13, err_msg=k)


def test_boundary_points_and_hard_bc_ansatz():
    """Boundary points lie on the six faces (rng draws as JAX's); the hard-BC
    ansatz equals u_exact on the faces for any parameters."""
    jcfg, tcfg = configs(hard_bc=True)
    tX, tu = tp3d.boundary_points(tcfg, np.random.default_rng(4), tp3d.u_exact)
    jX, ju = jp3d.boundary_points(jcfg, np.random.default_rng(4), jp3d.u_exact)
    np.testing.assert_array_equal(tX, jX)
    np.testing.assert_array_equal(tu, ju)
    assert np.all(np.isclose(np.abs(tX), 1.0).any(axis=1))
    prob = tv.build(tcfg, device="cpu")
    params = tv.params_from_jax(shared_params(prob), dtype=torch.float64)
    with torch.no_grad():
        u = prob.apply(params, torch.tensor(tX))
    np.testing.assert_allclose(tnp(u), tu, rtol=1e-12, atol=1e-12)


def test_training_and_evaluate_match_jax():
    """6 Adam steps under "pallas" (the plain versions on the CPU) against
    JAX "taylor" from the same parameters: records to rtol 1e-8, and
    evaluate() on the 41^3 grid (the L-BFGS phase is held to JAX's in
    tests/test_torch_trainer.py); strong_residual raises the ValueError
    that JAX's raises."""
    train = dict(iterations=6, check_every=3)
    jprob, _ = build_both(var_form=0, train=train)
    _, tprob = build_both(var_form=0, train=train, deriv_mode="pallas")
    tree = shared_params(tprob)
    jres = jv.train(jprob, params=to_jax(tree), verbose=False)
    tres = tv.train(tprob, params=tv.params_from_jax(tree, dtype=torch.float64), verbose=False)
    for k in ("loss", "lossb", "lossv"):
        np.testing.assert_allclose(tres.history[k], jres.history[k], rtol=1e-8, err_msg=k)
    want = jv.evaluate_problem(jprob, jres.params)
    got = tv.evaluate_problem(tprob, tres.params)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-8, err_msg=k)
    message = "no strong form registered for problem 'poisson3d'"
    with pytest.raises(ValueError, match=message):
        tv.strong_residual(tprob, tres.params)
    with pytest.raises(ValueError, match=message):
        jv.evaluate.strong_residual(jprob, jres.params)


def test_b2_shared_memory_ceiling_at_three_axes():
    """B2's resident form at n_dirs 3 (bwd_smem_bytes, the kernel's own
    count): poisson3d_quality's (3,48,48,48,1) fits the H100's opt-in
    232,448 B per block, one block per SM; from width 56 with three hidden
    layers it does not, and bwd_plan gives those networks the layered form
    (per-layer GEMMs, its stash in device memory) instead."""
    from hpvpinns_tpu_torch.ops.fused_fields import bwd_plan, bwd_smem_bytes

    h100_opt_in = 232448
    got = {w: bwd_smem_bytes((3, w, w, w, 1), 3) for w in (48, 52, 56)}
    assert got == {48: 200864, 52: 220928, 56: 241504}
    assert got[52] <= h100_opt_in < got[56]
    plan = bwd_plan((3, 48, 48, 48, 1), 3, 8000)
    assert (plan.tiles_per_block, plan.n_blocks, plan.smem_bytes) == (1, 500, 200864)
    assert [bwd_plan((3, w, w, w, 1), 3, 8000).form for w in (48, 52, 56, 64)] == [
        "resident", "resident", "layered", "layered"]
