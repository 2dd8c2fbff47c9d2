"""Port parity, the element mesh (hpvpinns_tpu_torch/parallel/sharding.py)
at world 2, against the JAX package's unsharded problem and the port's
unsharded training, in float64 on the CPU.

One gloo world of two processes (tests/torch_mesh_cases.py, suite
"sharding") runs every multi-rank case once and writes its numbers; the
tests here hold them to the references computed in this process.  The
fixture is tests/test_sharding.py's: Poisson-2D, E 12 (4 x 3), n_quad 6,
4 x 4 tests; the padding has its own case, a Poisson-1D of 3 elements
(padded to 4).  Tolerances are tests/test_sharding.py's: the loss to 1e-10,
the gradients to 1e-8 / 1e-12, 20 Adam steps to 1e-8, Gauss-Newton "cg" to
1e-5 and "qr" to 1e-8, the ensemble to 1e-9, the trainer's GN phase to 1e-4.
"""

import dataclasses
import functools
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import hpvpinns_tpu as jv  # noqa: E402
import hpvpinns_tpu_torch as tv  # noqa: E402
from hpvpinns_tpu.parallel.sharding import pad_elements as jpad_elements  # noqa: E402
from hpvpinns_tpu.parallel.sharding import pad_points as jpad_points  # noqa: E402
from hpvpinns_tpu_torch.parallel import distributed  # noqa: E402
from hpvpinns_tpu_torch.parallel.multihost_check import spawn  # noqa: E402
from hpvpinns_tpu_torch.parallel.sharding import (  # noqa: E402
    POINT_AXIS,
    Axis,
    pad_elements,
    pad_points,
    points_of,
    tag_points,
)
from hpvpinns_tpu_torch.problems.base import parameters  # noqa: E402
from test_torch_parity import jax_loss_and_grads, named_leaves, one_torch_thread, shared_params, tnp, to_jax  # noqa: E402
from torch_mesh_cases import TRAIN, family_config, p1d_config, p2d_config, shared_tree  # noqa: E402

CASES = str(Path(__file__).resolve().parent / "torch_mesh_cases.py")
LOSS_TOL = dict(rtol=1e-10)
GRAD_TOL = dict(rtol=1e-8, atol=1e-12)
F64 = torch.float64


@pytest.fixture(scope="module")
def world():
    """Both ranks' results of the "sharding" suite."""
    return spawn([sys.executable, CASES, "sharding"], 2, timeout_s=300)


def jax_config(tcfg):
    """The JAX package's config of the same class and fields."""
    cls = getattr(jv, type(tcfg).__name__)
    names = {f.name for f in dataclasses.fields(cls)} - {"train"}
    return cls(**{f.name: getattr(tcfg, f.name) for f in dataclasses.fields(tcfg) if f.name in names})


@functools.lru_cache(maxsize=None)
def port_problem(key):
    return tv.build({"p2d": p2d_config, "p1d": p1d_config}[key](), device="cpu")


@functools.lru_cache(maxsize=None)
def jax_reference(key):
    """JAX's unsharded (aux, flat gradients) at the shared params."""
    tprob = port_problem(key)
    aux, grads = jax_loss_and_grads(jv.build(jax_config(tprob.config)), to_jax(shared_params(tprob)))
    return {k: float(v) for k, v in aux.items()}, np.concatenate([np.ravel(g) for _, g in named_leaves(grads)])


def port_params(prob):
    return tv.params_from_jax(shared_tree(prob), dtype=F64)


def test_pad_elements_equals_jax():
    """The inert padding (mask and f_proj zero, n_test at least 1, the rest
    edge-padded) gives JAX's arrays exactly, E 12 -> 16."""
    tel = port_problem("p2d").data["elements"]
    jel = jpad_elements(jv.build(jax_config(port_problem("p2d").config)).data["elements"], 8)
    padded = pad_elements(tel, 8)
    assert padded.mask.shape[0] == 16
    for f in dataclasses.fields(padded):
        np.testing.assert_array_equal(tnp(getattr(padded, f.name)), np.asarray(getattr(jel, f.name)), err_msg=f.name)


def test_pad_points_equals_jax():
    """The fast quadrature axis padded Q 10 -> 16: the coordinates
    edge-padded, the weighted basis columns zero, as JAX's."""
    tcfg = p1d_config(n_elements=2)
    tprob, jprob = tv.build(tcfg, device="cpu"), jv.build(jax_config(tcfg))
    tel, tb = pad_points(tprob.data["elements"], tprob.data["basis"], 8)
    jel, jb = jpad_points(jprob.data["elements"], jprob.data["basis"], 8)
    assert tel.x.shape[-1] == 16 and tb.wphi.shape[-1] == 16
    for t, j in ((tel, jel), (tb, jb)):
        for f in dataclasses.fields(t):
            np.testing.assert_array_equal(tnp(getattr(t, f.name)), np.asarray(getattr(j, f.name)), err_msg=f.name)


def test_basis_to_keeps_the_point_axis():
    """The point Axis reaches the contractions only through the tag on the
    fast basis tensors; moving the basis with its `.to` keeps it on the new
    tensors, and an untagged basis stays untagged."""
    basis = port_problem("p1d").data["basis"]
    axis = Axis(POINT_AXIS, None, 2, 1, root=False, mesh_group=None)
    tagged = dataclasses.replace(basis, **{n: tag_points(getattr(basis, n).clone(), axis)
                                           for n in ("wphi", "wdphi", "wd2phi")})
    moved = tagged.to(torch.float32)
    for name in ("wphi", "wdphi", "wd2phi"):
        assert getattr(moved, name) is not getattr(tagged, name) and points_of(getattr(moved, name)) is axis
    assert points_of(moved.dphi_b) is None and points_of(basis.to(torch.float32).wphi) is None


def test_pad_elements_preserves_loss():
    prob = port_problem("p2d")
    params = port_params(prob)
    padded = dict(prob.data, elements=pad_elements(prob.data["elements"], 8))
    with one_torch_thread():
        np.testing.assert_allclose(tnp(prob.loss_fn(params, padded)[0]), tnp(prob.loss_fn(params, prob.data)[0]),
                                   rtol=1e-12)


def test_distributed_initialize_single_process():
    """One process and no cluster environment: a no-op that reports the
    topology, idempotent (tests/test_sharding.py:150-161)."""
    info = distributed.initialize()
    assert info == {"process_index": 0, "process_count": 1, "local_devices": 1, "global_devices": 1}
    assert distributed.initialize() == info


def test_psum_rule_counts_replicated_terms_once(world):
    """y = psum(c_r x) + once(x^2) with c_r = rank + 1 and x = 2: y is the
    global 3x + x^2 on both ranks; rank 0's gradient share is c_0 + 2x, rank
    1's c_1 alone, and the summed shares the global 3 + 2x: the replicated
    term is counted once, not once a rank (torch.distributed.nn's all_reduce
    would give 2 (3 + 2x) here)."""
    shares = [r["psum_rule"] for r in world]
    assert [s["y"] for s in shares] == [10.0, 10.0]
    assert [s["share"] for s in shares] == [5.0, 2.0]
    assert [s["summed"] for s in shares] == [7.0, 7.0]


@pytest.mark.parametrize("key", ["p2d", "p1d"])
def test_sharded_loss_and_grads_equal_jax_unsharded(world, key):
    """Each rank's loss, aux and summed gradient shares at the shared
    params against JAX's unsharded problem: E 12 split 6 + 6, and E 3
    padded to 4 and split 2 + 2."""
    jaux, jgrads = jax_reference(key)
    for r in world:
        got = r["p2d" if key == "p2d" else "p1d_padded"]
        np.testing.assert_allclose(got["loss"], jaux["loss"], **LOSS_TOL)
        assert sorted(got["aux"]) == sorted(jaux)
        for k, v in jaux.items():
            np.testing.assert_allclose(got["aux"][k], v, **LOSS_TOL, err_msg=k)
        np.testing.assert_allclose(got["grads"], jgrads, **GRAD_TOL)


@functools.lru_cache(maxsize=None)
def unsharded_train(iterations, gn_iterations=0):
    prob = port_problem("p2d")
    cfg = tv.TrainConfig(iterations=iterations, check_every=TRAIN["check_every"] * (2 if gn_iterations else 1),
                         gn_iterations=gn_iterations, gn_solve="cg")
    with one_torch_thread():
        return tv.train(prob, cfg, params=port_params(prob), verbose=False)


def test_adam_on_mesh_equals_unsharded(world):
    """20 Adam steps on the mesh (one all-reduce of the flat gradients a
    step, eager under gloo) against the port's unsharded `train`."""
    ref = unsharded_train(TRAIN["iterations"])
    for r in world:
        assert r["adam"]["chunk_mode"] == "eager"
        np.testing.assert_allclose(r["adam"]["loss"], ref.history["loss"], rtol=1e-8)


def test_trainer_gn_phase_on_mesh(world):
    """run --mesh with a gn_iterations phase: the trainer hands its shard to
    gauss_newton, and the three-phase result matches unsharded."""
    ref = unsharded_train(40, gn_iterations=3)
    for r in world:
        assert r["train_gn"]["phases"] == ["adam", "gn"]
        np.testing.assert_allclose(r["train_gn"]["final"], ref.final_aux["loss"], rtol=1e-4)


@pytest.mark.parametrize("solve,iterations,rtol", [("cg", 5, 1e-5), ("qr", 3, 1e-8), ("normal", 3, 1e-8),
                                                   ("lsqr", 3, 1e-5)])
def test_gauss_newton_sharded_matches_unsharded(world, solve, iterations, rtol):
    """LM with the rows sharded: "cg"/"lsqr" sum each matvec over the ranks,
    "qr" gathers J, "normal" sums J^T J and J^T r; the loss after the same
    accepted steps as unsharded, and the parameters (looser for the
    rounding-sensitive Krylov iterates, as tests/test_sharding.py)."""
    prob = port_problem("p2d")
    with one_torch_thread():
        ref = tv.gauss_newton(prob, port_params(prob), iterations=iterations, solve=solve, verbose=False)
    ptol = dict(rtol=1e-2, atol=1e-4) if solve in ("cg", "lsqr") else dict(rtol=1e-6, atol=1e-9)
    for r in world:
        got = r[f"gn_{solve}"]
        assert got["accepted"] == ref.accepted == iterations
        np.testing.assert_allclose(got["loss"], ref.final_aux["loss"], rtol=rtol)
        np.testing.assert_allclose(got["params"], tnp(torch.cat([t.reshape(-1) for t in parameters(ref.params)])),
                                   **ptol)


def test_gauss_newton_row_weights_keep_the_element_mesh_bits(world):
    """On an element mesh every row weight `own` is 1: "qr"'s parameters
    after three steps equal, bit for bit, those of the same run with the
    rows unweighted (the arrangement before the element x point mesh)."""
    for r in world:
        assert r["gn_qr"]["params"] == r["gn_qr_unweighted"]["params"]


def test_gauss_newton_rows_of_the_elements_points(world):
    """AdvDiff's Tikhonov term on a quadratic eps is a row a quadrature
    point of the elements (`reg_resvec_fn.element_rows`): on the mesh its
    rows follow the shard, the padded elements' rows zero, and "qr" on the
    gathered J lands where the unsharded LM lands."""
    prob = tv.build(family_config("advdiff_reg"), device="cpu")
    with one_torch_thread():
        ref = tv.gauss_newton(prob, port_params(prob), iterations=2, solve="qr", verbose=False)
    for r in world:
        assert r["gn_advdiff_reg"]["accepted"] == ref.accepted == 2
        np.testing.assert_allclose(r["gn_advdiff_reg"]["loss"], ref.final_aux["loss"], rtol=1e-8)


def test_ensemble_on_mesh_matches_unsharded(world):
    """Seeds (0, 1, 2), 20 steps: the vmapped shares, one all-reduce of the
    stacked gradients outside the vmap, against the unsharded ensemble."""
    with one_torch_thread():
        ref = tv.train_ensemble(port_problem("p2d"), tv.TrainConfig(**TRAIN), seeds=(0, 1, 2), verbose=False)
    for r in world:
        np.testing.assert_allclose(r["ensemble"]["loss"], ref.final_aux["loss"], rtol=1e-9)


def test_ranks_agree_and_import_no_jax(world):
    """Both ranks report the same world, the same losses bit for bit (the
    parameters stay replicated), and no JAX module."""
    assert [r["topology"]["process_index"] for r in world] == [0, 1]
    assert all(r["mesh"] == {"elements": 2} and r["jax_modules"] == [] for r in world)
    for key in ("adam", "train_gn", "ensemble"):
        assert world[0][key]["loss"] == world[1][key]["loss"], key
