"""Port parity, fused field kernel (ops/fused_fields.py).

On the CPU, `fields_flat` runs the kernel's plain PyTorch version; it is held
against the JAX package's `fields_flat`, whose Pallas kernel runs in
interpret mode here exactly as tests/test_pallas_fields.py runs it.  float32,
with that file's tolerances: rtol 2e-5 / atol 1e-6 for fields, rtol 2e-4 /
atol 1e-5 for gradients.  The CUDA kernel itself runs only on a GPU
(chip_smoke.py holds it against the same plain version there)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hpvpinns_tpu.models.mlp import MLP as JMLP  # noqa: E402
from hpvpinns_tpu.ops.pallas_fields import fields_flat as jfields_flat  # noqa: E402
from hpvpinns_tpu.ops.pallas_fields import pallas_fields_2d  # noqa: E402
from hpvpinns_tpu_torch.convert import params_from_jax  # noqa: E402
from hpvpinns_tpu_torch.models.mlp import MLP, init_mlp  # noqa: E402
from hpvpinns_tpu_torch.ops.fused_fields import (  # noqa: E402
    BWD_RESIDENT_WIDTH,
    FWD_MAX_WIDTH,
    FWD_MIN_BLOCKS,
    MAX_LAYERS,
    SMEM_PER_BLOCK,
    bwd_plan,
    check_kernel_args,
    fields_flat,
    fields_flat_bwd_reference,
    fields_flat_reference,
    fused_fields_2d,
    fused_fields_bwd_kernel,
    fused_fields_bwd_layered_kernel,
    fused_fields_kernel,
    fwd_plan,
    fwd_smem_bytes,
    layer_pointers,
    pack_params,
)

FIELD_TOL = dict(rtol=2e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=1e-5)
SLICE = (2, 20, 20, 20, 1)


def make(layers, act, seed=0):
    """One network for both packages: Xavier-scaled normal weights and small
    biases from numpy, handed to JAX as arrays and to the port through
    params_from_jax."""
    rng = np.random.default_rng(seed)
    tree = {"net": [
        {"W": (rng.standard_normal((a, b)) * np.sqrt(2.0 / (a + b))).astype(np.float32),
         "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
        for a, b in zip(layers[:-1], layers[1:])
    ], "pde": {}}
    jp = jax.tree.map(jnp.asarray, tree["net"])
    tp = params_from_jax(tree, dtype=torch.float32)["net"]
    return JMLP(layers=layers, activation=act), jp, MLP(layers=layers, activation=act), tp


def inputs(P, d, seed=1):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (P, d)).astype(np.float32)


@pytest.mark.parametrize(
    "layers,act,n_dirs,second",
    [
        (SLICE, "tanh", 2, False),  # the slice: var_form 1, d = 2
        ((1, 12, 12, 1), "sin", 1, True),
        ((3, 16, 16, 1), "sin", 3, True),
    ],
)
def test_fields_flat_matches_jax_pallas(layers, act, n_dirs, second):
    jspec, jp, spec, tp = make(layers, act)
    X = inputs(150, layers[0])
    got = fields_flat(spec, tp, torch.as_tensor(X), n_dirs, second)
    want = np.asarray(jfields_flat(jspec, jp, jnp.asarray(X), n_dirs, second))
    assert got.shape == want.shape == (150, 1 + n_dirs * (2 if second else 1))
    np.testing.assert_allclose(got.detach().numpy(), want, **FIELD_TOL)


def test_fields_flat_gradient_matches_jax():
    """second=False backward (autograd through the Taylor propagation) vs
    jax.grad of the JAX fields_flat (its XLA-Taylor VJP)."""
    jspec, jp, spec, tp = make(SLICE, "tanh", seed=3)
    X = inputs(150, 2, seed=4)
    g = np.random.default_rng(5).standard_normal((150, 3)).astype(np.float32)
    Xt = torch.as_tensor(X).requires_grad_(True)
    (fields_flat(spec, tp, Xt, 2, False) * torch.as_tensor(g)).sum().backward()
    jg_p, jg_x = jax.grad(
        lambda p, x: (jfields_flat(jspec, p, x, 2, False) * g).sum(), argnums=(0, 1)
    )(jp, jnp.asarray(X))
    np.testing.assert_allclose(Xt.grad.numpy(), np.asarray(jg_x), **GRAD_TOL)
    for t, j in zip(tp, jg_p):
        for k in ("W", "b"):
            np.testing.assert_allclose(t[k].grad.numpy(), np.asarray(j[k]), **GRAD_TOL)


def test_fused_fields_2d_contract_matches_jax():
    jspec, jp, spec, tp = make(SLICE, "tanh", seed=6)
    x, y = inputs(150, 2, seed=7).T.reshape(2, 3, 50)
    for kw in ({"firsts_only": True}, {}, {"first_y_only": True}):
        tf = fused_fields_2d(spec, tp, torch.as_tensor(x), torch.as_tensor(y), **kw)
        jf = pallas_fields_2d(jspec, jp, jnp.asarray(x), jnp.asarray(y), **kw)
        assert sorted(tf) == sorted(jf)
        for k in tf:
            np.testing.assert_allclose(tf[k].detach().numpy(), np.asarray(jf[k]), **FIELD_TOL, err_msg=k)


def test_second_derivative_gradient_is_the_plain_backward_on_cpu():
    """On a CPU tensor the second=True gradient is fields_flat_bwd_reference,
    exactly, in the caller's dtype; without X's gradient it skips gX."""
    spec = MLP(layers=(2, 8, 8, 1), activation="sin")
    tp = init_mlp(spec, torch.Generator().manual_seed(0), dtype=torch.float64)
    X, g = (torch.as_tensor(a).double() for a in (inputs(20, 2), np.random.default_rng(2).standard_normal((20, 5))))
    Xt = X.clone().requires_grad_(True)
    leaves = [t for layer in tp for t in (layer["W"], layer["b"])]
    grads = torch.autograd.grad((fields_flat(spec, tp, Xt, 2, True) * g).sum(), leaves + [Xt])
    rgrads, rgx = fields_flat_bwd_reference(spec, tp, X, g, 2)
    rleaves = [t for layer in rgrads for t in (layer["W"], layer["b"])]
    for a, b in zip(grads, rleaves + [rgx]):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    rgrads2, rgx2 = fields_flat_bwd_reference(spec, tp, X, g, 2, want_x=False)
    assert rgx2 is None
    torch.testing.assert_close(rgrads2[0]["W"], rgrads[0]["W"], rtol=0, atol=0)


def test_plain_version_is_the_taylor_propagation_in_f64():
    """fields_flat on a CPU tensor keeps the caller's dtype (float64 here) and
    equals fields_flat_reference exactly."""
    spec = MLP(layers=(2, 8, 8, 1), activation="tanh")
    tp = init_mlp(spec, torch.Generator().manual_seed(0), dtype=torch.float64)
    X = torch.as_tensor(inputs(20, 2)).double()
    out = fields_flat(spec, tp, X, 2, False)
    assert out.dtype == torch.float64
    torch.testing.assert_close(out, fields_flat_reference(spec, tp, X, 2, False), rtol=0, atol=0)


def test_pack_params_layout():
    spec = MLP(layers=(2, 5, 3, 1))
    tp = init_mlp(spec, torch.Generator().manual_seed(0))
    packed, widths = pack_params(spec, tp)
    assert widths.dtype == np.int32 and widths.tolist() == [2, 5, 3, 1]
    assert packed.is_contiguous() and packed.numel() == 2 * 5 + 5 + 5 * 3 + 3 + 3 * 1 + 1
    off = 0
    for layer in tp:  # W_l [in, out] row-major, then b_l
        for t in (layer["W"], layer["b"]):
            np.testing.assert_array_equal(packed[off : off + t.numel()].detach().numpy(), t.detach().reshape(-1).numpy())
            off += t.numel()


def test_kernel_rejects_what_it_does_not_take():
    """The kernel wrapper raises before any launch: on a CPU tensor (the
    plain version is taken only by fields_flat, never by the kernel), above
    the forward kernel's widest width, and for a non-scalar output."""
    spec = MLP(layers=(2, 8, 1))
    tp = init_mlp(spec, torch.Generator().manual_seed(0))
    X = torch.as_tensor(inputs(4, 2))
    with pytest.raises(ValueError, match="CUDA"):
        fused_fields_kernel(spec, tp, X, 2, False)
    assert fused_fields_kernel.launches == 0
    wide = MLP(layers=(2, FWD_MAX_WIDTH + 1, 1))
    with pytest.raises(ValueError, match=f"widths <= {FWD_MAX_WIDTH}"):
        check_kernel_args(wide, [], X, 2, FWD_MAX_WIDTH)
    with pytest.raises(ValueError, match="scalar output"):
        check_kernel_args(MLP(layers=(2, 8, 2)), [], X, 2)
    with pytest.raises(ValueError, match="n_dirs"):
        check_kernel_args(MLP(layers=(1, 8, 1)), [], X, 2)


def test_each_kernel_has_its_own_width_limit():
    """B1 and B2 take width 256 (on a CPU tensor they get as far as the
    device check) and raise at 257; B2's resident form takes width 64 and
    refuses 65, which its layered form takes."""
    X = torch.as_tensor(inputs(4, 2))
    assert (FWD_MAX_WIDTH, BWD_RESIDENT_WIDTH) == (256, 64)
    for width, match in ((FWD_MAX_WIDTH, "CUDA"), (FWD_MAX_WIDTH + 1, f"widths <= {FWD_MAX_WIDTH}")):
        spec = MLP(layers=(2, width, 1))
        tp = init_mlp(spec, torch.Generator().manual_seed(0))
        with pytest.raises(ValueError, match=match):
            fused_fields_kernel(spec, tp, X, 2, True)
        with pytest.raises(ValueError, match=match):
            fused_fields_bwd_layered_kernel.prepare(spec, tp, X, torch.zeros(4, 5), 2)
    for width, form in ((BWD_RESIDENT_WIDTH, "resident"), (BWD_RESIDENT_WIDTH + 1, "layered")):
        assert bwd_plan((2, width, 1), 2, 4).form == form
    with pytest.raises(ValueError, match=f"widths <= {BWD_RESIDENT_WIDTH}"):
        bwd_plan((2, BWD_RESIDENT_WIDTH + 1, 1), 2, 4, form="resident")
    assert fused_fields_kernel.launches == fused_fields_bwd_kernel.launches == 0
    assert fused_fields_bwd_layered_kernel.launches == 0


# chip_smoke.py phase 3's shapes: (layers, n_dirs, second, P) and the plan
# (staged, points per block, neuron-tile groups, blocks) each must get.
PLAN_CASES = {
    "scaled": ((2, 20, 20, 20, 1), 2, False, 16384, (False, 32, 5, 512)),
    "quality": ((2, 48, 48, 48, 48, 1), 2, False, 4096, (False, 16, 12, 256)),
    "sin_d1_second": ((1, 20, 20, 20, 1), 1, True, 1000, (False, 8, 5, 125)),
    "sin_d3_second": ((3, 48, 48, 48, 1), 3, True, 1003, (False, 8, 12, 126)),
    "p1d_record": ((1, 20, 20, 20, 20, 1), 1, True, 80, (False, 8, 5, 10)),
    "p1d_quality": ((1, 30, 30, 30, 1), 1, True, 240, (False, 8, 8, 30)),
    "p2d_scaled_second": ((2, 20, 20, 20, 1), 2, True, 16384, (False, 32, 5, 512)),
    "p2d_quality_second": ((2, 48, 48, 48, 48, 1), 2, True, 4096, (False, 16, 12, 256)),
    "wide_scaled": ((2, 256, 256, 256, 1), 2, False, 16384, (True, 16, 16, 1024)),
    "wide_one_layer": ((2, 256, 1), 2, True, 1000, (True, 16, 16, 63)),
    "wide_mixed": ((1, 200, 40, 1), 1, True, 1000, (True, 16, 16, 63)),
    "wide_sin_d3": ((3, 128, 128, 128, 1), 3, True, 1003, (True, 16, 16, 63)),
}


@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_fwd_plan_at_the_card_check_shapes(name):
    """The plan is a function of the shapes alone: the form (resident up to
    width 64, staged above), points per block (the most that still give
    FWD_MIN_BLOCKS blocks, else the fewest), the groups (a tile for every
    group in every round of the widest layer), and shared memory that fits a
    block of an H100 and is what fwd_smem_bytes says."""
    layers, n_dirs, second, P, (staged, points, groups, blocks) = PLAN_CASES[name]
    plan = fwd_plan(layers, n_dirs, second, P)
    assert (plan.staged, plan.block_points, plan.groups, plan.n_blocks) == (staged, points, groups, blocks)
    assert plan.staged == (max(layers) > 64)
    assert plan.block_points * plan.groups <= 256 and plan.n_blocks * plan.block_points >= P
    assert plan.smem_bytes == fwd_smem_bytes(layers, n_dirs, second, staged, points, plan.k_tile) <= SMEM_PER_BLOCK
    # rows of W per tile: 8 where more than one block an SM can run (three blocks of 69,648 B share an SM), else 32
    assert plan.k_tile == (0 if not staged else 8 if name == "wide_scaled" else 32)
    if not staged:
        tiles = -(-max(layers[1:]) // 4)
        assert tiles % plan.groups == 0 or tiles < plan.groups  # no group idles in a round
        assert plan.n_blocks >= FWD_MIN_BLOCKS or plan.block_points == 8
        # the staged form can be forced (the card holds it bit for bit against the resident one)
        forced = fwd_plan(layers, n_dirs, second, P, staged=True)
        assert (forced.staged, forced.block_points, forced.groups) == (True, 16, 16)
        assert forced.smem_bytes <= SMEM_PER_BLOCK
    assert fwd_plan(tuple(layers), n_dirs, second, P) == plan  # nothing but the shapes goes in


def test_fwd_plan_forms_and_shared_memory():
    """Shared memory by hand at one shape of each form; a network too deep
    for the resident form goes to the staged one; the widest staged shape
    the kernel takes fits the card."""
    # resident: W rows padded to 4 floats, then b; two stream buffers
    net = (2 + 1) * 20 + 2 * (20 + 1) * 20 + (20 + 1) * 4
    assert fwd_plan((2, 20, 20, 20, 1), 2, False, 16384).smem_bytes == 4 * (net + 2 * 3 * 20 * 32)
    # staged: one stream buffer of 16 points, two tiles of 8 rows, the biases and the output weights
    assert fwd_plan((2, 256, 256, 256, 1), 2, False, 16384).smem_bytes == 69_648 == 4 * (
        3 * 256 * 16 + 2 * 8 * 256 + (3 * 256 + 4) + 256)
    # with seven streams one block fills an SM whatever the tile: the largest tile
    assert fwd_plan((3, 256, 256, 1), 3, True, 16384).k_tile == 32
    assert fwd_plan((2, 256, 256, 256, 1), 2, False, 16384, k_tile=16).k_tile == 16  # forced
    deep = (2,) + (64,) * (MAX_LAYERS - 1) + (1,)
    assert fwd_smem_bytes(deep, 2, True, False, 8) > SMEM_PER_BLOCK
    assert fwd_plan(deep, 2, True, 4096).staged
    widest = (3,) + (256,) * (MAX_LAYERS - 1) + (1,)
    assert fwd_plan(widest, 3, True, 4096).smem_bytes <= SMEM_PER_BLOCK
    with pytest.raises(ValueError, match="16 points"):
        fwd_plan((2, 256, 1), 2, True, 100, block_points=32)


def test_layer_pointer_table():
    """B1 reads the layers where they lie: the table holds W_0.. and b_0.. in
    layer order and null beyond; a layer that is not contiguous float32 of
    the right shape on X's device raises."""
    spec = MLP(layers=(2, 5, 3, 1))
    tp = init_mlp(spec, torch.Generator().manual_seed(0))
    cpu = torch.device("cpu")
    table = layer_pointers(spec, tp, cpu)
    assert len(table.W) == len(table.b) == MAX_LAYERS
    for l, layer in enumerate(tp):
        assert (table.W[l], table.b[l]) == (layer["W"].data_ptr(), layer["b"].data_ptr())
    assert all(table.W[l] is None and table.b[l] is None for l in range(len(tp), MAX_LAYERS))

    def swapped(l, key, value):
        return [dict(layer, **({key: value} if i == l else {})) for i, layer in enumerate(tp)]

    bad = [
        swapped(1, "W", tp[1]["W"].detach().t().contiguous().t()),  # right shape, not contiguous
        swapped(0, "W", tp[0]["W"].detach().double()),
        swapped(2, "b", torch.zeros(2)),
        swapped(0, "b", torch.zeros(5, device="meta")),
        tp[:2],
    ]
    for params in bad:
        with pytest.raises(ValueError, match="layer"):
            layer_pointers(spec, params, cpu)


def test_fields_flat_matches_jax_pallas_above_width_128():
    """One width above the TPU kernel's 128 lanes: (2, 256, 1) tanh with
    second derivatives, forward only, against the JAX Pallas kernel in
    interpret mode."""
    layers = (2, 256, 1)
    jspec, jp, spec, tp = make(layers, "tanh", seed=8)
    X = inputs(64, 2, seed=9)
    got = fields_flat(spec, tp, torch.as_tensor(X), 2, True)
    want = np.asarray(jfields_flat(jspec, jp, jnp.asarray(X), 2, True))
    assert got.shape == want.shape == (64, 5)
    np.testing.assert_allclose(got.detach().numpy(), want, **FIELD_TOL)
