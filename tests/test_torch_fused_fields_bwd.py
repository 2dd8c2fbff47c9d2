"""Port parity, the second-derivative backward (B2, ops/fused_fields.py).

On the CPU the gradient of fields_flat(..., second=True) is B2's plain
version, fields_flat_bwd_reference (autograd through the plain forward).  It
is held against the JAX package's backward kernel _pallas_fields_bwd, run in
interpret mode as tests/test_pallas_fields.py runs it, and against jax.grad
of the JAX fields_flat (whose custom VJP is that kernel), in float32 at that
file's tolerance: rtol 2e-4 / atol 1e-5 (the kernels sum over points in
another order than autograd).  The CUDA kernel itself runs only on a GPU
(chip_smoke.py holds it against the same plain version there)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hpvpinns_tpu.models.mlp import MLP as JMLP  # noqa: E402
from hpvpinns_tpu.ops.pallas_fields import _pallas_fields_bwd, _xla_fields_flat  # noqa: E402
from hpvpinns_tpu.ops.pallas_fields import fields_flat as jfields_flat  # noqa: E402
from hpvpinns_tpu.ops.pallas_fields import pallas_fields_1d  # noqa: E402
from hpvpinns_tpu_torch.convert import params_from_jax  # noqa: E402
from hpvpinns_tpu_torch.models.mlp import MLP, init_mlp  # noqa: E402
from hpvpinns_tpu_torch.ops.fused_fields import (  # noqa: E402
    BWD_RESIDENT_WIDTH,
    BWD_TILE_POINTS,
    SUM_MAX_TILES,
    SUM_ONE_PASS_ROWS,
    SUM_THREADS,
    block_sum_kernel,
    block_sum_plan,
    bwd_layered_scratch_bytes,
    bwd_plan,
    bwd_smem_bytes,
    fields_flat,
    fields_flat_bwd_reference,
    fused_fields_1d,
    fused_fields_bwd_kernel,
    pack_params,
    unpack_params,
)

GRAD_TOL = dict(rtol=2e-4, atol=1e-5)
# One point count (and the JAX kernels' default blocks) for every test, and
# jitted JAX gradients: compiling the interpret-mode kernels takes most of
# this file's time, and the tests of one network then share compilations.
P = 70
SHAPES = [  # (layers, activation, n_dirs)
    ((1, 12, 12, 1), "sin", 1),
    ((2, 16, 16, 1), "tanh", 2),
    ((3, 16, 16, 1), "sin", 3),
    ((2, 8, 24, 5, 1), "tanh", 2),  # mixed widths
]


def make(layers, act, seed=0):
    """One network for both packages: Xavier-scaled normal weights and small
    biases from numpy."""
    rng = np.random.default_rng(seed)
    tree = {"net": [
        {"W": (rng.standard_normal((a, b)) * np.sqrt(2.0 / (a + b))).astype(np.float32),
         "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
        for a, b in zip(layers[:-1], layers[1:])
    ], "pde": {}}
    jp = jax.tree.map(jnp.asarray, tree["net"])
    tp = params_from_jax(tree, dtype=torch.float32)["net"]
    return JMLP(layers=layers, activation=act), jp, MLP(layers=layers, activation=act), tp


def inputs(P, d, n_fields, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1.0, 1.0, (P, d)).astype(np.float32)
    return X, rng.standard_normal((P, n_fields)).astype(np.float32)


def assert_grads(tgrads, tgx, jgrads, jgx):
    for t, j in zip(tgrads, jgrads):
        for k in ("W", "b"):
            np.testing.assert_allclose(t[k].detach().numpy(), np.asarray(j[k]), **GRAD_TOL, err_msg=k)
    np.testing.assert_allclose(tgx.detach().numpy(), np.asarray(jgx), **GRAD_TOL, err_msg="X")


@pytest.mark.parametrize("layers,act,n_dirs", SHAPES)
def test_plain_backward_matches_jax_backward_kernel(layers, act, n_dirs):
    jspec, jp, spec, tp = make(layers, act)
    X, g = inputs(P, layers[0], 1 + 2 * n_dirs)
    tgrads, tgx = fields_flat_bwd_reference(spec, tp, torch.as_tensor(X), torch.as_tensor(g), n_dirs)
    jgrads, jgx = _pallas_fields_bwd(jspec, jp, jnp.asarray(X), jnp.asarray(g), n_dirs)
    assert_grads(tgrads, tgx, jgrads, jgx)


@pytest.mark.parametrize("layers,act,n_dirs", SHAPES)
def test_fields_flat_gradient_matches_jax_grad(layers, act, n_dirs):
    """Autograd through the port's fields_flat (second=True, so B2's path)
    against jax.grad of the JAX fields_flat."""
    jspec, jp, spec, tp = make(layers, act, seed=2)
    X, g = inputs(P, layers[0], 1 + 2 * n_dirs, seed=3)
    Xt = torch.as_tensor(X).requires_grad_(True)
    leaves = [t for layer in tp for t in (layer["W"], layer["b"])]
    grads = torch.autograd.grad((fields_flat(spec, tp, Xt, n_dirs, True) * torch.as_tensor(g)).sum(), leaves + [Xt])
    jgrads, jgx = jax.jit(jax.grad(
        lambda p, x: (jfields_flat(jspec, p, x, n_dirs, True) * g).sum(), argnums=(0, 1)
    ))(jp, jnp.asarray(X))
    assert_grads(unpack_params(spec, torch.cat([t.reshape(-1) for t in grads[:-1]])), grads[-1], jgrads, jgx)


def test_fused_fields_1d_matches_jax():
    jspec, jp, spec, tp = make((1, 12, 12, 1), "sin", seed=4)
    x = np.random.default_rng(5).uniform(-1.0, 1.0, (2, P // 2)).astype(np.float32)
    xt = torch.as_tensor(x)
    tf = fused_fields_1d(spec, tp, xt)
    jf = pallas_fields_1d(jspec, jp, jnp.asarray(x))
    for t, j in zip(tf, jf):
        assert t.shape == (2, P // 2)
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=2e-5, atol=1e-6)
    w = np.random.default_rng(6).standard_normal((3, 2, P // 2)).astype(np.float32)
    leaves = [t for layer in tp for t in (layer["W"], layer["b"])]
    tg = torch.autograd.grad(sum((f * torch.as_tensor(c)).sum() for f, c in zip(tf, w)), leaves)
    jg = jax.jit(jax.grad(lambda p: sum((f * c).sum() for f, c in zip(pallas_fields_1d(jspec, p, jnp.asarray(x)), w))))(jp)
    assert_grads(unpack_params(spec, torch.cat([t.reshape(-1) for t in tg])), torch.zeros(1), jg, np.zeros(1))


def test_unpack_params_inverts_pack_params():
    spec = MLP(layers=(3, 7, 5, 1))
    tp = init_mlp(spec, torch.Generator().manual_seed(0))
    packed, _ = pack_params(spec, tp)
    for a, b in zip(unpack_params(spec, packed), tp):
        for k in ("W", "b"):
            assert a[k].shape == b[k].shape
            torch.testing.assert_close(a[k], b[k].detach(), rtol=0, atol=0)


def test_backward_kernels_reject_what_they_do_not_take():
    """Both wrappers raise before any launch on a CPU tensor (the plain
    version is taken only by fields_flat's backward, never by the kernels)."""
    spec = MLP(layers=(2, 8, 1))
    tp = init_mlp(spec, torch.Generator().manual_seed(0))
    X, g = (torch.as_tensor(a) for a in inputs(4, 2, 5))
    with pytest.raises(ValueError, match="CUDA"):
        fused_fields_bwd_kernel(spec, tp, X, g, 2)
    with pytest.raises(ValueError, match="CUDA"):
        block_sum_kernel(torch.zeros(3, 4))
    assert fused_fields_bwd_kernel.launches == 0 and block_sum_kernel.launches == 0


# The shapes chip_smoke.py phase 7 runs B2 and its block sum at: (name,
# layers, n_dirs, P) and the launch shape bwd_plan must give there
# (tiles_per_block, n_blocks, row_pitch, shared memory bytes), worked out by
# hand from the kernel's layout: two padded copies of the network (weights,
# sums) and (n_layers + 2) buffers of (1 + 2 n_dirs) x max width x 20 floats.
H100_SMEM_PER_BLOCK = 232448  # 227 KB, the most one block may opt in to
PHASE7 = [
    ("p1d_record", (1, 20, 20, 20, 20, 1), 1, 80, (1, 5, 1324, 4 * (2 * 1324 + 7 * 3 * 20 * 20))),
    ("p1d_quality", (1, 30, 30, 30, 1), 1, 240, (1, 15, 1952, 4 * (2 * 1952 + 6 * 3 * 30 * 20))),
    ("p2d_scaled", (2, 20, 20, 20, 1), 2, 16384, (2, 512, 924, 4 * (2 * 924 + 6 * 5 * 20 * 20))),
    ("p2d_quality", (2, 48, 48, 48, 48, 1), 2, 4096, (1, 256, 7252, 4 * (2 * 7252 + 7 * 5 * 48 * 20))),
    ("ragged", (3, 48, 48, 48, 1), 3, 1003, (1, 63, 4948, 4 * (2 * 4948 + 6 * 7 * 48 * 20))),
]


def n_params(layers):
    return sum(a * b + b for a, b in zip(layers[:-1], layers[1:]))


@pytest.mark.parametrize("name,layers,n_dirs,P,want", PHASE7, ids=[c[0] for c in PHASE7])
def test_bwd_plan_at_phase7_shapes(name, layers, n_dirs, P, want):
    plan = bwd_plan(layers, n_dirs, P)
    assert (plan.tiles_per_block, plan.n_blocks, plan.row_pitch, plan.smem_bytes) == want
    assert plan.row_pitch % 4 == 0 and 0 <= plan.row_pitch - n_params(layers) < 4
    assert plan.smem_bytes <= H100_SMEM_PER_BLOCK  # p2d_quality included: 192,416 B
    # the blocks cover the points, and no block is empty
    span = plan.tiles_per_block * BWD_TILE_POINTS
    assert (plan.n_blocks - 1) * span < P <= plan.n_blocks * span


def test_bwd_plan_depends_on_P_alone():
    """T grows with P only (never with the widths or the card), and an
    explicit T is kept."""
    for P in (1, 15, 16, 17, 8191, 8192, 16384, 65536, 10**6):
        Ts = {bwd_plan(layers, n_dirs, P).tiles_per_block for _, layers, n_dirs, _, _ in PHASE7}
        assert len(Ts) == 1
        T = Ts.pop()
        n_tiles = -(-P // BWD_TILE_POINTS)
        assert 1 <= T <= 8 and (T == 1 or n_tiles // T >= 512)
    assert bwd_plan((2, 20, 1), 2, 16384, tiles_per_block=1).n_blocks == 1024


@pytest.mark.parametrize("rows", ["new", "old"])
@pytest.mark.parametrize("name,layers,n_dirs,P,want", PHASE7, ids=[c[0] for c in PHASE7])
def test_block_sum_plan_at_phase7_shapes(name, layers, n_dirs, P, want, rows):
    """The block sum's plan on B2's partials ("new": padded rows) and on the
    shape B2 wrote before (one row per 16 points, n_params wide): the slabs
    cover every row once and no slab is empty; one pass up to
    SUM_ONE_PASS_ROWS rows; a thread adds at most 8 rows a pass; and more
    than one slab only where each column tile has a ticket."""
    if rows == "new":
        n_rows, n = want[1], want[2]
    else:
        n_rows, n = -(-P // BWD_TILE_POINTS), n_params(layers)
    lanes, rows_per_slab, slabs = block_sum_plan(n_rows, n)
    assert SUM_THREADS % lanes == 0 and lanes & (lanes - 1) == 0
    groups = SUM_THREADS // lanes
    assert (slabs - 1) * rows_per_slab < n_rows <= slabs * rows_per_slab
    assert -(-rows_per_slab // groups) <= 8
    assert (slabs == 1) == (n_rows <= SUM_ONE_PASS_ROWS)
    assert slabs == 1 or -(-n // (4 * lanes)) <= SUM_MAX_TILES


def test_bwd_plan_takes_the_layered_form_exactly_above_the_resident_limits():
    """The resident form wherever no layer is wider than 64 and its shared
    memory fits the H100's per-block opt-in; above those limits (at n_dirs
    3 with three hidden layers from width 55) the layered form, which is
    also what forcing it gives at any width, its slices from P alone and
    its scratch one chunk's stash (at P 8,000 one chunk covers every
    network here).  Forcing the resident form above its limits raises."""
    for n_dirs in (1, 2, 3):
        for n_hidden in (1, 2, 3, 4):
            for w in (8, 40, 48, 52, 54, 55, 56, 60, 64, 65, 128, 256):
                layers = (n_dirs, *([w] * n_hidden), 1)
                fits = w <= BWD_RESIDENT_WIDTH and bwd_smem_bytes(layers, n_dirs) <= H100_SMEM_PER_BLOCK
                plan = bwd_plan(layers, n_dirs, 8000)
                assert plan.form == ("resident" if fits else "layered"), layers
                assert plan.scratch_bytes == (0 if fits else bwd_layered_scratch_bytes(layers, n_dirs, 8000))
                forced = bwd_plan(layers, n_dirs, 8000, form="layered")
                assert (forced.form, forced.chunk_points, forced.tiles_per_block, forced.n_blocks) == (
                    "layered", 8000, 4, 125)
                assert forced.scratch_bytes == bwd_layered_scratch_bytes(layers, n_dirs, 8000)
                assert forced.row_pitch == plan.row_pitch
                if not fits:
                    assert plan == forced
                    with pytest.raises(ValueError, match="resident form"):
                        bwd_plan(layers, n_dirs, 8000, form="resident")
    assert bwd_plan((3, 54, 54, 54, 1), 3, 8000).form == "resident"
    assert bwd_plan((3, 55, 55, 55, 1), 3, 8000).form == "layered"
    assert bwd_plan((2, 64, 64, 64, 1), 2, 16384).form == "resident"  # 222,240 B
    assert bwd_plan((2, 64, 64, 64, 64, 1), 2, 16384).form == "layered"  # 281,120 B
    with pytest.raises(ValueError, match="form"):
        bwd_plan((2, 8, 1), 2, 100, form="staged")
    with pytest.raises(ValueError, match="form"):
        bwd_plan((2, 256, 256, 1), 2, 100, form="wide")


@pytest.mark.parametrize("layers,n_dirs", [((2, 256, 1), 2), ((1, 200, 40, 1), 1)])
def test_plain_backward_at_the_wide_shapes_matches_jax(layers, n_dirs):
    """B2's plain version at tests/test_pallas_fields.py's wide shapes (the
    layered form's on the card), float32, against the gradient of JAX's
    plain _xla_fields_flat at that file's tolerance (rtol 5e-4, atol 1e-4)."""
    jspec, jp, spec, tp = make(layers, "tanh", seed=7)
    X, g = inputs(64, layers[0], 1 + 2 * n_dirs, seed=8)
    assert bwd_plan(layers, n_dirs, 64).form == "layered"
    tgrads, tgx = fields_flat_bwd_reference(spec, tp, torch.as_tensor(X), torch.as_tensor(g), n_dirs)
    jgrads, jgx = jax.jit(jax.grad(
        lambda p, x: (_xla_fields_flat(jspec, p, x, n_dirs, True) * g).sum(), argnums=(0, 1)
    ))(jp, jnp.asarray(X))
    for t, j in zip(tgrads, jgrads):
        for k in ("W", "b"):
            np.testing.assert_allclose(t[k].detach().numpy(), np.asarray(j[k]), rtol=5e-4, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(tgx.detach().numpy(), np.asarray(jgx), rtol=5e-4, atol=1e-4, err_msg="X")
