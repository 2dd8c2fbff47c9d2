"""B2's layered form (csrc/fused_fields_bwd_layered.cu), on the CPU.

The CUDA kernels run only on a GPU (chip_smoke.py phase 15 (e)-(g) holds them
against the plain version there).  Here: bwd_plan's layered plan (slices,
partial rows, scratch bytes, worked out by hand at chip_smoke.py phase 15's
shapes), and a torch model of the form's decomposition, launch by launch
(seed, replay GEMMs with the outputs() rule on their A operand, the head,
gW split over the plan's point slices, gh with gz_point in its epilogue,
the input layer, gX), writing partial rows in the kernel's layout.  The
model must give fields_flat_bwd_reference's gradient in float64 to 1e-12,
and in float32 the gradient of the JAX package's plain _xla_fields_flat at
tests/test_pallas_fields.py's wide tolerance (rtol 5e-4, atol 1e-4)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hpvpinns_tpu.models.mlp import MLP as JMLP  # noqa: E402
from hpvpinns_tpu.ops.pallas_fields import _xla_fields_flat  # noqa: E402
from hpvpinns_tpu_torch.models.mlp import MLP  # noqa: E402
from hpvpinns_tpu_torch.ops.fused_fields import (  # noqa: E402
    BWD_TILE_POINTS,
    LAYERED_ROWS,
    bwd_layered_scratch_bytes,
    bwd_plan,
    fields_flat_bwd_reference,
    fused_fields_bwd,
    fused_fields_bwd_layered_kernel,
    pack_params,
)


def net_of(layers, seed, dtype):
    """Xavier-scaled normal weights and 0.1-scaled normal biases, from numpy."""
    rng = np.random.default_rng(seed)
    return [{"W": torch.as_tensor(rng.standard_normal((a, b)) * np.sqrt(2.0 / (a + b)), dtype=dtype),
             "b": torch.as_tensor(0.1 * rng.standard_normal(b), dtype=dtype)}
            for a, b in zip(layers[:-1], layers[1:])]


def points_of(P, d, n_dirs, seed, dtype):
    rng = np.random.default_rng(seed)
    X = torch.as_tensor(rng.uniform(-1.0, 1.0, (P, d)), dtype=dtype)
    return X, torch.as_tensor(rng.standard_normal((P, 1 + 2 * n_dirs)), dtype=dtype)


# ---- the torch model of the decomposition (the kernel's rules and layout) ----

def stash_value(z, act):
    return torch.tanh(z) if act == "tanh" else z


def derivs(v, act):
    """act(z), d1, d2, d3 from the stashed value v (t for tanh, z for sin)."""
    if act == "tanh":
        d1 = 1.0 - v * v
        return v, d1, -2.0 * v * d1, -2.0 * d1 * (1.0 - 3.0 * v * v)
    return torch.sin(v), torch.cos(v), -torch.sin(v), -torch.cos(v)


def outputs(st, act, nd):
    """h, h_k, h_kk [S, P, w] from a stash [S, P, w] (the rules' outputs())."""
    a, d1, d2, _ = derivs(st[0], act)
    zk, zkk = st[1:1 + nd], st[1 + nd:]
    return torch.cat([a[None], d1 * zk, d2 * zk * zk + d1 * zkk])


def gz_point(st, gh, act, nd):
    """gz [S, P, w] from the stash and gh (the rules' gz_point())."""
    _, d1, d2, d3 = derivs(st[0], act)
    zk, zkk, ghk, ghkk = st[1:1 + nd], st[1 + nd:], gh[1:1 + nd], gh[1 + nd:]
    g0 = d1 * gh[0] + (d2 * zk * ghk + (d3 * zk * zk + d2 * zkk) * ghkk).sum(0)
    return torch.cat([g0[None], d1 * ghk + 2.0 * d2 * zk * ghkk, d1 * ghkk])


def layered_model(spec, params, X, g, nd, tiles=None):
    """The layered form's launches in torch: (partials [slices, row_pitch] in
    the kernel's layout, gX)."""
    layers, act = spec.layers, spec.activation
    L, P = len(layers) - 1, X.shape[0]
    plan = bwd_plan(layers, nd, P, tiles, form="layered")
    sp = BWD_TILE_POINTS * plan.tiles_per_block
    slices = [slice(r * sp, min(P, (r + 1) * sp)) for r in range(plan.n_blocks)]
    W = [p["W"] for p in params]
    b = [p["b"] for p in params]
    offs = np.cumsum([0] + [a * c + c for a, c in zip(layers[:-1], layers[1:])]).tolist()
    partials = torch.zeros((plan.n_blocks, plan.row_pitch), dtype=X.dtype)
    # seed: z = x W0 + b0, z_k = W0[k], z_kk = 0
    w1 = layers[1]
    st = [torch.cat([stash_value(X @ W[0] + b[0], act)[None],
                     W[0][:nd, None, :].expand(nd, P, w1), torch.zeros(nd, P, w1, dtype=X.dtype)])]
    for l in range(1, L - 1):  # replay: Z_s = outputs(stash)_s W_l, + b and stash_value on u
        Z = outputs(st[l - 1], act, nd) @ W[l]
        st.append(torch.cat([stash_value(Z[0] + b[l], act)[None], Z[1:]]))
    # head: the linear last layer
    G = g.T.contiguous()  # [S, P]
    h = outputs(st[L - 2], act, nd)
    for r, sl in enumerate(slices):
        partials[r, offs[L - 1]:offs[L - 1] + layers[L - 1]] = (h[:, sl] * G[:, sl, None]).sum((0, 1))
        partials[r, offs[L - 1] + layers[L - 1]] = G[0, sl].sum()
    gz = gz_point(st[L - 2], G[:, :, None] * W[L - 1][:, 0], act, nd)
    for l in range(L - 2, 0, -1):  # gw split over the slices, then gh and gz_point
        din, dout = layers[l], layers[l + 1]
        h = outputs(st[l - 1], act, nd)
        for r, sl in enumerate(slices):
            partials[r, offs[l]:offs[l] + din * dout] = torch.einsum("spi,spj->ij", h[:, sl], gz[:, sl]).reshape(-1)
            partials[r, offs[l] + din * dout:offs[l + 1]] = gz[0, sl].sum(0)
        gz = gz_point(st[l - 1], gz @ W[l].T, act, nd)
    d = layers[0]  # input: x, the seeds e_k and zero
    for r, sl in enumerate(slices):
        gW0 = X[sl].T @ gz[0, sl]
        gW0[:nd] += gz[1:1 + nd, sl].sum(1)
        partials[r, :d * w1] = gW0.reshape(-1)
        partials[r, d * w1:offs[1]] = gz[0, sl].sum(0)
    return partials, gz[0] @ W[0].T


def flat(grads):
    return torch.cat([t.reshape(-1) for layer in grads for t in (layer["W"], layer["b"])])


MODEL_CASES = [  # layers, activation, n_dirs, P, slice tiles (None: the plan's)
    ((2, 12, 1), "tanh", 2, 37, None),
    ((1, 20, 13, 1), "sin", 1, 70, None),
    ((2, 70, 130, 1), "tanh", 2, 150, 2),
    ((3, 33, 20, 17, 1), "sin", 3, 70, 3),
    ((2, 24, 24, 24, 1), "tanh", 2, 129, 1),
    ((2, 20, 20, 20, 1), "tanh", 2, 4100, None),  # 17 slices of 256 points
]


@pytest.mark.parametrize("layers,act,nd,P,tiles", MODEL_CASES, ids=[str(c[0]) + c[1] for c in MODEL_CASES])
def test_layered_model_equals_the_plain_backward_in_float64(layers, act, nd, P, tiles):
    spec = MLP(layers=layers, activation=act)
    net = net_of(layers, 0, torch.float64)
    X, g = points_of(P, layers[0], nd, 1, torch.float64)
    partials, gX = layered_model(spec, net, X, g, nd, tiles)
    n = flat(net).numel()
    assert (partials[:, n:] == 0).all()
    want, want_x = fields_flat_bwd_reference(spec, net, X, g, nd)
    want = flat(want)
    np.testing.assert_allclose(partials.sum(0)[:n].numpy(), want.numpy(), rtol=1e-12, atol=1e-12 * want.abs().max().item())
    np.testing.assert_allclose(gX.numpy(), want_x.numpy(), rtol=1e-12, atol=1e-12 * want_x.abs().max().item())


@functools.lru_cache(maxsize=None)
def jax_wide_grad(layers, nd):
    """(inputs, JAX gradient) at one of tests/test_pallas_fields.py's wide
    shapes: jax.grad of the plain _xla_fields_flat in float32, compiled once
    per shape for every check that uses it."""
    spec = MLP(layers=layers, activation="tanh")
    net = net_of(layers, 7, torch.float32)
    X, g = points_of(64, layers[0], nd, 8, torch.float32)
    jspec, jp = JMLP(layers=layers, activation="tanh"), [{k: jnp.asarray(v.numpy()) for k, v in p.items()} for p in net]
    gn = g.numpy()
    jg, jgx = jax.jit(jax.grad(lambda p, x: (_xla_fields_flat(jspec, p, x, nd, True) * gn).sum(), argnums=(0, 1)))(
        jp, jnp.asarray(X.numpy()))
    want = np.concatenate([np.asarray(t).reshape(-1) for layer in jg for t in (layer["W"], layer["b"])])
    return spec, net, X, g, want, np.asarray(jgx)


@pytest.mark.parametrize("source", ["layered model", "plain version"])
@pytest.mark.parametrize("layers,nd", [((2, 256, 1), 2), ((1, 200, 40, 1), 1)])
def test_layered_model_in_float32_matches_jax_at_the_wide_shapes(layers, nd, source):
    spec, net, X, g, want, want_x = jax_wide_grad(layers, nd)
    if source == "layered model":
        partials, gX = layered_model(spec, net, X, g, nd)
        got = partials.sum(0)[:want.size]
    else:
        grads, gX = fields_flat_bwd_reference(spec, net, X, g, nd)
        got = flat(grads)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=1e-4)
    np.testing.assert_allclose(gX.numpy(), want_x, rtol=5e-4, atol=1e-4)


# (name, layers, n_dirs, P) of chip_smoke.py phase 15 and the layered plan
# there, by hand: slice tiles (16 points each, doubled until at most 128
# slices), slices = partial rows, row pitch (n_params rounded up to 4), and
# scratch bytes = 4 (n_layers - 1) S P round4(widest hidden layer).
PHASE15 = [
    ("p2d_scaled 3 x 256", (2, 256, 256, 256, 1), 2, 16384, (8, 128, 132_612, 4 * 3 * 5 * 16384 * 256)),
    ("p2d_scaled 3 x 128", (2, 128, 128, 128, 1), 2, 16384, (8, 128, 33_540, 4 * 3 * 5 * 16384 * 128)),
    ("jax_one_layer", (2, 256, 1), 2, 1000, (1, 63, 1_028, 4 * 1 * 5 * 1000 * 256)),
    ("jax_mixed", (1, 200, 40, 1), 1, 1000, (1, 63, 8_484, 4 * 2 * 3 * 1000 * 200)),
    ("p3d_quality 3 x 56", (3, 56, 56, 56, 1), 3, 8000, (4, 125, 6_668, 4 * 3 * 7 * 8000 * 56)),
    ("p3d_quality 3 x 64", (3, 64, 64, 64, 1), 3, 8000, (4, 125, 8_644, 4 * 3 * 7 * 8000 * 64)),
    ("forced p2d_scaled", (2, 20, 20, 20, 1), 2, 16384, (8, 128, 924, 4 * 3 * 5 * 16384 * 20)),
    ("forced p3d_quality", (3, 48, 48, 48, 1), 3, 8000, (4, 125, 4_948, 4 * 3 * 7 * 8000 * 48)),
]


@pytest.mark.parametrize("name,layers,nd,P,want", PHASE15, ids=[c[0] for c in PHASE15])
def test_layered_plan_by_hand_at_phase15_shapes(name, layers, nd, P, want):
    plan = bwd_plan(layers, nd, P, form="layered")
    assert (plan.tiles_per_block, plan.n_blocks, plan.row_pitch, plan.scratch_bytes) == want
    assert plan.scratch_bytes == bwd_layered_scratch_bytes(layers, nd, P)
    span = plan.tiles_per_block * BWD_TILE_POINTS  # the slices cover the points, none empty
    assert (plan.n_blocks - 1) * span < P <= plan.n_blocks * span and plan.n_blocks <= LAYERED_ROWS
    assert plan.scratch_bytes <= 251_658_240  # the wide form's at 3 x 256, never more


@pytest.mark.parametrize("P,wide_blocks,ratio", [(8000, 500, 0.5), (16384, 512, 1.0), (32768, 512, 2.0),
                                                 (65536, 512, 4.0), (131072, 1024, 4.0)])
def test_layered_scratch_grows_with_P_against_the_wide_forms(P, wide_blocks, ratio):
    """At (2,256,256,256,1), n_dirs 2, by hand: the layered scratch is every
    point's stash, 4 x 3 layers x 5 streams x P x 256; the wide form's is 4 x
    blocks x (n_layers + 2 = 6) buffers x 5 streams x 256 x 16 points, its blocks
    ceil(P / 16 / T) with T = min(8, max(1, P // 16 // 512)) tiles."""
    layers = (2, 256, 256, 256, 1)
    lay, wide = bwd_plan(layers, 2, P, form="layered"), bwd_plan(layers, 2, P, form="wide")
    assert lay.scratch_bytes == 4 * 3 * 5 * P * 256
    assert wide.n_blocks == wide_blocks and wide.scratch_bytes == 4 * wide_blocks * 6 * 5 * 256 * 16
    assert lay.scratch_bytes == ratio * wide.scratch_bytes
    if P == 131072:
        assert (lay.scratch_bytes, wide.scratch_bytes) == (2_013_265_920, 503_316_480)


RULE = [  # layers, n_dirs, the form bwd_plan picks at every P
    ((2, 20, 20, 20, 1), 2, "resident"),  # poisson2d_scaled
    ((3, 48, 48, 48, 1), 3, "resident"),  # poisson3d_quality: 200,864 B of shared memory
    ((3, 54, 54, 54, 1), 3, "resident"),
    ((3, 55, 55, 55, 1), 3, "layered"),  # above the card's 232,448 B a block
    ((2, 64, 64, 64, 64, 1), 2, "layered"),
    ((2, 65, 1), 2, "layered"),  # wider than 64
    ((2, 256, 256, 256, 1), 2, "layered"),
    ((1, 200, 40, 1), 1, "layered"),
    ((4, 20, 1), 2, "resident"),
    ((4, 128, 128, 1), 2, "wide"),  # four inputs: the layered form takes at most three
    ((16, 256, 1), 3, "wide"),
]


@pytest.mark.parametrize("layers,nd,form", RULE, ids=[str(c[0]) for c in RULE])
def test_bwd_plan_three_way_rule_from_shapes_alone(layers, nd, form):
    """Resident where it fits, else layered where it takes the network (a
    hidden layer, at most three inputs), else wide; the same at every P."""
    for P in (1, 64, 1000, 8000, 16384, 10**6):
        plan = bwd_plan(layers, nd, P)
        assert plan.form == form
        assert (plan.scratch_bytes > 0) == (form != "resident")
        if form == "layered":
            assert plan == bwd_plan(layers, nd, P, form="layered")


def test_layered_slices_depend_on_P_alone():
    for P in (1, 16, 17, 2048, 2049, 8000, 16384, 65536, 10**6):
        tiles = {bwd_plan(layers, nd, P, form="layered").tiles_per_block for _, layers, nd, _, _ in PHASE15}
        assert len(tiles) == 1
        T = tiles.pop()
        rows = -(-P // (BWD_TILE_POINTS * T))
        assert rows <= LAYERED_ROWS and (T == 1 or -(-P // (BWD_TILE_POINTS * T // 2)) > LAYERED_ROWS)


def test_layered_refuses_what_it_does_not_take():
    """No hidden layer, or more than three inputs: forcing the form raises;
    an unknown form raises."""
    with pytest.raises(ValueError, match="layered form"):
        bwd_plan((2, 1), 2, 100, form="layered")
    with pytest.raises(ValueError, match="layered form"):
        bwd_plan((4, 16, 1), 2, 100, form="layered")
    with pytest.raises(ValueError, match="form"):
        bwd_plan((2, 16, 1), 2, 100, form="tiled")


def test_forcing_layered_on_a_cpu_tensor_takes_the_plain_version():
    """fused_fields_bwd at a network bwd_plan gives the layered form, on a
    CPU tensor, is the plain version, bit for bit; the layered wrapper
    itself, forced, raises on a CPU tensor before any launch."""
    layers = (2, 96, 80, 1)
    assert bwd_plan(layers, 2, 40).form == "layered"
    spec = MLP(layers=layers, activation="tanh")
    net = net_of(layers, 3, torch.float32)
    X, g = points_of(40, 2, 2, 4, torch.float32)
    got, got_x = fused_fields_bwd(spec, net, X, g, 2)
    want, want_x = fields_flat_bwd_reference(spec, net, X, g, 2)
    assert torch.equal(flat(got), flat(want)) and torch.equal(got_x, want_x)
    with pytest.raises(ValueError, match="CUDA"):
        fused_fields_bwd_layered_kernel(spec, net, X, g, 2)
    assert fused_fields_bwd_layered_kernel.launches == 0
    packed, _ = pack_params(spec, net)
    assert bwd_plan(layers, 2, 40, form="layered").row_pitch == -(-packed.numel() // 4) * 4
