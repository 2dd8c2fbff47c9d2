"""B2's layered form (csrc/fused_fields_bwd_layered.cu), on the CPU.

The CUDA kernels run only on a GPU (chip_smoke.py phase 15 (e)-(j) holds them
against the plain version there).  Here: bwd_plan's layered plan (chunks of
points under LAYERED_SCRATCH_CAP, slices, partial rows, scratch bytes, worked
out by hand at chip_smoke.py phase 15's shapes), its rule (resident or
layered for every network B1 takes), and a torch model of the form's
decomposition, launch by launch (seed, replay GEMMs with the outputs() rule
on their A operand, the head, gW split over the plan's point slices, gh with
gz_point in its epilogue, the input layer, gX; without a hidden layer the
input layer on g itself), chunk by chunk, writing partial rows in the
kernel's layout: slice r of chunk c adds into row r.  The model must give
fields_flat_bwd_reference's gradient in float64 to 1e-12, and in float32 the
gradient of the JAX package's plain _xla_fields_flat at
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
    BWD_FORMS,
    BWD_TILE_POINTS,
    FWD_MAX_WIDTH,
    LAYERED_CHUNK_GROUP,
    LAYERED_ROWS,
    LAYERED_SCRATCH_CAP,
    MAX_LAYERS,
    bwd_layered_scratch_bytes,
    bwd_plan,
    bwd_smem_bytes,
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


def unchunked_model(spec, params, X, g, nd, tiles=None):
    """The layered form's launches in torch over all P points in one piece,
    as the form ran before its points were chunked: (partials [slices,
    row_pitch] in the kernel's layout, gX).  Networks with a hidden layer."""
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


def chunk_model(spec, params, X, g, nd, span, row_pitch):
    """One chunk's launches in torch (X, g: the chunk's points; span: points
    a slice): (its partial rows [ceil(chunk / span), row_pitch], its gX).
    Without a hidden layer gz_0 is g itself and only the input layer and gX
    run."""
    layers, act = spec.layers, spec.activation
    L, P = len(layers) - 1, X.shape[0]
    slices = [slice(r, min(P, r + span)) for r in range(0, P, span)]
    W = [p["W"] for p in params]
    b = [p["b"] for p in params]
    offs = np.cumsum([0] + [a * c + c for a, c in zip(layers[:-1], layers[1:])]).tolist()
    rows = torch.zeros((len(slices), row_pitch), dtype=X.dtype)
    G = g.T.contiguous()  # [S, P]
    w1 = layers[1]
    if L == 1:
        gz = G[:, :, None]  # [S, P, 1]: u = x W + b, u_k = W[k], u_kk = 0
    else:
        st = [torch.cat([stash_value(X @ W[0] + b[0], act)[None],
                         W[0][:nd, None, :].expand(nd, P, w1), torch.zeros(nd, P, w1, dtype=X.dtype)])]
        for l in range(1, L - 1):
            Z = outputs(st[l - 1], act, nd) @ W[l]
            st.append(torch.cat([stash_value(Z[0] + b[l], act)[None], Z[1:]]))
        h = outputs(st[L - 2], act, nd)
        for r, sl in enumerate(slices):
            rows[r, offs[L - 1]:offs[L - 1] + layers[L - 1]] = (h[:, sl] * G[:, sl, None]).sum((0, 1))
            rows[r, offs[L - 1] + layers[L - 1]] = G[0, sl].sum()
        gz = gz_point(st[L - 2], G[:, :, None] * W[L - 1][:, 0], act, nd)
        for l in range(L - 2, 0, -1):
            din, dout = layers[l], layers[l + 1]
            h = outputs(st[l - 1], act, nd)
            for r, sl in enumerate(slices):
                rows[r, offs[l]:offs[l] + din * dout] = torch.einsum("spi,spj->ij", h[:, sl], gz[:, sl]).reshape(-1)
                rows[r, offs[l] + din * dout:offs[l + 1]] = gz[0, sl].sum(0)
            gz = gz_point(st[l - 1], gz @ W[l].T, act, nd)
    d = layers[0]
    for r, sl in enumerate(slices):
        gW0 = X[sl].T @ gz[0, sl]
        gW0[:nd] += gz[1:1 + nd, sl].sum(1)
        rows[r, :d * w1] = gW0.reshape(-1)
        rows[r, d * w1:offs[1]] = gz[0, sl].sum(0)
    return rows, gz[0] @ W[0].T


def layered_model(spec, params, X, g, nd, tiles=None, chunk_points=None):
    """The layered form's launches in torch, chunk by chunk (`tiles` and
    `chunk_points` force bwd_plan's): (partials [slices, row_pitch] in the
    kernel's layout, gX).  Slice r of the first chunk stores row r, slice r
    of every later chunk adds into it, in chunk order."""
    P = X.shape[0]
    plan = bwd_plan(spec.layers, nd, P, tiles, form="layered", chunk_points=chunk_points)
    span = BWD_TILE_POINTS * plan.tiles_per_block
    partials, gX = None, []
    for c0 in range(0, P, plan.chunk_points):
        sl = slice(c0, min(P, c0 + plan.chunk_points))
        rows, gx = chunk_model(spec, params, X[sl], g[sl], nd, span, plan.row_pitch)
        if partials is None:
            partials = rows
        else:
            partials[:rows.shape[0]] += rows
        gX.append(gx)
    assert partials.shape == (plan.n_blocks, plan.row_pitch)
    return partials, torch.cat(gX)


def flat(grads):
    return torch.cat([t.reshape(-1) for layer in grads for t in (layer["W"], layer["b"])])


MODEL_CASES = [  # layers, activation, n_dirs, P, slice tiles (None: the plan's)
    ((2, 12, 1), "tanh", 2, 37, None),
    ((1, 20, 13, 1), "sin", 1, 70, None),
    ((2, 70, 130, 1), "tanh", 2, 150, 2),
    ((3, 33, 20, 17, 1), "sin", 3, 70, 3),
    ((2, 24, 24, 24, 1), "tanh", 2, 129, 1),
    ((2, 20, 20, 20, 1), "tanh", 2, 4100, None),  # 17 slices of 256 points
    ((5, 30, 20, 1), "tanh", 3, 90, None),  # more than three inputs
    ((19, 24, 1), "sin", 2, 60, 2),
    ((7, 1), "sin", 3, 50, None),  # no hidden layer
    ((100, 1), "tanh", 2, 40, None),
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


CHUNK_CASES = [  # layers, activation, n_dirs, P, forced chunk points: several chunks, the last one short
    ((2, 24, 24, 1), "tanh", 2, 300, 128),
    ((3, 33, 20, 17, 1), "sin", 3, 200, 70),
    ((5, 30, 20, 1), "tanh", 3, 150, 64),
    ((70, 1), "sin", 2, 200, 48),  # no hidden layer
]


@pytest.mark.parametrize("layers,act,nd,P,chunk", CHUNK_CASES, ids=[str(c[0]) + c[1] for c in CHUNK_CASES])
def test_chunked_model_equals_one_chunk_and_the_plain_backward_in_float64(layers, act, nd, P, chunk):
    """Chunks of `chunk` points (slice r of each adding into row r) and one
    chunk forced (chunk_points=P) give the same gradient, both the plain
    backward's to 1e-12; the chunked partials have one chunk's rows."""
    spec = MLP(layers=layers, activation=act)
    net = net_of(layers, 2, torch.float64)
    X, g = points_of(P, layers[0], nd, 3, torch.float64)
    chunked, cx = layered_model(spec, net, X, g, nd, chunk_points=chunk)
    whole, wx = layered_model(spec, net, X, g, nd, chunk_points=P)
    plan = bwd_plan(layers, nd, P, form="layered", chunk_points=chunk)
    assert plan.chunk_points == chunk and -(-P // chunk) >= 3 and P % chunk
    assert chunked.shape[0] == -(-chunk // (BWD_TILE_POINTS * plan.tiles_per_block)) < whole.shape[0]
    want, want_x = fields_flat_bwd_reference(spec, net, X, g, nd)
    want = flat(want)
    n = want.numel()
    for partials, gX in ((chunked, cx), (whole, wx)):
        np.testing.assert_allclose(partials.sum(0)[:n].numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12 * want.abs().max().item())
        np.testing.assert_allclose(gX.numpy(), want_x.numpy(), rtol=1e-12, atol=1e-12 * want_x.abs().max().item())
    np.testing.assert_allclose(chunked.sum(0).numpy(), whole.sum(0).numpy(), rtol=1e-12,
                               atol=1e-12 * want.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("layers,act,nd,P,tiles", [c for c in MODEL_CASES if len(c[0]) > 2],
                         ids=[str(c[0]) + c[1] for c in MODEL_CASES if len(c[0]) > 2])
def test_one_chunk_model_gives_the_unchunked_models_bits(layers, act, nd, P, tiles, dtype):
    """Where one chunk covers P (every MODEL_CASES shape), the chunked model
    runs the unchunked model's operations: the same partials and gX, bit for
    bit, as the kernel's one-chunk call launches the unchunked form's
    kernels with its arguments."""
    spec = MLP(layers=layers, activation=act)
    net = net_of(layers, 4, dtype)
    X, g = points_of(P, layers[0], nd, 5, dtype)
    assert bwd_plan(layers, nd, P, tiles, form="layered").chunk_points == P
    got, got_x = layered_model(spec, net, X, g, nd, tiles)
    want, want_x = unchunked_model(spec, net, X, g, nd, tiles)
    assert torch.equal(got, want) and torch.equal(got_x, want_x)


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
@pytest.mark.parametrize("layers,nd", [((2, 256, 1), 2), ((1, 200, 40, 1), 1), ((4, 128, 128, 1), 3),
                                       ((16, 256, 1), 3)])
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
# there, by hand: chunk points (the most 2,048-point groups, a power of two,
# whose stash is within 2^28 B, or P where that covers P), slice tiles (16
# points each, doubled until at most 128 slices a chunk), slices = partial
# rows, row pitch (n_params rounded up to 4), and scratch bytes = 4
# (n_layers - 1) S chunk round4(widest hidden layer).
PHASE15 = [
    ("p2d_scaled 3 x 256", (2, 256, 256, 256, 1), 2, 16384, (16384, 8, 128, 132_612, 4 * 3 * 5 * 16384 * 256)),
    ("p2d_scaled 3 x 128", (2, 128, 128, 128, 1), 2, 16384, (16384, 8, 128, 33_540, 4 * 3 * 5 * 16384 * 128)),
    ("jax_one_layer", (2, 256, 1), 2, 1000, (1000, 1, 63, 1_028, 4 * 1 * 5 * 1000 * 256)),
    ("jax_mixed", (1, 200, 40, 1), 1, 1000, (1000, 1, 63, 8_484, 4 * 2 * 3 * 1000 * 200)),
    ("p3d_quality 3 x 56", (3, 56, 56, 56, 1), 3, 8000, (8000, 4, 125, 6_668, 4 * 3 * 7 * 8000 * 56)),
    ("p3d_quality 3 x 64", (3, 64, 64, 64, 1), 3, 8000, (8000, 4, 125, 8_644, 4 * 3 * 7 * 8000 * 64)),
    ("forced p2d_scaled", (2, 20, 20, 20, 1), 2, 16384, (16384, 8, 128, 924, 4 * 3 * 5 * 16384 * 20)),
    ("forced p3d_quality", (3, 48, 48, 48, 1), 3, 8000, (8000, 4, 125, 4_948, 4 * 3 * 7 * 8000 * 48)),
    ("p2d_scaled 3 x 256 P 131072", (2, 256, 256, 256, 1), 2, 131072,
     (16384, 8, 128, 132_612, 4 * 3 * 5 * 16384 * 256)),  # eight chunks
    ("fields_flat VJP (4, 128, 128, 1)", (4, 128, 128, 1), 3, 8000, (8000, 4, 125, 17_284, 4 * 2 * 7 * 8000 * 128)),
    ("(16, 256, 1)", (16, 256, 1), 3, 8000, (8000, 4, 125, 4_612, 4 * 1 * 7 * 8000 * 256)),
    ("x y z t 3 x 256", (4, 256, 256, 256, 1), 3, 16384, (8192, 4, 128, 133_124, 4 * 3 * 7 * 8192 * 256)),  # two
    ("(256, 1)", (256, 1), 3, 8000, (8000, 4, 125, 260, 0)),  # no hidden layer: no stash
]


@pytest.mark.parametrize("name,layers,nd,P,want", PHASE15, ids=[c[0] for c in PHASE15])
def test_layered_plan_by_hand_at_phase15_shapes(name, layers, nd, P, want):
    plan = bwd_plan(layers, nd, P, form="layered")
    assert (plan.chunk_points, plan.tiles_per_block, plan.n_blocks, plan.row_pitch, plan.scratch_bytes) == want
    assert plan.scratch_bytes == bwd_layered_scratch_bytes(layers, nd, plan.chunk_points) <= LAYERED_SCRATCH_CAP
    span = plan.tiles_per_block * BWD_TILE_POINTS  # a chunk's slices cover it, none empty
    chunk = plan.chunk_points
    assert (plan.n_blocks - 1) * span < chunk <= plan.n_blocks * span and plan.n_blocks <= LAYERED_ROWS
    assert chunk == P or chunk % LAYERED_CHUNK_GROUP == 0


@pytest.mark.parametrize("P,chunk,tiles,rows", [(8000, 8000, 4, 125), (16384, 16384, 8, 128),
                                                (32768, 16384, 8, 128), (65536, 16384, 8, 128),
                                                (131072, 16384, 8, 128)])
def test_layered_scratch_is_capped_by_chunks(P, chunk, tiles, rows):
    """At (2,256,256,256,1), n_dirs 2, by hand: a point's stash is 4 x 3
    layers x 5 streams x 256 = 15,360 B, so 2^28 B holds 8 groups of 2,048
    points (251,658,240 B) and not 16; up to P 16,384 one chunk covers P (the
    plan of one call over all points), above it chunks of 16,384 points, each
    cut into 128 slices of 128 points.  The scratch stops growing with P (it
    was every point's stash: 2,013,265,920 B at P 131,072), and the device
    memory of a call, scratch and partials, stays under 0.35 GB."""
    layers = (2, 256, 256, 256, 1)
    plan = bwd_plan(layers, 2, P, form="layered")
    assert (plan.chunk_points, plan.tiles_per_block, plan.n_blocks) == (chunk, tiles, rows)
    assert plan.scratch_bytes == 4 * 3 * 5 * chunk * 256 <= LAYERED_SCRATCH_CAP == 268_435_456
    assert bwd_layered_scratch_bytes(layers, 2, 2 * LAYERED_CHUNK_GROUP * 8) > LAYERED_SCRATCH_CAP
    assert -(-P // plan.chunk_points) == max(1, P // 16384)
    assert plan.scratch_bytes + 4 * plan.n_blocks * plan.row_pitch < 0.35e9
    if P == 131072:
        assert bwd_layered_scratch_bytes(layers, 2, P) == 2_013_265_920
        assert bwd_plan(layers, 2, P, form="layered", chunk_points=P).scratch_bytes == 2_013_265_920


def test_layered_scratch_never_exceeds_the_cap():
    """At every network B1 takes (widths up to 256, 1-16 layers) and P, the
    layered plan's scratch is within LAYERED_SCRATCH_CAP (one group of 2,048
    points at 16 layers of width 256, n_dirs 3, is 220,200,960 B); its chunk
    is P or a power-of-two number of groups, the largest within the cap;
    and where one chunk covers P the plan is that of one call over all
    points (slices from P, scratch every point's stash)."""
    rng = np.random.default_rng(20)
    nets = [(3, *([256] * 15), 1), (1, 256, 1), (256, 1), (3, 256, 256, 256, 1)]
    nets += [tuple(int(w) for w in (rng.integers(1, 4), *rng.choice([8, 64, 65, 130, 256], rng.integers(0, 16)), 1))
             for _ in range(60)]
    for layers in nets:
        for nd in range(1, min(3, layers[0]) + 1):
            for P in (1, 37, 2047, 2048, 8000, 16384, 40000, 131072, 10**6):
                plan = bwd_plan(layers, nd, P, form="layered")
                chunk = plan.chunk_points
                assert plan.scratch_bytes <= LAYERED_SCRATCH_CAP, (layers, nd, P)
                assert plan.n_blocks <= LAYERED_ROWS
                groups = chunk // LAYERED_CHUNK_GROUP
                assert chunk == P or (chunk % LAYERED_CHUNK_GROUP == 0 and groups & (groups - 1) == 0)
                if chunk < P:  # twice the chunk would pass the cap
                    assert bwd_layered_scratch_bytes(layers, nd, 2 * chunk) > LAYERED_SCRATCH_CAP
                else:
                    n_tiles = -(-P // BWD_TILE_POINTS)
                    T = plan.tiles_per_block
                    assert -(-n_tiles // T) == plan.n_blocks and (T == 1 or -(-n_tiles // (T // 2)) > LAYERED_ROWS)
                    assert plan.scratch_bytes == bwd_layered_scratch_bytes(layers, nd, P)
    assert bwd_layered_scratch_bytes((3, *([256] * 15), 1), 3, LAYERED_CHUNK_GROUP) == 220_200_960


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
    ((4, 128, 128, 1), 2, "layered"),  # four inputs (x, y, z, t)
    ((16, 256, 1), 3, "layered"),
]


@pytest.mark.parametrize("layers,nd,form", RULE, ids=[str(c[0]) for c in RULE])
def test_bwd_plan_three_way_rule_from_shapes_alone(layers, nd, form):
    """Resident where it fits, else layered (B2's two forms); the same at
    every P, from the shapes alone."""
    for P in (1, 64, 1000, 8000, 16384, 10**6):
        plan = bwd_plan(layers, nd, P)
        assert plan.form == form
        assert (plan.scratch_bytes > 0) == (form != "resident")
        if form == "layered":
            assert plan == bwd_plan(layers, nd, P, form="layered")


EDGE = [(layers, nd) for layers in ((100, 1), (256, 1), (100, 20, 1), (4, 128, 128, 1), (16, 256, 1), (256, 256, 1))
        for nd in (1, 2, 3)]


@pytest.mark.parametrize("layers,nd", EDGE, ids=[f"{c[0]}-{c[1]}" for c in EDGE])
def test_every_edge_shape_has_a_b2_form(layers, nd):
    """The networks at the edges of the forms' limits (no hidden layer and
    an input wider than 64, more than three inputs, an input of 256) get a
    form B2 has at every P, and the layered form's plan at each: within the
    cap, no stash without a hidden layer."""
    assert BWD_FORMS == ("resident", "layered")
    for P in (1, 1000, 8000, 131072):
        plan = bwd_plan(layers, nd, P)
        assert plan.form == "layered"  # every one is wider than the resident form's 64
        assert plan.scratch_bytes <= LAYERED_SCRATCH_CAP and plan.n_blocks <= LAYERED_ROWS
        assert (plan.scratch_bytes == 0) == (len(layers) == 2)


def test_bwd_plan_gives_every_network_b1_takes_a_form():
    """Every network B1 takes (widths up to FWD_MAX_WIDTH, 1 to MAX_LAYERS
    layers, n_dirs 1-3 and at most the input count) gets one of B2's two
    forms, resident exactly where it fits."""
    rng = np.random.default_rng(21)
    widths = [1, 2, 3, 4, 16, 48, 55, 64, 65, 100, 200, FWD_MAX_WIDTH]
    nets = [(d, *([w] * h), 1) for d in (1, 3, 4, 64, 65, 256) for w in (1, 20, 64, 65, 256) for h in (0, 1, 2, 3)]
    nets += [tuple(int(w) for w in (rng.choice(widths), *rng.choice(widths, rng.integers(0, MAX_LAYERS)), 1))
             for _ in range(300)]
    for layers in nets:
        assert 1 <= len(layers) - 1 <= MAX_LAYERS and max(layers) <= FWD_MAX_WIDTH
        for nd in range(1, min(3, layers[0]) + 1):
            form = bwd_plan(layers, nd, 8000).form
            assert form in BWD_FORMS
            assert (form == "resident") == (max(layers) <= 64 and bwd_smem_bytes(layers, nd) <= 232_448), layers


def test_layered_slices_depend_on_P_alone():
    """A chunk's slices come from its points alone, the fewest tiles (a
    power of two) that give at most LAYERED_ROWS slices; where one chunk
    covers P (every phase-15 shape up to P 8,000) that is P alone, the same
    for every network."""
    for P in (1, 16, 17, 2048, 2049, 8000, 16384, 65536, 10**6):
        plans = [bwd_plan(layers, nd, P, form="layered") for _, layers, nd, _, _ in PHASE15]
        for plan in plans:
            T = plan.tiles_per_block
            rows = -(-plan.chunk_points // (BWD_TILE_POINTS * T))
            assert rows == plan.n_blocks <= LAYERED_ROWS
            assert T == 1 or -(-plan.chunk_points // (BWD_TILE_POINTS * T // 2)) > LAYERED_ROWS
        if P <= 8000:
            assert len({plan.tiles_per_block for plan in plans}) == 1


def test_layered_refuses_what_it_does_not_take():
    """The layered form takes every network B1 takes, with or without a
    hidden layer and at any input count; what bwd_plan refuses is a form
    B2 does not have (the wide form is gone), a chunk below one point, and
    a chunk forced on the resident form, which does not chunk."""
    assert bwd_plan((2, 1), 2, 100, form="layered").scratch_bytes == 0
    assert bwd_plan((4, 16, 1), 2, 100, form="layered").form == "layered"
    for form in ("tiled", "wide"):
        with pytest.raises(ValueError, match="form"):
            bwd_plan((2, 16, 1), 2, 100, form=form)
    with pytest.raises(ValueError, match="chunk_points"):
        bwd_plan((2, 96, 1), 2, 100, chunk_points=0)
    with pytest.raises(ValueError, match="chunk_points"):
        bwd_plan((2, 16, 1), 2, 100, chunk_points=50)


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
