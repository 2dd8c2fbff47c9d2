"""B2's firsts-only mode (ops/fused_fields.py, second=False), on the CPU.

The var_form-1 backward: the VJP of fields_flat(..., second=False), whose
fields are u and u_k alone.  The JAX package sends it to XLA's VJP of its
Taylor path (hpvpinns_tpu/ops/pallas_fields.py:190-196); the port runs B2's
firsts-only forms on a CUDA tensor (resident: csrc/fused_fields_bwd_firsts.cu;
layered: csrc/fused_fields_bwd_layered.cu compiled without the second-order
streams), and its plain version fields_flat_bwd_reference(..., second=False)
on a CPU tensor.  The kernels
run only on a GPU (chip_smoke.py phase 7 holds them against the plain
version there).  Here:

- the plain version against jax.vjp of the JAX fields_flat(..., False) in
  float32 (its Pallas forward in interpret mode, as tests/test_pallas_fields.py
  runs it) at rtol 2e-4 / atol 1e-5, and against the VJP of the JAX plain
  _xla_fields_flat(..., False) (what that custom VJP calls) in float64 at
  1e-10;
- a torch model of the kernels' firsts-only rules (the stash (t or z, z_k),
  outputs() and gz_point() without the kk streams), launch by launch as the
  layered form runs them chunk by chunk, and group by group as the resident
  kernel sums them into its blocks' partial rows, against the plain version
  in float64;
- bwd_plan's firsts-only plans (shared memory, launch shapes, scratch,
  chunks) by hand with S = 1 + n_dirs, the resident form taking every
  network the second-derivative kernel's firsts-only build took, and the
  second=True plans unchanged;
- the routing: fields_flat's second=False VJP reaches fused_fields_bwd(...,
  second=False), which on a CPU tensor is the plain version bit for bit, and
  each form's wrapper refuses a g whose width is not the mode's.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hpvpinns_tpu.models.mlp import MLP as JMLP  # noqa: E402
from hpvpinns_tpu.ops.pallas_fields import _xla_fields_flat  # noqa: E402
from hpvpinns_tpu.ops.pallas_fields import fields_flat as jfields_flat  # noqa: E402
from hpvpinns_tpu_torch.convert import params_from_jax  # noqa: E402
from hpvpinns_tpu_torch.models.mlp import MLP  # noqa: E402
from hpvpinns_tpu_torch.ops import fused_fields as ff  # noqa: E402
from hpvpinns_tpu_torch.ops.fused_fields import (  # noqa: E402
    BWD_TILE_POINTS,
    FIRSTS_PARTIAL_CAP,
    LAYERED_CHUNK_GROUP,
    LAYERED_SCRATCH_CAP,
    bwd_layered_scratch_bytes,
    bwd_plan,
    bwd_resident_fits,
    bwd_smem_bytes,
    bwd_streams,
    fields_flat,
    fields_flat_bwd_reference,
    fused_fields_bwd,
    fused_fields_bwd_kernel,
    fused_fields_bwd_layered_kernel,
    layered_chunk_points,
    pack_params,
)

GRAD_TOL = dict(rtol=2e-4, atol=1e-5)
P = 70  # one point count for every JAX comparison: the interpret-mode forward compiles once a network
SHAPES = [  # (layers, activation, n_dirs): the slice, three inputs, and one wider than the resident form
    ((2, 20, 20, 20, 1), "tanh", 2),
    ((3, 16, 16, 1), "sin", 3),
    ((2, 96, 80, 1), "tanh", 2),
]


def tree_of(layers, seed):
    """Xavier-scaled normal weights and 0.1-scaled normal biases, from numpy."""
    rng = np.random.default_rng(seed)
    return [{"W": rng.standard_normal((a, b)) * np.sqrt(2.0 / (a + b)), "b": 0.1 * rng.standard_normal(b)}
            for a, b in zip(layers[:-1], layers[1:])]


def inputs(layers, n_dirs, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, (P, layers[0])), rng.standard_normal((P, 1 + n_dirs))


def both(layers, act, n_dirs, dtype):
    """One network and inputs for both packages in `dtype`: (torch spec,
    params, X, g; JAX spec, params, X, g).  The port's weights come through
    params_from_jax."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    tree = [{k: v.astype(np_dtype) for k, v in p.items()} for p in tree_of(layers, 0)]
    X, g = (a.astype(np_dtype) for a in inputs(layers, n_dirs, 1))
    tp = params_from_jax({"net": tree, "pde": {}}, dtype=dtype)["net"]
    jp = jax.tree.map(jnp.asarray, tree)
    return (MLP(layers=layers, activation=act), tp, torch.as_tensor(X), torch.as_tensor(g),
            JMLP(layers=layers, activation=act), jp, jnp.asarray(X), jnp.asarray(g))


def flat(grads):
    return np.concatenate([t.detach().numpy().reshape(-1) for layer in grads for t in (layer["W"], layer["b"])])


def jflat(grads):
    return np.concatenate([np.asarray(t).reshape(-1) for layer in grads for t in (layer["W"], layer["b"])])


@functools.lru_cache(maxsize=None)
def jax_vjp(layers, act, n_dirs, dtype):
    """(gparams, gX) of JAX's firsts-only VJP, compiled once a case: in
    float32 through the custom VJP of fields_flat (the Pallas forward in
    interpret mode), in float64 through the VJP of _xla_fields_flat that it
    calls (the Pallas forward accumulates in float32)."""
    *_, jspec, jp, X, g = both(layers, act, n_dirs, dtype)
    fn = jfields_flat if dtype == torch.float32 else _xla_fields_flat
    _, vjp = jax.vjp(lambda p, x: fn(jspec, p, x, n_dirs, False), jp, X)
    gp, gx = jax.jit(vjp)(g)
    return jflat(gp), np.asarray(gx)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("layers,act,n_dirs", SHAPES, ids=[str(s[0]) for s in SHAPES])
def test_plain_firsts_backward_matches_jax_vjp(layers, act, n_dirs, dtype):
    spec, tp, X, g, *_ = both(layers, act, n_dirs, dtype)
    assert bwd_plan(layers, n_dirs, P, second=False).form == ("layered" if max(layers) > 64 else "resident")
    grads, gx = fields_flat_bwd_reference(spec, tp, X, g, n_dirs, second=False)
    want, want_x = jax_vjp(layers, act, n_dirs, dtype)
    tol = GRAD_TOL if dtype == torch.float32 else dict(rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(flat(grads), want, **tol)
    np.testing.assert_allclose(gx.numpy(), want_x, **tol)


# ---- a torch model of the kernels' firsts-only rules (fused_fields_bwd_rules.cuh) ----

def derivs(v, act):
    """act(z), d1, d2 from the stashed value v (t for tanh, z for sin)."""
    if act == "tanh":
        d1 = 1.0 - v * v
        return v, d1, -2.0 * v * d1
    return torch.sin(v), torch.cos(v), -torch.sin(v)


def outputs(st, act):
    """h, h_k [1 + nd, P, w] from a firsts-only stash (t or z, z_k)."""
    a, d1, _ = derivs(st[0], act)
    return torch.cat([a[None], d1 * st[1:]])


def gz_point(st, gh, act):
    """gz = d1 gh + sum_k d2 z_k gh_k, gz_k = d1 gh_k."""
    _, d1, d2 = derivs(st[0], act)
    return torch.cat([(d1 * gh[0] + (d2 * st[1:] * gh[1:]).sum(0))[None], d1 * gh[1:]])


def stash_value(z, act):
    return torch.tanh(z) if act == "tanh" else z


def chunk_model(layers, act, params, X, g, nd, span):
    """One chunk of the layered form's firsts-only launches (seed, replay,
    head, gw and gh per layer, input, gX), its gradient sums split into
    slices of `span` points: (per-slice rows of the packed gradient, gX)."""
    L, Pc = len(layers) - 1, X.shape[0]
    W, b = [p["W"] for p in params], [p["b"] for p in params]
    offs = np.cumsum([0] + [a * c + c for a, c in zip(layers[:-1], layers[1:])]).tolist()
    slices = [slice(r, min(Pc, r + span)) for r in range(0, Pc, span)]
    rows = torch.zeros((len(slices), offs[-1]), dtype=X.dtype)
    G = g.T.contiguous()  # [1 + nd, P]
    st = [torch.cat([stash_value(X @ W[0] + b[0], act)[None], W[0][:nd, None, :].expand(nd, Pc, layers[1])])]
    for l in range(1, L - 1):
        Z = outputs(st[l - 1], act) @ W[l]
        st.append(torch.cat([stash_value(Z[0] + b[l], act)[None], Z[1:]]))
    h = outputs(st[L - 2], act)
    for r, sl in enumerate(slices):
        rows[r, offs[L - 1]:offs[L - 1] + layers[L - 1]] = (h[:, sl] * G[:, sl, None]).sum((0, 1))
        rows[r, offs[L - 1] + layers[L - 1]] = G[0, sl].sum()
    gz = gz_point(st[L - 2], G[:, :, None] * W[L - 1][:, 0], act)
    for l in range(L - 2, 0, -1):
        din, dout = layers[l], layers[l + 1]
        h = outputs(st[l - 1], act)
        for r, sl in enumerate(slices):
            rows[r, offs[l]:offs[l] + din * dout] = torch.einsum("spi,spj->ij", h[:, sl], gz[:, sl]).reshape(-1)
            rows[r, offs[l] + din * dout:offs[l + 1]] = gz[0, sl].sum(0)
        gz = gz_point(st[l - 1], gz @ W[l].T, act)
    d, w1 = layers[0], layers[1]
    for r, sl in enumerate(slices):
        gW0 = X[sl].T @ gz[0, sl]
        gW0[:nd] += gz[1:, sl].sum(1)
        rows[r, :d * w1] = gW0.reshape(-1)
        rows[r, d * w1:offs[1]] = gz[0, sl].sum(0)
    return rows, gz[0] @ W[0].T


MODEL_CASES = [  # layers, activation, n_dirs, points, chunk points forced (None: the plan's)
    ((2, 20, 20, 20, 1), "tanh", 2, 150, None),
    ((1, 12, 9, 1), "sin", 1, 40, None),
    ((3, 33, 20, 17, 1), "sin", 3, 200, 70),
    ((5, 30, 1), "tanh", 3, 90, 32),
]


@pytest.mark.parametrize("layers,act,nd,n,chunk", MODEL_CASES, ids=[str(c[0]) + c[1] for c in MODEL_CASES])
def test_firsts_rules_model_equals_the_plain_backward_in_float64(layers, act, nd, n, chunk):
    """The firsts-only rules, launch by launch and chunk by chunk as the
    layered form runs them (slice r of every chunk adding into row r), give
    the plain version's gradient to 1e-12."""
    spec = MLP(layers=layers, activation=act)
    rng = np.random.default_rng(3)
    params = [{k: torch.as_tensor(v) for k, v in p.items()} for p in tree_of(layers, 2)]
    X = torch.as_tensor(rng.uniform(-1.0, 1.0, (n, layers[0])))
    g = torch.as_tensor(rng.standard_normal((n, 1 + nd)))
    plan = bwd_plan(layers, nd, n, form="layered", chunk_points=chunk, second=False)
    span = BWD_TILE_POINTS * plan.tiles_per_block
    partials, gX = None, []
    for c0 in range(0, n, plan.chunk_points):
        sl = slice(c0, min(n, c0 + plan.chunk_points))
        rows, gx = chunk_model(layers, act, params, X[sl], g[sl], nd, span)
        partials = rows if partials is None else torch.cat([partials[:rows.shape[0]] + rows, partials[rows.shape[0]:]])
        gX.append(gx)
    assert partials.shape[0] == plan.n_blocks
    want, want_x = fields_flat_bwd_reference(spec, params, X, g, nd, second=False)
    want = torch.as_tensor(flat(want))
    np.testing.assert_allclose(partials.sum(0).numpy(), want.numpy(), rtol=1e-12, atol=1e-12 * want.abs().max().item())
    np.testing.assert_allclose(torch.cat(gX).numpy(), want_x.numpy(), rtol=1e-12,
                               atol=1e-12 * want_x.abs().max().item())


def resident_model(layers, act, params, X, g, nd, pb, T):
    """csrc/fused_fields_bwd_firsts.cu's decomposition: groups of pb points
    (the last one short), each through the replay, gh with gz_point and the
    outputs fused in its epilogue, and gW as its threads sum it (each entry
    over the streams in order, each stream over the group's points), the
    group sums of block b's T groups stored into or added to partial row b
    in group order (pad columns zero); gX group by group.  (partials
    [n_blocks, row pitch], gX)."""
    L, P, d = len(layers) - 1, X.shape[0], layers[0]
    W, b = [p["W"] for p in params], [p["b"] for p in params]
    offs = np.cumsum([0] + [a * c + c for a, c in zip(layers[:-1], layers[1:])]).tolist()
    n_groups = -(-P // pb)
    rows = torch.zeros((-(-n_groups // T), row_pitch(layers)), dtype=X.dtype)
    gX = torch.empty_like(X)
    for grp in range(n_groups):
        sl = slice(grp * pb, min(P, (grp + 1) * pb))
        x, G = X[sl], g[sl].T  # [n, d], [1 + nd, n]
        seed = torch.zeros((1 + nd, x.shape[0], d), dtype=X.dtype)
        seed[0] = x
        for k in range(nd):
            seed[1 + k, :, k] = 1.0
        h, st = seed, []
        for l in range(L - 1):  # replay: stash (t or z, z_k), next inputs
            Z = h @ W[l]
            st.append(torch.cat([stash_value(Z[0] + b[l], act)[None], Z[1:]]))
            h = outputs(st[l], act)
        sums = torch.zeros(offs[-1], dtype=X.dtype)
        gz = G[:, :, None]  # [1 + nd, n, 1]: gz of the last layer
        for l in range(L - 1, -1, -1):
            din, dout = layers[l], layers[l + 1]
            if l > 0:  # gh's epilogue: gz of the layer below, and its outputs over its stash
                gzn = gz_point(st[l - 1], gz @ W[l].T, act)
                H = outputs(st[l - 1], act)
            else:
                H = seed
            gw = torch.zeros((din, dout), dtype=X.dtype)
            for s in range(1 + nd):
                gw = gw + H[s].T @ gz[s]
            sums[offs[l]:offs[l] + din * dout] = gw.reshape(-1)
            sums[offs[l] + din * dout:offs[l + 1]] = gz[0].sum(0)
            if l == 0:
                gX[sl] = gz[0] @ W[0].T
            else:
                gz = gzn
        rows[grp // T, :offs[-1]] += sums
    return rows, gX


RESIDENT_CASES = [  # layers, activation, n_dirs, points, groups a block forced (None: the plan's)
    ((2, 20, 20, 20, 1), "tanh", 2, 150, None),
    ((3, 48, 48, 48, 1), "sin", 3, 37, None),
    ((1, 12, 9, 1), "sin", 1, 45, 3),
    ((3, 33, 20, 17, 1), "tanh", 3, 70, 2),
    ((2, 1), "tanh", 2, 20, None),
]


@pytest.mark.parametrize("layers,act,nd,n,T", RESIDENT_CASES, ids=[str(c[0]) + c[1] for c in RESIDENT_CASES])
def test_firsts_resident_model_equals_the_plain_backward_in_float64(layers, act, nd, n, T):
    """The resident kernel's groups, epilogues and partial rows (bwd_plan's
    launch shape: its groups of points, T of them a block) give the plain
    version's gradient to 1e-12, with one row a block and zero pad columns."""
    spec = MLP(layers=layers, activation=act)
    rng = np.random.default_rng(5)
    params = [{k: torch.as_tensor(v) for k, v in p.items()} for p in tree_of(layers, 6)]
    X = torch.as_tensor(rng.uniform(-1.0, 1.0, (n, layers[0])))
    g = torch.as_tensor(rng.standard_normal((n, 1 + nd)))
    plan = bwd_plan(layers, nd, n, tiles_per_block=T, second=False)
    assert plan.form == "resident" and plan.warps_per_block in (1, 2, 4)
    rows, gX = resident_model(layers, act, params, X, g, nd, plan.group_points, plan.tiles_per_block)
    assert rows.shape == (plan.n_blocks, plan.row_pitch)
    n_params = pack_params(spec, params)[0].numel()
    assert (rows[:, n_params:] == 0).all()
    want, want_x = fields_flat_bwd_reference(spec, params, X, g, nd, second=False)
    want = torch.as_tensor(flat(want))
    np.testing.assert_allclose(rows.sum(0)[:n_params].numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-12 * want.abs().max().item())
    np.testing.assert_allclose(gX.numpy(), want_x.numpy(), rtol=1e-12, atol=1e-12 * want_x.abs().max().item())


# ---- the plans, by hand with S = 1 + n_dirs ----

def row_pitch(layers):
    return -(-sum(a * b + b for a, b in zip(layers[:-1], layers[1:])) // 4) * 4


# chip_smoke.py phase 7's firsts-only shapes: (name, layers, n_dirs, P) and
# (form, tiles (groups) a block, n_blocks, shared memory, scratch, chunk
# points, points a group, warps a block).  Resident (csrc/fused_fields_bwd_firsts.cu):
# groups of 16 points (ragged: 8, as 63 groups of 16 would leave SMs of an
# H100 empty), one a block, the fewest warps whose 2-point x 3-neuron threads
# cover the widest hidden layer in two passes (20: 8 x 4 = 32 threads, 1
# warp), or 4 where there are fewer blocks than twice the SMs
# (p2d_quality's 256, ragged's 126); shared memory: the packed network
# (row_pitch floats) and (n_layers + 1) buffers of (1 + n_dirs) x round4(max
# width) x point stride floats (16 points -> 20, 8 -> 12).  The layered
# form's shared-memory entry is the resident kernel's at its smallest groups
# (4 points, stride 4); scratch: the hidden layers' stash of (1 + n_dirs) x
# P x pitch floats each.
FIRSTS_PLANS = [
    ("p2d_scaled", (2, 20, 20, 20, 1), 2, 16384,
     ("resident", 1, 1024, 4 * (924 + 5 * 3 * 20 * 20), 0, 16384, 16, 1)),
    ("p2d_quality", (2, 48, 48, 48, 48, 1), 2, 4096,
     ("resident", 1, 256, 4 * (7252 + 6 * 3 * 48 * 20), 0, 4096, 16, 4)),
    ("ragged", (3, 48, 48, 48, 1), 3, 1003, ("resident", 1, 126, 4 * (4948 + 5 * 4 * 48 * 12), 0, 1003, 8, 4)),
    ("p2d_scaled 3 x 256", (2, 256, 256, 256, 1), 2, 16384,
     ("layered", 8, 128, 4 * (132612 + 5 * 3 * 256 * 4), 4 * 3 * 3 * 16384 * 256, 16384, 16, 0)),
]


@pytest.mark.parametrize("name,layers,nd,P_,want", FIRSTS_PLANS, ids=[c[0] for c in FIRSTS_PLANS])
def test_firsts_plan_by_hand_at_phase7_shapes(name, layers, nd, P_, want):
    plan = bwd_plan(layers, nd, P_, second=False)
    assert (plan.form, plan.tiles_per_block, plan.n_blocks, plan.smem_bytes, plan.scratch_bytes,
            plan.chunk_points, plan.group_points, plan.warps_per_block) == want
    assert plan.row_pitch == row_pitch(layers) and bwd_streams(nd, False) == 1 + nd
    pb = plan.group_points if plan.form == "resident" else 4
    assert bwd_smem_bytes(layers, nd, False, pb) == want[3]
    assert bwd_layered_scratch_bytes(layers, nd, P_, False) == 4 * (len(layers) - 2) * (1 + nd) * P_ * (
        -(-max(layers[1:-1]) // 4) * 4)


LAUNCH_CASES = [  # layers, n_dirs, P and the resident form's (group points, warps, groups a block, blocks)
    ((2, 20, 20, 20, 1), 2, 65536, (16, 1, 4, 1024)),  # 4,096 groups: four a block keep one wave (8 blocks an SM)
    ((3, 48, 48, 48, 1), 3, 8000, (16, 4, 2, 250)),  # poisson3d_quality: 500 groups, 2 blocks an SM: 250 < 264
    ((2, 64, 64, 64, 64, 1), 2, 4096, (16, 4, 2, 128)),  # 256 rows of 12,740 floats exceed FIRSTS_PARTIAL_CAP
    ((2, 5, 5, 5, 1), 2, 100, (8, 4, 1, 13)),  # advdiff_of_record's shapes: 8-point groups, 13 of them: 4 warps
    ((1, 12, 1), 1, 2000, (8, 4, 1, 250)),
    ((2, 12, 12, 1), 1, 8192, (16, 1, 1, 512)),  # 512 groups: the fewest warps covering 12 neurons (8 x 2 threads)
]


@pytest.mark.parametrize("layers,nd,P_,want", LAUNCH_CASES, ids=[f"{c[0]} P {c[2]}" for c in LAUNCH_CASES])
def test_firsts_resident_launch_shapes_by_hand(layers, nd, P_, want):
    """firsts_launch's rules at other shapes: groups a block double until the
    blocks fit one wave and the partial rows FIRSTS_PARTIAL_CAP."""
    plan = bwd_plan(layers, nd, P_, second=False)
    assert plan.form == "resident"
    assert (plan.group_points, plan.warps_per_block, plan.tiles_per_block, plan.n_blocks) == want
    assert plan.n_blocks * plan.row_pitch <= FIRSTS_PARTIAL_CAP
    assert bwd_plan(layers, nd, P_, tiles_per_block=1, second=False).n_blocks == -(-P_ // plan.group_points)


def old_firsts_smem(layers, nd):
    """The shared memory of the second-derivative kernel compiled firsts only
    (before its own kernel): two padded copies of the network, (n_layers + 2) buffers
    of (1 + n_dirs) x max width x 20 floats."""
    return 4 * (2 * row_pitch(layers) + (len(layers) + 1) * (1 + nd) * max(layers[:-1]) * 20)


@pytest.mark.parametrize("nd", [1, 2, 3])
def test_firsts_resident_takes_every_network_the_old_build_took(nd):
    """Every network of widths <= 64 whose old firsts-only block fit an H100
    block (232,448 B) fits the new kernel, at its least groups and at the
    plan's, for a spread of depths and widths."""
    rng = np.random.default_rng(nd)
    seen = 0
    for depth in range(1, 17):
        for _ in range(12):
            layers = (int(rng.integers(nd, 65)), *rng.integers(1, 65, depth - 1).tolist(), 1)
            if old_firsts_smem(layers, nd) > 232448:
                continue
            seen += 1
            assert bwd_resident_fits(layers, nd, second=False)
            plan = bwd_plan(layers, nd, 4096, second=False)
            assert plan.form == "resident" and plan.smem_bytes <= 232448
    assert seen > 20


SECOND_PLANS = [  # tests/test_torch_fused_fields_bwd.py's PHASE7 plans and phase 15's 3 x 256, second=True
    ((1, 20, 20, 20, 20, 1), 1, 80, ("resident", 1, 5, 4 * (2 * 1324 + 7 * 3 * 20 * 20), 0)),
    ((2, 20, 20, 20, 1), 2, 16384, ("resident", 2, 512, 4 * (2 * 924 + 6 * 5 * 20 * 20), 0)),
    ((2, 48, 48, 48, 48, 1), 2, 4096, ("resident", 1, 256, 4 * (2 * 7252 + 7 * 5 * 48 * 20), 0)),
    ((3, 48, 48, 48, 1), 3, 1003, ("resident", 1, 63, 4 * (2 * 4948 + 6 * 7 * 48 * 20), 0)),
    ((2, 256, 256, 256, 1), 2, 16384,
     ("layered", 8, 128, 4 * (2 * 132612 + 6 * 5 * 256 * 20), 4 * 3 * 5 * 16384 * 256)),
]


@pytest.mark.parametrize("layers,nd,P_,want", SECOND_PLANS, ids=[str(c[0]) for c in SECOND_PLANS])
def test_second_derivative_plans_are_unchanged(layers, nd, P_, want):
    """second=True, said or by default, keeps the plans the kernels had
    before the firsts-only mode."""
    plan = bwd_plan(layers, nd, P_, second=True)
    assert plan == bwd_plan(layers, nd, P_)
    assert (plan.form, plan.tiles_per_block, plan.n_blocks, plan.smem_bytes, plan.scratch_bytes) == want
    assert bwd_smem_bytes(layers, nd) == bwd_smem_bytes(layers, nd, True) == want[3]


def test_firsts_chunks_and_forms_follow_the_smaller_stash():
    """A firsts-only stash is (1 + n_dirs) / (1 + 2 n_dirs) of a
    second-derivative one, so under the same cap a layered chunk holds more
    points (a power of two of LAYERED_CHUNK_GROUP-point groups), and the
    resident form takes networks whose second-derivative block does not fit."""
    layers = (2, 256, 256, 1)  # 10,240 B a point with second derivatives, 6,144 firsts only
    assert layered_chunk_points(layers, 2, 131072) == 16384
    assert layered_chunk_points(layers, 2, 131072, second=False) == 32768
    for second, chunk in ((True, 16384), (False, 32768)):
        plan = bwd_plan(layers, 2, 131072, second=second)
        assert (plan.chunk_points, plan.n_blocks) == (chunk, 128)
        assert plan.scratch_bytes == bwd_layered_scratch_bytes(layers, 2, chunk, second) <= LAYERED_SCRATCH_CAP
        assert bwd_layered_scratch_bytes(layers, 2, 2 * chunk, second) > LAYERED_SCRATCH_CAP
        assert chunk % LAYERED_CHUNK_GROUP == 0
    deep = (2, 64, 64, 64, 64, 1)  # second derivatives 281,120 B of shared memory; firsts only 69,392 B at least
    assert not bwd_resident_fits(deep, 2) and bwd_resident_fits(deep, 2, second=False)
    assert bwd_smem_bytes(deep, 2, second=False) == 4 * (12740 + 6 * 3 * 64 * 4) == 69392
    assert (bwd_plan(deep, 2, 4096).form, bwd_plan(deep, 2, 4096, second=False).form) == ("layered", "resident")


# ---- the routing ----

def test_firsts_vjp_goes_through_b2s_path():
    """_fields_flat_vjp at second=False reaches fused_fields_bwd(...,
    second=False), which on a CPU tensor is the plain version bit for bit;
    without want_x it returns the parameters' gradients alone; and autograd
    through fields_flat takes the same route."""
    layers, nd = (2, 20, 20, 20, 1), 2
    spec, tp, X, g, *_ = both(layers, "tanh", nd, torch.float64)
    flat_params = ff._flatten(tp)
    calls = []

    def spy(*args, **kw):
        calls.append((args[4:], kw))
        return fused_fields_bwd(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ff, "fused_fields_bwd", spy)
        got = ff._fields_flat_vjp(spec, nd, False, True, g, X, flat_params)
        no_x = ff._fields_flat_vjp(spec, nd, False, False, g, X, flat_params)
        Xt = X.clone().requires_grad_(True)
        leaves = [t.clone().requires_grad_(True) for t in flat_params]
        auto = torch.autograd.grad((fields_flat(spec, ff._unflatten(leaves), Xt, nd, False) * g).sum(), [Xt] + leaves)
    assert [c[0] for c in calls] == [(nd, True, False), (nd, False, False), (nd, True, False)]
    want, want_x = fields_flat_bwd_reference(spec, tp, X, g, nd, second=False)
    want_flat = ff._flatten(want)
    assert len(got) == 1 + len(want_flat) and len(no_x) == len(want_flat)
    for a, b in zip(got, [want_x, *want_flat], strict=True):
        assert a.dtype == torch.float64 and torch.equal(a, b)
    for a, b in zip(no_x, want_flat, strict=True):
        assert torch.equal(a, b)
    for a, b in zip(auto, [want_x, *want_flat], strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kernel", [fused_fields_bwd_kernel, fused_fields_bwd_layered_kernel],
                         ids=["resident", "layered"])
def test_wrappers_refuse_a_cotangent_of_the_other_mode(kernel):
    """g must have 1 + n_dirs columns firsts only and 1 + 2 n_dirs with
    second derivatives; with the mode's width the wrapper goes on to refuse
    the CPU tensor.  Nothing launches."""
    spec = MLP(layers=(2, 8, 8, 1))
    tp = [{k: torch.as_tensor(v, dtype=torch.float32) for k, v in p.items()} for p in tree_of(spec.layers, 4)]
    X = torch.zeros((5, 2), dtype=torch.float32)
    for second, bad, good in ((False, 5, 3), (True, 3, 5)):
        with pytest.raises(ValueError, match=rf"g must be contiguous float32 \[5, {good}\] \(second={second}\)"):
            kernel.prepare(spec, tp, X, torch.zeros((5, bad)), 2, second=second)
        with pytest.raises(ValueError, match="CUDA"):
            kernel(spec, tp, X, torch.zeros((5, good)), 2, second=second)
    assert kernel.launches == kernel.firsts_launches == 0
