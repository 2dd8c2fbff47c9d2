"""Fused MLP + derivative-field kernel (B1), its backward kernel (B2), and
the gradient that joins them.

Counterpart of hpvpinns_tpu/ops/pallas_fields.py.  `fields_flat` returns
[P, F] with F = 1 + n_dirs * (2 if second else 1) columns (u, firsts...,
seconds...).  Its forward is the hand-written CUDA kernel
csrc/fused_fields.cu on a CUDA tensor, and the plain PyTorch version
`fields_flat_reference` on a CPU tensor; on a CUDA tensor the kernel
launches or the call raises, it never falls back.  The kernels take float32,
sin/tanh, a scalar output, n_dirs 1-3, up to MAX_LAYERS = 16 layers and layer
widths up to FWD_MAX_WIDTH = 256, and raise above.  B1 has two forms,
resident or staged, chosen by `fwd_plan`; B2 two: resident (everything in
shared memory, widths up to BWD_RESIDENT_WIDTH = 64) and layered (per-layer
GEMMs over chunks of points, its stash in device memory under
LAYERED_SCRATCH_CAP bytes, csrc/fused_fields_bwd_layered.cu), chosen by
`bwd_plan`.  Both plans are functions of the shapes alone.

The gradient is B2, csrc/fused_fields_bwd.cu, csrc/fused_fields_bwd_firsts.cu
and csrc/fused_fields_bwd_layered.cu, in either mode: for second=True the
JAX package's _fields_bwd_kernel, for second=False the same chain without
the second-order streams (the VJP the JAX package leaves to XLA's VJP of
its Taylor path, pallas_fields.py:190-196; its TPU kernel has no backward
for that layout): the layered form compiled without them, and a resident
kernel of its own.  B2 writes per-block (per-slice) partial sums of
the weight gradients, added in a fixed order by a second kernel
(block_sum), so the gradient is bit-identical from run to run.  On a CPU
tensor its plain version `fields_flat_bwd_reference` (autograd through the
plain forward of the same mode) runs instead; on a CUDA tensor the kernels
launch or the call raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from hpvpinns_tpu_torch.models.mlp import MLP
from hpvpinns_tpu_torch.ops.cuda_build import CSRC_DIR, BuiltLibrary, build_library
from hpvpinns_tpu_torch.ops.taylor import mlp_fields

# FWD_MAX_WIDTH / MAX_LAYERS must equal kMaxWidth / kMaxLayers in both
# csrc/fused_fields.cu (B1) and csrc/fused_fields_bwd.cu (B2), and
# BWD_RESIDENT_WIDTH kResidentMaxWidth in the latter; the kernels reject wider
# or deeper networks too.
FWD_MAX_WIDTH = 256
FORWARD_MODE_ERROR = (
    "deriv_mode='pallas' has no forward-mode derivative: the fused-fields kernels have a VJP (B2) and no JVP, "
    "as the JAX package's custom_vjp has none.  Forward-mode products (a JVP, the Gauss-Newton Jacobian by "
    "columns when parameters <= residuals, the matrix-free 'cg'/'lsqr' solves) need deriv_mode 'taylor' or 'jvp'"
)
BWD_RESIDENT_WIDTH = 64
MAX_LAYERS = 16
_ACTIVATION_CODE = {"tanh": 0, "sin": 1}


def fields_flat_reference(spec: MLP, params, X: torch.Tensor, n_dirs: int, second: bool):
    """Plain PyTorch version of the kernel (counterpart of _xla_fields_flat)."""
    u, firsts, seconds = mlp_fields(spec, params, X, tuple(range(n_dirs)), second=second)
    return torch.cat([u, *firsts, *seconds], dim=1)


def _flatten(params):
    return [t for layer in params for t in (layer["W"], layer["b"])]


def _unflatten(flat):
    return [{"W": flat[i], "b": flat[i + 1]} for i in range(0, len(flat), 2)]


def pack_params(spec: MLP, params):
    """The kernel's parameter layout: W_0 [in, out], b_0, W_1, b_1, ... back
    to back in one contiguous fp32 buffer, and the int32 widths."""
    packed = torch.cat([t.reshape(-1) for t in _flatten(params)])
    return packed.contiguous(), np.asarray(spec.layers, dtype=np.int32)


def check_kernel_network(spec: MLP) -> None:
    """Raise the JAX package's ValueErrors for a network no kernel takes, on
    every device: an adaptive slope (pallas_fields.py:113-116), then an
    activation other than sin/tanh (:40-45)."""
    if spec.adaptive_slope:
        raise ValueError("deriv_mode='pallas' does not support adaptive_slope; use 'taylor'")
    if spec.activation not in _ACTIVATION_CODE:
        raise ValueError(f"pallas fields kernel supports sin/tanh activations; got {spec.activation!r}")


def check_kernel_args(spec: MLP, params, X: torch.Tensor, n_dirs: int, max_width: int = FWD_MAX_WIDTH) -> None:
    """Raise on anything a kernel does not take: an adaptive slope or an
    activation other than sin/tanh (check_kernel_network), widths above
    max_width (the limit of the kernel that is served), more than MAX_LAYERS
    layers, a non-scalar output, X that is not contiguous float32 on a CUDA
    device, or params of another type, shape or device."""
    check_kernel_network(spec)
    if spec.layers[-1] != 1:
        raise ValueError(f"fused_fields kernel needs a scalar output; got layers {spec.layers}")
    if max(spec.layers) > max_width or spec.n_layers > MAX_LAYERS:
        raise ValueError(
            f"fused_fields kernel supports widths <= {max_width} and <= {MAX_LAYERS} "
            f"layers; got {spec.layers}"
        )
    if not 1 <= n_dirs <= min(3, spec.layers[0]):
        raise ValueError(f"n_dirs must be in 1..min(3, d_in); got {n_dirs}")
    if not X.is_cuda or X.dtype != torch.float32:
        raise ValueError(f"fused_fields kernel takes a float32 CUDA tensor; got {X.dtype} on {X.device}")
    if X.dim() != 2 or X.shape[1] != spec.layers[0] or not X.is_contiguous():
        raise ValueError(f"X must be contiguous [P, {spec.layers[0]}]; got {tuple(X.shape)}")
    for l, layer in enumerate(params):
        for name, shape in (("W", spec.layers[l : l + 2]), ("b", spec.layers[l + 1 : l + 2])):
            t = layer[name]
            if t.device != X.device or t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
                raise ValueError(
                    f"layer {l} {name}: expected float32 {tuple(shape)} on {X.device}; "
                    f"got {t.dtype} {tuple(t.shape)} on {t.device}"
                )


class CudaLibrary:
    """A library csrc/<name>.cu behind a ctypes handle, built with nvcc at
    first use.  `signatures` maps each exported function to its ctypes
    argument types (it returns an int: a launch returns a CUDA error code)
    or to (argument types, return type); every library also exports
    hp_<name>_smem_bytes (its argument types are `smem_bytes_args`),
    _smem_limit, _max_width and _max_layers, and its limits must equal
    `max_width` / MAX_LAYERS."""

    def __init__(self, name: str, signatures: dict, smem_bytes_args: list, max_width: int, sources=None):
        self.name, self._signatures, self._smem_bytes_args = name, signatures, smem_bytes_args
        self.max_width = max_width
        self.sources = sources or (f"{name}.cu",)  # under csrc/, one nvcc each
        self.built: BuiltLibrary | None = None
        self._smem_limit = {}

    def load(self) -> BuiltLibrary:
        if self.built is None:
            built = build_library(self.name, [CSRC_DIR / src for src in self.sources])
            lib, i32, pre = built.lib, ctypes.c_int, f"hp_{self.name}"
            signatures = {
                **{fn: (args if isinstance(args, tuple) else (args, i32)) for fn, args in self._signatures.items()},
                f"{pre}_smem_bytes": (self._smem_bytes_args, ctypes.c_longlong),
                f"{pre}_smem_limit": ([i32], i32),
                f"{pre}_max_width": ([], i32),
                f"{pre}_max_layers": ([], i32),
            }
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
            if (getattr(lib, f"{pre}_max_width")(), getattr(lib, f"{pre}_max_layers")()) != (self.max_width, MAX_LAYERS):
                raise RuntimeError(f"csrc/{self.name}.cu limits disagree with {self.max_width} / MAX_LAYERS")
            self.built = built
        return self.built

    def smem_limit(self, dev: int) -> int:
        """The most shared memory one block may opt in to on device `dev`."""
        if dev not in self._smem_limit:
            self._smem_limit[dev] = getattr(self.load().lib, f"hp_{self.name}_smem_limit")(dev)
        return self._smem_limit[dev]

    def check_smem(self, dev: int, smem_args, what: str) -> None:
        """Raise unless the kernel's shared memory for `smem_args` fits the
        card's per-block limit."""
        smem = getattr(self.load().lib, f"hp_{self.name}_smem_bytes")(*smem_args)
        if smem > self.smem_limit(dev):
            raise ValueError(
                f"{self.name} kernel needs {smem} B of shared memory for {what}; "
                f"the card allows {self.smem_limit(dev)} B per block"
            )


class KernelWrapper:
    """A kernel's wrapper around the launch function `fn` of `library`:
    `launch` raises on a CUDA error, and `launches` counts the host
    launches.  Under a CUDA graph those are the warm-up's and the capture's,
    not the replays: the graph's counters in utils/profiling.py give the
    kernel's nodes and its replays."""

    def __init__(self, library: CudaLibrary, fn: str):
        self.library, self.fn = library, fn
        self.launches = 0

    def load(self) -> BuiltLibrary:
        return self.library.load()

    def launch(self, *args) -> None:
        self._launch(self.fn, args)

    def _launch(self, fn: str, args) -> None:
        err = getattr(self.load().lib, fn)(*args)
        if err != 0:
            raise RuntimeError(f"{fn} launch failed: CUDA error {err}")
        self.launches += 1


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


_VP, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FWD_LIBRARY = CudaLibrary(
    "fused_fields",
    {
        "hp_fused_fields_f32": [_VP, _VP, _VP, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _I64, _VP, _I32, _VP],
        "hp_fused_fields_staged_points": [],
        "hp_fused_fields_staged_groups": [],
    },
    [_VP, _I32, _I32, _I32, _I32, _I32, _I32], FWD_MAX_WIDTH,
)
_BWD_LIBRARY = CudaLibrary("fused_fields_bwd", {
    "hp_fused_fields_bwd_f32": [_VP, _VP, _VP, _VP, _I32, _I32, _I32, _I32, _I32, _I32, _VP, _VP, _I32, _VP],
    "hp_fused_fields_bwd_firsts_f32": [_VP, _VP, _VP, _VP] + [_I32] * 8 + [_VP, _VP, _I32, _VP],
    "hp_fused_fields_bwd_firsts_smem_bytes": ([_VP, _I32, _I32, _I32], _I64),
    "hp_fused_fields_bwd_layered_f32": [_VP, _VP, _VP, _VP, _I32, _I32, _I32, _I32, _I32, _I32, _I32, _VP, _VP, _VP,
                                        _I32, _VP],
    "hp_fused_fields_bwd_layered_replay_f32": [_VP, _VP, _VP, _I32, _I32, _I32, _I32, _VP, _I32, _VP],
    "hp_fused_fields_bwd_layered_scratch_bytes": ([_I32] * 5, _I64),
    "hp_block_sum_f32": [_VP, _I32, _I32, _I32, _I32, _I32, _VP, _VP, _VP, _I32, _VP],
    "hp_fused_fields_bwd_block_points": [],
    "hp_fused_fields_bwd_point_stride": [],
    "hp_fused_fields_bwd_resident_max_width": [],
}, [_I32] * 5, FWD_MAX_WIDTH, ("fused_fields_bwd.cu", "fused_fields_bwd_firsts.cu", "fused_fields_bwd_layered.cu"))


# B1's launch shape.  FWD_STAGED_POINTS / FWD_STAGED_GROUPS / FWD_TILE must
# equal kStagedPoints / kStagedGroups / kJT in csrc/fused_fields.cu (the
# wrapper checks the first two after the build, the C function the plan).
FWD_TILE = 4  # consecutive output neurons per thread: a row of W is padded to it in shared memory
FWD_MAX_THREADS = 256
FWD_RESIDENT_WIDTH = 64  # the resident form's widest layer
FWD_MIN_BLOCKS = 256  # points per block shrink until the grid has this many blocks: about two per SM of an H100
FWD_BLOCK_POINTS = (32, 16, 8)
FWD_STAGED_POINTS = 16
FWD_STAGED_GROUPS = 16
FWD_K_TILES = (32, 16, 8)  # input rows of W per shared-memory tile in the staged form, largest first
# An H100, against which the plans are chosen: its SMs, the staged blocks an
# SM's registers hold (the lightest staged instantiations take 64-80 a
# thread), an SM's shared memory, what one block may opt in to, and what the
# card keeps back per block.
FWD_SMS = 132
FWD_STAGED_BLOCKS_PER_SM = 3
SMEM_PER_SM = 233_472
SMEM_PER_BLOCK = 232_448
SMEM_RESERVED_PER_BLOCK = 1024


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """B1's launch shape for a network, a stream count and P points: the form
    (staged or resident), block_points points x groups neuron-tile groups per
    block, k_tile rows of W per tile (staged; else 0), n_blocks blocks and
    the shared memory one block needs."""

    staged: bool
    block_points: int
    groups: int
    k_tile: int
    n_blocks: int
    smem_bytes: int


def _padded(n: int) -> int:
    return -(-n // FWD_TILE) * FWD_TILE


def fwd_smem_bytes(layers, n_dirs: int, second: bool, staged: bool, block_points: int, k_tile: int = 0) -> int:
    """Shared memory of one B1 block (hp_fused_fields_smem_bytes).  Resident:
    every W at a row pitch padded to FWD_TILE with its b, and two stream
    buffers of S x widest input x block_points floats.  Staged: one stream
    buffer of FWD_STAGED_POINTS points, two W tiles of k_tile rows at the
    widest padded pitch, every padded b and the output layer's weights."""
    S = 1 + n_dirs * (2 if second else 1)
    max_w = max(layers[:-1])
    if not staged:
        n_net = sum((a + 1) * _padded(b) for a, b in zip(layers[:-1], layers[1:]))
        return 4 * (n_net + 2 * S * max_w * block_points)
    small = _padded(layers[-2]) + sum(_padded(b) for b in layers[1:])
    return 4 * (S * max_w * FWD_STAGED_POINTS + 2 * k_tile * max(_padded(b) for b in layers[1:]) + small)


def _staged_k_tile(layers, n_dirs: int, second: bool, n_blocks: int) -> int:
    """Rows of W per tile in the staged form.  With at most a block per SM
    the largest tile (fewest barriers); with more, the largest tile that
    still lets the most blocks share an SM's shared memory: at widths near
    256 the blocks per SM, not the tile, set the time on an H100."""
    if n_blocks <= FWD_SMS:
        return FWD_K_TILES[0]

    def blocks_per_sm(k_tile):
        return min(FWD_STAGED_BLOCKS_PER_SM, SMEM_PER_SM // (
            fwd_smem_bytes(layers, n_dirs, second, True, FWD_STAGED_POINTS, k_tile) + SMEM_RESERVED_PER_BLOCK))

    return max(FWD_K_TILES, key=lambda k_tile: (blocks_per_sm(k_tile), k_tile))


@functools.lru_cache(maxsize=256)
def fwd_plan(layers: tuple, n_dirs: int, second: bool, P: int, staged: bool | None = None,
             block_points: int | None = None, k_tile: int | None = None) -> FwdPlan:
    """B1's plan, from the shapes alone (so it does not depend on the card).

    The resident form where no layer is wider than FWD_RESIDENT_WIDTH and the
    network fits beside its stream buffers, else the staged form (`staged`,
    `block_points` and `k_tile` force each: for tests and sweeps).  Resident: the
    most points per block of FWD_BLOCK_POINTS that still gives
    FWD_MIN_BLOCKS blocks (else the fewest), and as many neuron-tile groups
    as the widest hidden layer has tiles, halved (thirded, ...) until the
    block has at most FWD_MAX_THREADS threads, so that every group has a
    tile in every round of that layer.  Staged: FWD_STAGED_POINTS points x
    FWD_STAGED_GROUPS groups, and the tile rows of _staged_k_tile."""
    if staged is None:
        staged = max(layers) > FWD_RESIDENT_WIDTH or fwd_smem_bytes(
            layers, n_dirs, second, False, block_points or FWD_BLOCK_POINTS[-1]) > SMEM_PER_BLOCK
    if staged:
        if block_points not in (None, FWD_STAGED_POINTS):
            raise ValueError(f"the staged form takes {FWD_STAGED_POINTS} points per block; got {block_points}")
        points, groups = FWD_STAGED_POINTS, FWD_STAGED_GROUPS
        k_tile = k_tile or _staged_k_tile(layers, n_dirs, second, -(-P // points))
    else:
        fits = [n for n in FWD_BLOCK_POINTS if fwd_smem_bytes(layers, n_dirs, second, False, n) <= SMEM_PER_BLOCK]
        points = block_points or next((n for n in fits if -(-P // n) >= FWD_MIN_BLOCKS), fits[-1] if fits else FWD_BLOCK_POINTS[-1])
        tiles = max(_padded(b) for b in layers[1:]) // FWD_TILE
        rounds = -(-tiles // (FWD_MAX_THREADS // points))
        groups, k_tile = -(-tiles // rounds), 0
    return FwdPlan(staged, points, groups, k_tile, -(-P // points),
                   fwd_smem_bytes(layers, n_dirs, second, staged, points, k_tile))


class LayerPointers(ctypes.Structure):
    """The kernel's table of the layers (LayerPtrs in csrc/fused_fields.cu):
    the device pointers of W_0.. and of b_0.., null beyond the last layer."""

    _fields_ = [("W", ctypes.c_void_p * MAX_LAYERS), ("b", ctypes.c_void_p * MAX_LAYERS)]


def layer_pointers(spec: MLP, params, device: torch.device) -> LayerPointers:
    """Check every layer in one pass (contiguous float32 W [in, out] and b
    [out] on `device`) and return the table of their pointers: B1 reads the
    layers where they lie."""
    layers = spec.layers
    if len(params) != len(layers) - 1 or len(params) > MAX_LAYERS:
        raise ValueError(f"expected {len(layers) - 1} layers (at most {MAX_LAYERS}); got {len(params)}")
    table = LayerPointers()
    for l, layer in enumerate(params):
        W, b = layer["W"], layer["b"]
        if not (W.dtype == b.dtype == torch.float32 and W.device == b.device == device
                and W.shape == (layers[l], layers[l + 1]) and b.shape == (layers[l + 1],)
                and W.is_contiguous() and b.is_contiguous()):
            raise ValueError(
                f"layer {l}: expected contiguous float32 W {(layers[l], layers[l + 1])} and b {(layers[l + 1],)} on "
                f"{device}; got W {W.dtype} {tuple(W.shape)} on {W.device} (contiguous: {W.is_contiguous()}), "
                f"b {b.dtype} {tuple(b.shape)} on {b.device} (contiguous: {b.is_contiguous()})"
            )
        table.W[l], table.b[l] = W.data_ptr(), b.data_ptr()
    return table


@functools.lru_cache(maxsize=256)
def _widths_array(layers: tuple) -> np.ndarray:
    return np.asarray(layers, dtype=np.int32)


class FusedFieldsKernel(KernelWrapper):
    """B1, the CUDA kernels of csrc/fused_fields.cu (the resident and the
    staged form), built at first use."""

    def load(self) -> BuiltLibrary:
        built = self.library.load()
        lib = built.lib
        if (lib.hp_fused_fields_staged_points(), lib.hp_fused_fields_staged_groups()) != (
            FWD_STAGED_POINTS, FWD_STAGED_GROUPS
        ):
            raise RuntimeError("csrc/fused_fields.cu disagrees with FWD_STAGED_POINTS/FWD_STAGED_GROUPS")
        return built

    def prepare(self, spec: MLP, params, X: torch.Tensor, n_dirs: int, second: bool, plan: FwdPlan | None = None):
        """Check the arguments, plan the launch (`plan` forces one: for tests
        and sweeps) and allocate the output: (the C function's arguments and
        what they point into, out)."""
        check_kernel_args(spec, (), X, n_dirs, FWD_MAX_WIDTH)
        table = layer_pointers(spec, params, X.device)
        P = X.shape[0]
        plan = plan or fwd_plan(spec.layers, n_dirs, bool(second), P)
        dev = _device_index(X)
        if plan.smem_bytes > self.library.smem_limit(dev):
            raise ValueError(
                f"fused_fields kernel needs {plan.smem_bytes} B of shared memory for layers {spec.layers}; "
                f"the card allows {self.library.smem_limit(dev)} B per block"
            )
        out = torch.empty((P, 1 + n_dirs * (2 if second else 1)), dtype=torch.float32, device=X.device)
        widths = _widths_array(spec.layers)
        args = (
            X.data_ptr(), ctypes.addressof(table), widths.ctypes.data, spec.n_layers, P, n_dirs, int(second),
            _ACTIVATION_CODE[spec.activation], int(plan.staged), plan.block_points, plan.groups, plan.k_tile,
            plan.smem_bytes, out.data_ptr(), dev, torch.cuda.current_stream(X.device).cuda_stream,
        )
        return (args, table, widths), out

    def __call__(self, spec: MLP, params, X: torch.Tensor, n_dirs: int, second: bool, plan: FwdPlan | None = None) -> torch.Tensor:
        (args, *_keep), out = self.prepare(spec, params, X, n_dirs, second, plan)
        if X.shape[0]:
            self.launch(*args)
        return out


fused_fields_kernel = FusedFieldsKernel(_FWD_LIBRARY, "hp_fused_fields_f32")


def fields_flat_bwd_reference(spec: MLP, params, X: torch.Tensor, g: torch.Tensor, n_dirs: int, want_x: bool = True,
                              second: bool = True):
    """Plain PyTorch version of B2 and its block sum (counterpart of
    _pallas_fields_bwd's contract, and for second=False of the XLA VJP the
    JAX package takes there): (gparams, gX) of sum(g * fields) for fields =
    fields_flat_reference(..., second), by autograd; gX is None unless
    want_x."""
    with torch.enable_grad():
        Xd = X.detach().requires_grad_(want_x)
        flat = [t.detach().requires_grad_(True) for t in _flatten(params)]
        out = fields_flat_reference(spec, _unflatten(flat), Xd, n_dirs, second)
        grads = torch.autograd.grad(out, ([Xd] if want_x else []) + flat, g)
    return _unflatten(list(grads[len(grads) - len(flat):])), (grads[0] if want_x else None)


def block_sum_reference(partials: torch.Tensor) -> torch.Tensor:
    """Plain version of the block-sum kernel: the column sums of [n_rows, n]."""
    return partials.sum(dim=0)


def unpack_params(spec: MLP, packed: torch.Tensor):
    """Inverse of pack_params: views of `packed` shaped like the params."""
    out, off = [], 0
    for din, dout in zip(spec.layers[:-1], spec.layers[1:]):
        W = packed[off : off + din * dout].view(din, dout)
        off += din * dout
        out.append({"W": W, "b": packed[off : off + dout]})
        off += dout
    return out


# Must equal kBlockPoints / kPointStride in csrc/fused_fields_bwd.cu (the
# wrapper checks both after the build).
BWD_TILE_POINTS = 16
BWD_POINT_STRIDE = 20
BWD_BLOCKS = 512  # T grows only above this many blocks: four per SM of an H100
BWD_MAX_TILES = 8
BWD_FORMS = ("resident", "layered")
# The layered form (csrc/fused_fields_bwd_layered.cu) takes the points in
# chunks whose stash stays within LAYERED_SCRATCH_CAP bytes, each a power-of-two
# number of LAYERED_ROWS x BWD_TILE_POINTS-point groups (or all P points where
# that covers them); a chunk's slices are whole numbers of BWD_TILE_POINTS
# tiles, doubled until there are at most LAYERED_ROWS (one partial row each).
LAYERED_ROWS = 128
LAYERED_SCRATCH_CAP = 2**28
LAYERED_CHUNK_GROUP = LAYERED_ROWS * BWD_TILE_POINTS
# The firsts-only resident form (csrc/fused_fields_bwd_firsts.cu, a kernel of
# its own): groups of FIRSTS_GROUP_POINTS points (half as many where that
# leaves an SM of an H100 without a group, fewer still where a block's shared
# memory needs it, down to FIRSTS_MIN_POINTS), blocks of 32 x 1, 2 or 4
# threads (FIRSTS_MAX_WARPS), threads of FIRSTS_TILE_POINTS points by
# FIRSTS_TILE_NEURONS neurons a pass (kTP, kTN), and as many groups a block
# as keep the blocks within one wave and the partial rows within
# FIRSTS_PARTIAL_CAP floats.
FIRSTS_GROUP_POINTS = 16
FIRSTS_MIN_POINTS = 4
FIRSTS_MAX_WARPS = 4
FIRSTS_TILE_POINTS = 2
FIRSTS_TILE_NEURONS = 3
FIRSTS_PARTIAL_CAP = 2**21


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """B2's launch shape for a network, a mode (second derivatives or firsts
    only) and P points: the form (resident or layered), tiles_per_block
    tiles (groups) of group_points points per block (the layered form: per
    slice of a chunk), n_blocks blocks (slices of a chunk), each writing one
    partial row of row_pitch floats (n_params rounded up to a multiple of
    4), the shared memory one resident block needs (bwd_smem_bytes, whatever
    the form), the layered form's scratch in device memory (0 for the
    resident form) and its chunk_points (P for the resident form, which does
    not chunk).  group_points is BWD_TILE_POINTS but in the firsts-only
    resident form, whose blocks have 32 warps_per_block threads
    (warps_per_block is 0 for the other forms, whose blocks are fixed)."""

    tiles_per_block: int
    n_blocks: int
    row_pitch: int
    smem_bytes: int
    form: str
    scratch_bytes: int
    chunk_points: int
    group_points: int = BWD_TILE_POINTS
    warps_per_block: int = 0


def _row_pitch(layers) -> int:
    """The network's parameter count rounded up to a multiple of 4."""
    return -(-sum(a * b + b for a, b in zip(layers[:-1], layers[1:])) // 4) * 4


def bwd_streams(n_dirs: int, second: bool) -> int:
    """B2's streams (field columns, the width of its cotangent g): u, u_k and,
    with second derivatives, u_kk."""
    return 1 + n_dirs * (2 if second else 1)


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def _point_stride(group_points: int) -> int:
    """Floats between neurons in a stream buffer of the firsts-only resident
    form (csrc/fused_fields_bwd_firsts.cu's point_stride): group_points
    rounded up to four times an odd number (16-byte rows, eight consecutive
    rows on distinct banks)."""
    p = _round4(group_points)
    return p if (p // 4) % 2 else p + 4


def bwd_smem_bytes(layers, n_dirs: int, second: bool = True, group_points: int = FIRSTS_MIN_POINTS) -> int:
    """Shared memory of one resident B2 block.  With second derivatives
    (hp_fused_fields_bwd_smem_bytes): the packed network and the block's
    gradient sums (row_pitch floats each), the stash of every hidden layer
    and three stream buffers, each bwd_streams x max width x
    BWD_POINT_STRIDE floats.  Firsts only (hp_fused_fields_bwd_firsts_smem_bytes,
    by default at its smallest groups): the packed network (row_pitch
    floats) and (n_layers + 1) stream buffers (the hidden layers' stash and
    two), each bwd_streams x the widest input rounded up to 4 x
    _point_stride(group_points) floats."""
    n_layers = len(layers) - 1
    S = bwd_streams(n_dirs, second)
    if second:
        return 4 * (2 * _row_pitch(layers) + (n_layers + 2) * S * max(layers[:-1]) * BWD_POINT_STRIDE)
    return 4 * (_row_pitch(layers) + (n_layers + 1) * S * _round4(max(layers[:-1])) * _point_stride(group_points))


def bwd_layered_scratch_bytes(layers, n_dirs: int, points: int, second: bool = True) -> int:
    """Device memory of the layered form's scratch for chunks of `points`
    points (hp_fused_fields_bwd_layered_scratch_bytes): the stash of every
    hidden layer, bwd_streams x points x pitch floats each, pitch = the
    widest hidden layer rounded up to a multiple of 4 (gz takes the stash's
    place on the way down); 0 without a hidden layer."""
    hidden = layers[1:-1]
    return 4 * len(hidden) * bwd_streams(n_dirs, second) * points * (-(-max(hidden, default=0) // 4) * 4)


def layered_chunk_points(layers, n_dirs: int, P: int, second: bool = True) -> int:
    """Points per chunk of the layered form: the most LAYERED_CHUNK_GROUP-point
    groups, a power of two, whose stash stays within LAYERED_SCRATCH_CAP
    bytes (never fewer than one group: at 16 layers, n_dirs 3 and width 256
    one group's is 220 MB), and never more than P.  Where that covers P it is
    P, and the plan is that of one call over all points."""
    chunk = LAYERED_CHUNK_GROUP
    while chunk < P and bwd_layered_scratch_bytes(layers, n_dirs, 2 * chunk, second) <= LAYERED_SCRATCH_CAP:
        chunk *= 2
    return min(chunk, P)


def layered_slice_tiles(P: int) -> int:
    """Tiles of BWD_TILE_POINTS points per slice of the layered form's chunk
    of P points: the fewest (a power of two) that give at most LAYERED_ROWS
    slices."""
    n_tiles, T = -(-P // BWD_TILE_POINTS), 1
    while -(-n_tiles // T) > LAYERED_ROWS:
        T *= 2
    return T


def bwd_resident_fits(layers, n_dirs: int, second: bool = True) -> bool:
    """Whether the resident form takes the network: no layer wider than
    BWD_RESIDENT_WIDTH and one block's shared memory (firsts only: at its
    smallest groups) within an H100's per-block opt-in.  Firsts only it
    takes every network the second-derivative kernel compiled without the
    second-order streams took (that block held the network twice and
    16-point buffers of width max(layers) a layer, one more than this)."""
    return max(layers) <= BWD_RESIDENT_WIDTH and bwd_smem_bytes(layers, n_dirs, second) <= SMEM_PER_BLOCK


def firsts_launch(layers, n_dirs: int, P: int, groups_per_block: int | None = None) -> tuple:
    """The firsts-only resident form's launch shape, from the shapes alone:
    (group_points, warps_per_block, groups_per_block).  Groups of
    FIRSTS_GROUP_POINTS points, or half as many where fewer groups than an
    H100 has SMs would leave SMs empty, halved again while a block's shared
    memory exceeds the per-block opt-in; the fewest warps (a power of two up
    to FIRSTS_MAX_WARPS) whose threads cover the widest hidden layer at
    FIRSTS_TILE_POINTS points by FIRSTS_TILE_NEURONS neurons a thread in two
    passes, or FIRSTS_MAX_WARPS where fewer blocks than twice the SMs leave
    the card room; one group a block, doubled while the blocks exceed one
    wave (the blocks an SM's shared memory holds, on every SM) or the
    partial rows exceed FIRSTS_PARTIAL_CAP floats (`groups_per_block`
    forces it)."""
    pb = FIRSTS_GROUP_POINTS
    if -(-P // pb) < FWD_SMS:
        pb //= 2
    while pb > FIRSTS_MIN_POINTS and bwd_smem_bytes(layers, n_dirs, False, pb) > SMEM_PER_BLOCK:
        pb //= 2
    groups, T = -(-P // pb), groups_per_block or 1
    per_sm = SMEM_PER_SM // (bwd_smem_bytes(layers, n_dirs, False, pb) + SMEM_RESERVED_PER_BLOCK)
    while not groups_per_block and (-(-groups // T) > FWD_SMS * per_sm
                                    or -(-groups // T) * _row_pitch(layers) > FIRSTS_PARTIAL_CAP):
        T *= 2
    lanes = pb // FIRSTS_TILE_POINTS * -(-max(layers[1:-1], default=1) // (2 * FIRSTS_TILE_NEURONS))
    warps = 1
    while warps < FIRSTS_MAX_WARPS and (32 * warps < lanes or -(-groups // T) < 2 * FWD_SMS):
        warps *= 2
    return pb, warps, T


def bwd_plan(layers, n_dirs: int, P: int, tiles_per_block: int | None = None, form: str | None = None,
             chunk_points: int | None = None, second: bool = True) -> BwdPlan:
    """B2's plan, from the shapes and the mode alone (so the summation order,
    and the gradient, do not depend on the card).  The resident form where
    bwd_resident_fits, else the layered form, which takes every network B1
    takes (`form` forces one: for tests and chip_smoke.py; forcing the
    resident form on a network it does not take raises).  `second`: the
    mode, second derivatives or firsts only (the g of bwd_streams columns);
    firsts only needs less shared memory and scratch a point, so the
    resident form takes more networks and a layered chunk more points.

    The layered form replaced a third, wide form (one kernel over tiles of
    16 points) wherever it ran: in turns within one call on an NVIDIA H100
    80GB HBM3 at 700.00 W (chip_smoke.py phase 15) it was faster at every
    shape, µs layered / wide: 589.9 / 1,139.0 at (2,128,128,128,1) and
    1,932.8 / 4,101.9 at (2,256,256,256,1), P 16,384, n_dirs 2; 23.1 / 58.8
    at (2,256,1) and 54.3 / 78.5 at (1,200,40,1), P 1,000; 223.0 / 257.6 at
    (3,56,56,56,1) and 229.3 / 284.4 at (3,64,64,64,1), P 8,000, n_dirs 3;
    PERF.md §6 has the shapes above three inputs.  Where the resident form
    fits it stays: forced there the layered form took 235.2 µs at
    (2,20,20,20,1) against the resident form's 53.4.

    T = tiles_per_block, by default as many tiles per block as keep at least
    BWD_BLOCKS blocks (at most BWD_MAX_TILES), a function of P alone, for
    the resident form with second derivatives; firsts only, the resident
    form is its own kernel, with groups of points and blocks of warps from
    firsts_launch (T its groups a block).  The layered form's chunk (`chunk_points` forces it:
    for tests and chip_smoke.py) is layered_chunk_points, and its slices are
    layered_slice_tiles(chunk) tiles, at most LAYERED_ROWS a chunk; its
    scratch is one chunk's stash."""
    fits = bwd_resident_fits(layers, n_dirs, second)
    form = form or ("resident" if fits else "layered")
    if form not in BWD_FORMS:
        raise ValueError(f"B2's form is one of {BWD_FORMS}; got {form!r}")
    if form == "resident" and not fits:
        raise ValueError(
            f"B2's resident form takes widths <= {BWD_RESIDENT_WIDTH} and <= {SMEM_PER_BLOCK} B of shared memory; "
            f"layers {tuple(layers)} at n_dirs {n_dirs} (second={second}) need "
            f"{bwd_smem_bytes(layers, n_dirs, second)} B"
        )
    if chunk_points is not None and (chunk_points < 1 or form == "resident"):
        raise ValueError(f"chunk_points is the layered form's, at least 1; got {chunk_points} for the {form} form")
    if form == "layered":
        chunk = min(chunk_points, P) if chunk_points else layered_chunk_points(layers, n_dirs, P, second)
        T = tiles_per_block or layered_slice_tiles(chunk)
        scratch = bwd_layered_scratch_bytes(layers, n_dirs, chunk, second)
    elif not second:
        pb, warps, T = firsts_launch(layers, n_dirs, P, tiles_per_block)
        return BwdPlan(T, -(-(-(-P // pb)) // T), _row_pitch(layers), bwd_smem_bytes(layers, n_dirs, False, pb), form,
                       0, P, pb, warps)
    else:
        chunk, scratch = P, 0
        T = tiles_per_block or max(1, min(BWD_MAX_TILES, -(-P // BWD_TILE_POINTS) // BWD_BLOCKS))
    n_blocks = -(-(-(-chunk // BWD_TILE_POINTS)) // T)
    return BwdPlan(T, n_blocks, _row_pitch(layers), bwd_smem_bytes(layers, n_dirs, second), form, scratch, chunk)


# The position of `second` among the arguments of B2's C functions (both forms, both modes).
_BWD_SECOND_ARG = 7


class FusedFieldsBwdKernel(KernelWrapper):
    """One form of B2 (`form`), built at first use, in either mode: second
    derivatives (g [P, 1 + 2 n_dirs]) or firsts only (g [P, 1 + n_dirs]).
    Resident: the CUDA kernels csrc/fused_fields_bwd.cu::fused_fields_bwd_kernel
    (second derivatives, C function `fn`) and
    csrc/fused_fields_bwd_firsts.cu::fused_fields_bwd_firsts_kernel (firsts
    only, `firsts_fn`); layered: the launches of
    csrc/fused_fields_bwd_layered.cu over every chunk of points (one C call
    in either mode, one count).  A call returns the per-block (per-slice)
    partial sums [n_blocks, row_pitch] of the weight gradients (packed as
    pack_params packs the weights, then zero pad columns; bwd_plan gives the
    shape) and gX (or None).  The resident form raises for a network it
    cannot hold; the layered form takes every network B1 takes
    (chip_smoke.py forces it at resident widths).  `launches` counts every
    host launch, `firsts_launches` those of the firsts-only mode among them:
    under a CUDA graph, the warm-up's and the capture's, not the replays."""

    def __init__(self, library: CudaLibrary, fn: str, form: str, firsts_fn: str | None = None):
        super().__init__(library, fn)
        self.form = form
        self.firsts_fn = firsts_fn or fn
        self.firsts_launches = 0

    def launch(self, *args) -> None:
        """Launch the C function of the mode that args[_BWD_SECOND_ARG] names
        (prepare's args: both modes' functions take `second` there)."""
        second = args[_BWD_SECOND_ARG]
        self._launch(self.fn if second else self.firsts_fn, args)
        if not second:
            self.firsts_launches += 1

    def load(self) -> BuiltLibrary:
        built = self.library.load()
        lib = built.lib
        if (lib.hp_fused_fields_bwd_block_points(), lib.hp_fused_fields_bwd_point_stride(),
                lib.hp_fused_fields_bwd_resident_max_width()) != (BWD_TILE_POINTS, BWD_POINT_STRIDE, BWD_RESIDENT_WIDTH):
            raise RuntimeError(
                "csrc/fused_fields_bwd.cu disagrees with BWD_TILE_POINTS/BWD_POINT_STRIDE/BWD_RESIDENT_WIDTH")
        return built

    def prepare(self, spec: MLP, params, X: torch.Tensor, g: torch.Tensor, n_dirs: int, want_x: bool = True,
                tiles_per_block: int | None = None, chunk_points: int | None = None, second: bool = True):
        """Check the arguments (g's width against the mode first) and
        allocate the outputs (and the layered form's scratch, one chunk's
        stash) of one launch: (the C function's arguments and the buffers
        they point into, partials, gX or None).  `tiles_per_block` and
        `chunk_points` force bwd_plan's."""
        P = X.shape[0]
        n_fields = bwd_streams(n_dirs, second)
        if g.device != X.device or g.dtype != torch.float32 or tuple(g.shape) != (P, n_fields) or not g.is_contiguous():
            raise ValueError(
                f"g must be contiguous float32 [{P}, {n_fields}] (second={second}) on {X.device}; "
                f"got {g.dtype} {tuple(g.shape)} on {g.device}"
            )
        check_kernel_args(spec, params, X, n_dirs, FWD_MAX_WIDTH)
        plan = bwd_plan(spec.layers, n_dirs, P, tiles_per_block, self.form, chunk_points, second)
        packed, widths = pack_params(spec, params)
        dev = _device_index(X)
        self.load()
        scratch = None
        if self.form == "resident" and second:
            self.library.check_smem(
                dev, (packed.numel(), max(spec.layers[:-1]), spec.n_layers, n_dirs, int(second)),
                f"layers {spec.layers} and n_dirs {n_dirs} (second={second}) in the resident form")
        elif self.form == "resident" and plan.smem_bytes > self.library.smem_limit(dev):
            raise ValueError(
                f"fused_fields_bwd_firsts kernel needs {plan.smem_bytes} B of shared memory for layers {spec.layers} "
                f"and n_dirs {n_dirs}; the card allows {self.library.smem_limit(dev)} B per block")
        elif self.form == "layered":
            scratch = torch.empty((plan.scratch_bytes // 4,), dtype=torch.float32, device=X.device)
        partials = torch.empty((plan.n_blocks, plan.row_pitch), dtype=torch.float32, device=X.device)
        gX = torch.empty_like(X) if want_x else None
        launch_shape = (plan.tiles_per_block,)
        if self.form == "resident" and not second:
            launch_shape = (plan.group_points, plan.warps_per_block, plan.tiles_per_block)
        head = (X.data_ptr(), g.data_ptr(), packed.data_ptr(), widths.ctypes.data, spec.n_layers, P,
                n_dirs, int(second), _ACTIVATION_CODE[spec.activation], *launch_shape)
        tail = (partials.data_ptr(), gX.data_ptr() if want_x else None, dev,
                torch.cuda.current_stream(X.device).cuda_stream)
        args = head + ((plan.chunk_points, scratch.data_ptr()) if scratch is not None else ()) + tail
        return (args, packed, widths, scratch), partials, gX

    def __call__(self, spec: MLP, params, X: torch.Tensor, g: torch.Tensor, n_dirs: int, want_x: bool = True,
                 tiles_per_block: int | None = None, chunk_points: int | None = None, second: bool = True):
        (args, *_keep), partials, gX = self.prepare(spec, params, X, g, n_dirs, want_x, tiles_per_block, chunk_points,
                                                    second)
        if X.shape[0]:
            self.launch(*args)
        return partials, gX


fused_fields_bwd_kernel = FusedFieldsBwdKernel(_BWD_LIBRARY, "hp_fused_fields_bwd_f32", "resident",
                                               "hp_fused_fields_bwd_firsts_f32")
fused_fields_bwd_layered_kernel = FusedFieldsBwdKernel(_BWD_LIBRARY, "hp_fused_fields_bwd_layered_f32", "layered")
_BWD_KERNELS = {k.form: k for k in (fused_fields_bwd_kernel, fused_fields_bwd_layered_kernel)}


# Must equal kSumThreads / kMaxSumTiles in csrc/fused_fields_bwd.cu.
SUM_THREADS = 256
SUM_MAX_TILES = 4096
SUM_ONE_PASS_ROWS = 256  # up to this many rows: one pass, up to 32 row groups of 8 rows
SUM_SLAB_ROWS = 64  # above it: slabs of 64 rows, 16 row groups of 4 rows


def block_sum_plan(n_rows: int, n: int):
    """(lanes, rows_per_slab, slabs) of the block-sum kernel for partials
    [n_rows, n]; a block has `lanes` lanes of four columns by 256 / lanes
    row groups.  Up to SUM_ONE_PASS_ROWS rows one slab, one pass and no
    ticket, with a row group per row up to 32 groups; above it slabs of
    SUM_SLAB_ROWS rows and 16 groups (each slab adds a ticket and a second
    pass over the slab sums).  Chosen from a sweep of (lanes, slabs) on an
    H100 at the partial shapes of chip_smoke.py phase 7.  It depends on the
    shape alone, so the summation order, and the result, do not depend on
    the card (or on the rows' alignment, which only picks the loads)."""
    if n_rows <= SUM_ONE_PASS_ROWS:
        groups = min(32, 1 << max(0, n_rows - 1).bit_length())
        rows_per_slab = max(1, n_rows)
    else:
        groups, rows_per_slab = 16, SUM_SLAB_ROWS
    lanes = SUM_THREADS // groups
    if -(-n // (4 * lanes)) > SUM_MAX_TILES:  # too many column tiles to take a ticket each
        rows_per_slab = n_rows
    return lanes, rows_per_slab, max(1, -(-n_rows // rows_per_slab))


class BlockSumKernel(KernelWrapper):
    """csrc/fused_fields_bwd.cu::block_sum_kernel, the fixed-order column sum
    of B2's partials; shares B2's library."""

    def prepare(self, partials: torch.Tensor):
        """Check `partials` and allocate the output and scratch of one launch:
        (the C function's arguments and the tensors they point into, out).
        With more than one slab the scratch holds the slab sums and the
        launch's own tickets, one int32 word per column tile, zeroed here (a
        memset on the stream, captured with the launch in a CUDA graph)."""
        if not partials.is_cuda or partials.dtype != torch.float32 or partials.dim() != 2 or not partials.is_contiguous():
            raise ValueError(
                f"block_sum kernel takes a contiguous float32 [rows, n] CUDA tensor; got "
                f"{partials.dtype} {tuple(partials.shape)} on {partials.device}"
            )
        n_rows, n = partials.shape
        out = torch.empty((n,), dtype=torch.float32, device=partials.device)
        lanes, rows_per_slab, slabs = block_sum_plan(n_rows, n)
        aligned = n % 4 == 0 and partials.data_ptr() % 16 == 0
        scratch = tickets = None
        if slabs > 1:
            scratch = torch.empty((slabs, -(-n // 4) * 4), dtype=torch.float32, device=partials.device)
            tickets = torch.zeros((-(-n // (4 * lanes)),), dtype=torch.int32, device=partials.device)
        args = (
            partials.data_ptr(), n_rows, n, int(aligned), lanes, rows_per_slab,
            None if scratch is None else scratch.data_ptr(), None if tickets is None else tickets.data_ptr(),
            out.data_ptr(), _device_index(partials), torch.cuda.current_stream(partials.device).cuda_stream,
        )
        return (args, (scratch, tickets)), out

    def __call__(self, partials: torch.Tensor) -> torch.Tensor:
        (args, _scratch), out = self.prepare(partials)
        if out.numel() == 0:
            return out
        if partials.shape[0] == 0:
            return out.zero_()
        self.launch(*args)
        return out


block_sum_kernel = BlockSumKernel(_BWD_LIBRARY, "hp_block_sum_f32")


def launch_counts() -> dict:
    """The host launches so far of B1 (either form), B2 (every form, either
    mode) and the block sum: the difference over a capture is the count of
    each one's nodes in the graph."""
    return {"B1": fused_fields_kernel.launches, "B2": sum(k.launches for k in _BWD_KERNELS.values()),
            "block_sum": block_sum_kernel.launches}


def fused_fields_bwd(spec: MLP, params, X: torch.Tensor, g: torch.Tensor, n_dirs: int, want_x: bool = True,
                     second: bool = True):
    """(gparams, gX) of sum(g * fields_flat(..., second)): on a CUDA tensor
    B2 in the mode `second` and the form bwd_plan gives, then the block sum;
    on a CPU tensor the plain version."""
    if not X.is_cuda:
        return fields_flat_bwd_reference(spec, params, X, g, n_dirs, want_x, second)
    kernel = _BWD_KERNELS[bwd_plan(spec.layers, n_dirs, X.shape[0], second=second).form]
    partials, gX = kernel(spec, params, X, g, n_dirs, want_x, second=second)
    return unpack_params(spec, block_sum_kernel(partials)), gX  # the pad columns are left out


def _fields_flat_vjp(spec: MLP, n_dirs: int, second: bool, want_x: bool, g: torch.Tensor, X: torch.Tensor, flat):
    """The VJP of fields_flat at X for one cotangent g [P, F]: (gX, *gflat)
    with want_x, else (*gflat).  In either mode B2 and its block sum on a
    CUDA tensor (firsts only, the kernels compiled without the second-order
    streams: what the JAX package leaves to XLA's VJP of its Taylor path,
    pallas_fields.py:190-196), their plain version on a CPU tensor."""
    gparams, gX = fused_fields_bwd(spec, _unflatten(flat), X, g.contiguous(), n_dirs, want_x, second)
    return ((gX,) if want_x else ()) + tuple(_flatten(gparams))


def _member(t: torch.Tensor, dim, i: int) -> torch.Tensor:
    """Member i of a tensor batched along `dim` (None: not batched, the same
    tensor for every member).  A contiguous stack gives a contiguous view
    whose data_ptr is the member's own slice of the stack."""
    return t if dim is None else t.select(dim, i).contiguous()


def _members(info, in_dims, args):
    """[args of member i for i in range(batch_size)], each batched tensor
    replaced by its member's slice."""
    return [[_member(a, d, i) for a, d in zip(args, in_dims)] for i in range(info.batch_size)]


class _FieldsFlatVjp(torch.autograd.Function):
    """The VJP of fields_flat as a function of its cotangent, so that
    torch.func.vmap can batch it.  The vmap rule runs the VJP (B2 and its
    block sum, in the mode of the fields) once for each member of the
    batch: over the cotangent alone on one primal (the Gauss-Newton dual
    Jacobian), or over the parameters with the cotangent (and X where
    batched) alongside (a seed ensemble: `grad` inside `vmap`).  The JAX
    package batches B2's grid instead (and XLA the firsts-only VJP); one
    launch for the whole batch is ROADMAP B' 5 (cotangents) and B' 6
    (members).  Not differentiable again, as the JAX kernel's VJP is not."""

    @staticmethod
    def forward(spec, n_dirs, second, want_x, g, X, *flat):
        return _fields_flat_vjp(spec, n_dirs, second, want_x, g, X, flat)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("fields_flat has no second-order derivative (the kernels' VJP is not differentiable)")

    @staticmethod
    def vmap(info, in_dims, spec, n_dirs, second, want_x, g, X, *flat):
        per = [_fields_flat_vjp(spec, n_dirs, second, want_x, gi, Xi, fi)
               for gi, Xi, *fi in _members(info, in_dims[4:], (g, X, *flat))]
        out = tuple(torch.stack(parts) for parts in zip(*per))
        return out, (0,) * len(out)


def _fields_flat_forward(spec: MLP, n_dirs: int, second: bool, X: torch.Tensor, flat) -> torch.Tensor:
    params = _unflatten(flat)
    if X.is_cuda:
        return fused_fields_kernel(spec, params, X, n_dirs, second)
    return fields_flat_reference(spec, params, X, n_dirs, second)


class _FieldsFlat(torch.autograd.Function):
    """fields_flat with B1 as its forward and _FieldsFlatVjp as its VJP.  Its
    vmap rule runs the forward once for each member of a batch of networks
    (and of X where batched): B1 on a CUDA tensor, each launch reading its
    member's slices of the stacked parameters, the plain version on a CPU
    one.  It has no forward-mode rule, as the JAX package's custom_vjp has
    none: a JVP through it (torch.func.jvp, the forward-mode Jacobian,
    Gauss-Newton's matrix-free solves) raises."""

    @staticmethod
    def forward(spec, n_dirs, second, X, *flat):
        return _fields_flat_forward(spec, n_dirs, second, X, flat)

    @staticmethod
    def setup_context(ctx, inputs, output):
        spec, n_dirs, second, X, *flat = inputs
        ctx.spec, ctx.n_dirs, ctx.second = spec, n_dirs, second
        ctx.save_for_backward(X, *flat)

    @staticmethod
    def backward(ctx, g):
        X, *flat = ctx.saved_tensors
        want_x = ctx.needs_input_grad[3]
        grads = _FieldsFlatVjp.apply(ctx.spec, ctx.n_dirs, ctx.second, want_x, g, X, *flat)
        gX = grads[0] if want_x else None
        return (None, None, None, gX, *grads[int(want_x):])

    @staticmethod
    def jvp(ctx, *tangents):
        raise TypeError(FORWARD_MODE_ERROR)

    @staticmethod
    def vmap(info, in_dims, spec, n_dirs, second, X, *flat):
        out = [_fields_flat_forward(spec, n_dirs, second, Xi, fi) for Xi, *fi in _members(info, in_dims[3:], (X, *flat))]
        return torch.stack(out), 0


def fields_flat(spec: MLP, params, X: torch.Tensor, n_dirs: int, second: bool) -> torch.Tensor:
    """Differentiable fused fields at X [P, d]: [P, F] (u, u_1..u_n[, u_11..u_nn]).
    A network no kernel takes raises on the CPU too, as in the JAX package."""
    check_kernel_network(spec)
    return _FieldsFlat.apply(spec, n_dirs, second, X, *_flatten(params))


def fused_fields_1d(spec: MLP, params, x):
    """(u, u_x, u_xx) at x [..., Q]: fused-kernel twin of taylor_fields_1d
    (the pallas_fields_1d contract)."""
    shape = x.shape
    out = fields_flat(spec, params, x.reshape(-1, 1), 1, True)
    return out[:, 0].reshape(shape), out[:, 1].reshape(shape), out[:, 2].reshape(shape)


def fused_fields_2d(
    spec: MLP, params, x, y, *,
    second_y: bool = True, first_y_only: bool = False, firsts_only: bool = False,
):
    """Fused-kernel twin of taylor_fields_2d (the pallas_fields_2d contract).

    Seconds are computed per direction all-or-nothing, so first_y_only also
    computes uyy and drops it; firsts_only=True runs the kernel with the
    second-order streams off ({u, ux, uy}, the var_form-1 mode)."""
    shape = x.shape
    X = torch.stack([x.reshape(-1), y.reshape(-1)], dim=-1)
    if firsts_only:
        out = fields_flat(spec, params, X, 2, False)
        return {"u": out[:, 0].reshape(shape), "ux": out[:, 1].reshape(shape), "uy": out[:, 2].reshape(shape)}
    out = fields_flat(spec, params, X, 2, True)
    flds = {k: out[:, c].reshape(shape) for c, k in enumerate(("u", "ux", "uy", "uxx"))}
    if not first_y_only:
        flds["uyy"] = out[:, 4].reshape(shape)
    return flds


def fused_fields_3d(spec: MLP, params, x, y, z, *, second: bool = True):
    """Fused-kernel twin of taylor_fields_3d (the pallas_fields_3d contract):
    n_dirs 3, the columns u, ux, uy, uz[, uxx, uyy, uzz] with x the first
    input."""
    shape = x.shape
    X = torch.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], dim=-1)
    out = fields_flat(spec, params, X, 3, second)
    names = ("u", "ux", "uy", "uz") + (("uxx", "uyy", "uzz") if second else ())
    return {k: out[:, c].reshape(shape) for c, k in enumerate(names)}
