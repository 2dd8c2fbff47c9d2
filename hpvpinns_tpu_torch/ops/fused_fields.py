"""Fused MLP + derivative-field kernel (B1), its backward kernel (B2), and
the gradient that joins them.

Counterpart of hpvpinns_tpu/ops/pallas_fields.py.  `fields_flat` returns
[P, F] with F = 1 + n_dirs * (2 if second else 1) columns (u, firsts...,
seconds...).  Its forward is the hand-written CUDA kernel
csrc/fused_fields.cu on a CUDA tensor, and the plain PyTorch version
`fields_flat_reference` on a CPU tensor; on a CUDA tensor the kernel
launches or the call raises, it never falls back.  The kernels take float32,
sin/tanh, a scalar output, n_dirs 1-3, layer widths up to MAX_WIDTH = 64 and
up to MAX_LAYERS = 16 layers, and raise above them.

The gradient: for second=False it is autograd through the plain Taylor
propagation (ops/taylor.py::mlp_fields), which is what the JAX package does
(pallas_fields.py:194-196; its TPU kernel has no backward for that layout).
For second=True it is B2, csrc/fused_fields_bwd.cu (the JAX package's
_fields_bwd_kernel): per-block partial sums of the weight gradients, added
in a fixed order by a second kernel of the same file (block_sum), so the
gradient is bit-identical from run to run.  On a CPU tensor its plain
version `fields_flat_bwd_reference` (autograd through the plain forward)
runs instead.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from hpvpinns_tpu_torch.models.mlp import MLP
from hpvpinns_tpu_torch.ops.cuda_build import CSRC_DIR, BuiltLibrary, build_library
from hpvpinns_tpu_torch.ops.taylor import mlp_fields

# Must equal kMaxWidth / kMaxLayers in csrc/fused_fields.cu (the kernel
# rejects wider or deeper networks too).
MAX_WIDTH = 64
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


def check_kernel_args(spec: MLP, params, X: torch.Tensor, n_dirs: int) -> None:
    """Raise on anything the kernel does not take: widths above MAX_WIDTH,
    more than MAX_LAYERS layers, a non-scalar output, activations other than
    sin/tanh, or X / params that are not contiguous float32 on one CUDA
    device."""
    if spec.activation not in _ACTIVATION_CODE:
        raise ValueError(f"fused_fields kernel supports sin/tanh; got {spec.activation!r}")
    if spec.layers[-1] != 1:
        raise ValueError(f"fused_fields kernel needs a scalar output; got layers {spec.layers}")
    if max(spec.layers) > MAX_WIDTH or spec.n_layers > MAX_LAYERS:
        raise ValueError(
            f"fused_fields kernel supports widths <= {MAX_WIDTH} and <= {MAX_LAYERS} "
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
    argument types (each returns an int: a launch returns a CUDA error
    code); every library also
    exports hp_<name>_smem_bytes/_smem_limit/_max_width/_max_layers, and its
    limits must equal MAX_WIDTH / MAX_LAYERS."""

    def __init__(self, name: str, signatures: dict):
        self.name, self._signatures = name, signatures
        self.built: BuiltLibrary | None = None
        self._smem_limit = {}

    def load(self) -> BuiltLibrary:
        if self.built is None:
            built = build_library(self.name, [CSRC_DIR / f"{self.name}.cu"])
            lib, i32, pre = built.lib, ctypes.c_int, f"hp_{self.name}"
            signatures = {
                **{fn: (args, i32) for fn, args in self._signatures.items()},
                f"{pre}_smem_bytes": ([i32] * 4, ctypes.c_longlong),
                f"{pre}_smem_limit": ([i32], i32),
                f"{pre}_max_width": ([], i32),
                f"{pre}_max_layers": ([], i32),
            }
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
            if (getattr(lib, f"{pre}_max_width")(), getattr(lib, f"{pre}_max_layers")()) != (MAX_WIDTH, MAX_LAYERS):
                raise RuntimeError(f"csrc/{self.name}.cu limits disagree with MAX_WIDTH/MAX_LAYERS")
            self.built = built
        return self.built

    def check_smem(self, dev: int, smem_args, what: str) -> None:
        """Raise unless the kernel's shared memory for `smem_args` fits the
        card's per-block limit."""
        lib = self.load().lib
        smem = getattr(lib, f"hp_{self.name}_smem_bytes")(*smem_args)
        if dev not in self._smem_limit:
            self._smem_limit[dev] = getattr(lib, f"hp_{self.name}_smem_limit")(dev)
        if smem > self._smem_limit[dev]:
            raise ValueError(
                f"{self.name} kernel needs {smem} B of shared memory for {what}; "
                f"the card allows {self._smem_limit[dev]} B per block"
            )


class KernelWrapper:
    """A kernel's wrapper around the launch function `fn` of `library`:
    `launch` raises on a CUDA error, and `launches` counts the launches."""

    def __init__(self, library: CudaLibrary, fn: str):
        self.library, self.fn = library, fn
        self.launches = 0

    def load(self) -> BuiltLibrary:
        return self.library.load()

    def launch(self, *args) -> None:
        err = getattr(self.load().lib, self.fn)(*args)
        if err != 0:
            raise RuntimeError(f"{self.fn} launch failed: CUDA error {err}")
        self.launches += 1


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


_VP, _I32 = ctypes.c_void_p, ctypes.c_int
_FWD_LIBRARY = CudaLibrary(
    "fused_fields", {"hp_fused_fields_f32": [_VP, _VP, _VP, _I32, _I32, _I32, _I32, _I32, _VP, _I32, _VP]}
)
_BWD_LIBRARY = CudaLibrary("fused_fields_bwd", {
    "hp_fused_fields_bwd_f32": [_VP, _VP, _VP, _VP, _I32, _I32, _I32, _I32, _VP, _VP, _I32, _VP],
    "hp_block_sum_f32": [_VP, _I32, _I32, _VP, _I32, _VP],
    "hp_fused_fields_bwd_block_points": [],
})


class FusedFieldsKernel(KernelWrapper):
    """B1, the CUDA kernel csrc/fused_fields.cu, built at first use."""

    def __call__(self, spec: MLP, params, X: torch.Tensor, n_dirs: int, second: bool) -> torch.Tensor:
        check_kernel_args(spec, params, X, n_dirs)
        packed, widths = pack_params(spec, params)
        dev = _device_index(X)
        self.library.check_smem(
            dev, (packed.numel(), max(spec.layers[:-1]), n_dirs, int(second)), f"layers {spec.layers}"
        )
        P = X.shape[0]
        out = torch.empty((P, 1 + n_dirs * (2 if second else 1)), dtype=torch.float32, device=X.device)
        if P == 0:
            return out
        self.launch(
            X.data_ptr(), packed.data_ptr(), widths.ctypes.data, spec.n_layers, P, n_dirs,
            int(second), _ACTIVATION_CODE[spec.activation], out.data_ptr(), dev,
            torch.cuda.current_stream(X.device).cuda_stream,
        )
        return out


fused_fields_kernel = FusedFieldsKernel(_FWD_LIBRARY, "hp_fused_fields_f32")


def fields_flat_bwd_reference(spec: MLP, params, X: torch.Tensor, g: torch.Tensor, n_dirs: int, want_x: bool = True):
    """Plain PyTorch version of B2 and its block sum (counterpart of
    _pallas_fields_bwd's contract): (gparams, gX) of sum(g * fields) for
    fields = fields_flat_reference(..., second=True), by autograd; gX is None
    unless want_x."""
    with torch.enable_grad():
        Xd = X.detach().requires_grad_(want_x)
        flat = [t.detach().requires_grad_(True) for t in _flatten(params)]
        out = fields_flat_reference(spec, _unflatten(flat), Xd, n_dirs, True)
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


class FusedFieldsBwdKernel(KernelWrapper):
    """B2, the CUDA kernel csrc/fused_fields_bwd.cu::fused_fields_bwd_kernel,
    built at first use.  A call returns the per-block partial sums
    [n_blocks, n_params] of the weight gradients (packed as pack_params packs
    the weights) and gX (or None)."""

    def __call__(self, spec: MLP, params, X: torch.Tensor, g: torch.Tensor, n_dirs: int, want_x: bool = True):
        check_kernel_args(spec, params, X, n_dirs)
        P = X.shape[0]
        n_fields = 1 + 2 * n_dirs
        if g.device != X.device or g.dtype != torch.float32 or tuple(g.shape) != (P, n_fields) or not g.is_contiguous():
            raise ValueError(
                f"g must be contiguous float32 [{P}, {n_fields}] on {X.device}; "
                f"got {g.dtype} {tuple(g.shape)} on {g.device}"
            )
        packed, widths = pack_params(spec, params)
        n_params = packed.numel()
        dev = _device_index(X)
        self.library.check_smem(
            dev, (n_params, max(spec.layers[:-1]), spec.n_layers, n_dirs), f"layers {spec.layers} and n_dirs {n_dirs}"
        )
        block = self.load().lib.hp_fused_fields_bwd_block_points()
        partials = torch.empty(((P + block - 1) // block, n_params), dtype=torch.float32, device=X.device)
        gX = torch.empty_like(X) if want_x else None
        if P == 0:
            return partials, gX
        self.launch(
            X.data_ptr(), g.data_ptr(), packed.data_ptr(), widths.ctypes.data, spec.n_layers, P,
            n_dirs, _ACTIVATION_CODE[spec.activation], partials.data_ptr(),
            gX.data_ptr() if want_x else None, dev, torch.cuda.current_stream(X.device).cuda_stream,
        )
        return partials, gX


fused_fields_bwd_kernel = FusedFieldsBwdKernel(_BWD_LIBRARY, "hp_fused_fields_bwd_f32")


class BlockSumKernel(KernelWrapper):
    """csrc/fused_fields_bwd.cu::block_sum_kernel, the fixed-order column sum
    of B2's partials; shares B2's library."""

    def __call__(self, partials: torch.Tensor) -> torch.Tensor:
        if not partials.is_cuda or partials.dtype != torch.float32 or partials.dim() != 2 or not partials.is_contiguous():
            raise ValueError(
                f"block_sum kernel takes a contiguous float32 [rows, n] CUDA tensor; got "
                f"{partials.dtype} {tuple(partials.shape)} on {partials.device}"
            )
        n_rows, n = partials.shape
        out = torch.zeros((n,), dtype=torch.float32, device=partials.device)
        if n_rows == 0 or n == 0:
            return out
        self.launch(
            partials.data_ptr(), n_rows, n, out.data_ptr(), _device_index(partials),
            torch.cuda.current_stream(partials.device).cuda_stream,
        )
        return out


block_sum_kernel = BlockSumKernel(_BWD_LIBRARY, "hp_block_sum_f32")


def fused_fields_bwd(spec: MLP, params, X: torch.Tensor, g: torch.Tensor, n_dirs: int, want_x: bool = True):
    """(gparams, gX) of sum(g * fields_flat(..., second=True)) on the card:
    B2, then the block sum."""
    partials, gX = fused_fields_bwd_kernel(spec, params, X, g, n_dirs, want_x)
    return unpack_params(spec, block_sum_kernel(partials)), gX


class _FieldsFlat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, n_dirs, second, X, *flat):
        params = _unflatten(flat)
        if X.is_cuda:
            out = fused_fields_kernel(spec, params, X, n_dirs, second)
        else:
            out = fields_flat_reference(spec, params, X, n_dirs, second)
        ctx.spec, ctx.n_dirs, ctx.second = spec, n_dirs, second
        ctx.save_for_backward(X, *flat)
        return out

    @staticmethod
    def backward(ctx, g):
        X, *flat = ctx.saved_tensors
        want_x = ctx.needs_input_grad[3]
        if ctx.second:
            bwd = fused_fields_bwd if X.is_cuda else fields_flat_bwd_reference
            gparams, gX = bwd(ctx.spec, _unflatten(flat), X, g.contiguous(), ctx.n_dirs, want_x)
            return (None, None, None, gX, *_flatten(gparams))
        with torch.enable_grad():
            Xd = X.detach().requires_grad_(want_x)
            fd = [t.detach().requires_grad_(True) for t in flat]
            out = fields_flat_reference(ctx.spec, _unflatten(fd), Xd, ctx.n_dirs, False)
            grads = torch.autograd.grad(out, ([Xd] if want_x else []) + fd, g)
        gX = grads[0] if want_x else None
        return (None, None, None, gX, *grads[len(grads) - len(fd):])


def fields_flat(spec: MLP, params, X: torch.Tensor, n_dirs: int, second: bool) -> torch.Tensor:
    """Differentiable fused fields at X [P, d]: [P, F] (u, u_1..u_n[, u_11..u_nn])."""
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
