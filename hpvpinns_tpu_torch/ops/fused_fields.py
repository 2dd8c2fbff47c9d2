"""Fused MLP + derivative-field kernel (B1) and its gradient.

Counterpart of hpvpinns_tpu/ops/pallas_fields.py.  `fields_flat` returns
[P, F] with F = 1 + n_dirs * (2 if second else 1) columns (u, firsts...,
seconds...).  Its forward is the hand-written CUDA kernel
csrc/fused_fields.cu on a CUDA tensor, and the plain PyTorch version
`fields_flat_reference` on a CPU tensor; on a CUDA tensor the kernel
launches or the call raises, it never falls back.  The kernel takes float32,
sin/tanh, a scalar output, n_dirs 1-3, layer widths up to MAX_WIDTH = 64 and
up to MAX_LAYERS = 16 layers, and raises above them.

The gradient: for second=False it is autograd through the plain Taylor
propagation (ops/taylor.py::mlp_fields), which is what the JAX package does
(pallas_fields.py:194-196; its TPU kernel has no backward for that layout).
For second=True the JAX package has a backward kernel (B2,
_fields_bwd_kernel) that is not ported yet, so the backward raises.
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


class FusedFieldsKernel:
    """The CUDA kernel csrc/fused_fields.cu behind a ctypes handle, built at
    first use, with `launches`: the number of times it was launched."""

    def __init__(self):
        self.launches = 0
        self.built: BuiltLibrary | None = None
        self._smem_limit = {}

    def load(self) -> BuiltLibrary:
        if self.built is None:
            built = build_library("fused_fields", [CSRC_DIR / "fused_fields.cu"])
            lib = built.lib
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            lib.hp_fused_fields_f32.argtypes = [vp, vp, vp, i32, i32, i32, i32, i32, vp, i32, vp]
            lib.hp_fused_fields_f32.restype = i32
            lib.hp_fused_fields_smem_bytes.argtypes = [i32, i32, i32, i32]
            lib.hp_fused_fields_smem_bytes.restype = ctypes.c_longlong
            lib.hp_fused_fields_smem_limit.argtypes = [i32]
            lib.hp_fused_fields_smem_limit.restype = i32
            lib.hp_fused_fields_max_width.restype = i32
            lib.hp_fused_fields_max_layers.restype = i32
            if (lib.hp_fused_fields_max_width(), lib.hp_fused_fields_max_layers()) != (MAX_WIDTH, MAX_LAYERS):
                raise RuntimeError("csrc/fused_fields.cu limits disagree with MAX_WIDTH/MAX_LAYERS")
            self.built = built
        return self.built

    def __call__(self, spec: MLP, params, X: torch.Tensor, n_dirs: int, second: bool) -> torch.Tensor:
        check_kernel_args(spec, params, X, n_dirs)
        lib = self.load().lib
        dev = X.device.index if X.device.index is not None else torch.cuda.current_device()
        packed, widths = pack_params(spec, params)
        n_params = packed.numel()
        max_w = max(spec.layers[:-1])
        smem = lib.hp_fused_fields_smem_bytes(n_params, max_w, n_dirs, int(second))
        if dev not in self._smem_limit:
            self._smem_limit[dev] = lib.hp_fused_fields_smem_limit(dev)
        if smem > self._smem_limit[dev]:
            raise ValueError(
                f"fused_fields kernel needs {smem} B of shared memory for layers "
                f"{spec.layers}; the card allows {self._smem_limit[dev]} B per block"
            )
        P = X.shape[0]
        out = torch.empty((P, 1 + n_dirs * (2 if second else 1)), dtype=torch.float32, device=X.device)
        if P == 0:
            return out
        stream = torch.cuda.current_stream(X.device).cuda_stream
        err = lib.hp_fused_fields_f32(
            X.data_ptr(), packed.data_ptr(), widths.ctypes.data, spec.n_layers, P, n_dirs,
            int(second), _ACTIVATION_CODE[spec.activation], out.data_ptr(), dev, stream,
        )
        if err != 0:
            raise RuntimeError(f"fused_fields kernel launch failed: CUDA error {err}")
        self.launches += 1
        return out


fused_fields_kernel = FusedFieldsKernel()


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
        if ctx.second:
            raise NotImplementedError(
                "B2 (_fields_bwd_kernel, the backward of second=True fields) is not "
                "ported yet (ROADMAP.md): fields_flat(..., second=True) has no gradient"
            )
        X, *flat = ctx.saved_tensors
        want_x = ctx.needs_input_grad[3]
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
