"""Multi-device parallelism over the hp-decomposition's element axis.

Counterpart of hpvpinns_tpu/parallel/sharding.py.  The elements couple only
through the shared network weights and the summed loss, so the element
axis is the data-parallel axis: each rank holds a slice of the elements
(`shard_problem`), the parameters and every other array are replicated,
and the only communication the arithmetic needs is a sum over ranks.

JAX runs one process and lets GSPMD insert that sum; torch runs one process
a device (parallel/distributed.py), so every collective here is written
out.  A `Mesh` is this rank's view of the ranks: its shape, its groups (one
for each axis, made with torch.distributed.new_group) and its device.

The sum and its gradient, one rule for the whole port:

  * A loss called with `axis_name=` the element `Axis` returns the global
    value on every rank: its element terms are all-reduced by `psum`, and
    the replicated terms (boundary data, sensors, initial conditions,
    regularisers of replicated points) pass through `once`.
  * Its backward on a rank gives that rank's SHARE of the gradient: `psum`'s
    backward passes the cotangent on unchanged, and `once` lets the
    gradient through on the mesh's rank 0 only.  The shares sum to the
    global gradient, so the callers sum them (`allreduce_grads`), never average.
  * An axis taken `.as_share()` leaves even the forward sum to the caller:
    `psum` returns the local term and `once` zero off rank 0, so the loss is
    this rank's share of the global loss.  The trainer's step then reduces
    the loss and the gradients in one all-reduce of a flat buffer.

torch.distributed.nn.functional.all_reduce is not used: its backward
all-reduces the cotangent, which suits averaged gradients and counts the
replicated terms once a rank when the gradients are summed.

With a point axis (`element_point_mesh`) the fast quadrature axis is split
too.  The contractions over it (ops/contract.py) all-reduce their partial
sums over the point group before anything squares them; the sharded fast
basis tensors carry the point `Axis` (`tag_points`, `points_of`), and that
tag is the only way the point axis reaches them.  Values evaluated once
per element (the edge fluxes of var_form 3, "2c" and AdvDiff's 2) pass
through `once` over the point axis.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from hpvpinns_tpu_torch.parallel import distributed

AXIS = "elements"
POINT_AXIS = "points"

_POINT_ATTR = "_hp_point_axis"  # the point Axis on a sharded fast-axis basis tensor


@dataclass(frozen=True)
class Axis:
    """One named axis of a mesh, as this rank sees it: the process group
    along it, its size, this rank's index, whether this rank carries the
    terms replicated along it (`root`), the group of the whole mesh (over
    which the gradient shares are summed), and for the element axis of a
    2-D mesh whether this rank is index 0 along the point axis."""

    name: str
    group: Any
    size: int
    index: int
    root: bool
    mesh_group: Any
    point_root: bool = True
    share: bool = False

    def as_share(self) -> "Axis":
        """The same axis with the element sum left to the caller."""
        return dataclasses.replace(self, share=True)


class Mesh:
    """This rank's view of a 1-D or 2-D mesh of ranks.  `shape` maps each
    axis name to its size, as jax.sharding.Mesh.shape does."""

    def __init__(self, axes: Sequence[Axis], device: torch.device):
        self.axes = {a.name: a for a in axes}
        self.axis_names = tuple(a.name for a in axes)
        self.shape = {a.name: a.size for a in axes}
        self.size = math.prod(self.shape.values())
        self.device = device
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()

    def axis(self, name: str = AXIS) -> Axis:
        return self.axes[name]

    @property
    def is_root(self) -> bool:
        return self.rank == 0

    @property
    def captures(self) -> bool:
        """Whether a step can be captured into a CUDA graph with its
        collectives inside: NCCL on the card.  gloo works through the host
        and cannot be captured, so under gloo the chunks run eagerly."""
        return self.backend == "nccl" and self.device.type == "cuda"

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank}, backend={self.backend!r}, device={self.device})"


def _world(devices, device, backend) -> tuple:
    """Bring the default group up where needed and return (world, device).
    Under torchrun (or with the topology in the environment) that is
    distributed.initialize; a lone process gets a one-rank group on an
    in-process store, so one script runs alone or under torchrun."""
    device = distributed.local_device(device)
    if not dist.is_initialized():
        distributed.initialize(backend=backend, device=device)
    if not dist.is_initialized():
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend or distributed.default_backend(device), store=dist.HashStore(),
                                rank=0, world_size=1)
    world = dist.get_world_size()
    if devices is not None and list(devices) != list(range(world)):
        raise ValueError(f"a mesh spans every rank of the world, in order: range({world}); got {list(devices)}")
    return world, device


def _warm_up(axes: Sequence[Axis], device: torch.device) -> None:
    """One all-reduce on every group, so that NCCL's communicators exist
    before a CUDA graph captures a collective (NCCL refuses a capture that
    would create one), on the stream the captures warm up on."""
    if device.type != "cuda":
        for a in axes:
            dist.all_reduce(torch.zeros(1, device=device), group=a.group)
        return
    from hpvpinns_tpu_torch.training.trainer import _side_stream

    side = _side_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for a in axes:
            dist.all_reduce(torch.zeros(1, device=device), group=a.group)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize(device)


def element_mesh(devices: Optional[Sequence] = None, axis_name: str = AXIS, *, device=None,
                 backend: Optional[str] = None) -> Mesh:
    """1-D mesh over the element axis: the whole world.  `devices` (the
    ranks, in order) must be the world's; `device` is this rank's device
    (default cuda:LOCAL_RANK, else the CPU); `backend` as in
    distributed.initialize."""
    world, device = _world(devices, device, backend)
    rank = dist.get_rank()
    axes = [Axis(axis_name, dist.group.WORLD, world, rank, root=rank == 0, mesh_group=dist.group.WORLD)]
    _warm_up(axes, device)
    return Mesh(axes, device)


def element_point_mesh(shape: tuple, devices: Optional[Sequence] = None, axis_names: tuple = (AXIS, POINT_AXIS),
                       *, device=None, backend: Optional[str] = None) -> Mesh:
    """2-D mesh: elements x quadrature points, rank r at (r // shape[1],
    r % shape[1]).  The point axis splits the fast quadrature dimension;
    the contractions over it all-reduce their partial sums over the point
    group (ops/contract.py).  Every rank makes every subgroup, in one
    order, as torch.distributed.new_group requires."""
    world, device = _world(devices, device, backend)
    n_e, n_p = int(shape[0]), int(shape[1])
    if n_e * n_p != world:
        raise ValueError(f"mesh shape {shape} needs {n_e * n_p} ranks; the world has {world}")
    rank = dist.get_rank()
    e, p = divmod(rank, n_p)
    elem_groups = [dist.new_group([i * n_p + j for i in range(n_e)]) for j in range(n_p)]
    point_groups = [dist.new_group([i * n_p + j for j in range(n_p)]) for i in range(n_e)]
    axes = [
        Axis(axis_names[0], elem_groups[p], n_e, e, root=rank == 0, mesh_group=dist.group.WORLD, point_root=p == 0),
        Axis(axis_names[1], point_groups[e], n_p, p, root=p == 0, mesh_group=dist.group.WORLD),
    ]
    _warm_up(axes, device)
    return Mesh(axes, device)


class _AllReduce(torch.autograd.Function):
    """Sum over a group.  Backward: the cotangent unchanged (this rank's
    share; module docstring).  Forward mode: the tangents summed, the
    derivative of the sum, through this Function again, so that under vmap
    (a batch of tangents, as a forward-built Jacobian has) its vmap rule
    sums the batched tensor whole: one collective a batch on every rank."""

    @staticmethod
    def forward(t, group):
        out = t.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out.view(-1), group=group)
        return out

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        return grad, None

    @staticmethod
    def jvp(ctx, t_dot, _):
        return _AllReduce.apply(t_dot, ctx.group)

    @staticmethod
    def vmap(info, in_dims, t, group):
        return _AllReduce.apply(t, group), in_dims[0]


def psum(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The sum of `t` over the ranks of `axis` (module docstring).  On a
    share axis the caller sums: the local term, which on a rank off the
    point axis's index 0 keeps its gradient and contributes no value (its
    element row is counted by index 0)."""
    if axis.share:
        return t if axis.point_root else t - t.detach()
    return _AllReduce.apply(t, axis.group)


class _Replica(torch.autograd.Function):
    """The identity with no gradient: a replicated term off its axis's root.
    Its tangent passes (through this Function again, so that a gradient of
    the tangent stops here too), so that a forward-mode derivative of the
    value is the same on every rank; its backward is none (module
    docstring)."""

    @staticmethod
    def forward(t):
        return t.clone()

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        return None

    @staticmethod
    def jvp(ctx, t_dot):
        return _Replica.apply(t_dot)

    @staticmethod
    def vmap(info, in_dims, t):
        return _Replica.apply(t), in_dims[0]


def once(t: torch.Tensor, axis: Axis) -> torch.Tensor:
    """A term replicated along `axis`, counted once: its value and its
    tangent on every rank, its gradient on the axis's root only; on a share
    axis its value on the root only."""
    if axis.root:
        return t
    return torch.zeros_like(t) if axis.share else _Replica.apply(t)


def allreduce_grads(leaves: Sequence[torch.Tensor], axis: Axis, extra: Sequence[torch.Tensor] = ()) -> None:
    """Sum the `.grad` of every leaf (this rank's shares) and the tensors
    `extra` over every rank of `axis`'s mesh (on a 2-D mesh the point ranks'
    shares too), in place, in ONE all-reduce of a flat buffer.  A leaf with
    no gradient on this rank (one only the replicated terms reach, off rank
    0) gets zeros.  `allreduce_grads.captured` counts the all-reduces issued
    while a CUDA graph was being captured: the ones inside a graph."""
    for t in leaves:
        if t.grad is None:
            t.grad = torch.zeros_like(t)
    tensors = [t.grad for t in leaves] + list(extra)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    if flat.is_cuda and torch.cuda.is_current_stream_capturing():
        allreduce_grads.captured += 1
    dist.all_reduce(flat, group=axis.mesh_group)
    for t, piece in zip(tensors, torch.split(flat, [t.numel() for t in tensors])):
        t.copy_(piece.view_as(t))


allreduce_grads.captured = 0


def points_of(t: torch.Tensor) -> Optional[Axis]:
    """The point Axis a point-sharded basis tensor carries, else None: the
    one channel by which the point axis reaches the contractions
    (ops/contract.py)."""
    return getattr(t, _POINT_ATTR, None)


def tag_points(t: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """`t`, tagged with the point Axis `axis` (nothing where it is None)."""
    if axis is not None:
        setattr(t, _POINT_ATTR, axis)
    return t


def _pad_leading(arr: torch.Tensor, pad: int, *, zero: bool) -> torch.Tensor:
    """Pad axis 0 by `pad` rows: zeros, or the last row repeated (finite
    network inputs)."""
    if pad == 0:
        return arr
    tail = torch.zeros_like(arr[:1]).expand(pad, *arr.shape[1:]) if zero else arr[-1:].expand(pad, *arr.shape[1:])
    return torch.cat([arr, tail])


def pad_elements(elems, multiple: int):
    """Pad an Elements1D/2D/3D batch so E divides the mesh size.

    Padded elements are inert: mask = 0 and f_proj = 0 (their residual
    contributes exactly zero to the loss), n_test = max(n_test, 1) edge-padded
    (no division by zero), every other field edge-padded (network
    evaluations stay finite)."""
    E = elems.mask.shape[0]
    pad = (-E) % multiple
    if pad == 0:
        return elems
    fields = {}
    for f in dataclasses.fields(elems):
        arr = getattr(elems, f.name)
        if f.name in ("mask", "f_proj"):
            fields[f.name] = _pad_leading(arr, pad, zero=True)
        elif f.name == "n_test":
            fields[f.name] = _pad_leading(torch.clamp(arr, min=1), pad, zero=False)
        else:
            fields[f.name] = _pad_leading(arr, pad, zero=False)
    return type(elems)(**fields)


def _pad_trailing(arr: torch.Tensor, pad: int, *, zero: bool) -> torch.Tensor:
    """Pad the LAST axis by `pad`: zeros, or the last column repeated."""
    if pad == 0:
        return arr
    shape = (*arr.shape[:-1], pad)
    tail = torch.zeros(shape, dtype=arr.dtype, device=arr.device) if zero else arr[..., -1:].expand(shape)
    return torch.cat([arr, tail], dim=-1)


def pad_points(elems, fast_basis, multiple: int):
    """Pad the fast quadrature axis (last axis of x/y/z and the column axis
    of the fast-axis weighted basis) so Q divides the point-axis size.

    Padded quadrature points are inert: their basis columns carry zero
    weight, so they add exactly zero to every contraction; the coordinates
    are edge-padded (finite network inputs)."""
    Q = elems.x.shape[-1]
    pad = (-Q) % multiple
    if pad == 0:
        return elems, fast_basis
    efields = {f.name: getattr(elems, f.name) for f in dataclasses.fields(elems)}
    for name in ("x", "y", "z"):
        if name in efields:
            efields[name] = _pad_trailing(efields[name], pad, zero=False)
    bfields = {f.name: getattr(fast_basis, f.name) for f in dataclasses.fields(fast_basis)}
    for name in ("wphi", "wdphi", "wd2phi"):
        bfields[name] = _pad_trailing(bfields[name], pad, zero=True)
    return type(elems)(**efields), type(fast_basis)(**bfields)


def _to(value, device):
    return value.to(device) if hasattr(value, "to") else value


def shard_problem(data: dict, mesh: Mesh, axis_name: str = AXIS, point_axis: Optional[str] = None) -> dict:
    """THIS rank's shard of a problem's data: the element batch padded to a
    multiple of the element axis and sliced along axis 0; with a point axis
    (default: the mesh's, if it has one) the fast quadrature axis padded and
    sliced too, in the coordinates and in the fast basis (`basis_x`, else
    `basis`), whose sliced tensors carry the point Axis; everything else
    replicated (every rank built the same problem).  All of it on the
    mesh's device."""
    if point_axis is None and POINT_AXIS in mesh.axis_names:
        point_axis = POINT_AXIS
    ea = mesh.axis(axis_name)
    out = {k: v for k, v in data.items() if k != "elements"}
    elems = pad_elements(data["elements"], ea.size)
    fields = {f.name: getattr(elems, f.name) for f in dataclasses.fields(elems)}
    if point_axis is not None:
        pa = mesh.axis(point_axis)
        fast_key = "basis_x" if "basis_x" in data else "basis"
        elems, fast_basis = pad_points(elems, data[fast_key], pa.size)
        fields = {f.name: getattr(elems, f.name) for f in dataclasses.fields(elems)}
        q = fields["x"].shape[-1] // pa.size
        cols = slice(pa.index * q, (pa.index + 1) * q)
        for name in ("x", "y", "z"):
            if name in fields:
                fields[name] = fields[name][..., cols]
        bfields = {f.name: getattr(fast_basis, f.name) for f in dataclasses.fields(fast_basis)}
        for name in ("wphi", "wdphi", "wd2phi"):
            bfields[name] = tag_points(bfields[name][:, cols].contiguous().to(mesh.device), pa)
        bfields["dphi_b"] = bfields["dphi_b"].to(mesh.device)
        out[fast_key] = type(fast_basis)(**bfields)
    n = fields["mask"].shape[0] // ea.size
    rows = slice(ea.index * n, (ea.index + 1) * n)
    out["elements"] = type(elems)(**{k: v[rows].contiguous().to(mesh.device) for k, v in fields.items()})
    for key, value in out.items():
        if key != "elements" and not (point_axis is not None and key == fast_key):
            out[key] = _to(value, mesh.device)
    return out


def replicate(tree: Any, mesh: Mesh) -> Any:
    """A copy of a tree of tensors (parameters, optimizer state) with every
    leaf broadcast from rank 0, on the mesh's device."""

    def bcast(t):
        if not torch.is_tensor(t):
            return t
        t = t.detach().to(mesh.device, copy=True).contiguous()
        dist.broadcast(t, src=0)
        return t

    return torch.utils._pytree.tree_map(bcast, tree)


def shard_map_loss(loss_fn, data: dict, mesh: Mesh, axis_name: str = AXIS):
    """The explicit formulation of a problem loss on the mesh: (params,
    data) -> (loss, aux), `loss_fn` called on this rank's shard with
    `axis_name=` the element Axis, so that the loss and every aux value are
    the global ones on every rank.  Its gradient on a rank is that rank's
    share (module docstring): sum the shares with `allreduce_grads`."""
    axis = mesh.axis(axis_name)

    def wrapped(params, data):
        return loss_fn(params, data, axis_name=axis)

    return wrapped
