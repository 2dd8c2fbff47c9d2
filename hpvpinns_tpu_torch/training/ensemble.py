"""Seed-ensemble training: S independent networks in one vmapped step.

Counterpart of hpvpinns_tpu/training/ensemble.py.  The parameters of S
seeds are stacked along a leading axis, and one step computes every
member's loss and gradient with `torch.func.vmap` of
`torch.func.grad_and_value` over the stack, the data shared (not batched).
Adam is elementwise, so one Adam over the stacked tensors is S independent
Adams, as optax's over the stacked pytree is in the JAX package.  The
metrics come back with a leading [S] axis, one host read a chunk.

On the card the step is captured once as a CUDA graph and a chunk replays
it n times, then a graph of the metrics, with the trainer's machinery
(training/trainer.py::_graph_chunk); on the CPU the chunk runs step by
step.  Under deriv_mode="pallas" the fused-fields kernels run under the
vmap once for each member (ops/fused_fields.py: _FieldsFlat's and
_FieldsFlatVjp's vmap rules), S launches of B1 a step (and of B2 and its
block sum with second derivatives), all inside the one captured step.
A capture failure raises.

On a mesh (parallel/sharding.py) every member trains on this rank's shard
of the elements: the vmapped step computes every member's share of the
loss and the gradients (the element Axis `.as_share()`), and one all-reduce
of the stacked gradients, outside the vmap, sums them over the ranks (JAX:
ensemble.py:116-140).  The metrics are the global ones (the loss's `psum`
under the vmap).  Under NCCL the step is a captured graph as above; under
gloo the chunks run eagerly.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from hpvpinns_tpu_torch.config import TrainConfig
from hpvpinns_tpu_torch.models.mlp import use_ieee_fp32_matmuls
from hpvpinns_tpu_torch.parallel.sharding import AXIS, allreduce_grads, replicate, shard_problem
from hpvpinns_tpu_torch.problems.base import Problem, map_params, parameters
from hpvpinns_tpu_torch.training.trainer import (
    _captures,
    _Chunk,
    _graph_chunk,
    _mesh_losses,
    _repeat,
    make_optimizer,
)
from hpvpinns_tpu_torch.utils import profiling


@dataclass
class EnsembleResult:
    params_stack: Any  # params tree with a leading seed axis [S, ...]
    seeds: List[int]
    history: Dict[str, np.ndarray]  # each [n_records, S]
    iterations_run: int
    wall_time_s: float
    steps_per_sec: float  # optimizer steps/s (each step advances ALL seeds)
    seed_steps_per_sec: float  # steps_per_sec * S (the serial-equivalent rate)
    final_aux: Dict[str, np.ndarray]  # each [S]

    def member(self, i: int):
        """Seed i's parameters, as a tree of detached copies."""
        return map_params(lambda a: a[i].detach().clone(), self.params_stack)

    def best_member(self, key: str = "loss"):
        """(index, params) of the seed with the lowest final `key`."""
        i = int(np.argmin(self.final_aux[key]))
        return i, self.member(i)


def _zip_trees(fn: Callable, trees):
    """One tree of the trees' nesting (dicts and lists) with fn([the leaf of
    every tree]) at each leaf."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _zip_trees(fn, [t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return [_zip_trees(fn, [t[i] for t in trees]) for i in range(len(first))]
    return fn(trees)


def init_ensemble(problem: Problem, seeds: Sequence[int]):
    """Stacked init, leading axis = seed: member i is, bit for bit, the draw
    problem.init_params(torch.Generator().manual_seed(seeds[i])) that
    `train` starts from at cfg.seed = seeds[i]."""
    draws = [problem.init_params(torch.Generator().manual_seed(int(s))) for s in seeds]
    return _zip_trees(lambda leaves: nn.Parameter(torch.stack([t.detach() for t in leaves])), draws)


def _detached(params_stack):
    """The stack's leaves as detached views (the same storage): what the
    vmapped step differentiates, so no autograd graph reaches the
    parameters themselves."""
    return map_params(lambda t: t.detach(), params_stack)


def _ensemble_step(loss_fn: Callable, opt, params_stack, data, axis=None):
    """() -> None: one Adam step of every member.  The gradients of the
    vmapped loss become the stacked parameters' .grad, which the optimizer
    reads; on a mesh (`axis`) they are this rank's shares, summed over the
    ranks in one all-reduce after the vmap."""
    leaves = parameters(params_stack)
    grad_fn = torch.func.vmap(torch.func.grad_and_value(lambda p: loss_fn(p, data), has_aux=True))
    view = _detached(params_stack)

    def step():
        grads, _ = grad_fn(view)
        for t, g in zip(leaves, parameters(grads)):
            t.grad = g
        if axis is not None:
            allreduce_grads(leaves, axis)
        opt.step()

    return step


def _ensemble_metrics(loss_fn: Callable, params_stack, data):
    """() -> the aux dict at the current params, each value [S], without
    gradients."""
    aux_fn = torch.func.vmap(lambda p: loss_fn(p, data)[1])
    view = _detached(params_stack)

    def aux():
        with torch.no_grad():
            return aux_fn(view)

    return aux


def _build_ens_chunk(loss_fn: Callable, opt, params_stack, data, debug: bool = False, mesh=None) -> _Chunk:
    """The ensemble chunk: n vmapped Adam steps, then the metrics of every
    member.  On the card as CUDA graphs (training/trainer.py::_graph_chunk),
    on the CPU and on a mesh under gloo step by step."""
    axis = None if mesh is None else mesh.axis(AXIS)
    step_loss, metric_loss = _mesh_losses(loss_fn, axis)
    step = _ensemble_step(step_loss, opt, params_stack, data, axis)
    metrics = _ensemble_metrics(metric_loss, params_stack, data)
    if not _captures(params_stack, mesh):
        return _Chunk(_repeat(step), metrics)
    return _graph_chunk(step, metrics, opt, parameters(params_stack), debug)


def train_ensemble(
    problem: Problem,
    cfg: Optional[TrainConfig] = None,
    seeds: Sequence[int] = (0, 1, 2, 3),
    verbose: bool = True,
    mesh=None,
) -> EnsembleResult:
    """Train len(seeds) independent initializations in one vmapped loop, the
    Adam phase only (as in the JAX package: polish the selected member
    afterwards with `train`'s L-BFGS/Gauss-Newton if wanted).  The records
    come one a chunk of cfg.check_every steps; cfg.threshold stops the run
    when the largest member loss is below it.  `mesh` (parallel/sharding.py)
    trains every member on this rank's shard of the elements, the stack
    broadcast from rank 0 (module docstring); only its rank 0 prints."""
    cfg = cfg or problem.config.train
    use_ieee_fp32_matmuls()
    seeds = [int(s) for s in seeds]
    params_stack = init_ensemble(problem, seeds)
    data = problem.data
    if mesh is not None:
        data = shard_problem(data, mesh)
        params_stack = map_params(nn.Parameter, replicate(params_stack, mesh))
        verbose = verbose and mesh.is_root
    opt = make_optimizer(cfg, params_stack)
    check = max(1, cfg.check_every)
    with profiling.span("phase", name="ensemble"):
        chunk = _build_ens_chunk(problem.loss_fn, opt, params_stack, data, mesh=mesh)

        records = []
        t0 = time.perf_counter()
        t_warm = None
        it = it_warm = 0
        aux_host: Dict[str, np.ndarray] = {}
        while it < cfg.iterations:
            n = min(check, cfg.iterations - it)
            aux = chunk(n)
            keys = list(aux)
            with profiling.span("chunk.read"):
                values = torch.stack([aux[k].detach() for k in keys]).cpu().numpy()  # one device sync
            aux_host = {k: v.astype(np.float64) for k, v in zip(keys, values)}
            it += n
            if t_warm is None:  # the first chunk carries the one-time build and capture costs
                t_warm, it_warm = time.perf_counter(), it
            records.append({"iteration": it, **aux_host})
            if verbose and it % cfg.log_every < check:
                losses = aux_host["loss"]
                print(f"It: {it}, loss min/med/max: {losses.min():.3e}/{np.median(losses):.3e}/{losses.max():.3e}")
            if cfg.threshold is not None and aux_host["loss"].max() < cfg.threshold:
                break
        del chunk  # its graphs, and the gradient buffers in their pools
        for t in parameters(params_stack):
            t.grad = None

    t_end = time.perf_counter()
    if t_warm is not None and it > it_warm and t_end > t_warm:
        sps = (it - it_warm) / (t_end - t_warm)
    else:
        sps = it / max(t_end - t0, 1e-9)
    S = len(seeds)
    keys = sorted({k for r in records for k in r})
    history = {
        k: np.stack([np.full(S, r[k]) if k == "iteration"
                     else np.broadcast_to(np.asarray(r.get(k, np.nan)), (S,)) for r in records])
        for k in keys
    }
    return EnsembleResult(
        params_stack=params_stack,
        seeds=seeds,
        history=history,
        iterations_run=it,
        wall_time_s=t_end - t0,
        steps_per_sec=sps,
        seed_steps_per_sec=sps * S,
        final_aux=aux_host,
    )
