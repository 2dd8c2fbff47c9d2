"""Generic trainer: full-batch Adam, then optionally L-BFGS, in chunks of
`check_every` iterations, then optionally Gauss-Newton/LM.

Counterpart of hpvpinns_tpu/training/trainer.py.  Each chunk runs
`check_every` optimizer iterations without reading anything back, then
evaluates the metrics at the updated parameters (as the JAX chunk does,
trainer.py:170-175) and brings them to the host in one sync.
Threshold early stop, loss history, the best-parameter snapshot and the
iteration count carried across phases behave as in the JAX package.

On the card the JAX package's `jax.jit(lax.scan(...))` chunk becomes CUDA
graphs: one Adam step (forward, backward, optimizer update) is captured once
and a chunk replays it n times, then replays a second graph that evaluates
the metrics.  The L-BFGS closure (forward and backward) is a captured graph
too.  A capture failure raises: nothing falls back to the eager loop.  On the
CPU the chunks run eagerly, step by step.  The Gauss-Newton/LM phase
(training/gauss_newton.py) runs eagerly after the graphs are freed, and
writes its result into the same parameter tensors.  With `checkpoint_dir`
the params and the optimizer state are saved every `checkpoint_every`
iterations, at chunk boundaries, and once at the end
(training/checkpoint.py).

On a mesh (parallel/sharding.py) each rank trains on its shard of the
elements with the parameters replicated.  A step computes this rank's
share of the loss and of the gradients (the element Axis `.as_share()`)
and sums the loss and the gradients over the ranks in ONE all-reduce of a
flat buffer, where JAX's GSPMD inserts its own (trainer.py:191-206).  The
metrics, the L-BFGS closure and the best snapshot see the global loss, so
every rank takes the same branch.  Under NCCL the chunk stays a captured
CUDA graph with the all-reduce inside it (its communicator made before the
capture, parallel/sharding.py::_warm_up); under gloo (the CPU, or ranks
that share one card) the chunks run eagerly, step by step.  The mode is
`TrainResult.chunk_mode`.  Only the mesh's rank 0 prints and writes
checkpoints.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from hpvpinns_tpu_torch.config import TrainConfig
from hpvpinns_tpu_torch.models.mlp import use_ieee_fp32_matmuls
from hpvpinns_tpu_torch.ops.fused_fields import launch_counts
from hpvpinns_tpu_torch.parallel.sharding import AXIS, allreduce_grads, replicate, shard_problem
from hpvpinns_tpu_torch.problems.base import Problem, map_params, parameters
from hpvpinns_tpu_torch.training.checkpoint import Checkpointer
from hpvpinns_tpu_torch.training.gauss_newton import gauss_newton
from hpvpinns_tpu_torch.training.lbfgs import LBFGS
from hpvpinns_tpu_torch.utils import profiling


@dataclass
class TrainResult:
    params: Any
    history: Dict[str, np.ndarray]  # 'iteration', 'loss', 'lossb', 'lossv'
    iterations_run: int
    wall_time_s: float
    steps_per_sec: float
    stopped_early: bool
    best_params: Optional[Any] = None
    final_aux: Dict[str, float] = field(default_factory=dict)
    # per phase ("adam", "lbfgs", "gn"): iterations, wall seconds; for L-BFGS
    # the closure evaluations (the loss and gradient), the failed line
    # searches, and under "unsafe_at" the iterations (counted as in
    # history["iteration"]) that ended with an unsafe step (training/lbfgs.py);
    # for Gauss-Newton the accepted steps, the others ("rejected"), why it
    # stopped and the damping after its last accepted step
    phases: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    # how the Adam and L-BFGS chunks ran: "graph" (captured CUDA graphs, the
    # card; on a mesh under NCCL only) or "eager" (step by step: the CPU, or
    # a mesh under gloo)
    chunk_mode: str = "eager"

    @property
    def eval_params(self):
        """The best snapshot when one was kept, otherwise the final params."""
        return self.best_params if self.best_params is not None else self.params


def _on_card(params) -> bool:
    return all(t.is_cuda for t in parameters(params))


def make_optimizer(cfg: TrainConfig, params) -> torch.optim.Adam:
    """Adam with the optax/TF1 defaults (betas 0.9/0.999, eps 1e-8) and the
    configured learning rate, over every leaf of `params`; `capturable` on the
    card, so that its step can be captured in a CUDA graph.

    Capturable Adam forms its bias corrections 1 - beta^t on the device from
    its step counter, which torch makes float32: a float64 run's corrections
    were rounded to float32, and its records on the card parted from the
    JAX package's (optax corrects in the parameters' dtype) by ~4e-6 after
    300 steps.  So each float64 leaf's state starts here, with a float64
    counter; other leaves keep torch's own."""
    leaves = parameters(params)
    capturable = _on_card(params)
    opt = torch.optim.Adam(leaves, lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8, capturable=capturable)
    for p in leaves:
        if p.dtype == torch.float64:
            opt.state[p] = {"step": torch.zeros((), dtype=torch.float64, device=p.device if capturable else None),
                            "exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}
    return opt


def make_lbfgs(params) -> LBFGS:
    """optax.lbfgs() (training/lbfgs.py): a memory of 10, the zoom line
    search with at most 20 trials, over every leaf of `params`; one `step`
    is one iteration, and no tolerance stops it early."""
    return LBFGS(parameters(params))


def _copy_params(params, as_parameters: bool):
    def copy(t):
        t = t.detach().clone()
        return nn.Parameter(t) if as_parameters else t

    return map_params(copy, params)


_SIDE_STREAMS: Dict[int, "torch.cuda.Stream"] = {}


def _side_stream() -> "torch.cuda.Stream":
    """The one side stream of the current device that every capture's
    warm-up runs on.  cuBLAS keeps a workspace for each stream it has run
    on until the process ends, so a new stream for each capture kept ~48 MiB
    more allocated with every capture (~288 MiB a round of adaptive_solve
    on an H100 80GB HBM3; PERF.md §6)."""
    device = torch.cuda.current_device()
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream()
    return _SIDE_STREAMS[device]


def _capture(fn: Callable, name: str, debug: bool = False):
    """Run `fn` twice on the side stream (the kernels build and set their
    attributes, lazily created state appears), then capture one call of it
    in a CUDA graph: (graph, what the captured call returned, a function
    that replays the graph).  The warm-up calls run; the capture runs
    nothing.  `debug` keeps the captured graph (not only its instantiation)
    for `debug_dump`.  While the recorder is on (utils/profiling.py) the
    spans `chunk.capture` (graph=`name`), `capture.warmup` and
    `capture.graph` time it, the graph is kept to count its kernel nodes and
    the kernel launches its capture made, and the replay function counts its
    calls."""
    recording = profiling.enabled()
    with profiling.span("chunk.capture", graph=name):
        side = _side_stream()
        side.wait_stream(torch.cuda.current_stream())
        with profiling.span("capture.warmup"), torch.cuda.stream(side):
            for _ in range(2):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph(keep_graph=debug or recording)
        if debug:
            graph.enable_debug_mode()
        with profiling.span("capture.graph"):
            before = launch_counts()
            with torch.cuda.graph(graph):
                out = fn()
            launched = {k: v - before[k] for k, v in launch_counts().items()}
            if debug or recording:
                graph.instantiate()
    if not recording:
        return graph, out, graph.replay
    counts = profiling.capture_counts(name, graph, launched)

    def replay():
        graph.replay()
        counts.replays += 1

    return graph, out, replay


def _mesh_losses(loss_fn: Callable, axis):
    """(step loss, metrics loss): off a mesh both `loss_fn`; on a mesh the
    step's loss is this rank's share (axis.as_share(), parallel/sharding.py)
    and the metrics' the global one."""
    if axis is None:
        return loss_fn, loss_fn
    share = axis.as_share()
    return (lambda p, d: loss_fn(p, d, axis_name=share)), (lambda p, d: loss_fn(p, d, axis_name=axis))


def _eager_metrics(loss_fn: Callable, params, data):
    """() -> the metrics (aux) at the current params, without gradients."""

    def aux():
        with torch.no_grad():
            return loss_fn(params, data)[1]

    return aux


def _graph_metrics(aux: Callable, debug: bool = False):
    """The metrics `aux()` as a replayed CUDA graph: (() -> aux, the graph)."""
    graph, out, run = _capture(aux, "metrics", debug)

    def replay():
        run()
        return out

    return replay, graph


class _Chunk:
    """chunk(n): n optimizer iterations, then the metrics at the updated
    params (a dict of tensors).  `graphs` holds the CUDA graphs it replays
    (empty when it runs eagerly).  While the recorder is on
    (utils/profiling.py) a call records its `chunk` and `chunk.launch` spans
    and, for a chunk of graphs, an event before and one after it."""

    def __init__(self, iterate: Callable[[int], None], metrics: Callable, graphs=()):
        self._iterate, self._metrics, self.graphs = iterate, metrics, tuple(g for g in graphs if g is not None)

    def __call__(self, n: int):
        recorder = profiling.RECORDER
        if not recorder.on:
            self._iterate(n)
            return self._metrics()
        recorder.chunk_begin(n, bool(self.graphs))
        try:
            self._iterate(n)
            return self._metrics()
        finally:
            recorder.chunk_end()


def _backward(loss_fn: Callable, params, data, axis) -> torch.Tensor:
    """The loss at the current params and its gradients in .grad; on a mesh
    (`axis`) this rank's shares, then the loss and every gradient summed over
    the ranks in one all-reduce: the global values on every rank."""
    loss, _ = loss_fn(params, data)
    loss.backward()
    loss = loss.detach()
    if axis is not None:
        loss = loss.clone()
        allreduce_grads(parameters(params), axis, extra=[loss])
    return loss


def _adam_step(loss_fn: Callable, opt, params, data, axis=None):
    def step():
        opt.zero_grad(set_to_none=True)
        _backward(loss_fn, params, data, axis)
        opt.step()

    return step


def _repeat(step: Callable[[], None]) -> Callable[[int], None]:
    def iterate(n):
        for _ in range(n):
            step()

    return iterate


def _build_stepwise_chunk(loss_fn: Callable, opt, params, data, axis=None) -> _Chunk:
    """The eager Adam chunk: n steps of zero-grad, forward, backward and
    update, each with its own launches, then the metrics.  The CPU path, a
    mesh's under gloo, and what the card's graph chunk is held against."""
    step_loss, metric_loss = _mesh_losses(loss_fn, axis)
    return _Chunk(_repeat(_adam_step(step_loss, opt, params, data, axis)), _eager_metrics(metric_loss, params, data))


def _graph_chunk(step: Callable[[], None], aux: Callable, opt, leaves, debug: bool = False) -> _Chunk:
    """A chunk of CUDA graphs: `step` (one optimizer step of `opt` over the
    tensors `leaves`) captured once, and the metrics `aux()`; a chunk of n
    steps is n replays of the first and one of the second, so a shorter last
    chunk needs no new capture.  `debug` keeps the graphs for `debug_dump`.

    The warm-up before the capture steps the optimizer and moves the
    parameters, so both are saved before it and written back, into the same
    tensors, after the capture: the graph then starts where the eager loop
    would.  The captured launches keep the addresses of the parameters, the
    optimizer state and the data: none of them may be rebound afterwards."""
    with torch.no_grad():
        saved = [t.clone() for t in leaves]
        saved_state = {p: {k: v.clone() for k, v in s.items() if torch.is_tensor(v)} for p, s in opt.state.items()}
    step_graph, _, step_replay = _capture(step, "step", debug)
    with torch.no_grad():
        for t, s in zip(leaves, saved):
            t.copy_(s)
        for p, s in opt.state.items():  # state the warm-up created starts at zero (Adam's step and moments)
            for k, v in s.items():
                if torch.is_tensor(v):
                    v.copy_(saved_state[p][k]) if p in saved_state else v.zero_()
    metrics, metrics_graph = _graph_metrics(aux, debug)
    return _Chunk(_repeat(step_replay), metrics, (step_graph, metrics_graph))


def _captures(params, mesh) -> bool:
    """Whether the chunks run as captured CUDA graphs: on the card, and on
    a mesh only under NCCL (parallel/sharding.py::Mesh.captures)."""
    return _on_card(params) and (mesh is None or mesh.captures)


def _build_chunk(loss_fn: Callable, opt, params, data, debug: bool = False, mesh=None) -> _Chunk:
    """The Adam chunk.  On the CPU, or on a mesh under gloo, the stepwise
    chunk.  On the card one step captured once as a CUDA graph (`opt` must
    be capturable), plus a graph of the metrics (_graph_chunk); on a mesh
    under NCCL the step's all-reduce is inside the graph.  The gradients are
    None when the capture starts, so the captured backward writes them
    afresh, into buffers of the graph's pool, on every replay."""
    axis = None if mesh is None else mesh.axis(AXIS)
    if not _captures(params, mesh):
        return _build_stepwise_chunk(loss_fn, opt, params, data, axis)
    step_loss, metric_loss = _mesh_losses(loss_fn, axis)
    return _graph_chunk(_adam_step(step_loss, opt, params, data, axis), _eager_metrics(metric_loss, params, data),
                        opt, parameters(params), debug)


def _build_lbfgs_chunk(loss_fn: Callable, opt: LBFGS, params, data, mesh=None) -> _Chunk:
    """The L-BFGS chunk: n calls of `opt.step(closure)`, one iteration each,
    then the metrics.  The closure sets the gradients of the loss at the
    current params and returns the loss; on the card it replays a CUDA graph
    of the forward and backward, captured once (the optimizer writes each
    trial point into the parameters with `copy_`, so their addresses hold).

    The optimizer is the JAX package's optax.lbfgs() (training/lbfgs.py), so
    this phase follows the JAX trajectory: in float64 on the CPU its records
    equal the JAX package's to rounding (tests/test_torch_trainer.py).  Each
    line-search trial reads its value and slope on the host in one sync.
    On a mesh the closure returns the global loss and gradients, so every
    rank runs the same iterations."""
    axis = None if mesh is None else mesh.axis(AXIS)
    step_loss, metric_loss = _mesh_losses(loss_fn, axis)

    def evaluate():
        opt.zero_grad(set_to_none=True)
        return _backward(step_loss, params, data, axis)

    graph = metrics_graph = None
    closure, metrics = evaluate, _eager_metrics(metric_loss, params, data)
    if _captures(params, mesh):
        graph, loss, replay = _capture(evaluate, "closure")

        def closure():
            replay()
            return loss

        metrics, metrics_graph = _graph_metrics(metrics)

    def iterate(n):
        for _ in range(n):
            opt.step(closure)

    return _Chunk(iterate, metrics, (graph, metrics_graph))


def train(
    problem: Problem,
    cfg: Optional[TrainConfig] = None,
    mesh=None,
    params=None,
    verbose: bool = True,
) -> TrainResult:
    """Adam for cfg.iterations, then L-BFGS for cfg.lbfgs_iterations, then
    Gauss-Newton/LM for cfg.gn_iterations accepted steps, on problem.loss_fn;
    the arguments in the JAX package's order.  `params` (default:
    problem.init_params from a CPU torch.Generator seeded with cfg.seed) are
    copied, never updated in place.  `mesh` (parallel/sharding.py) trains
    this rank's shard of the elements with the parameters broadcast from
    rank 0 (module docstring); the problem is built on the mesh's device."""
    cfg = cfg or problem.config.train
    use_ieee_fp32_matmuls()
    loss_fn, data = problem.loss_fn, problem.data
    if params is None:
        params = problem.init_params(torch.Generator().manual_seed(cfg.seed))
    if mesh is not None:
        data = shard_problem(data, mesh)
        params = replicate(params, mesh)
        verbose = verbose and mesh.is_root
    params = _copy_params(params, as_parameters=True)
    chunk_mode = "graph" if _captures(params, mesh) else "eager"
    if verbose and mesh is not None:
        print(f"mesh {mesh.shape} ({mesh.backend}): {chunk_mode} chunks")

    check = max(1, cfg.check_every)
    checkpointer = None
    if cfg.checkpoint_dir is not None and (mesh is None or mesh.is_root):
        checkpointer = Checkpointer(cfg.checkpoint_dir, keep_last=cfg.checkpoint_keep_last,
                                    use_async=cfg.checkpoint_async)
    adam = make_optimizer(cfg, params)
    opt_state = adam.state_dict  # () -> what a checkpoint saves as the optimizer state
    records: List[Dict[str, float]] = []
    phases: Dict[str, Dict[str, Any]] = {}
    stopped = False
    best_params = None
    min_loss = np.inf
    total_iters = cfg.iterations + cfg.lbfgs_iterations
    snap_after = (
        cfg.best_snapshot_fraction * total_iters
        if cfg.best_snapshot_fraction is not None
        else None
    )

    t0 = time.perf_counter()
    state = {"t_log": t0, "t_warm": None, "it_warm": 0, "it": 0, "it_saved": 0, "aux": {}}

    def run_phase(name, build_chunk, opt, n_iters):
        nonlocal stopped, best_params, min_loss
        with profiling.span("phase", name=name):
            t_phase, it_start = time.perf_counter(), state["it"]
            chunk = build_chunk(loss_fn, opt, params, data, mesh=mesh)
            end = state["it"] + n_iters
            while state["it"] < end:
                n = min(check, end - state["it"])
                aux = chunk(n)
                keys = list(aux)
                with profiling.span("chunk.read"):
                    values = torch.stack([aux[k].detach() for k in keys]).tolist()  # one device sync
                aux_host = state["aux"] = dict(zip(keys, values))
                it = state["it"] = state["it"] + n
                if state["t_warm"] is None:  # the first chunk carries one-time build/capture costs
                    state["t_warm"], state["it_warm"] = time.perf_counter(), it
                records.append({"iteration": it, **aux_host})
                loss_value = aux_host["loss"]

                if snap_after is not None and it > snap_after and loss_value < min_loss:
                    min_loss = loss_value
                    best_params = _copy_params(params, as_parameters=False)
                if checkpointer is not None and cfg.checkpoint_every and it - state["it_saved"] >= cfg.checkpoint_every:
                    checkpointer.save(it, params, opt.state_dict())
                    state["it_saved"] = it
                if cfg.threshold is not None and loss_value < cfg.threshold:
                    if verbose:
                        print(f"It: {it}, Loss: {loss_value:.3e} (threshold reached)")
                    stopped = True
                    break
                if verbose and it % cfg.log_every < check:
                    now = time.perf_counter()
                    parts = ", ".join(f"{k}: {v:.3e}" for k, v in aux_host.items() if k != "loss")
                    print(f"It: {it}, Loss: {loss_value:.3e}, {parts}, Time: {now - state['t_log']:.2f}")
                    state["t_log"] = now
            del chunk  # its graphs, and the gradient buffers in their pools
            for t in parameters(params):
                t.grad = None
            phases[name] = {"iterations": state["it"] - it_start, "wall_s": time.perf_counter() - t_phase}

    if cfg.iterations > 0:
        run_phase("adam", _build_chunk, adam, cfg.iterations)
    if cfg.lbfgs_iterations > 0 and not stopped:
        # Second-phase full-batch L-BFGS: the standard accelerator once Adam
        # has found the basin.
        lbfgs = make_lbfgs(params)
        run_phase("lbfgs", _build_lbfgs_chunk, lbfgs, cfg.lbfgs_iterations)
        phases["lbfgs"].update(evaluations=lbfgs.evaluations, failed_searches=lbfgs.failed_searches,
                               unsafe_at=[cfg.iterations + c + 1 for c in lbfgs.unsafe_at])
        # Adam's state is stale at the params L-BFGS moved: a resume from the
        # final checkpoint restarts Adam with fresh moments
        opt_state = make_optimizer(cfg, params).state_dict

    if cfg.gn_iterations > 0 and not stopped:
        # Third-phase Gauss-Newton/LM on the residual vector, eagerly, after
        # the phases' graphs are freed; its result is copied into the same
        # parameter tensors
        t_phase = time.perf_counter()
        gn = gauss_newton(
            problem, params, data=data, iterations=cfg.gn_iterations, damping_init=cfg.gn_damping_init,
            solve=cfg.gn_solve, cg_tol=cfg.gn_cg_tol, cg_maxiter=cfg.gn_cg_maxiter, jac_chunk=cfg.gn_jac_chunk,
            verbose=verbose, log_every=max(1, cfg.log_every // 10), mesh=mesh,
        )
        with torch.no_grad():
            for t, new in zip(parameters(params), parameters(gn.params)):
                t.copy_(new)
        offset = state["it"]
        for i in range(len(gn.history.get("iteration", ()))):
            records.append({k: (offset + v[i] if k == "iteration" else float(v[i])) for k, v in gn.history.items()})
        state["it"] += gn.iterations_run
        state["aux"] = gn.final_aux
        damping = gn.history["damping"][-1] if gn.accepted else cfg.gn_damping_init
        phases["gn"] = {"iterations": gn.iterations_run, "wall_s": time.perf_counter() - t_phase,
                        "accepted": gn.accepted, "rejected": gn.iterations_run - gn.accepted,
                        "stopped": gn.stopped, "damping": float(damping)}
        # LM accepts only decreases, so its end supersedes a best snapshot it undercuts
        if gn.final_aux.get("loss", np.inf) < min_loss:
            best_params = None
            min_loss = gn.final_aux["loss"]
        opt_state = make_optimizer(cfg, params).state_dict
        if cfg.threshold is not None and gn.final_aux.get("loss", np.inf) < cfg.threshold:
            stopped = True

    it = state["it"]
    t_end = time.perf_counter()
    wall = t_end - t0
    t_warm, it_warm = state["t_warm"], state["it_warm"]
    if t_warm is not None and it > it_warm and t_end > t_warm:
        sps = (it - it_warm) / (t_end - t_warm)
    else:
        sps = it / wall if wall > 0 else float("nan")

    keys = sorted({k for r in records for k in r})
    history = {k: np.asarray([r.get(k, np.nan) for r in records]) for k in keys}
    if checkpointer is not None:
        checkpointer.save(it, params, opt_state())
        checkpointer.wait()
    return TrainResult(
        params=params,
        history=history,
        iterations_run=it,
        wall_time_s=wall,
        steps_per_sec=sps,
        stopped_early=stopped,
        best_params=best_params,
        final_aux=state["aux"],
        phases=phases,
        chunk_mode=chunk_mode,
    )
