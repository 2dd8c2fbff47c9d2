"""One run of one cell: the set-up, the first three steps, the timed (or
traced) window, and the comparison with the plain reference.

A cell is found by its name: BENCHMARK.json gives its configuration and its
traffic, `configs/<config>.json` the configuration (the program's config
class and fields, and the reference module that follows it),
`traffic/<traffic>.json` how it trains (the fields' engine, the members of
a seed ensemble, the ranks of an element mesh, the traced window's length)
and `workloads/<cell>.json` the limits of its comparison.

The timed path is the program's own Adam chunk (`_build_chunk`, or
`_build_ens_chunk` for an ensemble): one captured step replayed n times
and the metrics once, then one host read of the metrics, as `train()`'s
`run_phase` drives it.  Set-up builds that chunk once and drives it through
its first three steps (chunk(0), then chunk(1) three times); the window
goes on with the same object.  The program gets from here only its inputs:
the weights, drawn on the device from the seed, and the boundary data.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import socket
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
from torch import nn

from bench_port import check
from bench_port import trace as tracing

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FIRST_STEPS = 3
BETA1 = 0.9  # the program's Adam: its first moment after one step is (1 - BETA1) g
BANNED = ("jax", "jaxlib", "flax", "hpvpinns_tpu")
RANK_TIMEOUT_S = 330


def load(workload: str, root: Path = ROOT) -> dict:
    """The cell `workload` with its configuration, traffic, limits and the
    metrics it reports (name -> unit), as the files give them."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in manifest["configs"]}

    def metrics(kind):
        return {m["name"]: m["unit"] for m in manifest[kind] if workload in m.get("workloads", [workload])}

    return {
        "name": workload,
        "chips": cell["chips"],
        "config": json.loads((root / configs[cell["config"]]["file"]).read_text()),
        "traffic": json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads((BENCH / "workloads" / f"{workload}.json").read_text())["limits"],
        "end_to_end": metrics("end_to_end"),
        "per_layer": metrics("per_layer"),
    }


def reference_module(cell: dict):
    return importlib.import_module(f"bench_port.reference.{cell['config']['reference']}")


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def program_config(cell: dict):
    """The program's config object: its class and fields from the
    configuration's file, the fields' engine from the traffic."""
    from hpvpinns_tpu_torch import config as port

    program = cell["config"]["program"]
    fields = {k: _tuples(v) for k, v in program["fields"].items()}
    return getattr(port, program["class"])(**fields, deriv_mode=cell["traffic"]["deriv_mode"],
                                           train=port.TrainConfig(**program["train"]))


def weights(layers, members: int, seed: int, device) -> list:
    """[(W [members, in, out], b [members, out])]: Xavier-normal weights and
    0.1-normal biases, from one draw of a generator on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    pairs = list(zip(layers[:-1], layers[1:]))
    draw = torch.randn((members, sum(a * b + b for a, b in pairs)), generator=gen, device=device)
    out, at = [], 0
    for a, b in pairs:
        W = draw[:, at:at + a * b].reshape(members, a, b) * math.sqrt(2.0 / (a + b))
        bias = 0.1 * draw[:, at + a * b:at + a * b + b]
        out.append((W.contiguous(), bias.contiguous()))
        at += a * b + b
    return out


def _params(w, members: int) -> dict:
    pick = (lambda t: t[0]) if members == 1 else (lambda t: t)
    return {"net": [{"W": nn.Parameter(pick(W).clone()), "b": nn.Parameter(pick(b).clone())} for W, b in w],
            "pde": {}}


def _host(aux: dict) -> dict:
    """The metrics on the host in one sync, as run_phase reads them."""
    keys = list(aux)
    return dict(zip(keys, torch.stack([aux[k].detach() for k in keys]).tolist()))


def _members(value, members: int) -> list:
    return [value] if members == 1 else list(value)


def _window(chunk, n: int, seconds: float, stop, root: bool) -> dict:
    """Chunks of n steps, each followed by one host read, until `seconds`
    have passed; on a mesh (`stop`, shared by the ranks) until the chunk
    that rank 0 names there once its time is up: one chunk past the one it
    has read, which no rank can have read before rank 0 launched it."""
    steps = chunks = bad = 0
    t0 = time.perf_counter()
    ends = []
    while True:
        loss = _host(chunk(n))["loss"]
        steps, chunks = steps + n, chunks + 1
        ends.append(time.perf_counter() - t0)
        if not all(math.isfinite(v) for v in np.ravel(loss)):
            bad += n
        if stop is None:
            if time.perf_counter() - t0 >= seconds:
                break
            continue
        if root and stop.value < 0 and time.perf_counter() - t0 >= seconds:
            stop.value = chunks + 1
        if 0 <= stop.value <= chunks:
            break
    seconds_in = [int(t) for t in ends]
    by_second = [n * seconds_in.count(i) for i in range(int(ends[-1]) + 1)]
    return {"steps": steps, "chunks": chunks, "bad": bad, "host_window_s": time.perf_counter() - t0,
            "steps_by_second": by_second}


def banned_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(BANNED))


def run_rank(cell: dict, seed: int, seconds: float, trace: bool, device, t0: float, mesh=None, stops=None,
             reference: bool = True) -> dict:
    """One process's run: the program's readings of its first steps, the
    timed window and (with `trace`) a traced one after it, the peak memory,
    and (with `reference`) the reference's readings; plain numbers only.
    On a mesh `stops` holds the windows' shared ends (see _window)."""
    from hpvpinns_tpu_torch import build
    from hpvpinns_tpu_torch.models.mlp import use_ieee_fp32_matmuls
    from hpvpinns_tpu_torch.parallel.sharding import replicate, shard_problem
    from hpvpinns_tpu_torch.problems.base import map_params, parameters
    from hpvpinns_tpu_torch.training.ensemble import _build_ens_chunk
    from hpvpinns_tpu_torch.training.trainer import _build_chunk, make_optimizer

    phases = {"imported": time.monotonic() - t0}
    ref = reference_module(cell)
    fields, traffic = cell["config"]["program"]["fields"], cell["traffic"]
    members, ranks = traffic["members"], traffic["ranks"]
    on_card = torch.device(device).type == "cuda"
    use_ieee_fp32_matmuls()
    cfg = program_config(cell)
    given = ref.inputs(fields, np.random.default_rng(seed))
    problem = build(cfg, device=device)
    for key, value in given.items():
        problem.data[key] = torch.as_tensor(value, dtype=torch.float32).to(device)
    w = weights(fields["layers"], members, seed, device)
    w_host = [(W.double().cpu(), b.double().cpu()) for W, b in w]
    params, data = _params(w, members), problem.data
    del w
    if mesh is not None:
        data = shard_problem(data, mesh)
        params = map_params(nn.Parameter, replicate(params, mesh))
    phases["built"] = time.monotonic() - t0
    opt = make_optimizer(cfg.train, params)
    build_chunk = _build_chunk if members == 1 else _build_ens_chunk
    chunk = build_chunk(problem.loss_fn, opt, params, data, mesh=mesh)
    leaves = parameters(params)
    phases["captured"] = time.monotonic() - t0

    start = [t.detach().double().cpu() for t in leaves]
    losses = [_host(chunk(0))["loss"]]
    for step in range(FIRST_STEPS):
        losses.append(_host(chunk(1))["loss"])
        if step == 0:
            first = [opt.state[t].get("exp_avg", torch.zeros_like(t)).double().cpu() / (1.0 - BETA1) for t in leaves]
    change = [t.detach().double().cpu() - s for t, s in zip(leaves, start)]
    readings = [{"loss": [_members(v, members)[s] for v in losses],
                 "grad": check.norms(_members(g, members)[s] for g in first),
                 "change": check.norms(_members(c, members)[s] for c in change)} for s in range(members)]
    if mesh is not None:
        torch.distributed.barrier()
    setup_s = time.monotonic() - t0

    n, root = cfg.train.check_every, mesh is None or mesh.is_root
    stops = stops or (None, None)
    window, traced = _window(chunk, n, seconds, stops[0], root), None
    if trace:  # a second, shorter window under the profiler, after the timed one
        with tracing.profile() as prof:
            with tracing.window_span():
                traced = _window(chunk, n, traffic["trace_seconds"], stops[1], root)
        traced.update(tracing.reduce(prof))
        del prof
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    del chunk, opt, params, data, problem, leaves
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    expected = reference_readings(cell, w_host, given, device) if reference else None
    return {
        "readings": readings, "reference": expected, "setup_s": setup_s, "window": window, "trace": traced,
        "net_steps": window["steps"] * members, "peak": peak, "members": members, "ranks": ranks,
        "shapes": ref.shapes(fields, ranks), "device": torch.cuda.get_device_name(device) if on_card else "cpu",
        "banned": banned_modules(), "phases": phases,
    }


def reference_readings(cell: dict, w_host, given: dict, device, dtype=torch.float64, half: bool = False) -> list:
    """The reference's readings of its first steps for every member, from
    the same weights (float64 host copies) and inputs, in `dtype`."""
    ref = reference_module(cell)
    fields = cell["config"]["program"]["fields"]
    prob = ref.build(fields, given["xb"], dtype=dtype, device=device)
    out = []
    for s in range(cell["traffic"]["members"]):
        layers = [(W[s].to(device=device, dtype=dtype), b[s].to(device=device, dtype=dtype)) for W, b in w_host]
        r = ref.adam_readings(prob, layers, cell["config"]["program"]["train"]["learning_rate"], FIRST_STEPS,
                              half=half)
        out.append({"loss": r["loss"], "grad": check.norms(r["grad"]), "change": check.norms(r["change"])})
    return out


def rank_entry(rank: int, world: int, port: int, backend: str, device_type: str, cell: dict, seed: int,
               seconds: float, trace: bool, t0: float, stops, queue) -> None:
    """A rank of the mesh: joins the NCCL (or gloo) world on localhost,
    runs its shard, and puts (rank, result, error) on `queue`."""
    from hpvpinns_tpu_torch.parallel import distributed
    from hpvpinns_tpu_torch.parallel.sharding import element_mesh

    try:
        device = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
        distributed.initialize(f"localhost:{port}", world, rank, backend=backend, device=device)
        mesh = element_mesh(device=device, backend=backend)
        out = run_rank(cell, seed, seconds, trace, device, t0, mesh=mesh, stops=stops, reference=rank == 0)
        queue.put((rank, out, None))
    except Exception:  # the launcher reports it and ends the other ranks
        queue.put((rank, None, traceback.format_exc()))
    finally:
        distributed.shutdown()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def execute(cell: dict, seed: int, seconds: float, trace: bool, t0: float, device_type: str = "cuda",
            backend: str = "nccl", target=rank_entry) -> list:
    """The cell's run: in this process for one rank, else one spawned
    process a rank; the ranks' results in rank order."""
    ranks = cell["traffic"]["ranks"]
    if ranks == 1:
        device = torch.device("cuda", 0) if device_type == "cuda" else torch.device("cpu")
        return [run_rank(cell, seed, seconds, trace, device, t0)]
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    stops, queue = (ctx.Value("q", -1), ctx.Value("q", -1)), ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=target, args=(r, ranks, port, backend, device_type, cell, seed, seconds, trace,
                                              t0, stops, queue)) for r in range(ranks)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        deadline = time.monotonic() + RANK_TIMEOUT_S
        while len(results) + len(errors) < ranks:
            rank, out, err = queue.get(timeout=max(1.0, deadline - time.monotonic()))
            if err is not None:
                errors.append(f"rank {rank}:\n{err}")
                break
            results[rank] = out
    finally:
        for p in procs:
            p.join(timeout=60 if not errors else 5)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    if errors or len(results) < ranks:
        raise RuntimeError("mesh run failed: " + ("\n".join(errors) or f"{ranks - len(results)} ranks gave nothing"))
    return [results[r] for r in range(ranks)]


def reader(name: str):
    """The module of metric `name`: bench_port/metrics/<name>.py (a name
    may hold dots, so it is loaded from its path)."""
    spec = importlib.util.spec_from_file_location(f"bench_port.metrics._{name.replace('.', '_')}",
                                                  BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def summarize(cell: dict, runs: list, trace: bool) -> tuple:
    """(the result line's object without `device`'s power limit, the lines
    of the compared numbers): the metrics the cell reports in this mode,
    the correctness verdict against every rank's and every member's
    readings, the breakdown of rank 0's trace."""
    lead = runs[0]
    views = []
    for r in runs:
        view = {"setup_s": r["setup_s"], "window_s": r["window"]["host_window_s"], "net_steps": r["net_steps"],
                "steps": r["window"]["steps"],
                "members": r["members"], "ranks": r["ranks"], "chips": cell["chips"], "shapes": r["shapes"],
                "trace": None}
        if r["trace"] is not None:
            view["trace"] = {**r["trace"], "net_steps": r["trace"]["steps"] * r["members"]}
        views.append(view)
    metrics = {}
    if trace:
        for name, unit in cell["per_layer"].items():
            values = [reader(name).read(v) for v in views]
            if all(v is not None for v in values):
                metrics[name] = {"value": sum(values) / len(values), "unit": unit}
    else:
        for name, unit in cell["end_to_end"].items():
            metrics[name] = {"value": reader(name).read(views[0]), "unit": unit}

    pairs = [(p, e) for r in runs for p, e in zip(r["readings"], lead["reference"])]
    numbers = check.worst(pairs)
    failed = lead["window"]["bad"] * lead["members"]  # a non-finite loss in a chunk fails its steps
    correct = check.verdict(numbers, cell["limits"]) and failed == 0
    device = {"platform": "gpu" if lead["device"] != "cpu" else "cpu", "kind": lead["device"], "count": cell["chips"],
              "memory_peak_bytes": max(r["peak"] for r in runs)}
    result = {"correct": correct, "attempted": lead["net_steps"], "failed": failed, "metrics": metrics,
              "device": device}
    if trace:
        device["busy_s"] = sum(r["trace"]["busy_us"] for r in runs) / len(runs) * 1e-6
        device["window_s"] = sum(r["trace"]["window_us"] for r in runs) / len(runs) * 1e-6
        result["breakdown"] = {"device_ops": lead["trace"]["device_ops"], "idle_gaps": lead["trace"]["idle_gaps"]}
    result["checks"] = {k: {"value": numbers[k], "limit": cell["limits"][k]} for k in check.NUMBERS}
    lines = [f"check {k}: {numbers[k]!r} (limit {cell['limits'][k]!r})" for k in check.NUMBERS]
    lines.insert(0, "steps in each second of the timed window: " + " ".join(map(str, lead["window"]["steps_by_second"])))
    lines.insert(0, "set-up, s from the start to: " + ", ".join(f"{k} {v:.2f}" for k, v in lead["phases"].items()))
    lines.append(f"check failed_steps: {failed} (limit 0)")
    return result, lines
