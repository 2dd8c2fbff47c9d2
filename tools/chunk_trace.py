"""The program's chunk trace of a benchmark cell: the recorder of
hpvpinns_tpu_torch/utils/profiling.py over a cell's run, the four numbers
it gives, and what it says about the slow pace.

    python3 tools/chunk_trace.py run CELL [--seconds 25] [--seed N] [--out PATH]
        (on the card: one `--trace 1` run of the cell through
        bench_port/cell.py, a timed window of --seconds, with the recorder on
        in every rank from the build to the end; writes each rank's window
        chunks, graphs and the run's result to PATH, default
        chiprun_out/chunk_trace_<CELL>.json)
    python3 tools/chunk_trace.py overhead CELL [--pairs 12] [--seconds 1] [--seed N]
        (on the card: the cell's chunk built once, then rounds of windows of
        --seconds in turns: the recorder on, off, and on without the chunk
        events; prints each round's rates)
    python3 tools/chunk_trace.py report PATH...
        (anywhere: from the files `run` wrote, each rank's switch from the slow
        pace to the fast one, and before and after it the device µs a step
        inside chunks, between chunks and the host's launch µs a step; on a
        mesh each rank's chunk-launch lag behind the earliest rank)

The four numbers (`METRICS`) read the timed window's chunks alone:
`launch_us_per_step`, `chunk_gap_us_per_step`, `slow_pace_share` and
`graph_nodes_per_step`.  Each is None where the chunks ran eagerly (the
CPU, gloo), which record no device events.  A chunk's record in the files
is [n, launch start, launch end, device start, device end], host ns
(CLOCK_MONOTONIC, one clock for the ranks of a host).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SWITCH_MIN = 0.03  # a split whose two paces differ by less is no switch
SEED = 2**31 + 2026


def cell_chunk(name: str, seed: int, device):
    """The cell's chunk on one card, built as bench_port/cell.py::run_rank
    builds it: (chunk, members)."""
    import numpy as np
    import torch

    from bench_port import cell as cells
    from hpvpinns_tpu_torch import build
    from hpvpinns_tpu_torch.models.mlp import use_ieee_fp32_matmuls
    from hpvpinns_tpu_torch.training.ensemble import _build_ens_chunk
    from hpvpinns_tpu_torch.training.trainer import _build_chunk, make_optimizer

    cell = cells.load(name)
    fields, members = cell["config"]["program"]["fields"], cell["traffic"]["members"]
    use_ieee_fp32_matmuls()
    cfg = cells.program_config(cell)
    problem = build(cfg, device=device)
    for key, value in cells.reference_module(cell).inputs(fields, np.random.default_rng(seed)).items():
        problem.data[key] = torch.as_tensor(value, dtype=torch.float32).to(device)
    params = cells._params(cells.weights(fields["layers"], members, seed, device), members)
    build_chunk = _build_chunk if members == 1 else _build_ens_chunk
    return build_chunk(problem.loss_fn, make_optimizer(cfg.train, params), params, problem.data), members


class _WithRecords:
    """A rank's result queue that adds the recorder's records to the result."""

    def __init__(self, queue):
        self.queue = queue

    def put(self, item) -> None:
        from hpvpinns_tpu_torch.utils import profiling

        rank, out, err = item
        profiling.disable()
        if out is not None:
            out = {**out, "program": profiling.records()}
        self.queue.put((rank, out, err))


def recording_rank(rank, world, port, backend, device_type, cell, seed, seconds, trace, t0, stops, queue) -> None:
    """A mesh rank as bench_port/cell.py::rank_entry runs it, with the
    recorder on from before its build."""
    from bench_port import cell as cells
    from hpvpinns_tpu_torch.utils import profiling

    profiling.enable()
    cells.rank_entry(rank, world, port, backend, device_type, cell, seed, seconds, trace, t0, stops,
                     _WithRecords(queue))


def recorded_runs(cell: dict, seed: int, seconds: float, trace: bool, t0: float, device_type: str = "cuda",
                  backend: str = "nccl") -> list:
    """bench_port/cell.py::execute with the recorder on in every rank from
    its build to the end of its run: each rank's result gains `program`,
    the recorder's records()."""
    from bench_port import cell as cells
    from hpvpinns_tpu_torch.utils import profiling

    if cell["traffic"]["ranks"] > 1:
        return cells.execute(cell, seed, seconds, trace, t0, device_type, backend, target=recording_rank)
    profiling.enable()
    try:
        runs = cells.execute(cell, seed, seconds, trace, t0, device_type, backend)
    finally:
        profiling.disable()
    runs[0]["program"] = profiling.records()
    return runs


def window_chunks(run: dict):
    """The timed window's chunks of a recorded run (after the set-up's
    chunk(0) and FIRST_STEPS chunk(1) calls, before any profiled window's),
    each with its device interval on the host clock; None unless there are
    two or more and every one has device times."""
    from bench_port import cell as cells

    first = 1 + cells.FIRST_STEPS
    chunks = run["program"]["chunks"][first:first + run["window"]["chunks"]]
    if len(chunks) < 2 or any(c["device_ns"] is None for c in chunks):
        return None
    return chunks


def step_periods(chunks) -> list:
    """Each chunk's device period a step, ns: from its start event to the
    next chunk's, over its steps; the last chunk has no successor and no
    period."""
    return [(b["device_ns"][0] - a["device_ns"][0]) / a["n"] for a, b in zip(chunks, chunks[1:])]


def launch_us_per_step(run: dict):
    """Host µs a step of the chunk's graph launches: the mean `chunk.launch`
    span (the n step replays and the metrics replay as the host enqueues
    them, and the chunk's two events) over n.  The device runs a chunk while
    the host enqueues the rest of it, so this is the host's side of the
    step, not time the device waits."""
    chunks = window_chunks(run)
    if chunks is None:
        return None
    spans = run["program"]["spans"]
    return sum((spans[c["launch"]]["end_ns"] - spans[c["launch"]]["start_ns"]) / c["n"] for c in chunks) / len(chunks) / 1e3


def chunk_gap_us_per_step(run: dict):
    """Device µs a step between chunks: from each chunk's end event (after
    its metrics replay) to the next chunk's start event (before its first
    step replay), summed and divided by the steps of the chunks that have a
    successor.  The device runs nothing of the step there: the host reads
    the metrics (one small stack and copy) and launches the next chunk."""
    chunks = window_chunks(run)
    if chunks is None:
        return None
    gaps = sum(max(0.0, b["device_ns"][0] - a["device_ns"][1]) for a, b in zip(chunks, chunks[1:]))
    return gaps / sum(c["n"] for c in chunks[:-1]) / 1e3


SLOW_THRESHOLD = 0.04  # a run's paces lie 7-14% apart on the H100, its chunks within one pace ~4% at most


def slow_pace_share(run: dict):
    """The share (%) of the window's chunks whose device period a step
    exceeds the window's 10th-percentile period by more than
    SLOW_THRESHOLD.  A run slow from end to end reads near 0, as a fast one
    does: its slow pace is its own 10th percentile; the rate says which."""
    chunks = window_chunks(run)
    if chunks is None or len(chunks) < 3:
        return None
    periods = step_periods(chunks)
    p10 = statistics.quantiles(periods, n=10)[0]
    return 100.0 * sum(p > p10 * (1.0 + SLOW_THRESHOLD) for p in periods) / len(periods)


def graph_nodes_per_step(run: dict):
    """The nodes of the captured step graph (one optimizer step; an
    ensemble's step of every member): kernels, copies and sets, each one
    operation the device runs in every step, as torch.profiler sees them in
    a replay (chip_smoke.py phase 25 (a)).  The last step graph captured."""
    graphs = [g for g in run["program"]["graphs"] if g["name"] == "step"]
    return float(graphs[-1]["nodes"]) if graphs else None


METRICS = {f.__name__: f for f in (launch_us_per_step, chunk_gap_us_per_step, slow_pace_share, graph_nodes_per_step)}


def program_metrics(runs: list) -> dict:
    """The four numbers, the mean over the ranks as bench_port/cell.py's
    summarize takes a metric; a number no rank gives is left out."""
    out = {}
    for name, read in METRICS.items():
        values = [read(r) for r in runs]
        if all(v is not None for v in values):
            out[name] = sum(values) / len(values)
    return out


def compact(run: dict) -> list:
    spans = run["program"]["spans"]
    return [[c["n"], spans[c["launch"]]["start_ns"], spans[c["launch"]]["end_ns"], *c["device_ns"]]
            for c in window_chunks(run)]


def cmd_run(args) -> int:
    from bench_port import cell as cells

    cell = cells.load(args.cell)
    runs = recorded_runs(cell, args.seed, args.seconds, True, time.monotonic())
    result, lines = cells.summarize(cell, runs, True)
    result["program_metrics"] = program_metrics(runs)
    out = {"cell": args.cell, "seed": args.seed, "seconds": args.seconds, "result": result, "lines": lines,
           "ranks": [{"window": r["window"], "members": r["members"], "chunks": compact(r),
                      "graphs": r["program"]["graphs"], "anchors": r["program"]["anchors"],
                      "loads": [s for s in r["program"]["spans"] if s["name"] in ("kernels.load", "chunk.capture")]}
                     for r in runs]}
    path = Path(args.out or ROOT / "chiprun_out" / f"chunk_trace_{args.cell}.json")
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out))
    print(json.dumps(result))
    print(f"wrote {path}")
    return 0


def cmd_overhead(args) -> int:
    import torch

    from hpvpinns_tpu_torch.utils import profiling

    profiling.enable()  # captured as recorded_runs captures: the graphs count their replays
    chunk, members = cell_chunk(args.cell, args.seed, torch.device("cuda", 0))
    profiling.disable()
    n = 10

    def window(seconds):
        steps, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            aux = chunk(n)
            torch.stack([v.detach() for v in aux.values()]).tolist()
            steps += n
        return steps * members / (time.perf_counter() - t0)

    window(2.0)
    graphs = chunk.graphs
    rounds = []
    for i in range(args.pairs):
        rates = {}
        modes = ("on", "off", "spans")
        for mode in modes[i % 3:] + modes[: i % 3]:
            if mode != "off":
                profiling.enable()
            chunk.graphs = () if mode == "spans" else graphs  # spans: the recorder without the chunk events
            rates[mode] = window(args.seconds)
            profiling.disable()
            chunk.graphs = graphs
        profiling.records()
        rounds.append(rates)
        print(f"{args.cell} round {i}: " + ", ".join(f"{k} {v:.1f}" for k, v in rates.items())
              + f" net-steps/s (on/off {rates['on'] / rates['off']:.4f}, spans/off {rates['spans'] / rates['off']:.4f})",
              flush=True)
    ratios = [r["on"] / r["off"] for r in rounds]
    print(json.dumps({"cell": args.cell, "rounds": rounds, "median_on_over_off": statistics.median(ratios),
                      "median_spans_over_off": statistics.median(r["spans"] / r["off"] for r in rounds),
                      "on_slower_in": sum(x < 1 for x in ratios)}))
    return 0


def split(values: list) -> tuple:
    """The split of `values` into a first and a second run of at least a
    tenth each that leaves the least squared deviation from their two means:
    (index where the second starts, mean before, mean after)."""
    k0 = max(1, len(values) // 10)
    prefix = [0.0]
    prefix2 = [0.0]
    for v in values:
        prefix.append(prefix[-1] + v)
        prefix2.append(prefix2[-1] + v * v)
    total, total2, n = prefix[-1], prefix2[-1], len(values)
    best = None
    for k in range(k0, n - k0 + 1):
        a, b = prefix[k], total - prefix[k]
        sse = (prefix2[k] - a * a / k) + (total2 - prefix2[k] - b * b / (n - k))
        if best is None or sse < best[0]:
            best = (sse, k, a / k, b / (n - k))
    return best[1:]


def segment(chunks: list) -> dict:
    """Means a step over `chunks` (each with a successor): device µs inside
    the chunk, device µs from its end to the next start, host launch µs, and
    the device period."""
    steps = sum(c[0] for c, _ in chunks)
    return {"chunks": len(chunks),
            "inside_us": sum(c[4] - c[3] for c, _ in chunks) / steps / 1e3,
            "gap_us": sum(max(0.0, d[3] - c[4]) for c, d in chunks) / steps / 1e3,
            "launch_us": sum(c[2] - c[1] for c, _ in chunks) / steps / 1e3,
            "period_us": sum(d[3] - c[3] for c, d in chunks) / steps / 1e3}


def rank_report(rank: dict) -> dict:
    w = rank["window"]
    chunks = rank["chunks"][-w["chunks"]:]
    pairs = list(zip(chunks, chunks[1:]))
    periods = [(d[3] - c[3]) / c[0] for c, d in pairs]
    k, before, after = split(periods)
    switched = before / after - 1 >= SWITCH_MIN
    t0 = chunks[0][1]
    device_span = (chunks[-1][3] - chunks[0][3]) + (chunks[-1][4] - chunks[-1][3])
    out = {"window_s": w["host_window_s"], "device_over_host": device_span / 1e9 / w["host_window_s"],
           "whole": segment(pairs), "switch_s": (chunks[k][1] - t0) / 1e9 if switched else None,
           "paces_us": [before / 1e3, after / 1e3]}
    if switched:
        out["before"], out["after"] = segment(pairs[:k]), segment(pairs[k:])
    return out


def cmd_report(args) -> int:
    for path in args.paths:
        doc = json.loads(Path(path).read_text())
        print(f"== {doc['cell']} seed {doc['seed']}, {doc['seconds']} s window")
        print("   metrics: " + ", ".join(f"{k} {v['value']:.4g}" for k, v in doc["result"]["metrics"].items()))
        print("   the recorder's: " + ", ".join(f"{k} {v:.4g}" for k, v in doc["result"].get("program_metrics", {}).items()))
        reports = [rank_report(r) for r in doc["ranks"]]
        for i, (rank, rep) in enumerate(zip(doc["ranks"], reports)):
            print(f"   rank {i}: window {rep['window_s']:.3f} s, device periods / host window "
                  f"{rep['device_over_host']:.5f}, graphs " + ", ".join(
                      f"{g['name']} {g['kernel_nodes']} kernel nodes ({g['launches']}) x {g['replays']}"
                      for g in rank["graphs"]))
            sw = "none" if rep["switch_s"] is None else f"{rep['switch_s']:.2f} s"
            print(f"     switch {sw}; paces {rep['paces_us'][0]:.2f} -> {rep['paces_us'][1]:.2f} µs a step")
            for part in ("before", "after", "whole"):
                if part in rep:
                    s = rep[part]
                    print(f"     {part:6s} {s['chunks']:5d} chunks: inside {s['inside_us']:.2f}, gap {s['gap_us']:.2f}, "
                          f"period {s['period_us']:.2f}, launch {s['launch_us']:.2f} µs a step")
            for s in rank["loads"]:
                print(f"     {s['name']} {s['attrs']}: {(s['end_ns'] - s['start_ns']) / 1e6:.1f} ms")
        if len(doc["ranks"]) > 1:
            windows = [r["chunks"][-r["window"]["chunks"]:] for r in doc["ranks"]]
            m = min(len(w) for w in windows)
            for col, what in ((1, "launch"), (3, "device start")):
                lags = [[w[k][col] - min(v[k][col] for v in windows) for k in range(m)] for w in windows]
                print(f"   {what} lag behind the earliest rank, µs (median / p90 / max): " + "; ".join(
                    f"rank {i} {statistics.median(x) / 1e3:.1f} / {statistics.quantiles(x, n=10)[-1] / 1e3:.1f} / "
                    f"{max(x) / 1e3:.1f}" for i, x in enumerate(lags)))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="command", required=True)
    run = sub.add_parser("run")
    run.add_argument("cell")
    run.add_argument("--seconds", type=float, default=25.0)
    run.add_argument("--seed", type=int, default=SEED)
    run.add_argument("--out")
    over = sub.add_parser("overhead")
    over.add_argument("cell")
    over.add_argument("--pairs", type=int, default=12)
    over.add_argument("--seconds", type=float, default=1.0)
    over.add_argument("--seed", type=int, default=SEED)
    rep = sub.add_parser("report")
    rep.add_argument("paths", nargs="+")
    args = parser.parse_args(argv)
    return {"run": cmd_run, "overhead": cmd_overhead, "report": cmd_report}[args.command](args)


if __name__ == "__main__":
    sys.exit(main())
