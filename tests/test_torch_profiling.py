"""The program's recorder (hpvpinns_tpu_torch/utils/profiling.py) on the
CPU: off it records nothing; on, the stepwise chunk of a tiny Poisson-2D
records its spans, `train` its phases, chunks and reads; the Chrome-trace
export nests; the two-anchor clock mapping, and the chunk events resolved
through it against a device clock that drifts (CUDA events stood in for);
tools/chunk_trace.py's four numbers of the recorder on a synthetic run and on
a recorded CPU run of a benchmark cell, where they are None."""

import json
import time

import pytest

torch = pytest.importorskip("torch")

import hpvpinns_tpu_torch as tv  # noqa: E402
from bench_port import cell as cells  # noqa: E402
from bench_port.tests.tiny import tiny_cell  # noqa: E402
from hpvpinns_tpu_torch.training.trainer import _build_stepwise_chunk, make_optimizer  # noqa: E402
from hpvpinns_tpu_torch.utils import profiling  # noqa: E402
from tools import chunk_trace  # noqa: E402

NUMBERS = ("launch_us_per_step", "chunk_gap_us_per_step", "slow_pace_share", "graph_nodes_per_step")


def tiny_config(**train):
    kw = {"iterations": 4, "lbfgs_iterations": 0, "check_every": 2, **train}
    return tv.Poisson2DConfig(n_elements_x=2, n_elements_y=2, n_quad=6, n_test_x=3, n_test_y=3, layers=(2, 8, 8, 1),
                              dtype="float64", train=tv.TrainConfig(**kw))


@pytest.fixture
def recorder():
    """The recorder, switched off and emptied again after the test."""
    yield profiling
    profiling.disable()
    profiling.RECORDER.clear()


def stepwise_chunk():
    cfg = tiny_config()
    prob = tv.build(cfg, device="cpu")
    params = prob.init_params(torch.Generator().manual_seed(0))
    return _build_stepwise_chunk(prob.loss_fn, make_optimizer(cfg.train, params), params, prob.data)


def by_name(rec, name):
    return [s for s in rec["spans"] if s["name"] == name]


def test_off_the_recorder_records_nothing_and_returns_the_shared_no_op(recorder):
    assert not recorder.enabled()
    with recorder.span("chunk", n=3) as s:
        s.set(extra=1)
    assert recorder.span("anything") is recorder.NULL and s is recorder.NULL
    stepwise_chunk()(2)
    assert recorder.records() == {"spans": [], "chunks": [], "graphs": [], "anchors": []}


def test_on_a_chunk_records_its_span_with_the_launch_nested_and_self_times(recorder):
    chunk = stepwise_chunk()
    recorder.enable()
    with recorder.span("outer", tag="x"):
        for n in (1, 2, 3):
            chunk(n)
    recorder.disable()
    chunk(1)  # off again: not recorded
    rec = recorder.records()
    outer, = by_name(rec, "outer")
    chunks, launches = by_name(rec, "chunk"), by_name(rec, "chunk.launch")
    assert [s["attrs"] for s in chunks] == [{"n": 1}, {"n": 2}, {"n": 3}] and len(launches) == 3
    assert [c["n"] for c in rec["chunks"]] == [1, 2, 3] and all(c["device_ns"] is None for c in rec["chunks"])
    index = {id(s): i for i, s in enumerate(rec["spans"])}
    for c, s, child in zip(rec["chunks"], chunks, launches):
        assert rec["spans"][c["span"]] is s and rec["spans"][c["launch"]] is child
        assert s["parent"] == index[id(outer)] and child["parent"] == c["span"]
        assert s["start_ns"] <= child["start_ns"] <= child["end_ns"] <= s["end_ns"]
        assert s["self_ns"] == (s["end_ns"] - s["start_ns"]) - (child["end_ns"] - child["start_ns"])
        assert child["self_ns"] == child["end_ns"] - child["start_ns"]
    assert outer["attrs"] == {"tag": "x"}
    assert outer["self_ns"] == outer["end_ns"] - outer["start_ns"] - sum(s["end_ns"] - s["start_ns"] for s in chunks)


def test_train_records_its_phase_chunks_and_reads(recorder):
    cfg = tiny_config(iterations=6, lbfgs_iterations=2)
    prob = tv.build(cfg, device="cpu")
    recorder.enable()
    tv.train(prob, cfg.train, verbose=False)
    rec = recorder.records()
    phases = by_name(rec, "phase")
    assert [p["attrs"]["name"] for p in phases] == ["adam", "lbfgs"]
    index = {id(s): i for i, s in enumerate(rec["spans"])}
    for phase, want in zip(phases, ([2, 2, 2], [2])):
        mine = [s for s in rec["spans"] if s["parent"] == index[id(phase)]]
        assert [s["name"] for s in mine] == ["chunk", "chunk.read"] * len(want)
        assert [s["attrs"]["n"] for s in mine if s["name"] == "chunk"] == want
        for a, b in zip(mine, mine[1:]):
            assert a["end_ns"] <= b["start_ns"]
    assert rec["graphs"] == [] and rec["anchors"] == []  # the CPU captures nothing


def test_export_chrome_loads_as_json_with_each_span_inside_its_parent(recorder, tmp_path):
    chunk = stepwise_chunk()
    recorder.enable()
    with recorder.span("phase", name="adam"):
        for n in (2, 2):
            chunk(n)
            with recorder.span("chunk.read"):
                pass
    recorder.disable()
    path = tmp_path / "trace.json"
    written = recorder.export_chrome(str(path))
    doc = json.loads(path.read_text())
    spans = {e["args"]["id"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert len(spans) == len(written["spans"]) == 7
    assert sorted(e["name"] for e in spans.values()) == sorted(["phase"] + ["chunk", "chunk.launch", "chunk.read"] * 2)
    for e in spans.values():
        parent = e["args"]["parent"]
        assert (parent is None) == (e["name"] == "phase")
        if parent is not None:
            p = spans[parent]
            assert p["tid"] == e["tid"] and p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"] + 1e-3
    assert doc["otherData"]["graphs"] == [] and min(e["ts"] for e in spans.values()) == 0.0


def test_map_clock_is_the_line_through_the_two_anchors():
    anchors = ((1_000_000.0, 0.0), (11_000_100.0, 10.0))  # the device's ms run 1e-5 short of the host's
    assert profiling.map_clock(0.0, anchors) == 1_000_000.0
    assert profiling.map_clock(10.0, anchors) == 11_000_100.0
    assert profiling.map_clock(5.0, anchors) == pytest.approx(6_000_050.0, abs=1e-6)
    shifted = ((500.0, 2.0), (2_500.0, 4.0))  # anchors need not start at device time 0
    assert profiling.map_clock(3.0, shifted) == pytest.approx(1_500.0) and profiling.map_clock(1.0, shifted) == -500.0


class FakeEvent:
    """A CUDA event on a device whose clock runs 3e-4 fast against the
    host's and starts far from it; recorded, it completes at once."""

    def __init__(self, enable_timing=True):
        self.ms = None

    def record(self, stream=None):
        self.ms = (time.perf_counter_ns() * (1 + 3e-4)) / 1e6 + 12_345.0

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_chunk_events_resolve_onto_the_host_clock_through_both_anchors(recorder, monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(recorder.RECORDER, "_stream_now", lambda: None)
    recorder.enable()
    host = []
    for n in (10, 10, 10, 10):
        recorder.RECORDER.chunk_begin(n, events=True)
        host.append(time.perf_counter_ns())
        time.sleep(0.002)
        host.append(time.perf_counter_ns())
        recorder.RECORDER.chunk_end()
    rec = recorder.records()
    assert len(rec["anchors"]) == 1 and len(rec["chunks"]) == 4
    for i, c in enumerate(rec["chunks"]):
        launch = rec["spans"][c["launch"]]
        start, end = c["device_ns"]
        # each event is recorded just outside the host times taken inside the launch span
        assert launch["start_ns"] - 20e3 <= start <= host[2 * i] + 20e3
        assert host[2 * i + 1] - 20e3 <= end <= launch["end_ns"] + 20e3
    assert len(recorder.RECORDER._pool) >= 8  # resolved events go back to the pool
    recorder.RECORDER.chunk_begin(10, events=True)  # a recording after records() anchors anew
    recorder.RECORDER.chunk_end()
    assert len(recorder.records()["anchors"]) == 2


def summary(periods_us, busy_us, n=10, launch_us=50.0, setup=4, after=2):
    """A recorded run: `setup` set-up chunks, then the window's chunks with
    device periods `periods_us` (one fewer than the chunks: the last has
    none) and `busy_us` of device time each, then `after` chunks of a
    profiled window, and the step graph's counters."""
    spans, chunks = [], []
    starts = [0.0]
    for p in periods_us:
        starts.append(starts[-1] + p)
    ahead = [-1e6 + k * 1e5 for k in range(setup)]
    behind = [starts[-1] + 1e6 + k * 1e5 for k in range(after)]
    for i, start in enumerate(ahead + starts + behind):
        n_i = n if i >= setup else 1
        spans.append({"name": "chunk", "start_ns": start * 1e3 - 100, "end_ns": start * 1e3 + launch_us * 1e3})
        spans.append({"name": "chunk.launch", "start_ns": start * 1e3 - 50, "end_ns": start * 1e3 + launch_us * 1e3})
        chunks.append({"n": n_i, "span": 2 * i, "launch": 2 * i + 1,
                       "device_ns": [start * 1e3, (start + busy_us) * 1e3]})
    graphs = [{"name": "step", "nodes": 150, "kernel_nodes": 143, "launches": {"B1": 1, "B2": 1, "block_sum": 1},
               "replays": 100}, {"name": "metrics", "nodes": 40, "kernel_nodes": 39, "launches": {}, "replays": 10}]
    return {"program": {"spans": spans, "chunks": chunks, "graphs": graphs, "anchors": []},
            "window": {"chunks": len(starts)}}


def test_the_four_numbers_of_the_recorder_on_a_synthetic_run():
    read = chunk_trace.METRICS
    assert sorted(read) == sorted(NUMBERS)
    fast, slow = 2_700.0, 3_000.0  # µs a chunk of 10: 270 and 300 µs a step
    run = summary([slow] * 3 + [fast] * 7, busy_us=2_600.0, launch_us=150.0)
    assert [c["n"] for c in chunk_trace.window_chunks(run)] == [10] * 11  # neither set-up nor the profiled window
    assert read["launch_us_per_step"](run) == pytest.approx(15.0 + 0.05 / 10)
    # gaps: slow periods leave 400 µs, fast ones 100, over the 10 chunks with successors (100 steps)
    assert read["chunk_gap_us_per_step"](run) == pytest.approx((3 * 400 + 7 * 100) / 100)
    assert read["slow_pace_share"](run) == pytest.approx(30.0)
    assert read["graph_nodes_per_step"](run) == 150.0  # every node: kernels, copies and sets
    rank = {"window": {**run["window"], "host_window_s": 0.0285}, "chunks": chunk_trace.compact(run)}
    report = chunk_trace.rank_report(rank)  # the slow pace found, and split before and after its switch
    assert report["paces_us"] == pytest.approx([300.0, 270.0]) and report["switch_s"] == pytest.approx(9e-3)
    assert report["before"]["chunks"] == 3 and report["after"]["gap_us"] == pytest.approx(10.0)
    within = summary([fast * (1 + 0.01 * (k % 3)) for k in range(12)], busy_us=2_600.0)
    assert read["slow_pace_share"](within) == 0.0  # 2% within one pace is under the threshold
    assert chunk_trace.program_metrics([run, within])["slow_pace_share"] == pytest.approx(15.0)
    no_events = summary([fast] * 5, busy_us=2_600.0)
    for c in no_events["program"]["chunks"]:
        c["device_ns"] = None
    no_events["program"]["graphs"] = []
    assert all(read[name](no_events) is None for name in NUMBERS)
    assert chunk_trace.program_metrics([run, no_events]) == {}


@pytest.mark.parametrize("workload, ranks, traced", [("p2d_scaled.pallas", None, True), ("p2d_e256.mesh4", 2, False)])
def test_a_recorded_cpu_run_keeps_the_window_s_chunks_and_gives_none_of_the_four(recorder, workload, ranks, traced):
    c = tiny_cell(workload, ranks)
    runs = chunk_trace.recorded_runs(c, 2**31 + 5, 0.2, traced, time.monotonic(), device_type="cpu", backend="gloo")
    assert len(runs) == (ranks or 1) and not recorder.enabled()
    for run in runs:  # on a mesh each rank records in its own process
        program, window = run["program"], run["window"]
        after = run["trace"]["chunks"] if traced else 0
        assert [x["n"] for x in program["chunks"]] == [0, 1, 1, 1] + [10] * (window["chunks"] + after)
        assert len(by_name(program, "chunk.launch")) == len(program["chunks"])
        assert all(chunk_trace.METRICS[name](run) is None for name in NUMBERS)
    result, _ = cells.summarize(c, runs, traced)
    assert result["correct"] and chunk_trace.program_metrics(runs) == {}
