"""The harness on the CPU at tiny sizes: a dry run loads neither JAX nor
the JAX package, the measurement path refuses a machine with no card, each
fault a cell can have turns `correct` false under the cell's own limits,
and BENCHMARK.json names only files and readers that exist."""

import functools
import importlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest

from bench_port import cell as cells
from bench_port import faults
from bench_port.tests.tiny import tiny_cell

ROOT = Path(cells.__file__).resolve().parent.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

DRY_RUN = """
import json, sys, time
sys.path.insert(0, {root!r})
from bench_port import cell as cells
from bench_port.tests.tiny import tiny_cell
if __name__ == "__main__":
    seen = set()
    for workload, ranks, trace in (("p2d_scaled.pallas", None, 0), ("p2d_scaled.ens4", None, 1), ("p2d_e256.mesh4", 2, 0)):
        c = tiny_cell(workload, ranks)
        runs = cells.execute(c, 2**31 + 11, 0.2, bool(trace), time.monotonic(), device_type="cpu", backend="gloo")
        cells.summarize(c, runs, bool(trace))
        seen.update(*(r["banned"] for r in runs))
    seen.update(cells.banned_modules())
    print(json.dumps({{"banned": sorted(seen), "port": "hpvpinns_tpu_torch" in sys.modules}}))
"""


def test_a_dry_run_loads_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", DRY_RUN.format(root=str(ROOT))], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen == {"banned": [], "port": True}


def test_the_banned_names_are_compared_whole():
    assert "hpvpinns_tpu_torch" not in cells.BANNED
    sys.modules.setdefault("hpvpinns_tpu_torch", importlib.import_module("hpvpinns_tpu_torch"))
    assert "hpvpinns_tpu_torch" not in cells.banned_modules()


def test_without_a_card_the_measurement_path_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "p2d_scaled.pallas", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
    assert "CUDA cards" in out.stderr


CASES = [(w, f) for w in ("p2d_scaled.pallas", "p2d_scaled.ens4", "p2d_scaled.taylor")
         for f in (None, "unchanged_state", "half_batch")]
CASES += [("p2d_e256.mesh4", f) for f in (None, "unchanged_state", "half_batch", "no_exchange")]


@pytest.mark.parametrize("workload,fault", CASES)
def test_each_fault_turns_correct_false(workload, fault):
    """The cell's own limits, its path cut to a tiny size, a planted fault
    (None: a sound run, which has to pass)."""
    c = tiny_cell(workload, 2 if workload.endswith("mesh4") else None)
    kw = dict(device_type="cpu", backend="gloo")
    if c["traffic"]["ranks"] > 1:
        target = cells.rank_entry if fault is None else functools.partial(faults.rank_with, fault)
        runs = cells.execute(c, 77, 0.2, False, time.monotonic(), target=target, **kw)
    elif fault is None:
        runs = cells.execute(c, 77, 0.2, False, time.monotonic(), **kw)
    else:
        with faults.FAULTS[fault]():
            runs = cells.execute(c, 77, 0.2, False, time.monotonic(), **kw)
    result, lines = cells.summarize(c, runs, False)
    assert result["correct"] is (fault is None), result["checks"]
    assert list(result)[-1] == "checks" and [l.split(":")[0] for l in lines[-4:]] == [
        "check loss_gap", "check grad_gap", "check change_gap", "check failed_steps"]


def test_the_manifest_names_files_and_readers_that_exist():
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert manifest["paths"] == ["bench_port"] and manifest["command"][1] == "bench_port/run.py"
    configs = {c["name"]: c for c in manifest["configs"]}
    for c in configs.values():
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file() and c["file"].startswith("bench_port/")
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    cells_ = manifest["workloads"]
    assert sum(w["chips"] == 4 for w in cells_) <= max(1, len(cells_) // 4)
    for w in cells_:
        assert NAME.match(w["name"]) and w["config"] in configs and len(w["why"]) <= 200
        assert (ROOT / "bench_port/traffic" / f"{w['traffic']}.json").is_file()
        assert set(json.loads((ROOT / "bench_port/workloads" / f"{w['name']}.json").read_text())["limits"]) == {
            "loss_gap", "grad_gap", "change_gap"}
    assert {w["config"] for w in cells_} == set(configs)
    names = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert callable(cells.reader(m["name"]).read)
        assert set(m.get("workloads", [])) <= {w["name"] for w in cells_}
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in manifest["per_layer"]:
        assert m["moves"] in {e["name"] for e in manifest["end_to_end"]}
    for w in cells_:  # every cell reports setup_s, another end-to-end metric and a per-layer one
        loaded = cells.load(w["name"])
        assert "setup_s" in loaded["end_to_end"] and len(loaded["end_to_end"]) >= 2 and loaded["per_layer"]
