"""The port's command line (hpvpinns_tpu_torch/cli.py and __main__.py)
against the JAX package's, on the CPU (--device cpu), at tiny sizes.

(i) The argparse trees are the same, subcommand by subcommand (option
strings, dests, defaults, choices, nargs, consts, types), but for --device,
which every subcommand that builds a problem or loads an artifact adds, and
`run`'s --trace-out (the recorder of utils/profiling.py).
(ii) `presets` prints what JAX's prints.  (iii) `_config_from_args` gives
JAX's config over a table of argv.  (iv) From the same float64 record, a few
Adam steps in each CLI give the same summary keys and rel_l2, max_abs_err
and final_loss to 1e-10.  (v) Every other subcommand runs at a tiny size
and prints the JSON keys of JAX's command (read off hpvpinns_tpu/cli.py);
--mesh raises the trainer's NotImplementedError; with no CUDA device and no
--device, a run raises.
"""

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hpvpinns_tpu import cli as jcli  # noqa: E402
from hpvpinns_tpu_torch import cli as tcli  # noqa: E402
from test_torch_parity import one_torch_thread  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]
TIGHT = dict(rtol=1e-10, atol=1e-13)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    with one_torch_thread():
        yield


def subparsers(parser, path=()):
    """{path: parser} over the whole subcommand tree."""
    out = {path: parser}
    for a in parser._actions:
        if isinstance(a, argparse._SubParsersAction):
            for name, sub in a.choices.items():
                out.update(subparsers(sub, path + (name,)))
    return out


def describe(action):
    if isinstance(action, argparse._SubParsersAction):
        return ("subcommands", action.dest, action.required, tuple(action.choices))
    return (tuple(action.option_strings), action.dest, repr(action.default),
            None if action.choices is None else tuple(action.choices), action.nargs, repr(action.const),
            action.required, getattr(action.type, "__name__", action.type), type(action).__name__)


JAX_TREE = subparsers(jcli.build_parser())
# The subcommands that build a problem or load an artifact take --device.
WITH_DEVICE = [p for p in JAX_TREE if p[:1] in (("serve",), ("adapt",), ("march",), ("identify",), ("sweep",))
               or len(p) == 2 and p[0] == "run"]


@pytest.mark.parametrize("path", list(JAX_TREE), ids=lambda p: "-".join(p) or "root")
def test_parser_matches_jax_but_for_device(path):
    port = subparsers(tcli.build_parser())
    assert sorted(port) == sorted(JAX_TREE)
    want = [describe(a) for a in JAX_TREE[path]._actions]
    got = [describe(a) for a in port[path]._actions]
    extra = [d for d in got if d not in want]
    assert [d for d in got if d in want] == want
    if path in WITH_DEVICE:
        trace_out = [(("--trace-out",), "trace_out", "None", None, None, "None", False, None, "_StoreAction")]
        assert extra == (trace_out if path[0] == "run" else []) + [
            (("--device",), "device", "None", None, None, "None", False, None, "_StoreAction")]
    else:
        assert extra == []
    assert port[path].prog.replace("hpvpinns_tpu_torch", "hpvpinns_tpu") == JAX_TREE[path].prog


def test_presets_print_what_jax_prints(capsys):
    assert jcli.cmd_presets() == 0
    want = capsys.readouterr().out
    assert tcli.main(["presets"]) == 0
    assert capsys.readouterr().out == want and want.count("== ") == 28


# argv for both CLIs' _config_from_args (the port's with --device cpu too):
# each tier, --forward, --hard-bc with quality, the grids, --layers,
# --var-form 2c, the train keys and march's use of the same plumbing.
ARGV = [
    "run poisson1d",
    "run poisson1d --preset quality",
    "run poisson1d --preset precision --iterations 50",
    "run poisson1d --grid=-1,-0.1,0.1,1 --n-test 4 --layers 1,8,1 --var-form 2 --lbfgs-iterations 7",
    "run poisson2d --preset quality --hard-bc",
    "run poisson2d --var-form 2c --grid-x=-1,0,1 --scheme PINNs --n-test-x 4",
    "run poisson3d --preset quality --hard-bc",
    "run advdiff --forward --iterations 5",
    "run advdiff --preset precision --forward",
    "run advdiff --preset precision --epsilon-model quadratic --identify-velocity --velocity-model linear",
    "run advdiff2d --identify-velocity --checkpoint-dir ckpt --checkpoint-every 5 --gn-cg-tol 1e-4 --gn-cg-maxiter 9",
    "run burgers --preset quality --front-feature --n-strong 10 --strong-window=-0.1,0.1",
    "run helmholtz2d --inverse --k-sq-init 70 --activation sin --dtype float64 --matmul-precision high",
    "run kovasznay --preset precision --eq-weights 1,6,1 --gn-solve qr --gn-jac-chunk 64",
    "run taylorgreen --no-bc-pressure --p-zero-mean 2.0 --learning-rate 1e-4 --seed 3 --threshold 1e-6",
    "march burgers --slabs 2 --preset quality --n-elements-t 2 --hard-bc --layers 2,8,1",
    "march taylorgreen --slabs 3 --n-test-y 3 --gn-iterations 2 --dtype float64",
]


@pytest.mark.parametrize("argv", ARGV)
def test_config_from_args_matches_jax(argv):
    jargs = jcli.build_parser().parse_args(argv.split())
    targs = tcli.build_parser().parse_args(argv.split() + CPU)
    assert dataclasses.asdict(tcli._config_from_args(targs)) == dataclasses.asdict(jcli._config_from_args(jargs))


def summaries(out: str) -> list:
    """The JSON lines of a command's stdout."""
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def test_same_draw_same_summary_in_both_clis(tmp_path, capsys):
    """JAX's CLI writes a float64 --record-params record of Poisson-1D; both
    CLIs then take 20 Adam steps from it (--init-record)."""
    base = ("run poisson1d --grid=-1,-0.2,0.3,1 --n-quad 12 --n-test 5 --layers 1,8,8,1 --dtype float64 "
            "--lbfgs-iterations 0 --quiet").split()
    assert jcli.main(base + ["--iterations", "5", "--record", f"{tmp_path}/rec", "--record-params"]) == 0
    capsys.readouterr()
    warm = base + ["--iterations", "20", "--init-record", f"{tmp_path}/rec.npz"]
    assert jcli.main(warm) == 0
    want = summaries(capsys.readouterr().out)[0]
    assert tcli.main(warm + CPU) == 0
    got = summaries(capsys.readouterr().out)[0]
    assert sorted(got) == sorted(want)
    assert got["problem"] == want["problem"] and got["iterations"] == want["iterations"] == 20
    for key in ("rel_l2", "max_abs_err", "final_loss"):
        np.testing.assert_allclose(got[key], want[key], err_msg=key, **TIGHT)


RUN = ("problem", "iterations", "wall_time_s", "steps_per_sec", "final_loss", "rel_l2", "max_abs_err", "mean_abs_err")
P1D = "run poisson1d --iterations 10 --lbfgs-iterations 0 --n-quad 10 --n-test 4 --layers 1,6,1 --quiet".split()


def test_run_export_serve(tmp_path, capsys):
    art = str(tmp_path / "art")
    assert tcli.main(P1D + ["--export", art, "--record", f"{tmp_path}/rec"] + CPU) == 0
    run, record, export = summaries(capsys.readouterr().out)
    assert sorted(run) == sorted(RUN) and record == {"record": [f"{tmp_path}/rec.npz", f"{tmp_path}/rec.mat"]}
    assert export == {"export": art, "platforms": ["cpu", "cuda"], "n_params": 19, "dtype": "float32"}
    assert tcli.main(["serve", art, "--check", "--out", str(tmp_path / "pred.npz")] + CPU) == 0
    (served,) = summaries(capsys.readouterr().out)
    assert sorted(served) == sorted(("artifact", "problem", "platforms", "n_params", "d_in", "n_out", "dtype",
                                     "n_points", "wall_s", "rel_l2", "out"))
    assert served["problem"] == "poisson1d" and served["n_points"] > 0
    np.testing.assert_allclose(served["rel_l2"], run["rel_l2"], rtol=1e-6)
    with np.load(tmp_path / "pred.npz") as z:
        assert z["Y"].shape == (served["n_points"], 1)


def test_run_seeds(capsys):
    argv = "run poisson2d --seeds 2 --iterations 10 --lbfgs-iterations 0 --n-quad 5 --n-test-x 3 --n-test-y 3 " \
           "--layers 2,6,1 --quiet"
    assert tcli.main(argv.split() + CPU) == 0
    (out,) = summaries(capsys.readouterr().out)
    assert sorted(out) == sorted(("problem", "seeds", "iterations", "wall_time_s", "steps_per_sec",
                                  "seed_steps_per_sec", "rel_l2_min", "rel_l2_median", "rel_l2_max", "best_seed",
                                  "per_seed"))
    assert [m["seed"] for m in out["per_seed"]] == [0, 1] and out["iterations"] == 10


def test_identify_advdiff(capsys):
    assert tcli.main(["identify", "advdiff"] + CPU) == 0
    (out,) = summaries(capsys.readouterr().out)
    assert sorted(out) == sorted(("problem", "method", "epsilon", "eps_coef", "n_forward_solves", "misfit",
                                  "epsilon_true", "epsilon_rel_err", "wall_time_s"))
    assert out["epsilon_rel_err"] < 1e-6


def test_adapt_march_sweep(tmp_path, capsys):
    small = "--iterations 10 --lbfgs-iterations 0".split()
    assert tcli.main(["adapt", "poisson1d", "--rounds", "2", "--n-quad", "10", "--n-test", "4",
                      "--outdir", str(tmp_path / "adapt")] + small + CPU) == 0
    (out,) = summaries(capsys.readouterr().out)
    assert sorted(out) == ["n_elem_trajectory", "record", "rel_l2_trajectory"] and out["n_elem_trajectory"][0] == 1
    assert tcli.main(["march", "burgers", "--slabs", "2", "--n-test-x", "3", "--n-test-t", "3", "--layers", "2,6,1",
                      "--plots", "--outdir", str(tmp_path / "march"), "--quiet"] + small + CPU) == 0
    out, plots = summaries(capsys.readouterr().out)
    assert sorted(out) == sorted(("problem", "command", "slabs", "ic", "warm_start", "budget_weights", "edges",
                                  "wall_time_s", "per_slab", "rel_l2", "max_abs_err", "mean_abs_err"))
    assert out["edges"] == [0.0, 0.5, 1.0] and plots == {"plots": [str(tmp_path / "march" / "march.png")]}
    assert tcli.main(["sweep", "poisson1d", "--axis", "h", "--values", "1,2", "--n-quad", "10",
                      "--outdir", str(tmp_path / "sweep")] + small + CPU) == 0
    sweep, record = summaries(capsys.readouterr().out)
    assert [r["n_elements"] for r in sweep["sweep"]] == [1, 2]
    assert record == {"record": str(tmp_path / "sweep" / "h_sweep.json")}


def test_python_m_presets_in_a_subprocess(capsys):
    """`python -m hpvpinns_tpu_torch presets` (__main__.py) prints JAX's
    presets and imports no JAX."""
    code = ("import runpy, sys; sys.argv = ['hpvpinns_tpu_torch', 'presets']\n"
            "try:\n    runpy.run_module('hpvpinns_tpu_torch', run_name='__main__')\n"
            "except SystemExit as e:\n    assert e.code == 0, e.code\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'hpvpinns_tpu.')) for m in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    jcli.cmd_presets()
    assert proc.stdout == capsys.readouterr().out


def test_mesh_raises_until_multi_device(capsys):
    """--mesh on `run` and `march` alone: a one-rank element mesh (gloo on
    the CPU), whose summary equals the run without it (one rank's
    all-reduce is a copy)."""
    march = "march burgers --slabs 2 --iterations 1 --quiet".split()
    with one_torch_thread():
        for argv in (P1D, march):
            assert tcli.main(argv + ["--mesh"] + CPU) == 0
            meshed = json.loads(capsys.readouterr().out.splitlines()[0])
            assert tcli.main(argv + CPU) == 0
            plain = json.loads(capsys.readouterr().out.splitlines()[0])
            meshed.pop("wall_time_s"), plain.pop("wall_time_s")
            meshed.pop("steps_per_sec", None), plain.pop("steps_per_sec", None)
            assert meshed == plain


def test_run_needs_the_card_or_device_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(P1D)
