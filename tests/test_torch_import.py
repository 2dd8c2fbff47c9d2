"""The PyTorch port imports neither JAX, optax, orbax nor the JAX package (nor
matplotlib, which sweep.plot_sweep and viz.py import when a plot is drawn):
the machine with the GPU has none of them.  Checked in a fresh interpreter, since this
test process has JAX loaded already (tests/conftest.py)."""

import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent


# The public functions of hpvpinns_tpu/inverse.py and uncertainty.py, which
# the port's modules of the same names carry under the same names.
INVERSE = ("legendre_field", "fit_epsilon_field", "fit_coefficient_fields", "als_identify", "reduced_identify",
           "reduced_identify2d", "reduced_identify_field", "reduced_identify_burgers", "fit_epsilon_field2d",
           "als_identify2d", "reduced_identify_kovasznay", "reduced_identify_taylorgreen",
           "reduced_identify_helmholtz")
UQ = ("lstsq_covariance", "legendre_field_band", "reduced_scalar_ci", "reduced_scalar_ci2d", "profile_eps_ci2d",
      "reduced_field_ci", "als_bootstrap", "reduced_ns_ci", "reduced_ns_unsteady_ci", "reduced_helmholtz_ci")


def test_port_imports_no_jax():
    code = (
        f"INVERSE, UQ = {INVERSE!r}, {UQ!r}\n"
        "import importlib, pkgutil, sys, hpvpinns_tpu_torch, chip_smoke, tools.draw_parity\n"
        "import hpvpinns_tpu_torch.ops.fused_fields, hpvpinns_tpu_torch.training.trainer, hpvpinns_tpu_torch.utils.profiling\n"
        "import hpvpinns_tpu_torch.ops.derivatives, hpvpinns_tpu_torch.ops.fields, hpvpinns_tpu_torch.problems.advdiff\n"
        "import hpvpinns_tpu_torch.problems.poisson3d, hpvpinns_tpu_torch.problems.advdiff2d, hpvpinns_tpu_torch.training.lbfgs\n"
        "names = [m.name for m in pkgutil.walk_packages(hpvpinns_tpu_torch.__path__, 'hpvpinns_tpu_torch.')]\n"
        "for name in names: importlib.import_module(name)\n"
        "new = ('problems.advdiff', 'ops.fields', 'problems.poisson3d', 'problems.advdiff2d', 'training.lbfgs',\n"
        "       'problems.helmholtz', 'problems.burgers', 'training.gauss_newton', 'training.hybrid',\n"
        "       'training.checkpoint', 'problems.kovasznay', 'problems.taylorgreen', 'adaptive', 'sweep', 'galerkin',\n"
        "       'training.ensemble', 'training.timemarch', 'inverse', 'uncertainty', 'utils.records', 'serving',\n"
        "       'viz', 'cli', '__main__', 'parallel', 'parallel.sharding', 'parallel.distributed',\n"
        "       'parallel.multihost_check', 'parallel.dryrun')\n"
        "assert all(hasattr(hpvpinns_tpu_torch, n) for n in ('KovasznayConfig', 'TaylorGreenConfig', 'kovasznay_quality',\n"
        "           'kovasznay_precision', 'taylorgreen_quality', 'taylorgreen_precision', 'per_element_rel_l2',\n"
        "           'train_ensemble', 'EnsembleResult', 'time_march', 'TimeMarchResult', '__version__',\n"
        "           'inverse', 'uncertainty', 'save_model', 'load_model'))\n"
        "from hpvpinns_tpu_torch import inverse, uncertainty\n"
        "assert all(callable(getattr(inverse, n)) for n in INVERSE) and all(callable(getattr(uncertainty, n)) for n in UQ)\n"
        "assert all('hpvpinns_tpu_torch.' + n in names for n in new), names\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'orbax', 'hpvpinns_tpu', 'matplotlib'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_draw_parity_runs_without_jax():
    """tools/draw_parity.py, the card's half of the draw parity, run as a
    script (its verdict over the committed results) loads no JAX."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['tools/draw_parity.py', '--verdict']\n"
        "runpy.run_path('tools/draw_parity.py', run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'orbax', 'hpvpinns_tpu'))\n"
        "print('VERDICT DONE', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "VERDICT DONE []" in proc.stdout, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", ["sharding", "distributed", "multihost_check"])
def test_parallel_modules_keep_jax_names(module):
    """hpvpinns_tpu_torch.parallel exports the JAX package's four names, and
    every public function of a JAX parallel module has its counterpart of
    the same name whose leading parameters are JAX's, in JAX's order."""
    import importlib
    import inspect

    import hpvpinns_tpu.parallel as jpar
    import hpvpinns_tpu_torch.parallel as tpar

    names = sorted(n for n in vars(jpar) if not n.startswith("_") and callable(getattr(jpar, n)))
    assert names == ["element_mesh", "pad_elements", "replicate", "shard_problem"]
    assert all(callable(getattr(tpar, n)) for n in names)
    jmod = importlib.import_module(f"hpvpinns_tpu.parallel.{module}")
    tmod = importlib.import_module(f"hpvpinns_tpu_torch.parallel.{module}")
    public = [n for n, f in vars(jmod).items() if inspect.isfunction(f) and f.__module__ == jmod.__name__
              and not n.startswith("_")]
    assert public
    for n in public:
        jp = list(inspect.signature(getattr(jmod, n)).parameters)
        assert list(inspect.signature(getattr(tmod, n)).parameters)[:len(jp)] == jp, n
    for n in ("AXIS", "POINT_AXIS"):
        assert getattr(tmod, n, None) == getattr(jmod, n, None), n


@pytest.mark.parametrize("module,names", [("inverse", INVERSE), ("uncertainty", UQ)])
def test_inverse_suite_has_jax_names_and_signatures(module, names):
    """The port's inverse.py and uncertainty.py carry every public function
    of the JAX modules of the same names, with the same parameters and
    defaults."""
    import importlib
    import inspect

    jmod = importlib.import_module(f"hpvpinns_tpu.{module}")
    tmod = importlib.import_module(f"hpvpinns_tpu_torch.{module}")
    public = sorted(n for n, f in vars(jmod).items()
                    if inspect.isfunction(f) and f.__module__ == jmod.__name__ and not n.startswith("_"))
    assert public == sorted(names)
    for n in names:
        assert inspect.signature(getattr(tmod, n)) == inspect.signature(getattr(jmod, n)), n
