"""The PyTorch port imports neither JAX, optax, orbax nor the JAX package (nor
matplotlib, which sweep.plot_sweep imports when it is called): the
machine with the GPU has none of them.  Checked in a fresh interpreter, since this
test process has JAX loaded already (tests/conftest.py)."""

import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys, hpvpinns_tpu_torch, chip_smoke\n"
        "import hpvpinns_tpu_torch.ops.fused_fields, hpvpinns_tpu_torch.training.trainer, hpvpinns_tpu_torch.utils.profiling\n"
        "import hpvpinns_tpu_torch.ops.derivatives, hpvpinns_tpu_torch.ops.fields, hpvpinns_tpu_torch.problems.advdiff\n"
        "import hpvpinns_tpu_torch.problems.poisson3d, hpvpinns_tpu_torch.problems.advdiff2d, hpvpinns_tpu_torch.training.lbfgs\n"
        "names = [m.name for m in pkgutil.walk_packages(hpvpinns_tpu_torch.__path__, 'hpvpinns_tpu_torch.')]\n"
        "for name in names: importlib.import_module(name)\n"
        "new = ('problems.advdiff', 'ops.fields', 'problems.poisson3d', 'problems.advdiff2d', 'training.lbfgs',\n"
        "       'problems.helmholtz', 'problems.burgers', 'training.gauss_newton', 'training.hybrid',\n"
        "       'training.checkpoint', 'problems.kovasznay', 'problems.taylorgreen', 'adaptive', 'sweep', 'galerkin')\n"
        "assert all(hasattr(hpvpinns_tpu_torch, n) for n in ('KovasznayConfig', 'TaylorGreenConfig', 'kovasznay_quality',\n"
        "           'kovasznay_precision', 'taylorgreen_quality', 'taylorgreen_precision', 'per_element_rel_l2'))\n"
        "assert all('hpvpinns_tpu_torch.' + n in names for n in new), names\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'orbax', 'hpvpinns_tpu', 'matplotlib'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
