"""The PyTorch port imports neither JAX, optax nor the JAX package: the
machine with the GPU has no JAX.  Checked in a fresh interpreter, since this
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
        "names = [m.name for m in pkgutil.walk_packages(hpvpinns_tpu_torch.__path__, 'hpvpinns_tpu_torch.')]\n"
        "for name in names: importlib.import_module(name)\n"
        "assert 'hpvpinns_tpu_torch.problems.advdiff' in names and 'hpvpinns_tpu_torch.ops.fields' in names, names\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'hpvpinns_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
