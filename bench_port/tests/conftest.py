"""The benchmark's own tests: `pytest bench_port/tests` from the root of the
repository.  Tests marked `card` need a CUDA card and skip without one; on
a machine with a card `pytest bench_port/tests -m card` runs them alone."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """cuda:0, or a skip where the machine has no CUDA card: decided when
    the test runs, never when the module is imported."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the control reads TF32 products, which only a card computes")
    return torch.device("cuda", 0)
