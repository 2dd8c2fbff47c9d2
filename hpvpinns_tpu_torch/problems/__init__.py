from hpvpinns_tpu_torch.config import Poisson2DConfig
from hpvpinns_tpu_torch.problems import poisson2d
from hpvpinns_tpu_torch.problems.base import Problem


def build(config, device=None) -> Problem:
    """Dispatch on config type (only Poisson2DConfig is ported so far)."""
    if isinstance(config, Poisson2DConfig):
        return poisson2d.build(config, device=device)
    raise TypeError(f"unknown or not yet ported problem config type: {type(config).__name__}")
