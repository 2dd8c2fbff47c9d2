from hpvpinns_tpu_torch.config import Poisson1DConfig, Poisson2DConfig
from hpvpinns_tpu_torch.problems import poisson1d, poisson2d
from hpvpinns_tpu_torch.problems.base import Problem


def build(config, *, device=None) -> Problem:
    """Dispatch on config type (Poisson1DConfig, Poisson2DConfig).  The
    problem lives on `device`, by default the card (torch.device("cuda"));
    with no CUDA device, pass device="cpu"."""
    if isinstance(config, Poisson1DConfig):
        return poisson1d.build(config, device=device)
    if isinstance(config, Poisson2DConfig):
        return poisson2d.build(config, device=device)
    raise TypeError(f"unknown or not yet ported problem config type: {type(config).__name__}")
