from hpvpinns_tpu_torch.config import AdvDiff2DConfig, AdvDiffConfig, Poisson1DConfig, Poisson2DConfig, Poisson3DConfig
from hpvpinns_tpu_torch.problems import advdiff, advdiff2d, poisson1d, poisson2d, poisson3d
from hpvpinns_tpu_torch.problems.base import Problem


def build(config, *, device=None) -> Problem:
    """Dispatch on config type (Poisson1DConfig, Poisson2DConfig,
    Poisson3DConfig, AdvDiffConfig, AdvDiff2DConfig).  The problem lives on `device`, by default the card
    (torch.device("cuda")); with no CUDA device, pass device="cpu"."""
    if isinstance(config, Poisson1DConfig):
        return poisson1d.build(config, device=device)
    if isinstance(config, Poisson2DConfig):
        return poisson2d.build(config, device=device)
    if isinstance(config, Poisson3DConfig):
        return poisson3d.build(config, device=device)
    if isinstance(config, AdvDiffConfig):
        return advdiff.build(config, device=device)
    if isinstance(config, AdvDiff2DConfig):
        return advdiff2d.build(config, device=device)
    raise TypeError(f"unknown or not yet ported problem config type: {type(config).__name__}")
