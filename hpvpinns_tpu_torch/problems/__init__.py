from hpvpinns_tpu_torch.config import (
    AdvDiff2DConfig,
    AdvDiffConfig,
    BurgersConfig,
    Helmholtz2DConfig,
    KovasznayConfig,
    Poisson1DConfig,
    Poisson2DConfig,
    Poisson3DConfig,
    TaylorGreenConfig,
)
from hpvpinns_tpu_torch.problems import (
    advdiff, advdiff2d, burgers, helmholtz, kovasznay, poisson1d, poisson2d, poisson3d, taylorgreen,
)
from hpvpinns_tpu_torch.problems.base import Problem

_BUILDERS = (
    (Poisson1DConfig, poisson1d.build),
    (Poisson2DConfig, poisson2d.build),
    (Poisson3DConfig, poisson3d.build),
    (Helmholtz2DConfig, helmholtz.build),
    (AdvDiffConfig, advdiff.build),
    (AdvDiff2DConfig, advdiff2d.build),
    (BurgersConfig, burgers.build),
    (KovasznayConfig, kovasznay.build),
    (TaylorGreenConfig, taylorgreen.build),
)


def build(config, *, device=None) -> Problem:
    """Dispatch on config type (Poisson1DConfig, Poisson2DConfig,
    Poisson3DConfig, Helmholtz2DConfig, AdvDiffConfig, AdvDiff2DConfig,
    BurgersConfig, KovasznayConfig, TaylorGreenConfig).  The problem lives on `device`, by default the card
    (torch.device("cuda")); with no CUDA device, pass device="cpu"."""
    for cls, build_fn in _BUILDERS:
        if isinstance(config, cls):
            return build_fn(config, device=device)
    raise TypeError(f"unknown or not yet ported problem config type: {type(config).__name__}")
