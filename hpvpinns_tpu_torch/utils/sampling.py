"""Training-point samplers (numpy, host).

Counterpart of hpvpinns_tpu/utils/sampling.py: classic Latin-hypercube
sampling on a caller-supplied numpy Generator, so the same seed gives the
same points in both packages.
"""

from __future__ import annotations

import numpy as np


def latin_hypercube(n_dims: int, n_samples: int, rng: np.random.Generator) -> np.ndarray:
    """LHS on the unit hypercube: [n_samples, n_dims] in (0, 1)."""
    u = rng.uniform(size=(n_samples, n_dims))
    out = np.empty((n_samples, n_dims))
    for d in range(n_dims):
        perm = rng.permutation(n_samples)
        out[:, d] = (perm + u[:, d]) / n_samples
    return out


def lhs_interval(lo, hi, n_samples: int, rng: np.random.Generator) -> np.ndarray:
    """LHS column vector on [lo, hi): shape [n_samples, 1]."""
    return lo + (hi - lo) * latin_hypercube(1, n_samples, rng)


def lhs_box(bounds, n_samples: int, rng: np.random.Generator) -> np.ndarray:
    """LHS on a box given [(lo, hi), ...] per dimension: [n_samples, len(bounds)]."""
    unit = latin_hypercube(len(bounds), n_samples, rng)
    lo = np.asarray([b[0] for b in bounds])
    hi = np.asarray([b[1] for b in bounds])
    return lo + (hi - lo) * unit
