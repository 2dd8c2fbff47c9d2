"""Model FLOPs and bytes of the fields and of a training step, from shapes,
and the published peaks of the card they are measured against.

The fields are a tanh MLP's value and its first derivatives in `n_dirs`
directions (and with `second` the pure second derivatives): 1 + n_dirs
streams (1 + 2 n_dirs with `second`) through every layer.  A
multiply-add is 2 FLOPs; activations and their derivatives are not counted.
The backward of the fields is twice their forward (a gradient of the input
and one of the weights for every product), and nothing is counted for a
forward that an implementation replays or recomputes, so a kernel that
replays and one that stashes do the same counted work.
"""

from __future__ import annotations

# NVIDIA H100 SXM, data sheet, dense: fp32 outside the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12
FLOAT_BYTES = 4


def streams(n_dirs: int, second: bool) -> int:
    return 1 + n_dirs * (2 if second else 1)


def n_params(layers) -> int:
    return sum(a * b + b for a, b in zip(layers[:-1], layers[1:]))


def fields_fwd(layers, points: int, n_dirs: int, second: bool) -> tuple:
    """(FLOPs, bytes) of the fields at `points` points: every stream through
    every layer; X, the network and the fields moved once."""
    s = streams(n_dirs, second)
    macs = sum(a * b for a, b in zip(layers[:-1], layers[1:]))
    moved = points * layers[0] + n_params(layers) + points * s
    return 2.0 * points * s * macs, float(FLOAT_BYTES * moved)


def fields_bwd(layers, points: int, n_dirs: int, second: bool) -> tuple:
    """(FLOPs, bytes) of the fields' VJP with respect to the network: twice
    the forward's FLOPs; X, the cotangent of every field and the network
    read once, the gradient written once."""
    flops, _ = fields_fwd(layers, points, n_dirs, second)
    moved = points * layers[0] + points * streams(n_dirs, second) + 2 * n_params(layers)
    return 2.0 * flops, float(FLOAT_BYTES * moved)


def step_flops(layers, points: int, n_dirs: int, second: bool) -> float:
    """Model FLOPs of one network's training step: the fields' forward and
    their backward."""
    return 3.0 * fields_fwd(layers, points, n_dirs, second)[0]


def bound_s(flops: float, moved: float) -> float:
    """The least time the card could take: the larger of the FLOPs over the
    fp32 peak and the bytes over the HBM bandwidth."""
    return max(flops / PEAK_FP32_FLOPS, moved / PEAK_HBM_BYTES_PER_S)
