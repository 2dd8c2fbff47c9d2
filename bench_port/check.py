"""The comparison that decides `correct`: what the timed path did in its
first three Adam steps against the plain reference's three steps from the
same weights and data.

Readings, for each network (a member of an ensemble, or the one network;
on a mesh every rank's):

  loss    the loss at the start and after each of the three steps
  grad    each leaf's norm of the first gradient as the optimizer got it
  change  each leaf's norm of its change over the three steps

Numbers compared, each the worst over the networks:

  loss_gap    max over the four losses of |program - reference| / |reference|
  grad_gap    max over the leaves of |program - reference|, over the larger
              of that leaf's reference norm and the median leaf's
  change_gap  as grad_gap, over the leaves whose first reference gradient is
              at least a thousandth of the median leaf's (leaves moved by
              Adam's round-off alone are left out by this rule, not by name)
"""

from __future__ import annotations

import math
import statistics

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
NEGLIGIBLE_GRAD = 1e-3


def norms(leaves) -> list:
    """The float64 norm of every leaf (torch tensors)."""
    return [float(t.double().norm()) for t in leaves]


def _largest(values) -> float:
    """The largest value; infinity where any is not finite (a NaN fails)."""
    values = list(values)
    return max(values) if all(math.isfinite(v) for v in values) else math.inf


def _worst_leaf(prog, ref, keep) -> float:
    scale = statistics.median(ref[i] for i in keep)
    return _largest(abs(prog[i] - ref[i]) / max(ref[i], scale) for i in keep)


def gaps(prog: dict, ref: dict) -> dict:
    """The numbers for one network, from its readings (dicts of `loss`,
    `grad`, `change` as lists of floats) and the reference's."""
    loss = _largest(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    every = range(len(ref["grad"]))
    floor = NEGLIGIBLE_GRAD * statistics.median(ref["grad"])
    moved = [i for i in every if ref["grad"][i] >= floor]
    return {"loss_gap": loss, "grad_gap": _worst_leaf(prog["grad"], ref["grad"], every),
            "change_gap": _worst_leaf(prog["change"], ref["change"], moved)}


def worst(pairs) -> dict:
    """The numbers over several networks: [(program readings, reference
    readings)] -> each number's worst."""
    each = [gaps(p, r) for p, r in pairs]
    return {k: _largest(g[k] for g in each) for k in NUMBERS}


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in NUMBERS)
