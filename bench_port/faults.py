"""Faults planted under the timed path: the tests run a cell with each and
see `correct` come out false, and `control.py --fault` reads them on the
chip.  Each is a context manager that patches the program where the fault
would sit and restores it on leaving."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def unchanged_state():
    """Every optimizer step returns the state it was given."""
    import torch

    step = torch.optim.Adam.step
    torch.optim.Adam.step = lambda self, closure=None: None
    try:
        yield
    finally:
        torch.optim.Adam.step = step


@contextlib.contextmanager
def half_batch():
    """The weak-form loss over the first half of the elements only, the
    mean taken over them (their sum doubled)."""
    from hpvpinns_tpu_torch.problems import poisson2d

    whole = poisson2d.variational_loss
    poisson2d.variational_loss = lambda res, mask, n_test: 2.0 * whole(*(t[: t.shape[0] // 2] for t in (res, mask, n_test)))
    try:
        yield
    finally:
        poisson2d.variational_loss = whole


@contextlib.contextmanager
def no_exchange():
    """The all-reduce of the loss and the gradients between the ranks left
    out: every rank steps on its own share."""
    from hpvpinns_tpu_torch.training import trainer

    exchange = trainer.allreduce_grads
    trainer.allreduce_grads = lambda leaves, axis, extra=(): None
    try:
        yield
    finally:
        trainer.allreduce_grads = exchange


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch, "no_exchange": no_exchange}


def rank_with(fault: str, *args) -> None:
    """A mesh rank (bench_port/cell.py::rank_entry) with `fault` planted."""
    from bench_port import cell

    with FAULTS[fault]():
        cell.rank_entry(*args)
