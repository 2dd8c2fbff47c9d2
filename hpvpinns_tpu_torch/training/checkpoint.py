"""Checkpoint and resume with torch.save.

Counterpart of hpvpinns_tpu/training/checkpoint.py (Orbax there): the
params, the optimizer state and the step, one directory `step_<8 digits>`
per checkpoint, holding one `checkpoint.pt`.  Orbax's on-disk format is not
read (a difference by design).  Everything is copied to the host when
`save` is called, so a background write (`use_async`) never reads a tensor
that training goes on to change.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any, Optional

import torch

from hpvpinns_tpu_torch.problems.base import map_params, parameters

_FILE = "checkpoint.pt"


def _to_host(tree):
    """A copy of `tree` (dicts, lists, tuples) with every tensor on the host."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


class Checkpointer:
    """save/restore {params, opt_state} keyed by step.

    `keep_last` bounds disk use: older step directories are deleted after
    each save (0 keeps everything).  `use_async=True` takes the host copies
    at `save` and writes them on a background thread; `wait()` (called
    before `restore` and by the trainer at the end of a run) waits for it.
    A checkpoint is written under a temporary name and renamed when
    complete, so only finished ones are listed."""

    def __init__(self, directory: str, keep_last: int = 3, use_async: bool = False):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep_last = keep_last
        self.use_async = use_async
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def _write(self, step: int, tree) -> None:
        tmp = self._path(step) + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(tree, os.path.join(tmp, _FILE))
        shutil.rmtree(self._path(step), ignore_errors=True)  # an earlier save of this step
        os.replace(tmp, self._path(step))

    def _write_in_background(self, step: int, tree) -> None:
        try:
            self._write(step, tree)
        except Exception as err:  # raised again by wait()
            self._error = err

    def save(self, step: int, params: Any, opt_state: Any) -> None:
        tree = {"params": _to_host(params), "opt_state": _to_host(opt_state), "step": int(step)}
        if not self.use_async:
            self._write(step, tree)
            if self.keep_last:
                self._prune()
            return
        self.wait()
        if self.keep_last:
            # prune before the write (the new directory appears only when it
            # is complete), keeping room for `step`, which it may replace
            self._prune(keep=self.keep_last - 1, replaced=step)
        self._thread = threading.Thread(target=self._write_in_background, args=(step, tree), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Wait for the background write, and raise what it raised (a no-op
        for a synchronous saver)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _steps(self):
        return sorted(int(m.group(1)) for name in os.listdir(self.directory) if (m := re.fullmatch(r"step_(\d+)", name)))

    def _prune(self, keep: Optional[int] = None, replaced: Optional[int] = None) -> None:
        keep = self.keep_last if keep is None else keep
        steps = [s for s in self._steps() if s != replaced]
        for step in steps[:-keep] if keep > 0 else steps:
            shutil.rmtree(self._path(step), ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, like: Any = None):
        """(step, {"params", "opt_state"}) of `step` (default: the latest).
        `like` ({"params": ..., "opt_state": ...}) places the params: each
        leaf on the device and in the dtype of its counterpart there; without
        it they stay on the host."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        tree = torch.load(os.path.join(self._path(step), _FILE), map_location="cpu", weights_only=True)
        params = tree["params"]
        if like is not None:
            placed = {id(t): t.to(device=l.device, dtype=l.dtype)
                      for t, l in zip(parameters(params), parameters(like["params"]))}
            params = map_params(lambda t: placed[id(t)], params)
        return step, {"params": params, "opt_state": tree["opt_state"]}
