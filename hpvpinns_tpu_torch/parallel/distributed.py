"""Process-group bring-up: one process a device.

Counterpart of hpvpinns_tpu/parallel/distributed.py.  JAX runs one process
a host and sees every device of the cluster from it once
jax.distributed.initialize() has run; torch runs one process a device (a
rank), and the ranks meet in a torch.distributed process group.  Every
rank calls `initialize()` once, before it builds a mesh
(parallel/sharding.py).  The topology comes from the arguments or from
torchrun's environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK,
LOCAL_RANK) where JAX reads JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and
JAX_PROCESS_ID.  One process with no cluster environment is a no-op, so
the same script runs alone or under torchrun.

The backend: NCCL on the card, gloo on the CPU, unless `backend` names
one.  NCCL takes one rank a card: ranks that share one card pass
backend="gloo", whose collectives take CUDA tensors through the host.  An
NCCL group of two ranks on one card fails with NCCL's own error; nothing
here catches it.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

_initialized = False


def is_initialized() -> bool:
    return _initialized


def default_backend(device) -> str:
    """NCCL for a CUDA device, gloo otherwise."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_device(device=None) -> torch.device:
    """This rank's device: `device` when given, else cuda:LOCAL_RANK (the
    card of this rank), else the CPU when there is no card.  A CUDA device
    with no index takes LOCAL_RANK modulo the number of cards."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = torch.device("cuda", local % max(1, torch.cuda.device_count()))
    return device


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> dict:
    """Idempotent torch.distributed bring-up; returns the topology as the
    JAX package's dict {"process_index", "process_count", "local_devices",
    "global_devices"}: one device a rank, the world in all.

    `coordinator_address` is "host:port" (default MASTER_ADDR:MASTER_PORT),
    `num_processes` the world size (WORLD_SIZE), `process_id` the rank
    (RANK).  `device` is where this rank computes (parallel/distributed.py::
    local_device); a CUDA device becomes the current one.  With one process
    and no address nothing is brought up."""
    global _initialized
    if coordinator_address is None and os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None and os.environ.get("WORLD_SIZE"):
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and os.environ.get("RANK"):
        process_id = int(os.environ["RANK"])

    multi_process = coordinator_address is not None or (num_processes is not None and num_processes > 1)
    if multi_process and not dist.is_initialized():
        device = local_device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            backend=backend or default_backend(device),
            init_method=f"tcp://{coordinator_address or 'localhost:29500'}",
            world_size=num_processes or 1,
            rank=process_id or 0,
        )
        _initialized = True
    if dist.is_initialized():
        index, count = dist.get_rank(), dist.get_world_size()
    else:
        index, count = 0, 1
    return {"process_index": index, "process_count": count, "local_devices": 1, "global_devices": count}


def shutdown() -> None:
    """Destroy the default group where `initialize` (or a mesh) made one."""
    global _initialized
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False
