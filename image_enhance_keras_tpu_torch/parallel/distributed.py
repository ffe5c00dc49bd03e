"""Multi-process bootstrap (mirror of ``parallel/distributed.py``).

One process needs nothing: :func:`~image_enhance_keras_tpu_torch.parallel.mesh.make_mesh`
sees every card of its machine.  For a job of several processes, call
:func:`maybe_init_distributed` once at process start: it joins a
``torch.distributed`` process group from the JAX package's environment
contract when that is set and does nothing otherwise, so the same entry
points run on one process and on many.  The trainer then all-reduces its
gradients over the group (``nccl`` between cards, ``gloo`` on the CPU).
"""

from __future__ import annotations

import datetime
import os

import torch

from image_enhance_keras_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

__all__ = ["maybe_init_distributed"]

_ENV_KEYS = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS")


def maybe_init_distributed(device: str | torch.device = "cuda", timeout_s: float = 300.0) -> bool:
    """Join a process group iff the coordinator's address is in the environment.

    Environment contract (the JAX package's):
      JAX_COORDINATOR_ADDRESS (or COORDINATOR_ADDRESS)  host:port of rank 0
      JAX_NUM_PROCESSES / JAX_PROCESS_ID                world size and rank (default 1 and 0)

    The backend is ``nccl`` when the process runs on CUDA (``device``), else
    ``gloo``.  Returns True when it joined (or had already joined) a group."""
    addr = next((os.environ[k] for k in _ENV_KEYS if k in os.environ), None)
    if addr is None:
        return False
    dist = torch.distributed
    if dist.is_initialized():
        return True
    world = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    rank = int(os.environ.get("JAX_PROCESS_ID", "0"))
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{addr}", world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    log.info("torch.distributed initialised (%s): process %d/%d", backend, rank, world)
    return True
