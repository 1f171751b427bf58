"""Data parallelism with ``DistributedDataParallel``.

The port's counterpart of the JAX package's ``data`` mesh axis
(``lic_tpu/parallel/{mesh,distributed}.py``): one process per card, the
batch split over the ranks (``shard_batch``), parameters replicated, and
DDP averaging the gradients, so that the gradient equals the
single-process gradient on the whole batch.  NCCL on the card, gloo on the
CPU.  The spatial and hybrid sharding of ``lic_tpu/parallel/mesh.py`` are
not ported (ROADMAP A17).

``init_distributed`` takes the address, world size and rank explicitly or
from ``torchrun``'s environment (``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``); nothing here discovers a
cluster.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn


def init_distributed(address: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, device=None) -> Tuple[int, int]:
    """Join the process group; → (rank, world size).  ``address`` is
    ``host:port`` of rank 0 (default: ``MASTER_ADDR:MASTER_PORT``).  With
    no argument and no ``WORLD_SIZE`` in the environment, or a world of
    one, it does nothing and returns (0, 1).  The backend is NCCL for a
    CUDA ``device`` (default: the local rank's card where CUDA exists),
    gloo otherwise."""
    env = os.environ
    world_size = int(world_size if world_size is not None else env.get("WORLD_SIZE", 1))
    rank = int(rank if rank is not None else env.get("RANK", 0))
    if world_size <= 1:
        return 0, 1
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if address is None:
        address = f"{env.get('MASTER_ADDR', 'localhost')}:{env['MASTER_PORT']}"
    device = torch.device(device) if device is not None else local_device()
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://{address}", world_size=world_size, rank=rank)
    return rank, world_size


def local_device(cpu: bool = False) -> torch.device:
    """This process's card (``LOCAL_RANK``), or the CPU if asked."""
    if cpu:
        return torch.device("cpu")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def shard_batch(batch: torch.Tensor, rank: int, world_size: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous share of a global batch."""
    b = batch.shape[0]
    if b % world_size:
        raise ValueError(f"batch {b} does not split over {world_size} ranks")
    n = b // world_size
    return batch[rank * n : (rank + 1) * n]


def wrap_ddp(model: nn.Module) -> nn.Module:
    """``model`` in DDP when a process group of more than one rank is up,
    else ``model`` itself.  The parameters no forward reads (the model's
    ``unread_parameters``: the syntax model of a model whose g_s gives
    RGB) are left out of DDP: they never take a gradient, and DDP would
    otherwise stop at the next step waiting for their reduction.  They
    keep their values on every rank, as the optimizer skips a leaf
    without a gradient."""
    if not (dist.is_initialized() and dist.get_world_size() > 1):
        return model
    dev = next(model.parameters()).device
    unread = getattr(model, "unread_parameters", lambda: [])()
    if unread:
        nn.parallel.DistributedDataParallel._set_params_and_buffers_to_ignore_for_model(
            model, unread)
    return nn.parallel.DistributedDataParallel(
        model, device_ids=[dev.index] if dev.type == "cuda" else None)
