"""Data parallelism over processes (counterpart of ``lic_tpu.parallel``'s
data mesh): ``torch.distributed`` with DDP."""

from .distributed import init_distributed, local_device, shard_batch, wrap_ddp

__all__ = ["init_distributed", "local_device", "shard_batch", "wrap_ddp"]
