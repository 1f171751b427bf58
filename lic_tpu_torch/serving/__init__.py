"""Variable-rate serving (counterpart of ``lic_tpu/serving``): the
target-bitrate solver and the dynamic-batching ``CodecService``."""

from .rate_control import solve_rate_for_bpp
from .service import CodecService, ServiceStats

__all__ = ["CodecService", "ServiceStats", "solve_rate_for_bpp"]
