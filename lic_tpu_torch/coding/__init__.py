"""Entropy coding of the port (counterpart of ``lic_tpu.coding``).

The host coders run on the port's copy of the C++ rANS (``csrc/rans.cpp``
via ``rans`` and ``host_rans``); the interleaved decoder is plain PyTorch
(``device_rans``) and kernel B1, its CUDA drain (``drain.rans_drain``).
"""

from .device_rans import (
    DeviceIState,
    DeviceRans16Interleaved,
    drain_plain,
    stack_payloads,
)
from .drain import rans_drain
from .host_rans import (
    FactorizedCoder,
    GaussianCoder,
    GaussianMuCoder,
    Rans16InterleavedCodec,
    load_host_rans,
    random_streams,
)

__all__ = [
    "DeviceIState",
    "DeviceRans16Interleaved",
    "drain_plain",
    "stack_payloads",
    "rans_drain",
    "FactorizedCoder",
    "GaussianCoder",
    "GaussianMuCoder",
    "Rans16InterleavedCodec",
    "load_host_rans",
    "random_streams",
]
