"""Entropy coding of the port (counterpart of ``lic_tpu.coding``).

The host rANS of ``lic_tpu`` is reused as it is (``host_rans``); this
package adds the interleaved decoder in plain PyTorch (``device_rans``)
and kernel B1, its CUDA drain (``drain.rans_drain``).
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
    "Rans16InterleavedCodec",
    "load_host_rans",
    "random_streams",
]
