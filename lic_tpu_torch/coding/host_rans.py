"""The host C++ rANS of ``lic_tpu``, reused as it is.

The port's one entry to the JAX package's host coding code, none of which
imports jax: ``FactorizedCoder`` and ``GaussianCoder``
(``lic_tpu/coding/codec.py``) and ``Rans16InterleavedCodec``
(``lic_tpu/coding/device_rans.py``; jax is imported only inside the
methods of that module's device classes, which the port does not use).

``lic_tpu/coding/rans.py`` loads ``lic_tpu/coding/_rans.so``, a binary
committed from another host, unless it is older than ``rans.cpp``.
``load_host_rans`` points the loader at ``build/_rans.so`` before its
first use, so the library that loads is compiled on this host from
``lic_tpu/coding/rans.cpp``.  If the process has already loaded the
library, that one stays.
"""

from __future__ import annotations

from lic_tpu.coding import rans
from lic_tpu.coding.codec import FactorizedCoder, GaussianCoder
from lic_tpu.coding.device_rans import Rans16InterleavedCodec

import numpy as np

from ..utils.build import BUILD_DIR
from .device_rans import stack_payloads

__all__ = [
    "FactorizedCoder",
    "GaussianCoder",
    "Rans16InterleavedCodec",
    "load_host_rans",
    "random_streams",
]


def load_host_rans() -> str:
    """Load the host rANS library; return the path of the one loaded."""
    if rans._LIB is None:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        rans._SO = str(BUILD_DIR / "_rans.so")
    rans._lib()
    return rans._SO


def random_streams(cdfs, offsets, cases, steps, n_lanes: int):
    """Host-encoded interleaved streams of random symbols, to check a
    drain against: one stream per ``(seed, with_escapes)`` in ``cases``,
    ``sum(steps)`` symbols each, encoded in ``steps`` segments.  With
    escapes, about 1 symbol in 17 lies outside its table row, two of them
    at |δ| >= 2^30 (the unzigzag's logical-shift case).

    Returns (symbols (B, n) int32, rows (B, n) int32, payload (B, W) int32
    with >= ``n_lanes`` trailing zero words, each stream's word count)."""
    load_host_rans()
    codec = Rans16InterleavedCodec(cdfs, offsets)
    n = int(sum(steps))
    syms, rows, pays = [], [], []
    for seed, with_escapes in cases:
        rng = np.random.default_rng(seed)
        idx = rng.integers(0, cdfs.shape[0], n).astype(np.int32)
        sym = (offsets[idx] + rng.integers(0, cdfs.shape[1] - 2, n)).astype(np.int32)
        if with_escapes:
            k = max(2, n // 17)
            pos = rng.choice(n, k, replace=False)
            sym[pos] = rng.integers(-5000, 5000, k).astype(np.int32)
            sym[pos[0]] = (1 << 30) + 12345
            sym[pos[1]] = -((1 << 30) + 999)
        _, pay = Rans16InterleavedCodec.parse(codec.encode(sym, idx, steps, n_lanes))
        syms.append(sym)
        rows.append(idx)
        pays.append(pay.astype(np.int32))
    pay, ends = stack_payloads(pays, n_lanes)
    return np.stack(syms), np.stack(rows), pay, ends
