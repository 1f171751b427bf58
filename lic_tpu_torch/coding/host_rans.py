"""Host entropy coders on the port's C++ rANS (``csrc/rans.cpp``).

The port's copies of what its codec uses from the JAX package's host
coding code: ``GaussianCoder``, ``GaussianMuCoder`` and ``FactorizedCoder``
(``lic_tpu/coding/codec.py:25-217``) and ``Rans16InterleavedCodec``
(``lic_tpu/coding/device_rans.py:288-346``).  Tests hold their tables and
streams byte-identical to the JAX package's.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from . import rans
from .device_rans import stack_payloads
from .rans import RansCodec, pmf_to_quantized_cdf

try:
    from scipy.special import erf as _erf
except ImportError:  # scipy-less host: vectorize math.erf (exact, slower)
    _erf = np.vectorize(math.erf, otypes=[np.float64])

__all__ = [
    "FactorizedCoder",
    "GaussianCoder",
    "GaussianMuCoder",
    "Rans16InterleavedCodec",
    "load_host_rans",
    "random_streams",
]

# the log-spaced scale grid (CompressAI-standard) and the residual radius
SCALES_MIN = 0.11
SCALES_MAX = 256.0
SCALES_LEVELS = 64
RADIUS = 64


def _gaussian_pmf(scale: float, radius: int, mean: float = 0.0) -> np.ndarray:
    xs = np.arange(-radius, radius + 1, dtype=np.float64) - mean
    upper = 0.5 * (1 + _erf((xs + 0.5) / (scale * math.sqrt(2))))
    lower = 0.5 * (1 + _erf((xs - 0.5) / (scale * math.sqrt(2))))
    return np.maximum(upper - lower, 0.0)


def _scale_table() -> np.ndarray:
    return np.exp(np.linspace(math.log(SCALES_MIN), math.log(SCALES_MAX), SCALES_LEVELS))


def _quantized_row(scale: float, mean: float = 0.0) -> np.ndarray:
    # honest tail mass: the escape slot takes 1 − Σpmf; the 0.9999 factor
    # only keeps it nonzero for tiny σ
    pmf = _gaussian_pmf(scale, RADIUS, mean)
    return pmf_to_quantized_cdf(np.clip(pmf, 0.0, 1.0) * 0.9999)


def scale_table_indexes(table: np.ndarray, scales: np.ndarray) -> np.ndarray:
    """Index of the smallest table scale >= scale (lower-bounded); the
    device mirror is ``models.compress.dev_scale_idx``."""
    s = np.maximum(scales, table[0])
    return np.searchsorted(table, s - 1e-9).clip(0, len(table) - 1).astype(np.int32)


class GaussianCoder:
    """CDF rows of the conditional Gaussian over the scale-table grid, for
    (y − μ) residuals; one row per table scale."""

    def __init__(self):
        self.scale_table = _scale_table()
        rows = [_quantized_row(float(s)) for s in self.scale_table]
        self.codec = RansCodec(np.stack(rows), np.full(len(rows), -RADIUS, np.int32))

    def scale_indexes(self, scales: np.ndarray) -> np.ndarray:
        return scale_table_indexes(self.scale_table, scales)

    def encode_symbols(self, symbols: np.ndarray, scales: np.ndarray) -> bytes:
        """Integer residual symbols under the table rows of ``scales``."""
        return self.codec.encode(symbols.astype(np.int32), self.scale_indexes(scales))


class GaussianMuCoder:
    """rANS coder for integer-grid symbols under N(μ, σ) with a fractional
    μ (the neural-syntax family codes ``round(y)``): one CDF row per
    (scale index, δ bin), δ = μ − round(μ) in ``n_delta`` bins; symbols
    ``y_int − round(μ)``."""

    def __init__(self, n_delta: int = 16):
        self.scale_table = _scale_table()
        self.n_delta = n_delta
        centers = (np.arange(n_delta) + 0.5) / n_delta - 0.5
        rows = [_quantized_row(float(s), float(d)) for s in self.scale_table for d in centers]
        self.codec = RansCodec(np.stack(rows), np.full(len(rows), -RADIUS, np.int32))

    def indexes(self, scales: np.ndarray, means: np.ndarray) -> np.ndarray:
        si = scale_table_indexes(self.scale_table, scales)
        dj = np.clip(np.floor((means - np.round(means) + 0.5) * self.n_delta), 0,
                     self.n_delta - 1)
        return (si * self.n_delta + dj).astype(np.int32)

    def encode_ints(self, y_int: np.ndarray, means: np.ndarray, scales: np.ndarray) -> bytes:
        sym = y_int.astype(np.int64) - np.round(means).astype(np.int64)
        return self.codec.encode(sym.astype(np.int32), self.indexes(scales, means))

    def decode_ints(self, data: bytes, means: np.ndarray, scales: np.ndarray) -> np.ndarray:
        sym = self.codec.decode(data, self.indexes(scales, means))
        return sym.reshape(means.shape) + np.round(means).astype(np.int32)


class FactorizedCoder:
    """rANS coder for the factorized prior: one CDF row per channel."""

    def __init__(self, pmf_table: np.ndarray, medians: np.ndarray, offset: int):
        """pmf_table: (C, S) from ``EntropyBottleneck.pmf_table(min_sym,
        max_sym)``; offset = min_sym; medians: (C,)."""
        rows = [pmf_to_quantized_cdf(np.clip(p, 0, 1) * 0.9999) for p in pmf_table]
        self.codec = RansCodec(np.stack(rows), np.full(len(rows), offset, np.int32))
        self.medians = np.asarray(medians, np.float32)

    def encode_symbols(self, symbols: np.ndarray) -> bytes:
        """symbols: (..., C) int, channel last."""
        c = symbols.shape[-1]
        indexes = np.broadcast_to(np.arange(c, dtype=np.int32), symbols.shape)
        return self.codec.encode(symbols.astype(np.int32), np.ascontiguousarray(indexes))

    def decode_symbols(self, data: bytes, shape: Tuple[int, ...]) -> np.ndarray:
        """Decode to raw int32 symbols (medians not re-added)."""
        c = shape[-1]
        indexes = np.broadcast_to(np.arange(c, dtype=np.int32), shape)
        return self.codec.decode(data, np.ascontiguousarray(indexes)).reshape(shape)


class Rans16InterleavedCodec:
    """Host encode (and mirror decode) of the interleaved lane format.

    Container: [uint16 L][uint16 payload ...].  ``symbols``/``indexes`` are
    flat in decode order (step-major); the wire format is defined entirely
    by (step_counts, L).
    """

    def __init__(self, cdfs: np.ndarray, offsets: np.ndarray):
        self.cdfs = np.ascontiguousarray(cdfs, np.uint32)
        self.row_len = self.cdfs.shape[1]
        self.offsets = np.ascontiguousarray(offsets, np.int32)

    def encode(self, symbols, indexes, step_counts, n_lanes: int) -> bytes:
        symbols = np.ascontiguousarray(np.asarray(symbols).reshape(-1), np.int32)
        indexes = np.ascontiguousarray(np.asarray(indexes).reshape(-1), np.int32)
        step_counts = np.ascontiguousarray(step_counts, np.int64)
        assert symbols.shape == indexes.shape
        assert int(step_counts.sum()) == symbols.size
        cap = symbols.size * 24 + 2 * n_lanes + 64
        out = np.empty(cap, np.uint16)
        n = rans.lib().rans16i_encode(
            symbols, indexes, step_counts, step_counts.size, n_lanes,
            self.cdfs, self.row_len, self.offsets, out, cap,
        )
        if n < 0:
            raise RuntimeError("rans16i encode overflow")
        return np.asarray([n_lanes], np.uint16).tobytes() + out[:n].tobytes()

    @staticmethod
    def parse(blob: bytes) -> Tuple[int, np.ndarray]:
        """→ (n_lanes, payload uint16)."""
        n_lanes = int(np.frombuffer(blob, np.uint16, 1)[0])
        return n_lanes, np.frombuffer(blob, np.uint16, -1, 2)

    def decode_host(self, blob: bytes, indexes, step_counts) -> np.ndarray:
        """C++ mirror of the device decoder."""
        n_lanes, payload = self.parse(blob)
        indexes = np.ascontiguousarray(np.asarray(indexes).reshape(-1), np.int32)
        step_counts = np.ascontiguousarray(step_counts, np.int64)
        out = np.empty(indexes.size, np.int32)
        rc = rans.lib().rans16i_decode(
            np.ascontiguousarray(payload), payload.size, indexes,
            step_counts, step_counts.size, n_lanes, self.cdfs,
            self.row_len, self.offsets, out,
        )
        if rc != 0:
            raise ValueError("corrupt or truncated rans16i stream")
        return out


def load_host_rans() -> str:
    """Build (if stale) and load the host rANS library; return its path."""
    rans.lib()
    return str(rans.SO)


def random_streams(cdfs, offsets, cases, steps, n_lanes: int):
    """Host-encoded interleaved streams of random symbols, to check a
    drain against: one stream per ``(seed, with_escapes)`` in ``cases``,
    ``sum(steps)`` symbols each, encoded in ``steps`` segments.  With
    escapes, about 1 symbol in 17 lies outside its table row, two of them
    at |δ| >= 2^30 (the unzigzag's logical-shift case).

    Returns (symbols (B, n) int32, rows (B, n) int32, payload (B, W) int32
    with >= ``n_lanes`` trailing zero words, each stream's word count)."""
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
