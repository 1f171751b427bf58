"""ctypes binding of the host C++ rANS (``csrc/rans.cpp``) and CDF
quantization.

The port's copy of the parts of ``lic_tpu/coding/rans.py`` its coders use:
``pmf_to_quantized_cdf`` and the indexed ``RansCodec``.  The library is
compiled from this package's ``csrc/rans.cpp`` with ``g++`` into
``build/_rans.so`` at first use (rebuilt when the source is newer).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from ..utils.build import BUILD_DIR, PACKAGE_DIR, build_if_stale

_PRECISION = 16
_SRC = PACKAGE_DIR / "csrc" / "rans.cpp"
SO = BUILD_DIR / "_rans.so"
_LOCK = threading.Lock()
_LIB = None


def lib() -> ctypes.CDLL:
    """Build (if stale) and load the host rANS library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        build_if_stale(_SRC, SO, [
            "g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-o", "{out}", str(_SRC),
        ])
        so = ctypes.CDLL(str(SO))
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
        u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        so.rans_encode_indexed.restype = ctypes.c_long
        so.rans_encode_indexed.argtypes = [
            i32p, i32p, ctypes.c_long, u32p, ctypes.c_long, i32p,
            u8p, ctypes.c_long,
        ]
        so.rans_build_lut.restype = None
        so.rans_build_lut.argtypes = [u32p, ctypes.c_long, ctypes.c_long, u16p]
        so.rans_decode_indexed.restype = ctypes.c_long
        so.rans_decode_indexed.argtypes = [
            u8p, ctypes.c_long, i32p, ctypes.c_long, u32p, ctypes.c_long,
            i32p, u16p, i32p,
        ]
        so.rans16i_encode.restype = ctypes.c_long
        so.rans16i_encode.argtypes = [
            i32p, i32p, i64p, ctypes.c_long, ctypes.c_long,
            u32p, ctypes.c_long, i32p, u16p, ctypes.c_long,
        ]
        so.rans16i_decode.restype = ctypes.c_long
        so.rans16i_decode.argtypes = [
            u16p, ctypes.c_long, i32p, i64p, ctypes.c_long, ctypes.c_long,
            u32p, ctypes.c_long, i32p, i32p,
        ]
        _LIB = so
        return so


def pmf_to_quantized_cdf(pmf: np.ndarray, precision: int = _PRECISION) -> np.ndarray:
    """Quantize a PMF to a monotone integer CDF summing to 2^precision.

    Every in-table slot AND the trailing escape slot get frequency >= 1;
    deficits/surpluses are settled against the largest bins.
    pmf: (S,) probabilities over the in-table symbols.  Returns (S + 2,)
    cdf with cdf[0] = 0, cdf[-1] = 2^precision (S in-table slots + escape).
    """
    pmf = np.asarray(pmf, np.float64)
    s = pmf.size
    total = 1 << precision
    # reserve escape mass = max(remaining tail mass, tiny)
    tail = max(1.0 - pmf.sum(), 0.0) + 1e-9
    scaled = np.concatenate([pmf, [tail]])
    scaled = scaled / scaled.sum() * total
    freqs = np.maximum(np.round(scaled).astype(np.int64), 1)
    diff = total - freqs.sum()
    while diff != 0:
        if diff > 0:
            freqs[np.argmax(scaled - freqs)] += 1
            diff -= 1
        else:
            candidates = np.where(freqs > 1)[0]
            j = candidates[np.argmin((scaled - freqs)[candidates])]
            freqs[j] -= 1
            diff += 1
    cdf = np.zeros(s + 2, np.uint32)
    cdf[1:] = np.cumsum(freqs).astype(np.uint32)
    assert cdf[-1] == total
    return cdf


class RansCodec:
    """Indexed-CDF rANS: every symbol selects a CDF row.

    ``cdf_rows``: (rows, row_len) quantized CDFs of one length;
    ``offsets``: per-row integer value of in-table slot 0.
    """

    def __init__(self, cdf_rows: np.ndarray, offsets: np.ndarray):
        self.cdfs = np.ascontiguousarray(cdf_rows, np.uint32)
        assert self.cdfs.ndim == 2
        self.row_len = self.cdfs.shape[1]
        self.offsets = np.ascontiguousarray(offsets, np.int32)
        assert self.offsets.shape[0] == self.cdfs.shape[0]
        # first-level decode LUT (cum >> 8 → slot)
        self.lut = np.empty((self.cdfs.shape[0], 256), np.uint16)
        lib().rans_build_lut(self.cdfs, self.cdfs.shape[0], self.row_len, self.lut)

    def encode(self, symbols: np.ndarray, indexes: np.ndarray) -> bytes:
        symbols = np.ascontiguousarray(symbols.reshape(-1), np.int32)
        indexes = np.ascontiguousarray(indexes.reshape(-1), np.int32)
        assert symbols.shape == indexes.shape
        self._check_indexes(indexes)
        cap = symbols.size * 16 + 1024
        out = np.empty(cap, np.uint8)
        n = lib().rans_encode_indexed(
            symbols, indexes, symbols.size, self.cdfs, self.row_len,
            self.offsets, out, cap,
        )
        if n < 0:
            raise RuntimeError("rANS encode overflow")
        return out[:n].tobytes()

    def decode(self, data: bytes, indexes: np.ndarray) -> np.ndarray:
        indexes = np.ascontiguousarray(indexes.reshape(-1), np.int32)
        self._check_indexes(indexes)
        buf = np.ascontiguousarray(np.frombuffer(data, np.uint8))
        out = np.empty(indexes.size, np.int32)
        rc = lib().rans_decode_indexed(
            buf, buf.size, indexes, indexes.size, self.cdfs, self.row_len,
            self.offsets, self.lut, out,
        )
        if rc < 0:
            raise ValueError(
                "corrupt or truncated rANS stream (final-state check failed)"
            )
        return out

    def _check_indexes(self, indexes: np.ndarray) -> None:
        """The binding is the memory-safety boundary: an out-of-range CDF
        row would make the C side read past the tables instead of raising."""
        if indexes.size and (
            indexes.min() < 0 or indexes.max() >= self.cdfs.shape[0]
        ):
            raise IndexError(
                f"CDF row index out of range [0, {self.cdfs.shape[0]}): "
                f"min={indexes.min()}, max={indexes.max()}"
            )
