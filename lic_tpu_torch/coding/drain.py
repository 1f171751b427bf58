"""Wrapper of kernel B1, the interleaved rANS drain (``csrc/rans_drain.cu``).

Counterpart of ``lic_tpu/coding/pallas_rans.py::pallas_drain``: it takes
(lanes, payload, rows, s_tot) and returns (new lanes, decoded values).  CPU
tensors take the plain version (``device_rans.drain_plain``); CUDA tensors
launch the kernel, built at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (loaded with ``ctypes``); any other
device raises.  A failed build or launch raises.
"""

from __future__ import annotations

import ctypes
import shutil
import threading
from typing import Tuple

import torch

from ..utils.build import BUILD_DIR, PACKAGE_DIR, build_if_stale
from .device_rans import (
    _MASK32,
    DeviceIState,
    DeviceRans16Interleaved,
    drain_plain,
)

_SRC = PACKAGE_DIR / "csrc" / "rans_drain.cu"
_SO = BUILD_DIR / "rans_drain.so"
_LOCK = threading.Lock()
_LIB = None
BUILD_LOG = ""  # the compiler's output of this process's build, if any


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not shutil.which(nvcc):
        raise RuntimeError("nvcc not found: the rANS drain kernel cannot build")
    return nvcc


def library() -> ctypes.CDLL:
    """Build (if stale) and load the kernel's shared library."""
    global _LIB, BUILD_LOG
    with _LOCK:
        if _LIB is not None:
            return _LIB
        BUILD_LOG = build_if_stale(_SRC, _SO, [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
            "-Xcompiler", "-fPIC", "-o", "{out}", str(_SRC),
        ])
        lib = ctypes.CDLL(str(_SO))
        lib.rans_drain_launch.restype = ctypes.c_int
        lib.rans_drain_launch.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        )
        _LIB = lib
        return lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"rans_drain: {msg}")


def _drain_cuda(dev, lanes, payload, rows_flat, s_tot):
    b, s = rows_flat.shape
    L = dev.n_lanes
    w_len = payload.shape[1]
    device = payload.device
    _check(0 <= s_tot <= s, f"s_tot={s_tot} outside [0, {s}]")
    _check(L % 32 == 0 and 0 < L <= 1024, f"L={L} must be a multiple of 32 <= 1024")
    _check(payload.dtype == torch.int32 and payload.is_contiguous(),
           "payload must be contiguous int32")
    _check(payload.shape[0] == b and w_len >= 2 * L,
           f"payload {tuple(payload.shape)} vs rows {tuple(rows_flat.shape)}")
    _check(dev.cdf_rows.device == device and rows_flat.device == device,
           "tables, rows and payload must share a device")
    _check(tuple(lanes.state.shape) == (b, L) and tuple(lanes.ptr.shape) == (b,),
           "lane state shape")
    # the interleaved format's contract (device_rans.py:361-363): every
    # stream ends with >= L zero words
    _check(not bool(payload[:, w_len - L:].any()),
           f"each payload row needs >= {L} trailing zero words")
    rows = rows_flat.to(torch.int32).contiguous()
    out = torch.zeros((b, s), dtype=torch.int32, device=device)
    if s_tot == 0:
        return lanes, out
    # uint32 bit pattern in int32 storage; the kernel updates both in place
    st = lanes.state
    state = torch.where(st >= 1 << 31, st - (1 << 32), st).to(torch.int32).contiguous()
    ptr = lanes.ptr.to(torch.int32).contiguous()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = library().rans_drain_launch(
        rows.data_ptr(), payload.data_ptr(), state.data_ptr(), ptr.data_ptr(),
        out.data_ptr(), dev.cdf_rows.data_ptr(), dev.offsets.data_ptr(),
        b, s, int(s_tot), w_len, L, dev.rows, dev.row_len, stream,
    )
    if err != 0:
        raise RuntimeError(f"rans_drain kernel launch failed: cudaError {err}")
    rans_drain.launches += 1
    return DeviceIState(state.long() & _MASK32, ptr.long()), out


def rans_drain(
    dev: DeviceRans16Interleaved,
    lanes: DeviceIState,
    payload: torch.Tensor,
    rows_flat: torch.Tensor,
    s_tot: int,
) -> Tuple[DeviceIState, torch.Tensor]:
    """Decode ``s_tot`` symbols of B interleaved streams.

    ``payload`` (B, W) int32 words, each row followed by >= L zeros;
    ``rows_flat`` (B, S) CDF rows, S >= ``s_tot``.  Returns (new lanes,
    dec (B, S) int32, zero past ``s_tot``)."""
    if payload.device.type == "cpu":
        return drain_plain(dev, lanes, payload, rows_flat, s_tot)
    if payload.device.type != "cuda":
        raise RuntimeError(f"rans_drain: no kernel for device {payload.device}")
    return _drain_cuda(dev, lanes, payload, rows_flat, s_tot)


rans_drain.launches = 0
