"""Wrapper of kernel B1, the interleaved rANS drain (``csrc/rans_drain.cu``).

Counterpart of ``lic_tpu/coding/pallas_rans.py::pallas_drain``: it takes
(lanes, payload, rows, s_tot) and returns (new lanes, decoded values).  CPU
tensors take the plain version (``device_rans.drain_plain``); CUDA tensors
launch the kernel, built at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (loaded with ``ctypes``); any other
device raises.  A failed build or launch raises, and so does a shape the
kernel does not take (no fallback).

The kernel takes L in {8, 16, 32, 64, 128, 256} lanes and tables of rows
of at most 256 entries.  Its table (CDF rows, offsets and the coarse slot
index) sits in shared memory where it fits beside the payload ring — the
64-row ``GaussianCoder`` table at L <= 128 — and in device memory
otherwise — ``GaussianMuCoder``'s 1,024 rows, or any table at L = 256
(``route``: the kernel library decides, by the shared memory the table
needs, once per coder).  ``table_routes`` counts the launches of each
route; B1's launches are their sum.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ..utils.build import CudaLibrary, check_launch
from .device_rans import (
    _MASK32,
    DeviceIState,
    DeviceRans16Interleaved,
    drain_plain,
)


def _bind(lib: ctypes.CDLL) -> None:
    lib.rans_drain_launch.restype = ctypes.c_int
    lib.rans_drain_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    )
    lib.rans_drain_route.restype = ctypes.c_int
    lib.rans_drain_route.argtypes = [ctypes.c_int] * 3


library = CudaLibrary("rans_drain.cu", _bind)

LANES = (8, 16, 32, 64, 128, 256)
ROUTES = ("smem", "global")


class RouteCount:
    """Launches of one table route of B1."""

    def __init__(self, route: str):
        self.route = route
        self.launches = 0


table_routes = {r: RouteCount(r) for r in ROUTES}


def route(dev: DeviceRans16Interleaved) -> str:
    """The table route of the coder's launches on the card, 'smem' or
    'global', asked of the kernel library once and kept on the coder;
    raises for a shape the kernel does not take."""
    r = getattr(dev, "_table_route", None)
    if r is None:
        k = library().rans_drain_route(dev.n_lanes, dev.rows, dev.row_len)
        if k < 0:
            raise ValueError(f"rans_drain: no kernel for L={dev.n_lanes}, a table of {dev.rows} "
                             f"rows of {dev.row_len} (L in {LANES}, rows of at most 256)")
        r = dev._table_route = ROUTES[k]
    return r


SLOT_BUCKET_BITS = 7  # the coarse slot index keys on cum >> 7: 512 buckets


def slot_index(cdfs: np.ndarray) -> np.ndarray:
    """The kernel's coarse slot index.  For each CDF row and each h in
    0..512, with lo the slot of cum = min(h << 7, 65535), i.e.
    ``#{j : cdf[j] <= cum} - 1``: the entry ``cdf[lo] << 8 | lo``.  The
    slot of any cum in bucket h lies between the slots of entries h and
    h + 1.  (rows, 513) uint32; the rows must ascend from cdf[0] = 0 to a
    last entry above 65535 and hold at most 256 entries."""
    cdfs = np.asarray(cdfs, np.int64)
    rows, row_len = cdfs.shape
    if (row_len > 256 or (cdfs[:, 0] != 0).any() or (cdfs[:, -1] <= 0xFFFF).any()
            or (np.diff(cdfs, axis=1) < 0).any()):
        raise ValueError(
            "slot_index: rows must ascend from 0 past 65535 and hold <= 256 entries"
        )
    n = (1 << (16 - SLOT_BUCKET_BITS)) + 1
    cums = np.minimum(np.arange(n) << SLOT_BUCKET_BITS, 0xFFFF)
    out = np.empty((rows, n), np.uint32)
    for r in range(rows):
        lo = np.searchsorted(cdfs[r], cums, side="right") - 1
        out[r] = (cdfs[r, lo] << 8) | lo
    return out


def _slot_index_on(dev: DeviceRans16Interleaved) -> torch.Tensor:
    """``slot_index`` of the coder's tables, on their device, built once."""
    idx = getattr(dev, "_slot_index", None)
    if idx is None or idx.device != dev.cdf_rows.device:
        idx = torch.from_numpy(slot_index(dev.cdf_rows.cpu().numpy())).to(dev.cdf_rows.device)
        dev._slot_index = idx
    return idx


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"rans_drain: {msg}")


def _drain_cuda(dev, lanes, payload, rows_flat, s_tot):
    b, s = rows_flat.shape
    L = dev.n_lanes
    w_len = payload.shape[1]
    device = payload.device
    _check(0 <= s_tot <= s, f"s_tot={s_tot} outside [0, {s}]")
    table = route(dev)
    _check(payload.dtype == torch.int32 and payload.is_contiguous(),
           "payload must be contiguous int32")
    _check(payload.shape[0] == b and w_len >= 2 * L,
           f"payload {tuple(payload.shape)} vs rows {tuple(rows_flat.shape)}")
    _check(dev.cdf_rows.device == device and rows_flat.device == device,
           "tables, rows and payload must share a device")
    _check(tuple(lanes.state.shape) == (b, L) and tuple(lanes.ptr.shape) == (b,),
           "lane state shape")
    # the interleaved format's contract (device_rans.py:361-363): every
    # stream ends with >= L zero words.  Checked once per payload tensor and
    # again after an in-place write (its version counter moves): the check
    # waits for the card, and one decode drains the same payload per slice
    if getattr(payload, "_rans_zero_tail", None) != (payload._version, L):
        _check(not bool(payload[:, w_len - L:].any()),
               f"each payload row needs >= {L} trailing zero words")
        payload._rans_zero_tail = (payload._version, L)
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
        _slot_index_on(dev).data_ptr(), b, s, int(s_tot), w_len, L, dev.rows, dev.row_len,
        ROUTES.index(table), stream,
    )
    check_launch(err, "rans_drain")
    table_routes[table].launches += 1
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
