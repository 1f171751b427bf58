"""Interleaved rANS decoder in plain PyTorch — kernel B1's plain version.

Counterpart of ``lic_tpu/coding/device_rans.py::DeviceRans16Interleaved``
(``:357-501``) and of the chunk loop that drives it
(``lic_tpu/models/compress.py:287-321``).  It is the CPU decoder and the
reference the CUDA drain (``coding.drain``) is held to, bit for bit.

Torch has no general uint32 arithmetic, so lane states are int64 tensors
holding uint32 values: products and shifts are masked to 32 bits, the
unsigned compare ``state < 2^16`` is exact on the non-negative int64, and
the escape unzigzag runs on the non-negative value (a logical shift).

A renorm word at or past the payload's end reads as 0.  The JAX window
slice clamps its start to W - L instead, which reads the same zeros: the
format's contract puts >= L zero words at the end of every stream
(``tests/test_torch_port_rans.py`` holds the two to each other on corrupt
streams).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF


class DeviceIState(NamedTuple):
    """Decoder state over a batch of B streams: L lane states (uint32
    values in int64) and one shared word pointer per stream."""

    state: torch.Tensor  # (B, L) int64
    ptr: torch.Tensor  # (B,) int64


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 → int32 with two's-complement wrap-around (as jnp int32)."""
    return (((v + (1 << 31)) & _MASK32) - (1 << 31)).to(torch.int32)


class DeviceRans16Interleaved:
    """CDF tables (on ``device``) + lane count of the interleaved format.

    ``payload`` arguments are (B, W) int32 — zero-extended uint16 words of
    B independent streams, each followed by at least L zero words."""

    def __init__(self, cdfs: np.ndarray, offsets: np.ndarray, n_lanes: int,
                 device):
        cdfs = np.asarray(cdfs, np.int64)
        self.rows, self.row_len = cdfs.shape
        self.nsyms = self.row_len - 2  # value slots; slot nsyms = escape
        self.n_lanes = int(n_lanes)
        self.cdf_rows = torch.as_tensor(cdfs.astype(np.int32), device=device)
        self.offsets = torch.as_tensor(
            np.asarray(offsets, np.int32), device=device
        )

    def init_lanes(self, payload: torch.Tensor) -> DeviceIState:
        L = self.n_lanes
        b = payload.shape[0]
        head = payload[:, : 2 * L].reshape(b, L, 2).long()
        return DeviceIState(
            (head[..., 0] << 16) | head[..., 1],
            torch.full((b,), 2 * L, dtype=torch.int64, device=payload.device),
        )

    def _window_renorm(self, state, ptr, payload, need):
        """Per stream, the k-th lane needing a word (lanes ascending) takes
        word ``ptr + k``."""
        w_len = payload.shape[1]
        needi = need.long()
        idx = ptr[:, None] + torch.cumsum(needi, dim=1) - needi
        word = torch.gather(payload, 1, idx.clamp(max=w_len - 1)).long()
        word = torch.where(idx < w_len, word, 0)
        state = torch.where(need, ((state << 16) | word) & _MASK32, state)
        return state, ptr + needi.sum(dim=1)

    def _renorm_phase(self, state, ptr, payload, active):
        return self._window_renorm(state, ptr, payload, active & (state < (1 << 16)))

    def _get_bits4(self, state, ptr, payload, active):
        val = state & 15
        ns = torch.where(active, state >> 4, state)
        ns, ptr = self._renorm_phase(ns, ptr, payload, active)
        return torch.where(active, val, 0), ns, ptr

    def decode_chunk(
        self, lanes: DeviceIState, payload, rows, valid
    ) -> Tuple[torch.Tensor, DeviceIState]:
        """Decode one symbol per valid lane (prefix mask per stream).
        rows/valid: (B, L).  Returns (values int32 (B, L), new state)."""
        state, ptr = lanes
        rows = rows.long().clamp(0, self.rows - 1)
        cum = state & 0xFFFF
        row = self.cdf_rows[rows].long()  # (B, L, row_len)
        # largest slot with cdf[slot] <= cum; cdf[0] = 0 so the count >= 1
        slot = ((row <= cum[..., None]).sum(dim=-1) - 1).clamp(max=self.nsyms)
        start = row.gather(-1, slot[..., None])[..., 0]
        freq = row.gather(-1, slot[..., None] + 1)[..., 0] - start
        ns = (freq * (state >> 16) + (cum - start)) & _MASK32
        state = torch.where(valid, ns, state)
        state, ptr = self._renorm_phase(state, ptr, payload, valid)

        esc = valid & (slot == self.nsyms)
        off = self.offsets[rows].long()
        values = slot + off
        if bool(esc.any()):  # far-tail symbols only: 4-bit-nibble bypass
            cnt, state, ptr = self._get_bits4(state, ptr, payload, esc)
            cnt = cnt + 1
            u = torch.zeros_like(state)
            for i in range(8):
                active = esc & (i < cnt)
                d, state, ptr = self._get_bits4(state, ptr, payload, active)
                u = torch.where(active, (u << 4) | d, u)
            # unzigzag on the non-negative uint32 value: a logical shift
            delta = _wrap_int32((u >> 1) ^ (-(u & 1))).long()
            esc_val = torch.where(delta < 0, 0, self.nsyms - 1) + delta + off
            values = torch.where(esc, esc_val, values)
        values = torch.where(valid, values, 0)
        return _wrap_int32(values), DeviceIState(state, ptr)


def stack_payloads(payloads, n_lanes: int) -> Tuple[np.ndarray, list]:
    """Stack B streams' uint16 word payloads into one (B, W) int32 array,
    each row followed by at least ``n_lanes`` zero words, as the decoders
    need.  Returns (payload, each stream's word count)."""
    ends = [int(p.size) for p in payloads]
    out = np.zeros((len(payloads), max(ends) + n_lanes), np.int32)
    for i, p in enumerate(payloads):
        out[i, : p.size] = p
    return out, ends


def drain_plain(
    dev: DeviceRans16Interleaved,
    lanes: DeviceIState,
    payload: torch.Tensor,
    rows_flat: torch.Tensor,
    s_tot: int,
) -> Tuple[DeviceIState, torch.Tensor]:
    """Decode ``s_tot`` symbols per stream, chunk by chunk of L lanes.
    rows_flat: (B, S) CDF rows, S >= s_tot.  Returns (new lanes,
    dec (B, S) int32) with zeros past ``s_tot`` — ``pallas_drain``'s
    contract."""
    b, s = rows_flat.shape
    if not 0 <= s_tot <= s:
        raise ValueError(f"s_tot={s_tot} outside [0, {s}]")
    L = dev.n_lanes
    dec = torch.zeros((b, s), dtype=torch.int32, device=rows_flat.device)
    lane = torch.arange(L, device=rows_flat.device)
    for c0 in range(0, s_tot, L):
        m = min(L, s_tot - c0)
        rk = torch.zeros((b, L), dtype=torch.int64, device=rows_flat.device)
        rk[:, :m] = rows_flat[:, c0 : c0 + m]
        valid = (lane < m).expand(b, L)
        vals, lanes = dev.decode_chunk(lanes, payload, rk, valid)
        dec[:, c0 : c0 + m] = vals[:, :m]
    return lanes, dec
