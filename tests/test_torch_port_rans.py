"""Port parity: the interleaved rANS drain (kernel B1's plain version).

Streams come from the host C++ ``Rans16InterleavedCodec.encode`` on the
codec's own 64 × 131 Gaussian tables, with and without escapes (including
|δ| ≥ 2^30, whose unzigzag needs a logical shift), at B = 2 and L = 128.
The port's plain drain must be BIT-EXACT with the JAX
``DeviceRans16Interleaved`` chunk scan and with ``pallas_drain`` in
interpret mode: values, final states and pointers, also when one decode is
split into several calls that thread the lane state.  The CUDA kernel is
held to this plain version by ``tests/test_torch_port_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lic_tpu.coding.codec import GaussianCoder
from lic_tpu.coding.device_rans import DeviceRans16Interleaved as JDev
from lic_tpu.coding.device_rans import Rans16InterleavedCodec
from lic_tpu.coding.pallas_rans import pallas_drain
from lic_tpu_torch.coding import (
    DeviceIState,
    DeviceRans16Interleaved,
    drain_plain,
    load_host_rans,
    random_streams,
    rans_drain,
)

torch.set_num_threads(2)

L = 128


@pytest.fixture(scope="module")
def tables():
    load_host_rans()
    g = GaussianCoder()  # the codec's tables: 64 rows × 131
    return g.codec.cdfs, g.codec.offsets


def _jax_scan(dev, lanes, pay, rows, s_tot):
    """The chunked decode_chunk scan pallas_drain replaces
    (``lic_tpu/models/compress.py:287-321``)."""
    b, s = rows.shape
    mc = -(-s // L)
    rows_pad = np.zeros((b, mc * L), np.int32)
    rows_pad[:, :s] = rows
    rows_sc = jnp.asarray(rows_pad.reshape(b, mc, L).transpose(1, 0, 2))
    valid_sc = jnp.asarray((np.arange(mc)[:, None] * L + np.arange(L)) < s_tot)

    def chunk(lanes, xs):
        rk, vd = xs
        vals, lanes = dev.decode_chunk(lanes, pay, rk, jnp.broadcast_to(vd, (b, L)))
        return lanes, vals

    lanes, dec = jax.lax.scan(chunk, lanes, (rows_sc, valid_sc))
    return lanes, np.asarray(dec).transpose(1, 0, 2).reshape(b, -1)[:, :s]


def _assert_same(t_lanes, t_dec, j_lanes, j_dec):
    np.testing.assert_array_equal(t_dec.numpy(), np.asarray(j_dec))
    np.testing.assert_array_equal(
        t_lanes.state.numpy(), np.asarray(j_lanes.state).astype(np.int64)
    )
    np.testing.assert_array_equal(
        t_lanes.ptr.numpy(), np.asarray(j_lanes.ptr).astype(np.int64)
    )


@pytest.mark.parametrize("with_escapes", [False, True])
def test_drain_bitexact_vs_jax_scan_and_pallas(tables, with_escapes):
    cdfs, offsets = tables
    n = 700  # 6 chunks, the last one partial
    sym, idx, pay, ends = random_streams(
        cdfs, offsets, [(40 + with_escapes, with_escapes), (50, with_escapes)], [n], L
    )
    dev = DeviceRans16Interleaved(cdfs, offsets, L, device="cpu")
    payt = torch.from_numpy(pay)
    t_lanes, t_dec = rans_drain(dev, dev.init_lanes(payt), payt, torch.from_numpy(idx), n)
    np.testing.assert_array_equal(t_dec.numpy(), sym)
    np.testing.assert_array_equal(t_lanes.state.numpy(), 1 << 16)
    np.testing.assert_array_equal(t_lanes.ptr.numpy(), ends)

    jdev = JDev(cdfs, offsets, L)
    jpay = jnp.asarray(pay)
    j_lanes, j_dec = _jax_scan(jdev, jdev.init_lanes(jpay), jpay, idx, n)
    _assert_same(t_lanes, t_dec, j_lanes, j_dec)
    p_lanes, p_dec = pallas_drain(
        jdev, jdev.init_lanes(jpay), jpay, jnp.asarray(idx), n, interpret=True
    )
    _assert_same(t_lanes, t_dec, p_lanes, p_dec)


def test_drain_threads_state_across_calls(tables):
    """ChARM-style: one decode in several calls (s_tot each, rows wider
    than s_tot) threading lane state, over B = 2 streams (one with
    escapes); intermediate states and pointers match the JAX scan and the
    Pallas kernel call for call."""
    cdfs, offsets = tables
    steps = [300, 129, 271]
    sym, idx, pay, ends = random_streams(cdfs, offsets, [(60, False), (61, True)], steps, L)
    dev = DeviceRans16Interleaved(cdfs, offsets, L, device="cpu")
    jdev = JDev(cdfs, offsets, L)
    payt, jpay = torch.from_numpy(pay), jnp.asarray(pay)
    t_lanes = dev.init_lanes(payt)
    s_lanes = p_lanes = jdev.init_lanes(jpay)
    off = 0
    for m in steps:
        rows = np.zeros((2, m + 37), np.int32)  # padded rows: s_tot < S
        rows[:, :m] = idx[:, off : off + m]
        t_lanes, t_dec = rans_drain(dev, t_lanes, payt, torch.from_numpy(rows), m)
        s_lanes, s_dec = _jax_scan(jdev, s_lanes, jpay, rows, m)
        p_lanes, p_dec = pallas_drain(
            jdev, p_lanes, jpay, jnp.asarray(rows), m, interpret=True
        )
        _assert_same(t_lanes, t_dec, s_lanes, s_dec)
        _assert_same(t_lanes, t_dec, p_lanes, p_dec)
        np.testing.assert_array_equal(t_dec.numpy()[:, :m], sym[:, off : off + m])
        np.testing.assert_array_equal(t_dec.numpy()[:, m:], 0)
        off += m
    np.testing.assert_array_equal(t_lanes.state.numpy(), 1 << 16)
    np.testing.assert_array_equal(t_lanes.ptr.numpy(), ends)


def test_drain_matches_host_decoder_and_flags_truncation(tables):
    cdfs, offsets = tables
    steps = [256, 256]
    sym, idx, pay, ends = random_streams(cdfs, offsets, [(70, True)], steps, L)
    codec = Rans16InterleavedCodec(cdfs, offsets)
    blob = codec.encode(sym[0], idx[0], steps, L)
    np.testing.assert_array_equal(codec.decode_host(blob, idx[0], steps), sym[0])
    dev = DeviceRans16Interleaved(cdfs, offsets, L, device="cpu")
    # a truncated payload decodes to a state or pointer that fails the
    # final-state check
    cut = pay.copy()
    cut[0, ends[0] - 20 :] = 0
    payt = torch.from_numpy(cut)
    lanes, _ = drain_plain(dev, dev.init_lanes(payt), payt, torch.from_numpy(idx), 512)
    assert not (bool((lanes.state == 1 << 16).all()) and int(lanes.ptr[0]) == ends[0])


def test_wrapper_rejects_other_devices(tables):
    cdfs, offsets = tables
    dev = DeviceRans16Interleaved(cdfs, offsets, L, device="meta")
    pay = torch.zeros((1, 3 * L), dtype=torch.int32, device="meta")
    lanes = DeviceIState(torch.zeros((1, L), dtype=torch.int64, device="meta"),
                         torch.zeros(1, dtype=torch.int64, device="meta"))
    with pytest.raises(RuntimeError, match="no kernel"):
        rans_drain(dev, lanes, pay, torch.zeros((1, 8), dtype=torch.int32, device="meta"), 8)
