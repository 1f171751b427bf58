"""Port parity: the interleaved rANS drain (kernel B1's plain version).

Streams come from the host C++ ``Rans16InterleavedCodec.encode`` on the
codec's own 64 × 131 Gaussian tables, with and without escapes (including
|δ| ≥ 2^30, whose unzigzag needs a logical shift), at B = 2 and L = 128.
The port's plain drain must be BIT-EXACT with the JAX
``DeviceRans16Interleaved`` chunk scan and with ``pallas_drain`` in
interpret mode: values, final states and pointers, also when one decode is
split into several calls that thread the lane state, and on corrupt
streams whose pointer runs past the payload's last L words.  The CUDA kernel is
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
from lic_tpu_torch.coding.drain import slot_index

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


def _corrupt(pay, ends, kind, seed):
    """A corrupt copy of the payload, its >= L trailing zero words kept:
    ``flipped`` xors random bits into 30% of each stream's words after the
    lane heads; ``zeroed`` zeroes each stream after its lane heads, so the
    decode's renorms run the pointer into the trailing zeros."""
    rng = np.random.default_rng(seed)
    bad = pay.copy()
    for b, end in enumerate(ends):
        if kind == "flipped":
            m = rng.random(end) < 0.3
            m[: 2 * L] = False
            bad[b, :end][m] ^= rng.integers(1, 1 << 16, int(m.sum())).astype(np.int32)
        else:
            bad[b, 2 * L + 5 :] = 0
    return bad


@pytest.mark.parametrize("kind", ["flipped", "zeroed"])
def test_drain_on_corrupt_streams_matches_jax_and_pallas(tables, kind):
    """Past the payload: a renorm word at or past W reads 0 in the port,
    where the JAX window slice clamps its start to W - L.  Under the
    format's contract of >= L trailing zero words the two read the same
    words, so a corrupt stream decodes to the same values, states and
    pointers in the JAX scan, ``pallas_drain`` (interpret mode) and
    ``drain_plain``; ``zeroed`` drives the pointer past W - L."""
    cdfs, offsets = tables
    n = 700
    _, idx, pay, ends = random_streams(cdfs, offsets, [(90, True), (91, False)], [n], L)
    bad = _corrupt(pay, ends, kind, seed=5)
    dev = DeviceRans16Interleaved(cdfs, offsets, L, device="cpu")
    payt = torch.from_numpy(bad)
    t_lanes, t_dec = drain_plain(dev, dev.init_lanes(payt), payt, torch.from_numpy(idx), n)
    jdev = JDev(cdfs, offsets, L)
    jpay = jnp.asarray(bad)
    j_lanes, j_dec = _jax_scan(jdev, jdev.init_lanes(jpay), jpay, idx, n)
    _assert_same(t_lanes, t_dec, j_lanes, j_dec)
    p_lanes, p_dec = pallas_drain(
        jdev, jdev.init_lanes(jpay), jpay, jnp.asarray(idx), n, interpret=True
    )
    _assert_same(t_lanes, t_dec, p_lanes, p_dec)
    if kind == "zeroed":
        assert int(t_lanes.ptr.max()) > bad.shape[1] - L


def test_slot_index_brackets_every_cum(tables):
    """The CUDA drain's coarse slot index: for every cum in [0, 2^16) the
    slot ``#{j : cdf[j] <= cum} - 1`` lies between the slots of the entries
    of cum's bucket (cum >> 7) and the next, and each entry carries its
    slot's CDF value (``cdf[lo] << 8 | lo``), on the codec's Gaussian tables
    and on random tables with zero-frequency slots."""
    cdfs, _ = tables
    rng = np.random.default_rng(3)
    freqs = rng.integers(0, 900, (5, 40))
    freqs[:, -1] = 1
    rand = np.concatenate([np.zeros((5, 1), np.int64), np.cumsum(freqs, 1)], 1)
    rand = rand * 65535 // rand[:, -1:] + (np.arange(41) == 40)  # last entry 65536
    cums = np.arange(1 << 16)
    for tab in (np.asarray(cdfs, np.int64), rand):
        idx = slot_index(tab).astype(np.int64)
        assert idx.shape == (tab.shape[0], 513)
        for r, row in enumerate(tab):
            slot = (row[None, :] <= cums[:, None]).sum(1) - 1
            e_lo, e_hi = idx[r, cums >> 7], idx[r, (cums >> 7) + 1]
            lo, hi = e_lo & 0xFF, e_hi & 0xFF
            assert (lo <= slot).all() and (slot <= hi).all()
            assert (row[lo] == e_lo >> 8).all() and (row[hi] == e_hi >> 8).all()
            assert (row[lo] <= cums).all() and (hi <= tab.shape[1] - 2).all()


def test_slot_index_rejects_tables_it_cannot_index():
    with pytest.raises(ValueError, match="ascend"):
        slot_index(np.array([[1, 5, 65536]]))
    with pytest.raises(ValueError, match="ascend"):
        slot_index(np.array([[0, 5, 4, 65536]]))
    with pytest.raises(ValueError, match="ascend"):
        slot_index(np.array([[0, 5, 65535]]))
