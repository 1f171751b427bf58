"""Real bitstream encode/decode for the charm codecs with a decodable hyper
(``classic_dual``, ``elic``, ``unet_dec``: ``source_net``,
``source_net_wam``, ``net_ga``, ``net_unet_ha_hs_dec``).

Counterpart of the ``ChannelCoder`` charm branch of
``lic_tpu/models/compress.py``: ``compress``/``decompress``, their batched
forms, the ``LTC2`` container, ``_dev_scale_idx`` (``:111-119``) and
``slices_pass_impl`` (``:323-366``).  The wire format is the JAX
package's, byte for byte:

  magic 'LTC2' | u8 name-len | name | u32 digest (crc32 of the factorized
  CDF tables) | u16 H | u16 W (original size) | u16 syntax-len |
  i16 syntax[M] | u32 z_len | z blob | u32 y_len | y blob

z is coded by the host ``FactorizedCoder``; y by the host
``Rans16InterleavedCodec`` as one 128-lane interleaved stream per image,
slice after slice, each slice's symbols in NHWC (h, w, c) order.

Encode runs the slice chain once and takes the symbols from the latent: it
never launches the drain (the TPU path skipped it behind a ``lax.cond``).
Decode runs the same slice chain and drains each slice's symbols from the
streams through ``coding.rans_drain`` — kernel B1 on a CUDA tensor — with
the lane state threaded from slice to slice, then checks that every lane
ended at ``1 << 16`` and every pointer at its stream's end.

Encoder and decoder must compute bit-identical σ-indexes.  The coder sets
the numerics flags of ``set_numerics_flags`` (no TF32, deterministic
cuDNN, no algorithm search) and both sides run the same code.  cuDNN and
oneDNN pick their algorithms by shape, batch size included: on an H100 the
hyper decoder, the ChARM and LRP convs, g_s and the rich g_a give other
bits for an image at B = 1 than inside a batch of 8, enough to move a
σ-index (ROADMAP §C5).  So every model pass runs on exactly
``pass_batch(H, W, device)`` images of the padded size H×W
(``_passes``): a batch is cut into passes of that many, the last filled
up with copies of the batch's last image, and the copies are dropped
after.  Each pass then sees the same shapes whatever the batch, and the
kernels compute each image on its own, so a stream's bytes and its
reconstruction are the same whichever batch encodes or decodes it on a
device of the same kind (``chip_smoke.py`` [c5] holds this on the card).
The host rANS coding and the drain take the streams of the batch as they
are; both treat each stream on its own.

``entro_pass_impl`` (entroformer checkerboard, ROADMAP A14) and the
neural-syntax wavefront coder (ROADMAP A15) are not ported.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Tuple

import numpy as np
import torch

from ..coding import (
    DeviceRans16Interleaved,
    FactorizedCoder,
    GaussianCoder,
    Rans16InterleavedCodec,
    load_host_rans,
    rans_drain,
    stack_payloads,
)
from ..data.pad import pad_to_multiple, padded_size
from .codec import CodecModel

MAGIC = b"LTC2"
Z_RANGE = 128  # factorized-prior symbol support: [-128, 127] rel. medians
_SYM_CLIP = 32000  # int16-safe symbol range (escapes code |s| > radius)
CHARM_LANES = 128
# hypers whose decoder reads nothing but coded data
_DECODABLE = ("classic_dual", "elic", "unet_dec")


def set_numerics_flags() -> None:
    """fp32 convolutions and matmuls without TF32, deterministic cuDNN
    algorithms and no benchmark-mode algorithm search: encoder and decoder
    must compute bit-identical σ-indexes, and parity with the JAX package
    is held in full fp32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def dev_scale_idx(sigma: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Scale-table index on the device (uint8): ``searchsorted(table,
    max(σ, table[0]) − 1e-9)``, side left — ``_dev_scale_idx``'s
    semantics, run identically by encoder and decoder."""
    s = torch.maximum(sigma, table[0]).contiguous()
    idx = torch.searchsorted(table, s - 1e-9)
    return idx.clamp(0, table.shape[0] - 1).to(torch.uint8)


# images per model pass on the card: as many of the padded size as fit in
# the pixels of a batch of 8 Kodak images, at most 8 and at least 1
PASS_PIXELS = 8 * 512 * 768
MAX_PASS_BATCH = 8


def pass_batch(h: int, w: int, device: torch.device) -> int:
    """Images per model pass at the padded image size h×w on ``device``.
    On the CPU one: its elementwise kernels split a tensor among threads
    and finish each share with scalar code, whose exp or sqrt can differ
    from the vector code's in the last bit, so there an element's bits
    depend on where in the batch it sits.  A CUDA kernel gives every
    element the same instructions."""
    if device.type == "cpu":
        return 1
    return max(1, min(MAX_PASS_BATCH, PASS_PIXELS // (h * w)))


def _fill(t: torch.Tensor, n: int) -> torch.Tensor:
    """``t`` with copies of its last image appended up to ``n`` images."""
    if t.shape[0] == n:
        return t
    extra = t[-1:].expand(n - t.shape[0], *t.shape[1:])
    return torch.cat([t, extra]).contiguous(memory_format=torch.channels_last)


def _passes(fn, p: int, *batches):
    """``fn`` on the batches in passes of ``p`` images, the last filled up
    with copies of the last image; its outputs (a tensor or a tuple of
    them) concatenated and cut back to the batch."""
    b = batches[0].shape[0]
    n = -(-b // p) * p
    outs = [fn(*chunk) for chunk in zip(*(_fill(t, n).split(p) for t in batches))]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o)[:b] for o in zip(*outs))
    return torch.cat(outs)[:b]


def _nhwc_flat(t: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, H·W·C) in the wire's (h, w, c) symbol order."""
    return t.permute(0, 2, 3, 1).reshape(t.shape[0], -1)


class ChannelCoder:
    """Real-bitstream coder for one charm ``CodecModel`` with a decodable
    hyper, on the model's device."""

    def __init__(self, model: CodecModel, name: str = ""):
        cfg = model.cfg
        if cfg.hyper not in _DECODABLE:
            raise ValueError(
                f"hyper path '{cfg.hyper}' is not decodable: the "
                "reference feeds encoder-side activations into its hyper "
                "decoder (see lic_tpu.models.compress docstring); use a "
                "'classic_dual', 'elic' or 'unet_dec' preset for real bitstreams (or "
                "the neural_syntax family's wavefront coder)"
            )
        set_numerics_flags()
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.name = name or f"{cfg.family}.{cfg.transform}.{cfg.hyper}.{cfg.context}"
        self.host_library = load_host_rans()
        with torch.no_grad():
            medians = model.eb_medians().detach().float()
            pmf = model.eb_pmf_table(-Z_RANGE, Z_RANGE - 1)
        self.z_coder = FactorizedCoder(
            pmf.cpu().numpy(), medians.cpu().numpy(), -Z_RANGE
        )
        self.y_coder = GaussianCoder()
        self.med = medians[None, :, None, None]
        self.tab = torch.as_tensor(
            self.y_coder.scale_table, dtype=torch.float32, device=self.device
        )
        cdfs, offsets = self.y_coder.codec.cdfs, self.y_coder.codec.offsets
        self.lane_codec = Rans16InterleavedCodec(cdfs, offsets)
        self.dev_rans = DeviceRans16Interleaved(
            cdfs, offsets, CHARM_LANES, device=self.device
        )
        # weights digest: crc32 of the quantized factorized-prior CDF tables
        self.digest = zlib.crc32(self.z_coder.codec.cdfs.tobytes()) & 0xFFFFFFFF

    # ------------------------------------------------------ device passes

    def _z_enc(self, z3, p):
        z = _passes(self.model.hyper_encode, p, z3)
        sym = torch.clamp(torch.round(z - self.med), -_SYM_CLIP, _SYM_CLIP)
        return sym.to(torch.int16), sym + self.med

    def _slices_pass(self, z_hat, p, y=None, payload=None):
        """The whole slice chain, each model call in passes of ``p``
        images (``_passes``), in one of two modes.  Encode (``y`` given): symbols
        come from the latent.  Decode (``payload`` given): each slice's
        symbols are drained from the streams.  Returns (symbols (B, S)
        int16, rows (B, S) uint8, y_hat (B, N, h, w), lanes)."""
        model, cfg = self.model, self.model.cfg
        b = z_hat.shape[0]
        scales, means = _passes(model.hyper_decode, p, z_hat)
        y_slices = y.chunk(cfg.num_slices, dim=1) if y is not None else None
        lanes = self.dev_rans.init_lanes(payload) if payload is not None else None
        supports, syms_out, rows_out = [], [], []
        for i in range(cfg.num_slices):
            mu, sigma, msup = _passes(
                lambda m, s, *sup: model.charm_entropy_params(m, s, list(sup), i),
                p, means, scales, *model.support(supports))
            rows = dev_scale_idx(sigma, self.tab)
            if payload is None:
                sym = torch.clamp(
                    torch.round(y_slices[i] - mu), -_SYM_CLIP, _SYM_CLIP
                )
            else:
                rows_flat = _nhwc_flat(rows).to(torch.int32)
                lanes, dec = rans_drain(
                    self.dev_rans, lanes, payload, rows_flat, rows_flat.shape[1]
                )
                _, c, h, w = mu.shape
                sym = dec.view(b, h, w, c).permute(0, 3, 1, 2).float()
            supports.append(_passes(lambda ms, yh: model.charm_apply_lrp(ms, yh, i),
                                    p, msup, sym + mu))
            syms_out.append(_nhwc_flat(sym).to(torch.int16))
            rows_out.append(_nhwc_flat(rows))
        return (
            torch.cat(syms_out, dim=1),
            torch.cat(rows_out, dim=1),
            torch.cat(supports, dim=1),
            lanes,
        )

    def _step_counts(self, hy: int, wy: int) -> List[int]:
        cfg = self.model.cfg
        return [hy * wy * (cfg.N // cfg.num_slices)] * cfg.num_slices

    # ------------------------------------------------------------- encode

    def _to_device(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device, torch.float32, memory_format=torch.channels_last)

    @torch.no_grad()
    def compress(self, x: torch.Tensor) -> bytes:
        """x: (1, 3, H, W) in [−1, 1], any size (padded to /64 inside;
        the original size rides the header)."""
        if x.shape[0] != 1:
            raise ValueError("compress takes one image; use compress_batch")
        return self.compress_batch(x)[0]

    @torch.no_grad()
    def compress_batch(self, xs: torch.Tensor) -> List[bytes]:
        """Compress B same-sized images (B, 3, H, W): the model in passes
        of ``pass_batch`` images, the host rANS encodes in a thread pool
        (the C coder releases the interpreter lock)."""
        b, _, h, w = xs.shape
        xs, _ = pad_to_multiple(self._to_device(xs), 64)
        p = pass_batch(*xs.shape[2:], self.device)
        z3 = _passes(self.model.analyze, p, xs)
        z_sym16, z_hat = self._z_enc(z3, p)
        syntax = _passes(self.model.syntax_from_latent, p, z3)
        sym, rows, _, _ = self._slices_pass(z_hat, p, y=z3)

        syntax_np = syntax.reshape(b, -1).cpu().numpy().astype(np.int16)
        z_np = z_sym16.permute(0, 2, 3, 1).cpu().numpy()  # NHWC for the host
        sym_np, rows_np = sym.cpu().numpy(), rows.cpu().numpy()
        counts = self._step_counts(z3.shape[2], z3.shape[3])

        def encode(i):
            z_blob = self.z_coder.encode_symbols(z_np[i : i + 1])
            y_blob = self.lane_codec.encode(
                sym_np[i], rows_np[i], counts, CHARM_LANES
            )
            return self._pack(h, w, syntax_np[i], z_blob, y_blob)

        with ThreadPoolExecutor(max_workers=min(b, os.cpu_count() or 1)) as pool:
            return list(pool.map(encode, range(b)))

    def _pack(self, h, w, syntax, z_blob, y_blob) -> bytes:
        out = bytearray(MAGIC)
        name = self.name.encode("utf-8")[:255]
        out += struct.pack("<B", len(name)) + name
        out += struct.pack("<I", self.digest)
        out += struct.pack("<HH", h, w)
        out += struct.pack("<H", syntax.size) + syntax.tobytes()
        for blob in (z_blob, y_blob):
            out += struct.pack("<I", len(blob)) + blob
        return bytes(out)

    # ------------------------------------------------------------- decode

    def _parse_header(self, data: bytes) -> Tuple[int, int, int, np.ndarray]:
        """→ (offset past header, orig_h, orig_w, syntax int16 array)."""
        if data[:4] != MAGIC:
            raise ValueError("bad magic — not an LTC2 bitstream")
        off = 4
        (nlen,) = struct.unpack_from("<B", data, off)
        off += 1
        name = data[off : off + nlen].decode("utf-8")
        off += nlen
        (digest,) = struct.unpack_from("<I", data, off)
        off += 4
        if name != self.name:
            raise ValueError(
                f"bitstream was produced by model '{name}', this coder is "
                f"'{self.name}'"
            )
        if digest != self.digest:
            raise ValueError(
                "bitstream weights digest mismatch — decoding with "
                "different parameters than it was encoded with"
            )
        orig_h, orig_w = struct.unpack_from("<HH", data, off)
        off += 4
        (m_len,) = struct.unpack_from("<H", data, off)
        off += 2
        syntax = np.frombuffer(data, np.int16, m_len, off)
        return off + m_len * 2, orig_h, orig_w, syntax

    @torch.no_grad()
    def decompress(self, data: bytes) -> torch.Tensor:
        return self.decompress_batch([data])

    @torch.no_grad()
    def decompress_batch(self, blobs: List[bytes]) -> torch.Tensor:
        """Decode B same-sized bitstreams → (B, 3, H, W) reconstruction."""
        b = len(blobs)
        heads = [self._parse_header(d) for d in blobs]
        orig_h, orig_w = heads[0][1], heads[0][2]
        if any((hd[1], hd[2]) != (orig_h, orig_w) for hd in heads):
            raise ValueError("decompress_batch needs same-sized bitstreams")
        h, w = padded_size(orig_h, orig_w, 64)
        z_shape = (1, h // 64, w // 64, self.z_coder.medians.shape[0])

        z_syms, payloads = [], []
        for data, (off, _, _, _) in zip(blobs, heads):
            (z_len,) = struct.unpack_from("<I", data, off)
            off += 4
            z_syms.append(
                self.z_coder.decode_symbols(data[off : off + z_len], z_shape)
            )
            off += z_len
            (y_len,) = struct.unpack_from("<I", data, off)
            off += 4
            n_lanes, pay = Rans16InterleavedCodec.parse(data[off : off + y_len])
            if n_lanes != CHARM_LANES:
                raise ValueError(
                    f"rans16i lane count mismatch: stream {n_lanes}, "
                    f"decoder {CHARM_LANES}"
                )
            payloads.append(pay)
        z_sym = torch.from_numpy(np.concatenate(z_syms, axis=0)).permute(0, 3, 1, 2)
        z_hat = self._to_device(z_sym) + self.med

        pay_np, ends = stack_payloads(payloads, CHARM_LANES)
        payload = torch.from_numpy(pay_np).to(self.device)

        p = pass_batch(h, w, self.device)
        _, _, y_hat, lanes = self._slices_pass(z_hat, p, payload=payload)
        ends_t = torch.as_tensor(ends, dtype=torch.int64, device=self.device)
        if not (bool(torch.all(lanes.state == 1 << 16))
                and bool(torch.all(lanes.ptr == ends_t))):
            raise ValueError(
                "corrupt or truncated rans16i stream (final-state check)"
            )
        syn = torch.from_numpy(
            np.stack([hd[3] for hd in heads]).astype(np.float32)
        ).reshape(b, -1, 1, 1).to(self.device)
        rec = _passes(self.model.synthesize, p, y_hat, syn)
        return rec[:, :, :orig_h, :orig_w]
