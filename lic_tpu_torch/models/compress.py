"""Real bitstream encode/decode: the charm codecs with a decodable hyper
(``classic_dual``, ``elic``, ``unet_dec``: ``source_net``,
``source_net_wam``, ``net_ga``, ``net_unet_ha_hs_dec``), their
entroformer checkerboard form (``entroformer_cb``, ``entroformer_cb_full``)
and the neural-syntax wavefront coder (``neural_syntax``).

Counterpart of ``ChannelCoder`` in ``lic_tpu/models/compress.py``:
``compress``/``decompress``, their batched forms, the ``LTC2`` container,
``_dev_scale_idx`` (``:111-119``), ``slices_pass_impl`` (``:323-366``),
``entro_pass_impl`` (``:368-429``), ``wavefront_groups`` (``:80-92``) and
the wavefront coder (``:440-487``, ``:776-1136``).  The wire format is the
JAX package's, byte for byte:

  magic 'LTC2' | u8 name-len | name | u32 digest | u16 H | u16 W
  (original size) | u16 syntax-len | i16 syntax[M] | [f32 rate] |
  u32 z_len | z blob | per blob: u32 len | blob

The rate field is there for gain-unit models only: each image's
continuous rate index, so any decoder of the checkpoint applies the
matching inverse gain.  The coded latent is the gained one, so only
``analyze`` and ``synthesize`` see the rate; a batch may mix rates, each
image's riding through the model passes beside it (``_passes``).

charm: the digest is the crc32 of the factorized CDF tables (from the
host pmf table, ``entropy.factorized.xla_pmf_table``: the JAX package's
bits on any device, ROADMAP §C7), z is coded
by the host ``FactorizedCoder`` and y by the host
``Rans16InterleavedCodec`` as one 128-lane interleaved stream per image:
slice after slice, each slice's symbols in NHWC (h, w, c) order; for the
entroformer, the anchors' symbols, then the non-anchors', each in that
order restricted to them.

neural syntax: the digest is the crc32 of the σ_z2 bytes; the header's
syntax field is empty; z2 is the host ``GaussianCoder`` under N(0,
|σ_z2|), then two blobs: the syntax vector under ``GaussianMuCoder`` with
``PredictionModelSyntax``'s (μ, σ), and the content as one interleaved
stream of L lanes (``ns_lane_count``) over ``GaussianMuCoder``'s 1,024
rows, in (wavefront t, position p, channel c) order.  The 4×4 causal
context lets every position of the anti-diagonal t = 2·row + col depend
on earlier wavefronts only, so the decode is a loop over T = 2(h−1) + w
wavefronts: gather the positions' patches, run the context head, compute
each symbol's row, drain the wavefront's symbols (one B1 launch) and
scatter the values.

Encode runs the same passes as decode but takes the symbols from the
latent: it never launches the drain (the TPU path skipped it behind a
``lax.cond``).  Decode drains each step's symbols from the streams
through ``coding.rans_drain`` — kernel B1 on a CUDA tensor — with the lane
state threaded from step to step, then checks that every lane ended at
``1 << 16`` and every pointer at its stream's end.

Encoder and decoder must compute bit-identical rows.  The coder sets the
numerics flags of ``set_numerics_flags`` (no TF32, deterministic cuDNN,
no algorithm search) and both sides run the same code.  cuDNN and oneDNN
pick their algorithms by shape, batch size included: on an H100 the
hyper decoder, the ChARM and LRP convs, g_s and the rich g_a give other
bits for an image at B = 1 than inside a batch of 8, enough to move a
σ-index (ROADMAP §C5).  So every model pass runs on exactly
``pass_batch(H, W, device)`` images of the padded size H×W
(``_passes``): a batch is cut into passes of that many, the last filled
up with copies of the batch's last image, and the copies are dropped
after.  The entroformer passes, the neural-syntax hyper and syntax
passes and every wavefront's context head (on ``pass_batch`` × p_max
patches, p_max the longest wavefront) run so too.  Each pass then sees
the same shapes whatever the batch, and the kernels compute each image on
its own, so a stream's bytes and its reconstruction are the same
whichever batch encodes or decodes it on a device of the same kind
(``chip_smoke.py`` [c5] holds this on the card).  The host rANS coding
and the drain take the streams of the batch as they are; both treat each
stream on its own.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..coding import (
    DeviceRans16Interleaved,
    FactorizedCoder,
    GaussianCoder,
    GaussianMuCoder,
    Rans16InterleavedCodec,
    load_host_rans,
    rans_drain,
    stack_payloads,
)
from ..data.pad import pad_to_multiple, padded_size
from ..layers.entroformer import checkerboard_masks
from .codec import DECODABLE_HYPERS, CodecModel

MAGIC = b"LTC2"
Z_RANGE = 128  # factorized-prior symbol support: [-128, 127] rel. medians
_SYM_CLIP = 32000  # int16-safe symbol range (escapes code |s| > radius)
CHARM_LANES = 128


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
    """``t`` with copies of its last image appended up to ``n`` images
    (a 4-D map in ``channels_last``)."""
    if t.shape[0] == n:
        return t
    extra = t[-1:].expand(n - t.shape[0], *t.shape[1:])
    out = torch.cat([t, extra])
    return out.contiguous(memory_format=torch.channels_last) if out.dim() == 4 else out


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


def _from_nhwc_flat(t: torch.Tensor, c: int, h: int, w: int) -> torch.Tensor:
    """The inverse of ``_nhwc_flat``, in ``channels_last``."""
    return t.reshape(t.shape[0], h, w, c).permute(0, 3, 1, 2)


def wavefront_groups(h: int, w: int):
    """The anti-diagonal schedule of the 4×4 causal context: positions of
    equal t = 2·row + col are independent and depend only on earlier t.
    → [(rows, cols)] int64 arrays, t ascending."""
    groups = []
    for t in range(2 * (h - 1) + w):
        p_min = max(0, -(-(t - w + 1) // 2))
        p_max = min(h - 1, t // 2)
        if p_min > p_max:
            continue
        ps = np.arange(p_min, p_max + 1, dtype=np.int64)
        groups.append((ps, t - 2 * ps))
    return groups


def ns_lane_count(total_syms: int) -> int:
    """Lanes of the neural-syntax content stream: doubled from 1 while
    every lane keeps >= 256 symbols of half the stream, at most 256, at
    least 8 (``_ns_lane_count``)."""
    n = 1
    while n < 256 and total_syms // (2 * n) >= 256:
        n *= 2
    return max(n, 8)


def factorized_z_coder(model: CodecModel) -> Tuple[FactorizedCoder, torch.Tensor, int]:
    """The hyper stream's coder of a charm model: ``FactorizedCoder`` over
    the entropy bottleneck's pmf table on [−Z_RANGE, Z_RANGE) about its
    medians (the host table, the JAX package's bits on any device), the
    medians as (1, C, 1, 1) on the model's device, and the weights digest,
    crc32 of the quantized CDF tables."""
    with torch.no_grad():
        medians = model.eb_medians().detach().float()
        pmf = model.eb_pmf_table(-Z_RANGE, Z_RANGE - 1)
    coder = FactorizedCoder(pmf.cpu().numpy(), medians.cpu().numpy(), -Z_RANGE)
    digest = zlib.crc32(coder.codec.cdfs.tobytes()) & 0xFFFFFFFF
    return coder, medians[None, :, None, None], digest


def z_encode(model: CodecModel, z3: torch.Tensor, med: torch.Tensor, p: int):
    """z3 → (z symbols int16, ẑ): the hyper encoder in passes of ``p``
    images, z rounded about the medians."""
    z = _passes(model.hyper_encode, p, z3)
    sym = torch.clamp(torch.round(z - med), -_SYM_CLIP, _SYM_CLIP)
    return sym.to(torch.int16), sym + med


class ChannelCoder:
    """Real-bitstream coder for one ``CodecModel`` (a charm model with a
    decodable hyper, or a neural-syntax model), on the model's device.
    ``rate``: the default gain-unit rate index of a variable-rate model
    (None: 0); a rate given to a model without gain units raises."""

    def __init__(self, model: CodecModel, name: str = "", rate: Optional[float] = None):
        cfg = model.cfg
        self.has_gain = cfg.gain_units > 0
        if rate is not None and not self.has_gain:
            raise ValueError(
                "rate= was given but this model has no gain units "
                "(cfg.gain_units == 0) — it would be silently ignored; "
                "use a variable-rate preset (e.g. source_net_vr) or drop "
                "the rate"
            )
        self.rate = 0.0 if rate is None else float(rate)
        self.is_ns = cfg.family == "neural_syntax"
        self.is_entro = not self.is_ns and cfg.context == "entroformer"
        if not self.is_ns and cfg.hyper not in DECODABLE_HYPERS:
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
        if self.is_ns:
            self._init_neural_syntax()
            return
        self.z_coder, self.med, self.digest = factorized_z_coder(model)
        self.y_coder = GaussianCoder()
        self.tab = torch.as_tensor(
            self.y_coder.scale_table, dtype=torch.float32, device=self.device
        )
        cdfs, offsets = self.y_coder.codec.cdfs, self.y_coder.codec.offsets
        self.lane_codec = Rans16InterleavedCodec(cdfs, offsets)
        self.dev_rans = DeviceRans16Interleaved(
            cdfs, offsets, CHARM_LANES, device=self.device
        )

    def _init_neural_syntax(self):
        with torch.no_grad():
            sigma = self.model.ns_z2_sigma().detach().float().cpu().numpy()
        self.z2_sigma = np.abs(sigma)  # (N,) float32
        self.z2_coder = GaussianCoder()
        self.mu_coder = GaussianMuCoder()
        cdfs, offsets = self.mu_coder.codec.cdfs, self.mu_coder.codec.offsets
        self.lane_codec = Rans16InterleavedCodec(cdfs, offsets)
        self.tab = torch.as_tensor(
            self.mu_coder.scale_table, dtype=torch.float32, device=self.device
        )
        self._dev_rans = {}  # lane count → DeviceRans16Interleaved
        self._ns_schedules = {}  # (h, w) of the latent → wavefront steps
        self.digest = zlib.crc32(self.z2_sigma.tobytes()) & 0xFFFFFFFF

    # ------------------------------------------------------ device passes

    def _z_enc(self, z3, p):
        return z_encode(self.model, z3, self.med, p)

    def _slices_pass(self, z_hat, p, y=None, payload=None):
        """The whole slice chain (the entroformer's two passes where the
        model has that context), each model call in passes of ``p``
        images (``_passes``), in one of two modes.  Encode (``y`` given):
        symbols come from the latent.  Decode (``payload`` given): each
        step's symbols are drained from the streams.  Returns (symbols
        (B, S) int16, rows (B, S) uint8, y_hat (B, N, h, w), lanes)."""
        if self.is_entro:
            return self._entro_pass(z_hat, p, y, payload)
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

    def _entro_pass(self, z_hat, p, y=None, payload=None):
        """The checkerboard analogue of the slice chain: the anchors'
        symbols from the hyper alone, then the non-anchors' given the
        decoded anchors (``entro_pass_impl``); each pass one B1 launch at
        decode.  Symbols in NHWC flat order, restricted to each half."""
        model = self.model
        scales, means = _passes(model.hyper_decode, p, z_hat)
        b, c, yh, yw = z_hat.shape[0], model.cfg.N, *scales.shape[2:]
        anchor = np.broadcast_to(checkerboard_masks(yh, yw)[0][:, :, None], (yh, yw, c))
        idxs = [torch.from_numpy(np.flatnonzero(m.reshape(-1))).to(self.device)
                for m in (anchor, ~anchor)]
        h_emb = _passes(model.entro_embed_hyper, p, scales, means)
        y_flat = _nhwc_flat(y) if y is not None else None
        lanes = self.dev_rans.init_lanes(payload) if payload is not None else None
        known = torch.zeros((b, yh * yw * c), dtype=torch.float32, device=self.device)
        syms_out, rows_out = [], []
        for idx in idxs:
            y_in = _from_nhwc_flat(known, c, yh, yw).contiguous(
                memory_format=torch.channels_last)
            mu, sigma = _passes(lambda yi, s, m, he: model.entro_predict(yi, s, m, he),
                                p, y_in, scales, means, h_emb)
            mu_f = _nhwc_flat(mu)[:, idx]
            rows = _nhwc_flat(dev_scale_idx(sigma, self.tab))[:, idx]
            if payload is None:
                sym = torch.clamp(torch.round(y_flat[:, idx] - mu_f), -_SYM_CLIP, _SYM_CLIP)
            else:
                lanes, dec = rans_drain(self.dev_rans, lanes, payload,
                                        rows.to(torch.int32), idx.numel())
                sym = dec.float()
            known[:, idx] = sym + mu_f
            syms_out.append(sym.to(torch.int16))
            rows_out.append(rows)
        y_hat = _from_nhwc_flat(known, c, yh, yw).contiguous(memory_format=torch.channels_last)
        return torch.cat(syms_out, dim=1), torch.cat(rows_out, dim=1), y_hat, lanes

    def _step_counts(self, hy: int, wy: int) -> List[int]:
        """Symbols per drain step in decode order: one entry per ChARM
        slice, or [anchors, non-anchors] for the checkerboard."""
        cfg = self.model.cfg
        if self.is_entro:
            n_anchor = int(checkerboard_masks(hy, wy)[0].sum()) * cfg.N
            return [n_anchor, hy * wy * cfg.N - n_anchor]
        return [hy * wy * (cfg.N // cfg.num_slices)] * cfg.num_slices

    # ------------------------------------------------------------- encode

    def _to_device(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.device, torch.float32, memory_format=torch.channels_last)

    def _rates(self, rates: Optional[Sequence[float]], b: int) -> Optional[torch.Tensor]:
        """The (B,) rate indexes of a batch on the device (the coder's
        rate where None); None for a model without gain units, where a
        rate raises."""
        if rates is not None and not self.has_gain:
            raise ValueError("rate= was given but this model has no gain units")
        if not self.has_gain:
            return None
        rates = [self.rate] * b if rates is None else [float(r) for r in rates]
        if len(rates) != b:
            raise ValueError(f"{len(rates)} rates for {b} images")
        return torch.tensor(rates, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def compress(self, x: torch.Tensor, rate: Optional[float] = None) -> bytes:
        """x: (1, 3, H, W) in [−1, 1], any size (padded to /64 inside;
        the original size rides the header).  ``rate``: this image's
        gain-unit rate index (default the coder's), e.g. from
        ``serving.solve_rate_for_bpp``."""
        if x.shape[0] != 1:
            raise ValueError("compress takes one image; use compress_batch")
        return self.compress_batch(x, None if rate is None else [rate])[0]

    @torch.no_grad()
    def compress_batch(self, xs: torch.Tensor,
                       rates: Optional[Sequence[float]] = None) -> List[bytes]:
        """Compress B same-sized images (B, 3, H, W): the model in passes
        of ``pass_batch`` images, the host rANS encodes in a thread pool
        (the C coder releases the interpreter lock).  ``rates``: one
        gain-unit rate index per image (gain-unit models; default the
        coder's rate); a batch may mix them."""
        b, _, h, w = xs.shape
        rate_t = self._rates(rates, b)
        xs, _ = pad_to_multiple(self._to_device(xs), 64)
        p = pass_batch(*xs.shape[2:], self.device)
        if rate_t is None:
            z3 = _passes(self.model.analyze, p, xs)
        else:
            z3 = _passes(self.model.analyze, p, xs, rate_t)
        if self.is_ns:
            return self._compress_ns(z3, p, h, w)
        z_sym16, z_hat = self._z_enc(z3, p)
        syntax = _passes(self.model.syntax_from_latent, p, z3)
        sym, rows, _, _ = self._slices_pass(z_hat, p, y=z3)

        syntax_np = syntax.flatten(1).cpu().numpy().astype(np.int16)
        z_np = z_sym16.permute(0, 2, 3, 1).cpu().numpy()  # NHWC for the host
        sym_np, rows_np = sym.cpu().numpy(), rows.cpu().numpy()
        rates_host = [None] * b if rate_t is None else rate_t.tolist()
        counts = self._step_counts(z3.shape[2], z3.shape[3])

        def encode(i):
            z_blob = self.z_coder.encode_symbols(z_np[i : i + 1])
            y_blob = self.lane_codec.encode(
                sym_np[i], rows_np[i], counts, CHARM_LANES
            )
            return self._pack(h, w, syntax_np[i], z_blob, [y_blob], rates_host[i])

        return self._pool_map(encode, b)

    @staticmethod
    def _pool_map(fn, n: int) -> list:
        with ThreadPoolExecutor(max_workers=min(n, os.cpu_count() or 1)) as pool:
            return list(pool.map(fn, range(n)))

    def _pack(self, h, w, syntax, z_blob, blobs, rate: Optional[float] = None) -> bytes:
        out = bytearray(MAGIC)
        name = self.name.encode("utf-8")[:255]
        out += struct.pack("<B", len(name)) + name
        out += struct.pack("<I", self.digest)
        out += struct.pack("<HH", h, w)
        out += struct.pack("<H", syntax.size) + syntax.tobytes()
        if self.has_gain:
            out += struct.pack("<f", rate)
        for blob in (z_blob, *blobs):
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

    @staticmethod
    def _blobs(data: bytes, off: int, n: int) -> List[bytes]:
        """The ``n`` length-prefixed blobs from ``off`` on."""
        out = []
        for _ in range(n):
            (size,) = struct.unpack_from("<I", data, off)
            off += 4
            out.append(data[off : off + size])
            off += size
        return out

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
        if self.is_ns:
            return self._decompress_ns(blobs, [hd[0] for hd in heads], h, w)[
                :, :, :orig_h, :orig_w]
        z_shape = (1, h // 64, w // 64, self.z_coder.medians.shape[0])

        z_syms, payloads, rates = [], [], []
        for data, (off, _, _, _) in zip(blobs, heads):
            if self.has_gain:
                rates.append(struct.unpack_from("<f", data, off)[0])
                off += 4
            z_blob, y_blob = self._blobs(data, off, 2)
            z_syms.append(self.z_coder.decode_symbols(z_blob, z_shape))
            n_lanes, pay = Rans16InterleavedCodec.parse(y_blob)
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
        self._check_final(lanes, ends)
        # (B, M, 1, 1); M is 0 for a model without a syntax model
        syn = torch.from_numpy(
            np.stack([hd[3] for hd in heads]).astype(np.float32)
        )[:, :, None, None].to(self.device)
        if self.has_gain:  # each image's header rate
            rate_t = torch.tensor(rates, dtype=torch.float32, device=self.device)
            rec = _passes(self.model.synthesize, p, y_hat, syn, rate_t)
        else:
            rec = _passes(self.model.synthesize, p, y_hat, syn)
        return rec[:, :, :orig_h, :orig_w]

    def _check_final(self, lanes, ends) -> None:
        """Every lane ended at ``1 << 16`` and every pointer at its
        stream's end."""
        ends_t = torch.as_tensor(ends, dtype=torch.int64, device=self.device)
        if not (bool(torch.all(lanes.state == 1 << 16))
                and bool(torch.all(lanes.ptr == ends_t))):
            raise ValueError(
                "corrupt or truncated rans16i stream (final-state check)"
            )

    # ------------------------------------------ neural-syntax wavefronts

    def ns_dev_rans(self, n_lanes: int) -> DeviceRans16Interleaved:
        """The device decoder over ``GaussianMuCoder``'s table at
        ``n_lanes`` lanes (the lane count depends on the latent size)."""
        if n_lanes not in self._dev_rans:
            self._dev_rans[n_lanes] = DeviceRans16Interleaved(
                self.mu_coder.codec.cdfs, self.mu_coder.codec.offsets, n_lanes,
                device=self.device)
        return self._dev_rans[n_lanes]

    def _ns_rows(self, mu: torch.Tensor, sigma: torch.Tensor):
        """``GaussianMuCoder`` rows (int32) and round(μ) (int32) of each
        symbol: scale index · n_delta + the δ bin of μ − round(μ)."""
        nd = self.mu_coder.n_delta
        mu_r = torch.round(mu)
        si = dev_scale_idx(sigma, self.tab).long()
        dj = torch.clamp(torch.floor((mu - mu_r + 0.5) * nd), 0, nd - 1).long()
        return (si * nd + dj).to(torch.int32), mu_r.to(torch.int32)

    def _wavefronts(self, h2, p, y_known=None, payload=None, n_lanes=None, stage=None):
        """The wavefront loop over T = 2(h−1) + w steps, in one of two
        modes.  Encode (``y_known`` (B, c, h, w) int given): each step's
        values come from the latent.  Decode (``payload`` given): each
        step drains its ``n·c`` symbols (one B1 launch).  Each step: the
        (B, p_max) context patches (positions past the step's n gather the
        zero border), the context head in passes of ``p`` images, the
        rows, the symbols and the scatter into the padded plane.
        ``stage(name)``, where given, is called after each step's
        "head", "rows" and "drain".  → (residuals (T, B, p_max, c) int,
        rows (T, B, p_max, c) int32, plane (B, c, h, w), lanes)."""
        c = self.model.cfg.N - self.model.cfg.M
        b, _, hy, wy = h2.shape
        steps, p_max = self._ns_schedule(hy, wy)
        hpad = torch.nn.functional.pad(h2, (3, 3, 3, 3))
        ypad = torch.zeros((b, c, hy + 6, wy + 6), dtype=torch.float32, device=self.device)
        dev = self.ns_dev_rans(n_lanes) if payload is not None else None
        lanes = dev.init_lanes(payload) if payload is not None else None
        mark = stage or (lambda name: None)
        res_out, rows_out = [], []
        for n, rr, cc, pt, qt in steps:
            ypat = ypad[:, :, rr, cc]  # (B, c, p_max, 4, 4)
            ypat[:, :, :, 3, 2:] = 0.0  # the causal mask
            merged = torch.cat([ypat, hpad[:, :, rr, cc]], dim=1).transpose(1, 2)
            mu, sg = _passes(self._ns_head, p, merged.contiguous())
            mark("head")
            rows, mu_i = self._ns_rows(mu, sg)  # (B, p_max, c)
            mark("rows")
            if payload is None:
                yk = y_known[:, :, pt - 3, qt - 3].transpose(1, 2)  # (B, n, c)
                vals = yk
                res = torch.zeros_like(mu_i)
                res[:, :n] = torch.clamp(yk - mu_i[:, :n], -_SYM_CLIP, _SYM_CLIP)
                res_out.append(res)
            else:
                lanes, dec = rans_drain(dev, lanes, payload, rows.reshape(b, -1), n * c)
                vals = dec.view(b, p_max, c)[:, :n] + mu_i[:, :n]
            mark("drain")
            ypad[:, :, pt, qt] = vals.transpose(1, 2).float()
            rows_out.append(rows)
        plane = ypad[:, :, 3 : 3 + hy, 3 : 3 + wy].contiguous(memory_format=torch.channels_last)
        res = torch.stack(res_out) if res_out else None
        return res, torch.stack(rows_out), plane, lanes

    def _ns_schedule(self, hy: int, wy: int):
        """The wavefront steps of an hy×wy latent on the device, built once:
        → ([(n, rows (p_max, 4, 4), cols (p_max, 4, 4), plane rows (n,),
        plane cols (n,))], p_max).  ``patch[i, j] = plane_pad[p + i,
        q + 1 + j]`` (``block_sample``'s geometry); a slot past a step's n
        reads the padded plane's zero corner, as the JAX scan's clamped
        out-of-range slots do."""
        key = (hy, wy)
        cache = self._ns_schedules
        if key not in cache:
            groups = wavefront_groups(hy, wy)
            p_max = max(len(ps) for ps, _ in groups)
            ii = np.arange(4)
            steps = []
            for ps, qs in groups:
                n = len(ps)
                rr = np.zeros((p_max, 4, 4), np.int64)
                cc = np.zeros((p_max, 4, 4), np.int64)
                rr[:n] = ps[:, None, None] + ii[None, :, None]
                cc[:n] = qs[:, None, None] + 1 + ii[None, None, :]
                on = lambda a: torch.from_numpy(a).to(self.device)
                steps.append((n, on(rr), on(cc), on(ps + 3), on(qs + 3)))
            cache[key] = (steps, p_max)
        return cache[key]

    def _ns_head(self, merged: torch.Tensor):
        """(p, p_max, C, 4, 4) patches → (μ, σ), each (p, p_max, c)."""
        pp, pm = merged.shape[:2]
        mu, sg = self.model.ns_context_head(merged.reshape(pp * pm, *merged.shape[2:]))
        return mu.reshape(pp, pm, -1), sg.reshape(pp, pm, -1)

    def _ns_hyper(self, z2_int: np.ndarray, p: int):
        """Integer z2 (B, h, w, N) → (h2, μ_s, σ_s): the hyper features and
        the syntax vector's parameters, (B, M) float32 numpy."""
        z2 = self._to_device(torch.from_numpy(z2_int.astype(np.float32)).permute(0, 3, 1, 2))
        h2 = _passes(self.model.ns_hyper_decode, p, z2)
        mu_s, sg_s = _passes(self.model.ns_syntax_params, p, h2)
        b = z2_int.shape[0]
        return (h2, mu_s.reshape(b, -1).cpu().numpy().astype(np.float32),
                sg_s.reshape(b, -1).cpu().numpy().astype(np.float32))

    def _compress_ns(self, z3, p, h, w) -> List[bytes]:
        """B same-sized images → B streams (``_compress_ns_batch``): z2
        and the syntax vector on the host, the content through the
        wavefront loop in encode mode."""
        cfg = self.model.cfg
        b = z3.shape[0]
        z2 = _passes(self.model.ns_hyper_encode, p, z3)
        z2_int = torch.round(z2).permute(0, 2, 3, 1).cpu().numpy().astype(np.int32)
        scales_z2 = np.broadcast_to(self.z2_sigma, z2_int.shape[1:])
        # h2 from the integers the decoder will decode
        h2, mu_s, sg_s = self._ns_hyper(z2_int, p)
        syn_int = _passes(self.model.syntax_from_latent, p, z3).reshape(b, -1)
        syn_int = syn_int.cpu().numpy().astype(np.int32)
        y_int = torch.round(z3[:, cfg.M :]).to(torch.int32)
        hy, wy = y_int.shape[2:]
        res, rows, _, _ = self._wavefronts(h2, p, y_known=y_int)
        groups = wavefront_groups(hy, wy)
        c = cfg.N - cfg.M
        n_lanes = ns_lane_count(hy * wy * c)
        # the valid (t, p) slots in wavefront order
        vt = np.concatenate([np.full(len(ps), t) for t, (ps, _) in enumerate(groups)])
        vp = np.concatenate([np.arange(len(ps)) for ps, _ in groups])
        res_np, rows_np = res.cpu().numpy()[vt, :, vp], rows.cpu().numpy()[vt, :, vp]
        counts = [len(ps) * c for ps, _ in groups]

        def encode(i):
            z_blob = self.z2_coder.encode_symbols(z2_int[i], scales_z2)
            s_blob = self.mu_coder.encode_ints(syn_int[i], mu_s[i], sg_s[i])
            y_blob = self.lane_codec.encode(np.ascontiguousarray(res_np[:, i]),
                                            np.ascontiguousarray(rows_np[:, i]), counts,
                                            n_lanes)
            return self._pack(h, w, np.zeros((0,), np.int16), z_blob, [s_blob, y_blob])

        return self._pool_map(encode, b)

    def _decompress_ns(self, blobs, offs, h, w) -> torch.Tensor:
        """B same-sized neural-syntax streams → (B, 3, h, w), padded size
        (``_decompress_ns_batch``), with the final-state check."""
        cfg = self.model.cfg
        b = len(blobs)
        z_shape = (h // 64, w // 64, cfg.N)
        z_idx = self.z2_coder.scale_indexes(np.broadcast_to(self.z2_sigma, z_shape))
        z2_int = np.zeros((b,) + z_shape, np.int32)
        s_blobs, payloads, lane_counts = [], [], set()
        for i, (data, off) in enumerate(zip(blobs, offs)):
            z_blob, s_blob, y_blob = self._blobs(data, off, 3)
            z2_int[i] = self.z2_coder.codec.decode(z_blob, z_idx).reshape(z_shape)
            s_blobs.append(s_blob)
            n_lanes, pay = Rans16InterleavedCodec.parse(y_blob)
            lane_counts.add(n_lanes)
            payloads.append(pay)
        if len(lane_counts) > 1:
            raise ValueError("mixed rans16i lane counts in one decode batch")
        p = pass_batch(h, w, self.device)
        h2, mu_s, sg_s = self._ns_hyper(z2_int, p)
        syn_int = np.stack([self.mu_coder.decode_ints(s_blobs[i], mu_s[i], sg_s[i])
                            for i in range(b)])
        hy, wy = h2.shape[2:]
        want = ns_lane_count(hy * wy * (cfg.N - cfg.M))
        if n_lanes != want:
            raise ValueError(f"rans16i lane count mismatch: stream {n_lanes}, decoder {want}")
        pay_np, ends = stack_payloads(payloads, n_lanes)
        payload = torch.from_numpy(pay_np).to(self.device)
        _, _, plane, lanes = self._wavefronts(h2, p, payload=payload, n_lanes=n_lanes)
        self._check_final(lanes, ends)
        syn = torch.from_numpy(syn_int.astype(np.float32)).reshape(b, -1, 1, 1).to(self.device)
        return _passes(self.model.synthesize, p, plane, syn)
