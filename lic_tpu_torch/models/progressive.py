"""Progressive (scalable) bitstreams for the ChARM slice family: one
``.ltcp`` stream that decodes at every trit-plane boundary.

Counterpart of ``lic_tpu/models/progressive.py``; the container is the JAX
package's, byte for byte:

  magic 'LTCP' | u8 name-len | name ('<preset>+prog') | u32 digest |
  u8 digit model (1 gaussian, 0 static) | u16 H | u16 W (original size) |
  u16 syntax-len | i16 syntax[M] | u32 z_len | z blob | u8 slices |
  per slice: u8 planes | per plane: u32 len | blob

Scheme (slice-major trit planes):

* the hyper stream z is the always-present base layer, coded as
  ``ChannelCoder`` codes it (``compress.factorized_z_coder``: the same
  host table and digest);
* each ChARM slice's integer residuals ``r = round(y − μ)`` are written in
  balanced ternary, MSB plane first, one rANS blob per plane, in NHWC
  (h, w, c) element order: by ``GaussianTritCoder`` from the slice's σ
  (float64 of the float32 σ, floored at 0.04), or by ``TritPlaneCoder``'s
  per-plane tables (``digit_model='static'``);
* a decode with a budget of n planes takes them slice-major: slices whose
  planes all fit reproduce the encoder's ŷ exactly, the slice the budget
  cuts fills its missing digits with 0, and later slices take ŷ = μ (+ LRP)
  from the decoded prefix.

Every model call (``analyze``, ``hyper_encode``, ``hyper_decode``,
``charm_entropy_params``, ``charm_apply_lrp``, ``syntax_from_latent``,
``synthesize``) runs under ``no_grad`` on the model's device in passes of
``pass_batch`` images (``compress._passes``), as ``ChannelCoder``'s do: a
one-image stream runs a pass of 8 on the card at 512×768, its seven other
images copies, so that its σ and so its context rows do not depend on the
batch (ROADMAP §C5).  The planes are coded on the host (``coding.tritplane``),
as in the JAX package; no kernel drains them.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..coding.tritplane import GaussianTritCoder, TritPlaneCoder, num_planes_for
from ..data.pad import pad_to_multiple, padded_size
from .codec import DECODABLE_HYPERS, CodecModel
from .compress import (
    _from_nhwc_flat,
    _nhwc_flat,
    _passes,
    factorized_z_coder,
    pass_batch,
    set_numerics_flags,
    z_encode,
)

MAGIC_P = b"LTCP"
SIGMA_FLOOR = 0.04


class ProgressiveCoder:
    """Scalable multi-rate bitstream over a ChARM model with a decodable
    hyper, on the model's device.  ``digit_model``: ``'gaussian'``
    (per-element digit models from σ) or ``'static'`` (per-plane tables)."""

    def __init__(self, model: CodecModel, name: str = "", digit_model: str = "gaussian"):
        cfg = model.cfg
        if cfg.family != "charm" or cfg.context == "entroformer":
            raise ValueError("progressive coding covers the ChARM slice family")
        if cfg.hyper not in DECODABLE_HYPERS:
            raise ValueError(
                f"hyper path '{cfg.hyper}' is not decodable (see "
                "lic_tpu_torch.models.compress); progressive streams need a "
                "decodable base layer"
            )
        if digit_model not in ("static", "gaussian"):
            raise ValueError(f"unknown digit_model {digit_model!r}")
        set_numerics_flags()
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.name = (name or cfg.family) + "+prog"
        self.z_coder, self.med, self.digest = factorized_z_coder(model)
        self.digit_model = digit_model
        self.trit = TritPlaneCoder()
        self.gauss = GaussianTritCoder() if digit_model == "gaussian" else None

    def _slice_params(self, means, scales, supports, i: int, p: int):
        """(μ, σ, mean support) of slice ``i`` in passes of ``p`` images."""
        model = self.model
        return _passes(lambda m, s, *sup: model.charm_entropy_params(m, s, list(sup), i),
                       p, means, scales, *model.support(supports))

    @staticmethod
    def _host_sigma(sigma: torch.Tensor) -> np.ndarray:
        """σ (1, c, h, w) → NHWC-flat float64 with the 0.04 floor."""
        return np.maximum(_nhwc_flat(sigma).cpu().numpy()[0].astype(np.float64), SIGMA_FLOOR)

    # ------------------------------------------------------------- encode

    @torch.no_grad()
    def compress(self, x: torch.Tensor) -> bytes:
        """x: (1, 3, H, W) in [−1, 1], any size (padded to /64 inside;
        the original size rides the header) → the ``.ltcp`` container."""
        if x.shape[0] != 1:
            raise ValueError("one image per progressive bitstream")
        model, cfg = self.model, self.model.cfg
        _, _, h, w = x.shape
        x, _ = pad_to_multiple(x.to(self.device, torch.float32,
                                    memory_format=torch.channels_last), 64)
        p = pass_batch(*x.shape[2:], self.device)
        z3 = _passes(model.analyze, p, x)
        z_sym16, z_hat = z_encode(model, z3, self.med, p)
        z_blob = self.z_coder.encode_symbols(z_sym16.permute(0, 2, 3, 1).cpu().numpy())
        syntax = _passes(model.syntax_from_latent, p, z3).reshape(-1).cpu().numpy()
        syntax = syntax.astype(np.int16)

        scales, means = _passes(model.hyper_decode, p, z_hat)
        supports, slice_blobs = [], []
        for i, y_i in enumerate(z3.chunk(cfg.num_slices, dim=1)):
            mu, sigma, msup = self._slice_params(means, scales, supports, i, p)
            sym = torch.round(y_i - mu)
            flat = _nhwc_flat(sym).cpu().numpy()[0].astype(np.int64)
            k = num_planes_for(int(np.abs(flat).max(initial=1)))
            if self.gauss is not None:
                slice_blobs.append(self.gauss.encode(flat, self._host_sigma(sigma), k))
            else:
                slice_blobs.append(self.trit.encode(flat, k))
            supports.append(_passes(lambda ms, yh: model.charm_apply_lrp(ms, yh, i),
                                    p, msup, sym + mu))
        return self._pack(h, w, syntax, z_blob, slice_blobs)

    def _pack(self, h, w, syntax, z_blob, slice_blobs) -> bytes:
        out = bytearray(MAGIC_P)
        name = self.name.encode("utf-8")[:255]
        out += struct.pack("<B", len(name)) + name
        out += struct.pack("<I", self.digest)
        out += struct.pack("<B", 1 if self.digit_model == "gaussian" else 0)
        out += struct.pack("<HH", h, w)
        out += struct.pack("<H", syntax.size) + syntax.astype("<i2").tobytes()
        out += struct.pack("<I", len(z_blob)) + z_blob
        out += struct.pack("<B", len(slice_blobs))
        for planes in slice_blobs:
            out += struct.pack("<B", len(planes))
            for blob in planes:
                out += struct.pack("<I", len(blob)) + blob
        return bytes(out)

    # ------------------------------------------------------------- decode

    def parse(self, data: bytes):
        """→ (h, w, syntax, z_blob, [[plane blobs] per slice], base_bytes),
        ``base_bytes`` counting everything but the plane payloads."""
        if data[:4] != MAGIC_P:
            raise ValueError("bad magic — not an LTCP progressive bitstream")
        off = 4
        (nlen,) = struct.unpack_from("<B", data, off)
        off += 1
        name = data[off : off + nlen].decode("utf-8")
        off += nlen
        (digest,) = struct.unpack_from("<I", data, off)
        off += 4
        if name != self.name:
            raise ValueError(f"bitstream for '{name}', coder is '{self.name}'")
        if digest != self.digest:
            raise ValueError("weights digest mismatch")
        (dm,) = struct.unpack_from("<B", data, off)
        off += 1
        want = 1 if self.digit_model == "gaussian" else 0
        if dm != want:
            raise ValueError(f"bitstream digit model {dm} != coder digit model {want}")
        h, w = struct.unpack_from("<HH", data, off)
        off += 4
        (m,) = struct.unpack_from("<H", data, off)
        off += 2
        syntax = np.frombuffer(data, "<i2", count=m, offset=off).copy()
        off += 2 * m
        (zl,) = struct.unpack_from("<I", data, off)
        off += 4
        z_blob = data[off : off + zl]
        off += zl
        (ns,) = struct.unpack_from("<B", data, off)
        off += 1
        base_bytes = off
        slice_blobs = []
        for _ in range(ns):
            (k,) = struct.unpack_from("<B", data, off)
            off += 1
            base_bytes += 1
            planes = []
            for _ in range(k):
                (bl,) = struct.unpack_from("<I", data, off)
                off += 4
                planes.append(data[off : off + bl])
                off += bl
                base_bytes += 4
            slice_blobs.append(planes)
        return h, w, syntax, z_blob, slice_blobs, base_bytes

    def truncation_points(self, data: bytes) -> List[Tuple[int, int]]:
        """Every (planes, bytes used) prefix, plane by plane, slice-major:
        the x-axis of the rate staircase."""
        _, _, _, _, slice_blobs, base = self.parse(data)
        pts, used, n = [(0, base)], base, 0
        for planes in slice_blobs:
            for blob in planes:
                used += len(blob)
                n += 1
                pts.append((n, used))
        return pts

    @torch.no_grad()
    def decompress(self, data: bytes, max_planes: Optional[int] = None) -> torch.Tensor:
        """Decode with at most ``max_planes`` plane blobs (slice-major; None:
        all) → (1, 3, H, W).  Every prefix is a valid reconstruction."""
        model, cfg = self.model, self.model.cfg
        h, w, syntax, z_blob, slice_blobs, _ = self.parse(data)
        hp, wp = padded_size(h, w, 64)
        hy, wy = hp // 16, wp // 16
        per_ch = cfg.N // cfg.num_slices
        p = pass_batch(hp, wp, self.device)

        z_sym = self.z_coder.decode_symbols(z_blob, (1, hy // 4, wy // 4, cfg.N))
        z_sym = torch.from_numpy(np.ascontiguousarray(z_sym)).permute(0, 3, 1, 2)
        z_hat = z_sym.to(self.device, torch.float32,
                         memory_format=torch.channels_last) + self.med
        scales, means = _passes(model.hyper_decode, p, z_hat)

        budget = sum(map(len, slice_blobs)) if max_planes is None else max_planes
        supports = []
        for i in range(cfg.num_slices):
            mu, sigma, msup = self._slice_params(means, scales, supports, i, p)
            planes = slice_blobs[i]
            k = len(planes)
            take = max(0, min(k, budget))
            budget -= take
            n = hy * wy * per_ch
            if self.gauss is not None:
                flat = self.gauss.decode(planes[:take], n, self._host_sigma(sigma), k)
            else:
                flat = self.trit.decode(planes[:take], n, k)
            sym = _from_nhwc_flat(torch.from_numpy(flat.astype(np.float32))[None],
                                  per_ch, hy, wy).to(self.device)
            supports.append(_passes(lambda ms, yh: model.charm_apply_lrp(ms, yh, i),
                                    p, msup, sym + mu))
        y_hat = torch.cat(supports, dim=1)
        syn = torch.from_numpy(syntax.astype(np.float32))[None, :, None, None].to(self.device)
        rec = _passes(model.synthesize, p, y_hat, syn)
        return rec[:, :, :h, :w]
