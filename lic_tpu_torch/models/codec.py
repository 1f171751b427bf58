"""The codec core, charm family with the classic dual hyper (``source_net``).

Counterpart of ``lic_tpu/models/codec.py``: ``_CharmSliceStack``
(``:73-85``), the eval-mode ``_forward_charm`` (``:481-575``) and the
sub-passes ``ChannelCoder`` calls (``:589-649``).  NCHW throughout.

The ``source_net`` config also builds a ``PredictionModelSyntax`` that no
charm forward calls (``config.py:88``, ``codec.py:115-119``); it is not
ported, and ``utils.params`` skips its subtree.  Training-mode forwards,
the other hypers and families, gain units and the HAN tail raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from lic_tpu.config import CodecConfig

from ..entropy import EntropyBottleneck, GaussianConditional
from ..layers import Conv2d, gelu
from ..ops import bypass_round, quantize_ste_offset, ste_round
from .hyper import ClassicHyperAnalysis, ClassicHyperSynthesis
from .syntax import ConvGenerator, SyntaxModel, batch_conv
from .transforms import AnalysisTransform, SynthesisTransform


class CodecOutput(NamedTuple):
    x_tilde: torch.Tensor          # reconstruction in [-1, 1], NCHW
    bpp: torch.Tensor              # total estimated bits per pixel
    mse: torch.Tensor              # mean squared error in [-1, 1]
    bpp_y: torch.Tensor
    bpp_z: torch.Tensor
    bpp_syntax: torch.Tensor
    extras: Dict[str, torch.Tensor]


def _bpp(likelihood: torch.Tensor, num_pixels: int) -> torch.Tensor:
    """Σ log p / (−log 2 · num_pixels)."""
    return torch.sum(torch.log(likelihood)) / (-math.log(2.0) * num_pixels)


def check_supported(cfg: CodecConfig) -> None:
    """Raise ``NotImplementedError`` for what this port does not carry yet."""
    gaps = [
        (cfg.family != "charm", f"family {cfg.family!r} (ROADMAP A15)"),
        (cfg.transform != "plain", f"transform {cfg.transform!r} (ROADMAP A10)"),
        (cfg.hyper != "classic_dual", f"hyper {cfg.hyper!r} (ROADMAP A10-A11)"),
        (cfg.context != "charm", f"context {cfg.context!r} (ROADMAP A14)"),
        (cfg.swatten, "SWAtten slice stacks (ROADMAP A10)"),
        (cfg.syntax != "basic" or not cfg.syntax_decoder,
         f"syntax {cfg.syntax!r} (ROADMAP A10)"),
        (cfg.post_processing, "the HAN post-processing tail (ROADMAP A16)"),
        (cfg.gain_units > 0, "gain units (ROADMAP A16)"),
        (not cfg.lrp, "charm without LRP (ROADMAP A16)"),
    ]
    for missing, what in gaps:
        if missing:
            raise NotImplementedError(f"lic_tpu_torch does not port {what} yet")


class _CharmSliceStack(nn.Module):
    """conv3 → GELU → conv3 → GELU → conv3 (224, 128, out)."""

    def __init__(self, cin: int, cout: int, generator=None):
        super().__init__()
        self.c0 = Conv2d(cin, 224, 3, 1, 1, generator=generator)
        self.c1 = Conv2d(224, 128, 3, 1, 1, generator=generator)
        self.c2 = Conv2d(128, cout, 3, 1, 1, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c2(gelu(self.c1(gelu(self.c0(x)))))


class CodecModel(nn.Module):
    def __init__(
        self, cfg: CodecConfig, *, generator: Optional[torch.Generator] = None
    ):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        N, M = cfg.N, cfg.M
        g = generator
        self.g_a = AnalysisTransform(N, generator=g)
        self.g_s = SynthesisTransform(N, M, generator=g)
        self.syntax_model = SyntaxModel(M, M, generator=g)
        self.conv_weights_gen = ConvGenerator(M, M, generator=g)
        self.h_a = ClassicHyperAnalysis(N, generator=g)
        self.h_mean_s = ClassicHyperSynthesis(N, generator=g)
        self.h_scale_s = ClassicHyperSynthesis(N, generator=g)
        self.entropy_bottleneck = EntropyBottleneck(N, generator=g)
        self.gaussian_conditional = GaussianConditional()

        ns = cfg.num_slices
        sc = N // ns
        n_sup = [
            i if cfg.max_support_slices < 0 else min(i, cfg.max_support_slices)
            for i in range(ns)
        ]
        self.cc_mean_transforms = nn.ModuleList(
            _CharmSliceStack(N + sc * n_sup[i], sc, g) for i in range(ns)
        )
        self.cc_scale_transforms = nn.ModuleList(
            _CharmSliceStack(N + sc * n_sup[i], sc, g) for i in range(ns)
        )
        self.lrp_transforms = nn.ModuleList(
            _CharmSliceStack(N + sc * (n_sup[i] + 1), sc, g) for i in range(ns)
        )

    def support(self, y_hat_slices: Sequence[torch.Tensor]):
        """The decoded slices slice ``len(y_hat_slices)`` conditions on."""
        k = self.cfg.max_support_slices
        return list(y_hat_slices) if k < 0 else list(y_hat_slices[:k])

    def _decode_tail(self, x_tilde, syntax_rounded):
        w = self.conv_weights_gen(syntax_rounded)
        x_bf = batch_conv(w, x_tilde)
        return torch.tanh(x_bf) if self.cfg.tanh_after_syntax else x_bf

    # ------------------------------------------------------------ forward

    def forward(self, x: torch.Tensor, training: bool = False) -> CodecOutput:
        """Eval-mode forward of the charm family on NCHW ``x`` in [-1, 1]."""
        if training:
            raise NotImplementedError(
                "the training-mode forward lands with training (ROADMAP A12)"
            )
        cfg = self.cfg
        b, _, h, w = x.shape
        num_pixels = b * h * w

        z3 = self.g_a(x)
        z = self.h_a(z3)
        _, z_lik = self.entropy_bottleneck(z)
        z_hat = quantize_ste_offset(z, self.eb_medians()[None, :, None, None])
        latent_scales = self.h_scale_s(z_hat)
        latent_means = self.h_mean_s(z_hat)
        syntax_rounded = self.syntax_from_latent(z3)

        y_hat_slices, y_liks, mus, sigmas = [], [], [], []
        for i, y_slice in enumerate(z3.chunk(cfg.num_slices, dim=1)):
            mu, scale, mean_support = self.charm_entropy_params(
                latent_means, latent_scales, self.support(y_hat_slices), i
            )
            _, y_lik = self.gaussian_conditional(y_slice, scale, mu)
            y_liks.append(y_lik)
            mus.append(mu)
            sigmas.append(scale)
            y_hat_slice = ste_round(y_slice - mu) + mu
            y_hat_slices.append(
                self.charm_apply_lrp(mean_support, y_hat_slice, i)
            )

        y_hat = torch.cat(y_hat_slices, dim=1)
        x_tilde = self._decode_tail(self.g_s(y_hat), syntax_rounded)

        bpp_y = _bpp(torch.cat(y_liks, dim=1), num_pixels)
        if cfg.count_hyper_bpp:
            bpp_z = _bpp(z_lik, num_pixels)
        else:
            bpp_z = torch.zeros((), device=x.device)
        mse = torch.mean((x_tilde - x) ** 2)
        return CodecOutput(
            x_tilde=x_tilde, bpp=bpp_y + bpp_z, mse=mse,
            bpp_y=bpp_y, bpp_z=bpp_z,
            bpp_syntax=torch.zeros((), device=x.device),
            extras={
                "y_hat": y_hat,
                "means": torch.cat(mus, dim=1),
                "scales": torch.cat(sigmas, dim=1),
            },
        )

    # ------------------------------------------------ bitstream sub-passes

    def analyze(self, x: torch.Tensor) -> torch.Tensor:
        return self.g_a(x)

    def hyper_encode(self, z3: torch.Tensor) -> torch.Tensor:
        return self.h_a(z3)

    def eb_medians(self) -> torch.Tensor:
        return self.entropy_bottleneck.medians

    def eb_pmf_table(self, min_sym: int, max_sym: int) -> torch.Tensor:
        return self.entropy_bottleneck.pmf_table(min_sym, max_sym)

    def hyper_decode(self, z_hat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """z_hat → (latent_scales, latent_means)."""
        return self.h_scale_s(z_hat), self.h_mean_s(z_hat)

    def syntax_from_latent(self, z3: torch.Tensor) -> torch.Tensor:
        """→ rounded syntax vector (B, M, 1, 1)."""
        return bypass_round(self.syntax_model(z3[:, : self.cfg.M]))

    def charm_entropy_params(self, latent_means, latent_scales, support, i: int):
        """(μ, σ, mean_support) for slice ``i`` given decoded ``support``."""
        yh, yw = latent_means.shape[2], latent_means.shape[3]
        mean_support = torch.cat([latent_means] + list(support), dim=1)
        mu = self.cc_mean_transforms[i](mean_support)[:, :, :yh, :yw]
        scale_support = torch.cat([latent_scales] + list(support), dim=1)
        sigma = self.cc_scale_transforms[i](scale_support)[:, :, :yh, :yw]
        return mu, sigma, mean_support

    def charm_apply_lrp(self, mean_support, y_hat_slice, i: int):
        lrp_in = torch.cat([mean_support, y_hat_slice], dim=1)
        return y_hat_slice + 0.5 * torch.tanh(self.lrp_transforms[i](lrp_in))

    def synthesize(self, y_hat: torch.Tensor, syntax_rounded: torch.Tensor):
        """y_hat (+ syntax vector (B, M, 1, 1)) → reconstruction."""
        return self._decode_tail(self.g_s(y_hat), syntax_rounded)
