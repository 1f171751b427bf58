"""The codec core: the charm family (ChARM slices or the entroformer
checkerboard context) and the neural-syntax family, NCHW.

Counterpart of ``lic_tpu/models/codec.py``:

* charm — the classic dual hyper (``source_net``, ``source_net_wam``), the
  ELIC hyper (``net_ga``, ``entroformer_cb*``), the decodable U-Net hyper
  (``net_unet_ha_hs_dec``), the U-Net hyper whose decoder reads the
  encoder's skips (``net_ha``, ``net_unet_ha_hs``, ``net_unet_ha_hs_1``)
  and the uncoded latent U-Net (``net_unet``, ``net_unet_1``,
  ``net_unet_005_5``: no z, no EntropyBottleneck, ``bpp_z`` 0);
  ``_CharmSliceStack`` (``:73-85``), the hyper branches (``:141-175``,
  ``_hyper_forward`` ``:437-479``), ``_forward_charm`` in eval and
  training mode (``:481-575``) and the sub-passes ``ChannelCoder`` calls
  (``:589-649``), which only the decodable hypers have;
* the entroformer context (``context='entroformer'``): ``entro_context``
  (``:178-196``), ``_entroformer_entropy`` (``:698-750``: two
  checkerboard passes, anchors from the hyper alone, then the non-anchors
  seeing the decoded anchors) and its sub-passes ``entro_predict`` /
  ``entro_embed_hyper`` (``:681-694``);
* neural syntax (``family='neural_syntax'``, ``:122-134``,
  ``_forward_neural_syntax`` ``:365-433``): the latent splits into M
  syntax and N − M content channels; z2 rides a learned per-channel
  N(0, |σ_z2|), the content ``PredictionModelContext`` over causal
  patches, the syntax vector ``PredictionModelSyntax``; sub-passes
  ``ns_*`` (``:660-679``).

The training forward is the eval one with U(-½, ½) noise in the
likelihoods (the rounded values still feed the decoders, as in the JAX
package).  Every noise tensor is drawn through one ``noise_fn(shape,
dtype, device)``, in the JAX package's order: charm, z then slices 0-3
(the latent U-Net draws no z); entroformer, z then y; neural syntax, z2,
content, syntax.

Variable rate (``cfg.gain_units`` = K > 0, charm slices only,
``:249-296``): K learned (log-gain, log-inverse-gain) rows of N; a
continuous rate r ∈ [0, K − 1] interpolates the adjacent rows in log
space.  The latent is scaled by the gain after g_a, so everything
downstream codes the gained latent, and ŷ by the inverse gain before g_s.
A scalar rate serves the batch; a (B,) rate one operating point per image.

Post-processing (``cfg.post_processing``, ``:238-247``, ``_decode_tail``
``:300-339``): the HAN tail (``models.han.HANHead``) on the generated
conv's RGB output, then a second per-image generated 1x1 conv
(``conv_weights_gen_han``, syntax → 3 × 64) and the DIV2K mean shift.
Every forward takes ``use_post_processing`` (False skips the tail, as
the content-adaptive tune does) and ``stop_base_grad`` (the gradient cut
at the HAN input, for the HAN-only training phase); ``synthesize`` runs
the tail, so the coders' decodes do.  The HAN parameters are built last,
so a seed gives a post-processing model the base weights of the model
without it.

The syntax machinery (``:99-113``, ``_decode_tail`` ``:322-328``): with
``syntax_decoder`` (the default) g_s gives M channels and the per-image
generated conv ``conv_weights_gen`` maps them to RGB; without it
(``net_unet_ha_hs_1``) g_s gives RGB itself and no generated conv is
built.  ``syntax="none"`` builds no syntax model either.  The JAX model
still builds the syntax model of ``syntax_decoder=False``, and so does
this one, though no forward reads it there: the forward skips it (as
XLA drops it under ``jit``), its leaves take no gradient, and
``unread_parameters`` names them for a ``DistributedDataParallel`` wrap.

The charm configs also build a ``PredictionModelSyntax`` that no charm
forward calls (``config.py:88``, ``codec.py:115-119``); it is not part of
a charm model, ``utils.params`` skips its subtree there, and
``utils.checkpoint`` carries it in the ``.npz`` files.

The transforms (``models.transforms``) are ``plain``, ``plain_wam``,
``rich`` or ``rbs`` (the rich g_a with the ``synthesisTransformModel_RBS``
g_s).  A charm config with ``lrp=False`` builds no ``lrp_transforms``, and
every forward and coder pass takes ŷ as it is (``charm_apply_lrp``,
``codec.py:636-640``).
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..config import CodecConfig
from ..entropy import EntropyBottleneck, GaussianConditional, GaussianModel
from ..entropy.context import PredictionModelContext
from ..layers import Conv2d, SWAtten, gelu
from ..layers.entroformer import EntroformerConfig, EntroformerContext, anchor_map
from ..ops import bypass_round, quantize_ste_offset, ste_round, uniform_noise
from ..ops.rounding import NoiseFn, additive_noise
from .han import HANHead, mean_shift
from .hyper import (
    ClassicHyperAnalysis,
    ClassicHyperSynthesis,
    DecodableUnetHyperSynthesis,
    ElicHyperAnalysis,
    ElicHyperSynthesis,
    LatentUnet,
    UnetHyperAnalysis,
    UnetHyperSynthesis,
)
from .syntax import ConvGenerator, PredictionModelSyntax, SyntaxModel, batch_conv
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


CHARM_HYPERS = ("classic_dual", "elic", "unet", "unet_dec", "latent_unet")
# hypers whose decoder reads nothing but coded data
DECODABLE_HYPERS = ("classic_dual", "elic", "unet_dec")


def check_supported(cfg: CodecConfig) -> None:
    """Raise ``ValueError`` for a config the JAX package rejects too."""
    charm = cfg.family == "charm"
    if cfg.family not in ("charm", "neural_syntax"):
        raise ValueError(f"unknown codec family {cfg.family!r}")
    if charm and cfg.hyper not in CHARM_HYPERS:
        raise ValueError(f"unknown charm hyper: {cfg.hyper}")
    if charm and cfg.context not in ("charm", "entroformer"):
        raise ValueError(f"unknown context {cfg.context!r}")
    if cfg.syntax not in ("basic", "wam", "none"):
        raise ValueError(f"unknown syntax {cfg.syntax!r}")
    if not charm and (cfg.syntax == "none" or not cfg.code_syntax):
        raise ValueError("the neural-syntax family codes its syntax stream: it needs a "
                         "syntax model and code_syntax")


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
        if cfg.post_processing and cfg.syntax == "none":
            raise ValueError(
                "post_processing=True needs a syntax stream: the HAN tail's "
                "second generated conv consumes the syntax vector"
            )
        check_supported(cfg)
        self.cfg = cfg
        N, M = cfg.N, cfg.M
        g = generator
        self.is_ns = cfg.family == "neural_syntax"
        self.is_entro = not self.is_ns and cfg.context == "entroformer"
        if cfg.gain_units and (self.is_ns or self.is_entro):
            raise ValueError("gain_units currently supports the charm slice family")
        has_syntax = cfg.syntax != "none"
        # g_s gives M channels for the generated conv, or RGB without it
        gen_conv = has_syntax and cfg.syntax_decoder
        # rbs is a g_s family: its g_a is the rich one (codec.py:95-97)
        self.g_a = AnalysisTransform(N, "rich" if cfg.transform == "rbs" else cfg.transform,
                                     generator=g)
        self.g_s = SynthesisTransform(N, M if gen_conv else 3, cfg.transform,
                                      in_channels=cfg.content_channels, generator=g)
        self.syntax_model = SyntaxModel(M, M, cfg.syntax, generator=g) if has_syntax else None
        self.conv_weights_gen = ConvGenerator(M, M, generator=g) if gen_conv else None
        # the forward computes the syntax vector only where something reads
        # it: the generated conv, the HAN tail's, the neural-syntax stream
        self.reads_syntax = gen_conv or (has_syntax and (cfg.post_processing or self.is_ns))
        if self.is_ns:
            self._init_neural_syntax(g)
        else:
            self._init_charm(g)
        if cfg.post_processing:
            self.han = HANHead(is_high=cfg.is_high, generator=g)
            self.conv_weights_gen_han = ConvGenerator(M, 64, generator=g)

    def _init_charm(self, g):
        """The hyper, the entropy models and the ChARM slice stacks or the
        entroformer context (``codec.py:136-296``)."""
        cfg = self.cfg
        N = cfg.N
        shared = cfg.shared_hyper_decoder
        z_channels = None
        if cfg.hyper == "classic_dual":
            self.h_a = ClassicHyperAnalysis(N, generator=g)
            self.h_mean_s = ClassicHyperSynthesis(N, generator=g)
            self.h_scale_s = ClassicHyperSynthesis(N, generator=g)
            z_channels = N
        elif cfg.hyper == "elic":
            self.h_a = ElicHyperAnalysis(N, generator=g)
            self.h_mean_s = ElicHyperSynthesis(N, generator=g)
            self.h_scale_s = ElicHyperSynthesis(N, generator=g)
            z_channels = 192
        elif cfg.hyper in ("unet", "unet_dec"):
            # one decoder pass with two heads (scales, means), or two decoders
            self.h_a = UnetHyperAnalysis(N, generator=g)
            if cfg.hyper == "unet":
                dec = lambda two: UnetHyperSynthesis(N, N, two_heads=two, generator=g)
            else:
                dec = lambda two: DecodableUnetHyperSynthesis(N, two_heads=two, generator=g)
            if shared:
                self.h_s = dec(True)
            else:
                self.h_s_scale, self.h_s_means = dec(False), dec(False)
            z_channels = 512
        else:  # latent_unet: (scales, means) from the unquantized latent
            variant = "conv1x1" if cfg.unet_variant == "conv1x1" else "res"
            self.unet = LatentUnet(N, N, variant=variant, two_heads=shared, generator=g)
            self.unet_b = None if shared else LatentUnet(N, N, variant=variant, generator=g)
        if z_channels is not None:
            self.entropy_bottleneck = EntropyBottleneck(z_channels, generator=g)
        self.gaussian_conditional = GaussianConditional()
        if self.is_entro:
            ed = cfg.entro_dim_mult * N
            self.entro_context = EntroformerContext(
                N, 2 * N, "checkerboard",
                EntroformerConfig(dim=ed, num_layers=cfg.entro_layers,
                                  num_heads=cfg.entro_heads,
                                  dim_head=ed // cfg.entro_heads,
                                  attn_topk=cfg.entro_topk),
                generator=g)
            return

        ns = cfg.num_slices
        sc = N // ns
        n_sup = [
            i if cfg.max_support_slices < 0 else min(i, cfg.max_support_slices)
            for i in range(ns)
        ]
        if cfg.swatten:
            def swatten(i):
                c = N + sc * n_sup[i]
                return SWAtten(c, c, 16, cfg.swatten_window, inter_dim=128, generator=g)

            self.atten_mean = nn.ModuleList(swatten(i) for i in range(ns))
            self.atten_scale = nn.ModuleList(swatten(i) for i in range(ns))
        self.cc_mean_transforms = nn.ModuleList(
            _CharmSliceStack(N + sc * n_sup[i], sc, g) for i in range(ns)
        )
        self.cc_scale_transforms = nn.ModuleList(
            _CharmSliceStack(N + sc * n_sup[i], sc, g) for i in range(ns)
        )
        if cfg.lrp:
            self.lrp_transforms = nn.ModuleList(
                _CharmSliceStack(N + sc * (n_sup[i] + 1), sc, g) for i in range(ns)
            )
        if cfg.gain_units:
            # a log-spaced amplitude ramp: unit K−1 starts at gain_span × unit
            # 0, so bpp rises with the rate from step 0; K = 1 is neutral
            K = cfg.gain_units
            span = float(np.log(cfg.gain_span))
            ramp = (np.zeros(1, np.float32) if K == 1
                    else np.linspace(-span / 2, span / 2, K, dtype=np.float32))
            ramp = torch.from_numpy(np.broadcast_to(ramp[:, None], (K, N)).copy())
            self.log_gain = nn.Parameter(ramp)
            self.log_inv_gain = nn.Parameter(-ramp)

    def _init_neural_syntax(self, g):
        """The neural-syntax modules (``codec.py:122-134`` and the syntax
        stream's ``PredictionModelSyntax``)."""
        cfg = self.cfg
        N, M = cfg.N, cfg.M
        self.prediction_model_syntax = PredictionModelSyntax(
            N, M, 2 * M, "wam" if cfg.syntax == "wam" else "basic", generator=g)
        self.ha_model = ClassicHyperAnalysis(N, generator=g)
        self.hs_model = ClassicHyperSynthesis(N, generator=g)
        # the flax leaf's (1, 1, 1, N) layout
        self.z2_sigma = nn.Parameter(torch.ones(1, 1, 1, N))
        self.prediction_model = PredictionModelContext(
            (N - M) + N, N, 2 * (N - M), generator=g)
        self.gm = GaussianModel()

    def _gain_vectors(self, rate) -> Tuple[torch.Tensor, torch.Tensor]:
        """(gain, inverse gain) at a continuous rate index, clipped to
        [0, K − 1]: the log rows of ⌊r⌋ and ⌊r⌋ + 1 interpolated, then
        exp, so an integer rate takes its learned row as is.  A scalar
        rate gives (N,) vectors, a (B,) rate (B, N, 1, 1)."""
        K = self.cfg.gain_units
        r = torch.as_tensor(rate, dtype=torch.float32, device=self.log_gain.device)
        r = torch.clamp(r, 0.0, float(K - 1))
        lo = torch.clamp(torch.floor(r).long(), 0, K - 1)
        hi = torch.clamp(lo + 1, max=K - 1)
        a = (r - lo.float())[..., None]
        g = torch.exp((1 - a) * self.log_gain[lo] + a * self.log_gain[hi])
        ig = torch.exp((1 - a) * self.log_inv_gain[lo] + a * self.log_inv_gain[hi])
        if r.dim():
            g, ig = g[:, :, None, None], ig[:, :, None, None]
        return g, ig

    def _gained(self, t: torch.Tensor, rate, inverse: bool) -> torch.Tensor:
        """``t`` (B, N, h, w) times the gain (or the inverse gain) at
        ``rate`` (None: rate 0); ``t`` itself without gain units."""
        if not self.cfg.gain_units:
            return t
        v = self._gain_vectors(0.0 if rate is None else rate)[1 if inverse else 0]
        return t * (v[:, None, None] if v.dim() == 1 else v)

    def support(self, y_hat_slices: Sequence[torch.Tensor]):
        """The decoded slices slice ``len(y_hat_slices)`` conditions on."""
        k = self.cfg.max_support_slices
        return list(y_hat_slices) if k < 0 else list(y_hat_slices[:k])

    def _decode_tail(self, x_tilde, syntax_rounded, use_post_processing=True,
                     stop_base_grad=False):
        """g_s output → RGB through the per-image generated conv (+ tanh)
        where the model has one (else g_s gave RGB), then, on a
        post-processing model unless ``use_post_processing`` is False, the
        HAN tail, the second generated conv and the mean shift.
        ``stop_base_grad`` detaches the HAN's inputs (the RGB image and the
        syntax vector): no gradient reaches the base network."""
        x_bf = x_tilde
        if self.conv_weights_gen is not None:
            x_bf = batch_conv(self.conv_weights_gen(syntax_rounded), x_tilde)
            if self.cfg.tanh_after_syntax:
                x_bf = torch.tanh(x_bf)
        if stop_base_grad:
            x_bf = x_bf.detach()
            syntax_rounded = None if syntax_rounded is None else syntax_rounded.detach()
        if not (self.cfg.post_processing and use_post_processing):
            return x_bf
        feats = self.han(x_bf)
        out = batch_conv(self.conv_weights_gen_han(syntax_rounded), feats)
        return mean_shift(out, sign=1).contiguous(memory_format=torch.channels_last)

    # ------------------------------------------------------------ forward

    def forward(
        self, x: torch.Tensor, training: bool = False, *,
        noise_fn: Optional[NoiseFn] = None, use_post_processing: bool = True,
        stop_base_grad: bool = False, rate=None,
    ) -> CodecOutput:
        """The forward on NCHW ``x`` in [-1, 1]: eval mode, or
        ``training`` with the likelihoods' noise drawn by ``noise_fn``
        (default: ``uniform_noise()``, torch's default generator).
        ``use_post_processing`` / ``stop_base_grad``: see
        ``_decode_tail``.  ``rate``: the gain units' continuous rate index,
        a scalar or one per image (None: rate 0); models without gain
        units ignore it."""
        if training and noise_fn is None:
            noise_fn = uniform_noise()
        tail = dict(use_post_processing=use_post_processing, stop_base_grad=stop_base_grad)
        if self.is_ns:
            return self._forward_neural_syntax(x, training, noise_fn, tail)
        cfg = self.cfg
        b, _, h, w = x.shape
        num_pixels = b * h * w

        z3 = self._gained(self.g_a(x), rate, inverse=False)
        latent_scales, latent_means, z_lik = self.hyper_forward(z3, training, noise_fn)
        syntax_rounded = self.syntax_from_latent(z3) if self.reads_syntax else None
        if self.is_entro:
            return self._entroformer_entropy(x, z3, latent_scales, latent_means, z_lik,
                                             syntax_rounded, training, noise_fn, tail)

        y_hat_slices, y_liks, mus, sigmas = [], [], [], []
        for i, y_slice in enumerate(z3.chunk(cfg.num_slices, dim=1)):
            mu, scale, mean_support = self.charm_entropy_params(
                latent_means, latent_scales, self.support(y_hat_slices), i
            )
            _, y_lik = self.gaussian_conditional(y_slice, scale, mu, training, noise_fn)
            y_liks.append(y_lik)
            mus.append(mu)
            sigmas.append(scale)
            y_hat_slice = ste_round(y_slice - mu) + mu
            y_hat_slices.append(
                self.charm_apply_lrp(mean_support, y_hat_slice, i)
            )

        y_hat = torch.cat(y_hat_slices, dim=1)
        x_tilde = self._decode_tail(self.g_s(self._gained(y_hat, rate, inverse=True)),
                                    syntax_rounded, **tail)

        bpp_y = _bpp(torch.cat(y_liks, dim=1), num_pixels)
        if z_lik is not None and cfg.count_hyper_bpp:
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

    def _entroformer_entropy(self, x, z3, latent_scales, latent_means, z_lik,
                             syntax_rounded, training, noise_fn, tail) -> CodecOutput:
        """Checkerboard entropy coding of y: anchors from the hyper alone,
        non-anchors from the anchors rounded about their μ; each pass runs
        the context once (``run``, as the JAX codec calls ``_run``)."""
        b, _, h, w = x.shape
        hyper = torch.cat([latent_scales, latent_means], dim=1)
        anchor = anchor_map(z3.shape[2], z3.shape[3], z3)
        ctx = self.entro_context
        mu1, s1 = ctx.run(torch.zeros_like(z3), hyper, None)
        mu2, s2 = ctx.run((ste_round(z3 - mu1) + mu1) * anchor, hyper, None)
        mu = anchor * mu1 + (1 - anchor) * mu2
        sigma = anchor * s1 + (1 - anchor) * s2
        _, y_lik = self.gaussian_conditional(z3, sigma, mu, training, noise_fn)
        y_hat = ste_round(z3 - mu) + mu
        x_tilde = self._decode_tail(self.g_s(y_hat), syntax_rounded, **tail)
        num_pixels = b * h * w
        bpp_y = _bpp(y_lik, num_pixels)
        bpp_z = (_bpp(z_lik, num_pixels) if z_lik is not None and self.cfg.count_hyper_bpp
                 else torch.zeros((), device=x.device))
        return CodecOutput(
            x_tilde=x_tilde, bpp=bpp_y + bpp_z, mse=torch.mean((x_tilde - x) ** 2),
            bpp_y=bpp_y, bpp_z=bpp_z, bpp_syntax=torch.zeros((), device=x.device),
            extras={"y_hat": y_hat, "means": mu, "scales": sigma},
        )

    def _forward_neural_syntax(self, x, training, noise_fn, tail) -> CodecOutput:
        M = self.cfg.M
        b, _, h, w = x.shape
        num_pixels = b * h * w
        z3 = self.g_a(x)
        z2 = self.ha_model(z3)
        h2 = self.hs_model(bypass_round(z2))
        syntax = self.syntax_model(z3[:, :M])
        syntax_rounded = bypass_round(syntax)
        content = z3[:, M:]
        content_rounded = bypass_round(content)
        if training:
            # the JAX package's three draws, in its order
            z2_in = additive_noise(z2, noise_fn)
            content_in = additive_noise(content, noise_fn)
            syntax_in = additive_noise(syntax, noise_fn)
        else:
            z2_in, content_in, syntax_in = bypass_round(z2), content_rounded, syntax_rounded
        # |σ| with a floor, as the wavefront coder's pmf (ns_z2_sigma)
        z2_scale = self.ns_z2_sigma()[None, :, None, None]
        z2_lik = self.gm(z2_in, z2_scale, torch.zeros_like(z2_scale))
        mu_c, sigma_c = self.prediction_model(content_rounded, h2, masked=True)
        content_lik = self.gm(content_in, sigma_c, mu_c)
        mu_s, sigma_s = self.prediction_model_syntax(h2)
        syntax_lik = self.gm(syntax_in, sigma_s, mu_s)
        x_tilde = self._decode_tail(self.g_s(content_rounded), syntax_rounded, **tail)

        bpp_z = _bpp(z2_lik, num_pixels)
        bpp_y = _bpp(content_lik, num_pixels)
        bpp_s = _bpp(syntax_lik, num_pixels)
        return CodecOutput(
            x_tilde=x_tilde, bpp=bpp_z + bpp_y + bpp_s, mse=torch.mean((x_tilde - x) ** 2),
            bpp_y=bpp_y, bpp_z=bpp_z, bpp_syntax=bpp_s,
            extras={"y_hat": content_rounded, "syntax": syntax_rounded,
                    "content_mu": mu_c, "content_sigma": sigma_c},
        )

    def entropy_aux_loss(self) -> torch.Tensor:
        """The EntropyBottleneck's quantile loss; 0 for the neural-syntax
        family and the latent U-Net, which have none."""
        if not hasattr(self, "entropy_bottleneck"):
            return torch.zeros((), device=next(self.parameters()).device)
        return self.entropy_bottleneck.aux_loss()

    def unread_parameters(self) -> List[str]:
        """Names of the parameters no forward reads: the syntax model of a
        model whose g_s gives RGB (and that has no HAN tail)."""
        if self.syntax_model is None or self.reads_syntax:
            return []
        return [f"syntax_model.{n}" for n, _ in self.syntax_model.named_parameters()]

    def hyper_forward(self, z3: torch.Tensor, training: bool = False,
                      noise_fn: Optional[NoiseFn] = None):
        """The hyper path on the latent (``_hyper_forward``, ``:437-479``):
        → (latent_scales, latent_means, z likelihoods or None).  The U-Net
        hyper's decoder takes the encoder-side skips and not ẑ; the
        latent U-Net codes nothing and draws no noise."""
        hyper = self.cfg.hyper
        if hyper == "latent_unet":
            if self.unet_b is None:
                return (*self.unet(z3), None)
            return self.unet(z3), self.unet_b(z3), None
        z = self.h_a(z3)
        skips = ()
        if hyper in ("unet", "unet_dec"):
            z, *skips = z  # (z, middle, skip1, inp)
        _, z_lik = self.entropy_bottleneck(z, training, noise_fn)
        if hyper == "unet":  # the decoder's ẑ argument, which it does not read
            return (*self._two_decoders(None, *skips), z_lik)
        z_hat = quantize_ste_offset(z, self.eb_medians()[None, :, None, None])
        return (*self.hyper_decode(z_hat), z_lik)

    def _two_decoders(self, *args) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scales, means) from the two-head ``h_s``, or from ``h_s_scale``
        and ``h_s_means``."""
        if self.cfg.shared_hyper_decoder:
            return self.h_s(*args)
        return self.h_s_scale(*args), self.h_s_means(*args)

    # ------------------------------------------------ bitstream sub-passes

    def analyze(self, x: torch.Tensor, rate=None) -> torch.Tensor:
        """x → z3, gained where the model has gain units: the coded
        latent is the gained one, so only ``synthesize`` sees the rate
        again."""
        return self._gained(self.g_a(x), rate, inverse=False)

    def hyper_encode(self, z3: torch.Tensor) -> torch.Tensor:
        """z3 → z; the U-Net hyper's skips are not part of the message."""
        self._decodable("hyper_encode")
        z = self.h_a(z3)
        return z[0] if self.cfg.hyper == "unet_dec" else z

    def _decodable(self, what: str) -> None:
        if self.cfg.hyper not in DECODABLE_HYPERS:
            raise ValueError(
                f"{what}: hyper path '{self.cfg.hyper}' is not decodable (its decoder "
                "reads encoder-side activations, or nothing is coded); "
                "use hyper_forward")

    def eb_medians(self) -> torch.Tensor:
        return self.entropy_bottleneck.medians

    def eb_pmf_table(self, min_sym: int, max_sym: int) -> torch.Tensor:
        return self.entropy_bottleneck.pmf_table(min_sym, max_sym)

    def hyper_decode(self, z_hat: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """z_hat → (latent_scales, latent_means)."""
        self._decodable("hyper_decode")
        if self.cfg.hyper == "unet_dec":
            return self._two_decoders(z_hat)
        return self.h_scale_s(z_hat), self.h_mean_s(z_hat)

    def syntax_from_latent(self, z3: torch.Tensor) -> torch.Tensor:
        """→ rounded syntax vector (B, M, 1, 1); (B, 0, 1, 1) for a model
        with no syntax model, whose streams carry an empty syntax field."""
        if self.syntax_model is None:
            return z3.new_zeros(z3.shape[0], 0, 1, 1)
        return bypass_round(self.syntax_model(z3[:, : self.cfg.M]))

    def charm_entropy_params(self, latent_means, latent_scales, support, i: int):
        """(μ, σ, mean_support) for slice ``i`` given decoded ``support``;
        with SWAtten, ``mean_support`` is the attended one, which LRP reads."""
        yh, yw = latent_means.shape[2], latent_means.shape[3]
        mean_support = torch.cat([latent_means] + list(support), dim=1)
        if self.cfg.swatten:
            mean_support = self.atten_mean[i](mean_support)
        mu = self.cc_mean_transforms[i](mean_support)[:, :, :yh, :yw]
        scale_support = torch.cat([latent_scales] + list(support), dim=1)
        if self.cfg.swatten:
            scale_support = self.atten_scale[i](scale_support)
        sigma = self.cc_scale_transforms[i](scale_support)[:, :, :yh, :yw]
        return mu, sigma, mean_support

    def charm_apply_lrp(self, mean_support, y_hat_slice, i: int):
        """ŷ + ½·tanh(LRP(mean support, ŷ)) for slice ``i``; ŷ itself
        where the config has no LRP (``codec.py:636-640``)."""
        if not self.cfg.lrp:
            return y_hat_slice
        lrp_in = torch.cat([mean_support, y_hat_slice], dim=1)
        return y_hat_slice + 0.5 * torch.tanh(self.lrp_transforms[i](lrp_in))

    def synthesize(self, y_hat: torch.Tensor, syntax_rounded: torch.Tensor, rate=None):
        """y_hat (+ syntax vector (B, M, 1, 1)) → reconstruction, through
        the HAN tail where the model has one; ``rate`` selects the inverse
        gain of a gain-unit model."""
        return self._decode_tail(self.g_s(self._gained(y_hat, rate, inverse=True)),
                                 syntax_rounded)

    # ------------------------------------- entroformer checkerboard passes

    def entro_embed_hyper(self, latent_scales, latent_means) -> torch.Tensor:
        """The hyper features embedded once for both passes: (B, H·W, D)."""
        return self.entro_context.embed_hyper(torch.cat([latent_scales, latent_means], dim=1))

    def entro_predict(self, y_in, latent_scales, latent_means, h_emb=None):
        """One checkerboard pass: (μ, σ) given the decoded latent ``y_in``
        (zeros where unknown) and the hyper (or ``h_emb``)."""
        hyper = None if h_emb is not None else torch.cat([latent_scales, latent_means], dim=1)
        return self.entro_context.run(y_in, hyper, None, h_emb=h_emb)

    # ------------------------------------ neural-syntax wavefront passes

    def ns_hyper_encode(self, z3: torch.Tensor) -> torch.Tensor:
        """z3 → z2 (unrounded; the symbols are round(z2))."""
        return self.ha_model(z3)

    def ns_hyper_decode(self, z2_int: torch.Tensor) -> torch.Tensor:
        """Integer ẑ2 → hyper features h2."""
        return self.hs_model(z2_int)

    def ns_z2_sigma(self) -> torch.Tensor:
        """max(|σ_z2|, 1e-4), (N,)."""
        return torch.clamp(torch.abs(self.z2_sigma), min=1e-4)[0, 0, 0]

    def ns_syntax_params(self, h2: torch.Tensor):
        """(μ, σ) of the syntax vector, each (B, M, 1, 1)."""
        return self.prediction_model_syntax(h2)

    def ns_context_head(self, merged: torch.Tensor):
        """(μ, σ) from prebuilt (P, C_y + C_h, 4, 4) context patches."""
        return self.prediction_model.head(merged)
