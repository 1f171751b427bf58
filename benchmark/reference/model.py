"""The reference codec: ``source_net`` and ``net_unet_ha_hs_dec`` in
plain PyTorch.

Frozen copy of ``lic_tpu_torch/models/{codec,transforms,hyper,syntax}.py``
and ``lic_tpu_torch/entropy/{factorized,gaussian}.py`` at commit a087453,
kept to the charm family with the ``classic_dual`` or ``unet_dec`` hyper,
ChARM slices with LRP (with or without SWAtten), the ``basic`` or ``wam``
syntax model and its generated 1x1 conv, and the ``plain`` or ``rich``
transforms.  Eval mode rounds as the coder does (z about the entropy
bottleneck's medians, each slice about its μ); training mode adds U(-½, ½)
noise drawn through ``noise_fn`` in the program's order (z, then slices
0-3).  The stages (``analyze``, ``hyper_encode``, ``hyper_decode``,
``syntax``, ``slice_chain``, ``synthesize``) are the passes the program's
coder runs, so the benchmark counts each one's operations apart.

``ReferenceCodec`` also carries what the harness needs to know of this
model and no other: the program features it does not model
(``UNMODELLED``), its weight declarations (``LATENT_LEAF``,
``SIGMA_BIASES``, ``GENERATOR_HEADS``, ``BOTTLENECKS``, ``leaf_rule``)
and its counts (``counts``).  A configuration names its class in its file
(``"reference": "model:ReferenceCodec"``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import roofline
from .layers import (
    GDN,
    IGDN,
    Conv2d,
    ConvTranspose2d,
    DepthwiseConv2d,
    Linear,
    ResidualBlock3_5,
    ResidualBlock3x3,
    ResidualBlock5x5,
    ResidualBlockWithStride,
    ResidualBottleneck,
    SWAtten,
    WinBasedAttention,
    WinNoShiftAttention,
    gelu,
    leaky_relu,
    lower_bound,
)

NoiseFn = Callable[[Sequence[int], torch.dtype, torch.device], torch.Tensor]

# ------------------------------------------------------------------ transforms

_DOWN_PAD = (1, 2, 1, 2)


def _down5(cin: int, cout: int) -> Conv2d:
    return Conv2d(cin, cout, 5, 2, _DOWN_PAD)


class _Up5(nn.Module):
    """ZeroPad2d((1,0,1,0)) + ConvTranspose2d(5, 2, 3, output_padding=1)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.deconv = ConvTranspose2d(cin, cout, 5, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.deconv(F.pad(x, (1, 0, 1, 0)))


class AnalysisTransform(nn.Module):
    def __init__(self, N: int, variant: str):
        super().__init__()
        wam, rich = variant != "plain", variant == "rich"
        if rich:
            for i in range(3):
                self.add_module(f"rb0_{i}", ResidualBottleneck(3))
            self.rbs0 = ResidualBlockWithStride(3, N, 2)
        else:
            self.down0 = _down5(3, N)
        self.gdn0 = GDN(N)
        self.down1 = _down5(N, N)
        self.gdn1 = GDN(N)
        if wam:
            self.wam0 = WinNoShiftAttention(N, 8, 8, 4)
        if rich:
            for i in range(3):
                self.add_module(f"rb1_{i}", ResidualBottleneck(N))
            self.rbs1 = ResidualBlockWithStride(N, N, 2)
        else:
            self.down2 = _down5(N, N)
        self.gdn2 = GDN(N)
        self.down3 = _down5(N, N)
        if wam:
            self.wam1 = WinNoShiftAttention(N, 8, 4, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = layer(x)
        return x


class SynthesisTransform(nn.Module):
    def __init__(self, N: int, out_channels: int, variant: str):
        super().__init__()
        wam = variant != "plain"
        if wam:
            self.wam0 = WinNoShiftAttention(N, 8, 4, 2)
        cin = N
        for i, f in enumerate([N, N, N, out_channels]):
            self.add_module(f"up{i}", _Up5(cin, f))
            self.add_module(f"igdn{i}", IGDN(f))
            if wam and i == 1:
                self.wam1 = WinNoShiftAttention(f, 8, 8, 2 if variant == "rich" else 4)
            cin = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = layer(x)
        return x


# ----------------------------------------------------------------------- hypers

class ClassicHyperAnalysis(nn.Module):
    def __init__(self, N: int):
        super().__init__()
        self.c0 = Conv2d(N, N, 3, 1, 1)
        self.c1 = Conv2d(N, N, 5, 2, 2)
        self.c2 = Conv2d(N, N, 5, 2, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.c0(torch.abs(x)))
        x = torch.relu(self.c1(x))
        return self.c2(x)


class ClassicHyperSynthesis(nn.Module):
    def __init__(self, N: int):
        super().__init__()
        self.d0 = ConvTranspose2d(N, N, 5, 2, 2, 1)
        self.d1 = ConvTranspose2d(N, N, 5, 2, 2, 1)
        self.c2 = Conv2d(N, N, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.d0(x))
        x = torch.relu(self.d1(x))
        return self.c2(x)


def _cat(*ts: torch.Tensor) -> torch.Tensor:
    return torch.cat(ts, dim=1)


class UnetHyperAnalysis(nn.Module):
    """→ z, the 512-channel middle at /4 of the latent."""

    def __init__(self, c: int, num_heads: int = 8):
        super().__init__()
        half = c // 2
        self.attn0 = WinBasedAttention(half, num_heads, 4, 2)
        self.conv1 = ResidualBlock3_5(c - half)
        self.down0 = Conv2d(c, c, 1)
        self.down1 = Conv2d(c, 256, 3, 2, 1)
        self.conv2 = ResidualBlock5x5(128)
        self.attn1 = WinBasedAttention(128, num_heads, 4, 2)
        self.down3 = Conv2d(256, 256, 1)
        self.down2 = Conv2d(256, 512, 3, 2, 1)
        self.mid0 = ResidualBottleneck(512)
        self.mid_attn = WinBasedAttention(512, num_heads, 2, 1)
        self.mid1 = ResidualBottleneck(512)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half = x.shape[1] // 2
        d1 = self.down0(_cat(self.conv1(x[:, half:]), self.attn0(x[:, :half]))) + x
        d1 = gelu(self.down1(d1))
        d2 = self.down3(_cat(self.conv2(d1[:, 128:]), self.attn1(d1[:, :128]))) + d1
        d2 = gelu(self.down2(d2))
        return self.mid1(self.mid_attn(self.mid0(d2)))


class UnetHyperSynthesis(nn.Module):
    """The two-headed U-Net hyper decoder: → (scales, means)."""

    def __init__(self, out_channels: int, inp_channels: int, num_heads: int = 8):
        super().__init__()
        self.conv3 = ResidualBlock3x3(256)
        self.attn3 = WinBasedAttention(256, num_heads, 2, 1)
        self.up0 = Conv2d(512, 512, 1)
        self.up1 = ConvTranspose2d(512, 256, 5, 2, 2, 1)
        self.up3 = Conv2d(512, 256, 1)
        self.conv4 = ResidualBlock3x3(128)
        self.attn2 = WinBasedAttention(128, num_heads, 2, 1)
        self.up5 = Conv2d(256, 256, 1)
        self.up2 = ConvTranspose2d(256, 192, 5, 2, 2, 1)
        self.up4 = ConvTranspose2d(192 + inp_channels, out_channels, 1, 1, 0, 0)
        self.up4b = ConvTranspose2d(192 + inp_channels, out_channels, 1, 1, 0, 0)

    def forward(self, middle, skip1, inp):
        u1 = self.up0(_cat(self.conv3(middle[:, 256:]), self.attn3(middle[:, :256]))) + middle
        u1 = gelu(self.up1(u1))
        u1 = gelu(self.up3(_cat(u1, skip1)))
        u2 = self.up5(_cat(self.conv4(u1[:, 128:]), self.attn2(u1[:, :128]))) + u1
        u2 = _cat(gelu(self.up2(u2)), inp)
        return self.up4(u2), self.up4b(u2)


class DecodableUnetHyperSynthesis(nn.Module):
    """The skip pyramid re-synthesized from ẑ, then the U-Net decoder."""

    def __init__(self, out_channels: int, num_heads: int = 8):
        super().__init__()
        self.skip_up1 = ConvTranspose2d(512, 256, 5, 2, 2, 1)
        self.skip_up2 = ConvTranspose2d(256, 192, 5, 2, 2, 1)
        self.body = UnetHyperSynthesis(out_channels, 192, num_heads)

    def forward(self, z_hat: torch.Tensor):
        skip1 = gelu(self.skip_up1(z_hat))
        inp = gelu(self.skip_up2(skip1))
        return self.body(z_hat, skip1, inp)


# ----------------------------------------------------------------------- syntax

def _gap(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(2, 3), keepdim=True)


class DepthwiseSeparableConv(nn.Module):
    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.depthwise = DepthwiseConv2d(in_dim)
        self.pointwise = Conv2d(in_dim, out_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))


class SyntaxModel(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, variant: str):
        super().__init__()
        self.wam_variant = variant == "wam"
        if self.wam_variant:
            self.dw0 = DepthwiseSeparableConv(in_dim, in_dim)
        self.down0 = Conv2d(in_dim, 32, 3, 2, 1)
        if self.wam_variant:
            self.dw1 = DepthwiseSeparableConv(32, 32)
        self.down1 = Conv2d(32, 64, 3, 2, 1)
        if self.wam_variant:
            self.wam = WinNoShiftAttention(64, 8, 4, 2)
            self.dw2 = DepthwiseSeparableConv(64, 64)
            self.down2 = Conv2d(64, 128, 3, 2, 1)
        self.out_conv = Conv2d(in_dim + 96 + (128 if self.wam_variant else 0), out_dim, 1)

    def forward(self, s: torch.Tensor) -> torch.Tensor:
        if not self.wam_variant:
            d0 = torch.relu(self.down0(s))
            d1 = torch.relu(self.down1(d0))
            return self.out_conv(torch.cat([_gap(s), _gap(d0), _gap(d1)], dim=1))
        d0 = torch.relu(self.down0(self.dw0(s)))
        d1 = self.wam(torch.relu(self.down1(self.dw1(d0))))
        d2 = torch.relu(self.down2(self.dw2(d1)))
        return self.out_conv(torch.cat([_gap(s), _gap(d0), _gap(d1), _gap(d2)], dim=1))


class ConvGenerator(nn.Module):
    """Syntax vector (B, M, 1, 1) → per-image 1x1 conv weights (B, 3, M)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.out_dim = out_dim
        self.fc0 = Linear(in_dim, 128)
        self.fc1 = Linear(128, 256)
        self.fc2 = Linear(256, out_dim * 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        x = leaky_relu(self.fc0(x.reshape(b, -1)), 0.2)
        x = leaky_relu(self.fc1(x), 0.2)
        return self.fc2(x).reshape(b, 3, self.out_dim)


def batch_conv(weights: torch.Tensor, inputs: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bchw,boc->bohw", inputs, weights)


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """Round with the identity gradient."""
    if torch.is_grad_enabled() and x.requires_grad:
        return x + (torch.round(x) - x).detach()
    return torch.round(x)


# ---------------------------------------------------------------------- entropy

_EB_FILTERS = (3, 3, 3, 3)
_LIKELIHOOD_BOUND = 1e-9
_TAIL_MASS = 1e-9
_SCALE_BOUND = 0.11


class EntropyBottleneck(nn.Module):
    """The factorized prior of z: a per-channel monotone MLP."""

    def __init__(self, channels: int):
        super().__init__()
        c = channels
        self.n_layers = len(_EB_FILTERS) + 1
        dims = (1,) + _EB_FILTERS + (1,)
        for i in range(self.n_layers):
            self.register_parameter(f"matrix_{i}", nn.Parameter(torch.empty(c, dims[i + 1],
                                                                            dims[i])))
            self.register_parameter(f"bias_{i}", nn.Parameter(torch.empty(c, dims[i + 1], 1)))
            if i < len(_EB_FILTERS):
                self.register_parameter(f"factor_{i}",
                                        nn.Parameter(torch.empty(c, dims[i + 1], 1)))
        self.quantiles = nn.Parameter(torch.empty(c, 1, 3))

    def _logits_cumulative(self, inputs: torch.Tensor, detach: bool = False) -> torch.Tensor:
        p = lambda name: getattr(self, name).detach() if detach else getattr(self, name)
        logits = inputs
        for i in range(self.n_layers):
            logits = torch.matmul(F.softplus(p(f"matrix_{i}")), logits) + p(f"bias_{i}")
            if i < self.n_layers - 1:
                logits = logits + torch.tanh(p(f"factor_{i}")) * torch.tanh(logits)
        return logits

    @property
    def medians(self) -> torch.Tensor:
        return self.quantiles[:, 0, 1]

    def forward(self, x: torch.Tensor, training: bool, noise_fn: Optional[NoiseFn]):
        b, c, h, w = x.shape
        perm = x.permute(1, 0, 2, 3).reshape(c, 1, -1)
        if training:
            outputs = perm + noise_fn(perm.shape, perm.dtype, perm.device)
        else:
            medians = self.quantiles[:, :, 1:2].detach()
            outputs = torch.round(perm - medians) + medians
        v0 = self._logits_cumulative(outputs - 0.5)
        v1 = self._logits_cumulative(outputs + 0.5)
        sign = -torch.sign(v0 + v1)
        lik = torch.abs(torch.sigmoid(sign * v1) - torch.sigmoid(sign * v0))
        lik = lower_bound(lik, _LIKELIHOOD_BOUND)
        return lik.reshape(c, b, h, w).permute(1, 0, 2, 3)

    def aux_loss(self) -> torch.Tensor:
        logits = self._logits_cumulative(self.quantiles, detach=True)
        t = float(np.log(2.0 / _TAIL_MASS - 1.0))
        target = torch.tensor([-t, 0.0, t], dtype=logits.dtype, device=logits.device)
        return torch.sum(torch.abs(logits - target))


def _standardized_cumulative(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.erfc(-x / math.sqrt(2.0))


def gaussian_likelihood(inputs, scales, means, training: bool, noise_fn: Optional[NoiseFn]):
    """CompressAI's conditional Gaussian: the scale bounded at 0.11, the
    likelihood at 1e-9; eval rounds about the mean, training adds noise."""
    if training:
        outputs = inputs + noise_fn(inputs.shape, inputs.dtype, inputs.device)
    else:
        outputs = torch.round(inputs - means) + means
    scales = lower_bound(scales, _SCALE_BOUND)
    values = torch.abs(outputs - means)
    lik = (_standardized_cumulative((0.5 - values) / scales)
           - _standardized_cumulative((-0.5 - values) / scales))
    return lower_bound(lik, _LIKELIHOOD_BOUND)


def _bpp(likelihood: torch.Tensor, num_pixels: int) -> torch.Tensor:
    return torch.sum(torch.log(likelihood)) / (-math.log(2.0) * num_pixels)


# ------------------------------------------------------------------------ codec

class _CharmSliceStack(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.c0 = Conv2d(cin, 224, 3, 1, 1)
        self.c1 = Conv2d(224, 128, 3, 1, 1)
        self.c2 = Conv2d(128, cout, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c2(gelu(self.c1(gelu(self.c0(x)))))


class ReferenceCodec(nn.Module):
    """A charm codec from a configuration file's ``model`` entry:
    ``transform`` ('plain' | 'plain_wam' | 'rich'), ``hyper``
    ('classic_dual' | 'unet_dec'), ``swatten``, ``syntax`` ('basic' |
    'wam'), ``N``, ``M``, ``num_slices``."""

    # the program's features this reference does not model: the program's
    # configuration field and the truth value at which the feature is on
    # (LRP off, gain units, the HAN tail); ``system.build_program`` refuses them
    UNMODELLED = {"lrp": False, "gain_units": True, "post_processing": True}
    # ``benchmark.weights``: the leaf the configuration's ``latent_gain``
    # scales, the σ heads' biases (name patterns) that get ``SIGMA_BIAS``,
    # the generated conv's head (the program's own scale) and the entropy
    # bottlenecks (a fitted density), each by name
    LATENT_LEAF = "g_a.down3.weight"
    SIGMA_BIASES = ("cc_scale_transforms.*.c2.bias",)
    GENERATOR_HEADS = ("conv_weights_gen.fc2",)
    BOTTLENECKS = ("entropy_bottleneck",)

    def __init__(self, model: Dict):
        super().__init__()
        N, M = int(model["N"]), int(model["M"])
        self.N, self.M, self.num_slices = N, M, int(model["num_slices"])
        self.hyper = model["hyper"]
        self.swatten = bool(model["swatten"])
        self.g_a = AnalysisTransform(N, model["transform"])
        self.g_s = SynthesisTransform(N, M, model["transform"])
        self.syntax_model = SyntaxModel(M, M, model["syntax"])
        self.conv_weights_gen = ConvGenerator(M, M)
        if self.hyper == "classic_dual":
            self.h_a = ClassicHyperAnalysis(N)
            self.h_mean_s = ClassicHyperSynthesis(N)
            self.h_scale_s = ClassicHyperSynthesis(N)
            z_channels = N
        elif self.hyper == "unet_dec":
            self.h_a = UnetHyperAnalysis(N)
            self.h_s = DecodableUnetHyperSynthesis(N)
            z_channels = 512
        else:
            raise ValueError(f"the reference has no hyper {self.hyper!r}")
        self.entropy_bottleneck = EntropyBottleneck(z_channels)
        ns = self.num_slices
        sc = N // ns
        if self.swatten:
            att = lambda i: SWAtten(N + sc * i, N + sc * i, 16, 8, inter_dim=128)
            self.atten_mean = nn.ModuleList(att(i) for i in range(ns))
            self.atten_scale = nn.ModuleList(att(i) for i in range(ns))
        self.cc_mean_transforms = nn.ModuleList(_CharmSliceStack(N + sc * i, sc)
                                                for i in range(ns))
        self.cc_scale_transforms = nn.ModuleList(_CharmSliceStack(N + sc * i, sc)
                                                 for i in range(ns))
        self.lrp_transforms = nn.ModuleList(_CharmSliceStack(N + sc * (i + 1), sc)
                                            for i in range(ns))

    # the stages the program's coder runs, each on a batch of images

    def analyze(self, x: torch.Tensor) -> torch.Tensor:
        return self.g_a(x)

    def hyper_encode(self, y: torch.Tensor) -> torch.Tensor:
        return self.h_a(y)

    def quantize_z(self, z: torch.Tensor) -> torch.Tensor:
        med = self.entropy_bottleneck.medians[None, :, None, None]
        return ste_round(z - med) + med

    def hyper_decode(self, z_hat: torch.Tensor):
        """ẑ → (scales, means)."""
        if self.hyper == "unet_dec":
            return self.h_s(z_hat)
        return self.h_scale_s(z_hat), self.h_mean_s(z_hat)

    def slice_params(self, means, scales, support: List[torch.Tensor], i: int):
        """(μ, σ, mean support) of slice ``i`` given the decoded slices."""
        mean_support = torch.cat([means] + support, dim=1)
        if self.swatten:
            mean_support = self.atten_mean[i](mean_support)
        mu = self.cc_mean_transforms[i](mean_support)
        scale_support = torch.cat([scales] + support, dim=1)
        if self.swatten:
            scale_support = self.atten_scale[i](scale_support)
        sigma = self.cc_scale_transforms[i](scale_support)
        return mu, sigma, mean_support

    def apply_lrp(self, mean_support, y_hat_slice, i: int) -> torch.Tensor:
        lrp_in = torch.cat([mean_support, y_hat_slice], dim=1)
        return y_hat_slice + 0.5 * torch.tanh(self.lrp_transforms[i](lrp_in))

    def slice_chain(self, y: torch.Tensor, means, scales, training: bool = False,
                    noise_fn: Optional[NoiseFn] = None):
        """→ (ŷ, likelihoods of y): every slice rounded about its μ."""
        y_hat, liks = [], []
        for i, y_slice in enumerate(y.chunk(self.num_slices, dim=1)):
            mu, sigma, mean_support = self.slice_params(means, scales, y_hat, i)
            liks.append(gaussian_likelihood(y_slice, sigma, mu, training, noise_fn))
            y_hat.append(self.apply_lrp(mean_support, ste_round(y_slice - mu) + mu, i))
        return torch.cat(y_hat, dim=1), torch.cat(liks, dim=1)

    def syntax(self, y: torch.Tensor) -> torch.Tensor:
        return ste_round(self.syntax_model(y[:, : self.M]))

    def synthesize(self, y_hat: torch.Tensor, syntax: torch.Tensor) -> torch.Tensor:
        return torch.tanh(batch_conv(self.conv_weights_gen(syntax), self.g_s(y_hat)))

    def forward(self, x: torch.Tensor, training: bool = False,
                noise_fn: Optional[NoiseFn] = None) -> Dict[str, torch.Tensor]:
        """The eval forward (what a decode returns), or the training one:
        → x_hat, bpp, mse."""
        b, _, h, w = x.shape
        y = self.analyze(x)
        z = self.hyper_encode(y)
        z_lik = self.entropy_bottleneck(z, training, noise_fn)
        scales, means = self.hyper_decode(self.quantize_z(z))
        syntax = self.syntax(y)
        y_hat, y_lik = self.slice_chain(y, means, scales, training, noise_fn)
        x_hat = self.synthesize(y_hat, syntax)
        n = b * h * w
        return {"x_hat": x_hat, "bpp": _bpp(y_lik, n) + _bpp(z_lik, n),
                "mse": torch.mean((x_hat - x) ** 2)}

    # what the harness reads of this model

    def leaf_rule(self, name: str, value: torch.Tensor) -> torch.Tensor:
        """A weight rule of this model's own for the leaf ``name``, applied
        after ``benchmark.weights``' rules (none here)."""
        return value

    def counts(self, b: int, h: int, w: int) -> Dict[str, object]:
        """Operations of each pass of the program's coder on a batch of
        ``b`` images of ``h`` × ``w`` (on the ``meta`` device; build the
        reference there), a roundtrip's operations (compress: g_a, h_a,
        h_s, syntax, slices; decode: h_s, slices, g_s), and the bytes of
        g_a's and g_s's passes (inputs, outputs, weights, once each)."""
        with torch.device("meta"), torch.no_grad():
            x = torch.empty(b, 3, h, w)
            y = self.analyze(x)
            z_hat = self.quantize_z(self.hyper_encode(y))
            scales, means = self.hyper_decode(z_hat)
            syntax = self.syntax(y)
            y_hat, _ = self.slice_chain(y, means, scales)
            x_hat = self.synthesize(y_hat, syntax)
            f = {
                "analyze": roofline.count_flops(lambda: self.analyze(x)),
                "hyper_encode": roofline.count_flops(lambda: self.hyper_encode(y)),
                "hyper_decode": roofline.count_flops(lambda: self.hyper_decode(z_hat)),
                "syntax": roofline.count_flops(lambda: self.syntax(y)),
                "slice_chain": roofline.count_flops(
                    lambda: self.slice_chain(y, means, scales)),
                "synthesize": roofline.count_flops(lambda: self.synthesize(y_hat, syntax)),
            }
        return {
            "flops": f,
            "roundtrip_flops": (f["analyze"] + f["hyper_encode"] + 2 * f["hyper_decode"]
                                + f["syntax"] + 2 * f["slice_chain"] + f["synthesize"]),
            "analyze_bytes": roofline.nbytes(x, y) + roofline.param_bytes([self.g_a]),
            "synthesize_bytes": (roofline.nbytes(y_hat, syntax, x_hat)
                                 + roofline.param_bytes([self.g_s, self.conv_weights_gen])),
        }
