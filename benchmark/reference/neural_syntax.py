"""The reference of the neural-syntax codec: ``neural_syntax`` in plain
PyTorch.

The model of https://github.com/xiaobucc/learning-driven-image-compression-algorithm/blob/main/model/net.py
("Neural Data-Dependent Transform", Wang et al., CVPR 2022, with the
context model of Minnen et al., arXiv:1809.02736), written from the layer
equations of ``lic_tpu_torch/models/codec.py::_forward_neural_syntax``,
``lic_tpu_torch/entropy/context.py`` and ``lic_tpu_torch/models/syntax.py``
at commit 3f0fc98; it imports nothing of that package.  The layers it
shares with the charm codecs (the plain GDN g_a, the classic hyper,
the syntax model, the generated conv) are ``model.py``'s and
``layers.py``'s.  What is its own:

* the latent y = g_a(x) splits into M **syntax** channels and N − M
  **content** channels; g_s decodes round(content) alone;
* the hyper: z2 = h_a(y), coded as round(z2) under N(0, |σ_z2|) with a
  learned per-channel ``z2_sigma``; h2 = h_s(round(z2));
* the syntax vector round(syntax_model(y[:M])) is coded under
  ``PredictionModelSyntax``'s (μ, σ) from h2;
* each content symbol is coded under the (μ, σ) of a context head over a
  4×4 causal patch of round(content) beside the same patch of h2.  The
  coder decodes it one anti-diagonal t = 2·row + col at a time; here the
  head runs over the masked patches of the **whole** rounded content at
  once, which gives the same numbers, since a patch holds only earlier
  anti-diagonals;
* x̂ = batch_conv(ConvGenerator(syntax), g_s(round(content))), with no
  tanh.

Rounding is plain: no medians, no offsets about μ.  So ŷ does not depend
on μ or σ, and a decoded image is right even where the context is wrong,
as long as the encoder and the decoder are wrong alike.  ``compared``
therefore holds the program's context (μ, σ) to this one's.

Departures from ``model/net.py``, both the program's too:

* ``PredictionModelSyntax`` and the context head unpack the fc output as
  (μ, σ = exp): the first half the means, the second the log-scales.  The
  reference code unpacks the syntax head swapped, which its training
  could not tell from the intended order;
* σ_z2 is max(|σ_z2|, 1e-4), where the reference uses |σ_z2|: the coder's
  table needs a scale above zero (``ns_z2_sigma``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import roofline
from ..weights import SIGMA_BIAS
from .layers import IGDN, Conv2d, Linear, leaky_relu
from .model import (
    AnalysisTransform,
    ClassicHyperAnalysis,
    ClassicHyperSynthesis,
    ConvGenerator,
    SyntaxModel,
    _Up5,
    batch_conv,
)

# the program's ``GaussianMuCoder`` rows, frozen: 64 scales from 0.11 to
# 256 on a log grid, 16 bins of μ − round(μ); a row is scale · 16 + bin
SCALE_TABLE = np.exp(np.linspace(math.log(0.11), math.log(256.0), 64))
N_DELTA = 16
_LIKELIHOOD_BOUND = 1e-8
_Z2_SIGMA_FLOOR = 1e-4
# ``z2_sigma``'s weight: about the spread of z2 = h_a(y) at the
# configuration's latent_gain
Z2_SIGMA = 0.3
# the context head's σ about which its σ half's bias is drawn
CONTEXT_SIGMA = 0.6
# the context patch: rows -3..0 and columns -2..+1 about a position, the
# position itself and its right neighbour masked
_PATCH_PAD = (2, 1, 3, 0)  # left, right, top, bottom
_MASKED = ((3, 2), (3, 3))


def _normal_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def likelihood(values: torch.Tensor, sigma: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """The unit bin's mass about ``values`` under N(μ, σ), at least 1e-8."""
    upper = _normal_cdf((values - mu + 0.5) / sigma)
    lower = _normal_cdf((values - mu - 0.5) / sigma)
    return torch.clamp(upper - lower, min=_LIKELIHOOD_BOUND)


def _bits(lik: torch.Tensor) -> torch.Tensor:
    return -torch.log2(lik).sum()


def causal_patches(x: torch.Tensor, masked: bool) -> torch.Tensor:
    """(B, C, H, W) → (B·H·W, C, 4, 4): each position's patch of rows
    −3..0 and columns −2..+1 about it (zeros outside the map), raster
    order; ``masked`` zeroes the position and its right neighbour."""
    b, c, h, w = x.shape
    cols = F.unfold(F.pad(x, _PATCH_PAD), 4)  # (B, C·16, H·W), (c, i, j) major to minor
    t = cols.view(b, c, 4, 4, h * w).permute(0, 4, 1, 2, 3).reshape(b * h * w, c, 4, 4)
    if masked:
        t = t.clone()
        for i, j in _MASKED:
            t[:, :, i, j] = 0.0
    return t


class ContentSynthesis(nn.Module):
    """The plain GDN g_s from the N − M content channels to M."""

    def __init__(self, N: int, M: int):
        super().__init__()
        cin = N - M
        for i, f in enumerate([N, N, N, M]):
            self.add_module(f"up{i}", _Up5(cin, f))
            self.add_module(f"igdn{i}", IGDN(f))
            cin = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.children():
            x = layer(x)
        return x


class PredictionModelSyntax(nn.Module):
    """h2 → (μ, σ) of the syntax vector, each (B, M, 1, 1): two 3×3
    stride-2 convs with ReLU, the pooled pyramid, one fc."""

    def __init__(self, N: int, M: int):
        super().__init__()
        self.M = M
        self.down0 = Conv2d(N, M, 3, 2, 1)
        self.down1 = Conv2d(M, M, 3, 2, 1)
        self.fc = Linear(N + 2 * M, 2 * M)

    def forward(self, h2: torch.Tensor):
        b = h2.shape[0]
        d0 = torch.relu(self.down0(h2))
        d1 = torch.relu(self.down1(d0))
        pooled = torch.cat([t.mean(dim=(2, 3)) for t in (h2, d0, d1)], dim=1)
        out = self.fc(pooled)
        mu, log_sigma = out[:, : self.M], out[:, self.M :]
        return mu.reshape(b, -1, 1, 1), torch.exp(log_sigma).reshape(b, -1, 1, 1)


class ContextHead(nn.Module):
    """(P, (N − M) + N, 4, 4) patches → (μ, σ), each (P, N − M): 3×3 conv
    to N, 3×3 stride-2 conv, 3×3 conv, each with LeakyReLU(0.2), then an
    fc over the (h, w, c) flattened 2×2 map."""

    def __init__(self, N: int, M: int):
        super().__init__()
        self.c = N - M
        self.c0 = Conv2d(2 * N - M, N, 3, 1, 1)
        self.c1 = Conv2d(N, N, 3, 2, 1)
        self.c2 = Conv2d(N, N, 3, 1, 1)
        self.fc = Linear(4 * N, 2 * (N - M))

    def forward(self, patches: torch.Tensor):
        t = leaky_relu(self.c0(patches), 0.2)
        t = leaky_relu(self.c1(t), 0.2)
        t = leaky_relu(self.c2(t), 0.2)
        out = self.fc(t.permute(0, 2, 3, 1).reshape(t.shape[0], -1))
        return out[:, : self.c], torch.exp(out[:, self.c :])


def coder_rows(mu: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The rows the program's coder takes for each symbol: the index of
    the first table scale not below max(σ, 0.11) − 1e-9, times 16, plus
    the bin of μ − round(μ)."""
    table = torch.as_tensor(SCALE_TABLE, dtype=sigma.dtype, device=sigma.device)
    s = torch.maximum(sigma, table[0]).contiguous()
    si = torch.searchsorted(table, s - 1e-9).clamp(0, len(SCALE_TABLE) - 1)
    dj = torch.clamp(torch.floor((mu - torch.round(mu) + 0.5) * N_DELTA), 0, N_DELTA - 1)
    return si * N_DELTA + dj.long()


def wavefronts(h: int, w: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """The positions of each anti-diagonal t = 2·row + col of an h × w
    map, rows ascending, t ascending (empty ones left out)."""
    out = []
    for t in range(2 * (h - 1) + w):
        rows = np.array([r for r in range(h) if 0 <= t - 2 * r < w], np.int64)
        if len(rows):
            out.append((rows, t - 2 * rows))
    return out


class NeuralSyntaxReference(nn.Module):
    """The neural-syntax codec from a configuration file's ``model``
    entry: ``family`` 'neural_syntax', ``transform`` 'plain', ``hyper``
    'classic', ``syntax`` 'basic', ``N``, ``M``."""

    # the program's features this reference does not model (gain units,
    # the HAN tail); ``system.build_program`` refuses them
    UNMODELLED = {"gain_units": True, "post_processing": True}
    # ``benchmark.weights``: g_a's last conv takes latent_gain; the σ
    # halves of the two fc heads and ``z2_sigma`` take ``leaf_rule``
    LATENT_LEAF = "g_a.down3.weight"
    SIGMA_BIASES: Tuple[str, ...] = ()
    GENERATOR_HEADS = ("conv_weights_gen.fc2",)
    BOTTLENECKS: Tuple[str, ...] = ()
    # the numbers ``compared`` returns that a configuration's limits hold
    COMPARED = ("context_mu_p5_err", "context_mu_p50_err",
                "context_log_sigma_p5_err", "context_log_sigma_p50_err")

    def __init__(self, model: Dict):
        super().__init__()
        N, M = int(model["N"]), int(model["M"])
        if (model["family"], model["transform"], model["hyper"], model["syntax"]) != (
                "neural_syntax", "plain", "classic", "basic"):
            raise ValueError(f"the reference has no such neural-syntax model: {model}")
        if model["tanh_after_syntax"] or not model["code_syntax"]:
            raise ValueError("the reference codes the syntax stream and has no tanh after "
                             "the generated conv")
        self.N, self.M = N, M
        self.g_a = AnalysisTransform(N, "plain")
        self.g_s = ContentSynthesis(N, M)
        self.syntax_model = SyntaxModel(M, M, "basic")
        self.conv_weights_gen = ConvGenerator(M, M)
        self.prediction_model_syntax = PredictionModelSyntax(N, M)
        self.ha_model = ClassicHyperAnalysis(N)
        self.hs_model = ClassicHyperSynthesis(N)
        self.z2_sigma = nn.Parameter(torch.empty(1, 1, 1, N))
        self.prediction_model = ContextHead(N, M)

    # the stages the program's coder runs, each on a batch of images

    def analyze(self, x: torch.Tensor) -> torch.Tensor:
        return self.g_a(x)

    def hyper_encode(self, y: torch.Tensor) -> torch.Tensor:
        return self.ha_model(y)

    def hyper_decode(self, z2_hat: torch.Tensor) -> torch.Tensor:
        return self.hs_model(z2_hat)

    def syntax(self, y: torch.Tensor) -> torch.Tensor:
        return torch.round(self.syntax_model(y[:, : self.M]))

    def syntax_params(self, h2: torch.Tensor):
        return self.prediction_model_syntax(h2)

    def context(self, content_hat: torch.Tensor, h2: torch.Tensor):
        """(μ, σ) of every content symbol, each (B, N − M, H, W), from the
        masked patches of the whole rounded content and h2's patches."""
        b, c, h, w = content_hat.shape
        patches = torch.cat([causal_patches(content_hat, True), causal_patches(h2, False)], 1)
        mu, sigma = self.prediction_model(patches)
        to_map = lambda t: t.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return to_map(mu), to_map(sigma)

    def synthesize(self, content_hat: torch.Tensor, syntax: torch.Tensor) -> torch.Tensor:
        return batch_conv(self.conv_weights_gen(syntax), self.g_s(content_hat))

    def z2_scale(self) -> torch.Tensor:
        return torch.clamp(self.z2_sigma.abs(), min=_Z2_SIGMA_FLOOR)[0, 0, 0]

    def coded(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """What the coder codes of ``x``: the rounded content and syntax,
        h2, and the (μ, σ) of each content symbol and syntax element."""
        y = self.analyze(x)
        z2_hat = torch.round(self.hyper_encode(y))
        h2 = self.hyper_decode(z2_hat)
        content_hat = torch.round(y[:, self.M :])
        syntax = self.syntax(y)
        mu, sigma = self.context(content_hat, h2)
        mu_s, sigma_s = self.syntax_params(h2)
        return {"z2_hat": z2_hat, "content_hat": content_hat, "syntax": syntax,
                "context_mu": mu, "context_sigma": sigma,
                "syntax_mu": mu_s, "syntax_sigma": sigma_s}

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The decode of ``x``'s streams (``x_hat``), the context's and the
        syntax's (μ, σ), and the streams' estimated bits per pixel."""
        b, _, h, w = x.shape
        out = self.coded(x)
        out["x_hat"] = self.synthesize(out["content_hat"], out["syntax"])
        s = self.z2_scale()[None, :, None, None]
        bits = (_bits(likelihood(out["z2_hat"], s, torch.zeros_like(s)))
                + _bits(likelihood(out["content_hat"], out["context_sigma"], out["context_mu"]))
                + _bits(likelihood(out["syntax"], out["syntax_sigma"], out["syntax_mu"])))
        out["bpp"] = bits / (b * h * w)
        return out

    # what the harness reads of this model

    def leaf_rule(self, name: str, value: torch.Tensor) -> torch.Tensor:
        """The σ halves of the two fc heads' biases raised off the 0.11
        floor (there every symbol but 0 escapes its table): the syntax
        head's ``SIGMA_BIAS`` up, as the charm σ heads'; the context
        head's log(``CONTEXT_SIGMA``) up, so its σ sits about 0.6.  At
        ``SIGMA_BIAS`` every σ of the context is about exp(0.3) = 1.35,
        where a zero alone costs 1.79 bits: the content would code at 1.23
        bpp or more, above a trained codec's 0.988, at any latent_gain.
        ``z2_sigma``: Z2_SIGMA · exp(v), v its fan-in draw (spread 1/√N),
        about the spread of z2, as a trained σ_z2."""
        half = value.shape[0] // 2 if value.dim() == 1 else 0
        if name == "prediction_model.fc.bias":
            value = value.clone()
            value[half:] += math.log(CONTEXT_SIGMA)
        elif name == "prediction_model_syntax.fc.bias":
            value = value.clone()
            value[half:] += SIGMA_BIAS
        elif name == "z2_sigma":
            value = Z2_SIGMA * torch.exp(value)
        return value

    def counts(self, b: int, h: int, w: int) -> Dict[str, object]:
        """Operations of each pass of the program's coder on a batch of
        ``b`` images of ``h`` × ``w`` (on the ``meta`` device; build the
        reference there), a roundtrip's operations (compress: g_a, h_a,
        h_s, syntax, the syntax's parameters, the context head over every
        position; decode: h_s, the syntax's parameters, the context head,
        g_s), ``context_flops`` (one pass of the head over the b·h·w/256
        latent positions; the coder's padded slots not counted) and the
        bytes of g_a's and g_s's passes (inputs, outputs, weights, once
        each)."""
        with torch.device("meta"), torch.no_grad():
            x = torch.empty(b, 3, h, w)
            y = self.analyze(x)
            z2_hat = torch.round(self.hyper_encode(y))
            h2 = self.hyper_decode(z2_hat)
            content_hat = torch.round(y[:, self.M :])
            syntax = self.syntax(y)
            x_hat = self.synthesize(content_hat, syntax)
            f = {
                "analyze": roofline.count_flops(lambda: self.analyze(x)),
                "hyper_encode": roofline.count_flops(lambda: self.hyper_encode(y)),
                "hyper_decode": roofline.count_flops(lambda: self.hyper_decode(z2_hat)),
                "syntax": roofline.count_flops(lambda: self.syntax(y)),
                "syntax_params": roofline.count_flops(lambda: self.syntax_params(h2)),
                "context": roofline.count_flops(lambda: self.context(content_hat, h2)),
                "synthesize": roofline.count_flops(
                    lambda: self.synthesize(content_hat, syntax)),
            }
        both = f["hyper_decode"] + f["syntax_params"] + f["context"]
        return {
            "flops": f,
            "roundtrip_flops": (f["analyze"] + f["hyper_encode"] + f["syntax"] + both
                                + both + f["synthesize"]),
            "context_flops": f["context"],
            "analyze_bytes": roofline.nbytes(x, y) + roofline.param_bytes([self.g_a]),
            "synthesize_bytes": (roofline.nbytes(content_hat, syntax, x_hat)
                                 + roofline.param_bytes([self.g_s, self.conv_weights_gen])),
        }

    def compared(self, side, x: torch.Tensor, decoded: torch.Tensor) -> Dict[str, float]:
        """The context's (μ, σ) of every content symbol of the batch ``x``
        as ``side`` computes them, against this reference's (float64): the
        worst image's 5th and 50th percentile of |μ − μ_ref| and of
        |log σ − log σ_ref|, and, as a reading, the worst image's share of
        symbols whose coder row differs from the reference's.

        ``side`` is the program's ``ChannelCoder``: its own compress of the
        batch (the timed code, at the timed pass size and shapes; the
        program is deterministic there) with each wavefront's (μ, σ) and
        rows taken where the coder turns them into rows (``_ns_rows``).
        Or it is the control, a reference of another precision: its
        parallel context.  ``decoded`` is not read: the images'
        comparison holds it."""
        with torch.no_grad():
            want = self.coded(x.to(self.dtype))
            mu_ref, sigma_ref = want["context_mu"], want["context_sigma"]
            if isinstance(side, NeuralSyntaxReference):
                got = side.coded(x.to(side.dtype))
                mu, sigma = got["context_mu"], got["context_sigma"]
                rows = coder_rows(mu, sigma)
            else:
                mu, sigma, rows = program_context(side, x, mu_ref.shape)
        mu, sigma = mu.to(mu_ref), sigma.to(sigma_ref)
        rows_ref = coder_rows(mu_ref, sigma_ref)
        per_image = lambda t: t.flatten(1).cpu()
        dmu = per_image((mu - mu_ref).abs())
        # a σ that is not positive is a fault, as far off as can be
        dls = per_image(torch.where(sigma > 0, (sigma.log() - sigma_ref.log()).abs(),
                                    torch.full_like(sigma, float("inf"))))
        q = torch.tensor([0.05, 0.5], dtype=dmu.dtype)
        qmu, qls = torch.quantile(dmu, q, dim=1), torch.quantile(dls, q, dim=1)
        share = per_image((rows.to(rows_ref.device).long() != rows_ref).double()).mean(1)
        return {"context_mu_p5_err": float(qmu[0].max()),
                "context_mu_p50_err": float(qmu[1].max()),
                "context_log_sigma_p5_err": float(qls[0].max()),
                "context_log_sigma_p50_err": float(qls[1].max()),
                "context_row_share": float(share.max())}


def program_context(coder, x: torch.Tensor, shape) -> Tuple[torch.Tensor, ...]:
    """The program's context (μ, σ) and rows of every content symbol of
    ``x``, each mapped to (B, N − M, H, W) of ``shape``: the coder's
    ``compress_batch`` with its ``_ns_rows`` (the step that turns each
    wavefront's (μ, σ), (B, p_max, N − M), into rows) wrapped to keep what
    it is given and gives.  The wavefronts' positions are this module's
    (rows ascending in each anti-diagonal), so a coder that visits them in
    another order reads as wrong."""
    steps = []
    inner = coder._ns_rows

    def keep(mu, sigma):
        rows, mu_r = inner(mu, sigma)
        steps.append((mu, sigma, rows))
        return rows, mu_r

    coder._ns_rows = keep
    try:
        coder.compress_batch(x)
    finally:
        del coder._ns_rows
    b, c, h, w = shape
    fronts = wavefronts(h, w)
    if len(steps) != len(fronts):
        raise ValueError(f"the coder ran {len(steps)} wavefronts of {len(fronts)}")
    out = [torch.zeros((b, h, w, c), dtype=t.dtype, device=t.device) for t in steps[0]]
    for (rr, cc), step in zip(fronts, steps):
        n = len(rr)
        r_idx, c_idx = (torch.from_numpy(a).to(out[0].device) for a in (rr, cc))
        for dst, src in zip(out, step):
            dst[:, r_idx, c_idx] = src[:, :n]
    return tuple(t.permute(0, 3, 1, 2) for t in out)
