"""Typed configuration: the port's copies of ``CodecConfig``,
``TrainConfig`` and ``EvalConfig``.

Copies of ``lic_tpu/config.py:17-189`` (plain dataclasses), kept here so
that the port imports nothing of the JAX package.  Tests hold every field
of the port's presets, and ``TrainConfig``'s and ``EvalConfig``'s
defaults, equal to the JAX package's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class CodecConfig:
    """Architecture configuration shared by both codec families."""

    # family: 'neural_syntax' (model/net.py lineage) or 'charm'
    # (source_net / net_ga / net_ha / net_unet* / Net_unet* lineage)
    family: str = "charm"

    # rate regime: low (N=192, M=16) vs high (N=384, M=32) — model/net.py:446-453
    is_high: bool = False

    # analysis/synthesis transform family:
    #   'plain'     — GDN conv stack            (model/net.py:91-148)
    #   'plain_wam' — plain + Win_noShift gates (source_net_WAM.py:252-306)
    #   'rich'      — ResidualBottleneck/RBS + WAM (net_unet_ha_hs.py:197-326)
    #   'rbs'       — g_s = working synthesisTransformModel_RBS assembly
    #                 (Net_unet.py:371-419; broken+unused in ref), g_a = rich
    transform: str = "plain"

    # hyper path:
    #   'classic'      — h_a + single h_s                  (model/net.py:456-473)
    #   'classic_dual' — h_a + separate mean/scale h_s + EB (source_net.py:699-715)
    #   'elic'         — conv h_a + subpel mean/scale h_s + EB (net_ga.py:811-846)
    #   'unet'         — split U-Net ha/hs + EB(512)        (net_ha.py:867-880)
    #                    (NOT decodable: decoder eats encoder-side skips)
    #   'unet_dec'     — decodable U-Net hyper: same decoder topology with
    #                    the skip pyramid re-synthesized from coded ẑ only
    #                    (this framework's shippable flagship path)
    #   'latent_unet'  — uncoded latent U-Net mean/scale    (Net_unet.py:869,1014)
    hyper: str = "classic"

    # U-Net style.  For hyper='unet' the split ha/hs pair always uses
    # WinBasedAttention (Unet_ha_new/Unet_hs_new).  For hyper='latent_unet'
    # this selects the latent U-Net body: 'res' = ResidualBottleneck stages
    # (the reference's Unet) vs 'conv1x1' = 1x1-conv stages (Unet_new);
    # any value other than 'conv1x1' resolves to 'res'.
    unet_variant: str = "res"
    # one shared hyper-synthesis evaluated once with two heads (True, the TPU
    # design — replaces the double forward at net_unet_ha_hs.py:892-895) or
    # two separate decoders (net_unet_ha_hs_1.py:810-811).
    shared_hyper_decoder: bool = True

    # entropy machinery over y (charm family):
    #   'charm'       — channel-conditional slice loop (the reference's)
    #   'entroformer' — masked-attention checkerboard AR context
    #                   (the capability of the missing model/Block.py path;
    #                   decodes in 2 device passes)
    context: str = "charm"
    # entroformer context capacity (context='entroformer' only).  The
    # round-2 default ran scaled-down (4 layers, dim=N); 'full' matches
    # the reference transformer sizing (entroformer_helper.py:12-69:
    # 6 layers, 6 heads, dim_head 64) projected to dim=2N=384.
    entro_layers: int = 4
    entro_heads: int = 8
    entro_dim_mult: int = 1       # context dim = entro_dim_mult * N
    entro_topk: int = -1          # top-k attention sparsification (-1 = off)
    num_slices: int = 4
    max_support_slices: int = 4
    swatten: bool = True          # SWAtten in the slice loop (net_ga yes, source_net no)
    lrp: bool = True              # latent residual prediction
    swatten_window: int = 8

    # neural-syntax machinery
    syntax: str = "basic"         # 'basic' | 'wam' | 'none'
    # g_s emits M channels + per-image generated 1x1 conv → 3 (True), or 3
    # directly with the syntax conv bypassed (False — net_unet_ha_hs_1.py:781,1055)
    syntax_decoder: bool = True
    # tanh after the syntax batch-conv (ChARM nets do, net.py does not)
    tanh_after_syntax: bool = True
    # code the syntax stream with PredictionModel_Syntax (neural_syntax family;
    # the ChARM forwards never entropy-code the syntax vector)
    code_syntax: bool = True

    # post-processing (HAN head + second generated conv + add_mean)
    post_processing: bool = False

    # variable-rate gain units (beyond reference, charm family): K learned
    # per-channel gain/inverse-gain vector pairs scale the latent before
    # quantization and after dequantization (Cui et al., "Asymmetric
    # Gained Deep Image Compression").  One checkpoint then serves K
    # discrete rates, with continuous rates by exponential interpolation
    # of adjacent pairs (linear in the log-gain parameterization).
    # 0 = off (every reference-parity preset).
    gain_units: int = 0
    # init span: unit K-1 starts at `gain_span`x the amplitude of unit 0,
    # log-spaced — so the rate ordering is monotone from step 0
    gain_span: float = 4.0

    # bpp accounting: True counts hyper (z) bits — the *intended* semantics;
    # False reproduces the reference ChARM train bpp that counts only y
    # (defect register §8.7).
    count_hyper_bpp: bool = True

    # capacity override for scaled-down test topologies (None = reference
    # widths).  Lets the suite execute the full flagship GRAPH (SWAtten
    # slice stacks, U-Net hyper) under an 8-device mesh at CPU-compilable
    # cost; real presets never set it.
    n_override: Optional[int] = None

    # ---- derived capacities ----
    @property
    def N(self) -> int:
        if self.n_override is not None:
            return self.n_override
        return 384 if self.is_high else 192

    @property
    def M(self) -> int:
        return 32 if self.is_high else 16

    @property
    def content_channels(self) -> int:
        """Channels entering g_s: N−M for neural_syntax (content stream),
        N for charm (full latent), irrespective of syntax decoding."""
        return (self.N - self.M) if self.family == "neural_syntax" else self.N

    def replace(self, **kw) -> "CodecConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters (reference defaults from
    ``train_net_unet.py:125-134,273-290``)."""

    lmbda: float = 0.0025
    lr: float = 1e-4
    batch_size: int = 8
    crop_size: int = 256
    epochs: int = 5000
    lr_milestones: Tuple[int, ...] = (1500, 2500, 3500, 4000)
    lr_gamma: float = 0.5
    grad_clip_norm: float = 1.0
    # post-processing-only phase (AdamW): train_net_unet.py:125-130
    pp_epochs: int = 1500
    pp_milestones: Tuple[int, ...] = (1200, 1350)
    loss_type: str = "mse"        # 'mse' | 'msssim' (train_net_unet.py:83-85)
    seed: int = 0
    ckpt_every_epochs: int = 100
    aux_lr: float = 1e-3          # factorized-prior quantiles (aux loss)
    # decoupled weight decay for the base phase (0 = reference-parity
    # plain Adam)
    weight_decay: float = 0.0
    # multi-rate training for gain-unit models: one λ per gain unit.
    # Empty = single-rate (every reference-parity run).
    lmbda_list: Tuple[float, ...] = ()


@dataclass(frozen=True)
class EvalConfig:
    """Evaluation settings (``eval_net.py`` semantics, defects fixed)."""

    lmbda: float = 0.0067
    pad_multiple: int = 64
    # content-adaptive encoding (eval_net.py:118-199)
    tune_iters: int = 100
    tune_lr: float = 1e-5
    tune_lr_drop_step: int = 50
    tune_lr_gamma: float = 0.5
    # True: the train-consistent λ·255²·mse + bpp; False: the reference's
    # literal λ·mse + bpp (eval_net.py:176, SURVEY defect §8.13, which
    # weights distortion about 65,000× less than training does)
    tune_loss_255sq: bool = True
    # gain-unit operating point (None = unit 0)
    rate: Optional[float] = None
