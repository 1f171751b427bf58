"""Preset table of the port: every row of the JAX package's table, built
from the port's ``config.CodecConfig``.

Each row must equal ``lic_tpu.models.presets.PRESETS[name]``; a test holds
it to that, field by field.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..config import CodecConfig
from .codec import CodecModel

PRESETS: Dict[str, CodecConfig] = {
    # model/net.py — the original neural-syntax model: plain GDN
    # transforms, classic hyper, PredictionModel_Context, no tanh after
    # the syntax conv
    "neural_syntax": CodecConfig(
        family="neural_syntax",
        transform="plain",
        hyper="classic",
        syntax="basic",
        tanh_after_syntax=False,
        code_syntax=True,
    ),
    # model/source_net.py — plain GDN transforms, classic dual hyper +
    # EntropyBottleneck, 4-slice ChARM with LRP, no SWAtten
    "source_net": CodecConfig(
        family="charm",
        transform="plain",
        hyper="classic_dual",
        swatten=False,
        syntax="basic",
    ),
    # model/source_net_WAM.py — source_net plus WinNoShiftAttention gates
    # in g_a and g_s
    "source_net_wam": CodecConfig(
        family="charm",
        transform="plain_wam",
        hyper="classic_dual",
        swatten=False,
        syntax="basic",
    ),
    # model/net_ga.py — rich transforms + ELIC conv hyper + SWAtten (the
    # reference eval entry point)
    "net_ga": CodecConfig(
        family="charm",
        transform="rich",
        hyper="elic",
        swatten=True,
        syntax="wam",
    ),
    # model/net_ha.py — plain transforms + split U-Net hyper + SWAtten
    "net_ha": CodecConfig(
        family="charm",
        transform="plain",
        hyper="unet",
        swatten=True,
        syntax="wam",
    ),
    # model/net_unet_ha_hs.py — the "full" model: rich transforms + U-Net
    # hyper + SWAtten + WAM syntax; the trainer's default preset
    "net_unet_ha_hs": CodecConfig(
        family="charm",
        transform="rich",
        hyper="unet",
        swatten=True,
        syntax="wam",
    ),
    # the decodable flagship: net_unet_ha_hs with the U-Net hyper's skip
    # pyramid re-synthesized from the coded z only
    "net_unet_ha_hs_dec": CodecConfig(
        family="charm",
        transform="rich",
        hyper="unet_dec",
        swatten=True,
        syntax="wam",
    ),
    # model/net_unet_ha_hs_1.py — g_s outputs RGB directly (no generated
    # conv), separate scale / means U-Net decoders
    "net_unet_ha_hs_1": CodecConfig(
        family="charm",
        transform="rich",
        hyper="unet",
        shared_hyper_decoder=False,
        swatten=True,
        syntax="wam",
        syntax_decoder=False,
    ),
    # model/Net_unet.py — rich transforms + the uncoded latent U-Net
    # (SpatialTransformer U-Net on the unquantized latent; the reference's
    # training entry point, train_net_unet.py:16)
    "net_unet": CodecConfig(
        family="charm",
        transform="rich",
        hyper="latent_unet",
        unet_variant="res",
        swatten=True,
        syntax="wam",
        count_hyper_bpp=False,     # nothing coded on the hyper path
    ),
    # model/Net_unet_1.py — net_unet with the Unet_new (1x1-conv) latent U-Net
    "net_unet_1": CodecConfig(
        family="charm",
        transform="rich",
        hyper="latent_unet",
        unet_variant="conv1x1",
        swatten=True,
        syntax="wam",
        count_hyper_bpp=False,
    ),
    # model/Net_unet_005_5.py — the λ = 0.05 twin, the 'res' U-Net
    "net_unet_005_5": CodecConfig(
        family="charm",
        transform="rich",
        hyper="latent_unet",
        unet_variant="res",
        swatten=True,
        syntax="wam",
        count_hyper_bpp=False,
    ),
    # the Entroformer path the reference implies but never ships: the
    # checkerboard masked-attention context over y, ELIC hyper
    "entroformer_cb": CodecConfig(
        family="charm",
        transform="plain",
        hyper="elic",
        context="entroformer",
        syntax="basic",
    ),
    # the reference-sized Entroformer context: 6 layers, 6 heads of 64,
    # dim 2N = 384
    "entroformer_cb_full": CodecConfig(
        family="charm",
        transform="plain",
        hyper="elic",
        context="entroformer",
        syntax="basic",
        entro_layers=6,
        entro_heads=6,
        entro_dim_mult=2,
    ),
    # variable-rate source_net: 4 learned gain-unit pairs span the
    # reference's λ family {0.0025, 0.0067, 0.013, 0.05} from one
    # checkpoint (train with TrainConfig.lmbda_list)
    "source_net_vr": CodecConfig(
        family="charm",
        transform="plain",
        hyper="classic_dual",
        swatten=False,
        syntax="basic",
        gain_units=4,
    ),
}

def get_config(name: str, **overrides) -> CodecConfig:
    cfg = PRESETS[name]
    return cfg.replace(**overrides) if overrides else cfg


def build_model(
    name: str,
    *,
    device="cuda",
    seed: int = 0,
    **overrides,
) -> CodecModel:
    """Build preset ``name`` with parameters initialised from a
    ``torch.Generator`` seeded with ``seed`` (on the CPU, so a seed gives
    the same weights on every device), then moved to ``device`` in
    ``channels_last`` memory.  The default is the card; a CUDA device on a
    host without CUDA raises instead of building on the CPU, which only
    ``device="cpu"`` asks for."""
    cfg = get_config(name, **overrides)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"build_model({name!r}): device {device} asked for, but CUDA is not "
            "available; pass device='cpu' to build on the CPU"
        )
    gen = torch.Generator().manual_seed(seed)
    model = CodecModel(cfg, generator=gen)
    return model.to(device=device, memory_format=torch.channels_last).eval()
