"""Preset table of the port: the ``source_net`` row, built from
``lic_tpu.config.CodecConfig`` (plain dataclasses, no jax).

The row must equal ``lic_tpu.models.presets.PRESETS["source_net"]``; a
test holds it to that.  Every other preset of the JAX package raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

from typing import Dict

import torch

from lic_tpu.config import CodecConfig

from .codec import CodecModel

PRESETS: Dict[str, CodecConfig] = {
    # model/source_net.py — plain GDN transforms, classic dual hyper +
    # EntropyBottleneck, 4-slice ChARM with LRP, no SWAtten
    "source_net": CodecConfig(
        family="charm",
        transform="plain",
        hyper="classic_dual",
        swatten=False,
        syntax="basic",
    ),
}

# the JAX package's other presets → the ROADMAP item that ports each
NOT_YET_PORTED: Dict[str, str] = {
    "neural_syntax": "A15",
    "source_net_wam": "A9-A10",
    "net_ga": "A10-A11",
    "net_ha": "A16",
    "net_unet_ha_hs": "A16",
    "net_unet_ha_hs_dec": "A10-A11",
    "net_unet_ha_hs_1": "A16",
    "net_unet": "A16",
    "net_unet_1": "A16",
    "net_unet_005_5": "A16",
    "entroformer_cb": "A14",
    "entroformer_cb_full": "A14",
    "source_net_vr": "A16",
}


def get_config(name: str, **overrides) -> CodecConfig:
    if name in NOT_YET_PORTED:
        raise NotImplementedError(
            f"preset {name!r} is not ported yet (ROADMAP {NOT_YET_PORTED[name]})"
        )
    cfg = PRESETS[name]
    return cfg.replace(**overrides) if overrides else cfg


def build_model(
    name: str,
    *,
    device="cpu",
    seed: int = 0,
    **overrides,
) -> CodecModel:
    """Build preset ``name`` with parameters initialised from a
    ``torch.Generator`` seeded with ``seed`` (on the CPU, so a seed gives
    the same weights on every device), then moved to ``device`` in
    ``channels_last`` memory."""
    gen = torch.Generator().manual_seed(seed)
    model = CodecModel(get_config(name, **overrides), generator=gen)
    return model.to(device=device, memory_format=torch.channels_last).eval()
