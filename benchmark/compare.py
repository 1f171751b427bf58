"""The comparison that decides ``correct`` for decoded images.

The ``code_batch`` and ``serve_open`` drivers judge each decode against
the reference's eval forward of the same weights and image, computed in
float64.  A latent symbol that the two sides round to different integers
moves a patch of the image, so a sound fp32 run does not match bit for
bit: a few hundred of a batch's 2.4 million symbols flip, and on the
flagship each flip's patch spreads through the SWAtten windows of the
later slices.  A run in a lower precision moves every pixel.  So the
numbers compared are percentiles, over each image's pixel values, of
|decoded − reference|, each for the worst image checked: the 5th holds
the cleanest twentieth of every image at its fp32 floor, the 50th holds
half of every image there, so a fault that moves more than half of any
image fails.  A wrong or missing answer reads high; a checked image
without a decode reads infinity.  The 75th, 90th and 95th percentiles, the
relative RMS error and the share of pixels off by more than one 8-bit
level are printed beside them as readings: a sound run's flips reach
them on some seeds, by three decades and more (PERF.md gives the
readings and the limits).

A reference class may add numbers of its own (its optional method
``compared``, ``benchmark.system``): the configuration file states their
limits beside the images', and ``checks`` holds each to its limit.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .train_check import NAMES as TRAINING

LEVEL = 2.0 / 255.0
PERCENTILES = {"decode_p5_err": 0.05, "decode_p50_err": 0.5, "decode_p75_err": 0.75,
               "decode_p90_err": 0.9, "decode_p95_err": 0.95}
NAMES = ("decode_p5_err", "decode_p50_err")
READINGS = tuple(k for k in PERCENTILES if k not in NAMES) + ("rel_rms", "share_off")
_SUBSAMPLE = 7  # every 7th pixel value: torch.quantile takes at most 2**24


def image_readings(decoded: torch.Tensor, reference: torch.Tensor) -> Dict[str, List[float]]:
    """Per image (B, 3, H, W): the percentiles of the abs error (over a
    fixed subsample of its values), and the other readings."""
    if decoded.shape != reference.shape:
        raise ValueError(f"decoded {tuple(decoded.shape)} against {tuple(reference.shape)}")
    ref = reference.double().flatten(1)
    d = (decoded.double().flatten(1) - ref).abs()
    qs = torch.tensor(list(PERCENTILES.values()), dtype=d.dtype)
    per = torch.quantile(d[:, ::_SUBSAMPLE], qs, dim=1)
    out = {k: row.tolist() for k, row in zip(PERCENTILES, per)}
    return {**out,
            "share_off": (d > LEVEL).double().mean(1).tolist(),
            "rel_rms": (d.pow(2).mean(1).sqrt() / ref.pow(2).mean(1).sqrt()).tolist()}


def worst(readings: List[Dict[str, List[float]]]) -> Dict[str, float]:
    """The worst image's value of each number and reading over batches of
    readings (infinity where there are none)."""
    out = {}
    for k in NAMES + READINGS:
        vals = [v for r in readings for v in r[k]]
        out[k] = max(vals) if vals else float("inf")
    return out


def names(limits: Dict[str, float]) -> List[str]:
    """The numbers compared: the images' two, and every other limit the
    configuration states but the training check's."""
    return list(NAMES) + [k for k in limits if k not in NAMES and k not in TRAINING]


def checks(found: Dict[str, float], limits: Dict[str, float]) -> List[dict]:
    """Each number against its limit; one with a limit and no reading
    reads infinity and fails."""
    out = []
    for k in names(limits):
        v = found.get(k, float("inf"))
        out.append({"name": k, "value": v, "limit": float(limits[k]), "ok": v <= float(limits[k])})
    return out
