"""The system under test, built from a configuration file.

The program is ``lic_tpu_torch``: its ``build_model`` builds the preset
the file names (the program's own initialisation on the CPU, then moved
to the card), and the benchmark's weights from the run's seed replace
every leaf.  The file's ``model`` entry is checked against the program's
configuration, so that the reference and the program run the same model.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import weights as W
from .reference import ReferenceCodec


def reference_meta(config: Dict) -> ReferenceCodec:
    """The reference's structure on the ``meta`` device (no memory)."""
    with torch.device("meta"):
        return ReferenceCodec(config["model"])


def make_weights(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return W.make_weights(reference_meta(config), seed, device, config["latent_gain"])


def build_program(config: Dict, weights: Dict[str, torch.Tensor], device):
    """The program's model of the configuration on ``device``, holding
    ``weights``; every leaf of the model has to take one."""
    from lic_tpu_torch.models import build_model

    model = build_model(config["preset"], device=device)
    cfg, want = model.cfg, config["model"]
    got = {"N": cfg.N, "M": cfg.M, "transform": cfg.transform, "hyper": cfg.hyper,
           "swatten": cfg.swatten, "syntax": cfg.syntax, "num_slices": cfg.num_slices}
    wrong = {k: (got[k], v) for k, v in want.items() if k in got and got[k] != v}
    if wrong or not cfg.lrp or cfg.gain_units or cfg.post_processing:
        raise ValueError(f"{config['preset']}: the program's configuration differs from the "
                         f"file's: {wrong}")
    untouched = sorted(set(n for n, _ in model.named_parameters()) - set(weights))
    if untouched:
        raise ValueError(f"{config['preset']}: leaves the benchmark does not set: {untouched[:5]}")
    W.load(model, weights)
    return model


PRECISIONS = ("float64", "float32", "tf32")
# the precision the checks judge by
JUDGE_PRECISION = "float64"


def build_reference(config: Dict, weights: Dict[str, torch.Tensor], device,
                    precision: str = "") -> ReferenceCodec:
    """The reference on ``device`` holding ``weights``: in float64 (what
    the checks judge by), in fp32, or in fp32 whose products round their
    inputs to TF32 (the control: the configurations state fp32 with TF32
    off); by default ``JUDGE_PRECISION``.  Feed it inputs of its dtype
    (``ref.dtype``); ``fp32_numerics`` restores TF32 off afterwards."""
    precision = precision or JUDGE_PRECISION
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}")
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    torch.backends.cudnn.allow_tf32 = precision == "tf32"
    with torch.device(device):
        ref = ReferenceCodec(config["model"])
    W.load(ref, weights)
    ref.dtype = torch.float64 if precision == "float64" else torch.float32
    return ref.to(ref.dtype).eval()


def fp32_numerics() -> None:
    """TF32 off again, as the configurations state."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
