"""The system under test, built from a configuration file.

The program is ``lic_tpu_torch``: its ``build_model`` builds the preset
the file names (the program's own initialisation on the CPU, then moved
to the card), and the benchmark's weights from the run's seed replace
every leaf.  The file's ``model`` entry is checked against the program's
configuration, so that the reference and the program run the same model.

The reference is the class the file's ``reference`` names,
``"<module>:<class>"``: a module of ``benchmark/reference/`` and a class
in it, built from the file's ``model``.  The class carries what is
particular to its model: ``UNMODELLED`` (program features it does not
model), the weight declarations ``benchmark.weights`` reads, ``counts``
(operations and bytes of the coder's passes) and, optionally,
``compared(side, x, decoded)``, numbers of its own that ``correct``
compares beside the images (``benchmark.compare``).
"""

from __future__ import annotations

import importlib
from typing import Dict

import torch
from torch import nn

from . import weights as W


def reference_class(config: Dict) -> type:
    """The class the file's ``reference`` names, imported from its module
    of ``benchmark/reference/`` (one module object per process, so a class
    there may subclass another's)."""
    module, _, name = config["reference"].partition(":")
    if not (module.isidentifier() and name.isidentifier()):
        raise ValueError(f"reference {config['reference']!r}: want '<module>:<class>'")
    return getattr(importlib.import_module(f"{__package__}.reference.{module}"), name)


def reference_meta(config: Dict) -> nn.Module:
    """The reference's structure on the ``meta`` device (no memory)."""
    with torch.device("meta"):
        return reference_class(config)(config["model"])


def make_weights(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return W.make_weights(reference_meta(config), seed, device, config["latent_gain"])


def build_program(config: Dict, weights: Dict[str, torch.Tensor], device):
    """The program's model of the configuration on ``device``, holding
    ``weights``; every key of the file's ``model`` has to equal the
    program's configuration field of that name, the program may have none
    of the features the reference class does not model, and every leaf of
    the model has to take a weight."""
    from lic_tpu_torch.models import build_model

    model = build_model(config["preset"], device=device)
    cfg, absent = model.cfg, object()
    wrong = {k: (getattr(cfg, k, absent), v) for k, v in config["model"].items()
             if getattr(cfg, k, absent) != v}
    unmodelled = {k: getattr(cfg, k) for k, on in reference_class(config).UNMODELLED.items()
                  if bool(getattr(cfg, k)) == on}
    if wrong or unmodelled:
        raise ValueError(f"{config['preset']}: the program's configuration differs from the "
                         f"file's: {wrong}; features the reference does not model: {unmodelled}")
    untouched = sorted(set(n for n, _ in model.named_parameters()) - set(weights))
    if untouched:
        raise ValueError(f"{config['preset']}: leaves the benchmark does not set: {untouched[:5]}")
    W.load(model, weights)
    return model


PRECISIONS = ("float64", "float32", "tf32")
# the precision the checks judge by
JUDGE_PRECISION = "float64"


def build_reference(config: Dict, weights: Dict[str, torch.Tensor], device,
                    precision: str = "") -> nn.Module:
    """The reference on ``device`` holding ``weights``: in float64 (what
    the checks judge by), in fp32, or in fp32 whose products round their
    inputs to TF32 (the control: the configurations state fp32 with TF32
    off); by default ``JUDGE_PRECISION``.  Feed it inputs of its dtype
    (``ref.dtype``); ``fp32_numerics`` restores TF32 off afterwards.
    TF32 rounds fp32 products only, so a float64 reference leaves the
    flags as they are: a control judged beside it keeps its TF32."""
    precision = precision or JUDGE_PRECISION
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}")
    if precision != "float64":
        torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
        torch.backends.cudnn.allow_tf32 = precision == "tf32"
    with torch.device(device):
        ref = reference_class(config)(config["model"])
    W.load(ref, weights)
    ref.dtype = torch.float64 if precision == "float64" else torch.float32
    return ref.to(ref.dtype).eval()


def fp32_numerics() -> None:
    """TF32 off again, as the configurations state."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
