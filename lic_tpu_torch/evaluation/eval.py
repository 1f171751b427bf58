"""Evaluation harness (counterpart of ``lic_tpu/evaluation/eval.py``):
``eval_net.py``'s semantics with its defects fixed (SURVEY §8.3/8.9) — the
whole set is evaluated, padding is replicate, and bpp/PSNR are normalized
over the unpadded pixels.

It includes the reference's headline feature, content-adaptive encoding:
a per-image Adam overfit of the analysis transform g_a only
(``eval_net.py:118-199``).  The decoder and the entropy models stay as
they are, so the tuned image's bitstream decodes with the checkpoint's
decoder.

The model is an ``nn.Module`` that holds its parameters, so where the JAX
functions take ``(model, params, ...)`` these take ``(model, ...)``, and
``content_adaptive_finetune`` returns a tuned copy of the model where the
JAX one returns tuned parameters.  ``EvalConfig.rate`` picks a
variable-rate model's operating point, in the eval forward and in the
tune forward alike.  On a model with the HAN post-processing tail the
evaluation runs it, and the tune does not: its loss is taken on the
pre-HAN reconstruction (``use_post_processing=False``), as the
reference sets ``net.post_processing = False`` for the per-image overfit.
"""

from __future__ import annotations

import copy
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import EvalConfig
from ..data.datasets import list_images, load_image_uint8, normalize_pm1, to_batch
from ..data.pad import pad_to_multiple, unpad
from ..models.codec import CodecModel
from ..ops.rounding import NoiseFn, uniform_noise
from ..training.adam import Adam
from ..training.loss import ms_ssim
from ..training.schedule import multistep
from .metrics import mse_255, psnr_255

def _load_pm1(path: str, device) -> torch.Tensor:
    """An image file → (1, 3, H, W) in [−1, 1], channels_last on ``device``."""
    return to_batch(normalize_pm1(load_image_uint8(path))[None], device)


def evaluate_image(
    model: CodecModel, x_pm1: torch.Tensor, eval_cfg: EvalConfig = EvalConfig()
) -> Dict[str, float]:
    """Evaluate one (1, 3, H, W) [−1, 1] image on the model's device: pad
    → eval forward → metrics over the unpadded region, bpp renormalized to
    the true pixels.  ``seconds`` is the forward's wall time, fenced by
    ``torch.cuda.synchronize()`` on the card.  Nothing is compiled here,
    where the JAX package's first image of a shape includes its jit
    compile; but the first image of a size includes cuDNN's choice of
    algorithms and each B3/B6 weight's one-off TF32 split."""
    _, _, h, w = x_pm1.shape
    padded, orig = pad_to_multiple(x_pm1, eval_cfg.pad_multiple, mode="replicate")
    fence = torch.cuda.synchronize if padded.is_cuda else (lambda: None)
    with torch.no_grad():
        fence()
        t0 = time.perf_counter()
        out = model(padded, rate=eval_cfg.rate)
        fence()
        dt = time.perf_counter() - t0

        ph, pw = padded.shape[2], padded.shape[3]
        # the model's bpp is over the padded pixels; renormalize to the true ones
        scale = (ph * pw) / (h * w)
        bpp = float(out.bpp) * scale

        x_rec = torch.clamp(unpad(out.x_tilde, orig), -1.0, 1.0)
        v_mse = mse_255(x_pm1, x_rec)
        v_psnr = float(psnr_255(v_mse))
        v_msssim = float(ms_ssim((x_pm1 + 1) / 2, (x_rec + 1) / 2, data_range=1.0))
    return {
        "bpp": bpp,
        "psnr": v_psnr,
        "mse": float(torch.mean(v_mse)),
        "msssim": v_msssim,
        "seconds": dt,
        "pixels": h * w,
    }


def content_adaptive_finetune(
    model: CodecModel,
    x_pm1: torch.Tensor,
    eval_cfg: EvalConfig = EvalConfig(),
    *,
    noise_fn: Optional[NoiseFn] = None,
    on_phase: Optional[Callable[[str], None]] = None,
) -> CodecModel:
    """Per-image encoder overfit: ``tune_iters`` steps of Adam (optax's
    arithmetic, ``training.adam``) on the training-mode ``λ·255²·mse +
    bpp`` (``λ·mse + bpp`` under ``tune_loss_255sq=False``, the
    reference's literal loss, SURVEY defect §8.13) of the padded image,
    over g_a's parameters only; the rate is ``tune_lr``, times
    ``tune_lr_gamma`` from step ``tune_lr_drop_step`` on (optax's
    ``piecewise_constant_schedule``).

    The steps run on a copy of the model, which is returned: ``model``
    itself is left as it was, so the next image starts from the
    checkpoint's g_a, as each JAX image starts from ``params``.  In the
    copy every parameter outside g_a keeps its value bit for bit (JAX's
    ``multi_transform`` + ``set_to_zero``; here they take no gradient), and
    each parameter's ``requires_grad`` is the model's again on return.
    The copy's parameters are new tensors, so B3/B6 split their weights
    anew and the post-step hook of ``layers.conv_direct`` keeps the split
    current through the steps.

    The tune forward skips the HAN tail (``use_post_processing=False``).
    The likelihoods' noise comes from ``noise_fn`` (default: a
    ``torch.Generator`` on the image's device seeded 0; the JAX package
    draws from ``PRNGKey(0)``, so the bits differ).  ``on_phase(name)``,
    where given, is called at "start", "forward", "backward" and
    "optimizer" of each step, for timing."""
    padded, _ = pad_to_multiple(x_pm1, eval_cfg.pad_multiple, mode="replicate")
    tuned = copy.deepcopy(model)
    for name, p in tuned.named_parameters():
        p.requires_grad_(name.split(".", 1)[0] == "g_a")
    opt = Adam(tuned.g_a.parameters(), lr=eval_cfg.tune_lr)
    lr = multistep(eval_cfg.tune_lr, (eval_cfg.tune_lr_drop_step,), 1, eval_cfg.tune_lr_gamma)
    # train-consistent distortion weight by default; the literal reference
    # λ·mse only behind tune_loss_255sq=False
    d_scale = 255.0 ** 2 if eval_cfg.tune_loss_255sq else 1.0
    if noise_fn is None:
        noise_fn = uniform_noise(torch.Generator(device=padded.device).manual_seed(0))
    mark = on_phase or (lambda name: None)
    for step in range(eval_cfg.tune_iters):
        mark("start")
        opt.param_groups[0]["lr"] = lr(step)
        opt.zero_grad(set_to_none=True)
        out = tuned(padded, training=True, noise_fn=noise_fn, use_post_processing=False,
                    rate=eval_cfg.rate)
        loss = eval_cfg.lmbda * d_scale * out.mse + out.bpp
        mark("forward")
        loss.backward()
        mark("backward")
        opt.step()
        mark("optimizer")
    for p, q in zip(tuned.parameters(), model.parameters()):
        p.requires_grad_(q.requires_grad)
    return tuned


def evaluate_folder(
    model: CodecModel,
    data_path: str,
    eval_cfg: EvalConfig = EvalConfig(),
    pre_processing: bool = False,
    log_fn: Callable[[str], None] = print,
) -> Dict[str, float]:
    """Full-set evaluation (bpp / PSNR / MS-SSIM / wall-clock averages) of
    the images under ``data_path`` on the model's device; with
    ``pre_processing``, each image is evaluated with its own tuned g_a."""
    device = next(model.parameters()).device
    results: List[Dict[str, float]] = []
    for f in list_images(data_path):
        x = _load_pm1(f, device)
        m = content_adaptive_finetune(model, x, eval_cfg) if pre_processing else model
        r = evaluate_image(m, x, eval_cfg)
        results.append(r)
        log_fn(
            f"{f}: bpp={r['bpp']:.4f} psnr={r['psnr']:.2f} "
            f"msssim={r['msssim']:.4f} t={r['seconds']:.3f}s"
        )
    agg = {
        k: float(np.mean([r[k] for r in results]))
        for k in ("bpp", "psnr", "mse", "msssim", "seconds")
    }
    agg["images"] = len(results)
    log_fn(
        "AVG: bpp=%.4f psnr=%.2f msssim=%.4f t=%.3fs over %d images"
        % (agg["bpp"], agg["psnr"], agg["msssim"], agg["seconds"], agg["images"])
    )
    return agg
