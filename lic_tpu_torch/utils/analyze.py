"""Offline analysis and visualisation (counterpart of
``lic_tpu/utils/analyze.py``), on NCHW tensors.

* ``analyze_data`` — min / max / mean / std and a 10-bin histogram of |x|,
  printed and returned (``model/Net_unet.py:62-70``).
* ``effective_receptive_field(fn, x)`` — |∂(Σ of the central feature over
  batch and channels)/∂x| summed over batch and channels, (H, W), by
  ``torch.autograd.grad``; ``erf_heatmap`` its log1p + 99.9%-quantile
  rendering in [0, 1] (``model/analyze.py``).
* ``feature_map_stats`` — per-channel mean and std; ``dump_feature_maps``
  / ``dump_feature_heatmaps`` — per-channel PNGs of (1, C, H, W) features
  (``model/visual_Feature*.py``, without their fixed output paths).  Each
  dump writes nothing and returns 0 where PIL (maps) or matplotlib
  (heatmaps; seaborn where present) cannot be imported.
"""

from __future__ import annotations

import os
from typing import Callable

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def analyze_data(x, name: str = "tensor", log_fn=print) -> dict:
    x = _np(x)
    stats = {"min": float(x.min()), "max": float(x.max()), "mean": float(x.mean()),
             "std": float(x.std()), "hist": np.histogram(np.abs(x), bins=10)[0].tolist()}
    log_fn(f"{name}: min={stats['min']:.4f} max={stats['max']:.4f} "
           f"mean={stats['mean']:.4f} std={stats['std']:.4f} |hist|={stats['hist']}")
    return stats


def effective_receptive_field(fn: Callable[[torch.Tensor], torch.Tensor],
                              x: torch.Tensor) -> np.ndarray:
    """ERF score matrix (H, W) of ``fn``: (B, C, H, W) → (B, c, h, w)."""
    x = x.detach().requires_grad_(True)
    with torch.enable_grad():
        feats = fn(x)
        ch, cw = feats.shape[2] // 2, feats.shape[3] // 2
        (g,) = torch.autograd.grad(feats[:, :, ch, cw].sum(), x)
    return np.abs(_np(g)).sum(axis=(0, 1))


def erf_heatmap(score: np.ndarray) -> np.ndarray:
    s = np.log1p(np.maximum(score, 0.0))
    hi = np.quantile(s, 0.999)
    return np.clip(s / max(hi, 1e-12), 0.0, 1.0)


def feature_map_stats(feats) -> dict:
    f = _np(feats)
    axes = (0,) + tuple(range(2, f.ndim))
    return {"shape": tuple(f.shape), "per_channel_mean": f.mean(axis=axes).tolist(),
            "per_channel_std": f.std(axis=axes).tolist()}


def dump_feature_maps(feats, out_dir: str, prefix: str = "feat", max_channels: int = 64) -> int:
    """One min-max-scaled grayscale PNG per channel of (1, C, H, W)
    features; → the number of files written."""
    try:
        from PIL import Image
    except Exception:
        return 0
    os.makedirs(out_dir, exist_ok=True)
    f = _np(feats)[0]
    n = min(f.shape[0], max_channels)
    for c in range(n):
        ch = f[c]
        lo, hi = ch.min(), ch.max()
        img = ((ch - lo) / max(hi - lo, 1e-12) * 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(out_dir, f"{prefix}_{c}.png"))
    return n


def dump_feature_heatmaps(feats, out_dir: str, prefix: str = "feat", max_channels: int = 16,
                          cmap: str = "jet", annot_grid: bool = False) -> int:
    """A colour-mapped heatmap per channel of (1, C, H, W) features (seaborn
    where importable, else matplotlib), and with ``annot_grid`` one figure
    tiling them; → the number of files written."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return 0
    try:
        import seaborn as sns
    except Exception:
        sns = None
    os.makedirs(out_dir, exist_ok=True)
    f = _np(feats)[0]
    n = min(f.shape[0], max_channels)
    for c in range(n):
        fig, ax = plt.subplots(figsize=(4, 3))
        if sns is not None:
            sns.heatmap(f[c], cmap=cmap, cbar=True, xticklabels=False, yticklabels=False, ax=ax)
        else:
            fig.colorbar(ax.imshow(f[c], cmap=cmap), ax=ax)
            ax.set_xticks([])
            ax.set_yticks([])
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, f"{prefix}_{c}_heat.png"), dpi=96)
        plt.close(fig)
    written = n
    if annot_grid and n:
        cols = int(np.ceil(np.sqrt(n)))
        rows = -(-n // cols)
        fig, axes = plt.subplots(rows, cols, figsize=(2.2 * cols, 1.8 * rows), squeeze=False)
        for c in range(rows * cols):
            ax = axes[c // cols][c % cols]
            if c < n:
                ax.imshow(f[c], cmap=cmap)
            ax.axis("off")
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, f"{prefix}_grid.png"), dpi=96)
        plt.close(fig)
        written += 1
    return written
