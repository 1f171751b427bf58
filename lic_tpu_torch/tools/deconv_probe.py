"""Probe of the transposed convolutions of g_s and h_s on one GPU.

    python -m lic_tpu_torch.tools.deconv_probe            # B=8, full size
    python -m lic_tpu_torch.tools.deconv_probe --device cpu   # tiny, no times

For each deconv shape of ``source_net`` at B=8, 512×768, fp32 without TF32,
it times ``F.conv_transpose2d`` with ``cudnn.deterministic`` on and off (and
whether two calls on one input are bit-identical), and a sub-pixel lowering
— the s×s output phases as one stride-1 convolution with C_out·s² output
channels, then a pixel shuffle — with its largest difference from the
deconv.  Each in ``channels_last`` and in NCHW memory.  Times are CUDA
events over 10 calls after one warm-up.
"""

from __future__ import annotations

import argparse
import subprocess
from typing import Tuple

import torch
import torch.nn.functional as F


def subpel_weights(
    w: torch.Tensor, stride: int, padding: int
) -> Tuple[torch.Tensor, int, int]:
    """ConvTranspose2d weight (C_in, C_out, k, k) → (weight of a stride-1
    convolution over the input, (C_out·s², C_in, T, T), output channels
    ordered (c, phase_h, phase_w) for ``pixel_shuffle``; the input offset
    of its first tap; T)."""
    k, s = w.shape[2], stride
    lead = k - 1 - padding
    wf = w.flip(2, 3).permute(1, 0, 2, 3)  # the correlation kernel
    taps = {}  # phase → [(kernel tap, input offset)]
    for r in range(s):
        for j in range(k):
            if (r + j - lead) % s == 0:
                taps.setdefault(r, []).append((j, (r + j - lead) // s))
    offsets = [d for r in taps for _, d in taps[r]]
    dmin, T = min(offsets), max(offsets) - min(offsets) + 1
    cout, cin = wf.shape[:2]
    wc = w.new_zeros(s, s, cout, cin, T, T)
    for rh in range(s):
        for jh, dh in taps[rh]:
            for rw in range(s):
                for jw, dw in taps[rw]:
                    wc[rh, rw, :, :, dh - dmin, dw - dmin] = wf[:, :, jh, jw]
    return wc.permute(2, 0, 1, 3, 4, 5).reshape(cout * s * s, cin, T, T), dmin, T


def subpel_conv_transpose2d(
    x: torch.Tensor, wc: torch.Tensor, bias: torch.Tensor, dmin: int, T: int,
    stride: int, out_hw: Tuple[int, int],
) -> torch.Tensor:
    """The deconv through ``subpel_weights``' convolution and a pixel
    shuffle; ``out_hw`` is the deconv's output size."""
    h, w = x.shape[2:]
    mh, mw = out_hw[0] // stride, out_hw[1] // stride
    right = max(0, mw + T - 1 + dmin - w)
    bottom = max(0, mh + T - 1 + dmin - h)
    xp = F.pad(x, (-dmin, right, -dmin, bottom))
    y = F.conv2d(xp, wc)[:, :, :mh, :mw]
    return F.pixel_shuffle(y, stride) + bias[None, :, None, None]


def _cuda_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    full = dev.type == "cuda"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    if full:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout.strip())
    # (name, C_in, C_out, input H, W, padding); g_s inputs carry their
    # (1,0,1,0) pad
    shapes = [
        ("g_s.up2 192->192 out 256x384", 192, 192, 129, 193, 3),
        ("g_s.up3 192->16 out 512x768", 192, 16, 257, 385, 3),
        ("h_s.d0 192->192 out 16x24", 192, 192, 8, 12, 2),
    ] if full else [
        ("up 8->8", 8, 8, 17, 25, 3), ("up 8->4", 8, 4, 9, 13, 2),
    ]
    batch = 8 if full else 1
    for name, cin, cout, h, w, pad in shapes:
        g = torch.Generator().manual_seed(0)
        x0 = torch.randn(batch, cin, h, w, generator=g)
        wt = (torch.randn(cin, cout, 5, 5, generator=g) * 0.05).to(dev)
        b = torch.randn(cout, generator=g).to(dev)
        for fmt_name, fmt in (("channels_last", torch.channels_last),
                              ("nchw", torch.contiguous_format)):
            x = x0.to(dev).contiguous(memory_format=fmt)
            for det in (True, False):
                torch.backends.cudnn.deterministic = det
                f = lambda: F.conv_transpose2d(x, wt, b, 2, pad, 1)
                same = bool(torch.equal(f(), f()))
                t = f"{_cuda_ms(f):.3f} ms" if full else "not timed"
                print(f"{name:30s} {fmt_name:13s} deterministic={det!s:5s} "
                      f"conv_transpose2d {t}  repeat_bitexact={same}")
            torch.backends.cudnn.deterministic = True
            ref = F.conv_transpose2d(x, wt, b, 2, pad, 1)
            wc, dmin, T = subpel_weights(wt, 2, pad)
            wc = wc.contiguous(memory_format=fmt)
            f = lambda: subpel_conv_transpose2d(x, wc, b, dmin, T, 2, ref.shape[2:])
            err = float((f() - ref).abs().max())
            t = f"{_cuda_ms(f):.3f} ms" if full else "not timed"
            print(f"{name:30s} {fmt_name:13s} deterministic=True  "
                  f"subpel conv+shuffle {t}  max_abs_err_vs_deconv={err:.3g}")


if __name__ == "__main__":
    main()
