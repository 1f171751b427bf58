"""Compress / decompress CLI — real bitstreams to and from ``.ltc`` files
(counterpart of ``lic_tpu/cli/codec.py``; the files are the JAX
package's, byte for byte).

    python -m lic_tpu_torch.cli.codec compress img.png out.ltc \\
        --weight_path ckpt/final.npz --preset net_ga
    python -m lic_tpu_torch.cli.codec decompress out.ltc rec.png \\
        --weight_path ckpt/final.npz --preset net_ga

Directory batch mode (input AND output are directories): images are
grouped by size and coded in chunks of at most ``--batch`` through
``compress_batch`` / ``decompress_batch`` (one image alone through
``compress`` / ``decompress``).  A stream decodes in any chunk, whatever
the batch it was encoded in.

Variable-rate presets (``source_net_vr``): ``--rate`` sets the coder's
gain-unit rate index (continuous: 1.5 interpolates units 1 and 2);
``--target_bpp`` solves each image's rate for that bitrate
(``serving.solve_rate_for_bpp``) and overrides ``--rate``.  The rate
rides each stream's header, so decompress needs neither flag.

Progressive streams (``.ltcp``, ChARM presets): ``--progressive`` codes
one file as a scalable trit-plane stream (``models.progressive``), whose
compress prints the bytes, bpp and every truncation point (planes → bpp);
its decompress takes at most ``--truncate_planes`` planes, slice-major
(all by default).  Progressive coding is single-file: a directory input
raises ``ValueError``.

``--post_processing`` builds the model with the HAN tail (the weights of a
phase-2 checkpoint); the coders' decodes then run it.

It runs on the card unless ``--device cpu`` is given.  PIL reads and
writes the files; ``compress_images`` and ``decompress_streams``, the
directory mode's core, take arrays and blobs.
"""

from __future__ import annotations

import argparse
import os
from collections import defaultdict
from typing import List, Optional, Sequence, Tuple

import numpy as np

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".ppm")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="lic_tpu_torch bitstream codec")
    p.add_argument("command", choices=("compress", "decompress"))
    p.add_argument("input", help="image/.ltc file, or a directory of them")
    p.add_argument("output", help="output file, or a directory (batch mode)")
    p.add_argument("--weight_path", required=True)
    p.add_argument("--preset", default="net_ga")
    p.add_argument("--high", action="store_true")
    p.add_argument("--post_processing", action="store_true",
                   help="build the model with the HAN post-processing tail "
                        "(required for phase-2 checkpoints)")
    p.add_argument("--batch", type=int, default=8,
                   help="max images per device batch in directory mode")
    p.add_argument("--rate", type=float, default=None,
                   help="gain-unit rate index (variable-rate presets; "
                        "continuous, e.g. 1.5 interpolates units 1 and 2)")
    p.add_argument("--target_bpp", type=float, default=None,
                   help="solve the gain-unit rate for this bitrate per "
                        "image (variable-rate presets; bisection on the "
                        "estimated bpp — overrides --rate)")
    p.add_argument("--progressive", action="store_true",
                   help="scalable trit-plane bitstream (ChARM presets, one "
                        "file): one stream decodes at every plane-boundary "
                        "truncation (lic_tpu_torch.models.progressive)")
    p.add_argument("--truncate_planes", type=int, default=None,
                   help="decompress using at most this many trit planes "
                        "(progressive streams; slice-major count)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="run on the card (default) or on the CPU")
    return p


def to_uint8(rec: np.ndarray) -> np.ndarray:
    """A [−1, 1] reconstruction → uint8 (the JAX CLI's conversion)."""
    return np.clip((rec + 1.0) * 127.5, 0, 255).astype(np.uint8)


def _chunks(items: list, batch: int):
    n = max(1, batch)
    for i in range(0, len(items), n):
        yield items[i : i + n]


def compress_images(coder, items: Sequence[Tuple[str, np.ndarray]],
                    batch: int, target_bpp: Optional[float] = None) -> List[Tuple[str, bytes]]:
    """Directory compress: ``items`` [(name, (H, W, 3) float32 in [−1, 1])]
    → [(name, blob)], grouped by size in order of first appearance, each
    group in chunks of at most ``batch``; with ``target_bpp``, each image
    at the rate solved for it."""
    from ..data.datasets import to_batch
    from ..serving import solve_rate_for_bpp

    buckets = defaultdict(list)
    for name, img in items:
        buckets[img.shape[:2]].append((name, img))
    out = []
    for group in buckets.values():
        for chunk in _chunks(group, batch):
            xs = to_batch(np.stack([img for _, img in chunk]), coder.device)
            rates = None
            if target_bpp is not None:
                rates = [solve_rate_for_bpp(coder.model, xs[k : k + 1], target_bpp)[0]
                         for k in range(len(chunk))]
            if len(chunk) > 1:
                blobs = coder.compress_batch(xs, rates=rates)
            else:
                blobs = [coder.compress(xs, rate=None if rates is None else rates[0])]
            out += [(name, blob) for (name, _), blob in zip(chunk, blobs)]
    return out


def decompress_streams(coder, items: Sequence[Tuple[str, bytes]],
                       batch: int) -> List[Tuple[str, np.ndarray]]:
    """Directory decompress: ``items`` [(name, blob)] → [(name, (H, W, 3)
    float32 reconstruction)], grouped by the size in each header, each
    group in chunks of at most ``batch``."""
    buckets = defaultdict(list)
    for name, blob in items:
        _, h, w, _ = coder._parse_header(blob)
        buckets[(h, w)].append((name, blob))
    out = []
    for group in buckets.values():
        for chunk in _chunks(group, batch):
            blobs = [blob for _, blob in chunk]
            recs = coder.decompress_batch(blobs) if len(chunk) > 1 else coder.decompress(blobs[0])
            recs = recs.permute(0, 2, 3, 1).cpu().numpy()
            out += [(name, rec) for (name, _), rec in zip(chunk, recs)]
    return out


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.progressive and os.path.isdir(args.input):
        raise ValueError("--progressive codes single files: a .ltcp stream has no "
                         "directory batch mode")

    from ..data.datasets import load_image_uint8, normalize_pm1, to_batch
    from ..models import build_model
    from ..models.compress import ChannelCoder
    from ..utils.checkpoint import load_params

    model = build_model(args.preset, device=args.device, is_high=args.high,
                        post_processing=args.post_processing)
    load_params(args.weight_path, model)
    if args.progressive:
        from ..models.progressive import ProgressiveCoder

        _run_progressive(args, ProgressiveCoder(model, name=args.preset))
        return
    coder = ChannelCoder(model, name=args.preset, rate=args.rate)

    if os.path.isdir(args.input):
        _run_dir(args, coder)
        return
    if args.command == "compress":
        img = normalize_pm1(load_image_uint8(args.input))
        x = to_batch(img[None], coder.device)
        rate = None
        if args.target_bpp is not None:
            from ..serving import solve_rate_for_bpp

            rate, est = solve_rate_for_bpp(model, x, args.target_bpp)
            print(f"target {args.target_bpp} bpp → rate {rate:.3f} "
                  f"(estimated {est:.4f} bpp)")
        blob = coder.compress(x, rate=rate)  # pads to /64 inside
        with open(args.output, "wb") as fd:
            fd.write(blob)
        h, w = img.shape[:2]
        print(f"{args.input} → {args.output}: {len(blob)} bytes "
              f"({len(blob) * 8 / (h * w):.4f} bpp)")
    else:
        from PIL import Image

        with open(args.input, "rb") as fd:
            blob = fd.read()
        img = to_uint8(coder.decompress(blob)[0].permute(1, 2, 0).cpu().numpy())
        Image.fromarray(img).save(args.output)
        print(f"{args.input} → {args.output}: {img.shape[1]}x{img.shape[0]}")


def _run_progressive(args, coder) -> None:
    """Single-file progressive compress / decompress (``.ltcp``)."""
    from ..data.datasets import load_image_uint8, normalize_pm1, to_batch

    if args.command == "compress":
        img = normalize_pm1(load_image_uint8(args.input))
        blob = coder.compress(to_batch(img[None], coder.device))
        with open(args.output, "wb") as fd:
            fd.write(blob)
        h, w = img.shape[:2]
        pts = coder.truncation_points(blob)
        print(f"{args.input} → {args.output}: {len(blob)} bytes "
              f"({len(blob) * 8 / (h * w):.4f} bpp), {pts[-1][0]} planes; "
              "truncation points (planes → bpp): "
              + ", ".join(f"{p}→{b * 8 / (h * w):.3f}" for p, b in pts))
    else:
        from PIL import Image

        with open(args.input, "rb") as fd:
            blob = fd.read()
        rec = coder.decompress(blob, max_planes=args.truncate_planes)
        img = to_uint8(rec[0].permute(1, 2, 0).cpu().numpy())
        Image.fromarray(img).save(args.output)
        tag = ("" if args.truncate_planes is None
               else f" (truncated to {args.truncate_planes} planes)")
        print(f"{args.input} → {args.output}: {img.shape[1]}x{img.shape[0]}{tag}")


def _run_dir(args, coder) -> None:
    """Directory batch mode: files in, files out."""
    from ..data.datasets import load_image_uint8, normalize_pm1

    os.makedirs(args.output, exist_ok=True)
    if args.command == "compress":
        names = sorted(n for n in os.listdir(args.input) if n.lower().endswith(IMAGE_EXTS))
        items = [(n, normalize_pm1(load_image_uint8(os.path.join(args.input, n))))
                 for n in names]
        sizes = {n: img.shape[0] * img.shape[1] for n, img in items}
        total_bits = total_px = 0
        for n, blob in compress_images(coder, items, args.batch, args.target_bpp):
            out = os.path.join(args.output, os.path.splitext(n)[0] + ".ltc")
            with open(out, "wb") as fd:
                fd.write(blob)
            total_bits += len(blob) * 8
            total_px += sizes[n]
            print(f"{n} → {out}: {len(blob)} bytes ({len(blob) * 8 / sizes[n]:.4f} bpp)")
        if total_px:
            print(f"avg: {total_bits / total_px:.4f} bpp over {len(names)} files")
    else:
        from PIL import Image

        names = sorted(n for n in os.listdir(args.input) if n.lower().endswith(".ltc"))
        items = []
        for n in names:
            with open(os.path.join(args.input, n), "rb") as fd:
                items.append((n, fd.read()))
        for n, rec in decompress_streams(coder, items, args.batch):
            img = to_uint8(rec)
            out = os.path.join(args.output, os.path.splitext(n)[0] + ".png")
            Image.fromarray(img).save(out)
            print(f"{n} → {out}: {img.shape[1]}x{img.shape[0]}")


if __name__ == "__main__":
    main()
