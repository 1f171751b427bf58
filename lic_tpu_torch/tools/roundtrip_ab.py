"""Eval-forward and roundtrip times of the port, alone or beside another
checkout's, on one GPU.

    python -m lic_tpu_torch.tools.roundtrip_ab [--base DIR] [--pairs 2] [--preset source_net ...] [--reps 7] [--batch 8]

Each run is a process of its own that imports ``lic_tpu_torch`` from one
checkout's root, builds each preset at full width (seed 0, a batch of ``--batch`` (8)
smooth synthetic 512×768 images, fp32 with the coder's numerics flags)
and, after one warm-up of each, times ``--reps`` eval forwards (CUDA
events) and ``--reps`` roundtrips ``compress_batch`` → ``decompress_batch``
(host clock, the device synchronised before and after).  With ``--base``,
the root of another checkout (for instance the parent commit unpacked by
``git archive`` into ``build/``), ``--pairs`` pairs of runs go on the same
card, alternating which side runs first (base, this, this, base, ...),
and each checkout builds its kernels into its own ``build/``.

It prints the card (``nvidia-smi``), one JSON line per run and preset with
every repetition and the stream's bpp (equal bpp: both checkouts coded the
same symbols), then per preset and metric each checkout's median over all
its repetitions, the quartiles of its runs' medians, and in how many pairs
this checkout's run median was the lower.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

THIS_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _run(presets, reps: int, batch: int) -> None:
    """One checkout's run: ``lic_tpu_torch`` is whichever the path finds."""
    import numpy as np
    import torch

    from lic_tpu_torch.data import smooth_images
    from lic_tpu_torch.models import build_model
    from lic_tpu_torch.models.compress import ChannelCoder, set_numerics_flags

    set_numerics_flags()
    x = torch.from_numpy(smooth_images(np.random.default_rng(0), batch, 512, 768))
    x = x.cuda().contiguous(memory_format=torch.channels_last)
    for preset in presets:
        model = build_model(preset, device="cuda", seed=0)
        coder = ChannelCoder(model, name=preset)
        with torch.no_grad():
            model(x)
        blobs = coder.compress_batch(x)
        coder.decompress_batch(blobs)
        fwd_ms, rt_s = [], []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with torch.no_grad():
                start.record()
                model(x)
                end.record()
            torch.cuda.synchronize()
            fwd_ms.append(start.elapsed_time(end))
        for _ in range(reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            coder.decompress_batch(coder.compress_batch(x))
            torch.cuda.synchronize()
            rt_s.append(time.perf_counter() - t)
        bpp = sum(len(b) for b in blobs) * 8 / x[:, 0].numel()
        print(json.dumps({"preset": preset, "forward_ms": fwd_ms, "roundtrip_s": rt_s,
                          "bpp": bpp}), flush=True)
        del model, coder
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", help="root of another checkout to time beside this one")
    ap.add_argument("--pairs", type=int, default=2, help="pairs of runs with --base")
    ap.add_argument("--preset", nargs="+", default=["source_net", "source_net_wam"])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--batch", type=int, default=8, help="images per batch")
    ap.add_argument("--one-run", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one_run:
        _run(args.preset, args.reps, args.batch)
        return
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip())
    roots = {"this": THIS_ROOT}
    order = ["this"]
    if args.base:
        roots["base"] = os.path.abspath(args.base)
        order = [name for i in range(args.pairs)
                 for name in (("base", "this") if i % 2 == 0 else ("this", "base"))]
    runs = []  # (checkout, preset, metric, repetitions), in run order
    for name in order:
        root = roots[name]
        env = dict(os.environ, PYTHONPATH=root)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one-run", "--reps", str(args.reps),
             "--batch", str(args.batch), "--preset", *args.preset],
            cwd=root, env=env, check=True, capture_output=True, text=True, timeout=1800,
        )
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                row = json.loads(line)
                print(json.dumps({"checkout": name, **row}), flush=True)
                runs += [(name, row["preset"], key, row[key]) for key in ("forward_ms", "roundtrip_s")]
    for preset in args.preset:
        for key in ("forward_ms", "roundtrip_s"):
            med = {name: [statistics.median(v) for n, p, k, v in runs
                          if (n, p, k) == (name, preset, key)] for name in roots}
            for name in roots:
                reps = [x for n, p, k, v in runs if (n, p, k) == (name, preset, key) for x in v]
                q = statistics.quantiles(med[name], n=4) if len(med[name]) > 1 else med[name] * 3
                print(f"MEDIAN {name:4s} {preset:20s} {key:12s} {statistics.median(reps):.6f} "
                      f"(run medians: quartiles {q[0]:.6f} {q[2]:.6f}, n {len(med[name])})")
            if "base" in med:
                wins = sum(t < b for t, b in zip(med["this"], med["base"]))
                print(f"PAIRS {preset:20s} {key:12s} this lower in {wins} of {len(med['base'])}")

if __name__ == "__main__":
    main()
