"""Where the time of the port's main path goes, on one GPU.

    python -m lic_tpu_torch.tools.profile_path [--out build/profile]

``source_net`` at full width, random weights from ``--seed``, a batch of
``--batch`` smooth synthetic images of ``--height`` × ``--width``, fp32
with the coder's numerics flags.  It prints:

* the card: name, power limit and maximum SM clock from ``nvidia-smi``;
* ``STAGE`` / ``LAYER`` lines: CUDA-event milliseconds of each stage of the
  eval forward and of each layer of g_a and g_s;
* for the eval forward and for the roundtrip ``compress_batch`` →
  ``decompress_batch``, each under ``torch.profiler``: the kernels with the
  most device time, and the device busy share — the union of the intervals
  in which a kernel, copy or memset ran on the card, over the host wall
  time of the profiled region (and over the span from the first device
  activity to the last);
* ``PHASES``: host-clock seconds of the roundtrip's phases, unprofiled.

The Chrome traces go to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from collections import defaultdict
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def device_activity(trace_events: List[dict]) -> Dict[str, object]:
    """From Chrome-trace events: the device's busy microseconds (union of
    kernel, copy and memset intervals), the span from the first device
    activity to the last, and the kernel time by name."""
    spans, by_name = [], defaultdict(lambda: [0.0, 0])
    for ev in trace_events:
        if ev.get("ph") != "X" or str(ev.get("cat", "")).lower() not in DEVICE_CATS:
            continue
        s, d = float(ev["ts"]), float(ev.get("dur", 0.0))
        spans.append((s, s + d))
        if str(ev["cat"]).lower() == "kernel":
            by_name[ev["name"]][0] += d
            by_name[ev["name"]][1] += 1
    if not spans:
        raise RuntimeError("the trace holds no device activity")
    return {
        "busy_us": union_length(spans),
        "span_us": max(e for _, e in spans) - min(s for s, _ in spans),
        "kernels": sorted(by_name.items(), key=lambda kv: -kv[1][0]),
    }


def _sync() -> None:
    torch.cuda.synchronize()


def _cuda_ms(fn, reps: int = 5) -> float:
    fn()
    _sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    _sync()
    return start.elapsed_time(end) / reps


def _profiled(label: str, fn, iters: int, out_dir: str, top: int) -> None:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        _sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    path = os.path.join(out_dir, f"{label}.trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        act = device_activity(json.load(f)["traceEvents"])
    kernel_us = sum(t for _, (t, _) in act["kernels"])
    print(f"{label.upper()} x{iters}: wall/iter {wall_us / iters / 1e3:.3f} ms, "
          f"device busy/iter {act['busy_us'] / iters / 1e3:.3f} ms, "
          f"kernel sum/iter {kernel_us / iters / 1e3:.3f} ms, "
          f"busy share of wall {act['busy_us'] / wall_us:.4f}, "
          f"of device span {act['busy_us'] / act['span_us']:.4f}")
    for name, (t, n) in act["kernels"][:top]:
        print(f"  {t / iters / 1e3:9.3f} ms/iter {100 * t / kernel_us:5.1f}%  "
              f"x{n // iters:<4d} {name[:100]}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=768)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join("build", "profile"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_path needs a CUDA device")

    from ..data import smooth_images
    from ..models import build_model
    from ..models.compress import ChannelCoder, set_numerics_flags

    os.makedirs(args.out, exist_ok=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip())
    set_numerics_flags()
    dev = torch.device("cuda")
    model = build_model("source_net", device=dev, seed=args.seed)
    x = torch.from_numpy(smooth_images(
        np.random.default_rng(args.seed), args.batch, args.height, args.width,
    )).to(dev).contiguous(memory_format=torch.channels_last)
    coder = ChannelCoder(model, name="source_net")

    with torch.no_grad():
        for _ in range(2):
            model(x)
        out = model(x)
        coder.decompress_batch(coder.compress_batch(x))
        _sync()
        y_hat = out.extras["y_hat"]
        z3 = model.analyze(x)
        med = model.eb_medians()[None, :, None, None]
        z_hat = torch.round(model.hyper_encode(z3) - med) + med
        syn = model.syntax_from_latent(z3)
        stages = {
            "forward": lambda: model(x),
            "g_a": lambda: model.analyze(x),
            "h_a": lambda: model.hyper_encode(z3),
            "h_s (both)": lambda: model.hyper_decode(z_hat),
            "g_s": lambda: model.g_s(y_hat),
            "synthesize": lambda: model.synthesize(y_hat, syn),
        }
        for name, fn in stages.items():
            print(f"STAGE {name:12s} {_cuda_ms(fn):9.3f} ms")
        for tname, inp in (("g_a", x), ("g_s", y_hat)):
            h = inp
            for cname, child in getattr(model, tname).named_children():
                t = _cuda_ms(lambda: child(h))
                h = child(h)
                print(f"LAYER {tname}.{cname:8s} out={tuple(h.shape)} {t:9.3f} ms")

        _profiled("forward", lambda: model(x), 3, args.out, top=15)
    _profiled("roundtrip", lambda: coder.decompress_batch(coder.compress_batch(x)),
              1, args.out, top=15)

    phases = {}
    for _ in range(2):  # the second pass is reported
        with torch.no_grad():
            t = time.perf_counter()
            z3 = model.analyze(x)
            _sync()
            phases["encode g_a"] = time.perf_counter() - t
            t = time.perf_counter()
            _, z_hat = coder._z_enc(z3)
            model.syntax_from_latent(z3)
            _sync()
            phases["encode hyper+syntax"] = time.perf_counter() - t
            t = time.perf_counter()
            coder._slices_pass(z_hat, y=z3)
            _sync()
            phases["encode slice chain"] = time.perf_counter() - t
        t = time.perf_counter()
        blobs = coder.compress_batch(x)
        _sync()
        phases["compress_batch"] = time.perf_counter() - t
        t = time.perf_counter()
        coder.decompress_batch(blobs)
        _sync()
        phases["decompress_batch"] = time.perf_counter() - t
    print("PHASES (s)", json.dumps(phases))
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


if __name__ == "__main__":
    main()
