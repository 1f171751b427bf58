"""Traffic kind ``code_batch``: a folder coded and decoded, batch by batch.

The codec CLI's directory mode: ``ChannelCoder.compress_batch`` then
``decompress_batch`` on batches of ``batch`` seeded smooth images of
``size``, cycling through a pool of ``pool`` batches made at set-up.
Parameters (the mix file): ``batch``, ``size`` [H, W], ``pool``,
``checked`` (how many of the pool's batches the reference checks: drawn
from the seed, each judged on its last decode in the window, image by
image, as ``benchmark.compare`` says, and by the reference class's own
numbers where it adds some).

End to end: ``codec_mps``, the megapixels of the images whose compress and
decode both finished, over the seconds from the window's start to the end
of its last roundtrip (no roundtrip starts after ``--seconds``).  The
streams' bits per pixel over the window are printed as a reading: they
are the host coder's load.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import compare, system
from ..images import smooth_images


def run(ctx):
    from lic_tpu_torch.models.compress import ChannelCoder, set_numerics_flags

    p, dev, rec = ctx.traffic, ctx.device, ctx.record
    b, (h, w) = int(p["batch"]), p["size"]
    set_numerics_flags()
    weights = system.make_weights(ctx.config, ctx.seed, dev)
    model = system.build_program(ctx.config, weights, dev)
    coder = ChannelCoder(model, name=ctx.config["preset"])
    pool, checked = inputs(p, ctx.seed, dev)

    def roundtrip(x):
        blobs = coder.compress_batch(x)
        out = coder.decompress_batch(blobs)
        torch.cuda.synchronize()
        return out, sum(map(len, blobs))

    failed = []

    for x in pool[:2]:  # the first builds the kernels and picks cuDNN's algorithms
        roundtrip(x)
    rec.host(coder, "compress_batch", "compress_batch", sync=True)
    rec.host(coder, "decompress_batch", "decompress_batch", sync=True)
    rec.host(coder, "_pool_map", "host_coding")
    hyper_coder = getattr(coder, "z_coder", None)  # the z stream's coder, where it has one
    if hyper_coder is not None:
        rec.host(hyper_coder, "decode_symbols", "z_decode")
    rec.cuda(model, "analyze", "analyze")
    rec.cuda(model, "synthesize", "synthesize")
    torch.cuda.reset_peak_memory_stats()
    ctx.window_start()

    last = {}
    n = nbytes = 0
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds
    while time.perf_counter() < deadline:
        i = n % len(pool)
        try:
            out, size = roundtrip(pool[i])
        except ValueError:  # a stream that does not decode: its images failed
            failed.append(i)
            last.pop(i, None)
        else:
            nbytes += size
            if i in checked:
                last[i] = out
        n += 1
    window_s = time.perf_counter() - t0
    if ctx.trace:
        rec.recording = False
        ctx.profile(lambda: [roundtrip(pool[k % len(pool)]) for k in range(int(p["traced"]))])
    rec.collect()
    memory = torch.cuda.max_memory_allocated()

    images = n * b
    mp = (n - len(failed)) * b * h * w / 1e6
    rec.values.update(window_s=window_s, passes=n, mp_per_batch=b * h * w / 1e6)
    if ctx.trace:
        rec.values.update(system.reference_meta(ctx.config).counts(b, h, w))

    decoded = {i: last[i].cpu() for i in checked if i in last}
    del model, last
    torch.cuda.empty_cache()
    found = judge(ctx.config, weights, pool, checked, decoded, dev, coder)
    del coder
    if failed:  # an answer that never came
        found = {k: float("inf") for k in found}
    limits = ctx.config["limits"]
    ctx.extra.update({k: v for k, v in found.items() if k not in compare.names(limits)},
                     bpp=8 * nbytes / max(mp * 1e6, 1))
    checks = compare.checks(found, limits)
    return {"attempted": images, "failed": len(failed) * b, "memory_peak_bytes": memory,
            "e2e": {"codec_mps": mp / window_s}, "checks": checks}


def inputs(p: dict, seed: int, device):
    """The pool of batches, and the indices of those the reference checks,
    from the seed."""
    rng = np.random.default_rng(seed)
    b, (h, w) = int(p["batch"]), p["size"]
    pool = [smooth_images(rng, b, h, w, device) for _ in range(int(p["pool"]))]
    checked = sorted(rng.choice(len(pool), int(p["checked"]), replace=False).tolist())
    return pool, checked


def judge(config, weights, pool, checked, decoded, device, side=None) -> dict:
    """The worst checked image's numbers against the reference's eval
    forward in float64 (``compare``), and the worst checked batch's value
    of each number the reference class's ``compared`` adds, given ``side``
    (the program's coder, or in the controls the reference put in its
    place); infinity where a checked batch has no decode."""
    ref = system.build_reference(config, weights, device)
    own = getattr(ref, "compared", None) if side is not None else None
    readings, added = [], []
    with torch.no_grad():
        for i in checked:
            if i not in decoded:
                readings = added = []
                break
            want = ref(pool[i].to(ref.dtype))["x_hat"].cpu()
            readings.append(compare.image_readings(decoded[i], want))
            if own is not None:
                added.append(own(side, pool[i], decoded[i]))
    del ref
    torch.cuda.empty_cache()
    system.fp32_numerics()
    found = compare.worst(readings)
    found.update({k: max(a[k] for a in added) for k in (added[0] if added else ())})
    return found
