"""Traffic kind ``code_batch``: a folder coded and decoded, batch by batch.

The codec CLI's directory mode: ``ChannelCoder.compress_batch`` then
``decompress_batch`` on batches of ``batch`` seeded smooth images of
``size``, cycling through a pool of ``pool`` batches made at set-up.
Parameters (the mix file): ``batch``, ``size`` [H, W], ``pool``,
``checked`` (how many of the pool's batches the reference checks: drawn
from the seed, each judged on its last decode in the window, image by
image, as ``benchmark.compare`` says).

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

from .. import compare, roofline, system
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
    rec.host(coder.z_coder, "decode_symbols", "z_decode")
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
        _count(ctx, b, h, w)

    decoded = {i: last[i].cpu() for i in checked if i in last}
    del coder, model, last
    torch.cuda.empty_cache()
    found = judge(ctx.config, weights, pool, checked, decoded, dev)
    if failed:  # an answer that never came
        found = {k: float("inf") for k in found}
    ctx.extra.update({k: found[k] for k in compare.READINGS}, bpp=8 * nbytes / max(mp * 1e6, 1))
    checks = compare.checks(found, ctx.config["limits"])
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


def judge(config, weights, pool, checked, decoded, device) -> dict:
    """The worst checked image's numbers against the reference's eval
    forward in float64 (``compare``); infinity where a checked batch has no
    decode."""
    ref = system.build_reference(config, weights, device)
    readings = []
    with torch.no_grad():
        for i in checked:
            if i not in decoded:
                readings = []
                break
            want = ref(pool[i].to(ref.dtype))["x_hat"].cpu()
            readings.append(compare.image_readings(decoded[i], want))
    del ref
    torch.cuda.empty_cache()
    system.fp32_numerics()
    return compare.worst(readings)


def _count(ctx, b, h, w) -> None:
    """Operations and bytes of the coder's passes, on the reference at the
    window's shapes (``meta`` device)."""
    ref = system.reference_meta(ctx.config)
    with torch.device("meta"), torch.no_grad():
        x = torch.empty(b, 3, h, w)
        y = ref.analyze(x)
        z_hat = ref.quantize_z(ref.hyper_encode(y))
        scales, means = ref.hyper_decode(z_hat)
        syntax = ref.syntax(y)
        y_hat, _ = ref.slice_chain(y, means, scales)
        x_hat = ref.synthesize(y_hat, syntax)
        f = {
            "analyze": roofline.count_flops(lambda: ref.analyze(x)),
            "hyper_encode": roofline.count_flops(lambda: ref.hyper_encode(y)),
            "hyper_decode": roofline.count_flops(lambda: ref.hyper_decode(z_hat)),
            "syntax": roofline.count_flops(lambda: ref.syntax(y)),
            "slice_chain": roofline.count_flops(lambda: ref.slice_chain(y, means, scales)),
            "synthesize": roofline.count_flops(lambda: ref.synthesize(y_hat, syntax)),
        }
    gs_mods = [ref.g_s, ref.conv_weights_gen]
    ctx.record.values.update(
        flops=f,
        roundtrip_flops=(f["analyze"] + f["hyper_encode"] + 2 * f["hyper_decode"]
                         + f["syntax"] + 2 * f["slice_chain"] + f["synthesize"]),
        analyze_bytes=roofline.nbytes(x, y) + roofline.param_bytes([ref.g_a]),
        synthesize_bytes=roofline.nbytes(y_hat, syntax, x_hat) + roofline.param_bytes(gs_mods),
    )
