"""Traffic kind ``train``: the reference's training recipe.

``make_train_step`` over the configuration's model (λ ``lmbda``, Adam with
the global norm clipped to 1, the entropy bottleneck's quantiles on their
own Adam), fed by the program's input pipeline: ``ImageFolderDataset``
over ``images`` seeded smooth PNGs of ``image_size`` written at set-up
under ``$TMPDIR``, and ``train_iterator`` with ``threads`` threads cutting
random ``crop`` crops into batches of ``batch``.

Set-up builds the one training state, takes its first ``checked`` steps
through the window's own call and feed (each on a batch of its own), and
hands that state on to the window.  End to end: ``train_images_per_s``,
the images of the steps that finished, over the seconds from the window's
start to the end of its last step (each step ends with the loss read
back, as the trainer's loop does; no step starts after ``--seconds``).

The check (``benchmark.train_check``) follows the first ``checked`` steps
with the plain reference from the same weights, crops and noise seed.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time

import numpy as np
import torch

from .. import roofline, system, train_check
from ..images import smooth_images


def write_images(p: dict, seed: int, device, folder: str) -> np.ndarray:
    """The seeded images as PNGs ``img_XX.png`` in ``folder``; → the same
    pixels, (n, H, W, 3) uint8."""
    from PIL import Image

    h, w = p["image_size"]
    rng = np.random.default_rng(seed)
    x = smooth_images(rng, int(p["images"]), h, w, device)
    u8 = torch.round((x + 1) * 127.5).clamp(0, 255).to(torch.uint8)
    u8 = u8.permute(0, 2, 3, 1).contiguous().cpu().numpy()
    for i, img in enumerate(u8):
        Image.fromarray(img).save(os.path.join(folder, f"img_{i:03d}.png"), compress_level=1)
    return u8


def first_steps(config, p: dict, seed: int, dev, folder: str):
    """Set-up: the PNGs, the weights, the one training state and its first
    ``checked`` steps through the window's call and feed.  → (step, state,
    iterator, weights, pixels, the program's readings of those steps)."""
    from lic_tpu_torch.config import TrainConfig
    from lic_tpu_torch.data.datasets import ImageFolderDataset, train_iterator
    from lic_tpu_torch.models.compress import set_numerics_flags
    from lic_tpu_torch.training import create_state, make_optimizer, make_train_step

    b = int(p["batch"])
    set_numerics_flags()
    pixels = write_images(p, seed, dev, folder)
    weights = system.make_weights(config, seed, dev)
    model = system.build_program(config, weights, dev).train()
    cfg = TrainConfig(lmbda=float(p["lmbda"]), batch_size=b, crop_size=int(p["crop"]))
    optimizer = make_optimizer(model, cfg, steps_per_epoch=1000)
    state = create_state(model, optimizer, seed=seed)
    step = make_train_step(model, cfg, optimizer)
    it = train_iterator(ImageFolderDataset(folder, int(p["crop"])), b, seed=seed,
                        num_threads=int(p["threads"]), device=dev)
    program = train_check.ProgramReadings(model, optimizer, weights)
    try:
        for k in range(int(p["checked"])):
            x = next(it)
            program.batches.append(x.cpu())
            program.losses.append(float(step(state, x)["loss"]))
            if k == 0:
                program.read_first_gradient()
        program.read_change()
    except BaseException:
        it.close()
        raise
    return step, state, it, weights, pixels, program


def run(ctx):
    p, dev, rec = ctx.traffic, ctx.device, ctx.record
    b = int(p["batch"])
    folder = tempfile.mkdtemp(prefix="lic_bench_train_", dir=os.environ.get("TMPDIR"))
    it = None
    try:
        step, state, it, weights, pixels, program = first_steps(ctx.config, p, ctx.seed, dev,
                                                                 folder)
        float(step(state, next(it))["loss"])  # one more, off the reading

        marks = {}
        on_phase = None
        if ctx.trace:
            def on_phase(name):
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                marks.setdefault(name, []).append(e)

        def feed():
            t = time.perf_counter()
            x = next(it)
            if ctx.trace and rec.recording:
                rec.host_s["input_wait"].append(time.perf_counter() - t)
            return x

        torch.cuda.reset_peak_memory_stats()
        ctx.window_start()
        n = 0
        t0 = time.perf_counter()
        deadline = t0 + ctx.seconds
        while time.perf_counter() < deadline:
            float(step(state, feed(), on_phase)["loss"])
            n += 1
        window_s = time.perf_counter() - t0
        if ctx.trace:
            rec.recording = False
            ctx.profile(lambda: [float(step(state, feed())["loss"])
                                 for _ in range(int(p["traced"]))])
            torch.cuda.synchronize()
            rec.cuda_ms["backward"] = [f.elapsed_time(bk) for f, bk in
                                       zip(marks["forward"], marks["backward"])]
            rec.values["step_flops"] = _step_flops(ctx.config, b, int(p["crop"]),
                                                   float(p["lmbda"]))
        memory = torch.cuda.max_memory_allocated()
        rec.values.update(window_s=window_s, steps=n)
        it.close()
        it = None
        program.model = program.optimizer = None
        del step, state
        torch.cuda.empty_cache()
        checks, readings = train_check.check(ctx.config, weights, program, pixels, p, ctx.seed,
                                             dev)
        ctx.extra.update(readings)
    finally:
        if it is not None:
            it.close()
        shutil.rmtree(folder, ignore_errors=True)
    return {"attempted": n * b, "failed": 0, "memory_peak_bytes": memory,
            "e2e": {"train_images_per_s": n * b / window_s}, "checks": checks}


def _step_flops(config, b: int, crop: int, lmbda: float) -> int:
    """Operations of one training step (forward and backward) on the
    reference at the window's shapes (``meta`` device)."""
    ref = system.reference_meta(config).train()
    with torch.device("meta"):
        x = torch.empty(b, 3, crop, crop)
        noise = lambda shape, dtype, device: torch.empty(tuple(shape), dtype=dtype,
                                                         device=device)

        def step():
            out = ref(x, training=True, noise_fn=noise)
            loss = lmbda * 255.0 ** 2 * out["mse"] + out["bpp"]
            (loss + ref.entropy_bottleneck.aux_loss()).backward()

        return roofline.count_flops(step)
