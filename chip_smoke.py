#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``lic_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

It drives the port's main path — the ``source_net`` serving path at full
width (N=192, M=16), random weights from a seed — through the entry points
a user calls, on a batch of 8 synthetic 512×768 images, and checks it.
Each phase prints one line:

1. device: the card's name and power limit, as ``nvidia-smi`` gives them;
2. build: both kernels built from this checkout's sources (into
   ``build/``), with the build seconds and the host rANS library loaded;
3. B2 (Triton GDN) against its plain version at the 7 GDN/IGDN shapes of
   one forward, fp32, atol/rtol 1e-5;
4. B1 (CUDA rANS drain) against its plain version on host-encoded streams
   with escapes, B=8, L=128, 4 slices threading state: bit-exact;
5. the eval forward at full width (finite outputs), and the same model on
   a small input against its CPU run (plain versions, no kernel);
6. the roundtrip ``compress_batch`` → ``decompress_batch``: final-state
   check, reconstruction within 1e-4 of the forward's; the kernels' launch
   counts over the main path; then ``compress`` → ``decompress`` at B=1;
7. times from CUDA events (UNTRAINED weights).

Then one JSON line with every kernel's name, route, source, the TPU kernel
it replaces, launches, max error and times, and, last, the device JSON.
Any failure raises: the exit code is not 0 and no result line is printed.
It needs no argument and one card, and exits non-zero without CUDA or
outside a checkout of the repository.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

H, W, BATCH = 512, 768, 8
SEED = 0
LANES = 128
GDN_TOL = 1e-5   # fp32 sums in another order than the plain matmul
RECON_TOL = 1e-4


def _say(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def _cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call between CUDA events, after one warm-up."""
    import torch

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


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "lic_tpu_torch")):
        print(
            "chip_smoke: lic_tpu_torch/ not found beside this script; run it "
            "from a checkout of the repository", file=sys.stderr,
        )
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2

    # ---- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    _say("device", kind=repr(kind), count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)

    from lic_tpu_torch import coding
    from lic_tpu_torch.coding import drain as drain_mod
    from lic_tpu_torch.data import smooth_images
    from lic_tpu_torch.layers import gdn as gdn_mod
    from lic_tpu_torch.models import build_model
    from lic_tpu_torch.models.compress import ChannelCoder, set_numerics_flags

    set_numerics_flags()  # no TF32, deterministic cuDNN: stated in code

    # ---- 2. build both kernels from the checkout's sources
    t0 = time.perf_counter()
    drain_mod.library()
    t_b1 = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in drain_mod.BUILD_LOG.splitlines() if "registers" in ln]
    t0 = time.perf_counter()
    for c in (16, 192):
        for inv in (False, True):
            x = torch.randn(256, c, device=dev)
            gdn_mod.gdn_fused(x, torch.eye(c, device=dev), torch.ones(c, device=dev), inv)
    torch.cuda.synchronize()
    t_b2 = time.perf_counter() - t0
    host_lib = coding.load_host_rans()
    _say("build", b1_cuda_s=f"{t_b1:.1f}", b2_triton_s=f"{t_b2:.1f}",
         b1_so=os.path.relpath(str(drain_mod._SO), ROOT),
         host_rans=os.path.relpath(host_lib, ROOT),
         ptxas=repr(ptxas[0] if ptxas else "cached"))

    # ---- 3. B2 vs plain at the forward's GDN/IGDN shapes (fp32)
    g = torch.Generator().manual_seed(SEED)
    gdn_shapes = [  # (stage, rows, C, inverse) for B=8 at 512×768
        ("g_a.gdn0", BATCH * 256 * 384, 192, False),
        ("g_a.gdn1", BATCH * 128 * 192, 192, False),
        ("g_a.gdn2", BATCH * 64 * 96, 192, False),
        ("g_s.igdn0", BATCH * 64 * 96, 192, True),
        ("g_s.igdn1", BATCH * 128 * 192, 192, True),
        ("g_s.igdn2", BATCH * 256 * 384, 192, True),
        ("g_s.igdn3", BATCH * 512 * 768, 16, True),
    ]
    gdn_err, gdn_ms, gdn_plain_ms = 0.0, 0.0, 0.0
    for stage, rows, c, inv in gdn_shapes:
        x = torch.randn(rows, c, generator=g).to(dev)
        gamma = (0.1 * torch.eye(c) + 0.01 * torch.rand(c, c, generator=g)).to(dev)
        beta = (1.0 + torch.rand(c, generator=g)).to(dev)
        y = gdn_mod.gdn_fused(x, gamma, beta, inv)
        ref = gdn_mod.gdn_plain(x, gamma, beta, inv)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        torch.testing.assert_close(y, ref, atol=GDN_TOL, rtol=GDN_TOL)
        ms = _cuda_ms(lambda: gdn_mod.gdn_fused(x, gamma, beta, inv), 20)
        pms = _cuda_ms(lambda: gdn_mod.gdn_plain(x, gamma, beta, inv), 20)
        gdn_err, gdn_ms, gdn_plain_ms = max(gdn_err, err), gdn_ms + ms, gdn_plain_ms + pms
        _say("b2_gdn", stage=stage, rows=rows, C=c, max_abs_err=f"{err:.3g}",
             ms=f"{ms:.4f}", plain_ms=f"{pms:.4f}")
        del x, y, ref

    # ---- 4. B1 vs plain: 4 slice drains threading state, B=8, L=128
    s_slice = (H // 16) * (W // 16) * 48  # 73 728 symbols per slice
    steps = [s_slice] * 4
    gcoder = coding.GaussianCoder()
    cdfs, offsets = gcoder.codec.cdfs, gcoder.codec.offsets
    sym, idx, pay, ends = coding.random_streams(
        cdfs, offsets, [(SEED + i, True) for i in range(BATCH)], steps, LANES
    )
    ddev = coding.DeviceRans16Interleaved(cdfs, offsets, LANES, device=dev)
    payt = torch.from_numpy(pay).to(dev)
    rows_all = torch.from_numpy(idx).to(dev)
    k_lanes = p_lanes = ddev.init_lanes(payt)
    drain_ms = drain_plain_ms = 0.0
    drain_err = 0
    for i in range(4):
        rows = rows_all[:, i * s_slice : (i + 1) * s_slice].contiguous()
        lanes_in = k_lanes
        k_lanes, k_dec = coding.rans_drain(ddev, lanes_in, payt, rows, s_slice)
        p_lanes, p_dec = coding.drain_plain(ddev, p_lanes, payt, rows, s_slice)
        torch.cuda.synchronize()
        drain_err = max(drain_err, int((k_dec.long() - p_dec.long()).abs().max()))
        if not (torch.equal(k_dec, p_dec) and torch.equal(k_lanes.state, p_lanes.state)
                and torch.equal(k_lanes.ptr, p_lanes.ptr)):
            raise AssertionError(f"B1 drain differs from its plain version (slice {i})")
        np.testing.assert_array_equal(
            k_dec.cpu().numpy(), sym[:, i * s_slice : (i + 1) * s_slice]
        )
        drain_ms += _cuda_ms(lambda: coding.rans_drain(ddev, lanes_in, payt, rows, s_slice), 5)
        drain_plain_ms += _cuda_ms(
            lambda: coding.drain_plain(ddev, lanes_in, payt, rows, s_slice), 1
        )
    if not (bool((k_lanes.state == 1 << 16).all()) and k_lanes.ptr.tolist() == ends):
        raise AssertionError("B1 drain: final lane states or pointers wrong")
    _say("b1_drain", streams=BATCH, lanes=LANES, slices=4, symbols_per_slice=s_slice,
         bitexact=True, ms_4_slices=f"{drain_ms:.3f}", plain_ms_4_slices=f"{drain_plain_ms:.3f}")
    del payt, rows_all, p_dec, k_dec

    # ---- 5. the model at full width; the same model on a small input
    # against its CPU run (plain versions, no kernel), stage by stage on
    # the same inputs so that no rounding flip can spread
    model = build_model("source_net", device=dev, seed=SEED)
    cpu_model = build_model("source_net", device="cpu", seed=SEED)
    x_np = smooth_images(np.random.default_rng(SEED), BATCH, H, W)
    x = torch.from_numpy(x_np).to(dev).contiguous(memory_format=torch.channels_last)
    small = torch.from_numpy(x_np[:1, :, :128, :128].copy())

    def stages(m, xin, z_hat=None, y_hat=None, syn=None):
        z3 = m.analyze(xin)
        if z_hat is None:
            med = m.eb_medians()[None, :, None, None]
            z_hat = torch.round(m.hyper_encode(z3) - med) + med
        scales, means = m.hyper_decode(z_hat)
        mu0, sigma0, _ = m.charm_entropy_params(means, scales, [], 0)
        if y_hat is None:
            y_hat, syn = m(xin).extras["y_hat"], m.syntax_from_latent(z3)
        rec = m.synthesize(y_hat, syn)
        return dict(z3=z3, z_hat=z_hat, scales=scales, means=means, mu0=mu0,
                    sigma0=sigma0, y_hat=y_hat, syn=syn, rec=rec)

    def on_gpu(t):
        return t.to(dev).contiguous(memory_format=torch.channels_last)

    with torch.no_grad():
        sc = stages(cpu_model, small)
        sg = stages(model, on_gpu(small), on_gpu(sc["z_hat"]), on_gpu(sc["y_hat"]),
                    sc["syn"].to(dev))
    ref_err = {
        k: float((sg[k].cpu() - sc[k]).abs().max())
        for k in ("z3", "scales", "means", "mu0", "sigma0", "rec")
    }
    if max(ref_err.values()) > RECON_TOL:
        raise AssertionError(f"GPU stages disagree with the CPU run: {ref_err}")

    # ---- 6. main path: forward + compress_batch → decompress_batch
    coder = ChannelCoder(model, name="source_net")
    torch.cuda.synchronize()
    gdn_mod.gdn_fused.launches = 0
    drain_mod.rans_drain.launches = 0
    with torch.no_grad():
        out = model(x)
    blobs = coder.compress_batch(x)
    rec = coder.decompress_batch(blobs)
    torch.cuda.synchronize()
    launches = {"gdn": gdn_mod.gdn_fused.launches, "drain": drain_mod.rans_drain.launches}
    if not (torch.isfinite(out.x_tilde).all() and torch.isfinite(out.bpp)):
        raise AssertionError("non-finite forward output")
    if out.x_tilde.shape != (BATCH, 3, H, W) or rec.shape != out.x_tilde.shape:
        raise AssertionError(f"shapes {tuple(out.x_tilde.shape)} / {tuple(rec.shape)}")
    _say("forward", shape=tuple(out.x_tilde.shape), bpp_est=f"{float(out.bpp):.4f}",
         mse=f"{float(out.mse):.5f}", finite=True, weights="UNTRAINED",
         small_vs_cpu_max_err=f"{max(ref_err.values()):.3g}")
    rec_err = float((rec - out.x_tilde).abs().max())
    if rec_err > RECON_TOL:
        raise AssertionError(f"decoded recon differs from the forward: {rec_err}")
    # every kernel of the path ran in it: 7 GDN stages in the forward, 3 in
    # the encoder's g_a, 4 in the decoder's g_s; one drain per decoded slice
    # and none in the encoder
    if launches != {"gdn": 14, "drain": 4}:
        raise AssertionError(f"unexpected kernel launches on the main path: {launches}")
    bpp = sum(len(b) for b in blobs) * 8 / (BATCH * H * W)
    x1 = x[:1]
    blob1 = coder.compress(x1)
    rec1 = coder.decompress(blob1)
    with torch.no_grad():
        ref1 = model(x1).x_tilde
    rec1_err = float((rec1 - ref1).abs().max())
    if rec1_err > RECON_TOL:
        raise AssertionError(f"B=1 roundtrip recon differs from its forward: {rec1_err}")
    _say("roundtrip", streams=BATCH, bpp=f"{bpp:.4f}", recon_max_err=f"{rec_err:.3g}",
         final_state_ok=True, launches=launches, b1_recon_max_err=f"{rec1_err:.3g}",
         b1_stream_equals_batch=blob1 == blobs[0], weights="UNTRAINED")

    # ---- 7. times (UNTRAINED weights: the codec rows are not rate points)
    mp = BATCH * H * W / 1e6
    with torch.no_grad():
        fwd_ms = _cuda_ms(lambda: model(x), 5)
    # the roundtrip includes host rANS: CUDA events around it on the
    # stream, synchronised, span the wall time of each call
    rt = sorted(
        _cuda_ms(lambda: coder.decompress_batch(coder.compress_batch(x)), 1) / 1e3
        for _ in range(3)
    )[1]
    _say("times", card=repr(smi), forward_ms=f"{fwd_ms:.2f}",
         forward_mps=f"{mp / fwd_ms * 1e3:.2f}", roundtrip_s=f"{rt:.3f}",
         roundtrip_mps=f"{mp / rt:.3f}", codec_bpp=f"{bpp:.4f}", weights="UNTRAINED")

    if any(m in sys.modules for m in ("jax", "flax")):
        raise AssertionError("the port imported jax")
    print(json.dumps({"kernels": [
        {
            "name": "rans_drain", "route": "cuda",
            "source": "lic_tpu_torch/csrc/rans_drain.cu",
            "replaces": "lic_tpu/coding/pallas_rans.py:93",
            "launches": launches["drain"], "max_abs_err": drain_err,
            "ms": round(drain_ms, 4), "plain_ms": round(drain_plain_ms, 4),
        },
        {
            "name": "gdn_fwd", "route": "triton",
            "source": "lic_tpu_torch/layers/gdn.py",
            "replaces": "lic_tpu/layers/pallas_gdn.py:31",
            "launches": launches["gdn"], "max_abs_err": gdn_err,
            "ms": round(gdn_ms, 4), "plain_ms": round(gdn_plain_ms, 4),
        },
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
