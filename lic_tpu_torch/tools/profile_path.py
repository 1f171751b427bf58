"""Where the time of the port's main path goes, on one GPU.

    python -m lic_tpu_torch.tools.profile_path [--preset net_unet_ha_hs_dec] [--out build/profile]

``--preset`` (any preset of the port; ``--transform rbs`` and
``--no_lrp`` build it with that transform or without LRP) at full width,
random weights from ``--seed``, a batch of ``--batch`` smooth synthetic images of
``--height`` × ``--width``, fp32 with the coder's numerics flags.  It
prints:

* the card: name, power limit and maximum SM clock from ``nvidia-smi``;
* ``STAGE`` / ``LAYER`` lines: CUDA-event milliseconds of each stage of the
  eval forward (g_a, the hyper path and its analysis and synthesis, the
  syntax model, g_s; for the entroformer the hyper embedding and each
  checkerboard pass; for neural syntax the hyper, the syntax vector's
  parameters and the spatial context) and of each layer of g_a and g_s (a
  ``WinNoShiftAttention`` gate is one layer);
* ``HYPER`` lines (latent U-Net presets): each ``SpatialTransformer`` of
  the latent U-Net on the input the forward gave it (``st2`` twice: the
  down and the up path), and its first block's self-attention core on
  that input: the plain product the port runs (matmul, fp32 softmax,
  matmul) beside ``F.scaled_dot_product_attention`` on the same q, k, v
  (a yardstick only: nothing on the path calls it), with their largest
  difference; each time the median of 9 means of 10 calls;
* ``SLICE`` lines (ChARM presets), read inside the eval forward itself by
  CUDA events that
  forward pre- and post-hooks record: the 4-slice ChARM chain from its
  first module to its last LRP stack, and per slice each SWAtten stack
  (where the preset has them), each ChARM conv stack and the LRP stack;
* ``WAVEFRONT`` lines (neural syntax): the wavefront loop of the encode
  and of the decode split by CUDA events into the patch gather, context
  head and scatter, the rows, and the drain (B1; the encode's residuals),
  summed over the T wavefronts;
* ``LAUNCHES``: each kernel's launches, and each plain route's calls, in
  one eval forward;
* for the eval forward and for the roundtrip ``compress_batch`` →
  ``decompress_batch``, each under ``torch.profiler``: the kernels with the
  most device time (and B1's device time per launch), and the device busy
  share — the union of the intervals
  in which a kernel, copy or memset ran on the card, over the host wall
  time of the profiled region (and over the span from the first device
  activity to the last);
* ``PHASES``: host-clock seconds of the roundtrip's phases, unprofiled,
  and the forward's and the roundtrip's megapixels per second.

A preset no coder takes (the ``unet`` and ``latent_unet`` hypers) has no
roundtrip: only its forward is timed and profiled.

With ``--post_processing`` the preset carries the HAN tail: the stages
add ``tail`` (the generated conv, the HAN, the second generated conv) and
``HAN`` lines time each piece of the head (head conv, each residual
group, ``body_tail``, the LAM stack and attention, ``last_conv``, CSAM,
``last``).

With ``--tune STEPS`` it profiles content-adaptive encoding instead
(``evaluation.content_adaptive_finetune`` of the batch's first image,
B = 1, after one unprofiled step): the step's milliseconds by phase (CUDA
events), the kernels with the most device time and the busy share, and
the aten ops with the most device time by input shape.

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

from ..models.codec import DECODABLE_HYPERS
from ..models.presets import PRESETS

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


def _median_ms(fn, rounds: int = 9, reps: int = 10) -> float:
    """The median over ``rounds`` of ``_cuda_ms(fn, reps)``: the sub-
    millisecond pieces are launch-bound, and one mean of a few calls
    moves by tens of percent with the host."""
    return float(np.median([_cuda_ms(fn, reps) for _ in range(rounds)]))


def _hooked_ms(model, x, spans: Dict[str, Tuple[torch.nn.Module, torch.nn.Module]],
               reps: int = 5) -> Dict[str, float]:
    """CUDA-event milliseconds of each span (first module's forward pre-hook
    to last module's forward hook) within ``model(x)``, the mean over
    ``reps`` forwards after a warm-up."""
    marks = defaultdict(list)

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks[name].append(ev)

    hooks = []
    for name, (first, last) in spans.items():
        hooks.append(first.register_forward_pre_hook(lambda m, a, n=name: mark(n)))
        hooks.append(last.register_forward_hook(lambda m, a, o, n=name: mark(n)))
    try:
        model(x)
        _sync()
        marks.clear()
        for _ in range(reps):
            model(x)
        _sync()
    finally:
        for h in hooks:
            h.remove()
    return {name: sum(ev[i].elapsed_time(ev[i + 1]) for i in range(0, len(ev), 2)) / reps
            for name, ev in marks.items()}


def _slice_spans(model) -> Dict[str, Tuple[torch.nn.Module, torch.nn.Module]]:
    """The ChARM chain and each slice's stacks, as (first, last) modules."""
    names = (["atten_mean", "atten_scale"] if model.cfg.swatten else []) + [
        "cc_mean_transforms", "cc_scale_transforms"] + (
        ["lrp_transforms"] if model.cfg.lrp else [])
    spans = {"chain": (getattr(model, names[0])[0], getattr(model, names[-1])[-1])}
    for i in range(model.cfg.num_slices):
        for name in names:
            mod = getattr(model, name)[i]
            spans[f"{i} {name.replace('_transforms', '')}"] = (mod, mod)
    return spans


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
    for name, (t, n) in act["kernels"]:
        if "rans_drain" in name:  # B1, in or out of the top
            print(f"  B1 {t / iters / 1e3:.4f} ms/iter in {n // iters} launches "
                  f"({t / n:.2f} us each): {name[:80]}")


def _tune_profile(model, x1, steps: int, out_dir: str, top: int = 15) -> None:
    """``--tune``: one unprofiled tune step, then ``steps`` steps of
    ``content_adaptive_finetune`` on ``x1`` timed by phase and profiled."""
    from torch.profiler import ProfilerActivity, profile

    from ..config import EvalConfig
    from ..evaluation import content_adaptive_finetune

    content_adaptive_finetune(model, x1, EvalConfig(tune_iters=1))
    ev = []

    def mark(name):
        if name == "start":
            ev.append({})
        ev[-1][name] = torch.cuda.Event(enable_timing=True)
        ev[-1][name].record()

    content_adaptive_finetune(model, x1, EvalConfig(tune_iters=steps), on_phase=mark)
    _sync()
    phases = ("start", "forward", "backward", "optimizer")
    for i, e in enumerate(ev):
        ms = [e[a].elapsed_time(e[b]) for a, b in zip(phases, phases[1:])]
        print(f"TUNE step {i}: forward {ms[0]:.3f} backward {ms[1]:.3f} "
              f"optimizer {ms[2]:.3f} ms")
    _profiled("tune", lambda: content_adaptive_finetune(
        model, x1, EvalConfig(tune_iters=steps)), 1, out_dir, top=top)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        content_adaptive_finetune(model, x1, EvalConfig(tune_iters=steps))
        _sync()
    print(prof.key_averages(group_by_input_shape=True).table(
        sort_by="cuda_time_total", row_limit=top, max_name_column_width=60,
        max_shapes_column_width=80))


def _counters() -> dict:
    """Each kernel wrapper and plain route of the forward, by name."""
    from ..coding import drain
    from ..layers import conv_direct, gdn, win_attention, window_attn

    return {"gdn": gdn.gdn_fused, "gdn_plain_route": gdn.gdn_plain_route,
            "conv5s2": conv_direct.conv5s2, "convk_s1": conv_direct.convk_s1,
            "wba": window_attn.window_attention,
            "wba_proj": window_attn.window_attention_proj,
            "wba_plain_route": win_attention.wba_plain_route,
            "drain": drain.table_routes["smem"], "drain_global": drain.table_routes["global"]}


def _stages(model, x, out) -> Dict[str, object]:
    """The eval forward's stages as callables, by family."""
    from ..layers.entroformer import anchor_map

    y_hat = out.extras["y_hat"]
    z3 = model.analyze(x)
    syn = model.syntax_from_latent(z3)
    stages = {"forward": lambda: model(x), "g_a": lambda: model.analyze(x)}
    if model.is_ns:
        z2_int = torch.round(model.ns_hyper_encode(z3))
        h2 = model.ns_hyper_decode(z2_int)
        stages.update({
            "ha_model": lambda: model.ns_hyper_encode(z3),
            "hs_model": lambda: model.ns_hyper_decode(z2_int),
            "syntax": lambda: model.syntax_from_latent(z3),
            "syntax (μ, σ)": lambda: model.ns_syntax_params(h2),
            "context": lambda: model.prediction_model(y_hat, h2, masked=True),
        })
    else:
        scales, means, _ = model.hyper_forward(z3)
        stages["hyper"] = lambda: model.hyper_forward(z3)
        if model.cfg.hyper in DECODABLE_HYPERS:
            med = model.eb_medians()[None, :, None, None]
            z_hat = torch.round(model.hyper_encode(z3) - med) + med
            stages.update({"h_a": lambda: model.hyper_encode(z3),
                           "h_s (both)": lambda: model.hyper_decode(z_hat)})
        elif model.cfg.hyper == "unet":  # the decoder reads the encoder's skips
            skips = model.h_a(z3)[1:]
            stages.update({"h_a": lambda: model.h_a(z3),
                           "h_s (both)": lambda: model._two_decoders(None, *skips)})
        stages["syntax"] = lambda: model.syntax_from_latent(z3)
        if model.is_entro:
            h_emb = model.entro_embed_hyper(scales, means)
            y_in = y_hat * anchor_map(y_hat.shape[2], y_hat.shape[3], y_hat)
            stages.update({
                "entro embed": lambda: model.entro_embed_hyper(scales, means),
                "entro anchors": lambda: model.entro_predict(
                    torch.zeros_like(y_hat), scales, means, h_emb),
                "entro non-anchors": lambda: model.entro_predict(y_in, scales, means, h_emb),
            })
    stages.update({"g_s": lambda: model.g_s(y_hat),
                   "synthesize": lambda: model.synthesize(y_hat, syn)})
    if model.cfg.post_processing:
        x_t = model.g_s(y_hat)
        stages["tail"] = lambda: model._decode_tail(x_t, syn)
    return stages


def _latent_unet_pieces(model, z3) -> Dict[str, float]:
    """CUDA-event milliseconds of each ``SpatialTransformer`` of the latent
    U-Net(s) on the input the hyper forward gave it."""
    from ..layers import SpatialTransformer

    inputs = []
    unets = [("unet", model.unet)] + ([("unet_b", model.unet_b)] if model.unet_b is not None else [])
    hooks = [m.register_forward_pre_hook(
                 lambda m, a, name=f"{u}.{n}": inputs.append((name, m, a[0])))
             for u, net in unets for n, m in net.named_modules()
             if isinstance(m, SpatialTransformer)]
    model.hyper_forward(z3)
    for h in hooks:
        h.remove()
    seen: Dict[str, int] = {}
    out = {}
    for name, m, a in inputs:
        seen[name] = seen.get(name, 0) + 1
        key = name if seen[name] == 1 else f"{name}#{seen[name]}"
        plain_ms, sdpa_ms, diff = _attention_vs_sdpa(m, a)
        out[f"{key} {tuple(a.shape)}"] = (f"{_median_ms(lambda: m(a)):9.3f} ms  attn1 plain "
                                          f"{plain_ms:.3f} ms, sdpa {sdpa_ms:.3f} ms, "
                                          f"max diff {diff:.3g}")
    return out


def _attention_vs_sdpa(st, x) -> Tuple[float, float, float]:
    """The first block's self-attention core of ``SpatialTransformer`` ``st``
    on its input ``x``: (plain ms, SDPA ms, max |difference|)."""
    import torch.nn.functional as F

    blk = st.block_0
    attn = blk.attn1
    t = blk.norm1(st.proj_in(st.norm(x)).flatten(2).transpose(1, 2))
    b, n, _ = t.shape
    h, d = attn.heads, attn.dim_head
    q, k, v = (lin(t).view(b, n, h, d).transpose(1, 2)
               for lin in (attn.to_q, attn.to_k, attn.to_v))

    def plain():
        sim = torch.matmul((q * d ** -0.5).float(), k.float().transpose(-1, -2))
        return torch.matmul(F.softmax(sim, dim=-1), v)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v)

    diff = float((plain() - sdpa()).abs().max())
    return _median_ms(plain), _median_ms(sdpa), diff


def _han_pieces(han, x_bf) -> Dict[str, float]:
    """CUDA-event milliseconds of each piece of ``HANHead`` on its input."""
    from ..models.han import mean_shift

    out, h = {}, mean_shift(x_bf, sign=-1)

    def timed(name, fn):
        out[name] = _cuda_ms(fn)
        return fn()

    x = timed("head", lambda: han.head(h))
    res, stages = x, []
    for i in range(han.n_resgroups):
        g = getattr(han, f"group{i}")
        res = timed(f"group{i}", lambda: g(res))
        stages.append(res)
    res = timed("body_tail", lambda: han.body_tail(res))
    stages.append(res)
    st = timed("stack", lambda: torch.stack(stages[::-1], dim=1))
    la = timed("la", lambda: han.la(st))
    out2 = timed("last_conv", lambda: han.last_conv(la))
    out1 = timed("csa", lambda: han.csa(res))
    fused = torch.cat([out1, out2], dim=1)
    timed("last", lambda: han.last(fused))
    return out


def _wavefront_split(coder, x, blobs) -> None:
    """``WAVEFRONT`` lines: the encode's and the decode's wavefront loops
    split by CUDA events after each step's head, rows and drain."""
    names = ("gather+head+scatter", "rows", "drain")
    real = coder._wavefronts
    for label, run in (("encode", lambda: coder.compress_batch(x)),
                       ("decode", lambda: coder.decompress_batch(blobs))):
        events = []

        def mark(name):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)

        def timed(*a, **k):
            mark("start")
            return real(*a, stage=mark, **k)

        coder._wavefronts = timed
        try:
            run()
        finally:
            coder._wavefronts = real
        _sync()
        sums = [0.0, 0.0, 0.0]
        for i in range(1, len(events)):
            sums[(i - 1) % 3] += events[i - 1].elapsed_time(events[i])
        steps = (len(events) - 1) // 3
        print(f"WAVEFRONT {label}: {steps} steps, " + ", ".join(
            f"{n} {t:.3f} ms ({t / steps * 1e3:.1f} us/step)" for n, t in zip(names, sums)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="source_net", choices=tuple(PRESETS))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--width", type=int, default=768)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=os.path.join("build", "profile"))
    ap.add_argument("--post_processing", action="store_true",
                    help="build the preset with the HAN tail and time its pieces")
    ap.add_argument("--tune", type=int, default=0, metavar="STEPS",
                    help="profile STEPS content-adaptive tune steps (B = 1) instead")
    ap.add_argument("--transform", default=None, choices=("plain", "plain_wam", "rich", "rbs"),
                    help="build the preset with this transform (rbs: the rich g_a with "
                         "the rbs g_s)")
    ap.add_argument("--no_lrp", action="store_true",
                    help="build the preset without latent residual prediction")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_path needs a CUDA device")

    from ..data import smooth_images
    from ..models import build_model
    from ..models.compress import ChannelCoder, pass_batch, set_numerics_flags

    os.makedirs(args.out, exist_ok=True)
    print(args.preset, subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip())
    set_numerics_flags()
    dev = torch.device("cuda")
    over = dict(post_processing=args.post_processing)
    if args.transform:
        over["transform"] = args.transform
    if args.no_lrp:
        over["lrp"] = False
    model = build_model(args.preset, device=dev, seed=args.seed, **over)
    x = torch.from_numpy(smooth_images(
        np.random.default_rng(args.seed), args.batch, args.height, args.width,
    )).to(dev).contiguous(memory_format=torch.channels_last)
    if args.tune:
        _tune_profile(model, x[:1], args.tune, args.out)
        return
    decodable = model.is_ns or model.cfg.hyper in DECODABLE_HYPERS
    coder = ChannelCoder(model, name=args.preset) if decodable else None

    with torch.no_grad():
        for _ in range(2):
            model(x)
        out = model(x)
        if coder is not None:
            coder.decompress_batch(coder.compress_batch(x))
        _sync()
        y_hat = out.extras["y_hat"]
        mp = x.shape[0] * x.shape[2] * x.shape[3] / 1e6
        for name, fn in _stages(model, x, out).items():
            ms = _cuda_ms(fn)
            print(f"STAGE {name:18s} {ms:9.3f} ms"
                  + (f"  {mp / ms * 1e3:.2f} MP/s" if name == "forward" else ""))
        if model.cfg.hyper == "latent_unet":
            for name, line in _latent_unet_pieces(model, model.analyze(x)).items():
                print(f"HYPER {name:32s} {line}")
        if not (model.is_ns or model.is_entro):
            sl = _hooked_ms(model, x, _slice_spans(model))
            print(f"SLICE chain {sl.pop('chain'):.3f} ms (inside the forward)")
            for i in range(model.cfg.num_slices):
                print(f"SLICE {i} " + " ".join(f"{k.split()[1]}={v:.3f}" for k, v in sl.items()
                                              if k.startswith(f"{i} ")) + " ms")
        counters = _counters()
        for fn in counters.values():
            fn.launches = 0
        model(x)
        _sync()
        print("LAUNCHES per forward", json.dumps({k: fn.launches for k, fn in counters.items()}))
        for tname, inp in (("g_a", x), ("g_s", y_hat)):
            h = inp
            for cname, child in getattr(model, tname).named_children():
                t = _cuda_ms(lambda: child(h))
                h = child(h)
                print(f"LAYER {tname}.{cname:8s} out={tuple(h.shape)} {t:9.3f} ms")
        if model.cfg.post_processing:
            x_bf = model._decode_tail(model.g_s(y_hat), model.syntax_from_latent(model.analyze(x)),
                                      use_post_processing=False)
            for name, t in _han_pieces(model.han, x_bf).items():
                print(f"HAN {name:10s} {t:9.3f} ms")

        _profiled("forward", lambda: model(x), 3, args.out, top=15)
    if coder is None:
        print("PHASES none: no coder takes this preset")
        print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        return
    _profiled("roundtrip", lambda: coder.decompress_batch(coder.compress_batch(x)),
              1, args.out, top=15)

    phases, p = {}, pass_batch(*x.shape[2:], x.device)
    for _ in range(2):  # the second pass is reported
        with torch.no_grad():
            t = time.perf_counter()
            z3 = model.analyze(x)
            _sync()
            phases["encode g_a"] = time.perf_counter() - t
            t = time.perf_counter()
            if model.is_ns:
                z2 = torch.round(model.ns_hyper_encode(z3))
                h2, _, _ = coder._ns_hyper(z2.permute(0, 2, 3, 1).cpu().numpy().astype(np.int32), p)
                model.syntax_from_latent(z3)
                _sync()
                phases["encode hyper+syntax"] = time.perf_counter() - t
                t = time.perf_counter()
                coder._wavefronts(h2, p, y_known=torch.round(z3[:, model.cfg.M :]).int())
                _sync()
                phases["encode wavefronts"] = time.perf_counter() - t
            else:
                _, z_hat = coder._z_enc(z3, p)
                model.syntax_from_latent(z3)
                _sync()
                phases["encode hyper+syntax"] = time.perf_counter() - t
                t = time.perf_counter()
                coder._slices_pass(z_hat, p, y=z3)
                _sync()
                phases["encode checkerboard" if model.is_entro else "encode slice chain"] = (
                    time.perf_counter() - t)
        t = time.perf_counter()
        blobs = coder.compress_batch(x)
        _sync()
        phases["compress_batch"] = time.perf_counter() - t
        t = time.perf_counter()
        coder.decompress_batch(blobs)
        _sync()
        phases["decompress_batch"] = time.perf_counter() - t
    mp = x.shape[0] * x.shape[2] * x.shape[3] / 1e6
    phases["roundtrip_mps"] = mp / (phases["compress_batch"] + phases["decompress_batch"])
    if model.is_ns:
        _wavefront_split(coder, x, blobs)
    print("PHASES (s)", json.dumps(phases))
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


if __name__ == "__main__":
    main()
