"""Where an image's bits depend on its batch: the σ path of the encoder at
B = 1 against B = 8, stage by stage, on one GPU (ROADMAP §C5).

    python -m lic_tpu_torch.tools.batch_probe [--preset source_net ...] [--batch 8]

For each preset (by default every preset a coder takes: the
neural-syntax family and the decodable hypers), built at full width (seed 0) with
the coder's numerics flags, on a batch of smooth synthetic 512×768 images,
each stage runs on the whole batch and on each image alone, fed the
batched run's values: g_a, h_a, both hyper-decoder heads, then for a
ChARM preset each slice's μ, σ, mean support, scale-table rows and LRP
output; for the entroformer each checkerboard pass's μ, σ and rows; for
neural syntax the context's μ and σ and the syntax vector's; and g_s.  It
prints the card (``nvidia-smi``) and one JSON line per preset with the
elements of each stage that differ in any bit, and the rows of the
coder's own passes (``coder_rows_differing``: the slice chain, the
checkerboard passes or the wavefront loop, in passes of ``pass_batch``
images) that differ between each image alone and the batch.  Model calls
straight at B = 1 and B = 8 may differ (cuDNN picks its algorithms by
shape); the coder's passes must not.

    python -m lic_tpu_torch.tools.batch_probe --card_vs_cpu [--preset ...]

compares the card with the CPU instead (ROADMAP §C8): for each preset with
a coder, built at full width on both (the entropy bottleneck's all-zero
``factor_i`` woken with seeded values, as a trained checkpoint has them),
the card encodes a batch of 512×768 images in its passes of 8, and the
CPU model with the same weights runs the decoder's side of the σ path
(``rows_card_vs_cpu``) on the card's ẑ and the card's symbols, one image
per pass: each drain step's scale-table rows against the card's.  Then
the CPU coder decodes each of the card's streams (``cpu_decode_outcomes``):
equal to the card's decode within 1e-4, raised at the final-state check,
or other pixels.  One JSON line per preset gives the rows that differ,
per slice, checkerboard pass or wavefront, and the outcomes.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from ..models.codec import DECODABLE_HYPERS
from ..models.presets import PRESETS


def decodable_presets():
    """The presets a coder takes, chosen by their hyper path (and the
    neural-syntax family's wavefront coder)."""
    return [name for name, cfg in PRESETS.items()
            if cfg.family == "neural_syntax" or cfg.hyper in DECODABLE_HYPERS]


def coder_rows_differing(model, coder, x) -> int:
    """The rows of the coder's own passes (σ-indexes of the slice chain or
    the checkerboard passes; ``GaussianMuCoder`` rows of every wavefront)
    for each image of ``x`` alone against the batch: → the count that
    differ."""
    from ..models.compress import _passes, pass_batch

    p = pass_batch(*x.shape[2:], x.device)
    with torch.no_grad():
        z3 = _passes(model.analyze, p, x)
        if coder.is_ns:
            def rows(i, j):
                z2 = torch.round(_passes(model.ns_hyper_encode, p, z3[i:j]))
                h2 = coder._ns_hyper(z2.permute(0, 2, 3, 1).cpu().numpy().astype(np.int32), p)[0]
                y = torch.round(z3[i:j, model.cfg.M :]).to(torch.int32)
                return coder._wavefronts(h2, p, y_known=y)[1].transpose(0, 1)
        else:
            _, z_hat = coder._z_enc(z3, p)

            def rows(i, j):
                return coder._slices_pass(z_hat[i:j], p, y=z3[i:j])[1]
        b = x.shape[0]
        return int((rows(0, b) != torch.cat([rows(i, i + 1) for i in range(b)])).sum())


def wake_eb(model, seed: int = 2) -> int:
    """Seeded values (0.05·N(0, 1)) for the entropy bottleneck's all-zero
    leaves (its ``factor_i``), as a trained checkpoint has them; the same
    for every model given the same seed.  → leaves woken."""
    g = torch.Generator().manual_seed(seed)
    woken = 0
    with torch.no_grad():
        for p in model.entropy_bottleneck.parameters():
            if not p.any():
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
                woken += 1
    return woken


def rows_card_vs_cpu(card, cpu, coder_card, coder_cpu, x, rate=None) -> dict:
    """The decoder's σ path on the CPU against the card's, on the card's
    stream: the card encodes ``x`` (its coder's passes), then the CPU
    coder runs its decode loop (slices, checkerboard passes or
    wavefronts) on the card's ẑ (or integer z2) with each drain replaced
    by the card's symbols of that step, so no row that differs can spread.
    ``rate``: a gain-unit model's rate index for every image.  → {"steps": [rows differing per drain step], "rows": total, "symbols":
    total, "first_step": index of the first step with a difference or
    None}."""
    from ..models import compress

    p = compress.pass_batch(*x.shape[2:], x.device)
    b = x.shape[0]
    with torch.no_grad():
        if rate is None:
            z3 = compress._passes(card.analyze, p, x)
        else:
            rates = torch.full((b,), float(rate), device=x.device)
            z3 = compress._passes(card.analyze, p, x, rates)
        if coder_card.is_ns:
            z2 = torch.round(compress._passes(card.ns_hyper_encode, p, z3))
            z2_int = z2.permute(0, 2, 3, 1).cpu().numpy().astype(np.int32)
            h2 = coder_card._ns_hyper(z2_int, p)[0]
            y = torch.round(z3[:, card.cfg.M :]).to(torch.int32)
            res, rows, _, _ = coder_card._wavefronts(h2, p, y_known=y)
            card_syms = [r.reshape(b, -1).cpu() for r in res]
            card_rows = [r.reshape(b, -1).cpu().to(torch.int32) for r in rows]
            counts = [len(ps) * (card.cfg.N - card.cfg.M)
                      for ps, _ in compress.wavefront_groups(*h2.shape[2:])]
        else:
            _, z_hat = coder_card._z_enc(z3, p)
            sym, rows, _, _ = coder_card._slices_pass(z_hat, p, y=z3)
            counts = coder_card._step_counts(*z3.shape[2:])
            card_syms = list(sym.cpu().to(torch.int32).split(counts, dim=1))
            card_rows = list(rows.cpu().to(torch.int32).split(counts, dim=1))
    replay, seen = iter(card_syms), []

    def drain(dev, lanes, payload, rows_flat, s_tot):
        seen.append(rows_flat[:, :s_tot].to(torch.int32).clone())
        return lanes, next(replay)

    inner = compress.rans_drain
    compress.rans_drain = drain
    try:
        with torch.no_grad():
            words = torch.zeros((b, 2 * 256 + 8), dtype=torch.int32)
            if coder_cpu.is_ns:
                h2_cpu = coder_cpu._ns_hyper(z2_int, 1)[0]
                coder_cpu._wavefronts(h2_cpu, 1, payload=words, n_lanes=256)
            else:
                coder_cpu._slices_pass(z_hat.cpu(), 1, payload=words)
    finally:
        compress.rans_drain = inner
    steps = [int((c[:, :n] != r).sum()) for c, r, n in zip(card_rows, seen, counts)]
    return {"steps": steps, "rows": sum(steps), "symbols": b * sum(counts),
            "first_step": next((i for i, n in enumerate(steps) if n), None)}


def cpu_decode_outcomes(coder_card, coder_cpu, x, tol: float = 1e-4) -> dict:
    """Each image of ``x`` coded by the card coder (one ``compress_batch``)
    and decoded alone by the CPU coder: → counts of "equal" (within
    ``tol`` of the card's decode), "raised" (the final-state check) and
    "other" (other pixels)."""
    blobs = coder_card.compress_batch(x)
    recs = coder_card.decompress_batch(blobs).cpu()
    out = {"equal": 0, "raised": 0, "other": 0}
    for i, blob in enumerate(blobs):
        try:
            rec = coder_cpu.decompress(blob)
        except ValueError as e:
            if "final-state" not in str(e):
                raise
            out["raised"] += 1
            continue
        out["equal" if float((rec - recs[i : i + 1]).abs().max()) <= tol else "other"] += 1
    return out


def stage_differences(model, coder, x) -> dict:
    """{stage: elements that differ in any bit between the batch ``x`` and
    each of its images alone}, and under ``coder_rows`` the differing
    rows of the coder's own passes."""
    from ..layers.entroformer import anchor_map
    from ..models.compress import dev_scale_idx

    b = x.shape[0]
    counts = {}

    def cmp(stage, full, single):
        counts[stage] = counts.get(stage, 0) + sum(
            int((full[i : i + 1] != single(i)).sum()) for i in range(b))

    def cmp_pair(stage, full, single):
        per = [single(i) for i in range(b)]
        for k, name in enumerate(("mu", "sigma")):
            cmp(f"{stage}.{name}", full[k], lambda i: per[i][k])
        return per

    with torch.no_grad():
        z3 = model.analyze(x)
        cmp("g_a", z3, lambda i: model.analyze(x[i : i + 1]))
        syn = model.syntax_from_latent(z3)
        if model.is_ns:
            z2 = torch.round(model.ns_hyper_encode(z3))
            cmp("ha_model", z2, lambda i: torch.round(model.ns_hyper_encode(z3[i : i + 1])))
            h2 = model.ns_hyper_decode(z2)
            cmp("hs_model", h2, lambda i: model.ns_hyper_decode(z2[i : i + 1]))
            y_hat = torch.round(z3[:, model.cfg.M :])
            cmp_pair("context", model.prediction_model(y_hat, h2),
                     lambda i: model.prediction_model(y_hat[i : i + 1], h2[i : i + 1]))
            cmp_pair("syntax", model.ns_syntax_params(h2),
                     lambda i: model.ns_syntax_params(h2[i : i + 1]))
        else:
            cmp("h_a", model.hyper_encode(z3), lambda i: model.hyper_encode(z3[i : i + 1]))
            med = model.eb_medians()[None, :, None, None]
            z_hat = torch.round(model.hyper_encode(z3) - med) + med
            scales, means = model.hyper_decode(z_hat)
            per = [model.hyper_decode(z_hat[i : i + 1]) for i in range(b)]
            cmp("h_s.scales", scales, lambda i: per[i][0])
            cmp("h_s.means", means, lambda i: per[i][1])
            if model.is_entro:
                y_hat = torch.zeros_like(z3)
                for k, name in enumerate(("anchors", "non_anchors")):
                    full = model.entro_predict(y_hat, scales, means)
                    per = cmp_pair(name, full, lambda i, y=y_hat: model.entro_predict(
                        y[i : i + 1], scales[i : i + 1], means[i : i + 1]))
                    cmp(f"{name}.rows", dev_scale_idx(full[1], coder.tab),
                        lambda i: dev_scale_idx(per[i][1], coder.tab))
                    mu = full[0]
                    y_hat = (torch.round(z3 - mu) + mu) * anchor_map(*z3.shape[2:], z3)
                y_hat = torch.round(z3 - mu) + mu
            else:
                supports = []
                for k, y_k in enumerate(z3.chunk(model.cfg.num_slices, dim=1)):
                    sup = model.support(supports)
                    mu, sigma, msup = model.charm_entropy_params(means, scales, sup, k)
                    per = [model.charm_entropy_params(means[i : i + 1], scales[i : i + 1],
                                                      [s[i : i + 1] for s in sup], k)
                           for i in range(b)]
                    cmp("mu", mu, lambda i: per[i][0])
                    cmp("sigma", sigma, lambda i: per[i][1])
                    cmp("mean_support", msup, lambda i: per[i][2])
                    cmp("rows", dev_scale_idx(sigma, coder.tab),
                        lambda i: dev_scale_idx(per[i][1], coder.tab))
                    y_hat = torch.round(y_k - mu) + mu
                    lrp = model.charm_apply_lrp(msup, y_hat, k)
                    cmp("lrp", lrp, lambda i: model.charm_apply_lrp(
                        msup[i : i + 1], y_hat[i : i + 1], k))
                    supports.append(lrp)
                y_hat = torch.cat(supports, dim=1)
        cmp("g_s", model.synthesize(y_hat, syn),
            lambda i: model.synthesize(y_hat[i : i + 1], syn[i : i + 1]))
    counts["coder_rows"] = coder_rows_differing(model, coder, x)
    return counts


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", nargs="+", default=decodable_presets(),
                    help="default: every preset the coders take")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--card_vs_cpu", action="store_true",
                    help="the decoder's σ rows on the CPU against the card's (§C8)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("batch_probe needs a CUDA device")

    from ..data import smooth_images
    from ..models import build_model
    from ..models.compress import ChannelCoder, set_numerics_flags

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip())
    set_numerics_flags()
    dev = torch.device("cuda")
    x = torch.from_numpy(smooth_images(np.random.default_rng(args.seed), args.batch, 512, 768))
    x = x.to(dev).contiguous(memory_format=torch.channels_last)
    if args.card_vs_cpu:
        for preset in args.preset:
            card = build_model(preset, device=dev, seed=args.seed)
            cpu = build_model(preset, device="cpu", seed=args.seed)
            woken = 0
            if not card.is_ns:
                woken = wake_eb(card)
                wake_eb(cpu)
            c_card, c_cpu = ChannelCoder(card, name=preset), ChannelCoder(cpu, name=preset)
            r = rows_card_vs_cpu(card, cpu, c_card, c_cpu, x)
            print(json.dumps({"preset": preset, "batch": args.batch, "size": "512x768",
                              "eb_leaves_woken": woken, "card_vs_cpu_rows_differing": r,
                              "cpu_decode_outcomes": cpu_decode_outcomes(c_card, c_cpu, x)}),
                  flush=True)
            del card, cpu
            torch.cuda.empty_cache()
        return
    for preset in args.preset:
        model = build_model(preset, device=dev, seed=args.seed)
        counts = stage_differences(model, ChannelCoder(model, name=preset), x)
        print(json.dumps({"preset": preset, "batch": args.batch,
                          "elements_differing_b1_vs_batch": counts}), flush=True)
        del model
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
