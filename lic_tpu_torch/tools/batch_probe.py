"""Where an image's bits depend on its batch: the σ path of the encoder at
B = 1 against B = 8, stage by stage, on one GPU (ROADMAP §C5).

    python -m lic_tpu_torch.tools.batch_probe [--preset source_net ...] [--batch 8]

For each preset (any of the port's), built at full width (seed 0) with
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
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from ..models.presets import PRESETS


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
    ap.add_argument("--preset", nargs="+", default=list(PRESETS))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
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
    for preset in args.preset:
        model = build_model(preset, device=dev, seed=args.seed)
        counts = stage_differences(model, ChannelCoder(model, name=preset), x)
        print(json.dumps({"preset": preset, "batch": args.batch,
                          "elements_differing_b1_vs_batch": counts}), flush=True)
        del model
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
