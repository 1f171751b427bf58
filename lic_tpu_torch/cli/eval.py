"""Evaluation CLI: the flags of ``lic_tpu/cli/eval.py`` (the reference's
``eval_net.py:202-254``) on the port's evaluator; it evaluates the whole
image set.

    python -m lic_tpu_torch.cli.eval --data_path /data/kodak \\
        --weight_path ckpt/final.npz --preset net_ga --lmbda 0.0067

It runs on the card unless ``--device cpu`` is given.  ``--weight_path``
is a ``.npz`` of either package; ``--pre_processing`` tunes g_a per image
(content-adaptive encoding); ``--write_bitstreams DIR`` writes each
image's ``.ltc`` file, coded with the checkpoint's weights; ``--rate``
picks a variable-rate preset's operating point for both.
``--post_processing`` builds the model with the HAN tail (a phase-2
checkpoint): the evaluation and the bitstreams' decodes run it, the
content-adaptive tune does not.
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="lic_tpu_torch evaluator")
    p.add_argument("--data_path", required=True)
    p.add_argument("--weight_path", required=True)
    p.add_argument("--preset", default="net_ga")
    p.add_argument("--lmbda", type=float, default=0.0067,
                   help="finetune λ (reference default, eval_net.py:236)")
    p.add_argument("--high", action="store_true")
    p.add_argument("--post_processing", action="store_true",
                   help="build the model with the HAN post-processing tail")
    p.add_argument("--pre_processing", action="store_true",
                   help="content-adaptive per-image encoder finetuning")
    p.add_argument("--tune_iter", type=int, default=100)
    p.add_argument("--write_bitstreams", default="",
                   help="directory to write real rANS bitstreams")
    p.add_argument("--rate", type=float, default=None,
                   help="gain-unit rate index for variable-rate presets "
                        "(continuous; None = unit 0)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="run on the card (default) or on the CPU")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from ..config import EvalConfig
    from ..data.datasets import list_images
    from ..evaluation import evaluate_folder
    from ..evaluation.eval import _load_pm1
    from ..models import build_model
    from ..models.compress import ChannelCoder
    from ..utils.checkpoint import load_params

    model = build_model(args.preset, device=args.device, is_high=args.high,
                        post_processing=args.post_processing)
    load_params(args.weight_path, model)
    if args.rate is not None and model.cfg.gain_units == 0:
        raise SystemExit(
            f"--rate given but preset '{args.preset}' has no gain units — "
            "it would be silently ignored (use a variable-rate preset)"
        )
    ec = EvalConfig(lmbda=args.lmbda, tune_iters=args.tune_iter, rate=args.rate)
    evaluate_folder(model, args.data_path, ec, pre_processing=args.pre_processing)

    if args.write_bitstreams:
        os.makedirs(args.write_bitstreams, exist_ok=True)
        coder = ChannelCoder(model, name=args.preset, rate=args.rate)
        for f in list_images(args.data_path):
            blob = coder.compress(_load_pm1(f, args.device))
            out = os.path.join(
                args.write_bitstreams, os.path.splitext(os.path.basename(f))[0] + ".ltc")
            with open(out, "wb") as fd:
                fd.write(blob)
            print(f"{f} → {out} ({len(blob)} bytes)")


if __name__ == "__main__":
    main()
