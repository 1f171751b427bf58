"""Training CLI: the flags of ``lic_tpu/cli/train.py`` (the reference's
``train_net_unet.py:241-302``) on the port's trainer.

    python -m lic_tpu_torch.cli.train --train_data_path '/data/DIV2K/*.png' \\
        --preset net_unet_ha_hs --lmbda 0.0025 --batch_size 8

It runs on the card unless ``--device cpu`` is given.  Data parallel over
processes: launch it under ``torchrun`` (one process per card), or give
``--coordinator_address host:port``, ``--num_processes`` and
``--process_id`` on every process; each rank then loads
``batch_size / num_processes`` crops a step.  ``--weight_path`` loads a
``.npz`` of either package; at the end the parameters are written to
``<checkpoint_dir>/final.npz`` (rank 0).  ``--post_processing`` builds the
model with the HAN tail and trains the tail alone (phase 2); its
``--weight_path`` load is non-strict, so a base checkpoint without HAN
leaves warm-starts it (the tail keeps its init).
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="lic_tpu_torch trainer")
    p.add_argument("--train_data_path", required=True,
                   help="folder or glob of training images (e.g. DIV2K)")
    p.add_argument("--preset", default="net_unet_ha_hs",
                   help="model preset (see lic_tpu_torch.models.PRESETS); the JAX "
                        "trainer's default")
    p.add_argument("--lmbda", type=float, default=0.0025,
                   help="R-D tradeoff (reference default, train_net_unet.py:273)")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--crop_size", type=int, default=256)
    p.add_argument("--epochs", type=int, default=5000)
    p.add_argument("--steps_per_epoch", type=int, default=100)
    p.add_argument("--checkpoint_dir", default="./ckpt")
    p.add_argument("--weight_path", default="",
                   help="npz params to resume/init from")
    p.add_argument("--high", action="store_true",
                   help="high-rate capacity N=384/M=32")
    p.add_argument("--post_processing", action="store_true",
                   help="train only the HAN post-processing phase")
    p.add_argument("--loss_type", choices=("mse", "msssim"), default="mse")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num_devices", type=int, default=None,
                   help="data-parallel size; must equal the number of processes")
    p.add_argument("--coordinator_address", default=None,
                   help="host:port of process 0 (torchrun's MASTER_ADDR:MASTER_PORT)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="torchrun's WORLD_SIZE")
    p.add_argument("--process_id", type=int, default=None, help="torchrun's RANK")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="run on the card (default) or on the CPU")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    from ..config import TrainConfig
    from ..data import ImageFolderDataset, train_iterator
    from ..models import build_model
    from ..parallel import init_distributed, local_device, wrap_ddp
    from ..training import freeze_partition, train
    from ..utils.checkpoint import load_params, save_params

    device = local_device(cpu=args.device == "cpu")
    rank, world = init_distributed(args.coordinator_address, args.num_processes,
                                   args.process_id, device)
    if args.num_devices is not None and args.num_devices != world:
        raise ValueError(f"--num_devices {args.num_devices} != {world} processes")
    if args.batch_size % world:
        raise ValueError(f"batch {args.batch_size} does not split over {world} processes")

    model = build_model(args.preset, device=device, seed=args.seed, is_high=args.high,
                        post_processing=args.post_processing)
    if args.weight_path:
        # phase-2 warm start: a base checkpoint has no HAN leaves, so the
        # load is non-strict (the tail keeps its init)
        load_params(args.weight_path, model, strict=not args.post_processing)
    if model.cfg.post_processing:  # before the DDP wrap, which takes the trained leaves
        freeze_partition(model, args.post_processing)
    tc = TrainConfig(
        lmbda=args.lmbda, lr=args.lr, batch_size=args.batch_size,
        crop_size=args.crop_size, epochs=args.epochs,
        loss_type=args.loss_type, seed=args.seed,
    )
    ds = ImageFolderDataset(args.train_data_path, crop_size=args.crop_size)
    # each rank draws its own crops: seed + rank keeps the ranks apart
    it = train_iterator(ds, args.batch_size // world, seed=args.seed + rank, device=device)
    try:
        train(
            wrap_ddp(model), it, tc,
            steps_per_epoch=args.steps_per_epoch,
            checkpoint_dir=args.checkpoint_dir if rank == 0 else None,
            post_processing_phase=args.post_processing,
            epochs=args.epochs,
            log_fn=print if rank == 0 else (lambda line: None),
        )
    finally:
        it.close()
    if rank == 0:
        save_params(os.path.join(args.checkpoint_dir, "final.npz"), model)
    if world > 1:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main()
