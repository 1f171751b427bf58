"""Data parallel against one process: the gradient of one training loss,
split over ``--world`` processes with DDP, against the single-process
gradient of the whole batch.

    python -m lic_tpu_torch.tools.ddp_check [--world 4] [--preset source_net]
        [--batch 8] [--size 256] [--device cuda|cpu] [--n_override N]

Each rank takes its contiguous share of one seeded batch of
``smooth_images`` and its share of the same global noise draws (the
EntropyBottleneck's along its B·H·W axis, each slice's along the batch),
runs the training forward, ``loss + aux`` backward through DDP (NCCL on
the cards, one per rank; gloo on the CPU), twice on the same batch and
noise (DDP's second step is where a parameter that takes no gradient
would stop it: ``net_unet_ha_hs_1``'s syntax model), and sends rank 0's
averaged gradients of the second back.  The parent process then
computes the gradient of the whole batch in one process (on the first
card, or the CPU) and prints, per parameter group, the largest
difference as a share of the gradient's range, and the ranks' backward
times.  It exits 1 above ``--tol``.  The process group takes
``localhost`` and a free port: nothing here looks for a cluster.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import socket
import sys
import time
from typing import Dict, Tuple

import numpy as np
import torch


def shard_noise(world: int, rank: int):
    """A ``noise_fn`` that draws the i-th global noise tensor from a
    generator seeded ``100 + i`` and hands this rank its share."""
    calls = []

    def draw(shape, dtype, device):
        g = torch.Generator().manual_seed(100 + len(calls))
        calls.append(tuple(shape))
        if len(shape) == 3:  # (C, 1, N): the EntropyBottleneck's channel-major z
            n = shape[2]
            full = torch.rand((shape[0], 1, n * world), generator=g) - 0.5
            out = full[:, :, rank * n : (rank + 1) * n]
        else:  # a slice, NCHW
            b = shape[0]
            out = (torch.rand((b * world, *shape[1:]), generator=g) - 0.5)[rank * b : (rank + 1) * b]
        return out.to(device=device, dtype=dtype).contiguous()

    return draw


def local_grads(args, world: int, rank: int, device) -> Tuple[Dict[str, np.ndarray], float]:
    """``loss + aux`` gradients of this rank's share, through DDP when
    ``world`` > 1, the second of two backwards; → ({parameter
    name: gradient} (DDP's average over ranks) for every parameter that
    took one, the second backward's ms)."""
    from ..data import smooth_images
    from ..models import build_model
    from ..models.compress import set_numerics_flags
    from ..parallel import shard_batch, wrap_ddp
    from ..training.loss import rate_distortion_loss

    set_numerics_flags()
    over = {"n_override": args.n_override} if args.n_override else {}
    model = build_model(args.preset, device=device, seed=0, **over).train()
    x = torch.from_numpy(smooth_images(np.random.default_rng(1), args.batch, args.size, args.size))
    x = shard_batch(x, rank, world).to(device).contiguous(memory_format=torch.channels_last)
    net = wrap_ddp(model)
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        out = net(x, training=True, noise_fn=shard_noise(world, rank))
        loss = rate_distortion_loss(out.bpp, out.mse, 0.0025) + model.entropy_aux_loss()
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss.backward()
        if device.type == "cuda":
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    return {n: p.grad.detach().cpu().numpy() for n, p in model.named_parameters()
            if p.grad is not None}, ms


def _worker(args, world, rank, port, q):
    import torch.distributed as dist

    from ..parallel import init_distributed

    device = torch.device("cuda", rank) if args.device == "cuda" else torch.device("cpu")
    try:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:
            torch.set_num_threads(1)
        init_distributed(f"localhost:{port}", world, rank, device=device)
        grads, ms = local_grads(args, world, rank, device)
        q.put((rank, grads if rank == 0 else None, ms, None))
    except Exception as e:  # noqa: BLE001 — reported to the parent, which fails
        q.put((rank, None, None, repr(e)))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run(args) -> dict:
    """Spawn the ranks, collect rank 0's gradients, compare them with the
    single-process gradient.  → the report (also printed as JSON)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(args, args.world, r, port, q))
             for r in range(args.world)]
    for p in procs:
        p.start()
    try:
        results = [q.get(timeout=args.timeout) for _ in procs]
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
    errors = [e for *_, e in results if e]
    if errors:
        raise RuntimeError(f"a rank failed: {errors}")
    got = next(g for r, g, _, _ in results if r == 0)
    device = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    ref, ref_ms = local_grads(args, 1, 0, device)
    if set(got) != set(ref):
        raise RuntimeError(f"DDP and one process differ in which parameters took a "
                           f"gradient: {sorted(set(got) ^ set(ref))[:5]}")
    worst = {}
    for name, r in ref.items():
        share = float(np.abs(got[name] - r).max() / max(float(np.abs(r).max()), 1e-30))
        group = name.split(".")[0]
        worst[group] = max(worst.get(group, 0.0), share)
    report = {
        "preset": args.preset, "world": args.world, "batch": args.batch, "size": args.size,
        "params_with_gradient": len(ref),
        "device": args.device, "backend": "nccl" if args.device == "cuda" else "gloo",
        "max_share_of_range": max(worst.values()), "by_module": worst,
        "rank_backward_ms": sorted(ms for _, _, ms, _ in results),
        "single_process_backward_ms": ref_ms,
    }
    if args.device == "cuda":
        report["card"] = torch.cuda.get_device_name(0)
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--world", type=int, default=4)
    p.add_argument("--preset", default="source_net")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", type=int, default=256)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--n_override", type=int, default=None)
    p.add_argument("--tol", type=float, default=1e-4)
    p.add_argument("--timeout", type=float, default=600.0)
    args = p.parse_args(argv)
    if args.device == "cuda" and torch.cuda.device_count() < args.world:
        print(f"ddp_check: {args.world} cards asked for, {torch.cuda.device_count()} found",
              file=sys.stderr)
        return 2
    report = run(args)
    print(json.dumps(report), flush=True)
    return 0 if report["max_share_of_range"] <= args.tol else 1


if __name__ == "__main__":
    sys.exit(main())
