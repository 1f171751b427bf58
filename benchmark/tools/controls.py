"""The readings the limits of ``correct`` are set from, on the chip.

    python -m benchmark.tools.controls --workload <cell> --seeds 1 2 3 ...

For each seed: the numbers the cell compares, read from the program's
timed path at the cell's own sizes (the program's readings), and from the
control, the plain reference computed in TF32 put in the program's place
(the control's readings; the configurations state fp32 with TF32 off),
each against the reference in float64: the images' numbers and those the
reference class adds (``compared``, with the control as its side).
Prints one line per seed and a JSON summary (per number, the largest
program reading and the smallest control reading).  Runs on a card only.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .. import run
from .. import weights as weights_module


def code_batch(cell: str, seeds, traffic=None):
    from lic_tpu_torch.models.compress import ChannelCoder, set_numerics_flags

    from .. import system
    from ..drivers import code_batch as drv

    spec = run.spec_of()
    c = run.cell_of(spec, cell)
    config, p = run.config_of(spec, c), traffic or run.traffic_of(c)
    dev = torch.device("cuda", 0)
    set_numerics_flags()
    model, rows = None, []
    for seed in seeds:
        weights = system.make_weights(config, seed, dev)
        if model is None:
            model = system.build_program(config, weights, dev)
        else:
            weights_module.load(model, weights)
        coder = ChannelCoder(model, name=config["preset"])
        pool, checked = drv.inputs(p, seed, dev)
        decoded, bits = {}, 0
        with torch.no_grad():
            for i in checked:
                blobs = coder.compress_batch(pool[i])
                bits += 8 * sum(map(len, blobs))
                decoded[i] = coder.decompress_batch(blobs).cpu()
        prog = drv.judge(config, weights, pool, checked, decoded, dev, coder)
        prog["bpp"] = bits / sum(pool[i][:, 0].numel() for i in checked)
        ref = system.build_reference(config, weights, dev, "tf32")
        with torch.no_grad():
            ctrl_out = {i: ref(pool[i])["x_hat"].cpu() for i in checked}
        ctrl = drv.judge(config, weights, pool, checked, ctrl_out, dev, ref)
        del ref
        set_numerics_flags()
        ctrl["bpp"] = prog["bpp"]
        row = {"seed": seed, "program": prog, "control": ctrl}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def train(cell: str, seeds, traffic=None):
    """Per seed: the program's gaps from the reference, the control's (the
    reference in TF32), and the fault of half the batch left out (the
    reference on the first half of each batch, its mean over that half)."""
    import os
    import shutil
    import tempfile

    from .. import train_check
    from ..drivers import train as drv

    spec = run.spec_of()
    c = run.cell_of(spec, cell)
    config, p = run.config_of(spec, c), traffic or run.traffic_of(c)
    dev = torch.device("cuda", 0)
    rows = []
    for seed in seeds:
        folder = tempfile.mkdtemp(prefix="lic_bench_ctl_", dir=os.environ.get("TMPDIR"))
        try:
            step, state, it, weights, pixels, program = drv.first_steps(config, p, seed, dev,
                                                                        folder)
            it.close()
        finally:
            shutil.rmtree(folder, ignore_errors=True)
        program.model = program.optimizer = None
        del step, state
        torch.cuda.empty_cache()
        cands = train_check.candidate_batches(pixels, p, seed, len(program.batches) + 2)
        batches = train_check.match_batches(program.batches, cands)
        lm = float(p["lmbda"])
        ref = train_check.reference_steps(config, weights, batches, seed, lm, dev)
        tf32 = train_check.reference_steps(config, weights, batches, seed, lm, dev, "tf32")
        half = train_check.reference_steps(config, weights, [x[: len(x) // 2] for x in batches],
                                           seed, lm, dev)
        row = {"seed": seed, "program": train_check.gaps(program, ref),
               "control": train_check.gaps(tf32, ref),
               "half_batch": train_check.gaps(half, ref),
               "losses": {"program": program.losses, "reference": ref.losses}}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def serve(cell: str, seeds, traffic=None):
    """Per seed: each size's pool coded and decoded by the program (as the
    service's batches do) and the reference in TF32, against the
    reference."""
    from lic_tpu_torch.models.compress import ChannelCoder, set_numerics_flags

    from .. import system
    from ..drivers import serve_open as drv

    spec = run.spec_of()
    c = run.cell_of(spec, cell)
    config, p = run.config_of(spec, c), traffic or run.traffic_of(c)
    dev = torch.device("cuda", 0)
    set_numerics_flags()
    model, rows = None, []
    for seed in seeds:
        weights = system.make_weights(config, seed, dev)
        if model is None:
            model = system.build_program(config, weights, dev)
        else:
            weights_module.load(model, weights)
        coder = ChannelCoder(model, name=config["preset"])
        pool = drv.make_pool(p, seed, dev)
        sched = [(0.0, "c", s, k) for s in range(len(pool)) for k in range(len(pool[s]))]
        with torch.no_grad():
            decoded = {}
            for s, x in enumerate(pool):
                rec = coder.decompress_batch(coder.compress_batch(x)).cpu()
                for k in range(len(x)):
                    decoded[s * len(pool[0]) + k] = rec[k]
        prog = drv.judge(config, weights, pool, sched, decoded, dev)
        ref = system.build_reference(config, weights, dev, "tf32")
        with torch.no_grad():
            ctl = {}
            for s, x in enumerate(pool):
                out = ref(x)["x_hat"].cpu()
                for k in range(len(x)):
                    ctl[s * len(pool[0]) + k] = out[k]
        del ref
        ctrl = drv.judge(config, weights, pool, sched, ctl, dev)
        set_numerics_flags()
        row = {"seed": seed, "program": prog, "control": ctrl}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    c = run.cell_of(run.spec_of(), args.workload)
    kind = run.traffic_of(c)["driver"]
    rows = {"code_batch": code_batch, "train": train, "serve_open": serve}[kind](
        args.workload, args.seeds)
    keys = rows[0]["program"].keys()
    summary = {k: {"program_max": max(r["program"][k] for r in rows),
                   "control_min": min(r["control"][k] for r in rows)} for k in keys}
    if kind == "train":
        for k in keys:
            summary[k]["half_batch_min"] = min(r["half_batch"][k] for r in rows)
    print(json.dumps({"workload": args.workload, "seeds": len(rows), **summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
