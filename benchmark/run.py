"""Run one cell of the benchmark and print its result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration and its traffic
mix are found by name: the cell in ``BENCHMARK.json``, the configuration
in ``benchmark/configs/<config>.json`` (its ``file`` there), the mix in
``benchmark/traffic/<traffic>.json``, whose ``driver`` names the module
of ``benchmark/drivers/`` that runs it.  ``--trace 0`` prints the cell's
end-to-end metrics; ``--trace 1`` runs the same window with the
benchmark's spans on, profiles a short stretch after it, and prints the
cell's per-layer metrics, each read by ``benchmark/layer_metrics/<name>.py``.
Either way the run checks what the timed path produced against the plain
reference (``benchmark/reference``) once the window has closed, prints
each number compared beside its limit as the last lines of standard
error, and prints one JSON line last on standard output.

Exits 2 without a result where CUDA is missing or has fewer cards than
the cell asks for, and 3 where a module of JAX or of the JAX package is
loaded once the window has closed.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "lic_tpu")


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module of the benchmark by file path (file names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def spec_of(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def cell_of(spec: dict, name: str) -> dict:
    cells = [w for w in spec["workloads"] if w["name"] == name]
    if not cells:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    return cells[0]


def config_of(spec: dict, cell: dict, root: str = ROOT) -> dict:
    entry = [c for c in spec["configs"] if c["name"] == cell["config"]][0]
    return _load_json(os.path.join(root, entry["file"]))


def traffic_of(cell: dict) -> dict:
    return _load_json(os.path.join(BENCH_DIR, "traffic", f"{cell['traffic']}.json"))


def metrics_of(spec: dict, cell: dict, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics, or its per-layer metrics: those that
    list the cell, and those without a list that move an end-to-end metric
    the cell reports."""
    e2e = [m for m in spec["end_to_end"] if cell["name"] in m.get("workloads", [cell["name"]])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell["name"] in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in names)]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


class Context:
    """What a driver gets: the run's arguments, its configuration and mix,
    the device, the span recorder, and the harness's window and profiler
    hooks."""

    def __init__(self, args, cell: dict, config: dict, traffic: dict, device):
        from .spans import Recorder

        self.cell, self.config, self.traffic, self.device = cell, config, traffic, device
        self.seed, self.seconds, self.trace = args.seed, args.seconds, bool(args.trace)
        self.record = Recorder(self.trace)
        self.setup_s: Optional[float] = None
        self.extra: Dict[str, object] = {}

    def window_start(self) -> None:
        """Set-up ends here: loading, weights, inputs, warm-up."""
        self.setup_s = time.perf_counter() - _T0

    def profile(self, fn: Callable[[], object]) -> None:
        """Run ``fn`` under ``torch.profiler`` and keep the traced
        stretch's busy and window seconds and its breakdown."""
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        from .trace import read_trace, summarize

        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        with profile(activities=acts) as prof:
            with record_function("bench.traced"):
                torch.cuda.synchronize()
                fn()
                torch.cuda.synchronize()
        tmp = os.environ.get("TMPDIR") or ROOT
        path = os.path.join(tmp, f"bench_trace_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        events = read_trace(path)
        span = [e for e in events if e.get("name") == "bench.traced" and e.get("ph") == "X"]
        t0 = float(span[0]["ts"])
        self.record.device = summarize(events, t0, t0 + float(span[0]["dur"]))


def parse(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(args, device, traffic: Optional[dict] = None) -> dict:
    """Everything of a run after the look for a chip: the driver's window
    and check, then the result line's object (``checks`` last).
    ``traffic`` replaces the cell's mix (the CPU tests run small ones)."""
    import torch

    spec = spec_of()
    cell = cell_of(spec, args.workload)
    config = config_of(spec, cell)
    traffic = traffic or traffic_of(cell)
    driver = load_module(os.path.join(BENCH_DIR, "drivers", f"{traffic['driver']}.py"),
                         f"benchmark.drivers.{traffic['driver']}")
    ctx = Context(args, cell, config, traffic, device)
    out = driver.run(ctx)

    values: Dict[str, Dict[str, object]] = {}
    for m in metrics_of(spec, cell, ctx.trace):
        if ctx.trace:
            reader = load_module(os.path.join(BENCH_DIR, "layer_metrics", f"{m['name']}.py"),
                                 f"benchmark.layer_metrics.{m['name']}")
            v = reader.read(ctx.record)
        elif m["name"] == "setup_s":
            v = ctx.setup_s
        else:
            v = out["e2e"][m["name"]]
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    checks = out["checks"]
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else str(device)
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": kind,
                   "count": int(cell["chips"]), "memory_peak_bytes": int(out["memory_peak_bytes"])}
    result = {"correct": bool(checks) and all(c["ok"] for c in checks),
              "attempted": int(out["attempted"]), "failed": int(out["failed"]),
              "metrics": values, "device": device_info}
    if ctx.trace and ctx.record.device:
        dev = ctx.record.device
        device_info.update(busy_s=dev["busy_s"], window_s=dev["window_s"])
        result["breakdown"] = {"device_ops": dev["device_ops"], "idle_gaps": dev["idle_gaps"]}
    if ctx.extra:
        result["readings"] = ctx.extra
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    result["_checks"] = checks
    return result


def main(argv: Optional[List[str]] = None) -> int:
    args = parse(argv)
    cell = cell_of(spec_of(), args.workload)
    # every build and kernel cache inside the checkout, at fixed paths
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", sub)
    os.environ["USE_FLAX"] = "0"

    import torch

    # one intra-op thread: the host work of a window is the program's own
    # thread pools (rANS, input pipeline), which torch's threads only crowd
    torch.set_num_threads(1)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < int(cell["chips"]):
        print(f"benchmark: the cell needs {cell['chips']} CUDA device(s); {have} available",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = execute(args, device)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: JAX or the JAX package was loaded: {bad}", file=sys.stderr)
        return 3
    for c in result.pop("_checks"):
        print(f"check {c['name']}: {c['value']:.6g} limit {c['limit']:.6g} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
