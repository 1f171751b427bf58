"""Probe of kernels B1 (rANS drain) and B2 (GDN) on one GPU: where their
time goes.

    python -m lic_tpu_torch.tools.kernel_probe           # on a GPU host
    python -m lic_tpu_torch.tools.kernel_probe --kernel b2   # B2 only
    python -m lic_tpu_torch.tools.kernel_probe --kernel b1_routes
    python -m lic_tpu_torch.tools.kernel_probe --check   # CPU: sources only

B1: a copy of ``csrc/rans_drain.cu`` with ``clock64`` probes between the
steps of a chunk (thread 0 of stream 0 sums each step's cycles), run on the
escape-heavy stress streams of ``chip_smoke.py`` (B=8, 4 slices of 73,728
symbols) and on the streams of a ``source_net`` B=8 512×768 decode; it
prints each set's kernel-only time (CUDA events, the state copies
included) and cycles per chunk by step.  The probes cost a few cycles each.

B2: a copy of ``csrc/gdn.cu`` without the ``wgmma`` products (``no_mma``:
the products are skipped, the fences and waits kept), timed beside the
kernel at the largest C = 192 shape (786,432 rows) and on the same bytes
at C = 96 (one 96-wide N-tile, so each x tile is read by one CTA).  The
variant's output is wrong by construction; only its time means anything.

B1's table routes (``--kernel b1_routes``): the kernel launched with its
table in shared memory (the route it takes for these streams) and in
device memory, timed on the same streams in the order shared, device,
device, shared (each set's calls threading one decode's state, 5 repeats
a call): the stress streams, a ``source_net`` and an ``entroformer_cb``
B=8 512×768 decode, all at L = 128 on the 64-row table.  Both routes must
give the same bits.

``--check`` builds nothing: it writes the instrumented sources into
``build/probe/`` and fails if a kernel source no longer has the lines the
probes attach to.  ``record_drains`` is also what ``chip_smoke.py`` uses to
capture a real decode's drain calls.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np
import torch

from ..utils.build import BUILD_DIR, PACKAGE_DIR

CSRC = PACKAGE_DIR / "csrc"
PROBE_DIR = BUILD_DIR / "probe"

# step names of B1's chunk, in the order of the probes below
DRAIN_STEPS = [
    "copies+wait", "row", "slot search", "state+ballots", "barrier 1", "exchange 1 + word",
    "offset", "escape: needs+ballots", "escape: barrier 2 + prefix", "escape: word reads",
    "rest+store",
]


def _insert(src: str, anchor: str, probe: str, before: bool = False) -> str:
    if src.count(anchor) != 1:
        raise RuntimeError(f"kernel_probe: anchor not found once in the source: {anchor!r}")
    return src.replace(anchor, probe + anchor if before else anchor + probe)


def instrumented_drain_source() -> str:
    """``rans_drain.cu`` with a probe after each step of a chunk: probe k
    adds the cycles since the previous probe to slot k, and the sums of
    thread 0 of stream 0 land in ``g_probe`` (read by ``probe_read``)."""
    s = (CSRC / "rans_drain.cu").read_text()
    s = _insert(s, "namespace {\n\nconstexpr int kEscPhases",
                "__device__ unsigned long long g_probe[16];\n", before=True)
    s = _insert(s, "  int par_main = 0, par_esc = 0;\n",
                "  unsigned long long pacc[16] = {};\n  long long tp = clock64(), tn;\n"
                "#define PT(k) do { tn = clock64(); pacc[k] += tn - tp; tp = tn; } while (0)\n")
    steps = [
        ("    cp_async_wait_lead();\n", 0),
        ("    const int row = min(max(s_rows[c % kRowSlots][t], 0), nrows - 1);\n", 1),
        ("    const uint32_t freq = static_cast<uint32_t>(c_up1) - start;\n", 2),
        ("    if (lane == 0) s_main[par_main][warp] = __popc(m_need) | (m_esc ? 1 << 16 : 0);\n", 3),
        ("    ptr += total & 0xFFFF;\n", 5),
        ("      const unsigned m_fb = __ballot_sync(0xffffffffu, !exact);\n", 7),
        ("      par_esc ^= 1;\n", 8),
        ("        ptr = base;\n", 9),
        ("    if (valid) orow[idx] = static_cast<int32_t>(value);\n", 10),
    ]
    for anchor, k in steps:
        s = _insert(s, anchor, f"    PT({k});\n")
    s = _insert(s, "    PT(3);\n    __syncthreads();\n", "    PT(4);\n")
    s = _insert(s, "    if (total >> 16) {\n      // exchange 2", "    PT(6);\n", before=True)
    s = _insert(s, "  cp_async_wait_all();\n",
                "  if (blockIdx.x == 0 && threadIdx.x == 0)\n"
                "    for (int k = 0; k < 16; ++k) g_probe[k] = pacc[k];\n")
    return s + (
        '\nextern "C" int probe_read(unsigned long long* out) {\n'
        "  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(g_probe));\n}\n"
    )


def gdn_variant_source(variant: str) -> str:
    """``gdn.cu`` as it is (``kernel``) or without its products (``no_mma``:
    each chunk's A values summed into one accumulator instead, so the loads
    and splits stay)."""
    s = (CSRC / "gdn.cu").read_text()
    if variant == "no_mma":
        # the products' loop never runs; the fences, commit and wait stay
        s = _insert(s, "#pragma unroll\n      for (int j = 0; j < 4; ++j) {\n"
                    "        wgmma_n96(part, ahi[j]",
                    "#pragma unroll\n      for (int j = 0; j < 4; ++j)\n#pragma unroll\n"
                    "        for (int i = 0; i < 4; ++i)\n"
                    "          part[4 * j + i] = __uint_as_float(ahi[j][i]) + "
                    "__uint_as_float(alo[j][i]);\n      if (0)\n", before=True)
    elif variant != "kernel":
        raise ValueError(f"kernel_probe: no gdn variant {variant!r}")
    return s


def _write_sources() -> Dict[str, Path]:
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    out = {"drain_probe": instrumented_drain_source()}
    for v in ("kernel", "no_mma"):
        out[f"gdn_{v}"] = gdn_variant_source(v)
    paths = {}
    for name, text in out.items():
        p = PROBE_DIR / f"{name}.cu"
        p.write_text(text)
        paths[name] = p
    return paths


def _build(src: Path) -> ctypes.CDLL:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    so = src.with_suffix(".so")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC), "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True)
    return ctypes.CDLL(str(so))


def record_drains(coder, blobs) -> List[tuple]:
    """The drain calls of one ``coder.decompress_batch(blobs)``: [(device
    coder, lanes in, payload, rows, s_tot)], recorded by a stand-in for the
    codec module's ``rans_drain`` that calls the real one."""
    from ..coding import DeviceIState
    from ..models import compress as compress_mod

    calls, real = [], compress_mod.rans_drain

    def record(dev, lanes, payload, rows, s_tot):
        calls.append((dev, DeviceIState(lanes.state.clone(), lanes.ptr.clone()), payload,
                      rows.clone(), s_tot))
        return real(dev, lanes, payload, rows, s_tot)

    compress_mod.rans_drain = record
    try:
        coder.decompress_batch(blobs)
    finally:
        compress_mod.rans_drain = real
    return calls


def _cuda_ms(fn: Callable, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _drain_sets(dev, presets=("source_net",)) -> Dict[str, list]:
    from .. import coding
    from ..data import smooth_images
    from ..models import build_model
    from ..models.compress import ChannelCoder, set_numerics_flags

    set_numerics_flags()
    g = coding.GaussianCoder()
    ddev = coding.DeviceRans16Interleaved(g.codec.cdfs, g.codec.offsets, 128, device=dev)
    s_slice = 73728
    _, idx, pay, _ = coding.random_streams(g.codec.cdfs, g.codec.offsets,
                                           [(i, True) for i in range(8)], [s_slice] * 4, 128)
    payt = torch.from_numpy(pay).to(dev)
    stress, lanes = [], ddev.init_lanes(payt)
    for i in range(4):
        rows = torch.from_numpy(idx[:, i * s_slice:(i + 1) * s_slice].copy()).to(dev)
        stress.append((ddev, lanes, payt, rows, s_slice))
        lanes, _ = coding.drain_plain(ddev, lanes, payt, rows, s_slice)
    x = torch.from_numpy(smooth_images(np.random.default_rng(0), 8, 512, 768)).to(dev)
    x = x.contiguous(memory_format=torch.channels_last)
    sets = {"stress": stress}
    for preset in presets:
        model = build_model(preset, device=dev, seed=0)
        coder = ChannelCoder(model, name=preset)
        sets[f"{preset} decode"] = record_drains(coder, coder.compress_batch(x))
        del model, coder
    return sets


def _raw_drain(lib, call, dev, route=None):
    """A launch of ``lib``'s ``rans_drain_launch`` on one recorded drain
    call, on copies of its lane state, on ``route`` (0 shared memory, 1
    device memory; default: the coder's own).  → (run, (out, state, ptr))."""
    from ..coding.drain import ROUTES, _slot_index_on
    from ..coding.drain import route as table_route

    ddev, lanes, payt, rows, s_tot = call
    if route is None:
        route = ROUTES.index(table_route(ddev))
    st = lanes.state
    state = torch.where(st >= 1 << 31, st - (1 << 32), st).to(torch.int32)
    ptr = lanes.ptr.to(torch.int32)
    out = torch.zeros(rows.shape, dtype=torch.int32, device=dev)
    s2, p2 = state.clone(), ptr.clone()
    sidx = _slot_index_on(ddev)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        s2.copy_(state)
        p2.copy_(ptr)
        err = lib.rans_drain_launch(
            rows.data_ptr(), payt.data_ptr(), s2.data_ptr(), p2.data_ptr(),
            out.data_ptr(), ddev.cdf_rows.data_ptr(), ddev.offsets.data_ptr(),
            sidx.data_ptr(), rows.shape[0], rows.shape[1], s_tot, payt.shape[1],
            ddev.n_lanes, ddev.rows, ddev.row_len, route, stream)
        if err:
            raise RuntimeError(f"drain probe launch failed: {err}")

    return run, (out, s2, p2)


def probe_routes(dev) -> None:
    from ..coding import drain

    routes = {"shared": 0, "global": 1}
    for name, calls in _drain_sets(dev, ("source_net", "entroformer_cb")).items():
        ms = {r: [] for r in routes}
        outs = {}
        for r in ("shared", "global", "global", "shared"):
            total, res = 0.0, []
            for call in calls:
                run, out = _raw_drain(drain.library(), call, dev, routes[r])
                total += _cuda_ms(run, 5)
                res.append(out)
            ms[r].append(total)
            if r not in outs:
                outs[r] = res
        for a, b in zip(outs["shared"], outs["global"]):
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(f"b1 routes: the two routes differ on {name}")
        sh, gl = sum(ms["shared"]) / 2, sum(ms["global"]) / 2
        print(f"[b1_routes] streams={name!r} calls={len(calls)} lanes={calls[0][0].n_lanes} "
              f"table_rows={calls[0][0].rows} symbols={sum(c[4] for c in calls)} "
              f"shared_ms={ms['shared'][0]:.4f},{ms['shared'][1]:.4f} "
              f"global_ms={ms['global'][0]:.4f},{ms['global'][1]:.4f} "
              f"global_over_shared={gl / sh:.4f}", flush=True)


def probe_drain(dev) -> None:
    lib = _build(PROBE_DIR / "drain_probe.cu")
    lib.rans_drain_launch.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    for name, calls in _drain_sets(dev).items():
        ms, cycles, chunks = 0.0, np.zeros(16), 0
        for call in calls:
            ddev, s_tot = call[0], call[4]
            run, _ = _raw_drain(lib, call, dev)
            ms += _cuda_ms(run, 5)
            buf = (ctypes.c_ulonglong * 16)()
            lib.probe_read(buf)
            cycles += np.array(list(buf), dtype=np.float64)
            chunks += -(-s_tot // ddev.n_lanes)
        per = cycles[: len(DRAIN_STEPS)] / chunks
        print(f"[b1_probe] streams={name!r} kernel_ms={ms:.4f} chunks_per_stream={chunks} "
              f"cycles_per_chunk={per.sum():.1f} "
              + " ".join(f"{k.replace(' ', '_')}={v:.1f}" for k, v in zip(DRAIN_STEPS, per)),
              flush=True)


def probe_gdn(dev) -> None:
    g = torch.Generator().manual_seed(0)
    x = torch.randn(786432, 192, generator=g).to(dev)
    y = torch.empty_like(x)
    shapes = {}
    for c in (192, 96):
        gamma = (0.1 * torch.eye(c) + 0.01 * torch.rand(c, c, generator=g)).to(dev)
        beta = (1.0 + torch.rand(c, generator=g)).to(dev)
        shapes[c] = (x.numel() // c, gamma, beta)
    stream = torch.cuda.current_stream().cuda_stream
    for v in ("kernel", "no_mma"):
        lib = _build(PROBE_DIR / f"gdn_{v}.cu")
        lib.gdn_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        times = {}
        for c, (rows, gamma, beta) in shapes.items():
            def run():
                err = lib.gdn_launch(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                                     y.data_ptr(), rows, c, 0, 0, stream)
                if err:
                    raise RuntimeError(f"gdn probe launch failed: {err}")
            times[c] = _cuda_ms(run, 20)
        print(f"[b2_probe] variant={v} C192_786432_rows_ms={times[192]:.4f} "
              f"C96_1572864_rows_ms={times[96]:.4f}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--check", action="store_true",
                    help="write the instrumented sources and stop (no GPU needed)")
    ap.add_argument("--kernel", choices=("b1", "b1_routes", "b2", "both"), default="both")
    args = ap.parse_args()
    paths = _write_sources()
    if args.check:
        print("kernel_probe: sources written: " + ", ".join(p.name for p in paths.values()))
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("kernel_probe: needs a CUDA device (or --check)")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    if args.kernel in ("b1", "both"):
        probe_drain(dev)
    if args.kernel in ("b2", "both"):
        probe_gdn(dev)
    if args.kernel == "b1_routes":
        probe_routes(dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
