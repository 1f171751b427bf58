"""Build-at-first-use for the port's native code.

Everything compiles from the checkout's sources into ``build/`` at the
root of the repository (listed in ``.gitignore``), so a fresh checkout
needs nothing but the toolchain: ``nvcc`` for the CUDA kernels, ``g++``
for the host rANS library.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, List, Optional, Sequence

PACKAGE_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PACKAGE_DIR.parent / "build"


def build_if_stale(src: Path, out: Path, cmd: List[str], deps: Sequence[Path] = ()) -> str:
    """Run ``cmd`` (which must write its output to the path in the last
    ``{out}`` placeholder) unless ``out`` is newer than ``src`` and every
    header in ``deps``.  The build
    goes to a temporary name and is renamed into place, so a process that
    races the build never loads a half-written file.  Returns the
    compiler's output (``ptxas`` register and spill lines for ``nvcc``)."""
    newest = max(p.stat().st_mtime for p in (src, *deps))
    if out.exists() and out.stat().st_mtime >= newest:
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}"
    argv = [tmp if a == "{out}" else a for a in cmd]
    try:
        res = subprocess.run(argv, check=True, capture_output=True, text=True)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(
            f"build of {src.name} failed ({' '.join(argv)}):\n{e.stderr}"
        ) from e
    os.replace(tmp, out)
    return res.stdout + res.stderr


class CudaLibrary:
    """A kernel source under ``csrc/``, compiled with ``nvcc`` for
    ``sm_90a`` into ``build/<stem>.so`` (a plain C interface) at first call
    and loaded with ``ctypes``; ``bind`` sets the entry points' argtypes.
    The headers under ``csrc/`` (``*.cuh``) count as its sources too.
    A failed build raises.  ``log`` keeps this process's compiler output
    (``ptxas -v``: registers, shared memory, spills) and ``seconds`` its
    build time."""

    def __init__(self, src_name: str, bind: Callable[[ctypes.CDLL], None]):
        self.src = PACKAGE_DIR / "csrc" / src_name
        self.so = BUILD_DIR / f"{self.src.stem}.so"
        self.log = ""
        self.seconds = 0.0
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def __call__(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
                if not shutil.which(nvcc):
                    raise RuntimeError(f"nvcc not found: {self.src.name} cannot build")
                t0 = time.perf_counter()
                self.log = build_if_stale(self.src, self.so, [
                    nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
                    "-Xcompiler", "-fPIC", "-o", "{out}", str(self.src),
                ], deps=sorted(self.src.parent.glob("*.cuh")))
                self.seconds = time.perf_counter() - t0
                lib = ctypes.CDLL(str(self.so))
                self._bind(lib)
                self._lib = lib
            return self._lib

    def ptxas(self) -> List[str]:
        """Per kernel of this process's build, its ``ptxas`` register count
        and spill line: ``"<kernel>: Used N registers, ... | N bytes stack
        frame, N bytes spill stores, N bytes spill loads"``."""
        out, kernel, spills = [], "?", ""
        for ln in self.log.splitlines():
            if "Compiling entry function" in ln:
                kernel, spills = ln.split("'")[1], ""
            elif "spill stores" in ln:
                spills = ln.strip()
            elif "Used" in ln and "registers" in ln:
                out.append(f"{kernel}: {ln.split(':', 1)[1].strip()} | {spills}")
        return out


def check_cuda_inputs(name: str, x, *others) -> None:
    """What an fp32 kernel's wrapper takes: ``x`` on a CUDA device, and
    every other tensor (None skipped) fp32 or bf16 on the same device (a
    wrapper widens bf16 to fp32 at the kernel boundary).  The gradient is
    each wrapper's ``torch.autograd.Function``."""
    import torch

    if x.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {x.device}")
    ts = [x, *[t for t in others if t is not None]]
    for t in ts:
        if t.dtype not in (torch.float32, torch.bfloat16) or t.device != x.device:
            raise TypeError(f"{name}: fp32 or bf16 tensors on {x.device} only, got "
                            f"{t.dtype} on {t.device}")


def needs_grad(*ts) -> bool:
    """Whether autograd has to differentiate a call on these tensors (None
    skipped): grad mode is on and one of them requires grad."""
    import torch

    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


def check_launch(err: int, name: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
