"""Build-at-first-use for the port's native code.

Everything compiles from the checkout's sources into ``build/`` at the
root of the repository (listed in ``.gitignore``), so a fresh checkout
needs nothing but the toolchain: ``nvcc`` for the CUDA kernels, ``g++``
for the host rANS library.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path
from typing import List

PACKAGE_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PACKAGE_DIR.parent / "build"


def build_if_stale(src: Path, out: Path, cmd: List[str]) -> str:
    """Run ``cmd`` (which must write its output to the path in the last
    ``{out}`` placeholder) unless ``out`` is newer than ``src``.  The build
    goes to a temporary name and is renamed into place, so a process that
    races the build never loads a half-written file.  Returns the
    compiler's output (``ptxas`` register and spill lines for ``nvcc``)."""
    if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
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
