"""Build native sources into shared libraries on first use.

The CUDA kernels in ``csrc/`` go through ``nvcc`` into a shared library with
a plain C interface, loaded with ``ctypes``; the host-side golden verifier
(``native/golden.cpp``) goes through ``g++`` the same way. Nothing is built
when the package is imported: only a CUDA launch (or a native golden check)
asks for a build.

Outputs land in ``build/stencil_tpu_torch/`` beside the package, named by a
hash of the sources, the compiler and the flags, so a changed source or flag
builds anew and an unchanged one loads the cached library. A build writes
to a temporary name and renames it into place, so concurrent builds do not
see a half-written library.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Sequence

PACKAGE_DIR = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE_DIR.parent / "build" / "stencil_tpu_torch"

# sm_90a (Hopper with its arch-specific features); -fmad=false keeps every
# a*b+c as a separate multiply and add, so the kernel rounds exactly as
# the eager torch version does
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-fmad=false",
    "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


class BuildError(RuntimeError):
    """A compiler is missing or rejected a source; the message holds the
    command and the compiler's stderr."""


@dataclasses.dataclass(frozen=True)
class BuildResult:
    path: Path
    seconds: float     # compile time of this call; 0.0 for a cached library
    log: str           # compiler stderr (ptxas register/shared-memory report)
    cached: bool


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, under ``$CUDA_HOME/bin`` or under
    ``/usr/local/cuda/bin``. Raises :class:`BuildError` when absent."""
    candidates = [shutil.which("nvcc")]
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home:
        candidates.append(str(Path(cuda_home) / "bin" / "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise BuildError(
        "nvcc not found (looked on PATH, $CUDA_HOME/bin and "
        "/usr/local/cuda/bin); the CUDA kernels need the CUDA toolkit")


def build(compiler: str, sources: Sequence[Path], flags: Sequence[str],
          name: str, headers: Sequence[Path] = ()) -> BuildResult:
    """Compile ``sources`` into ``BUILD_DIR/lib<name>-<hash>.so``, or return
    the cached library. ``headers`` are the files the sources include: they
    enter the hash, not the command line. Raises :class:`BuildError` on
    failure."""
    h = hashlib.sha256()
    h.update(compiler.encode())
    h.update("\0".join(flags).encode())
    for src in (*sources, *headers):
        h.update(Path(src).read_bytes())
    target = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    if target.exists():
        return BuildResult(target, 0.0, "", True)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = [compiler, *flags, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=900)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise BuildError(f"{' '.join(cmd)} could not run: {e}") from e
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(f"{' '.join(cmd)} failed with exit code "
                         f"{proc.returncode}:\n{proc.stderr}")
    os.replace(tmp, target)
    return BuildResult(target, seconds, proc.stderr, False)
