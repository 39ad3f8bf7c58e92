"""Build the CUDA sources of ``csrc/`` into shared libraries, at first use.

Each source is compiled by nvcc alone into a shared library with a plain C
interface, which ``ctypes`` loads; nothing includes PyTorch's headers, so a
build takes seconds. The library file name carries a hash of the source,
of every header of ``csrc/`` and of the flags, so a stale build is never
loaded, not even after a change to a shared header. Libraries go to ``_build/``
inside the package (listed in .gitignore).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

# sm_90a keeps Hopper's wgmma/setmaxnreg available to later kernels.
# --fmad=false: no FMA contraction, so every product and sum rounds as in
# the plain PyTorch versions and the two agree bit for bit. -Xptxas -v
# reports registers and spills in the build log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class BuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def find_nvcc() -> str:
    for candidate in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if candidate and os.path.exists(candidate):
            return candidate
    raise BuildError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives: the name
    hashes the source, every ``csrc/*.cuh`` (name and bytes) and the flags."""
    digest = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{Path(source).stem}_{digest.hexdigest()[:16]}.so"


def build(source: str, rebuild: bool = False) -> tuple[Path, float, str]:
    """Compile ``csrc/<source>`` unless its library exists.

    Returns (library path, seconds spent compiling, nvcc's log). With
    ``rebuild`` the library is compiled even if it exists.
    """
    out = library_path(source)
    if out.exists() and not rebuild:
        return out, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    start = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - start
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise BuildError(
            f"nvcc failed on {source} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a reader never sees half a library
    return out, seconds, proc.stdout + proc.stderr


def build_all(sources, rebuild: bool = False) -> dict:
    """``build`` of every source at once, one nvcc process each, all
    started together. Returns {source: build's result}."""
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        futures = {s: pool.submit(build, s, rebuild) for s in sources}
        return {s: f.result() for s, f in futures.items()}


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<source>``."""
    path, _, _ = build(source)
    return ctypes.CDLL(str(path))
