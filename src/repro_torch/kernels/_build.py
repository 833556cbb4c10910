"""Build and load the port's CUDA kernels (plain C interface, ``ctypes``).

A source ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` into a
shared library under ``build/repro_torch/`` at the root of the checkout,
named by a hash of the sources and flags so an edited source rebuilds and
an unchanged one loads straight from the cache.

Only the sources in the repository are compiled; ``nvcc`` is taken from
``PATH`` or ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"

# sm_90a keeps Hopper-only instructions available; --fmad=false keeps every
# clock update a single rounded f32 operation, as in the plain version;
# -Xptxas -v records registers and spills in the build log
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def build_dir() -> Path:
    """``build/repro_torch`` at the root of the checkout holding this package."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or in $CUDA_HOME/bin "
        f"(CUDA_HOME={home}); the CUDA kernels are built with the CUDA "
        "toolkit on the machine that has the GPU"
    )


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` unless its library is already built.

    Returns ``{"path", "seconds", "log"}``; ``seconds`` is 0.0 and ``log``
    the cached one for a library already built.  Raises with the
    compiler's output if the build fails.
    """
    target = _target(name)
    log = target.with_suffix(".log")
    if target.is_file():
        return dict(path=target, seconds=0.0, log=log.read_text() if log.is_file() else "")
    build_dir().mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, target)
    log.write_text(proc.stdout)
    return dict(path=target, seconds=secs, log=proc.stdout)


def load(name: str) -> ctypes.CDLL:
    """Load the library ``name``, built first if it is stale."""
    return ctypes.CDLL(str(build(name)["path"]))
