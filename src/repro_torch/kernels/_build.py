"""Build and load the port's CUDA kernels (plain C interface, ``ctypes``).

A source ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` into a
shared library under ``build/repro_torch/`` at the root of the checkout,
named by a hash of the source, the shared headers and the flags, so an
edited source rebuilds and an unchanged one loads straight from the cache.
:func:`build_all` starts one ``nvcc`` per source at once and waits for all.

Only the sources in the repository are compiled; ``nvcc`` is taken from
``PATH`` or ``$CUDA_HOME/bin`` (default ``/usr/local/cuda``).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"

# libraries built or loaded, by source name: each kernel module loads its
# library once (an lru_cache), so a count that moves after warm-up means a
# call paid a build or a load again (the online service's ``online_tick``)
LOAD_COUNTS: collections.Counter = collections.Counter()

# sm_90a keeps Hopper-only instructions available; --fmad=false keeps every
# clock update a single rounded f32 operation, as in the plain version;
# --split-compile=0 optimizes a source's template instances on all cores
# (faas_event_step.cu's 84 in 40 s instead of 87 on an H100 host); -Xptxas
# -v records registers and spills in the build log
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "--split-compile=0",
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
        if p.name == f"{name}.cu" or p.suffix in (".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names) -> dict:
    """Compile each ``csrc/<name>.cu`` whose library is not built yet, one
    ``nvcc`` per source, all started together.

    Returns ``{name: {"path", "seconds", "log"}}``; ``seconds`` is 0.0 and
    ``log`` the cached one for a library already built.  Raises with the
    compiler's output if a build fails.
    """
    out, running = {}, {}
    for name in names:
        target = _target(name)
        log = target.with_suffix(".log")
        if target.is_file():
            out[name] = dict(
                path=target, seconds=0.0, log=log.read_text() if log.is_file() else ""
            )
            continue
        build_dir().mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running[name] = (proc, tmp, target, log, time.perf_counter())
    failed = []
    for name, (proc, tmp, target, log, t0) in running.items():
        text = proc.communicate()[0]
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, target)
        log.write_text(text)
        out[name] = dict(path=target, seconds=secs, log=text)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """Load the library ``name``, built first if it is stale; counted in
    :data:`LOAD_COUNTS`."""
    LOAD_COUNTS[name] += 1
    return ctypes.CDLL(str(build_all([name])[name]["path"]))
