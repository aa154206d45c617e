"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (sm_90a) into a
shared library with a plain C interface and loaded with ctypes. The
build happens at first use, into `build/openh264_tpu_torch/` beside the
package (git-ignored); the file name carries a hash of the source and
flags, so an edited source rebuilds and an unchanged one loads at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / \
    "openh264_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:16]}.so"


def build(name: str) -> tuple[float, str]:
    """Compiles csrc/<name>.cu unless it is already built. Returns the
    build's seconds (0.0 when cached) and nvcc's output (registers,
    shared memory, spills)."""
    out = _target(name)
    if out.exists():
        return 0.0, "(cached)"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                          str(CSRC / f"{name}.cu")],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{res.stdout}")
    os.replace(tmp, out)
    return time.perf_counter() - t0, res.stdout


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The shared library of csrc/<name>.cu, built first if needed."""
    build(name)
    return ctypes.CDLL(str(_target(name)))
