"""Build and load the port's CUDA kernels and its host C.

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (sm_90a) into a
shared library with a plain C interface and loaded with ctypes. Each
`csrc/<name>.c` is host code, compiled by the host C compiler (`cc`)
and never by nvcc. Builds happen at first use, into
`build/openh264_tpu_torch/` beside the package (git-ignored); the file
name carries a hash of the source and flags, so an edited source
rebuilds and an unchanged one loads at once. A failed build raises.
Builds and loads are safe from several threads (simulcast layers and
GOP sessions build at first use): a lock per library serialises its
build and load in a process, so that different libraries may build at
once, and each build writes a temporary file named by process and
thread before it moves the library into place.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / \
    "openh264_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
CC_FLAGS = ["-O3", "-shared", "-fPIC"]
_LOCKS: dict[str, threading.RLock] = {}
_LOCKS_LOCK = threading.Lock()


def _lock(name: str) -> threading.RLock:
    with _LOCKS_LOCK:
        return _LOCKS.setdefault(name, threading.RLock())


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _cc() -> str:
    for cand in (os.environ.get("CC"), "cc", "gcc", "clang"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no host C compiler (cc) found: the port's host C "
                       "(csrc/*.c) cannot be built")


def _source(name: str) -> tuple[Path, list[str]]:
    """The source of `name` and its compiler's flags: csrc/<name>.cu goes
    to nvcc, csrc/<name>.c to the host compiler."""
    cu = CSRC / f"{name}.cu"
    if cu.exists():
        return cu, NVCC_FLAGS
    return CSRC / f"{name}.c", CC_FLAGS


def _target(name: str) -> Path:
    src, flags = _source(name)
    tag = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()
                         ).hexdigest()
    return BUILD_DIR / f"lib{name}-{tag[:16]}.so"


def build(name: str) -> tuple[float, str]:
    """Compiles csrc/<name>.cu (nvcc) or csrc/<name>.c (cc) unless it is
    already built. Returns the build's seconds (0.0 when cached) and the
    compiler's output (for nvcc: registers, shared memory, spills)."""
    with _lock(name):
        out = _target(name)
        if out.exists():
            return 0.0, "(cached)"
        src, flags = _source(name)
        compiler = _nvcc() if src.suffix == ".cu" else _cc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # another process may build the same library at the same time:
        # each writes its own file and the last move wins
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        t0 = time.perf_counter()
        res = subprocess.run([compiler, *flags, "-o", str(tmp), str(src)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{Path(compiler).name} failed for "
                               f"csrc/{src.name}:\n{res.stdout}")
        os.replace(tmp, out)
        return time.perf_counter() - t0, res.stdout


def load(name: str) -> ctypes.CDLL:
    """The shared library of csrc/<name>.cu or .c, built first if
    needed; loaded once per process."""
    with _lock(name):
        return _load(name)


@functools.lru_cache(maxsize=None)
def _load(name: str) -> ctypes.CDLL:
    build(name)
    return ctypes.CDLL(str(_target(name)))
