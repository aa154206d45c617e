"""Build and load the port's CUDA kernels and its host C.

Each `csrc/<name>.cu` is compiled by `nvcc` for Hopper (sm_90a) into a
shared library with a plain C interface and loaded with ctypes. Each
`csrc/<name>.c` is host code, compiled by the host C compiler (`cc`)
and never by nvcc. Builds happen at first use, into
`build/openh264_tpu_torch/` beside the package (git-ignored); the file
name carries a hash of the source, the csrc headers it includes and
the flags, so an edited source or header rebuilds and an unchanged one
loads at once. A failed build raises. SIGNATURES declares the ctypes
signature of every symbol of the host-C libraries, and bind(name) hands
out a library with them declared: a new host-C library is one entry
there.
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
import re
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
_P = ctypes.c_void_p
# host-C library -> its symbols -> (restype, argtypes); the binding
# modules beside the callers (encoder/cbind.py, decoder/cbind.py) pack
# the arguments
SIGNATURES = {
    "host_native": {
        "bitpack": (ctypes.c_size_t,
                    [_P, _P, ctypes.c_size_t, _P, ctypes.c_size_t]),
        "enc_intra_frame": (None, [_P] * 2),
        "recon_intra_mbs": (None, [_P] * 2),
    },
    "parse_cavlc": {"parse_cavlc_slice": (ctypes.c_int, [_P] * 3)},
    "parse_cabac": {"parse_cabac_slice": (ctypes.c_longlong, [_P] * 3)},
    "cabac_residual": {
        "cabac_residual": (ctypes.c_int, [_P, ctypes.c_longlong] + [_P] * 7),
    },
}
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
    text = src.read_bytes()
    headers = b"".join((CSRC / h.decode()).read_bytes() for h in
                       re.findall(rb'^#include "([^"]+)"', text, re.M))
    tag = hashlib.sha256(text + headers + " ".join(flags).encode()
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
    needed; loaded once per process, with the signatures SIGNATURES
    gives its symbols declared."""
    with _lock(name):
        return _load(name)


def bind(name: str) -> ctypes.CDLL:
    """The host-C library csrc/<name>.c of SIGNATURES, its symbols'
    signatures declared (load)."""
    if name not in SIGNATURES:
        raise KeyError(f"csrc/{name}.c has no entry in _build.SIGNATURES")
    return load(name)


@functools.lru_cache(maxsize=None)
def _load(name: str) -> ctypes.CDLL:
    build(name)
    lib = ctypes.CDLL(str(_target(name)))
    for sym, (restype, argtypes) in SIGNATURES.get(name, {}).items():
        fn = getattr(lib, sym)
        fn.restype, fn.argtypes = restype, argtypes
    return lib
