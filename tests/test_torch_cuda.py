"""The port's CUDA kernels: their contract on the CPU, and their
equality with the plain PyTorch versions on a GPU.

This file imports nothing of JAX, so the card's tests also run on a
machine without it:

    python -m pytest -m cuda --noconftest tests/test_torch_cuda.py
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from openh264_tpu_torch.encoder import deblock_cuda as dc
from openh264_tpu_torch.encoder import deblock_torch as dt
from openh264_tpu_torch.tables import ALPHA_TABLE, BETA_TABLE, TC0_TABLE

CSRC = Path(dc.__file__).resolve().parent.parent / "csrc"


def _inputs(mbw, mbh, seed, blocky=False):
    """Planes (uniform random, or flat MBs a few levels apart plus noise,
    whose edges the filter acts on), bS 0-4 and QP 18-41."""
    rng = np.random.default_rng(seed)

    def plane(size):
        if not blocky:
            return rng.integers(0, 256, (size * mbh, size * mbw), np.uint8)
        base = rng.integers(80, 120, (mbh, mbw)).repeat(size, 0).repeat(
            size, 1)
        return (base + rng.integers(-3, 4, base.shape)).astype(np.uint8)
    return [torch.from_numpy(a) for a in (
        plane(16), plane(8), plane(8),
        rng.integers(0, 5, (mbh * 4, mbw * 4), np.int32),
        rng.integers(0, 5, (mbh * 4, mbw * 4), np.int32),
        rng.integers(18, 42, mbw * mbh, np.int32),
        rng.integers(18, 42, mbw * mbh, np.int32))]


def test_cuda_source_tables_match():
    """The kernel's __constant__ tables equal the package's tables."""
    src = (CSRC / "deblock.cu").read_text()

    def table(name):
        m = re.search(name + r"(?:\[\d+\])+ = \{(.*?)\};", src, re.S)
        return [int(x) for x in re.findall(r"\d+", m.group(1))]

    assert table("kAlpha") == list(ALPHA_TABLE)
    assert table("kBeta") == list(BETA_TABLE)
    assert table("kTc0") == list(np.asarray(TC0_TABLE).reshape(-1))


def test_entry_point_declares_pointer_types(monkeypatch):
    """Pointers (the 7 tensors and the progress scratch) and the stream
    must go through ctypes as void*: with the default int argument type
    they would be cut to 32 bits."""
    import ctypes

    class FakeLib:
        deblock_frame = ctypes.CDLL(None).labs

    monkeypatch.setattr(dc._build, "load", lambda name: FakeLib)
    dc._kernel.cache_clear()
    try:
        fn = dc._kernel()
        assert fn.argtypes == [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 \
            + [ctypes.c_void_p]
        assert fn.restype is ctypes.c_int
    finally:
        dc._kernel.cache_clear()


def test_wrapper_rejects_cpu_tensors():
    """The wrapper takes CUDA tensors only: it never runs the plain
    version in the kernel's place."""
    n0 = dc.launches
    with pytest.raises(ValueError):
        dc.deblock_frame_cuda(*_inputs(6, 5, 0), 6, 5)
    assert dc.launches == n0


def test_auto_dispatch_on_cpu_is_plain():
    args = _inputs(6, 5, 1, blocky=True)
    n0 = dc.launches
    got = dt.deblock_frame_auto(*args, 6, 5)
    want = dt.deblock_frame_device(*args, 6, 5)
    assert dc.launches == n0
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("mbw,mbh,seed,blocky",
                         [(6, 5, 0, False), (4, 7, 1, False),
                          (9, 3, 2, False), (1, 3, 4, True),
                          (6, 5, 5, True), (80, 45, 3, True),
                          (1, 1, 8, True), (2, 300, 9, True),
                          (120, 68, 10, True)])
def test_cuda_kernel_matches_plain(mbw, mbh, seed, blocky):
    """(2, 300) has more MB rows than the card has SMs: blocks take
    several rows by ticket. (120, 68) is the 1080p grid."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = [a.cuda() for a in _inputs(mbw, mbh, seed, blocky)]
    before = [a.clone() for a in args]
    want = dt.deblock_frame_device(*args, mbw, mbh)
    n0 = dc.launches
    got = dc.deblock_frame_cuda(*args, mbw, mbh)
    torch.cuda.synchronize()
    assert dc.launches == n0 + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for g, a in zip(got, args[:3]):      # planes filtered in place
        assert g.data_ptr() == a.data_ptr()
    for a, b in zip(args[3:], before[3:]):   # bS and QP only read
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_kernel_repeats_exactly():
    """50 runs on one 80x45 input, each on fresh clones, all equal to the
    plain version: a fault in the progress counters would show only now
    and then."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = [a.cuda() for a in _inputs(80, 45, 11, blocky=True)]
    want = dt.deblock_frame_device(*args, 80, 45)
    for _ in range(50):
        got = dc.deblock_frame_cuda(*[a.clone() for a in args[:3]],
                                    *args[3:], 80, 45)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_misaligned_planes():
    """The kernel reads whole MB lines (16 bytes of luma, 8 of chroma):
    a plane that starts off that alignment is refused, not launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    args = [a.cuda() for a in _inputs(6, 5, 12)]
    n0 = dc.launches
    y = torch.empty(args[0].numel() + 8, dtype=torch.uint8,
                    device="cuda")[8:].view(args[0].shape)
    with pytest.raises(ValueError):
        dc.deblock_frame_cuda(y, *args[1:], 6, 5)
    assert dc.launches == n0
