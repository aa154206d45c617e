"""Wrapper of the Hopper deblock kernel (csrc/deblock.cu).

Replaces the TPU kernel openh264_tpu/encoder/deblock_pallas.py
(deblock_frame_pallas). The kernel filters one frame in one persistent
launch on the current stream: blocks take MB rows by an atomic ticket,
and row y filters MB x once row y-1 has finished MB x+1, read from
per-row progress counters in a zeroed int32 scratch that this wrapper
allocates. What bounds it on the card is the latency of that chain of
mb_w + 2*(mb_h-1) dependent MB steps, not the ~3.3 MB it moves; see the
note at the top of the CUDA source. Its plain version is
deblock_torch.deblock_frame_device.

The wrapper checks its inputs and raises on anything the kernel does
not take; it never falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch

from .. import _build

# calls that launched the kernel: one per deblocked frame, and each call
# is one kernel launch; counted under a lock, since simulcast layers and
# GOP sessions launch from several threads
launches = 0
_launches_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point, with its argument types declared: pointers and
    the stream as void*, so that ctypes does not cut them to 32 bits."""
    fn = _build.load("deblock").deblock_frame
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 2 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(t, name, dtype, shape, device, align=4):
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got "
                         f"{t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: expected a {align}-byte aligned tensor")


def deblock_frame_cuda(y, u, v, BSV, BSH, qp_mb, cqp_mb,
                       mb_w: int, mb_h: int, alpha_off=None, beta_off=None):
    """Computes what deblock_torch.deblock_frame_device computes, but
    filters the planes IN PLACE (no copies) and returns them, (y, u, v).
    The session hands it fresh pre-deblock recon that it never reads
    again; a caller that needs the unfiltered planes clones them first.
    All tensors on one CUDA device: y [16*mb_h, 16*mb_w], u/v
    [8*mb_h, 8*mb_w] uint8; BSV/BSH [4*mb_h, 4*mb_w] int32; qp_mb
    [mb_w*mb_h] int32; cqp_mb the chroma QPs, [mb_w*mb_h] int32 for both
    planes or [2, mb_w*mb_h] for Cb and Cr; alpha_off/beta_off the
    per-MB filter offsets, [mb_w*mb_h] int32, or None for 0. Only the
    planes are written. The kernel reads whole MB lines, so y must start
    on 16 bytes and u/v on 8 (fresh tensors do). One call is one kernel
    launch."""
    global launches
    dev = y.device
    if not y.is_cuda:
        raise ValueError("deblock_frame_cuda takes CUDA tensors")
    u8, i32 = torch.uint8, torch.int32
    _check(y, "y", u8, (16 * mb_h, 16 * mb_w), dev, align=16)
    _check(u, "u", u8, (8 * mb_h, 8 * mb_w), dev, align=8)
    _check(v, "v", u8, (8 * mb_h, 8 * mb_w), dev, align=8)
    _check(BSV, "BSV", i32, (4 * mb_h, 4 * mb_w), dev)
    _check(BSH, "BSH", i32, (4 * mb_h, 4 * mb_w), dev)
    n = mb_w * mb_h
    _check(qp_mb, "qp_mb", i32, (n,), dev)
    if cqp_mb.dim() == 2:
        _check(cqp_mb, "cqp_mb", i32, (2, n), dev)
        cqpu, cqpv = cqp_mb[0].data_ptr(), cqp_mb[1].data_ptr()
    else:
        _check(cqp_mb, "cqp_mb", i32, (n,), dev)
        cqpu, cqpv = cqp_mb.data_ptr(), None
    offs = []
    for name, off in (("alpha_off", alpha_off), ("beta_off", beta_off)):
        if off is not None:
            _check(off, name, i32, (n,), dev)
        offs.append(None if off is None else off.data_ptr())
    kernel = _kernel()
    # per-row progress counters and the row ticket, zero at launch; the
    # caching allocator hands the block out again only to work queued
    # after the kernel on this stream, so it may be freed on return
    scratch = torch.zeros(mb_h + 1, dtype=i32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = kernel(y.data_ptr(), u.data_ptr(), v.data_ptr(),
                     BSV.data_ptr(), BSH.data_ptr(), qp_mb.data_ptr(),
                     cqpu, cqpv, *offs, scratch.data_ptr(), mb_w, mb_h,
                     stream)
    if err != 0:
        raise RuntimeError(f"deblock kernel launch failed: CUDA error {err}")
    with _launches_lock:
        launches += 1
    return y, u, v
