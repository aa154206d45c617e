"""Wrapper of the Hopper deblock kernel (csrc/deblock.cu).

Replaces the TPU kernel openh264_tpu/encoder/deblock_pallas.py
(deblock_frame_pallas). The kernel filters one frame as a knight
wavefront: one launch per diagonal d = x + 2y, one block per MB of the
diagonal, all 168 launches (at 720p) issued by one C call on the
current stream. What bounds it on the card is that chain of dependent
steps, not the ~2.8 MB it moves; see the note at the top of the CUDA
source. Its plain version is deblock_torch.deblock_frame_device.

The wrapper checks its inputs and raises on anything the kernel does
not take; it never falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

# calls that launched the kernel (one per deblocked frame)
launches = 0


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point, with its argument types declared: pointers and
    the stream as void*, so that ctypes does not cut them to 32 bits."""
    fn = _build.load("deblock").deblock_frame
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(t, name, dtype, shape, device):
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


def deblock_frame_cuda(y, u, v, BSV, BSH, qp_mb, cqp_mb,
                       mb_w: int, mb_h: int):
    """Computes what deblock_torch.deblock_frame_device computes, but
    filters the planes IN PLACE (no copies) and returns them, (y, u, v).
    The session hands it fresh pre-deblock recon that it never reads
    again; a caller that needs the unfiltered planes clones them first.
    All tensors on one CUDA device: y [16*mb_h, 16*mb_w], u/v
    [8*mb_h, 8*mb_w] uint8; BSV/BSH [4*mb_h, 4*mb_w] int32; qp_mb/cqp_mb
    [mb_w*mb_h] int32. bS and QP are only read."""
    global launches
    dev = y.device
    if not y.is_cuda:
        raise ValueError("deblock_frame_cuda takes CUDA tensors")
    u8, i32 = torch.uint8, torch.int32
    _check(y, "y", u8, (16 * mb_h, 16 * mb_w), dev)
    _check(u, "u", u8, (8 * mb_h, 8 * mb_w), dev)
    _check(v, "v", u8, (8 * mb_h, 8 * mb_w), dev)
    _check(BSV, "BSV", i32, (4 * mb_h, 4 * mb_w), dev)
    _check(BSH, "BSH", i32, (4 * mb_h, 4 * mb_w), dev)
    _check(qp_mb, "qp_mb", i32, (mb_w * mb_h,), dev)
    _check(cqp_mb, "cqp_mb", i32, (mb_w * mb_h,), dev)
    kernel = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = kernel(y.data_ptr(), u.data_ptr(), v.data_ptr(),
                     BSV.data_ptr(), BSH.data_ptr(), qp_mb.data_ptr(),
                     cqp_mb.data_ptr(), mb_w, mb_h, stream)
    if err != 0:
        raise RuntimeError(f"deblock kernel launch failed: CUDA error {err}")
    launches += 1
    return y, u, v
