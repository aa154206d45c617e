"""Peaks of the card and the least work of the port's kernels, frozen
with the benchmark so that a change to the program cannot move its own
yardstick.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet): 3.35 TB/s of HBM,
and 67 TFLOP/s in float32 outside the tensor cores, used as the rate of
32-bit integer work. The deblock count is a copy of chip_smoke.py's
deblock_bound_ms.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# per-MB int32 arrays the deblock kernel reads: QP and chroma QP on the
# encoder's side; QP, Cb and Cr QPs and alpha / beta offsets on the
# decoder's
ENCODER_MB_ARRAYS = 2
DECODER_MB_ARRAYS = 5


def deblock_frame_bytes(mb_w: int, mb_h: int, mb_arrays: int) -> int:
    """Bytes one frame's deblock must move: the 4:2:0 planes read once
    and written once, the two bS grids (int32, 4x4 entries per MB) and
    the per-MB arrays read once. 80x45 MBs: 3,254,400 with the
    encoder's 2 arrays, 3,297,600 with the decoder's 5."""
    plane = 16 * mb_h * 16 * mb_w * 3 // 2
    bs = 4 * mb_h * 4 * mb_w
    return 2 * plane + 2 * bs * 4 + mb_arrays * mb_w * mb_h * 4


def deblock_frame_ops_max(mb_w: int, mb_h: int) -> int:
    """Integer operations of one frame's deblock if every edge inside
    the picture had bS > 0: ~60 for each luma line and ~25 for each
    chroma line across an edge (chip_smoke.py's count). Its time at the
    scalar rate stays below the bytes' time at HBM bandwidth, so the
    kernel's bound is the bytes' whatever the bS data."""
    v_luma = 4 * mb_h * (4 * mb_w - 1)
    h_luma = (4 * mb_h - 1) * 4 * mb_w
    v_chroma = 4 * mb_h * (2 * mb_w - 1)
    h_chroma = (2 * mb_h - 1) * 4 * mb_w
    return 60 * 4 * (v_luma + h_luma) + 25 * 4 * (v_chroma + h_chroma)


def deblock_frame_bound_s(mb_w: int, mb_h: int, mb_arrays: int) -> float:
    """Least seconds of one frame's deblock on the card."""
    return max(deblock_frame_bytes(mb_w, mb_h, mb_arrays) / HBM_BYTES_PER_S,
               deblock_frame_ops_max(mb_w, mb_h) / SCALAR_OPS_PER_S)


def roofline_percent(frames: int, kernel_s: float, mb_w: int, mb_h: int,
                     mb_arrays: int) -> float | None:
    """The kernel's share of its roofline over `frames` frames that took
    kernel_s seconds of device time; None when nothing was measured."""
    if frames <= 0 or kernel_s <= 0:
        return None
    return 100.0 * frames * deblock_frame_bound_s(mb_w, mb_h, mb_arrays) \
        / kernel_s
