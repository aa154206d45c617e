"""Scene change detection (METHOD_SCENE_CHANGE_DETECTION_VIDEO/_SCREEN).

Port of openh264_tpu/processing/scenechange.py (detect_scene_change),
with the same result on the same planes. Behavior parity: processing
SceneChangeDetection.h. Per non-overlapping 8x8 block, SAD against the
previous frame; a block with SAD > 320 is a high-motion block. The
frame is LARGE_CHANGED when motion blocks reach 0.85 (video) / 0.80
(screen) of all blocks, MEDIUM_CHANGED at 0.50. The screen variant also
classifies blocks as COLLOCATED_STATIC (SAD 0) or SCROLLED_STATIC (SAD 0
at the scroll vector). The SAD grids stay on the planes' device.
"""

from __future__ import annotations

import torch

SIMILAR = 0
SCENE_CHANGED_MEDIUM = 1
SCENE_CHANGED_LARGE = 2

HIGH_MOTION_BLOCK_THRESHOLD = 320
RATIO_LARGE_VIDEO = 0.85
RATIO_LARGE_SCREEN = 0.80
RATIO_MEDIUM = 0.50

NO_STATIC = 0
COLLOCATED_STATIC = 1
SCROLLED_STATIC = 2

I32 = torch.int32


def _sad8_grid(cur, ref):
    h, w = cur.shape
    bh, bw = h >> 3, w >> 3
    c = cur[:bh * 8, :bw * 8].to(I32)
    r = ref[:bh * 8, :bw * 8].to(I32)
    return (c - r).abs().reshape(bh, 8, bw, 8).sum((1, 3), dtype=I32)


def _motion_blocks(cur, ref):
    sad = _sad8_grid(cur, ref)
    return (sad > HIGH_MOTION_BLOCK_THRESHOLD).sum(), sad


def detect_scene_change(cur, ref, screen: bool = False,
                        scroll_mv: tuple[int, int] | None = None):
    """Returns (idc, result_dict). cur/ref: [H, W] uint8 luma tensors on
    one device; the dict's grids stay there."""
    n_motion, sad = _motion_blocks(cur, ref)
    n_motion = int(n_motion)
    nblk = sad.shape[0] * sad.shape[1]
    large = RATIO_LARGE_SCREEN if screen else RATIO_LARGE_VIDEO
    thd_large = int(large * nblk + 0.5 + 1e-6)
    thd_medium = int(RATIO_MEDIUM * nblk + 0.5 + 1e-6)
    idc = SIMILAR
    if n_motion >= thd_large:
        idc = SCENE_CHANGED_LARGE
    elif n_motion >= thd_medium:
        idc = SCENE_CHANGED_MEDIUM
    res = {"motion_blocks": n_motion, "sad8x8": sad,
           "frame_complexity": int(sad.sum(dtype=I32))}
    if screen:
        zero = torch.zeros((), dtype=I32, device=sad.device)
        static_idc = torch.where(sad == 0, zero + COLLOCATED_STATIC,
                                 zero + NO_STATIC)
        if scroll_mv is not None and (scroll_mv[0] or scroll_mv[1]):
            sad_scroll = _scrolled_sad(cur, ref, scroll_mv)
            static_idc = torch.where((static_idc == NO_STATIC)
                                     & (sad_scroll == 0),
                                     zero + SCROLLED_STATIC, static_idc)
        res["static_block_idc"] = static_idc
    return idc, res


def _scrolled_sad(cur, ref, mv: tuple[int, int]):
    """8x8 SAD grid against the scroll-shifted reference; blocks whose
    shifted place leaves the picture get the sentinel 1 << 20, so they
    never classify as static."""
    dx, dy = int(mv[0]), int(mv[1])
    shifted = torch.roll(ref, (-dy, -dx), (0, 1))
    sad = _sad8_grid(cur, shifted)
    bh, bw = sad.shape
    dev = sad.device
    by = torch.arange(bh, device=dev)[:, None] * 8
    bx = torch.arange(bw, device=dev)[None, :] * 8
    h, w = cur.shape
    ok = ((bx + dx >= 0) & (bx + dx <= w - 8)
          & (by + dy >= 0) & (by + dy <= h - 8))
    return torch.where(ok, sad, torch.full_like(sad, 1 << 20))
