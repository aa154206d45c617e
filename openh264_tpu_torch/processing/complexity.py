"""Complexity analysis (METHOD_COMPLEXITY_ANALYSIS / _SCREEN).

Behavior parity: processing ComplexityAnalysis.cpp —
AnalyzeFrameComplexityViaSad:98 (frame complexity = frame SAD,
optionally excluding background blocks), AnalyzeGomComplexityViaSad:172
(per-GOM SAD + foreground block count feeding the rate controller's
GOM QP ladder, GomSampleSad:153/GomSampleSadExceptBackground:161).

A GOM ("group of MBs") is a run of consecutive MB-raster rows-worth of
MBs as defined by the RC (ratectl.cpp); here it is expressed as a
segment length in MBs so the reduction is one segment-sum.

Copied from openh264_tpu/processing/complexity.py: host numpy over VAA
statistics already on the host (fetch the device tensors of
processing/vaa.py first). The docstring of gom_complexity keeps the
JAX version's words, "nonzero SAD OR not background", but the code
counts "not background" only; the port reproduces the code
(ROADMAP.md, queue C).
"""

from __future__ import annotations

import numpy as np


def frame_complexity(vaa, bgd_flag=None) -> int:
    """Frame SAD; when bgd_flag [mh,mw] given, background MBs excluded
    (GetFrameSadExcludeBackground)."""
    sad_mb = np.asarray(vaa["sad8x8"]).astype(np.int64).sum(-1)
    if bgd_flag is not None:
        sad_mb = np.where(np.asarray(bgd_flag) != 0, 0, sad_mb)
    return int(sad_mb.sum())


def gom_complexity(vaa, gom_size_mbs: int, bgd_flag=None):
    """Per-GOM (SAD, foreground MB count) arrays.

    Parity: AnalyzeGomComplexityViaSad — the foreground count uses
    "any of the MB's four 8x8 SADs nonzero OR not background".
    Returns (gom_sad [nG] int64, gom_fg [nG] int32).
    """
    sad8 = np.asarray(vaa["sad8x8"]).astype(np.int64)   # [mh, mw, 4]
    mh, mw, _ = sad8.shape
    sad_mb = sad8.sum(-1).reshape(-1)
    fg = np.ones(mh * mw, bool)
    if bgd_flag is not None:
        fg = np.asarray(bgd_flag).reshape(-1) == 0
        sad_mb = np.where(fg, sad_mb, 0)
    n = sad_mb.shape[0]
    ng = (n + gom_size_mbs - 1) // gom_size_mbs
    pad = ng * gom_size_mbs - n
    sad_p = np.pad(sad_mb, (0, pad)).reshape(ng, gom_size_mbs)
    fg_p = np.pad(fg, (0, pad)).reshape(ng, gom_size_mbs)
    return sad_p.sum(-1), fg_p.sum(-1).astype(np.int32)
