"""Weighted-prediction slice state (spec 8.4.2.3; reference rec_mb.cpp
WeightPrediction:298 / BiWeightPrediction:366 and decoder_core.cpp
CreateImplicitWeightTable:397).

A SliceWP descriptor is built once per slice and attached to
FrameSymbols.wp_by_slice; reconstruction consults it per MB.

Copied from openh264_tpu/decoder/wpred.py. The batched recon
(recon_batch.py) runs every mode; its _WPLuts.implicit_w0 is the
vectorized form of implicit_weights.
"""

from __future__ import annotations

import numpy as np

# wp modes
WP_NONE = 0        # plain prediction / default bi average
WP_P_EXPLICIT = 1  # P slice, pps.weighted_pred: WeightPrediction on all MC
WP_B_EXPLICIT = 2  # B slice, weighted_bipred_idc == 1: explicit bi + single
WP_B_IMPLICIT = 3  # B slice, weighted_bipred_idc == 2: implicit bi only


class SliceWP:
    __slots__ = ("mode", "luma_denom", "chroma_denom", "weights",
                 "implicit_w0")

    def __init__(self, mode=WP_NONE, luma_denom=0, chroma_denom=0,
                 weights=None, implicit_w0=None):
        self.mode = mode
        self.luma_denom = luma_denom
        self.chroma_denom = chroma_denom
        # explicit: {(lx, refidx): {luma_weight, luma_offset,
        #                           chroma_weight[2], chroma_offset[2]}}
        self.weights = weights or {}
        # implicit: w0[ref0][ref1]; w1 = 64 - w0 (denom 5, offsets 0)
        self.implicit_w0 = implicit_w0

    def luma_w(self, lx: int, ref: int):
        w = self.weights.get((lx, ref))
        if w is None:  # out-of-table ref (concealment): identity
            return 1 << self.luma_denom, 0
        return w["luma_weight"], w["luma_offset"]

    def chroma_w(self, lx: int, ref: int, comp: int):
        w = self.weights.get((lx, ref))
        if w is None:
            return 1 << self.chroma_denom, 0
        return w["chroma_weight"][comp], w["chroma_offset"][comp]


def build_slice_wp(sh, init_l0, init_l1, cur_poc=None) -> SliceWP:
    """Build the per-slice WP descriptor.

    init_l0/init_l1 are the INITIAL (pre-reorder) reference lists: the
    reference builds its implicit table before ref-list reordering
    (decoder_core.cpp:2439 InitRefPicList calls CreateImplicitWeightTable
    before WelsReorderRefList2) yet indexes it with post-reorder ref
    indices; we replicate that behavior for bit-exactness.

    cur_poc: the picture's computed (unwrapped) POC. The reference's
    CreateImplicitWeightTable reads pSliceHeader->iPicOrderCntLsb, but
    the slice-header parse has already OVERWRITTEN that field with
    pocMsb + pocLsb (the full POC) — so after a pic_order_cnt_lsb wrap
    the implicit weights must use the full POC, not the raw lsb (the
    same parse quirk that drives ComputeColocatedTemporalScaling).
    """
    from .slicehdr import P_SLICE, B_SLICE

    pps = sh.pps
    if sh.slice_type == P_SLICE:
        if pps.weighted_pred:
            return SliceWP(WP_P_EXPLICIT, sh.luma_log2_weight_denom,
                           sh.chroma_log2_weight_denom, dict(sh.weights))
        return SliceWP()
    if sh.slice_type != B_SLICE or pps.weighted_bipred_idc == 0:
        return SliceWP()
    if pps.weighted_bipred_idc == 1:
        return SliceWP(WP_B_EXPLICIT, sh.luma_log2_weight_denom,
                       sh.chroma_log2_weight_denom, dict(sh.weights))
    # implicit (idc == 2): POC-distance weights, denom 5, offsets 0.
    poc = sh.pic_order_cnt_lsb if cur_poc is None else cur_poc
    n0, n1 = sh.num_ref_idx_l0_active, sh.num_ref_idx_l1_active
    if (len(init_l0) > 0 and len(init_l1) > 0 and n0 == 1 and n1 == 1
            and init_l0[0].poc + init_l1[0].poc == 2 * poc):
        return SliceWP()  # bUseWeightedBiPredIdc turned off: plain average
    w0 = np.full((n0, n1), 32, dtype=np.int32)
    for r0 in range(min(n0, len(init_l0))):
        p0 = init_l0[r0]
        for r1 in range(min(n1, len(init_l1))):
            p1 = init_l1[r1]
            if getattr(p0, "is_long_term", False) or \
                    getattr(p1, "is_long_term", False):
                continue
            td = int(np.clip(p1.poc - p0.poc, -128, 127))
            if td == 0:
                continue
            tb = int(np.clip(poc - p0.poc, -128, 127))
            tx = (16384 + (abs(td) >> 1)) // td if td > 0 else \
                -((16384 + (abs(td) >> 1)) // -td)
            dsf = (tb * tx + 32) >> 8
            if -64 <= dsf <= 128:
                w0[r0, r1] = 64 - dsf
    return SliceWP(WP_B_IMPLICIT, 5, 5, None, w0)


def implicit_weights(wp: SliceWP, r0: int, r1: int):
    """(w0, w1) for a BI partition under implicit weighting; refs outside
    the table (concealed) fall back to 32/32."""
    t = wp.implicit_w0
    if t is not None and 0 <= r0 < t.shape[0] and 0 <= r1 < t.shape[1]:
        w = int(t[r0, r1])
    else:
        w = 32
    return w, 64 - w
