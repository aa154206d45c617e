"""Batched frame reconstruction: inter MBs on the device, intra MBs in
host C.

Port of openh264_tpu/decoder/recon_batch.py (recon_frame_batch,
_recon_inter_batch, _combine) for P pictures. All inter 4x4 blocks of a
frame are predicted at once by the MC of ops/recon_torch.py, grouped by
reference picture (whose planes a dpb.Picture holds on the decoder's
device), combined with the slice's explicit weights where the PPS asks
for them, scattered into the planes, and given their residual through
ops/transform.idct4x4_add, all on the decoder's device. The JAX module
switches between a numpy and a JAX path (`device: bool`); here there is
one path, on the planes' device.

Intra MBs (sequential neighbour dependencies) run afterwards in raster
order in host C (native.recon_intra_mbs_native): the planes move to the
host once and back once. Inter pixels are final before any intra MB
reads them, which matches raster decode order since intra prediction
only reads up/left neighbours. Parity anchors: rec_mb.cpp
GetInterPred:462, WeightPrediction:298, decode_slice.cpp:334
WelsTargetMbConstruction.

Bi-prediction (K_BI, K_BI_W: B slices) is not carried yet; the parser
refuses B slices before they reach this module.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.recon_torch import mc_chroma, mc_luma
from ..ops.transform import idct4x4_add
from .framedata import INTRA_CLASSES, FrameSymbols
from .recon_oracle import ReconState
from .wpred import WP_P_EXPLICIT

# combine kinds (recon_batch.py:25-29)
K_SINGLE = 0          # plain single-list
K_SINGLE_W = 1        # WeightPrediction single-list

I32 = torch.int32


def _combine(kind, pa, w0, o0, d):
    """Vectorized WeightPrediction for single-list blocks: K_SINGLE
    passes pa through, K_SINGLE_W weights it. pa is [N,h,w] uint8, the
    rest per-block int32 [N]."""
    w0_, o0_, d_ = (t[:, None, None] for t in (w0, o0, d))
    p = pa.to(I32)
    rnd = torch.ones_like(d_) << (d_ - 1).clamp(min=0)
    r = torch.where(d_ >= 1, ((p * w0_ + rnd) >> d_.clamp(min=1)) + o0_,
                    p * w0_ + o0_)
    out = torch.where((kind == K_SINGLE_W)[:, None, None], r.clamp(0, 255),
                      p)
    return out.to(torch.uint8)


class _WPLuts:
    """Per-slice explicit weighted-prediction tables for vector indexing
    (the single-list part of recon_batch.py:162-194)."""

    def __init__(self, fs: FrameSymbols, max_ref: int = 33):
        wps = fs.wp_by_slice or []
        ns = max(1, len(wps))
        self.mode = np.zeros(ns, np.int32)
        self.ldenom = np.zeros(ns, np.int32)
        self.cdenom = np.zeros(ns, np.int32)
        self.lw = np.ones((ns, max_ref), np.int32)
        self.lo = np.zeros((ns, max_ref), np.int32)
        self.cw = np.ones((ns, max_ref, 2), np.int32)
        self.co = np.zeros((ns, max_ref, 2), np.int32)
        for si, wp in enumerate(wps):
            if wp is None or wp.mode != WP_P_EXPLICIT:
                continue
            self.mode[si] = wp.mode
            self.ldenom[si] = wp.luma_denom
            self.cdenom[si] = wp.chroma_denom
            self.lw[si] = 1 << wp.luma_denom
            self.cw[si] = 1 << wp.chroma_denom
            for (lx, ri), w in wp.weights.items():
                if lx == 0 and ri < max_ref:
                    self.lw[si, ri] = w["luma_weight"]
                    self.lo[si, ri] = w["luma_offset"]
                    self.cw[si, ri] = w["chroma_weight"]
                    self.co[si, ri] = w["chroma_offset"]


def recon_frame_batch(fs: FrameSymbols, ref_pics: dict,
                      constrained: bool, device: torch.device) -> ReconState:
    """Reconstructs the correctly decoded MBs of `fs` into planes on
    `device`; the others stay 0 for error concealment. ref_pics: DPB
    pic_id -> dpb.Picture."""
    from ..native import recon_intra_mbs_native
    st = ReconState(fs, device)
    mb_ok = fs.mb_correct
    inter_idx = np.nonzero((fs.mb_type >= 4) & mb_ok)[0].astype(np.int32)
    if len(inter_idx):
        _recon_inter_batch(st, fs, ref_pics, inter_idx)
    # intra MBs in raster order (wavefront deps on recon pixels)
    intra_list = np.nonzero(np.isin(fs.mb_type, INTRA_CLASSES) & mb_ok)[0]
    if len(intra_list):
        if device.type == "cpu":      # the C writes the tensors' memory
            recon_intra_mbs_native(st.y.numpy(), st.u.numpy(),
                                   st.v.numpy(), fs, intra_list,
                                   constrained)
        else:
            # one fetch (none when nothing was predicted on the device)
            # and one upload
            host = [p.cpu().numpy() if len(inter_idx) else
                    np.zeros(tuple(p.shape), np.uint8)
                    for p in (st.y, st.u, st.v)]
            recon_intra_mbs_native(*host, fs, intra_list, constrained)
            st.y, st.u, st.v = (torch.from_numpy(p).to(device)
                                for p in host)
    return st


def _recon_inter_batch(st: ReconState, fs: FrameSymbols,
                       ref_pics: dict, mbs: np.ndarray) -> None:
    dev = st.y.device
    nmb = len(mbs)
    mb_w = fs.mb_w
    # per-(mb, blk) flattened units, host numpy
    mb_u = np.repeat(mbs, 16)
    blk = np.tile(np.arange(16, dtype=np.int32), nmb)
    bx = blk % 4
    by = blk // 4
    q = (by // 2) * 2 + (bx // 2)
    gx4 = np.repeat(mbs % mb_w, 16) * 4 + bx       # global 4x4 col
    gy4 = np.repeat(mbs // mb_w, 16) * 4 + by
    if (fs.pred_mode[mb_u, q] != 0).any():
        raise NotImplementedError("L1 and bi-prediction (B slices) are "
                                  "reconstructed by the JAX package only")
    sid = fs.slice_id[mb_u]
    r0 = fs.refidx[mb_u, 0, q].astype(np.int32)
    pid = fs.ref_pic[mb_u, 0, q]
    mv = fs.mv[mb_u, 0, blk]                         # [B,2]

    luts = _WPLuts(fs)
    sidc = np.clip(sid, 0, len(luts.mode) - 1)
    wmode = np.where((sid >= 0) & (sid < len(luts.mode)),
                     luts.mode[sidc], 0)
    weighted = wmode == WP_P_EXPLICIT
    rows = [gx4 * 4, gy4 * 4, mv[:, 0], mv[:, 1], gx4, gy4]
    if weighted.any():
        r0c = np.clip(r0, 0, luts.lw.shape[1] - 1)
        wsel = np.where(weighted, 1, 0)

        def w(table, default):
            return np.where(weighted, table, default)
        rows += [wsel * K_SINGLE_W,
                 w(luts.lw[sidc, r0c], 1), w(luts.lo[sidc, r0c], 0),
                 w(luts.ldenom[sidc], 0),
                 w(luts.cw[sidc, r0c, 0], 1), w(luts.co[sidc, r0c, 0], 0),
                 w(luts.cw[sidc, r0c, 1], 1), w(luts.co[sidc, r0c, 1], 0),
                 w(luts.cdenom[sidc], 0)]
    # blocks grouped by reference picture (each group one contiguous
    # run), moved to the device as one table
    order = np.argsort(pid, kind="stable")
    pids, starts, counts = np.unique(pid[order], return_index=True,
                                     return_counts=True)
    tab = torch.from_numpy(np.ascontiguousarray(
        np.stack(rows).astype(np.int32)[:, order])).to(dev)
    x0, y0, mvx, mvy, tgx, tgy = tab[:6]

    # ---- MC per reference picture ----
    B = len(order)
    pred_y = torch.zeros((B, 4, 4), dtype=torch.uint8, device=dev)
    pred_u = torch.zeros((B, 2, 2), dtype=torch.uint8, device=dev)
    pred_v = torch.zeros((B, 2, 2), dtype=torch.uint8, device=dev)
    for p, a, n in zip(pids.tolist(), starts.tolist(), counts.tolist()):
        if p < 0:
            continue                  # reference lost: prediction stays 0
        ref = ref_pics[p]
        s = slice(a, a + n)
        pred_y[s] = mc_luma(ref.y, x0[s], y0[s], mvx[s], mvy[s])
        pred_u[s] = mc_chroma(ref.u, x0[s] >> 1, y0[s] >> 1, mvx[s], mvy[s])
        pred_v[s] = mc_chroma(ref.v, x0[s] >> 1, y0[s] >> 1, mvx[s], mvy[s])
    if weighted.any():
        kind, lw, lo, ld, cwu, cou, cwv, cov, cd = tab[6:]
        pred_y = _combine(kind, pred_y, lw, lo, ld)
        pred_u = _combine(kind, pred_u, cwu, cou, cd)
        pred_v = _combine(kind, pred_v, cwv, cov, cd)

    # ---- scatter predictions into the planes ----
    H, W = st.y.shape
    cH, cW = st.u.shape
    yv = st.y.view(H // 4, 4, W // 4, 4).permute(0, 2, 1, 3)
    uv = st.u.view(cH // 2, 2, cW // 2, 2).permute(0, 2, 1, 3)
    vv = st.v.view(cH // 2, 2, cW // 2, 2).permute(0, 2, 1, 3)
    gy, gx = tgy.long(), tgx.long()
    yv[gy, gx] = pred_y
    uv[gy, gx] = pred_u      # chroma 2x2 block index == luma 4x4 index
    vv[gy, gx] = pred_v

    # ---- residual add, for the MBs that carry coefficients ----
    r4 = torch.arange(4, device=dev)
    luma = mbs[(fs.cbp[mbs] & 15) != 0]
    if len(luma):
        m = torch.from_numpy(luma).to(dev).long()
        g_y = ((m // mb_w) * 4)[:, None] + r4.repeat_interleave(4)[None, :]
        g_x = ((m % mb_w) * 4)[:, None] + r4.repeat(4)[None, :]
        coefs = torch.from_numpy(fs.coeffs_l[luma]).to(dev).view(
            len(luma), 16, 4, 4)
        yv[g_y, g_x] = idct4x4_add(yv[g_y, g_x], coefs)
    chroma = mbs[(fs.cbp[mbs] & 0x30) != 0]
    if len(chroma):
        m = torch.from_numpy(chroma).to(dev).long()
        r2 = torch.arange(2, device=dev)
        cg_y = ((m // mb_w) * 2)[:, None] + r2.repeat_interleave(2)[None, :]
        cg_x = ((m % mb_w) * 2)[:, None] + r2.repeat(2)[None, :]
        coefs = torch.from_numpy(fs.coeffs_c[chroma]).to(dev).view(
            len(chroma), 2, 4, 4, 4)
        for k, plane in enumerate((st.u, st.v)):
            pv = plane.view(cH // 4, 4, cW // 4, 4).permute(0, 2, 1, 3)
            pv[cg_y, cg_x] = idct4x4_add(pv[cg_y, cg_x], coefs[:, k])
