"""Batched frame reconstruction: inter MBs on the device, intra MBs in
host C, or in host Python for a picture that holds I8x8 MBs.

Port of openh264_tpu/decoder/recon_batch.py (recon_frame_batch,
_recon_inter_batch, _combine, _WPLuts). All inter 4x4 blocks of a frame
are predicted at once by the MC of ops/recon_torch.py, from L0, L1 or
both, grouped by reference picture (whose planes a dpb.Picture holds on
the decoder's device); combined by plain copy, explicit weights
(WeightPrediction), the plain bi average, or explicit or implicit
bi-weights (BiWeightPrediction), as the slice's weighted-prediction
mode asks; scattered into the planes; and given their residual through
the 4x4 (ops/transform.idct4x4_add) or the 8x8 inverse transform
(ops/transform.idct8x8_add), all on the decoder's device. The JAX module
switches between a numpy and a JAX path (`device: bool`); here there is
one path, on the planes' device.

A BI partition of a B 16x8 / 8x16 MB is predicted from both lists, as
clause 8.4.2 has it. Under fs.openh264_compat (H264Decoder's
openh264_compat) it reproduces the OpenH264 decoder's GetInterBPred
(rec_mb.cpp:739-831) byte for byte, as the JAX module does
(recon_batch.py:265-272; the why in recon_oracle.py:117-130): the first
partition's BI becomes its L1 prediction passed twice through
BiWeightPrediction when the slice weights B, and the second partition's
BI becomes its plain, unweighted L0 prediction.

Intra MBs (sequential neighbour dependencies) run afterwards in raster
order on host copies of the planes, which move to the host once and
back once: in host C (cbind.recon_intra_mbs_native), I8x8 MBs
included. Under fs.openh264_compat a picture with an I8x8 MB sends all
its intra MBs to Python (recon_oracle.recon_intra_mb), as the JAX
package routes them (recon_batch.py:221-228,
native/__init__.py:257-266), with its fault on modes that predict from
a missing neighbour (ROADMAP C7). Inter pixels are final before any intra MB
reads them, which matches raster decode order since intra prediction
only reads up/left neighbours. Parity anchors: rec_mb.cpp
GetInterPred:462 / GetInterBPred:666, WeightPrediction:298,
BiWeightPrediction:366, decode_slice.cpp:334 WelsTargetMbConstruction.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.recon_torch import mc_chroma, mc_luma
from ..ops.transform import idct4x4_add, idct8x8_add
from ..utils import trace
from . import cbind
from .framedata import (INTRA_CLASSES, MB_B16x8, MB_B8x16, MB_I8x8,
                        FrameSymbols)
from .recon_oracle import HostPlanes, ReconState, recon_intra_mb
from .wpred import WP_B_EXPLICIT, WP_B_IMPLICIT, WP_P_EXPLICIT

# combine kinds (recon_batch.py:25-29)
K_SINGLE = 0          # plain single-list
K_SINGLE_W = 1        # WeightPrediction single-list
K_BI = 2              # plain average
K_BI_W = 3            # BiWeightPrediction

I32 = torch.int32


def _combine(kind, pa, pb, w0, o0, w1, o1, d):
    """Vectorized WeightPrediction / BiWeightPrediction / average, per
    block by `kind`. pa, pb are [N,h,w] uint8 (pb is read by the bi kinds
    only), the rest per-block int32 [N]."""
    w0_, o0_, w1_, o1_, d_ = (t[:, None, None] for t in (w0, o0, w1, o1, d))
    k = kind[:, None, None]
    p0 = pa.to(I32)
    p1 = pb.to(I32)
    one = torch.ones_like(d_)
    single = torch.where(
        d_ >= 1, ((p0 * w0_ + (one << (d_ - 1).clamp(min=0)))
                  >> d_.clamp(min=1)) + o0_,
        p0 * w0_ + o0_).clamp(0, 255)
    bi = (p0 + p1 + 1) >> 1
    bi_w = (((p0 * w0_ + p1 * w1_ + (one << d_)) >> (d_ + 1))
            + ((o0_ + o1_ + 1) >> 1)).clamp(0, 255)
    out = torch.where(k == K_SINGLE_W, single, p0)
    out = torch.where(k == K_BI, bi, out)
    out = torch.where(k == K_BI_W, bi_w, out)
    return out.to(torch.uint8)


class _WPLuts:
    """Per-slice weighted-prediction lookup tables for vector indexing
    (recon_batch.py:162-211)."""

    def __init__(self, fs: FrameSymbols, max_ref: int = 33):
        wps = fs.wp_by_slice or []
        ns = max(1, len(wps))
        self.mode = np.zeros(ns, np.int32)
        self.ldenom = np.zeros(ns, np.int32)
        self.cdenom = np.zeros(ns, np.int32)
        self.lw = np.ones((ns, 2, max_ref), np.int32)
        self.lo = np.zeros((ns, 2, max_ref), np.int32)
        self.cw = np.ones((ns, 2, max_ref, 2), np.int32)
        self.co = np.zeros((ns, 2, max_ref, 2), np.int32)
        self.impl = [None] * ns
        for si, wp in enumerate(wps):
            if wp is None or wp.mode == 0:
                continue
            self.mode[si] = wp.mode
            self.ldenom[si] = wp.luma_denom
            self.cdenom[si] = wp.chroma_denom
            if wp.mode == WP_B_IMPLICIT:
                self.impl[si] = wp.implicit_w0
                continue
            self.lw[si] = 1 << wp.luma_denom
            self.cw[si] = 1 << wp.chroma_denom
            for (lx, ri), w in wp.weights.items():
                if ri < max_ref:
                    self.lw[si, lx, ri] = w["luma_weight"]
                    self.lo[si, lx, ri] = w["luma_offset"]
                    self.cw[si, lx, ri] = w["chroma_weight"]
                    self.co[si, lx, ri] = w["chroma_offset"]

    def implicit_w0(self, sid, r0, r1):
        """Implicit w0 per block; 32 where the table has no entry."""
        w0 = np.full(len(sid), 32, np.int32)
        for si in np.unique(sid):
            t = self.impl[si] if 0 <= si < len(self.impl) else None
            if t is None:
                continue
            m = sid == si
            rr0 = np.clip(r0[m], 0, t.shape[0] - 1)
            rr1 = np.clip(r1[m], 0, t.shape[1] - 1)
            ok = (r0[m] >= 0) & (r0[m] < t.shape[0]) & \
                 (r1[m] >= 0) & (r1[m] < t.shape[1])
            w0[m] = np.where(ok, t[rr0, rr1], 32)
        return w0


def recon_frame_batch(fs: FrameSymbols, ref_pics: dict,
                      constrained: bool, device: torch.device) -> ReconState:
    """Reconstructs the correctly decoded MBs of `fs` into planes on
    `device`; the others stay 0 for error concealment. ref_pics: DPB
    pic_id -> dpb.Picture."""
    st = ReconState(fs, device)
    mb_ok = fs.mb_correct
    inter_idx = np.nonzero((fs.mb_type >= 4) & mb_ok)[0].astype(np.int32)
    if len(inter_idx):
        with trace.span("recon.inter"):
            _recon_inter_batch(st, fs, ref_pics, inter_idx)
    # intra MBs in raster order (wavefront deps on recon pixels)
    intra_list = np.nonzero(np.isin(fs.mb_type, INTRA_CLASSES) & mb_ok)[0]
    if not len(intra_list):
        return st
    python = fs.openh264_compat and bool(
        (fs.mb_type[intra_list] == MB_I8x8).any())
    with trace.span("recon.intra", python=python):
        _recon_intra(st, fs, intra_list, constrained, device,
                     len(inter_idx) > 0, python)
    return st


def _recon_intra(st: ReconState, fs: FrameSymbols, intra_list,
                 constrained: bool, device: torch.device,
                 any_inter: bool, python: bool) -> None:
    """The intra MBs of intra_list in raster order on host copies of the
    planes: one download (none when nothing was predicted on the
    device), the host C recon, or the Python one (`python`: a picture
    with I8x8 MBs under openh264_compat), one upload."""
    if device.type == "cpu":          # the host code writes the tensors
        host = [p.numpy() for p in (st.y, st.u, st.v)]
    else:
        # one fetch (none when nothing was predicted on the device)
        with trace.span("recon.fetch"):
            host = [p.cpu().numpy() if any_inter else
                    np.zeros(tuple(p.shape), np.uint8)
                    for p in (st.y, st.u, st.v)]
    if python:
        hp = HostPlanes(fs, *host)
        for idx in intra_list:
            recon_intra_mb(hp, int(idx), constrained)
    else:
        cbind.recon_intra_mbs_native(*host, fs, intra_list, constrained)
    if device.type != "cpu":          # and one upload
        st.y, st.u, st.v = (torch.from_numpy(p).to(device) for p in host)


def _block_params(fs: FrameSymbols, mb_u, blk):
    """Per 4x4 block (host numpy, recon_batch.py:243-333): the prediction
    sources A and B (DPB pic id and vector; B only where `need_b`), the
    combine kind, and the luma / Cb / Cr weights, offsets and denominators
    that _combine takes."""
    B = len(mb_u)
    bx, by = blk % 4, blk // 4
    q = (by // 2) * 2 + (bx // 2)
    pm = fs.pred_mode[mb_u, q].astype(np.int32)
    mt = fs.mb_type[mb_u]
    sid = fs.slice_id[mb_u]
    r0 = fs.refidx[mb_u, 0, q].astype(np.int32)
    r1 = fs.refidx[mb_u, 1, q].astype(np.int32)
    pid0 = fs.ref_pic[mb_u, 0, q]
    pid1 = fs.ref_pic[mb_u, 1, q]
    mv0 = fs.mv[mb_u, 0, blk]               # [B,2]
    mv1 = fs.mv[mb_u, 1, blk]

    luts = _WPLuts(fs)
    wmode = luts.mode[np.clip(sid, 0, len(luts.mode) - 1)]
    wmode = np.where((sid >= 0) & (sid < len(luts.mode)), wmode, 0)

    # the B 16x8/8x16 BI partitions of the reference (module docstring)
    second = np.where(mt == MB_B16x8, by >= 2, bx >= 2)
    quirk_bi = (pm == 2) & ((mt == MB_B16x8) | (mt == MB_B8x16)) & \
        fs.openh264_compat
    quirk_l0 = quirk_bi & second       # plain L0, never weighted
    quirk_l1 = quirk_bi & ~second      # L1 MC through BiWeight twice

    use_l1_a = ((pm == 1) | quirk_l1) & ~quirk_l0
    pid_a = np.where(use_l1_a, pid1, pid0)
    mv_a = np.where(use_l1_a[:, None], mv1, mv0)
    is_bi = (pm == 2) & ~quirk_bi
    kind = np.zeros(B, np.int32)
    # w0, o0, w1, o1, d for luma, Cb and Cr
    wts = [[np.ones(B, np.int32), np.zeros(B, np.int32),
            np.ones(B, np.int32), np.zeros(B, np.int32),
            np.zeros(B, np.int32)] for _ in range(3)]

    sidc = np.clip(sid, 0, len(luts.mode) - 1)
    r0c = np.clip(r0, 0, luts.lw.shape[2] - 1)
    r1c = np.clip(r1, 0, luts.lw.shape[2] - 1)

    def table(c, lx, r):
        """(weight, offset, denominator) of plane c (0 luma, 1 Cb, 2 Cr)
        per block for list lx (array or int) and refs r."""
        if c == 0:
            return luts.lw[sidc, lx, r], luts.lo[sidc, lx, r], \
                luts.ldenom[sidc]
        return (luts.cw[sidc, lx, r, c - 1], luts.co[sidc, lx, r, c - 1],
                luts.cdenom[sidc])

    single_w = (~is_bi & ~quirk_l1 & ~quirk_l0 &
                (((wmode == WP_P_EXPLICIT) & (pm == 0)) |
                 ((wmode == WP_B_EXPLICIT) & (pm <= 1))))
    if single_w.any():
        kind[single_w] = K_SINGLE_W
        lxs = np.clip(pm, 0, 1)
        rs = np.where(pm == 0, r0c, r1c)
        for c in range(3):
            w, o, d = table(c, lxs, rs)
            wts[c][0][single_w] = w[single_w]
            wts[c][1][single_w] = o[single_w]
            wts[c][4][single_w] = d[single_w]

    bi_w = (is_bi | quirk_l1) & ((wmode == WP_B_EXPLICIT) |
                                 (wmode == WP_B_IMPLICIT))
    kind[is_bi & ~bi_w] = K_BI
    if bi_w.any():
        kind[bi_w] = K_BI_W
        expl = bi_w & (wmode == WP_B_EXPLICIT)
        if expl.any():
            for c in range(3):
                w0, o0, d = table(c, 0, r0c)
                w1, o1, _ = table(c, 1, r1c)
                for k, a in enumerate((w0, o0, w1, o1, d)):
                    wts[c][k][expl] = a[expl]
        impl = bi_w & (wmode == WP_B_IMPLICIT)
        if impl.any():
            iw0 = luts.implicit_w0(sid[impl], r0[impl], r1[impl])
            for c in range(3):
                wts[c][0][impl] = iw0
                wts[c][2][impl] = 64 - iw0
                wts[c][1][impl] = wts[c][3][impl] = 0
                wts[c][4][impl] = 5

    need_b = is_bi | quirk_l1  # second source (quirk_l1: same as A)
    pid_b = np.where(quirk_l1, pid_a, pid1)
    mv_b = np.where(quirk_l1[:, None], mv_a, mv1)
    return pid_a, mv_a, pid_b, mv_b, need_b, kind, wts


def _recon_inter_batch(st: ReconState, fs: FrameSymbols,
                       ref_pics: dict, mbs: np.ndarray) -> None:
    dev = st.y.device
    nmb = len(mbs)
    mb_w = fs.mb_w
    # per-(mb, blk) flattened units, host numpy
    B = nmb * 16
    mb_u = np.repeat(mbs, 16)
    blk = np.tile(np.arange(16, dtype=np.int32), nmb)
    gx4 = np.repeat(mbs % mb_w, 16) * 4 + blk % 4    # global 4x4 col
    gy4 = np.repeat(mbs // mb_w, 16) * 4 + blk // 4
    pid_a, mv_a, pid_b, mv_b, need_b, kind, wts = _block_params(fs, mb_u,
                                                                blk)
    # MC jobs: every block's source A, then the B sources; grouped by
    # reference picture (each group one contiguous run) and moved to the
    # device as one table. A job writes row `dst` of the [2B] predictions
    # (A in 0..B-1, B in B..2B-1).
    rows_b = np.nonzero(need_b)[0]
    job_pid = np.concatenate([pid_a, pid_b[rows_b]])
    job_mv = np.concatenate([mv_a, mv_b[rows_b]])
    job_row = np.concatenate([np.arange(B), rows_b])
    job_dst = np.concatenate([np.arange(B), B + rows_b])
    order = np.argsort(job_pid, kind="stable")
    pids, starts, counts = np.unique(job_pid[order], return_index=True,
                                     return_counts=True)
    jobs = torch.from_numpy(np.ascontiguousarray(np.stack([
        gx4[job_row] * 4, gy4[job_row] * 4, job_mv[:, 0], job_mv[:, 1],
        job_dst]).astype(np.int32)[:, order])).to(dev)
    x0, y0, mvx, mvy = jobs[:4]
    dst = jobs[4].long()

    # ---- MC per reference picture ----
    pred_y = torch.zeros((2 * B, 4, 4), dtype=torch.uint8, device=dev)
    pred_u = torch.zeros((2 * B, 2, 2), dtype=torch.uint8, device=dev)
    pred_v = torch.zeros((2 * B, 2, 2), dtype=torch.uint8, device=dev)
    for p, a, n in zip(pids.tolist(), starts.tolist(), counts.tolist()):
        if p < 0:
            continue                  # reference lost: prediction stays 0
        ref = ref_pics[p]
        s = slice(a, a + n)
        d = dst[s]
        pred_y[d] = mc_luma(ref.y, x0[s], y0[s], mvx[s], mvy[s])
        pred_u[d] = mc_chroma(ref.u, x0[s] >> 1, y0[s] >> 1, mvx[s], mvy[s])
        pred_v[d] = mc_chroma(ref.v, x0[s] >> 1, y0[s] >> 1, mvx[s], mvy[s])
    if (kind != K_SINGLE).any():
        par = torch.from_numpy(np.ascontiguousarray(np.stack(
            [kind] + [a for c in wts for a in c]).astype(np.int32))).to(dev)
        out = []
        for c, pred in enumerate((pred_y, pred_u, pred_v)):
            out.append(_combine(par[0], pred[:B], pred[B:],
                                *par[1 + 5 * c:6 + 5 * c]))
        pred_y, pred_u, pred_v = out
    else:
        pred_y, pred_u, pred_v = pred_y[:B], pred_u[:B], pred_v[:B]

    # ---- scatter predictions into the planes ----
    H, W = st.y.shape
    cH, cW = st.u.shape
    yv = st.y.view(H // 4, 4, W // 4, 4).permute(0, 2, 1, 3)
    uv = st.u.view(cH // 2, 2, cW // 2, 2).permute(0, 2, 1, 3)
    vv = st.v.view(cH // 2, 2, cW // 2, 2).permute(0, 2, 1, 3)
    g = torch.from_numpy(np.stack([gy4, gx4]).astype(np.int64)).to(dev)
    yv[g[0], g[1]] = pred_y
    uv[g[0], g[1]] = pred_u   # chroma 2x2 block index == luma 4x4 index
    vv[g[0], g[1]] = pred_v

    # ---- residual add, for the MBs that carry coefficients ----
    t8 = fs.transform8[mbs]
    coded = (fs.cbp[mbs] & 15) != 0
    luma = mbs[coded & ~t8]
    if len(luma):
        r4 = torch.arange(4, device=dev)
        m = torch.from_numpy(luma).to(dev).long()
        g_y = ((m // mb_w) * 4)[:, None] + r4.repeat_interleave(4)[None, :]
        g_x = ((m % mb_w) * 4)[:, None] + r4.repeat(4)[None, :]
        coefs = torch.from_numpy(fs.coeffs_l[luma]).to(dev).view(
            len(luma), 16, 4, 4)
        yv[g_y, g_x] = idct4x4_add(yv[g_y, g_x], coefs)
    luma8 = mbs[coded & t8]
    if len(luma8):
        # four 8x8 blocks per MB (recon_batch.py:414-423)
        fs.ensure_coeffs8()
        r2 = torch.arange(2, device=dev)
        m = torch.from_numpy(luma8).to(dev).long()
        g_y = ((m // mb_w) * 2)[:, None] + r2.repeat_interleave(2)[None, :]
        g_x = ((m % mb_w) * 2)[:, None] + r2.repeat(2)[None, :]
        coefs = torch.from_numpy(fs.coeffs8[luma8]).to(dev)
        y8 = st.y.view(H // 8, 8, W // 8, 8).permute(0, 2, 1, 3)
        y8[g_y, g_x] = idct8x8_add(y8[g_y, g_x], coefs)
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
