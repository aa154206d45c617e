"""In-loop deblocking for the encoder session: bS grids, edge filters,
the plain PyTorch wavefront and the device dispatch.

Port of openh264_tpu/encoder/deblock_jax.py. `deblock_frame_device` is
the plain version of the CUDA kernel in deblock_cuda.py: the CPU path
runs it, and the chip smoke test holds the kernel against it.

Scheduling (deblock_jax.py:10-17): MB (x, y) reads pixels last written
by MBs (x-1, y), (x, y-1) and (x+1, y-1), and the 20x20 luma / 10x10
chroma regions of MBs that may run at once are disjoint. Any order that
runs each MB after those three gives the same bytes. The plain version
runs the knight diagonals d = x + 2y, each as one batched gather -> 8
luma + 4 chroma edge passes -> scatter (`_filter_mbs`), mb_w + 2*mb_h - 2
steps a frame. The CUDA kernel runs MB rows as a pipeline in one launch
(row y runs MB x's vertical pass after its own MB x-1, and its
horizontal pass once row y-1 has finished MB x+1);
tests/test_torch_deblock_schedule.py runs `_filter_mbs` pass by pass in
that order.
The JAX twin shears the planes so each diagonal is one column band (a
TPU layout trick); here the regions are gathered directly from
zero-padded planes, which gives the same result: the padding only feeds
picture-border edges, whose bS is forced to 0.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import constant_cache
from ..tables import ALPHA_TABLE, BETA_TABLE, TC0_TABLE
from .deblock_cuda import deblock_frame_cuda

I32 = torch.int32

_const = constant_cache({"alpha": ALPHA_TABLE, "beta": BETA_TABLE,
                         "tc0": TC0_TABLE})


# ---------------------------------------------------------------------------
# Boundary strengths (encoder frames: I16x16 / P16x16 / PSKIP, single ref)
# ---------------------------------------------------------------------------
def encoder_bs(nz_blk, intra, mv, mb_w: int, mb_h: int):
    """BSV/BSH grids [mb_h*4, mb_w*4] int32 for an encoder-produced frame.

    nz_blk: [n_mb, 16] bool — per-4x4-block (raster in MB) nonzero flag;
    intra:  [n_mb] bool; mv: [n_mb, 2] int (quarter-pel, ref 0).
    Rules: spec 8.7.2.1 specialized to single-list ref-0 P16x16 frames
    (parity: encoder deblocking.cpp DeblockingBSCalcEnc).
    """
    H4, W4 = mb_h * 4, mb_w * 4
    dev = nz_blk.device
    nz = nz_blk.bool().reshape(mb_h, mb_w, 4, 4).permute(0, 2, 1, 3).reshape(
        H4, W4)
    ig = intra.bool().reshape(mb_h, mb_w).repeat_interleave(
        4, 0).repeat_interleave(4, 1)
    mvg = mv.to(I32).reshape(mb_h, mb_w, 2).repeat_interleave(
        4, 0).repeat_interleave(4, 1)

    def far(a, b):
        return ((a[..., 0] - b[..., 0]).abs() >= 4) | \
               ((a[..., 1] - b[..., 1]).abs() >= 4)

    def edges(ip, iq, mbb):
        bs = far(mvg[ip], mvg[iq]).to(I32)
        bs = torch.where(nz[ip] | nz[iq], 2, bs)
        bs = torch.where(mbb & (ig[ip] | ig[iq]), 4, bs)
        bs = torch.where(~mbb & ig[iq], 3, bs)
        return bs

    mbb_v = (torch.arange(1, W4, device=dev) % 4 == 0)[None, :].expand(
        H4, W4 - 1)
    mbb_h = (torch.arange(1, H4, device=dev) % 4 == 0)[:, None].expand(
        H4 - 1, W4)
    BSV = torch.zeros((H4, W4), dtype=I32, device=dev)
    BSV[:, 1:] = edges(np.s_[:, :-1], np.s_[:, 1:], mbb_v)
    BSH = torch.zeros((H4, W4), dtype=I32, device=dev)
    BSH[1:, :] = edges(np.s_[:-1, :], np.s_[1:, :], mbb_h)
    return BSV, BSH


# ---------------------------------------------------------------------------
# Edge filters (int32; parity: deblocking_common.cpp)
# ---------------------------------------------------------------------------
def _clip3(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _luma_edge(sub, bs, alpha, beta, tc0):
    """sub: [..., 8] int32 (p3..q3 across the edge); bs/tc0: [...];
    alpha/beta broadcastable. Returns new [..., 6] (p2..q2)."""
    p3, p2, p1, p0, q0, q1, q2, q3 = sub.unbind(-1)
    d0 = p0 - q0
    act = (bs > 0) & (d0.abs() < alpha) & \
        ((p1 - p0).abs() < beta) & ((q1 - q0).abs() < beta)
    ap = (p2 - p0).abs() < beta
    aq = (q2 - q0).abs() < beta
    is4 = bs == 4
    strong = d0.abs() < ((alpha >> 2) + 2)
    sp = ap & strong
    sq = aq & strong
    np0_4 = torch.where(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                        (2 * p1 + p0 + q1 + 2) >> 2)
    np1_4 = torch.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
    np2_4 = torch.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    nq0_4 = torch.where(sq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                        (2 * q1 + q0 + p1 + 2) >> 2)
    nq1_4 = torch.where(sq, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
    nq2_4 = torch.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)
    tc = tc0 + ap.to(I32) + aq.to(I32)
    delta = _clip3(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc)
    np0_n = (p0 + delta).clamp(0, 255)
    nq0_n = (q0 - delta).clamp(0, 255)
    avg = (p0 + q0 + 1) >> 1
    dp1 = _clip3((p2 + avg - 2 * p1) >> 1, -tc0, tc0)
    dq1 = _clip3((q2 + avg - 2 * q1) >> 1, -tc0, tc0)
    np1_n = torch.where(ap, p1 + dp1, p1)
    nq1_n = torch.where(aq, q1 + dq1, q1)
    np2 = torch.where(act & is4, np2_4, p2)
    np1 = torch.where(act, torch.where(is4, np1_4, np1_n), p1)
    np0 = torch.where(act, torch.where(is4, np0_4, np0_n), p0)
    nq0 = torch.where(act, torch.where(is4, nq0_4, nq0_n), q0)
    nq1 = torch.where(act, torch.where(is4, nq1_4, nq1_n), q1)
    nq2 = torch.where(act & is4, nq2_4, q2)
    return torch.stack([np2, np1, np0, nq0, nq1, nq2], -1)


def _chroma_edge(sub, bs, alpha, beta, tc0):
    """sub: [..., 4] (p1 p0 q0 q1). Returns new [..., 2] (p0 q0)."""
    p1, p0, q0, q1 = sub.unbind(-1)
    act = (bs > 0) & ((p0 - q0).abs() < alpha) & \
        ((p1 - p0).abs() < beta) & ((q1 - q0).abs() < beta)
    is4 = bs == 4
    np0_4 = (2 * p1 + p0 + q1 + 2) >> 2
    nq0_4 = (2 * q1 + q0 + p1 + 2) >> 2
    tc = tc0 + 1
    delta = _clip3(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc)
    np0_n = (p0 + delta).clamp(0, 255)
    nq0_n = (q0 - delta).clamp(0, 255)
    np0 = torch.where(act, torch.where(is4, np0_4, np0_n), p0)
    nq0 = torch.where(act, torch.where(is4, nq0_4, nq0_n), q0)
    return torch.stack([np0, nq0], -1)


# ---------------------------------------------------------------------------
# Plain wavefront
# ---------------------------------------------------------------------------
def _edge_params(BSV, BSH, qp_mb, cqp_mb, mb_w: int, mb_h: int,
                 alpha_off=None, beta_off=None):
    """Per-MB filter parameters for every edge, as deblock_jax's ab_tc
    computes them (deblock_jax.py:226-307):
      luma  bs [n,4(e),16], alpha/beta [n,4], tc0 [n,4,16]
      chroma bs [n,2(ce),8], alpha/beta [n,2(Cb,Cr),2], tc0 [n,2,2,8]
    for the vertical (v) and horizontal (h) passes. Edge 0 of each pass
    crosses the MB border: its bS is 0 at the picture border and its QP
    is the average with the left (v) or top (h) MB. cqp_mb is [n] (both
    chroma planes) or [2, n] (Cb, Cr); alpha_off / beta_off [n] (None:
    0) are added to an edge's QP average with the current MB's values,
    as the decoder's oracle does (oracle/deblock.py:235-263)."""
    dev = BSV.device
    n = mb_w * mb_h
    alpha_t, beta_t, tc0_t = (_const(k, dev) for k in ("alpha", "beta",
                                                      "tc0"))
    ar = torch.arange(n, device=dev)
    x, y = ar % mb_w, ar // mb_w
    left_id = y * mb_w + (x - 1).clamp(min=0)
    top_id = (y - 1).clamp(min=0) * mb_w + x

    # bsv4[n, e, r] = BSV[4y + r, 4x + e]; bsh4[n, e, s] = BSH[4y + e, 4x + s]
    bsv4 = BSV.to(I32).reshape(mb_h, 4, mb_w, 4).permute(0, 2, 3, 1).reshape(
        n, 4, 4).clone()
    bsh4 = BSH.to(I32).reshape(mb_h, 4, mb_w, 4).permute(0, 2, 1, 3).reshape(
        n, 4, 4).clone()
    bsv4[:, 0] *= (x > 0).to(I32)[:, None]
    bsh4[:, 0] *= (y > 0).to(I32)[:, None]
    zero = torch.zeros(n, dtype=I32, device=dev)
    ao = (zero if alpha_off is None else alpha_off.to(I32))[:, None]
    bo = (zero if beta_off is None else beta_off.to(I32))[:, None]

    def pack(bs4, q, nb_id, rep):
        qc = q.to(I32)
        qnb = torch.stack([qc[nb_id]] + [qc] * (bs4.shape[1] - 1), 1)
        qav = (qc[:, None] + qnb + 1) >> 1
        ia = (qav + ao).clamp(0, 51).long()
        ib = (qav + bo).clamp(0, 51).long()
        bs = bs4.repeat_interleave(rep, dim=2)
        tc0 = tc0_t[ia[..., None], (bs - 1).clamp(0, 2).long()]
        return bs, alpha_t[ia], beta_t[ib], tc0

    def pack_chroma(bs4, nb_id):
        cq = cqp_mb if cqp_mb.dim() == 2 else torch.stack([cqp_mb] * 2)
        planes = [pack(bs4, cq[k], nb_id, 2) for k in range(2)]
        return (planes[0][0],) + tuple(
            torch.stack([p[i] for p in planes], 1) for i in (1, 2, 3))

    return {
        "v": pack(bsv4, qp_mb, left_id, 4),
        "h": pack(bsh4, qp_mb, top_id, 4),
        "cv": pack_chroma(bsv4[:, ::2], left_id),
        "ch": pack_chroma(bsh4[:, ::2], top_id),
    }


def _diagonals(mb_w: int, mb_h: int):
    """MB ids of each knight diagonal d = x + 2y (valid MBs only)."""
    out = []
    for d in range(mb_w + 2 * (mb_h - 1)):
        ys = np.arange(max(0, -(-(d - mb_w + 1) // 2)), min(mb_h - 1, d // 2) + 1)
        out.append(ys * mb_w + (d - 2 * ys))
    return out


def _per_plane(cal, cbe, ctc, ce: int):
    """Chroma edge ce's alpha, beta [2, L, 1] and tc0 [2, L, 8], plane
    first, for lines [2(Cb, Cr), L, 8] of the MBs gathered."""
    return (cal[:, :, ce].T[:, :, None], cbe[:, :, ce].T[:, :, None],
            ctc[:, :, ce].transpose(0, 1))


def _filter_mbs(Yp, UVp, prm, ids, passes: str = "vh"):
    """Filters the MBs `ids` (int64 MB ids whose regions are disjoint) in
    the padded working planes in place: one batched gather of their
    regions, the edge passes, one scatter back. passes "vh" runs the 4
    luma + 2 chroma vertical edges, then the horizontal ones; "v" or "h"
    runs one of them and writes back only what it touches (the MB's own
    rows, or its own columns). Yp [H+4, W+4] and UVp [2, Hc+2, Wc+2]
    int32 carry 4 luma / 2 chroma rows and columns of zero top-left
    halo; prm is _edge_params'."""
    dev = Yp.device
    mb_w = (Yp.shape[1] - 4) // 16
    r20 = torch.arange(20, device=dev)
    r10 = torch.arange(10, device=dev)
    mx, my = ids % mb_w, ids // mb_w
    ry = (16 * my[:, None] + r20)[:, :, None]
    rx = (16 * mx[:, None] + r20)[:, None, :]
    cy = (8 * my[:, None] + r10)[:, :, None]
    cx = (8 * mx[:, None] + r10)[:, None, :]
    R = Yp[ry, rx]                       # [L,20,20]
    C = UVp[:, cy, cx]                   # [2,L,10,10]

    if "v" in passes:
        bs, al, be, tc = (t[ids] for t in prm["v"])
        cbs, cal, cbe, ctc = (t[ids] for t in prm["cv"])
        for e in range(4):
            new = _luma_edge(R[:, 4:20, 4 * e:4 * e + 8], bs[:, e],
                             al[:, e, None], be[:, e, None], tc[:, e])
            R[:, 4:20, 4 * e + 1:4 * e + 7] = new
            if e in (0, 2):
                ce = e // 2
                C[:, :, 2:10, 4 * ce + 1:4 * ce + 3] = _chroma_edge(
                    C[:, :, 2:10, 4 * ce:4 * ce + 4], cbs[:, ce],
                    *_per_plane(cal, cbe, ctc, ce))

    if "h" in passes:
        bs, al, be, tc = (t[ids] for t in prm["h"])
        cbs, cal, cbe, ctc = (t[ids] for t in prm["ch"])
        for e in range(4):
            new = _luma_edge(R[:, 4 * e:4 * e + 8, 4:20].transpose(1, 2),
                             bs[:, e], al[:, e, None], be[:, e, None],
                             tc[:, e])
            R[:, 4 * e + 1:4 * e + 7, 4:20] = new.transpose(1, 2)
            if e in (0, 2):
                ce = e // 2
                newc = _chroma_edge(
                    C[:, :, 4 * ce:4 * ce + 4, 2:10].transpose(2, 3),
                    cbs[:, ce], *_per_plane(cal, cbe, ctc, ce))
                C[:, :, 4 * ce + 1:4 * ce + 3, 2:10] = newc.transpose(2, 3)

    # regions are disjoint; one pass alone leaves the top rows ("v") or
    # the left columns ("h") as gathered, so it does not write them back
    lo = 4 * (passes == "v"), 4 * (passes == "h")
    Yp[ry[:, lo[0]:], rx[:, :, lo[1]:]] = R[:, lo[0]:, lo[1]:]
    clo = lo[0] // 2, lo[1] // 2
    UVp[:, cy[:, clo[0]:], cx[:, :, clo[1]:]] = C[:, :, clo[0]:, clo[1]:]


def _deblock_in_order(y, u, v, BSV, BSH, qp_mb, cqp_mb, mb_w: int,
                      mb_h: int, steps, alpha_off=None, beta_off=None):
    """Filters one frame by running `_filter_mbs` on each step, an (MB
    ids, passes) pair, in turn; returns new (y, u, v) uint8 planes. The
    result is the frame's deblock when each MB's passes come in order,
    after its three producers (see the module note)."""
    dev = y.device
    H, W = y.shape
    Hc, Wc = u.shape
    prm = _edge_params(BSV, BSH, qp_mb, cqp_mb, mb_w, mb_h, alpha_off,
                       beta_off)
    # zero-padded working planes (4 luma / 2 chroma rows and columns of
    # top-left halo), filtered in place step by step
    Yp = torch.zeros((H + 4, W + 4), dtype=I32, device=dev)
    Yp[4:, 4:] = y
    UVp = torch.zeros((2, Hc + 2, Wc + 2), dtype=I32, device=dev)
    UVp[0, 2:, 2:] = u
    UVp[1, 2:, 2:] = v
    for ids, passes in steps:
        _filter_mbs(Yp, UVp, prm, torch.as_tensor(ids, device=dev), passes)
    u8 = torch.uint8
    return (Yp[4:, 4:].to(u8), UVp[0, 2:, 2:].to(u8), UVp[1, 2:, 2:].to(u8))


def deblock_frame_device(y, u, v, BSV, BSH, qp_mb, cqp_mb,
                         mb_w: int, mb_h: int, alpha_off=None,
                         beta_off=None):
    """Filter one frame; returns new (y, u, v) uint8 planes.

    y/u/v: uint8 planes (MB-aligned); BSV/BSH: [4*mb_h, 4*mb_w] int32;
    qp_mb: [n_mb] int32 luma QP per MB; cqp_mb: [n_mb] chroma QP of both
    planes, or [2, n_mb] of Cb and Cr; alpha_off / beta_off: [n_mb]
    int32 filter offsets per MB, or None for 0. Left/top availability
    is the picture border; slice edges and skipped MBs come as bS 0.
    Runs the knight diagonals in order, one batch of both passes each.
    """
    return _deblock_in_order(y, u, v, BSV, BSH, qp_mb, cqp_mb, mb_w, mb_h,
                             [(d, "vh") for d in _diagonals(mb_w, mb_h)],
                             alpha_off, beta_off)


def deblock_frame_auto(y, u, v, BSV, BSH, qp_mb, cqp_mb,
                       mb_w: int, mb_h: int, alpha_off=None, beta_off=None):
    """The deblock of every path: a CUDA tensor goes to the Hopper kernel
    (deblock_cuda.py), a CPU tensor to the plain version. Both return
    the filtered planes; the kernel filters the input planes in place,
    so a caller reads only what is returned."""
    fn = deblock_frame_cuda if y.is_cuda else deblock_frame_device
    return fn(y, u, v, BSV, BSH, qp_mb, cqp_mb, mb_w, mb_h, alpha_off,
              beta_off)
