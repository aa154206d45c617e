"""Encoder core in PyTorch: I16x16 wavefront, intra-in-P, and the P-frame
motion search, quarter-pel refine, P_Skip promotion, transforms and recon.

Port of openh264_tpu/encoder/core_jax.py, bit-exact with it:
encode_i_frame (with intra_mask / init_recon), encode_i16_flat,
chainfree_intra_mask and encode_p_frame, with the prev_skip_sad /
prev_skip chain, band mode (`row_off`: y/u/v are a band of MB rows, the
reference planes whole), the `extra_mv` screen-content candidate and
per-MB QP arrays (adaptive quant, GOM rate control).

Translation notes:
- everything is int32 torch, like JAX without x64;
- the TPU's one-hot matmul gathers (mxu_gather_windows, qpel_select) are
  integer gathers here: exact, and no TF32 can reach them. A window that
  reaches outside the plane reads 0 there, as the one-hot product did;
- argmin picks the first minimum and candidate updates use a strict <,
  in the same candidate order as the JAX code;
- the ME lambda is averaged and multiplied in float32 and truncated,
  as core_jax.py does;
- the I wavefront keeps core_jax's dummy-row lanes so that no two lanes
  of one scatter share an index. Its recon planes and output rows are
  updated in place, one diagonal at a time.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import constant_cache
from ..ops.transform import (qp_tensor, dct4x4, dequant4x4, hadamard2x2, hadamard4x4,
                             idct4x4_add, luma_dc_dequant_ihadamard,
                             chroma_dc_dequant_ihadamard, quant4x4, quant_dc)
from ..ops.transform_soa import (chroma_dc_dequant_ihadamard_soa, dct4x4_soa,
                                 dequant4x4_soa, hadamard2x2_soa,
                                 idct4x4_add_soa, quant4x4_soa, quant_dc_soa)

I32 = torch.int32
U8 = torch.uint8
BIG = 1 << 30


def _mb_blocks(x16):
    """[.., 16, 16] -> [.., 16, 4, 4] raster 4x4 blocks."""
    s = x16.shape[:-2]
    n = len(s)
    return x16.reshape(*s, 4, 4, 4, 4).permute(
        *range(n), n, n + 2, n + 1, n + 3).reshape(*s, 16, 4, 4)


def _blocks_mb(blk):
    """[.., 16, 4, 4] -> [.., 16, 16]."""
    s = blk.shape[:-3]
    n = len(s)
    return blk.reshape(*s, 4, 4, 4, 4).permute(
        *range(n), n, n + 2, n + 1, n + 3).reshape(*s, 16, 16)


def _chroma_blocks(x8):
    s = x8.shape[:-2]
    n = len(s)
    return x8.reshape(*s, 2, 4, 2, 4).permute(
        *range(n), n, n + 2, n + 1, n + 3).reshape(*s, 4, 4, 4)


def _chroma_mb(blk):
    s = blk.shape[:-3]
    n = len(s)
    return blk.reshape(*s, 2, 2, 4, 4).permute(
        *range(n), n, n + 2, n + 1, n + 3).reshape(*s, 8, 8)


def _shifted(g, dy: int, dx: int, fill=0, lead: int = 0):
    """out[.., y, x] = g[.., y - dy, x - dx] where that lies in the grid,
    else `fill` (dy in {0, 1}; dx in {-1, 0, 1}). The grid axes follow
    `lead` batch axes; trailing axes are carried along."""
    out = torch.full_like(g, fill)
    h, w = g.shape[lead:lead + 2]
    ys, yd = slice(0, h - dy), slice(dy, h)
    if dx >= 0:
        xs, xd = slice(0, w - dx), slice(dx, w)
    else:
        xs, xd = slice(-dx, w), slice(0, w + dx)
    pre = (slice(None),) * lead
    out[pre + (yd, xd)] = g[pre + (ys, xs)]
    return out


# ---------------------------------------------------------------------------
# Intra 16x16 wavefront
# ---------------------------------------------------------------------------
def _predict_i16_batch(top, left, tl, has_top, has_left):
    """top: [D,16] left: [D,16] tl: [D]; returns preds [D,4,16,16] for
    modes (V,H,DC,Plane) and a validity mask [D,4]."""
    D = top.shape[0]
    dev = top.device
    top = top.to(I32)
    left = left.to(I32)
    tl = tl.to(I32)
    v = top[:, None, :].expand(D, 16, 16)
    h = left[:, :, None].expand(D, 16, 16)
    both = has_top & has_left
    dc_val = torch.where(
        both, (top.sum(-1, dtype=I32) + left.sum(-1, dtype=I32) + 16) >> 5,
        torch.where(has_left, (left.sum(-1, dtype=I32) + 8) >> 4,
                    torch.where(has_top, (top.sum(-1, dtype=I32) + 8) >> 4,
                                128)))
    dc = dc_val[:, None, None].expand(D, 16, 16)
    xs = torch.arange(8, dtype=I32, device=dev)
    neg_idx = (6 - xs).clamp(0, 15).long()
    has_neg = (6 - xs >= 0)[None, :]
    tneg = torch.where(has_neg, top[:, neg_idx], tl[:, None])
    hgrad = ((xs + 1)[None, :] * (top[:, 8:16] - tneg)).sum(-1, dtype=I32)
    lneg = torch.where(has_neg, left[:, neg_idx], tl[:, None])
    vgrad = ((xs + 1)[None, :] * (left[:, 8:16] - lneg)).sum(-1, dtype=I32)
    a = 16 * (left[:, 15] + top[:, 15])
    b = (5 * hgrad + 32) >> 6
    c = (5 * vgrad + 32) >> 6
    xx = torch.arange(16, dtype=I32, device=dev)
    plane = (a[:, None, None] + b[:, None, None] * (xx[None, None, :] - 7)
             + c[:, None, None] * (xx[None, :, None] - 7) + 16) >> 5
    plane = plane.clamp(0, 255)
    preds = torch.stack([v, h, dc, plane], dim=1)
    valid = torch.stack([has_top, has_left, torch.ones_like(has_top), both],
                        dim=1)
    return preds, valid


def _predict_chroma_batch(top, left, tl, has_top, has_left):
    """top/left: [D,8]; returns preds [D,4,8,8] (DC,H,V,Plane), valid [D,4]."""
    D = top.shape[0]
    dev = top.device
    top = top.to(I32)
    left = left.to(I32)
    tl = tl.to(I32)
    both = has_top & has_left
    tsum = top.reshape(D, 2, 4).sum(-1, dtype=I32)
    lsum = left.reshape(D, 2, 4).sum(-1, dtype=I32)

    def qdc(qx, qy):
        if qx == qy:
            return torch.where(
                both, (tsum[:, qx] + lsum[:, qy] + 4) >> 3,
                torch.where(has_top, (tsum[:, qx] + 2) >> 2,
                            torch.where(has_left, (lsum[:, qy] + 2) >> 2,
                                        128)))
        if qx == 1:
            return torch.where(has_top, (tsum[:, 1] + 2) >> 2,
                               torch.where(has_left, (lsum[:, 0] + 2) >> 2,
                                           128))
        return torch.where(has_left, (lsum[:, 1] + 2) >> 2,
                           torch.where(has_top, (tsum[:, 0] + 2) >> 2, 128))

    dc = torch.zeros((D, 8, 8), dtype=I32, device=dev)
    for qy in range(2):
        for qx in range(2):
            dc[:, qy * 4:qy * 4 + 4, qx * 4:qx * 4 + 4] = \
                qdc(qx, qy)[:, None, None]
    h = left[:, :, None].expand(D, 8, 8)
    v = top[:, None, :].expand(D, 8, 8)
    xs = torch.arange(4, dtype=I32, device=dev)
    neg_idx = (2 - xs).clamp(0, 7).long()
    has_neg = (2 - xs >= 0)[None, :]
    tneg = torch.where(has_neg, top[:, neg_idx], tl[:, None])
    hgrad = ((xs + 1)[None, :] * (top[:, 4:8] - tneg)).sum(-1, dtype=I32)
    lneg = torch.where(has_neg, left[:, neg_idx], tl[:, None])
    vgrad = ((xs + 1)[None, :] * (left[:, 4:8] - lneg)).sum(-1, dtype=I32)
    a = 16 * (left[:, 7] + top[:, 7])
    b = (17 * hgrad + 16) >> 5
    c = (17 * vgrad + 16) >> 5
    xx = torch.arange(8, dtype=I32, device=dev)
    plane = (a[:, None, None] + b[:, None, None] * (xx[None, None, :] - 3)
             + c[:, None, None] * (xx[None, :, None] - 3) + 16) >> 5
    plane = plane.clamp(0, 255)
    preds = torch.stack([dc, h, v, plane], dim=1)
    valid = torch.stack([torch.ones_like(both), has_left, has_top, both],
                        dim=1)
    return preds, valid


def _transform_i16(src, pred, qp):
    """src/pred: [D,16,16]; returns (dc_lev [D,4,4], ac_lev [D,16,16]
    raster-blk/raster-coef, recon [D,16,16] uint8)."""
    res = src.to(I32) - pred.to(I32)
    coef = dct4x4(_mb_blocks(res))                            # [D,16,4,4]
    dc_lev = quant_dc(hadamard4x4(coef[..., 0, 0].reshape(-1, 4, 4)), qp,
                      True)
    ac_lev = quant4x4(coef, qp, True)
    ac_lev[..., 0, 0] = 0
    rec_dc = luma_dc_dequant_ihadamard(dc_lev, qp)
    deq = dequant4x4(ac_lev, qp)
    deq[..., 0, 0] = rec_dc.reshape(-1, 16)
    rec = idct4x4_add(_mb_blocks(pred), deq)
    return dc_lev, ac_lev.reshape(-1, 16, 16), _blocks_mb(rec)


def _transform_chroma(src, pred, qp_c):
    """src/pred: [D,8,8]; returns (dc_lev [D,4], ac_lev [D,4,16], rec)."""
    res = src.to(I32) - pred.to(I32)
    coef = dct4x4(_chroma_blocks(res))
    dc_lev = quant_dc(hadamard2x2(coef[..., 0, 0].reshape(-1, 2, 2)), qp_c,
                      True)
    ac_lev = quant4x4(coef, qp_c, True)
    ac_lev[..., 0, 0] = 0
    rec_dc = chroma_dc_dequant_ihadamard(dc_lev, qp_c)
    deq = dequant4x4(ac_lev, qp_c)
    deq[..., 0, 0] = rec_dc.reshape(-1, 4)
    rec = idct4x4_add(_chroma_blocks(pred), deq)
    return dc_lev.reshape(-1, 4), ac_lev.reshape(-1, 4, 16), _chroma_mb(rec)


def _diag_indices(mb_w, mb_h):
    """Static wavefront tables: for each anti-diagonal d, the MB coords.

    Invalid lanes point at DISTINCT dummy MBs in a padding row below the
    frame (never at real MBs), so no two lanes of one scatter share an
    index (core_jax.py:186-207)."""
    D = min(mb_w, mb_h)
    nd = mb_w + mb_h - 1
    mbx = np.zeros((nd, D), np.int64)
    mby = np.zeros((nd, D), np.int64)
    valid = np.zeros((nd, D), bool)
    for d in range(nd):
        j = 0
        for y in range(mb_h):
            x = d - y
            if 0 <= x < mb_w:
                mbx[d, j], mby[d, j], valid[d, j] = x, y, True
                j += 1
        for k in range(j, D):
            mbx[d, k], mby[d, k] = k, mb_h
    return mbx, mby, valid


@functools.lru_cache(maxsize=None)
def _diag_tables(mb_w: int, mb_h: int, device: torch.device):
    return tuple(torch.as_tensor(a, device=device)
                 for a in _diag_indices(mb_w, mb_h))


def _mb_index(px, py, size: int, width: int):
    """Flat indices [D, size, size] of each lane's MB in a plane of the
    given width."""
    r = torch.arange(size, device=px.device)
    rows = py[:, None] * size + r[None, :]
    cols = px[:, None] * size + r[None, :]
    return rows[:, :, None] * width + cols[:, None, :]


def encode_i_frame(y, u, v, qp, qp_c, mb_w: int, mb_h: int,
                   intra_mask=None, init_recon=None):
    """Wavefront I16x16 encode of a full frame (or of the masked MBs).

    y: [H,W] uint8 (MB aligned). intra_mask: [mb_h*mb_w] bool — MBs to
    encode as intra (None = all); init_recon: starting recon planes
    (inter recon of a P frame; intra MBs overwrite their area; not
    modified). Returns a dict of symbol tensors + recon planes.
    """
    dev = y.device
    n_mb = mb_w * mb_h
    n_pad = (mb_h + 1) * mb_w
    W, Wc = 16 * mb_w, 8 * mb_w
    if intra_mask is None:
        intra_mask = torch.ones(n_mb, dtype=torch.bool, device=dev)
    mask_pad = torch.cat([intra_mask.bool(),
                          torch.zeros(mb_w, dtype=torch.bool, device=dev)])

    def padded(plane, rows):
        # one MB row of padding below the frame absorbs the dummy lanes
        out = torch.zeros((plane.shape[0] + rows, plane.shape[1]), dtype=U8,
                          device=dev)
        out[:plane.shape[0]] = plane
        return out

    if init_recon is None:
        init_recon = (torch.zeros_like(y), torch.zeros_like(u),
                      torch.zeros_like(v))
    rec_y, rec_u, rec_v = (padded(p, r) for p, r in
                           zip(init_recon, (16, 8, 8)))
    src_y, src_u, src_v = padded(y, 16), padded(u, 8), padded(v, 8)

    mbx_t, mby_t, valid_t = _diag_tables(mb_w, mb_h, dev)
    nd = mbx_t.shape[0]
    out = {
        "i16_mode": torch.zeros(n_pad, dtype=I32, device=dev),
        "chroma_mode": torch.zeros(n_pad, dtype=I32, device=dev),
        "luma_dc": torch.zeros((n_pad, 4, 4), dtype=I32, device=dev),
        "luma_ac": torch.zeros((n_pad, 16, 16), dtype=I32, device=dev),
        "chroma_dc": torch.zeros((n_pad, 2, 4), dtype=I32, device=dev),
        "chroma_ac": torch.zeros((n_pad, 2, 4, 16), dtype=I32, device=dev),
    }
    r16 = torch.arange(16, device=dev)
    r8 = torch.arange(8, device=dev)

    def neighbours(plane, px, py, size, width, r):
        """top [D,size], left [D,size], top-left [D] recon samples."""
        flat = plane.view(-1)
        ty = (py * size - 1).clamp(min=0)
        lx = (px * size - 1).clamp(min=0)
        top = flat[(ty * width)[:, None] + px[:, None] * size + r[None, :]]
        left = flat[(py[:, None] * size + r[None, :]) * width + lx[:, None]]
        return top, left, flat[ty * width + lx]

    def store(plane, idx, vals, act):
        flat = plane.view(-1)
        flat[idx] = torch.where(act[:, None, None], vals.to(U8), flat[idx])

    for d in range(nd):
        px, py = mbx_t[d], mby_t[d]
        mb_idx = py * mb_w + px
        act = valid_t[d] & mask_pad[mb_idx]
        has_top = py > 0
        has_left = px > 0

        # ---- luma ----
        iy = _mb_index(px, py, 16, W)
        src = src_y.view(-1)[iy]
        top, left, tl = neighbours(rec_y, px, py, 16, W, r16)
        preds, pvalid = _predict_i16_batch(top, left, tl, has_top, has_left)
        sads = (src[:, None].to(I32) - preds).abs().sum((-1, -2), dtype=I32)
        sads = torch.where(pvalid, sads, BIG)
        mode = torch.argmin(sads, dim=1)
        pred = preds[torch.arange(mode.shape[0], device=dev), mode]
        dc_lev, ac_lev, rec = _transform_i16(src, pred, qp)
        store(rec_y, iy, rec, act)

        # ---- chroma ----
        ic = _mb_index(px, py, 8, Wc)
        ctop_u, cleft_u, ctl_u = neighbours(rec_u, px, py, 8, Wc, r8)
        ctop_v, cleft_v, ctl_v = neighbours(rec_v, px, py, 8, Wc, r8)
        su, sv = src_u.view(-1)[ic], src_v.view(-1)[ic]
        pu, cvalid = _predict_chroma_batch(ctop_u, cleft_u, ctl_u, has_top,
                                           has_left)
        pv, _ = _predict_chroma_batch(ctop_v, cleft_v, ctl_v, has_top,
                                      has_left)
        csads = ((su[:, None].to(I32) - pu).abs().sum((-1, -2), dtype=I32)
                 + (sv[:, None].to(I32) - pv).abs().sum((-1, -2), dtype=I32))
        csads = torch.where(cvalid, csads, BIG)
        cmode = torch.argmin(csads, dim=1)
        lanes = torch.arange(cmode.shape[0], device=dev)
        dcu, acu, rec_u_mb = _transform_chroma(su, pu[lanes, cmode], qp_c)
        dcv, acv, rec_v_mb = _transform_chroma(sv, pv[lanes, cmode], qp_c)
        store(rec_u, ic, rec_u_mb, act)
        store(rec_v, ic, rec_v_mb, act)

        for key, vals in (("i16_mode", mode.to(I32)),
                          ("chroma_mode", cmode.to(I32)),
                          ("luma_dc", dc_lev), ("luma_ac", ac_lev),
                          ("chroma_dc", torch.stack([dcu, dcv], 1)),
                          ("chroma_ac", torch.stack([acu, acv], 1))):
            arr = out[key]
            m = act.reshape((-1,) + (1,) * (vals.dim() - 1))
            arr[mb_idx] = torch.where(m, vals, arr[mb_idx])

    out = {k: a[:n_mb] for k, a in out.items()}
    out["recon_y"] = rec_y[:-16]
    out["recon_u"] = rec_u[:-8]
    out["recon_v"] = rec_v[:-8]
    return out


def chainfree_intra_mask(mask, mb_w: int, mb_h: int):
    """Demote intra-in-P MBs whose causal neighbors (left/top/top-left —
    the I16x16/chroma prediction sources) are also marked, so the kept
    set predicts purely from inter recon (core_jax.py:340)."""
    g = mask.bool().reshape(mb_h, mb_w)
    near = _shifted(g, 0, 1, False) | _shifted(g, 1, 0, False) | \
        _shifted(g, 1, 1, False)
    return (g & ~near).reshape(-1)


def _mb_grid(plane, size: int, mb_w: int, mb_h: int):
    """[mb_h*size, mb_w*size] -> [n_mb, size, size]."""
    return plane.reshape(mb_h, size, mb_w, size).permute(0, 2, 1, 3).reshape(
        mb_w * mb_h, size, size)


def _grid_plane(mbs, size: int, mb_w: int, mb_h: int):
    """[n_mb, size, size] -> [mb_h*size, mb_w*size]."""
    return mbs.reshape(mb_h, mb_w, size, size).permute(0, 2, 1, 3).reshape(
        mb_h * size, mb_w * size)


def encode_i16_flat(y, u, v, qp, qp_c, mb_w: int, mb_h: int,
                    intra_mask=None, init_recon=None):
    """Batched I16x16 encode of a CHAIN-FREE masked MB set: identical to
    encode_i_frame for masks with no causally-adjacent intra MBs (all
    neighbour samples come from init_recon), with no sequential steps."""
    dev = y.device
    n_mb = mb_w * mb_h
    rec_y, rec_u, rec_v = init_recon
    mask = intra_mask

    def borders(plane, size):
        """(top [N,size], left [N,size], topleft [N]) neighbour samples,
        zeros at picture borders."""
        mh, mw = mb_h, mb_w
        topline = torch.cat(
            [torch.zeros((1, mw * size), dtype=plane.dtype, device=dev),
             plane[size - 1::size][:mh - 1]], 0)              # [mh, W]
        top = topline.reshape(n_mb, size)
        leftcol = torch.cat(
            [torch.zeros((mh * size, 1), dtype=plane.dtype, device=dev),
             plane[:, size - 1::size][:, :mw - 1]], 1)        # [H, mw]
        left = leftcol.reshape(mh, size, mw).permute(0, 2, 1).reshape(
            n_mb, size)
        tlrow = torch.cat(
            [torch.zeros((mh, 1), dtype=plane.dtype, device=dev),
             topline[:, size - 1::size][:, :mw - 1]], 1)      # [mh, mw]
        return top, left, tlrow.reshape(n_mb)

    ar = torch.arange(n_mb, device=dev)
    has_top = (ar // mb_w) > 0
    has_left = (ar % mb_w) > 0
    lanes = ar

    # ---- luma ----
    src = _mb_grid(y, 16, mb_w, mb_h)
    preds, pvalid = _predict_i16_batch(*borders(rec_y, 16), has_top,
                                       has_left)
    sads = (src[:, None].to(I32) - preds).abs().sum((-1, -2), dtype=I32)
    sads = torch.where(pvalid, sads, BIG)
    mode = torch.argmin(sads, dim=1)
    dc_lev, ac_lev, rec = _transform_i16(src, preds[lanes, mode], qp)
    m3 = mask[:, None, None]
    rec_mb = torch.where(m3, rec, _mb_grid(rec_y, 16, mb_w, mb_h))

    # ---- chroma ----
    src_u = _mb_grid(u, 8, mb_w, mb_h)
    src_v = _mb_grid(v, 8, mb_w, mb_h)
    pu, cvalid = _predict_chroma_batch(*borders(rec_u, 8), has_top, has_left)
    pv, _ = _predict_chroma_batch(*borders(rec_v, 8), has_top, has_left)
    csads = ((src_u[:, None].to(I32) - pu).abs().sum((-1, -2), dtype=I32)
             + (src_v[:, None].to(I32) - pv).abs().sum((-1, -2), dtype=I32))
    csads = torch.where(cvalid, csads, BIG)
    cmode = torch.argmin(csads, dim=1)
    dcu, acu, rec_u_mb = _transform_chroma(src_u, pu[lanes, cmode], qp_c)
    dcv, acv, rec_v_mb = _transform_chroma(src_v, pv[lanes, cmode], qp_c)

    def merge_c(plane, rec_c):
        pm = torch.where(m3, rec_c, _mb_grid(plane, 8, mb_w, mb_h))
        return _grid_plane(pm, 8, mb_w, mb_h)

    zero = torch.zeros((), dtype=I32, device=dev)
    return {
        "i16_mode": torch.where(mask, mode.to(I32), zero),
        "chroma_mode": torch.where(mask, cmode.to(I32), zero),
        "luma_dc": torch.where(m3, dc_lev, zero),
        "luma_ac": torch.where(m3, ac_lev, zero),
        "chroma_dc": torch.where(m3, torch.stack([dcu, dcv], 1), zero),
        "chroma_ac": torch.where(mask[:, None, None, None],
                                 torch.stack([acu, acv], 1), zero),
        "recon_y": _grid_plane(rec_mb, 16, mb_w, mb_h),
        "recon_u": merge_c(rec_u, rec_u_mb),
        "recon_v": merge_c(rec_v, rec_v_mb),
    }


# ---------------------------------------------------------------------------
# Motion estimation + P frame
# ---------------------------------------------------------------------------
PAD = 24  # reference border padding (>= search range + filter taps)

# lambda for motion cost: g_kiQpCostTable (encoder_data_tables.cpp:59)
QP_COST_TABLE = np.array(
    [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2,
     3, 3, 3, 4, 4, 4, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14,
     16, 18, 20, 23, 25, 29, 32, 36, 40, 45, 51, 57, 64, 72, 81, 91],
    np.int32)

_const = constant_cache({"qp_cost": QP_COST_TABLE,
                         "pow2": 2 ** np.arange(1, 25, dtype=np.int32)})


def pow2_count(x, n: int):
    """Number of i in 1..n with x >= 2**i (int32): the count that
    core_jax and entropy_jax sum one comparison at a time, in one op."""
    bounds = _const("pow2", x.device)[:n]
    return torch.bucketize(x, bounds, out_int32=True, right=True)


def _se_nbits(d):
    """Exact se(v) code length for mvd component d (quarter-pel units),
    saturating like core_jax._se_nbits."""
    return 2 * pow2_count(2 * d.abs() + 1, 13) + 1


def _median3(a, b, c):
    return a + b + c - torch.minimum(torch.minimum(a, b), c) \
        - torch.maximum(torch.maximum(a, b), c)


def _coarse_mvp(cmv_x, cmv_y, mb_w, mb_h):
    """Approximate per-MB MVP (quarter-pel) from the coarse motion field:
    median of left/top/top-right, used only inside ME cost terms."""
    def med_field(f):
        g = f.reshape(mb_h, mb_w)
        return _median3(_shifted(g, 0, 1), _shifted(g, 1, 0),
                        _shifted(g, 1, -1)).reshape(-1)
    return med_field(cmv_x) * 4, med_field(cmv_y) * 4


def pad_ref(plane):
    """Replicate-pad a plane by PAD (like ExpandReferencingPicture)."""
    H, W = plane.shape
    r = torch.arange(-PAD, H + PAD, device=plane.device).clamp(0, H - 1)
    c = torch.arange(-PAD, W + PAD, device=plane.device).clamp(0, W - 1)
    return plane[r[:, None], c[None, :]]


def gather_windows(plane, gy, gx, size: int):
    """[N, size, size] int32 windows of `plane` with top-left (gy, gx).
    Samples outside the plane read 0, as core_jax.mxu_gather_windows'
    one-hot product gives."""
    Hp, Wp = plane.shape
    r = torch.arange(size, device=plane.device)
    rows = gy.long()[:, None] + r[None, :]
    cols = gx.long()[:, None] + r[None, :]
    inside = ((rows >= 0) & (rows < Hp))[:, :, None] & \
        ((cols >= 0) & (cols < Wp))[:, None, :]
    idx = rows.clamp(0, Hp - 1)[:, :, None] * Wp + \
        cols.clamp(0, Wp - 1)[:, None, :]
    win = plane.reshape(-1)[idx].to(I32)
    return torch.where(inside, win, torch.zeros((), dtype=I32,
                                                device=plane.device))


def _soa(plane, size: int, mb_w: int, mb_h: int):
    """[mb_h*size, mb_w*size] -> [size, size, n_mb] int32 (SoA)."""
    return plane.reshape(mb_h, size, mb_w, size).permute(1, 3, 0, 2).reshape(
        size, size, mb_w * mb_h).to(I32)


def _fullpel_search(y, ry, mb_w, mb_h, sr, lam_mb, row_off: int = 0):
    """Hierarchical full-pel search (core_jax.py:514): an exhaustive SSD
    search on 4x-mean-downsampled planes over +-cr coarse offsets,
    cr = ceil(sr/4), then a full-resolution +-3 SAD + lambda*mvd-bits
    refine around the upscaled coarse best. row_off: the band's top luma
    row in the (whole, padded) reference ry.

    Returns (mv [n_mb, 2] full-pel, mvp_qx, mvp_qy)."""
    dev = y.device
    n_mb = mb_w * mb_h
    H, W = mb_h * 16, mb_w * 16
    cr = max(1, -(-sr // 4))
    n4 = 2 * cr + 1
    lam_i = lam_mb.to(torch.float32).mean()

    # ---- stage 1: coarse 4x search ----
    y4 = (y.to(I32).reshape(H // 4, 4, W // 4, 4).sum((1, 3), dtype=I32)
          + 8) >> 4
    ry4_full = ry[PAD % 4:, PAD % 4:]
    h4, w4 = ry4_full.shape[0] // 4, ry4_full.shape[1] // 4
    ry4 = (ry4_full[:h4 * 4, :w4 * 4].to(I32).reshape(h4, 4, w4, 4).sum(
        (1, 3), dtype=I32) + 8) >> 4
    PAD4 = PAD // 4
    dxs4 = torch.arange(n4, dtype=I32, device=dev) - cr
    xpen4 = (lam_i * (dxs4.abs() * 16).to(torch.float32)).to(I32)
    best_cost = torch.full((mb_h, mb_w), BIG, dtype=I32, device=dev)
    best_o = torch.zeros((mb_h, mb_w), dtype=torch.int64, device=dev)
    # lax.dynamic_slice clamps its start into the array; so does this
    c0 = min(max(PAD4 - cr, 0), w4 - (W // 4 + 2 * cr))
    for dy in range(-cr, cr + 1):
        r0 = min(max(PAD4 + (row_off >> 2) + dy, 0), h4 - H // 4)
        reg = ry4[r0:r0 + H // 4, c0:c0 + W // 4 + 2 * cr]
        refs = torch.stack([reg[:, k:k + W // 4] for k in range(n4)])
        d = y4[None] - refs
        ssd = (d * d).reshape(n4, mb_h, 4, mb_w, 4).sum((2, 4), dtype=I32)
        ypen = (lam_i * float(abs(dy) * 16)).to(I32)
        cost = ssd * 16 + (xpen4 + ypen)[:, None, None]
        c, k = cost.min(dim=0)          # first minimum, like jnp.argmin
        o = (dy + cr) * n4 + k
        better = c < best_cost
        best_cost = torch.where(better, c, best_cost)
        best_o = torch.where(better, o, best_o)
    cmv_y = ((best_o // n4) - cr).reshape(n_mb).to(I32) * 4
    cmv_x = ((best_o % n4) - cr).reshape(n_mb).to(I32) * 4

    # ---- stage 2: full-res +-3 refine around the coarse best ----
    mvp_qx, mvp_qy = _coarse_mvp(cmv_x, cmv_y, mb_w, mb_h)
    ar = torch.arange(n_mb, device=dev)
    gy = PAD + row_off + (ar // mb_w) * 16 + cmv_y - 3
    gx = PAD + (ar % mb_w) * 16 + cmv_x - 3
    Gw = gather_windows(ry, gy, gx, 22).permute(1, 2, 0)     # [22,22,N]
    src_soa = _soa(y, 16, mb_w, mb_h)
    best = torch.full((n_mb,), BIG, dtype=I32, device=dev)
    best_k = torch.zeros(n_mb, dtype=torch.int64, device=dev)
    for k, (ox, oy) in enumerate(_CANDS):     # oy outer, ox inner
        p = Gw[3 + oy:19 + oy, 3 + ox:19 + ox]
        sad = (src_soa - p).abs().sum((0, 1), dtype=I32)
        bits = _se_nbits((cmv_x + ox) * 4 - mvp_qx) + \
            _se_nbits((cmv_y + oy) * 4 - mvp_qy)
        cost = sad + lam_mb * bits
        better = cost < best
        best = torch.where(better, cost, best)
        best_k = torch.where(better, k, best_k)
    mv = torch.stack([cmv_x, cmv_y], -1) + _const_q("cand_off", dev)[best_k]
    return mv, mvp_qx, mvp_qy


def _skip_mv_field(mv_q, mb_w, mb_h):
    """P_Skip motion (spec 8.4.1.1) over a P16x16 quarter-pel MV field
    (core_jax.py:665)."""
    mv = mv_q.reshape(mb_h, mb_w, 2)
    f = torch.ones((mb_h, mb_w), dtype=torch.bool, device=mv.device)
    availA = _shifted(f, 0, 1, False)
    availB = _shifted(f, 1, 0, False)
    availC = _shifted(f, 1, -1, False)
    availD = _shifted(f, 1, 1, False)
    mvA, mvB = _shifted(mv, 0, 1), _shifted(mv, 1, 0)
    mvC, mvD = _shifted(mv, 1, -1), _shifted(mv, 1, 1)
    mvc = torch.where(availC[..., None], mvC, mvD)
    availc = availC | availD
    n_match = availA.to(I32) + availB.to(I32) + availc.to(I32)
    zero = torch.zeros((), dtype=mv.dtype, device=mv.device)
    a = torch.where(availA[..., None], mvA, zero)
    b = torch.where(availB[..., None], mvB, zero)
    cc = torch.where(availc[..., None], mvc, zero)
    med = _median3(a, b, cc)
    one = torch.where(availA[..., None], mvA,
                      torch.where(availB[..., None], mvB, mvc))
    only_a = (~availB) & (~availc) & availA
    mvp = torch.where((n_match == 1)[..., None], one,
                      torch.where(only_a[..., None], mvA, med))
    a_zero = availA & (mvA[..., 0] == 0) & (mvA[..., 1] == 0)
    b_zero = availB & (mvB[..., 0] == 0) & (mvB[..., 1] == 0)
    skip_zero = (~availA) | (~availB) | a_zero | b_zero
    return torch.where(skip_zero[..., None], zero, mvp).reshape(-1, 2)


def _tap6(a, axis: int):
    """6-tap half-pel filter along axis 0 or 1 of [h, w, N]; the output is
    5 shorter along that axis (core_jax.py:752)."""
    L = a.shape[axis] - 5

    def sh(k):
        return a.narrow(axis, k + 2, L)
    return sh(-2) - 5 * sh(-1) + 20 * sh(0) + 20 * sh(1) - 5 * sh(2) + sh(3)


def _halfpel_planes(G):
    """G [24,24,N] window -> (G, B, H, J) [24,24,N]: half-pel between x and
    x+1 (B), y and y+1 (H), both (J); zero margins as in core_jax."""
    h_, w_, n = G.shape

    def place(vals, y0, x0):
        out = torch.zeros((h_, w_, n), dtype=I32, device=G.device)
        out[y0:y0 + vals.shape[0], x0:x0 + vals.shape[1]] = vals
        return out

    b1 = _tap6(G, 1)                                         # [24,19,N]
    h1 = _tap6(G, 0)                                         # [19,24,N]
    j1 = _tap6(b1, 0)                                        # [19,19,N]
    return (G, place(((b1 + 16) >> 5).clamp(0, 255), 0, 2),
            place(((h1 + 16) >> 5).clamp(0, 255), 2, 0),
            place(((j1 + 512) >> 10).clamp(0, 255), 2, 2))


def _satd16(d):
    """Sum of 4x4 Hadamard-transformed |coefs| over a [16,16,N] diff
    (core_jax.py:805)."""
    b = d.reshape(4, 4, 4, 4, d.shape[-1]).permute(1, 3, 0, 2, 4).reshape(
        4, 4, 16, d.shape[-1])

    def bf(a0, a1, a2, a3):
        t0, t1, t2, t3 = a0 + a3, a1 + a2, a1 - a2, a0 - a3
        return t0 + t1, t3 + t2, t0 - t1, t3 - t2

    vv = torch.stack(bf(b[0], b[1], b[2], b[3]), 0)
    hh = torch.stack(bf(vv[:, 0], vv[:, 1], vv[:, 2], vv[:, 3]), 1)
    return (hh.abs().sum((0, 1, 2), dtype=I32) + 1) >> 1


# every quarter position is avg(sampleA, sampleB) of two of the planes
# {G, B, H, J} at a (dy, dx) shift (avg(a, a) == a): core_jax.py:841-862
_PG, _PB, _PH, _PJ = 0, 1, 2, 3
_QTAB = {
    (0, 0): lambda sy, sx: ((_PG, sy, sx), (_PG, sy, sx)),
    (0, 1): lambda sy, sx: ((_PG, sy, sx), (_PB, sy, sx)),
    (0, 2): lambda sy, sx: ((_PB, sy, sx), (_PB, sy, sx)),
    (0, 3): lambda sy, sx: ((_PG, sy, sx + 1), (_PB, sy, sx)),
    (1, 0): lambda sy, sx: ((_PG, sy, sx), (_PH, sy, sx)),
    (1, 1): lambda sy, sx: ((_PB, sy, sx), (_PH, sy, sx)),
    (1, 2): lambda sy, sx: ((_PB, sy, sx), (_PJ, sy, sx)),
    (1, 3): lambda sy, sx: ((_PB, sy, sx), (_PH, sy, sx + 1)),
    (2, 0): lambda sy, sx: ((_PH, sy, sx), (_PH, sy, sx)),
    (2, 1): lambda sy, sx: ((_PH, sy, sx), (_PJ, sy, sx)),
    (2, 2): lambda sy, sx: ((_PJ, sy, sx), (_PJ, sy, sx)),
    (2, 3): lambda sy, sx: ((_PJ, sy, sx), (_PH, sy, sx + 1)),
    (3, 0): lambda sy, sx: ((_PG, sy + 1, sx), (_PH, sy, sx)),
    (3, 1): lambda sy, sx: ((_PH, sy, sx), (_PB, sy + 1, sx)),
    (3, 2): lambda sy, sx: ((_PJ, sy, sx), (_PB, sy + 1, sx)),
    (3, 3): lambda sy, sx: ((_PH, sy, sx + 1), (_PB, sy + 1, sx)),
}
# the 49 refine candidates, qy outer, qx inner (core_jax.py:819)
_CANDS = [(qx, qy) for qy in range(-3, 4) for qx in range(-3, 4)]


def _vid(e):
    return e[0] * 9 + (e[1] - 2) * 3 + (e[2] - 2)


def _qtab(pairs):
    ta, tb = zip(*(_QTAB[k](sy, sx) for k, sy, sx in pairs))
    return (np.array([_vid(e) for e in ta], np.int64),
            np.array([_vid(e) for e in tb], np.int64))


_CAND_A, _CAND_B = _qtab([((qy & 3, qx & 3), 3 + (qy >> 2), 3 + (qx >> 2))
                          for qx, qy in _CANDS])
_FRAC_A, _FRAC_B = _qtab([((fy, fx), 3, 3)
                          for fy in range(4) for fx in range(4)])
_const_q = constant_cache({"cand_a": _CAND_A, "cand_b": _CAND_B,
                           "frac_a": _FRAC_A, "frac_b": _FRAC_B,
                           "cand_off": np.array(_CANDS, np.int32)})


def _sub_pred(planes, qx: int, qy: int):
    """[16,16,N] prediction for quarter offset (qx, qy) from the integer
    best (core_jax.py:774)."""
    G, Bw, Hw, Jw = planes
    sx, fx = 3 + (qx >> 2), qx & 3
    sy, fy = 3 + (qy >> 2), qy & 3

    def sl(wp, ox, oy):
        return wp[sy + oy:sy + oy + 16, sx + ox:sx + ox + 16]

    def avg(a, b):
        return (a + b + 1) >> 1
    g00 = sl(G, 0, 0)
    if fx == 0 and fy == 0:
        return g00
    b00, h00, j00 = sl(Bw, 0, 0), sl(Hw, 0, 0), sl(Jw, 0, 0)
    if fy == 0:
        return [None, avg(g00, b00), b00, avg(sl(G, 1, 0), b00)][fx]
    if fy == 1:
        return [avg(g00, h00), avg(b00, h00), avg(b00, j00),
                avg(b00, sl(Hw, 1, 0))][fx]
    if fy == 2:
        return [h00, avg(h00, j00), j00, avg(j00, sl(Hw, 1, 0))][fx]
    return [avg(sl(G, 0, 1), h00), avg(h00, sl(Bw, 0, 1)),
            avg(j00, sl(Bw, 0, 1)), avg(sl(Hw, 1, 0), sl(Bw, 0, 1))][fx]


def _qpel_select(planes, va_idx, vb_idx):
    """Per-MB average of two of the 36 (plane, dy, dx) variants: an
    integer gather in place of core_jax's one-hot matmul."""
    n = planes[0].shape[-1]
    S = torch.stack([planes[p][sy:sy + 16, sx:sx + 16]
                     for p in range(4) for sy in (2, 3, 4)
                     for sx in (2, 3, 4)]).reshape(36, 256, n)

    def sel(idx):
        return torch.gather(S, 0, idx.view(1, 1, n).expand(1, 256, n))[0]
    return ((sel(va_idx) + sel(vb_idx) + 1) >> 1).reshape(16, 16, n)


def encode_p_frame(y, u, v, ref_y, ref_u, ref_v, qp, qp_c,
                   mb_w: int, mb_h: int, sr: int = 8, row_off: int = 0,
                   prev_skip_sad=None, prev_skip=None, extra_mv=None):
    """Batched P16x16 encode (core_jax.py:701): full-pel search, windowed
    quarter-pel refine, P_Skip promotion, transforms and inter recon.

    qp / qp_c: Python ints, 0-d int32 tensors, or per-MB [n_mb] arrays
    (the lambda and the SoA quantisers broadcast them per MB).
    row_off: band mode; y/u/v are the MB rows of one band whose top luma
    row is row_off, while ref_* are whole planes, so motion reaches
    outside the band. extra_mv: a quarter-pel [2] screen-content
    candidate (a scroll vector, whole-pel), tried for every MB whose
    16x16 window lies in the padded plane and taken where its cost is
    strictly lower. Returns the symbol tensors, the costs for the
    intra-in-P decision and the recon planes.
    """
    dev = y.device
    n_mb = mb_w * mb_h
    H, W = y.shape
    ry, ru, rv = pad_ref(ref_y), pad_ref(ref_u), pad_ref(ref_v)
    qp = qp_tensor(qp, dev)
    qp_c = qp_tensor(qp_c, dev)
    lam_mb = _const("qp_cost", dev)[qp.clamp(0, 51).long()].expand(n_mb)
    int_mv, mvp_qx, mvp_qy = _fullpel_search(y, ry, mb_w, mb_h, sr, lam_mb,
                                             row_off)
    ar = torch.arange(n_mb, device=dev)
    mby, mbx = ar // mb_w, ar % mb_w

    # ---- quarter-pel refinement over the full +-3 quarter box ----
    gy = PAD - 3 + row_off + mby * 16 + int_mv[:, 1]
    gx = PAD - 3 + mbx * 16 + int_mv[:, 0]
    planes = _halfpel_planes(gather_windows(ry, gy, gx, 24).permute(1, 2, 0))
    src_soa = _soa(y, 16, mb_w, mb_h)
    best_cost = torch.full((n_mb,), BIG, dtype=I32, device=dev)
    best_q = torch.zeros(n_mb, dtype=torch.int64, device=dev)
    for k, (qx, qy) in enumerate(_CANDS):
        c = _satd16(src_soa - _sub_pred(planes, qx, qy)) + lam_mb * (
            _se_nbits(int_mv[:, 0] * 4 + qx - mvp_qx)
            + _se_nbits(int_mv[:, 1] * 4 + qy - mvp_qy))
        better = c < best_cost
        best_cost = torch.where(better, c, best_cost)
        best_q = torch.where(better, k, best_q)
    best_mv = int_mv * 4 + _const_q("cand_off", dev)[best_q]
    pred_soa = _qpel_select(planes, _const_q("cand_a", dev)[best_q],
                            _const_q("cand_b", dev)[best_q])

    if extra_mv is not None:
        # screen-content global candidate (core_jax.py:890-912): whole-MB
        # window at the scroll vector, only where it lies in the plane
        emv = torch.as_tensor(np.asarray(extra_mv, np.int32), device=dev)
        ei = emv >> 2
        gye = PAD + row_off + mby * 16 + ei[1]
        gxe = PAD + mbx * 16 + ei[0]
        Hp, Wp = ry.shape
        valid_e = (gye >= 0) & (gye <= Hp - 16) & (gxe >= 0) & \
            (gxe <= Wp - 16)
        pred_e = gather_windows(ry, gye.clamp(0, Hp - 16),
                                gxe.clamp(0, Wp - 16), 16).permute(1, 2, 0)
        bits_e = _se_nbits(emv[0] - mvp_qx) + _se_nbits(emv[1] - mvp_qy)
        cost_e = _satd16(src_soa - pred_e) + lam_mb * bits_e
        take = valid_e & (cost_e < best_cost)
        best_mv = torch.where(take[:, None], emv[None, :], best_mv)
        pred_soa = torch.where(take[None, None, :], pred_e, pred_soa)
        best_cost = torch.where(take, cost_e, best_cost)

    # ---- early-skip promotion (core_jax.py:914-1017) ----
    skip_q = _skip_mv_field(best_mv, mb_w, mb_h)               # [N,2]
    sk_int = skip_q >> 2
    gy2 = PAD - 3 + row_off + mby * 16 + sk_int[:, 1]
    gx2 = PAD - 3 + mbx * 16 + sk_int[:, 0]
    planes2 = _halfpel_planes(
        gather_windows(ry, gy2, gx2, 24).permute(1, 2, 0))
    frac_idx = ((skip_q[:, 1] & 3) * 4 + (skip_q[:, 0] & 3)).long()
    pred_skip = _qpel_select(planes2, _const_q("frac_a", dev)[frac_idx],
                             _const_q("frac_b", dev)[frac_idx])
    sad_skip_luma = (src_soa - pred_skip).abs().sum((0, 1), dtype=I32)

    def chroma_pred(refc, mv_q):
        cfx = (mv_q[:, 0] % 8)[None, None, :]
        cfy = (mv_q[:, 1] % 8)[None, None, :]
        cgy = PAD + (row_off >> 1) + mby * 8 + (mv_q[:, 1] >> 3)
        cgx = PAD + mbx * 8 + (mv_q[:, 0] >> 3)
        Wn = gather_windows(refc, cgy, cgx, 10).permute(1, 2, 0)  # [10,10,N]
        return ((8 - cfx) * (8 - cfy) * Wn[0:8, 0:8]
                + cfx * (8 - cfy) * Wn[0:8, 1:9]
                + (8 - cfx) * cfy * Wn[1:9, 0:8]
                + cfx * cfy * Wn[1:9, 1:9] + 32) >> 6           # [8,8,N]

    src_u_soa = _soa(u, 8, mb_w, mb_h)
    src_v_soa = _soa(v, 8, mb_w, mb_h)
    sad_skip = sad_skip_luma \
        + (src_u_soa - chroma_pred(ru, skip_q)).abs().sum((0, 1), dtype=I32) \
        + (src_v_soa - chroma_pred(rv, skip_q)).abs().sum((0, 1), dtype=I32)

    if prev_skip_sad is None:
        prev_skip_sad = torch.zeros(n_mb, dtype=I32, device=dev)
        prev_skip = torch.zeros(n_mb, dtype=torch.bool, device=dev)
    promote = (sad_skip == 0) | (prev_skip.bool() &
                                 (sad_skip < prev_skip_sad.to(I32)))
    # neighbour skip-SAD threshold (PredictSadSkip, md.cpp:871-906), as a
    # three-round fixed point over the whole frame
    sgl = sad_skip_luma.reshape(mb_h, mb_w)
    right_edge = torch.zeros((mb_h, mb_w), dtype=torch.bool, device=dev)
    right_edge[:, -1] = True
    top_row = torch.zeros((mb_h, mb_w), dtype=torch.bool, device=dev)
    top_row[0] = True
    has_left = torch.zeros((mb_h, mb_w), dtype=torch.bool, device=dev)
    has_left[:, 1:] = True
    zero = torch.zeros((), dtype=I32, device=dev)
    sgA, sgB = _shifted(sgl, 0, 1), _shifted(sgl, 1, 0)
    sgC, sgD = _shifted(sgl, 1, -1), _shifted(sgl, 1, 1)
    for _ in range(3):
        g = promote.reshape(mb_h, mb_w)
        skA, skB = _shifted(g, 0, 1, False), _shifted(g, 1, 0, False)
        skD = _shifted(g, 1, 1, False)
        # C = top-right; at the right edge it falls back to D (top-left)
        skC = torch.where(right_edge, skD, _shifted(g, 1, -1, False))
        sA = torch.where(skA, sgA, zero)
        sB = torch.where(skB, sgB, zero)
        sC_ = torch.where(skC & ~right_edge, sgC, zero)
        sD_ = torch.where(skC & right_edge, sgD, zero)
        sC = torch.where(right_edge, sD_, sC_)
        cnt = skA.to(I32) + skB.to(I32) + skC.to(I32)
        med = _median3(sA, sB, sC)
        one = torch.where(skA, sA, torch.where(skB, sB, sC))
        thr = torch.where(cnt == 1, one, med)
        thr = torch.where(top_row & has_left, sA, thr)
        promote = promote | (sad_skip < thr.reshape(-1))
    best_mv = torch.where(promote[:, None], skip_q, best_mv)
    pred_soa = torch.where(promote[None, None, :], pred_skip, pred_soa)

    # ---- luma transform path, all SoA [4, 4, 16 blocks, N] ----
    def mb16_to_blocks(x):
        return x.reshape(4, 4, 4, 4, n_mb).permute(1, 3, 0, 2, 4).reshape(
            4, 4, 16, n_mb)

    predb = mb16_to_blocks(pred_soa)
    coef = dct4x4_soa(mb16_to_blocks(src_soa) - predb)
    lev = quant4x4_soa(coef, qp, False)
    lev = torch.where(promote[None, None, None, :], zero, lev)
    recb = idct4x4_add_soa(predb, dequant4x4_soa(lev, qp))
    rec_y_plane = recb.reshape(4, 4, 4, 4, mb_h, mb_w).permute(
        4, 2, 0, 5, 3, 1).reshape(H, W).to(U8)

    # ---- chroma MC + transforms ----
    def mb8_to_blocks(x):
        return x.reshape(2, 4, 2, 4, n_mb).permute(1, 3, 0, 2, 4).reshape(
            4, 4, 4, n_mb)

    def chroma_tx(src_c, pred_c):
        predcb = mb8_to_blocks(pred_c)
        cf = dct4x4_soa(mb8_to_blocks(src_c) - predcb)
        dc_lev = quant_dc_soa(hadamard2x2_soa(cf[0, 0].reshape(2, 2, n_mb)),
                              qp_c, False)
        ac_lev = quant4x4_soa(cf, qp_c, False)
        ac_lev[0, 0] = 0
        dc_lev = torch.where(promote[None, None, :], zero, dc_lev)
        ac_lev = torch.where(promote[None, None, None, :], zero, ac_lev)
        rec_dc = chroma_dc_dequant_ihadamard_soa(dc_lev, qp_c)
        dq = dequant4x4_soa(ac_lev, qp_c)
        dq[0, 0] = rec_dc.reshape(4, n_mb)
        rec = idct4x4_add_soa(predcb, dq)                    # [4,4,4,N]
        plane = rec.reshape(4, 4, 2, 2, mb_h, mb_w).permute(
            4, 2, 0, 5, 3, 1).reshape(H // 2, W // 2).to(U8)
        return (dc_lev.reshape(4, n_mb).T,
                ac_lev.permute(3, 2, 0, 1).reshape(n_mb, 4, 16), plane)

    dcu, acu, rec_u_plane = chroma_tx(src_u_soa, chroma_pred(ru, best_mv))
    dcv, acv, rec_v_plane = chroma_tx(src_v_soa, chroma_pred(rv, best_mv))

    # intra-vs-inter cost: DC-pred intra SATD proxy
    mb_mean = (src_soa.sum((0, 1), dtype=I32) + 128) >> 8
    intra_satd = _satd16(src_soa - mb_mean[None, None, :])

    # natural skips (residual quantized to zero at the skip vector) also
    # seed the next frame's skip-SAD chain
    natural = (~promote) & (best_mv == skip_q).all(1) & \
        ~lev.bool().any(0).any(0).any(0) & \
        ~dcu.bool().any(1) & ~dcv.bool().any(1) & \
        ~acu.bool().flatten(1).any(1) & ~acv.bool().flatten(1).any(1)
    return {
        "mv": best_mv,
        "inter_cost": best_cost,
        "skip_mask": promote | natural,
        "skip_sad": sad_skip_luma,
        "intra_cost_proxy": intra_satd,
        "luma_ac": lev.permute(3, 2, 0, 1).reshape(n_mb, 16, 16),
        "chroma_dc": torch.stack([dcu, dcv], 1),
        "chroma_ac": torch.stack([acu, acv], 1),
        "recon_y": rec_y_plane,
        "recon_u": rec_u_plane,
        "recon_v": rec_v_plane,
    }
