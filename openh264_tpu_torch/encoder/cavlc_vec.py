"""Vectorized CAVLC slice writing: whole-frame symbolization in numpy.

Two-phase entropy per SURVEY §7: the jitted core emits dense symbol
tensors; this module turns a whole P-slice's worth of them into the
bitstream with batched table lookups + one boolean-mask bit pack —
replacing the per-MB/per-coefficient Python walk (the reference's
per-MB WelsSpatialWriteMbSyn loop, svc_set_mb_syn_cavlc.cpp:260, is the
serial analog). Bit-exact with cavlc_enc.write_residual_block — tests
compare against the scalar writer.

Token representation: (val uint32, len uint8) pairs in fixed slot
layouts; a slot with len 0 is absent. Flattening slots row-major and
boolean-masking yields the exact concatenation order.

Copied from openh264_tpu/encoder/cavlc_vec.py (ue/se codes, residual
tokens, MVP, write_p_slice_tokens, assemble_rbsp). assemble_rbsp always
packs with the host C bitpack (cbind.py); the numpy bit packer that the
JAX package falls back to is not copied.
"""

from __future__ import annotations

import numpy as np

from ..tables import ZIGZAG_4x4, ZSCAN_TO_RASTER
from ..tables.cavlc import (CBP_INTER_INV, COEFF_TOKEN, RUN_BEFORE,
                            TOTAL_ZEROS, TOTAL_ZEROS_CHROMA_DC)
from .cbind import bitpack

# residual-block slot layout: 1 coeff_token + 3 t1 signs + 16 levels
# (prefix+suffix fused, <=28 bits) + 1 total_zeros + 14 run_before
RES_SLOTS = 35


def ue_bits(v):
    """Exp-Golomb ue(v): (val, len) arrays."""
    v = np.atleast_1d(np.asarray(v, np.int64))
    vp1 = v + 1
    nbits = np.floor(np.log2(vp1.astype(np.float64))).astype(np.int64)
    return vp1.astype(np.uint32), (2 * nbits + 1).astype(np.uint8)


def se_bits(v):
    """Exp-Golomb se(v)."""
    v = np.asarray(v, np.int64)
    code = np.where(v > 0, 2 * v - 1, -2 * v)
    return ue_bits(code)


def residual_tokens(coeffs: np.ndarray, nc: np.ndarray, max_coeff: int):
    """coeffs: [B, max_coeff] levels in scan order; nc: [B] (-1 for
    chroma DC). Returns (vals [B,RES_SLOTS] u32, lens [B,RES_SLOTS] u8,
    total [B])."""
    B, mc = coeffs.shape
    assert mc == max_coeff
    vals = np.zeros((B, RES_SLOTS), np.uint32)
    lens = np.zeros((B, RES_SLOTS), np.uint8)
    c = coeffs.astype(np.int32)
    m = c != 0
    total = m.sum(1).astype(np.int32)

    # ordered nonzero positions (stable argsort of ~mask)
    order = np.argsort(~m, axis=1, kind="stable")           # [B, mc]
    jj = np.arange(mc)[None, :]
    pos = np.where(jj < total[:, None], order, 0)           # nz positions
    vnz = np.take_along_axis(c, order, 1)                   # values at pos
    vnz = np.where(jj < total[:, None], vnz, 0)

    def at(j):
        """value of the j-th (0-based) nonzero, j possibly negative."""
        jc = np.clip(j, 0, mc - 1)
        return np.take_along_axis(vnz, jc[:, None], 1)[:, 0]

    # trailing ones (up to 3, from the end)
    t_idx = total - 1
    c1 = (total >= 1) & (np.abs(at(t_idx)) == 1)
    c2 = c1 & (total >= 2) & (np.abs(at(t_idx - 1)) == 1)
    c3 = c2 & (total >= 3) & (np.abs(at(t_idx - 2)) == 1)
    t1 = c1.astype(np.int32) + c2 + c3

    # coeff_token
    cls = np.where(nc < 0, 4,
                   np.where(nc < 2, 0,
                            np.where(nc < 4, 1, np.where(nc < 8, 2, 3))))
    tok = COEFF_TOKEN[cls, total, t1]                       # [B, 2]
    vals[:, 0] = tok[:, 0]
    lens[:, 0] = tok[:, 1]

    # t1 signs (highest frequency first)
    for k in range(3):
        sel = t1 > k
        vals[sel, 1 + k] = (at(t_idx - k)[sel] < 0).astype(np.uint32)
        lens[sel, 1 + k] = 1

    # levels with adaptive suffix length
    sl = ((total > 10) & (t1 < 3)).astype(np.int32)
    n_lev = total - t1
    for k in range(mc):
        j = n_lev - 1 - k
        act = j >= 0
        if not act.any():
            break
        level = at(j)
        absl = np.abs(level)
        lc = ((absl - 1) << 1) | (level < 0)
        lc = np.where(act & (k == 0) & (t1 < 3), lc - 2, lc)
        # encode with current suffix length sl
        v0 = np.where(lc < 14, np.uint32(1),
                      np.where(lc < 30, np.uint32((1 << 4)) | (lc - 14).astype(np.uint32) & 0xF,
                               np.uint32(1 << 12) | ((lc - 30).astype(np.uint32) & 0xFFF)))
        l0 = np.where(lc < 14, lc + 1, np.where(lc < 30, 19, 28)).astype(np.int64)
        pre = lc >> np.maximum(sl, 1)
        mask = (1 << np.maximum(sl, 1)) - 1
        vs = np.where(pre < 15,
                      ((np.uint32(1) << sl.astype(np.uint32)) |
                       (lc & mask).astype(np.uint32)),
                      np.uint32(1 << 12) |
                      ((lc - (15 << np.maximum(sl, 1))).astype(np.uint32) & 0xFFF))
        ls = np.where(pre < 15, pre + 1 + sl, 28).astype(np.int64)
        use0 = sl == 0
        val_k = np.where(use0, v0, vs)
        len_k = np.where(use0, l0, ls)
        vals[act, 4 + k] = val_k[act]
        lens[act, 4 + k] = len_k[act]
        # suffix-length update (exact scalar-writer order)
        sl = np.where(act & (sl == 0), 1, sl)
        sl = np.where(act & (absl > (3 << np.maximum(sl - 1, 0))) & (sl < 6),
                      sl + 1, sl)

    # total_zeros
    last_pos = np.take_along_axis(pos, np.clip(total - 1, 0, mc - 1)[:, None],
                                  1)[:, 0]
    zeros = last_pos + 1 - total
    tz_act = (total > 0) & (total < mc)
    tz_tab = TOTAL_ZEROS_CHROMA_DC if mc == 4 else TOTAL_ZEROS
    tz = tz_tab[np.clip(total, 0, tz_tab.shape[0] - 1),
                np.clip(zeros, 0, tz_tab.shape[1] - 1)]
    vals[tz_act, 20] = tz[tz_act, 0]
    lens[tz_act, 20] = tz[tz_act, 1]

    # run_before (highest frequency first, stop when zeros exhausted)
    zl = np.where(tz_act, zeros, 0)
    for k in range(mc - 1):
        j = total - 1 - k
        act = (j >= 1) & (zl > 0)
        if not act.any():
            break
        jp = np.clip(j, 1, mc - 1)
        pj = np.take_along_axis(pos, jp[:, None], 1)[:, 0]
        pj1 = np.take_along_axis(pos, (jp - 1)[:, None], 1)[:, 0]
        run = pj - pj1 - 1
        rb = RUN_BEFORE[np.clip(zl, 0, 7), np.clip(run, 0, RUN_BEFORE.shape[1] - 1)]
        vals[act, 21 + k] = rb[act, 0]
        lens[act, 21 + k] = rb[act, 1]
        zl = np.where(act, zl - run, zl)

    return vals, lens, total


def _mvp_p16x16(mv: np.ndarray, mb_w: int, mb_h: int, intra=None):
    """Vectorized §8.4.1.3 median MVP and §8.4.1.1 skip-MV for a frame
    of P16x16 ref-0 MBs (single slice), optionally with intra MBs whose
    neighbors count as available-but-ref-mismatched (mv contribution 0).
    mv: [mb_h, mb_w, 2]. Returns (mvp, skip_mv) [mb_h,mb_w,2]."""
    if intra is None:
        intra = np.zeros((mb_h, mb_w), bool)
    mv = np.where(intra[..., None], 0, mv)
    z = np.zeros_like(mv)
    availA = np.zeros((mb_h, mb_w), bool)
    availA[:, 1:] = True
    availB = np.zeros((mb_h, mb_w), bool)
    availB[1:, :] = True
    availC = np.zeros((mb_h, mb_w), bool)
    availC[1:, :-1] = True
    availD = np.zeros((mb_h, mb_w), bool)
    availD[1:, 1:] = True

    mvA = z.copy();  mvA[:, 1:] = mv[:, :-1]
    mvB = z.copy();  mvB[1:, :] = mv[:-1, :]
    mvC = z.copy();  mvC[1:, :-1] = mv[:-1, 1:]  # top-right
    mvD = z.copy();  mvD[1:, 1:] = mv[:-1, :-1]
    inA = np.zeros((mb_h, mb_w), bool); inA[:, 1:] = intra[:, :-1]
    inB = np.zeros((mb_h, mb_w), bool); inB[1:, :] = intra[:-1, :]
    inC = np.zeros((mb_h, mb_w), bool); inC[1:, :-1] = intra[:-1, 1:]
    inD = np.zeros((mb_h, mb_w), bool); inD[1:, 1:] = intra[:-1, :-1]
    useC = availC
    mvc = np.where(useC[..., None], mvC, mvD)
    availc = availC | availD
    intrac = np.where(useC, inC, inD)
    # "matches" = available AND inter with ref 0 (intra -> no match)
    matchA = availA & ~inA
    matchB = availB & ~inB
    matchC = availc & ~intrac
    n_match = matchA.astype(np.int32) + matchB + matchC
    # median of available (unavailable = 0; intra contributes mv 0)
    a = np.where(availA[..., None], mvA, 0)
    b = np.where(availB[..., None], mvB, 0)
    cc = np.where(availc[..., None], mvc, 0)
    med = a + b + cc - np.minimum(np.minimum(a, b), cc) \
        - np.maximum(np.maximum(a, b), cc)
    one = np.where(matchA[..., None], mvA,
                   np.where(matchB[..., None], mvB, mvc))
    only_a = (~availB) & (~availc) & availA
    mvp = np.where((n_match == 1)[..., None], one,
                   np.where(only_a[..., None], mvA, med))
    # skip MV: 0 unless both A and B exist and neither is (ref0, mv 0);
    # an intra neighbor has ref -1, so it does not force zero
    a_zero = availA & ~inA & (mvA[..., 0] == 0) & (mvA[..., 1] == 0)
    b_zero = availB & ~inB & (mvB[..., 0] == 0) & (mvB[..., 1] == 0)
    skip_zero = (~availA) | (~availB) | a_zero | b_zero
    skip_mv = np.where(skip_zero[..., None], 0, mvp)
    return mvp, skip_mv


# raster 4x4 block -> its 8x8 block
_B8MAP = (np.arange(16) // 8) * 2 + (np.arange(16) % 4) // 2


def _p_mb_modes(out: dict, mb_w: int, mb_h: int):
    """Per MB of a P16x16 slice: (mvf [N, 2], luma, cdc, cac, intra,
    cbp_luma, cbp_chroma, cbp, mvp, is_skip)."""
    n_mb = mb_w * mb_h
    mv = np.asarray(out["mv"], np.int32).reshape(mb_h, mb_w, 2)
    luma = np.asarray(out["luma_ac"], np.int32)             # [N,16,16]
    cdc = np.asarray(out["chroma_dc"], np.int32)            # [N,2,4]
    cac = np.asarray(out["chroma_ac"], np.int32)            # [N,2,4,16]
    im = out.get("intra_mask")
    intra = (np.asarray(im, bool).reshape(n_mb) if im is not None
             else np.zeros(n_mb, bool))

    # cbp per MB
    nz_blk = luma.any(2)                                    # [N,16] raster
    cbp_luma = np.zeros(n_mb, np.int32)
    for b8 in range(4):
        cbp_luma |= nz_blk[:, _B8MAP == b8].any(1).astype(np.int32) << b8
    # I16x16 MBs: cbp_luma is all-or-nothing (carried in mb_type)
    cbp_luma = np.where(intra, np.where(nz_blk.any(1), 15, 0), cbp_luma)
    cbp_chroma = np.where(cac.reshape(n_mb, -1).any(1), 2,
                          np.where(cdc.reshape(n_mb, -1).any(1), 1, 0))
    cbp = cbp_luma | (cbp_chroma << 4)

    mvp, skip_mv = _mvp_p16x16(mv, mb_w, mb_h,
                               intra=intra.reshape(mb_h, mb_w))
    mvf = mv.reshape(n_mb, 2)
    is_skip = (cbp == 0) & (mvf == skip_mv.reshape(n_mb, 2)).all(1) & ~intra
    return (mvf, luma, cdc, cac, intra, cbp_luma, cbp_chroma, cbp, mvp,
            is_skip)


def p_skip_mask(out: dict, mb_w: int, mb_h: int) -> np.ndarray:
    """[N] bool: the MBs that write_p_slice_tokens codes as P_Skip."""
    return _p_mb_modes(out, mb_w, mb_h)[-1]


def write_p_slice_tokens(out: dict, mb_w: int, mb_h: int):
    """Token arrays for a whole P16x16 CAVLC slice body.

    Returns (vals, lens) flat arrays in stream order."""
    n_mb = mb_w * mb_h
    (mvf, luma, cdc, cac, intra, cbp_luma, cbp_chroma, cbp, mvp,
     is_skip) = _p_mb_modes(out, mb_w, mb_h)

    # skip runs: for each coded MB, number of skips since last coded
    coded_idx = np.nonzero(~is_skip)[0]
    csum = np.cumsum(is_skip)
    if len(coded_idx):
        starts = np.concatenate([[-1], coded_idx[:-1]])
        prev_coded = csum[coded_idx] - np.where(starts >= 0, csum[starts], 0)
        trailing_skips = int(is_skip[coded_idx[-1]:].sum())
    else:
        prev_coded = np.zeros(0, np.int64)
        trailing_skips = int(is_skip.sum())

    # ---- per-MB header tokens [N, 6] ----
    # inter: [skiprun][mb_type=ue0][mvdx][mvdy][cbp][dqp(se0) if cbp]
    # intra: [skiprun][mb_type=ue(5+i16raw)][chroma_mode][dqp(se0)][-][-]
    hv = np.zeros((n_mb, 6), np.uint32)
    hl = np.zeros((n_mb, 6), np.uint8)
    mvd = mvf - mvp.reshape(n_mb, 2)
    if len(coded_idx):
        sv, sl_ = ue_bits(prev_coded)
        hv[coded_idx, 0] = sv
        hl[coded_idx, 0] = sl_
    # per-MB delta QP chain (adaptive quant): mb_qp_delta is signaled
    # only on MBs with coded residual; the running value carries over
    mb_qp = out.get("mb_qp")
    slice_qp = out.get("slice_qp")
    if mb_qp is not None:
        mb_qp = np.asarray(mb_qp, np.int64).reshape(n_mb)
        res_mb = (~is_skip) & ((cbp != 0) | intra)
        lastr = np.maximum.accumulate(
            np.where(res_mb, np.arange(n_mb), -1))
        prev_res = np.concatenate([[-1], lastr[:-1]])
        prev_qp = np.where(prev_res >= 0,
                           mb_qp[np.clip(prev_res, 0, None)],
                           int(slice_qp))
        dqp = mb_qp - prev_qp
    else:
        dqp = np.zeros(n_mb, np.int64)
    ci_inter = coded_idx[~intra[coded_idx]] if len(coded_idx) else coded_idx
    if len(ci_inter):
        hv[ci_inter, 1], hl[ci_inter, 1] = 1, 1             # ue(0) mb_type
        v, l = se_bits(mvd[ci_inter, 0])
        hv[ci_inter, 2], hl[ci_inter, 2] = v, l
        v, l = se_bits(mvd[ci_inter, 1])
        hv[ci_inter, 3], hl[ci_inter, 3] = v, l
        v, l = ue_bits(CBP_INTER_INV[cbp[ci_inter]])
        hv[ci_inter, 4], hl[ci_inter, 4] = v, l
        has_res = cbp[ci_inter] != 0
        ir = ci_inter[has_res]
        v, l = se_bits(dqp[ir])
        hv[ir, 5], hl[ir, 5] = v, l
    ci_intra = np.nonzero(intra)[0]
    if len(ci_intra):
        i16m = np.asarray(out["i16_mode"], np.int64).reshape(-1)[ci_intra]
        cmode = np.asarray(out["chroma_mode"], np.int64).reshape(-1)[ci_intra]
        raw = 1 + i16m + 4 * cbp_chroma[ci_intra] + \
            12 * (cbp_luma[ci_intra] != 0)
        v, l = ue_bits(5 + raw)                              # P-slice offset
        hv[ci_intra, 1], hl[ci_intra, 1] = v, l
        v, l = ue_bits(cmode)
        hv[ci_intra, 2], hl[ci_intra, 2] = v, l
        v, l = se_bits(dqp[ci_intra])
        hv[ci_intra, 3], hl[ci_intra, 3] = v, l              # mb_qp_delta

    # ---- residual tokens ----
    # nzc grids for nC contexts (final values, order-independent).
    # Intra (I16) blocks count only their 15 AC coefficients.
    zz_all = np.take_along_axis(
        luma, np.broadcast_to(ZIGZAG_4x4[None, None, :], luma.shape), 2)
    tc_blk = np.count_nonzero(zz_all, axis=2)
    tc_blk_i16 = np.count_nonzero(zz_all[:, :, 1:], axis=2)
    tc_blk = np.where(intra[:, None], tc_blk_i16, tc_blk)
    blk_coded = (cbp_luma[:, None] >> _B8MAP[None, :]) & 1
    tc_blk = tc_blk * blk_coded * (~is_skip[:, None])
    nzc_l = tc_blk.reshape(mb_h, mb_w, 4, 4).transpose(0, 2, 1, 3).reshape(
        mb_h * 4, mb_w * 4)
    # chroma tc
    cac_z = np.take_along_axis(
        cac, np.broadcast_to(ZIGZAG_4x4[None, None, None, :], cac.shape), 3)
    tc_c = np.count_nonzero(cac_z[..., 1:], axis=3)         # [N,2,4]
    coded_c = (cbp_chroma == 2)[:, None, None]
    tc_c = tc_c * coded_c
    nzc_c = tc_c.reshape(mb_h, mb_w, 2, 2, 2).transpose(2, 0, 3, 1, 4).reshape(
        2, mb_h * 2, mb_w * 2)

    def nc_from(nzc):
        """nC per block position (§9.2.1): avg when both neighbors
        available, else the available one, else 0."""
        h, w = nzc.shape
        na = np.full((h, w), -1, np.int64)
        na[:, 1:] = nzc[:, :-1]
        nb = np.full((h, w), -1, np.int64)
        nb[1:, :] = nzc[:-1, :]
        both = (na >= 0) & (nb >= 0)
        nc = np.where(both, (na + nb + 1) >> 1, np.maximum(na, nb))
        return np.maximum(nc, 0)

    nc_l = nc_from(nzc_l)                                   # [H4, W4]
    nc_u = nc_from(nzc_c[0])
    nc_v = nc_from(nzc_c[1])

    # luma residual: 16 blocks per MB in ZSCAN order, max_coeff 16
    zz = luma[:, :, ZIGZAG_4x4]                             # [N,16,16] scan
    # reorder blocks to zscan
    zz_z = zz[:, ZSCAN_TO_RASTER, :]                        # [N,16z,16]
    # nC per (mb, zscan block)
    bx = (ZSCAN_TO_RASTER % 4)[None, :] + (np.arange(n_mb) % mb_w)[:, None] * 4
    by = (ZSCAN_TO_RASTER // 4)[None, :] + (np.arange(n_mb) // mb_w)[:, None] * 4
    nc_lb = nc_l[by, bx]                                    # [N,16]
    lv, ll, _ = residual_tokens(zz_z.reshape(-1, 16),
                                nc_lb.reshape(-1), 16)
    lv = lv.reshape(n_mb, 16, RES_SLOTS)
    ll = ll.reshape(n_mb, 16, RES_SLOTS)
    # blocks only written when their 8x8 is coded (and MB coded)
    wmask = (blk_coded[:, ZSCAN_TO_RASTER] & ~is_skip[:, None]).astype(bool)
    ll = ll * wmask[:, :, None]
    # intra (I16) luma: DC block (Hadamard, 16 coeffs) + 15-coeff AC
    dvv = np.zeros((n_mb, RES_SLOTS), np.uint32)
    dll = np.zeros((n_mb, RES_SLOTS), np.uint8)
    ci_intra2 = np.nonzero(intra)[0]
    if len(ci_intra2):
        ldc = np.asarray(out["luma_dc"], np.int32).reshape(n_mb, 16)
        dc_scan = ldc[ci_intra2][:, ZIGZAG_4x4]
        gx0 = (ci_intra2 % mb_w) * 4
        gy0 = (ci_intra2 // mb_w) * 4
        vv, lld, _ = residual_tokens(dc_scan, nc_l[gy0, gx0], 16)
        dvv[ci_intra2] = vv
        dll[ci_intra2] = lld
        vv, lla, _ = residual_tokens(
            zz_z[ci_intra2][:, :, 1:].reshape(-1, 15),
            nc_lb[ci_intra2].reshape(-1), 15)
        lv[ci_intra2] = vv.reshape(-1, 16, RES_SLOTS)
        ll[ci_intra2] = lla.reshape(-1, 16, RES_SLOTS) * \
            wmask[ci_intra2][:, :, None]

    # chroma DC: [N,2,4], nc = -1
    dcv, dcl, _ = residual_tokens(cdc.reshape(-1, 4),
                                  np.full(n_mb * 2, -1), 4)
    dcv = dcv.reshape(n_mb, 2, RES_SLOTS)
    dcl = dcl.reshape(n_mb, 2, RES_SLOTS)
    dcl = dcl * (cbp_chroma > 0)[:, None, None]

    # chroma AC: [N,2,4,15]
    cx = (np.arange(n_mb) % mb_w)[:, None] * 2 + np.arange(4)[None, :] % 2
    cy = (np.arange(n_mb) // mb_w)[:, None] * 2 + np.arange(4)[None, :] // 2
    nc_ub = nc_u[cy, cx]                                    # [N,4]
    nc_vb = nc_v[cy, cx]
    acv, acl, _ = residual_tokens(
        cac_z[:, :, :, 1:].reshape(-1, 15),
        np.stack([nc_ub, nc_vb], 1).reshape(-1), 15)
    acv = acv.reshape(n_mb, 2, 4, RES_SLOTS)
    acl = acl.reshape(n_mb, 2, 4, RES_SLOTS)
    acl = acl * (cbp_chroma == 2)[:, None, None, None]

    # ---- assemble stream order per MB ----
    SL = 6 + RES_SLOTS + 16 * RES_SLOTS + 2 * RES_SLOTS + 8 * RES_SLOTS
    av = np.zeros((n_mb, SL), np.uint32)
    al = np.zeros((n_mb, SL), np.uint8)
    av[:, :6] = hv
    al[:, :6] = hl
    o = 6
    av[:, o:o + RES_SLOTS] = dvv                            # I16 luma DC
    al[:, o:o + RES_SLOTS] = dll
    o += RES_SLOTS
    av[:, o:o + 16 * RES_SLOTS] = lv.reshape(n_mb, -1)
    al[:, o:o + 16 * RES_SLOTS] = ll.reshape(n_mb, -1)
    o += 16 * RES_SLOTS
    av[:, o:o + 2 * RES_SLOTS] = dcv.reshape(n_mb, -1)
    al[:, o:o + 2 * RES_SLOTS] = dcl.reshape(n_mb, -1)
    o += 2 * RES_SLOTS
    av[:, o:] = acv.reshape(n_mb, -1)
    al[:, o:] = acl.reshape(n_mb, -1)

    # trailing skip run
    tail_v = tail_l = None
    if trailing_skips or len(coded_idx) == 0:
        v, l = ue_bits(np.int64(trailing_skips))
        tail_v = np.array([v], np.uint32)
        tail_l = np.array([l], np.uint8)
    return av, al, tail_v, tail_l


def assemble_rbsp(hdr_bits: np.ndarray, token_groups) -> bytes:
    """Header bits + ordered token groups + rbsp trailing -> bytes,
    packed by the host C bit packer."""
    total = int(len(hdr_bits)) + 16
    for _, l in token_groups:
        total += int(l.astype(np.int64).sum())
    out = np.zeros(total // 8 + 8, np.uint8)
    pos = bitpack(hdr_bits.astype(np.uint32),
                  np.ones(len(hdr_bits), np.uint8), out, 0)
    for v, l in token_groups:
        pos = bitpack(v, l, out, pos)
    pos = bitpack(np.array([1], np.uint32), np.array([1], np.uint8),
                  out, pos)
    return out[:(pos + 7) // 8].tobytes()
