"""CAVLC tokenization of whole slices and the bit packer, in PyTorch.

Port of openh264_tpu/encoder/entropy_jax.py, bit-exact with it: the
core's symbol tensors become (value, length) token grids whose
row-major slot order is the stream order, and the packer writes the
live tokens MSB-first into a byte buffer on the device.

Translation notes:
- token values are int32 (every value the tokenizer emits is < 2**25)
  and lengths uint8, as in entropy_jax;
- the one-hot matmul lookups and permutations (_lut, _perm_last,
  _perm_mid) are integer indexing here: exact, with no float product;
- the packer fuses (len << 16 | val) and shifts in int64 where JAX used
  uint32, and keeps the low byte with `& 0xFF`, which is the same byte;
- JAX drops out-of-range byte writes (`mode="drop"`); here they are sent
  to a spare slot past the buffer, which is then cut off;
- the intra token variants of p_slice_tokens are always computed and
  selected per MB, where JAX skipped them by a lax.cond when no MB is
  intra: the result is the same, with no host sync;
- live tokens are compacted by one scatter to their ranks instead of
  the bit-plane shifts of _compact_rows: the same order and result.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import constant_cache
from ..tables import ZIGZAG_4x4, ZSCAN_TO_RASTER
from ..tables.cavlc import (CBP_INTER_INV, COEFF_TOKEN, RUN_BEFORE,
                            TOTAL_ZEROS, TOTAL_ZEROS_CHROMA_DC)
from .core_torch import _median3, _shifted, pow2_count

I32 = torch.int32
I64 = torch.int64
U8 = torch.uint8

# per-residual-block slot layout: 1 coeff_token + 16 sign-or-level
# (descending scan position) + 1 total_zeros + 16 run_before
RES_SLOTS = 34
P_SLOTS = 6 + RES_SLOTS * (1 + 16 + 2 + 8)

_B8MAP = ((np.arange(16) // 8) * 2 + (np.arange(16) % 4) // 2)

_const = constant_cache({
    "run_before": np.asarray(RUN_BEFORE, np.int32).reshape(-1, 2),
    "coeff_token": np.asarray(COEFF_TOKEN, np.int32).reshape(-1, 2),
    "total_zeros": np.asarray(TOTAL_ZEROS, np.int32).reshape(-1, 2),
    "total_zeros_cdc": np.asarray(TOTAL_ZEROS_CHROMA_DC,
                                  np.int32).reshape(-1, 2),
    "cbp_inter_inv": np.asarray(CBP_INTER_INV, np.int64),
    "zigzag": np.asarray(ZIGZAG_4x4, np.int64),
    "zscan": np.asarray(ZSCAN_TO_RASTER, np.int64),
    "b8map": _B8MAP.astype(np.int32),
})
_RB_RUNS = np.asarray(RUN_BEFORE).shape[1]
_CT_SHAPE = np.asarray(COEFF_TOKEN).shape
_TZ_SHAPE = {16: np.asarray(TOTAL_ZEROS).shape,
             15: np.asarray(TOTAL_ZEROS).shape,
             4: np.asarray(TOTAL_ZEROS_CHROMA_DC).shape}


def _ue_bits(v):
    """Exp-Golomb ue(v) for int32 v >= 0: (value v + 1, length)."""
    vp1 = v.to(I32) + 1
    return vp1, (2 * pow2_count(vp1, 24) + 1).to(U8)


def _se_bits(v):
    v = v.to(I32)
    return _ue_bits(torch.where(v > 0, 2 * v - 1, -2 * v))


def residual_tokens(coeffs, nc, max_coeff: int):
    """coeffs: [B, mc] int32 levels in scan order; nc: [B] int32 (-1 for
    chroma DC). Returns (vals [B,34] int32, lens [B,34] uint8, total [B]).
    Slot order within a block equals CAVLC stream order."""
    B, mc = coeffs.shape
    assert mc == max_coeff
    dev = coeffs.device
    c = coeffs.to(I32)
    nzm = c != 0
    total = nzm.sum(1, dtype=I32)
    pos = torch.arange(mc, dtype=I32, device=dev)
    lastnz = torch.where(nzm, pos[None, :], -1).amax(1)
    zeros_total = lastnz + 1 - total

    zero_i = torch.zeros(B, dtype=I32, device=dev)
    zero_b = torch.zeros(B, dtype=U8, device=dev)
    sign_v = [zero_i] * 16
    sign_l = [zero_b] * 16
    run_v = [zero_i] * 16
    run_l = [zero_b] * 16

    cnt = torch.zeros(B, dtype=I32, device=dev)
    t1cnt = torch.zeros(B, dtype=I32, device=dev)
    t1open = torch.ones(B, dtype=torch.bool, device=dev)
    lev_started = torch.zeros(B, dtype=torch.bool, device=dev)
    sl = torch.zeros(B, dtype=I32, device=dev)
    prevpos = torch.zeros(B, dtype=I32, device=dev)
    zl = torch.where((total > 0) & (total < mc), zeros_total, 0)
    rb_t = _const("run_before", dev)

    for step in range(mc):
        p = mc - 1 - step
        v = c[:, p]
        nz = v != 0
        absl = v.abs()
        neg = (v < 0).to(I32)
        take_t1 = nz & t1open & (absl == 1) & (t1cnt < 3)
        is_level = nz & ~take_t1
        t1cnt = t1cnt + take_t1.to(I32)
        t1open = t1open & ~is_level

        first_level = is_level & ~lev_started
        sl = torch.where(first_level, ((total > 10) & (t1cnt < 3)).to(I32),
                         sl)
        lc = ((absl - 1) << 1) | neg
        lc = torch.where(first_level & (t1cnt < 3), lc - 2, lc)
        v0 = torch.where(lc < 14, 1,
                         torch.where(lc < 30, (1 << 4) | ((lc - 14) & 0xF),
                                     (1 << 12) | ((lc - 30) & 0xFFF)))
        l0 = torch.where(lc < 14, lc + 1, torch.where(lc < 30, 19, 28))
        sl1 = sl.clamp(min=1)
        pre = lc >> sl1
        mask = (1 << sl1) - 1
        vs = torch.where(pre < 15, (1 << sl) | (lc & mask),
                         (1 << 12) | ((lc - (15 << sl1)) & 0xFFF))
        ls = torch.where(pre < 15, pre + 1 + sl, 28)
        use0 = sl == 0
        # a t1 sign xor a level shares the position slot
        sign_v[step] = torch.where(is_level, torch.where(use0, v0, vs),
                                   torch.where(take_t1, neg, 0))
        sign_l[step] = torch.where(take_t1, 1,
                                   torch.where(is_level,
                                               torch.where(use0, l0, ls),
                                               0)).to(U8)
        sl = torch.where(is_level & (sl == 0), 1, sl)
        sl = torch.where(is_level & (absl > (3 << (sl - 1).clamp(min=0)))
                         & (sl < 6), sl + 1, sl)
        lev_started = lev_started | is_level

        emit_run = nz & (cnt >= 1) & (zl > 0)
        run = prevpos - p - 1
        rb_idx = zl.clamp(0, 7) * _RB_RUNS + run.clamp(0, _RB_RUNS - 1)
        rb = rb_t[torch.where(emit_run, rb_idx, 0).long()]
        run_v[step] = torch.where(emit_run, rb[:, 0], 0)
        run_l[step] = torch.where(emit_run, rb[:, 1], 0).to(U8)
        zl = torch.where(emit_run, zl - run, zl)
        prevpos = torch.where(nz, p, prevpos)
        cnt = cnt + nz.to(I32)

    cls = torch.where(nc < 0, 4,
                      torch.where(nc < 2, 0,
                                  torch.where(nc < 4, 1,
                                              torch.where(nc < 8, 2, 3))))
    tok = _const("coeff_token", dev)[
        ((cls * _CT_SHAPE[1] + total) * _CT_SHAPE[2] + t1cnt).long()]
    tz_act = (total > 0) & (total < mc)
    tz_shape = _TZ_SHAPE[mc]
    tz_idx = (total.clamp(0, tz_shape[0] - 1) * tz_shape[1]
              + zeros_total.clamp(0, tz_shape[1] - 1))
    tz = _const("total_zeros_cdc" if mc == 4 else "total_zeros",
                dev)[tz_idx.long()]

    vals = torch.stack([tok[:, 0]] + sign_v
                       + [torch.where(tz_act, tz[:, 0], 0)] + run_v, 1)
    lens = torch.stack([tok[:, 1].to(U8)] + sign_l
                       + [torch.where(tz_act, tz[:, 1], 0).to(U8)] + run_l, 1)
    return vals, lens, total


def _mvp_p16x16(mv, mb_w: int, mb_h: int, intra):
    """Median MVP + skip MV over [nb, mb_h, mb_w, 2] P16x16 fields, one
    per slice band; intra: [nb, mb_h, mb_w]."""
    zero = torch.zeros((), dtype=mv.dtype, device=mv.device)
    mv = torch.where(intra[..., None], zero, mv)
    f = torch.ones((mb_h, mb_w), dtype=torch.bool, device=mv.device)
    availA, availB = _shifted(f, 0, 1, False), _shifted(f, 1, 0, False)
    availC, availD = _shifted(f, 1, -1, False), _shifted(f, 1, 1, False)
    mvA, mvB = _shifted(mv, 0, 1, lead=1), _shifted(mv, 1, 0, lead=1)
    mvC, mvD = _shifted(mv, 1, -1, lead=1), _shifted(mv, 1, 1, lead=1)
    inA = _shifted(intra, 0, 1, False, lead=1)
    inB = _shifted(intra, 1, 0, False, lead=1)
    inC = _shifted(intra, 1, -1, False, lead=1)
    inD = _shifted(intra, 1, 1, False, lead=1)
    mvc = torch.where(availC[..., None], mvC, mvD)
    availc = availC | availD
    intrac = torch.where(availC, inC, inD)
    matchA = availA & ~inA
    matchB = availB & ~inB
    matchC = availc & ~intrac
    n_match = matchA.to(I32) + matchB.to(I32) + matchC.to(I32)
    a = torch.where(availA[..., None], mvA, zero)
    b = torch.where(availB[..., None], mvB, zero)
    cc = torch.where(availc[..., None], mvc, zero)
    med = _median3(a, b, cc)
    one = torch.where(matchA[..., None], mvA,
                      torch.where(matchB[..., None], mvB, mvc))
    only_a = (~availB) & (~availc) & availA
    mvp = torch.where((n_match == 1)[..., None], one,
                      torch.where(only_a[..., None], mvA, med))
    a_zero = availA & ~inA & (mvA[..., 0] == 0) & (mvA[..., 1] == 0)
    b_zero = availB & ~inB & (mvB[..., 0] == 0) & (mvB[..., 1] == 0)
    skip_zero = (~availA) | (~availB) | a_zero | b_zero
    return mvp, torch.where(skip_zero[..., None], zero, mvp)


def _nc_from(na, nb):
    both = (na >= 0) & (nb >= 0)
    return torch.where(both, (na + nb + 1) >> 1,
                       torch.maximum(na, nb)).clamp(min=0)


def _nc_mb(tc_mb, mb_w: int, mb_h: int):
    """nC per luma 4x4 block from per-block counts [nb, n_mb, 16] (raster
    blocks, nb slice bands). Returns [nb, n_mb, 16] int32."""
    n = tc_mb.shape[0]
    g = tc_mb.to(I32).reshape(n, mb_h, mb_w, 4, 4)
    neg = torch.full((n, mb_h, 1, 4, 1), -1, dtype=I32, device=g.device)
    left_mb = torch.cat([neg, g[:, :, :-1, :, 3:4]], 2)
    na = torch.cat([left_mb, g[..., :3]], 4)
    negt = torch.full((n, 1, mb_w, 1, 4), -1, dtype=I32, device=g.device)
    top_mb = torch.cat([negt, g[:, :-1, :, 3:4, :]], 1)
    nb = torch.cat([top_mb, g[:, :, :, :3, :]], 3)
    return _nc_from(na, nb).reshape(n, -1, 16)


def _nc_chroma(tc_c, mb_w: int, mb_h: int):
    """nC per chroma 4x4 block. tc_c: [nb, n_mb, 2, 4] counts (comp,
    raster 2x2 block). Returns [nb, n_mb, 2, 4]."""
    n = tc_c.shape[0]
    g = tc_c.to(I32).reshape(n, mb_h, mb_w, 2, 2, 2).permute(
        0, 3, 1, 2, 4, 5)                        # [nb, comp, mh, mw, 2, 2]
    neg = torch.full((n, 2, mb_h, 1, 2, 1), -1, dtype=I32, device=g.device)
    left_mb = torch.cat([neg, g[:, :, :, :-1, :, 1:2]], 3)
    na = torch.cat([left_mb, g[..., :1]], 5)
    negt = torch.full((n, 2, 1, mb_w, 1, 2), -1, dtype=I32, device=g.device)
    top_mb = torch.cat([negt, g[:, :, :-1, :, 1:2, :]], 2)
    nb = torch.cat([top_mb, g[:, :, :, :, :1, :]], 4)
    return _nc_from(na, nb).permute(0, 2, 3, 1, 4, 5).reshape(n, -1, 2, 4)


def _cbp_chroma(cdc, cac):
    """[nb, n_mb] chroma CBP from [nb, n_mb, ...] chroma levels."""
    return torch.where(cac.flatten(2).any(-1), 2,
                       torch.where(cdc.flatten(2).any(-1), 1, 0))


def _count_nz(x, dim):
    return (x != 0).sum(dim, dtype=I32)


def _residual_groups(*groups):
    """residual_tokens over several groups of blocks of one size in one
    call (fewer, larger ops); returns each group's (vals, lens)."""
    mc = groups[0][0].shape[-1]
    coeffs = torch.cat([c.reshape(-1, mc) for c, _ in groups])
    nc = torch.cat([n.reshape(-1) for _, n in groups])
    vals, lens, _ = residual_tokens(coeffs, nc, mc)
    sizes = [c.numel() // mc for c, _ in groups]
    return list(zip(vals.split(sizes), lens.split(sizes)))


def _chroma_dc_group(cdc):
    return cdc, torch.full(cdc.shape[:-1], -1, dtype=I32, device=cdc.device)


def p_slice_tokens(out: dict, mb_w: int, mb_h: int, n_valid=None):
    """Token grids for a whole P16x16 CAVLC slice body.

    out: dict with mv [N,2], luma_ac [N,16,16], chroma_dc [N,2,4],
    chroma_ac [N,2,4,16], and optionally intra_mask/i16_mode/chroma_mode/
    luma_dc. Returns (vals [N,P_SLOTS+1] int32, lens uint8): the final
    row's extra slot carries the trailing skip-run token.

    n_valid (optional int): only MBs [0, n_valid) are real; the rest are
    padding that emits no tokens and does not count toward the trailing
    skip run. The per-MB QP of entropy_jax (`mb_qp`) is not ported: the
    session never passes it.
    """
    av, al = p_slice_tokens_bands({k: a[None] for k, a in out.items()},
                                  mb_w, mb_h, n_valid)
    return av[0], al[0]


def p_slice_tokens_bands(out: dict, mb_w: int, mb_h: int, n_valid=None):
    """p_slice_tokens for nb slice bands at once: every array of `out`
    has a leading band axis ([nb, N, ...]); n_valid is an int or an [nb]
    tensor. Entropy contexts (nC, MVP, skip runs) stay band-local: each
    band grid has no rows above its own top. This is the band axis of
    the JAX session's vmap, written out. Returns [nb, N, P_SLOTS+1]."""
    mv = out["mv"].to(I32)
    n = mv.shape[0]
    n_mb = mb_w * mb_h
    mv = mv.reshape(n, mb_h, mb_w, 2)
    dev = mv.device
    luma = out["luma_ac"].to(I32)
    cdc = out["chroma_dc"].to(I32)
    cac = out["chroma_ac"].to(I32)
    im = out.get("intra_mask")
    intra = (im.bool().reshape(n, n_mb) if im is not None
             else torch.zeros((n, n_mb), dtype=torch.bool, device=dev))
    zz = _const("zigzag", dev)
    zsr = _const("zscan", dev)
    b8map = _const("b8map", dev)

    nz_blk = luma.bool().any(-1)                             # [nb,N,16]
    cbp_luma = torch.zeros((n, n_mb), dtype=I32, device=dev)
    for b8 in range(4):
        sel = np.nonzero(_B8MAP == b8)[0].tolist()
        cbp_luma |= nz_blk[..., sel].any(-1).to(I32) << b8
    cbp_luma = torch.where(intra, torch.where(nz_blk.any(-1), 15, 0),
                           cbp_luma)
    cbp_chroma = _cbp_chroma(cdc, cac)
    cbp = cbp_luma | (cbp_chroma << 4)

    mvp, skip_mv = _mvp_p16x16(mv, mb_w, mb_h, intra.reshape(n, mb_h, mb_w))
    mvf = mv.reshape(n, n_mb, 2)
    is_skip = (cbp == 0) & (mvf == skip_mv.reshape(n, n_mb, 2)).all(-1) & \
        ~intra
    coded = ~is_skip
    ar = torch.arange(n_mb, dtype=I32, device=dev)
    if n_valid is None:
        nv = n_mb
    else:
        nv = n_valid.to(I32) if isinstance(n_valid, torch.Tensor) \
            else int(n_valid)
        valid = ar < (nv[:, None] if isinstance(nv, torch.Tensor) else nv)
        coded = coded & valid
        intra = intra & valid
    lastc = torch.cummax(torch.where(coded, ar, -1), dim=-1).values
    prevc = torch.cat([torch.full((n, 1), -1, dtype=I32, device=dev),
                       lastc[:, :-1]], 1)
    skiprun = ar - prevc - 1                      # valid where coded
    trailing = nv - 1 - lastc[:, -1]              # [nb]
    none_coded = lastc[:, -1] < 0

    zero_v = torch.zeros((n, n_mb), dtype=I32, device=dev)
    zero_l = torch.zeros((n, n_mb), dtype=U8, device=dev)

    def gated(vl, cond):
        v, l = vl
        return torch.where(cond, v, zero_v), torch.where(cond, l, zero_l)

    hdr = [gated(_ue_bits(skiprun.clamp(min=0)), coded)]
    mvd = mvf - mvp.reshape(n, n_mb, 2)
    inter_coded = coded & ~intra
    dqp = zero_v
    hdr.append(gated(_ue_bits(zero_v), inter_coded))   # mb_type P_L0_16x16
    hdr.append(gated(_se_bits(mvd[..., 0]), inter_coded))
    hdr.append(gated(_se_bits(mvd[..., 1]), inter_coded))
    hdr.append(gated(_ue_bits(_const("cbp_inter_inv", dev)[cbp.long()]),
                     inter_coded))
    hdr.append(gated(_se_bits(dqp), inter_coded & (cbp != 0)))

    if im is not None:
        i16m = out["i16_mode"].to(I32).reshape(n, -1)[:, :n_mb]
        cmode = out["chroma_mode"].to(I32).reshape(n, -1)[:, :n_mb]
        raw = 1 + i16m + 4 * cbp_chroma + 12 * (cbp_luma != 0).to(I32)
        for i, vl in ((1, _ue_bits(5 + raw)), (2, _ue_bits(cmode)),
                      (3, _se_bits(dqp)), (4, (zero_v, zero_l)),
                      (5, (zero_v, zero_l))):
            hdr[i] = (torch.where(intra, vl[0], hdr[i][0]),
                      torch.where(intra, vl[1], hdr[i][1]))

    # ---- per-block coefficient counts + nC contexts (MB layout) ----
    zz_all = luma[..., zz]                               # [nb,N,16,16] scan
    tc_blk = torch.where(intra[..., None], _count_nz(zz_all[..., 1:], -1),
                         _count_nz(zz_all, -1))
    blk_coded = (cbp_luma[..., None] >> b8map) & 1
    tc_blk = tc_blk * blk_coded * coded[..., None]
    nc_l = _nc_mb(tc_blk, mb_w, mb_h)                    # [nb,N,16] raster
    cac_z = cac[..., zz]
    tc_c = _count_nz(cac_z[..., 1:], -1) * \
        ((cbp_chroma == 2) & coded)[..., None, None]
    nc_c = _nc_chroma(tc_c, mb_w, mb_h)

    # ---- residual blocks (luma in z-scan block order) ----
    zz_z = zz_all[..., zsr, :]                           # [nb,N,16z,16]
    nc_lb = nc_l[..., zsr]                               # [nb,N,16z]
    ac_c = (cac_z[..., 1:], nc_c)
    shp = (n, n_mb, 16, RES_SLOTS)
    if im is not None:
        # I16 variants (15-coeff AC + luma DC) for the intra MBs
        ldc = out["luma_dc"].to(I32).reshape(n, -1, 16)[:, :n_mb]
        (lv, ll), (vv, lld) = _residual_groups((zz_z, nc_lb),
                                               (ldc[..., zz], nc_l[..., 0]))
        (av15, al15), (acv, acl) = _residual_groups(
            (zz_z[..., 1:], nc_lb), ac_c)
        i3 = intra[..., None, None]
        lv = torch.where(i3, av15.reshape(shp), lv.reshape(shp))
        ll = torch.where(i3, al15.reshape(shp), ll.reshape(shp))
        dvv = torch.where(intra[..., None], vv.reshape(n, n_mb, -1), 0)
        dll = lld.reshape(n, n_mb, -1) * intra[..., None]
    else:
        (lv, ll), = _residual_groups((zz_z, nc_lb))
        (acv, acl), = _residual_groups(ac_c)
        dvv = torch.zeros((n, n_mb, RES_SLOTS), dtype=I32, device=dev)
        dll = torch.zeros((n, n_mb, RES_SLOTS), dtype=U8, device=dev)
    wmask = (blk_coded[..., zsr] * coded[..., None]).bool()
    ll = ll.reshape(shp) * wmask[..., None]
    (dcv, dcl), = _residual_groups(_chroma_dc_group(cdc))
    dcl = dcl.reshape(n, n_mb, -1) * ((cbp_chroma > 0) & coded)[..., None]
    acl = acl.reshape(n, n_mb, -1) * ((cbp_chroma == 2) & coded)[..., None]
    av = torch.cat([torch.stack([h[0] for h in hdr], -1), dvv,
                    lv.reshape(n, n_mb, -1), dcv.reshape(n, n_mb, -1),
                    acv.reshape(n, n_mb, -1)], -1)
    al = torch.cat([torch.stack([h[1] for h in hdr], -1), dll,
                    ll.reshape(n, n_mb, -1), dcl, acl], -1)

    # trailing skip-run token in an extra final slot of each band
    tv, tl = _ue_bits(trailing.clamp(min=0))
    want_tail = (trailing > 0) | none_coded
    tail_v = torch.zeros((n, n_mb, 1), dtype=I32, device=dev)
    tail_l = torch.zeros((n, n_mb, 1), dtype=U8, device=dev)
    tail_v[:, n_mb - 1, 0] = torch.where(want_tail, tv, 0)
    tail_l[:, n_mb - 1, 0] = torch.where(want_tail, tl, 0)
    return torch.cat([av, tail_v], -1), torch.cat([al, tail_l], -1)


def i_slice_tokens(out: dict, mb_w: int, mb_h: int):
    """Token grids for an all-I16x16 CAVLC slice body."""
    n_mb = mb_w * mb_h
    luma = out["luma_ac"].to(I32)
    cdc = out["chroma_dc"].to(I32)
    cac = out["chroma_ac"].to(I32)
    dev = luma.device
    zz = _const("zigzag", dev)
    zsr = _const("zscan", dev)

    cbp_luma = torch.where(luma.reshape(n_mb, -1).any(1), 15, 0)
    cbp_chroma = _cbp_chroma(cdc[None], cac[None])[0]
    i16m = out["i16_mode"].to(I32).reshape(-1)[:n_mb]
    cmode = out["chroma_mode"].to(I32).reshape(-1)[:n_mb]
    mb_type = 1 + i16m + 4 * cbp_chroma + 12 * (cbp_luma != 0).to(I32)
    hdr = [_ue_bits(mb_type), _ue_bits(cmode),
           _se_bits(torch.zeros(n_mb, dtype=I32, device=dev))]

    zz_all = luma[:, :, zz]
    tc_blk = _count_nz(zz_all[:, :, 1:], 2) * (cbp_luma != 0)[:, None]
    nc_l = _nc_mb(tc_blk[None], mb_w, mb_h)[0]
    cac_z = cac[..., zz]
    tc_c = _count_nz(cac_z[..., 1:], 3) * (cbp_chroma == 2)[:, None, None]
    nc_c = _nc_chroma(tc_c[None], mb_w, mb_h)[0]

    ldc = out["luma_dc"].to(I32).reshape(-1, 16)[:n_mb]
    (dvv, dll), = _residual_groups((ldc[:, zz], nc_l[:, 0]))
    zz_z = zz_all[:, zsr]
    (lv, ll), (acv, acl) = _residual_groups(
        (zz_z[:, :, 1:], nc_l[:, zsr]), (cac_z[:, :, :, 1:], nc_c))
    ll = ll.reshape(n_mb, 16, RES_SLOTS) * (cbp_luma != 0)[:, None, None]
    (dcv, dcl), = _residual_groups(_chroma_dc_group(cdc))
    dcl = dcl.reshape(n_mb, 2, RES_SLOTS) * (cbp_chroma > 0)[:, None, None]
    acl = acl.reshape(n_mb, 2, 4, RES_SLOTS) * \
        (cbp_chroma == 2)[:, None, None, None]
    av = torch.cat([torch.stack([h[0] for h in hdr], 1), dvv,
                    lv.reshape(n_mb, -1), dcv.reshape(n_mb, -1),
                    acv.reshape(n_mb, -1)], 1)
    al = torch.cat([torch.stack([h[1] for h in hdr], 1), dll,
                    ll.reshape(n_mb, -1), dcl.reshape(n_mb, -1),
                    acl.reshape(n_mb, -1)], 1)
    return av, al


def pack_tokens_device(vals, lens, start_bit, max_bytes: int,
                       max_tok: int = 1 << 18):
    """Pack (val, len) tokens MSB-first into a byte buffer on the device.

    vals/lens: token grids whose row-major slot order is the stream
    order. start_bit: bit offset of the first token (the slice header's
    length mod 8). Each token contributes <= 5 bytes by scatter-add;
    contributions of different tokens to one byte occupy disjoint bits,
    so add == or.

    Returns (bytes uint8 [max_bytes], end_bit int32 0-d (absolute),
    overflow bool 0-d).
    """
    dev = lens.device
    N = lens.numel()
    max_tok = min(max_tok, N)
    ln = lens.reshape(-1).to(I64)
    # the fused word of entropy_jax, 32 bits wide: every emitted value
    # fits 16 bits, since long codes are unary-prefixed
    combo = ((ln << 16) | vals.reshape(-1).to(I64)) & 0xFFFFFFFF
    live = ln > 0
    rank = torch.cumsum(live, 0) - 1
    n_live = rank[-1] + 1
    # left-compact the live tokens (dead ones go to a spare slot N)
    cw = torch.zeros(N + 1, dtype=I64, device=dev)
    cw.scatter_(0, torch.where(live, rank, N), torch.where(live, combo, 0))
    cw = cw[:max_tok]
    cl = cw >> 16
    cv = cw & 0xFFFF

    start = start_bit.to(I64) if isinstance(start_bit, torch.Tensor) \
        else int(start_bit)
    off = start + torch.cumsum(cl, 0) - cl
    end_bit = start + ln.sum()

    shift = off & 7
    bpos = off >> 3
    outw = torch.zeros(max_bytes + 1, dtype=I64, device=dev)
    for i in range(5):
        s = cl + shift - 8 * (i + 1)
        byte = torch.where(s >= 0, cv >> s.clamp(0, 31),
                           cv << (-s).clamp(0, 31)) & 0xFF
        byte = torch.where(cl > 0, byte, 0)
        pos = bpos + i
        # out-of-range writes are dropped, as JAX's mode="drop" does
        outw.scatter_add_(0, torch.where(pos < max_bytes, pos, max_bytes),
                          byte)
    overflow = (n_live > max_tok) | (end_bit > 8 * max_bytes - 40)
    return outw[:max_bytes].to(U8), end_bit.to(I32), overflow
