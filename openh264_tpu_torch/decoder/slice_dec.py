"""Slice data parsing: per-MB syntax -> FrameSymbols tensors.

The serial entropy phase of the decoder, on the host. Mirrors the
behavior of the reference's WelsDecodeMbCavlc{I,P,B}Slice parse
(decode_slice.cpp:853-2610) but writes dense per-frame tensors instead
of reconstructing inline; reconstruction happens batched afterwards
(recon_batch.py).

Port of openh264_tpu/decoder/slice_dec.py: the per-slice context with
its neighbour lookups (nC, intra 4x4 / 8x8 mode prediction, MV
prediction, the spatial-direct cache over decoder/direct.py), the
per-MB Python CAVLC parser of I, P and B slices with the 8x8 transform
(I8x8, the inter transform_size_8x8_flag, the 8x8 residual as four
interleaved 4x4 CAVLC blocks) and direct prediction (apply_direct), and
the decoder's one routing rule, c_parses: which slices the host C
parsers (decoder/cbind.py) take and which the per-MB Python parsers of
both entropy modes take. The CABAC parser (slice_dec_cabac.py) shares
the context and the per-MB helpers. check_scope refuses SP and SI
slices with NotImplementedError, which the decoder lets through and
never conceals.
"""

from __future__ import annotations

import numpy as np

from ..bitstream import BitReader
from ..tables import CHROMA_QP_TABLE, ZIGZAG_4x4, ZIGZAG_8x8
from ..tables.cavlc import CBP_I16x16, CBP_INTER, CBP_INTRA
from .cavlc import parse_residual_block
from .dequant import DequantTables, hadamard2x2, luma_dc_dequant_ihadamard
from .direct import DirectContext
from .framedata import (FrameSymbols, MB_BDIRECT, MB_BSKIP, MB_B16x16,
                        MB_B16x8, MB_B8x16, MB_B8x8, MB_I4x4, MB_I16x16,
                        MB_IPCM, MB_I8x8, MB_P16x16, MB_P16x8, MB_P8x16,
                        MB_P8x8, MB_PSKIP, ZSCAN_TO_RASTER)
from .mvpred import MvContext, ensure_motion_grids
from .slicehdr import B_SLICE, I_SLICE, P_SLICE, SliceHeader

# luma DC scan: zigzag over the 4x4 DC array
_LUMA_DC_SCAN = ZIGZAG_4x4


class SliceDecodeContext:
    """Per-slice mutable parse state over a FrameSymbols target."""

    def __init__(self, fs: FrameSymbols, sh: SliceHeader, slice_idx: int,
                 ref_list0=None, ref_list1=None, poc: int = 0,
                 fmo_next=None):
        self.fs = fs
        self.sh = sh
        self.slice_idx = slice_idx
        # FMO: next raster MB of the slice's group (fmo.py next_mb_lut,
        # FmoNextMb analog); None = raster iteration (1 slice group)
        self.fmo_next = fmo_next
        self.mb_w = fs.mb_w
        self.mb_h = fs.mb_h
        self.qp = sh.qp  # running luma QP
        self.constrained_intra = sh.pps.constrained_intra_pred
        self.ref_list0 = ref_list0 or []
        self.ref_list1 = ref_list1 or []
        self.mvctx = MvContext(fs, slice_idx)
        self.direct = None
        self._sd_cache_mb = -1
        self._sd_cache = None
        if sh.slice_type == B_SLICE:
            self.direct = DirectContext(sh, self.ref_list0, self.ref_list1,
                                        poc)
        self.dq = DequantTables(sh.sps, sh.pps)
        # global intra-4x4-mode grid for mode prediction: -1 unavail
        # (shared across the picture's slices via fs)
        if not hasattr(fs, "i4_grid"):
            fs.i4_grid = np.full((fs.mb_h * 4, fs.mb_w * 4), -1,
                                 dtype=np.int32)

    # -- neighbor availability ----------------------------------------
    def mb_avail(self, mbx: int, mby: int) -> bool:
        if mbx < 0 or mby < 0 or mbx >= self.mb_w or mby >= self.mb_h:
            return False
        idx = mby * self.mb_w + mbx
        return self.fs.slice_id[idx] == self.slice_idx

    def mb_intra(self, mbx: int, mby: int) -> bool:
        idx = mby * self.mb_w + mbx
        return self.fs.mb_type[idx] in (MB_I4x4, MB_I16x16, MB_IPCM, MB_I8x8)

    # -- nC context (§9.2.1) ------------------------------------------
    def nc_luma(self, gx: int, gy: int) -> int:
        """gx, gy: global 4x4 luma block coords of current block."""
        na = self._nzc_at(gx - 1, gy, luma=True)
        nb = self._nzc_at(gx, gy - 1, luma=True)
        return self._combine_nc(na, nb)

    def nc_chroma(self, comp: int, cx: int, cy: int) -> int:
        na = self._nzc_at(cx - 1, cy, luma=False, comp=comp)
        nb = self._nzc_at(cx, cy - 1, luma=False, comp=comp)
        return self._combine_nc(na, nb)

    @staticmethod
    def _combine_nc(na, nb):
        if na >= 0 and nb >= 0:
            return (na + nb + 1) >> 1
        if na >= 0:
            return na
        if nb >= 0:
            return nb
        return 0

    def _nzc_at(self, bx: int, by: int, luma: bool, comp: int = 0) -> int:
        """Returns nzc or -1 if the block is unavailable."""
        scale = 4 if luma else 2
        if bx < 0 or by < 0:
            return -1
        mbx, mby = bx // scale, by // scale
        if not self.mb_avail(mbx, mby):
            return -1
        mb_idx = mby * self.mb_w + mbx
        if self.fs.mb_type[mb_idx] == MB_IPCM:
            return 16
        if luma:
            return int(self.fs.nzc_l[by, bx])
        return int(self.fs.nzc_c[comp, by, bx])

    # -- intra mode prediction (§8.3.1.1) ------------------------------
    def pred_intra4x4_mode(self, gx: int, gy: int) -> int:
        ma = self._i4_mode_at(gx - 1, gy)
        mb = self._i4_mode_at(gx, gy - 1)
        if ma < 0 or mb < 0:
            return 2
        return min(ma, mb)

    def _i4_mode_at(self, bx: int, by: int) -> int:
        if bx < 0 or by < 0:
            return -1
        mbx, mby = bx // 4, by // 4
        if not self.mb_avail(mbx, mby):
            return -1
        if not self.mb_intra(mbx, mby):
            return -1 if self.constrained_intra else 2
        m = int(self.fs.i4_grid[by, bx])
        return 2 if m < 0 else m

    def spatial_direct_mb(self, mb_idx: int):
        """Cached per-MB spatial-direct refs/MVPs — must be derived from
        neighbor state BEFORE any of this MB's partitions are written."""
        if self._sd_cache_mb != mb_idx:
            mbx, mby = mb_idx % self.mb_w, mb_idx // self.mb_w
            self._sd_cache = self.direct.spatial_refs(
                self.mvctx, mbx * 4, mby * 4, mb_idx)
            self._sd_cache_mb = mb_idx
        return self._sd_cache


def check_scope(sh: SliceHeader) -> None:
    """Raises NotImplementedError for a slice this decoder does not
    take: SP and SI slices (Extended profile), CAVLC or CABAC."""
    if sh.slice_type not in (I_SLICE, P_SLICE, B_SLICE):
        raise NotImplementedError(
            f"slice type {sh.slice_type} (SP/SI): the decoder takes I, P "
            "and B slices")


def c_parses(sh: SliceHeader) -> bool:
    """Whether the host C parses slice `sh` (decoder/cbind.py), the
    decoder's one routing rule: every CABAC I, P and B slice without FMO
    (csrc/parse_cabac.c), and every CAVLC I and P slice without FMO
    under a PPS without transform_8x8_mode (csrc/parse_cavlc.c), as the
    JAX package routes CAVLC (native/__init__.py:189-203). The per-MB
    Python parsers take the rest; SP and SI slices are check_scope's."""
    if sh.slice_type not in (I_SLICE, P_SLICE, B_SLICE) or \
            sh.pps.num_slice_groups > 1:
        return False
    return bool(sh.pps.entropy_coding_mode) or not (
        sh.slice_type == B_SLICE or sh.pps.transform_8x8_mode)


def decode_i_mb_cavlc(br: BitReader, ctx: SliceDecodeContext, mb_idx: int,
                      mb_type_raw: int) -> None:
    """Parse one intra MB (mb_type_raw: 0=I4x4, 1..24=I16x16, 25=IPCM)."""
    fs, sh = ctx.fs, ctx.sh
    mbx, mby = mb_idx % ctx.mb_w, mb_idx // ctx.mb_w
    fs.slice_id[mb_idx] = ctx.slice_idx
    fs.disable_deblock[mb_idx] = sh.disable_deblocking_filter_idc
    fs.alpha_offset[mb_idx] = sh.slice_alpha_c0_offset
    fs.beta_offset[mb_idx] = sh.slice_beta_offset
    fs.pred_mode[mb_idx, :] = -1

    if mb_type_raw == 25:  # IPCM
        fs.mb_type[mb_idx] = MB_IPCM
        while not br.byte_aligned():
            br.u(1)
        y = np.frombuffer(bytes(br.u(8) for _ in range(256)), np.uint8).reshape(16, 16)
        u = np.frombuffer(bytes(br.u(8) for _ in range(64)), np.uint8).reshape(8, 8)
        v = np.frombuffer(bytes(br.u(8) for _ in range(64)), np.uint8).reshape(8, 8)
        fs.ipcm[mb_idx] = (y, u, v)
        fs.qp[mb_idx] = 0  # IPCM: QP 0 for deblocking (spec 8.7; ref pLumaQp=0)
        # IPCM: nzc treated as 16 for deblock/nC purposes
        fs.nzc_l[mby * 4:mby * 4 + 4, mbx * 4:mbx * 4 + 4] = 16
        fs.nzc_c[:, mby * 2:mby * 2 + 2, mbx * 2:mbx * 2 + 2] = 16
        fs.i4_grid[mby * 4:mby * 4 + 4, mbx * 4:mbx * 4 + 4] = 2
        return

    if mb_type_raw == 0:  # I_4x4 (or I_8x8 with transform flag)
        t8 = False
        if sh.pps.transform_8x8_mode:
            t8 = br.flag()
        fs.mb_type[mb_idx] = MB_I8x8 if t8 else MB_I4x4
        fs.transform8[mb_idx] = t8
        n_units = 4 if t8 else 16
        modes = np.zeros(16, dtype=np.int32)
        for k in range(n_units):
            if t8:
                bx8, by8 = (k & 1) * 2, (k >> 1) * 2
                gx, gy = mbx * 4 + bx8, mby * 4 + by8
            else:
                bx, by = ZSCAN_TO_RASTER[k] % 4, ZSCAN_TO_RASTER[k] // 4
                gx, gy = mbx * 4 + bx, mby * 4 + by
            pred = ctx.pred_intra4x4_mode(gx, gy)
            if br.flag():  # prev_intra_pred_mode_flag
                mode = pred
            else:
                rem = br.u(3)
                mode = rem if rem < pred else rem + 1
            if t8:
                fs.i4_grid[gy:gy + 2, gx:gx + 2] = mode
                modes[[by8 * 4 + bx8, by8 * 4 + bx8 + 1,
                       (by8 + 1) * 4 + bx8, (by8 + 1) * 4 + bx8 + 1]] = mode
            else:
                fs.i4_grid[gy, gx] = mode
                modes[ZSCAN_TO_RASTER[k]] = mode
        fs.i4_modes[mb_idx] = modes
        fs.chroma_mode[mb_idx] = br.ue()
        cbp_code = br.ue()
        if cbp_code >= 48:
            raise ValueError("invalid cbp")
        cbp = int(CBP_INTRA[cbp_code])
    else:  # I16x16
        fs.mb_type[mb_idx] = MB_I16x16
        mt = mb_type_raw - 1
        fs.i16_mode[mb_idx] = mt & 3
        cbp = int(CBP_I16x16[mt >> 2])
        fs.i4_grid[mby * 4:mby * 4 + 4, mbx * 4:mbx * 4 + 4] = 2
        fs.chroma_mode[mb_idx] = br.ue()
    fs.cbp[mb_idx] = cbp

    parse_mb_residual_cavlc(br, ctx, mb_idx, cbp,
                            is_i16=(fs.mb_type[mb_idx] == MB_I16x16))


def parse_mb_residual_cavlc(br: BitReader, ctx: SliceDecodeContext,
                            mb_idx: int, cbp: int, is_i16: bool) -> None:
    """Residual parse + dequant into FrameSymbols (§7.3.5.3 / §9.2).

    Dequant mirrors the reference parse-time scaling
    (parse_mb_syn_cavlc.cpp:936-976): chroma DC gets the 2x2 inverse
    Hadamard + (v*dq[0])>>1, luma DC gets WelsLumaDcDequantIdct, AC
    coefficients are multiplied by the per-position dequant row.
    """
    fs, sh = ctx.fs, ctx.sh
    mbx, mby = mb_idx % ctx.mb_w, mb_idx // ctx.mb_w

    if is_i16 or cbp:
        delta = br.se()
        if delta:
            ctx.qp = (ctx.qp + delta + 52) % 52
    fs.qp[mb_idx] = ctx.qp
    qp = ctx.qp
    intra = fs.mb_type[mb_idx] in (MB_I4x4, MB_I16x16, MB_I8x8)
    # per-plane chroma QP (Cb: primary offset, Cr: secondary offset)
    offs = (sh.pps.chroma_qp_index_offset, sh.pps.second_chroma_qp_index_offset)
    fs.chroma_qp_offsets = offs
    qp_c = [int(CHROMA_QP_TABLE[np.clip(qp + o, 0, 51)]) for o in offs]
    dq = ctx.dq

    if is_i16:
        # luma DC: nC from block (0,0) position context
        gx, gy = mbx * 4, mby * 4
        nc = ctx.nc_luma(gx, gy)
        dc_scan, _ = parse_residual_block(br, nc, 16)
        dc = np.zeros(16, dtype=np.int32)
        dc[_LUMA_DC_SCAN] = dc_scan
        rec_dc = luma_dc_dequant_ihadamard(dc.reshape(4, 4),
                                           dq.luma_dc_qmul(qp))
        # write DC into coefficient slot 0 of each 4x4 block (raster)
        fs.coeffs_l[mb_idx, :, 0] = rec_dc.reshape(-1)

    if fs.transform8[mb_idx]:
        # 8x8 transform: 4 interleaved 4x4 CAVLC parses per 8x8 block
        # (parity: WelsResidualBlockCavlc8x8)
        fs.ensure_coeffs8()
        for blk8 in range(4):
            b8x, b8y = blk8 % 2, blk8 // 2
            gx0, gy0 = mbx * 4 + b8x * 2, mby * 4 + b8y * 2
            if not (cbp & (1 << blk8)):
                fs.nzc_l[gy0:gy0 + 2, gx0:gx0 + 2] = 0
                continue
            levels = np.zeros(64, dtype=np.int32)
            for sub in range(4):
                gx, gy = gx0 + (sub % 2), gy0 + (sub // 2)
                nc = ctx.nc_luma(gx, gy)
                coeffs_scan, tc = parse_residual_block(br, nc, 16)
                # interleave: scan pos j of sub-block -> 8x8 scan 4*j+sub
                levels[ZIGZAG_8x8[np.arange(16) * 4 + sub]] = coeffs_scan
                fs.nzc_l[gy, gx] = tc
            fs.coeffs8[mb_idx, blk8] = dq.luma8x8(levels, qp, intra)
    else:
        # luma AC / 4x4 blocks in z-scan order
        for k in range(16):
            raster = int(ZSCAN_TO_RASTER[k])
            bx, by = raster % 4, raster // 4
            gx, gy = mbx * 4 + bx, mby * 4 + by
            blk8 = (by >> 1) * 2 + (bx >> 1)
            if not (cbp & (1 << blk8)):
                fs.nzc_l[gy, gx] = 0
                continue
            nc = ctx.nc_luma(gx, gy)
            if is_i16:
                coeffs_scan, tc = parse_residual_block(br, nc, 15)
                blkc = np.zeros(16, dtype=np.int32)
                blkc[ZIGZAG_4x4[1:]] = coeffs_scan
            else:
                coeffs_scan, tc = parse_residual_block(br, nc, 16)
                blkc = np.zeros(16, dtype=np.int32)
                blkc[ZIGZAG_4x4] = coeffs_scan
            deq = dq.luma_ac(blkc, qp, intra)
            if is_i16:
                deq[0] = fs.coeffs_l[mb_idx, raster, 0]
            fs.coeffs_l[mb_idx, raster] = deq
            fs.nzc_l[gy, gx] = tc

    # chroma DC (cbp chroma bits: 0x30 mask; any nonzero -> DC present)
    if cbp & 0x30:
        for comp in range(2):
            dc_scan, _ = parse_residual_block(br, -1, 4)
            had = hadamard2x2(dc_scan.reshape(2, 2))
            rec = dq.chroma_dc(had, qp_c[comp], intra, comp)
            fs.coeffs_c[mb_idx, comp, :, 0] = rec.reshape(-1)
    # chroma AC
    if cbp & 0x20:
        for comp in range(2):
            for k in range(4):
                bx, by = k % 2, k // 2
                cx, cy = mbx * 2 + bx, mby * 2 + by
                nc = ctx.nc_chroma(comp, cx, cy)
                coeffs_scan, tc = parse_residual_block(br, nc, 15)
                blkc = np.zeros(16, dtype=np.int32)
                blkc[ZIGZAG_4x4[1:]] = coeffs_scan
                deq = dq.chroma_ac(blkc, qp_c[comp], intra, comp)
                deq[0] = fs.coeffs_c[mb_idx, comp, k, 0]
                fs.coeffs_c[mb_idx, comp, k] = deq
                fs.nzc_c[comp, cy, cx] = tc
    else:
        fs.nzc_c[:, mby * 2:mby * 2 + 2, mbx * 2:mbx * 2 + 2] = 0


def _mb_common_init(ctx: SliceDecodeContext, mb_idx: int) -> None:
    fs, sh = ctx.fs, ctx.sh
    fs.slice_id[mb_idx] = ctx.slice_idx
    fs.disable_deblock[mb_idx] = sh.disable_deblocking_filter_idc
    fs.alpha_offset[mb_idx] = sh.slice_alpha_c0_offset
    fs.beta_offset[mb_idx] = sh.slice_beta_offset
    # reset within-MB causality mask for MV prediction
    mbx, mby = mb_idx % ctx.mb_w, mb_idx // ctx.mb_w
    ensure_motion_grids(fs)
    fs.gwritten[mby * 4:mby * 4 + 4, mbx * 4:mbx * 4 + 4] = False


def _finish_inter_mb(ctx: SliceDecodeContext, mb_idx: int) -> None:
    """Copy grid motion into per-MB tensors + resolve DPB picture ids."""
    fs = ctx.fs
    mbx, mby = mb_idx % ctx.mb_w, mb_idx // ctx.mb_w
    gy, gx = mby * 4, mbx * 4
    fs.mv[mb_idx, 0] = fs.gmv[0, gy:gy + 4, gx:gx + 4].reshape(16, 2)
    fs.mv[mb_idx, 1] = fs.gmv[1, gy:gy + 4, gx:gx + 4].reshape(16, 2)
    for q in range(4):
        qy, qx = gy + (q // 2) * 2, gx + (q % 2) * 2
        for lx, rl in ((0, ctx.ref_list0), (1, ctx.ref_list1)):
            r = int(fs.gref[lx, qy, qx])
            fs.refidx[mb_idx, lx, q] = r
            fs.ref_pic[mb_idx, lx, q] = rl[r].pic_id \
                if (0 <= r < len(rl) and rl[r] is not None) else -1
        r0 = fs.refidx[mb_idx, 0, q]
        r1 = fs.refidx[mb_idx, 1, q]
        fs.pred_mode[mb_idx, q] = (2 if (r0 >= 0 and r1 >= 0) else
                                   (1 if r1 >= 0 else (0 if r0 >= 0 else -1)))


def _mark_intra_in_grids(ctx: SliceDecodeContext, mb_idx: int) -> None:
    """Intra MBs participate in MV prediction as ref=-1, mv=0."""
    fs = ctx.fs
    mbx, mby = mb_idx % ctx.mb_w, mb_idx // ctx.mb_w
    gy, gx = mby * 4, mbx * 4
    fs.gmv[:, gy:gy + 4, gx:gx + 4] = 0
    fs.gref[:, gy:gy + 4, gx:gx + 4] = -1
    fs.gwritten[gy:gy + 4, gx:gx + 4] = True


def decode_p_skip_mb(ctx: SliceDecodeContext, mb_idx: int) -> None:
    fs = ctx.fs
    _mb_common_init(ctx, mb_idx)
    mbx, mby = mb_idx % ctx.mb_w, mb_idx // ctx.mb_w
    gx, gy = mbx * 4, mby * 4
    fs.mb_type[mb_idx] = MB_PSKIP
    mv = ctx.mvctx.pred_skip_mv(gx, gy, mb_idx)
    ctx.mvctx.set_partition(gx, gy, 4, 4, 0, 0, mv)
    ctx.mvctx.set_partition(gx, gy, 4, 4, 1, -1, np.zeros(2, np.int32))
    fs.cbp[mb_idx] = 0
    fs.qp[mb_idx] = ctx.qp
    _finish_inter_mb(ctx, mb_idx)


def _read_ref_idx(br: BitReader, num_active: int, rl=None) -> int:
    if num_active <= 1:
        return 0
    r = br.te(num_active - 1)
    # invalid/missing ref -> conceal with ref 0 and keep decoding, like
    # the reference with EC active (parse_mb_syn_cavlc/ cabac
    # "error ref_idx" paths, e.g. parse_mb_syn_cabac.cpp:545-553)
    if rl is not None and not (0 <= r < len(rl) and rl[r] is not None):
        return 0
    return r


# sub_mb_type for P (Table 7-17): (n_parts, pw, ph) in 4x4-block units
_P_SUB_SHAPES = {0: (1, 2, 2), 1: (2, 2, 1), 2: (2, 1, 2), 3: (4, 1, 1)}


def decode_p_mb_cavlc(br: BitReader, ctx: SliceDecodeContext, mb_idx: int,
                      mb_type_raw: int) -> None:
    fs, sh = ctx.fs, ctx.sh
    if mb_type_raw >= 5:
        _mb_common_init(ctx, mb_idx)
        decode_i_mb_cavlc(br, ctx, mb_idx, mb_type_raw - 5)
        _mark_intra_in_grids(ctx, mb_idx)
        return
    _mb_common_init(ctx, mb_idx)
    fs.pred_mode[mb_idx, :] = 0
    mbx, mby = mb_idx % ctx.mb_w, mb_idx // ctx.mb_w
    gx, gy = mbx * 4, mby * 4
    n_ref = sh.num_ref_idx_l0_active
    mvc = ctx.mvctx

    if mb_type_raw == 0:  # P_L0_16x16
        fs.mb_type[mb_idx] = MB_P16x16
        ref = _read_ref_idx(br, n_ref, ctx.ref_list0)
        mvd = np.array([br.se(), br.se()], np.int32)
        mv = mvc.pred_mv(gx, gy, 4, 4, 0, ref, mb_idx) + mvd
        mvc.set_partition(gx, gy, 4, 4, 0, ref, mv)
    elif mb_type_raw == 1:  # P_L0_L0_16x8
        fs.mb_type[mb_idx] = MB_P16x8
        refs = [_read_ref_idx(br, n_ref, ctx.ref_list0) for _ in range(2)]
        for part in range(2):
            py = gy + part * 2
            mvd = np.array([br.se(), br.se()], np.int32)
            mv = mvc.pred_mv(gx, py, 4, 2, 0, refs[part], mb_idx) + mvd
            mvc.set_partition(gx, py, 4, 2, 0, refs[part], mv)
    elif mb_type_raw == 2:  # P_L0_L0_8x16
        fs.mb_type[mb_idx] = MB_P8x16
        refs = [_read_ref_idx(br, n_ref, ctx.ref_list0) for _ in range(2)]
        for part in range(2):
            px = gx + part * 2
            mvd = np.array([br.se(), br.se()], np.int32)
            mv = mvc.pred_mv(px, gy, 2, 4, 0, refs[part], mb_idx) + mvd
            mvc.set_partition(px, gy, 2, 4, 0, refs[part], mv)
    else:  # P_8x8 (3) / P_8x8ref0 (4)
        fs.mb_type[mb_idx] = MB_P8x8
        sub_types = [br.ue() for _ in range(4)]
        if any(t > 3 for t in sub_types):
            raise ValueError(f"invalid P sub_mb_type {sub_types}")
        if mb_type_raw == 3:
            refs = [_read_ref_idx(br, n_ref, ctx.ref_list0) for _ in range(4)]
        else:
            refs = [0, 0, 0, 0]
        for q in range(4):
            q_gx, q_gy = gx + (q % 2) * 2, gy + (q // 2) * 2
            n_parts, pw, ph = _P_SUB_SHAPES[sub_types[q]]
            for part in range(n_parts):
                if sub_types[q] == 1:  # 8x4
                    px, py = q_gx, q_gy + part
                elif sub_types[q] == 2:  # 4x8
                    px, py = q_gx + part, q_gy
                elif sub_types[q] == 3:  # 4x4
                    px, py = q_gx + (part % 2), q_gy + (part // 2)
                else:
                    px, py = q_gx, q_gy
                mvd = np.array([br.se(), br.se()], np.int32)
                mv = mvc.pred_mv(px, py, pw, ph, 0, refs[q], mb_idx) + mvd
                mvc.set_partition(px, py, pw, ph, 0, refs[q], mv)
    # list1 unused in P
    mvc.set_partition(gx, gy, 4, 4, 1, -1, np.zeros(2, np.int32))
    _finish_inter_mb(ctx, mb_idx)

    # NoSubMbPartSizeLessThan8x8Flag (7.3.5): only P_L0_8x8 sub types
    # keep the 8x8 transform legal (parse_mb_syn_cavlc.cpp:1229)
    t8_allowed = (mb_type_raw < 3) or all(t == 0 for t in sub_types)
    cbp_code = br.ue()
    if cbp_code >= 48:
        raise ValueError("invalid inter cbp")
    cbp = int(CBP_INTER[cbp_code])
    fs.cbp[mb_idx] = cbp
    # inter transform_size_8x8_flag (7.3.5; decode_slice.cpp:2278-2288)
    if (cbp & 15) and sh.pps.transform_8x8_mode and t8_allowed:
        fs.transform8[mb_idx] = bool(br.u(1))
    if cbp:
        parse_mb_residual_cavlc(br, ctx, mb_idx, cbp, is_i16=False)
    else:
        fs.qp[mb_idx] = ctx.qp
        fs.nzc_l[mby * 4:mby * 4 + 4, mbx * 4:mbx * 4 + 4] = 0
        fs.nzc_c[:, mby * 2:mby * 2 + 2, mbx * 2:mbx * 2 + 2] = 0


# ---------------------------------------------------------------------------
# B slices
# ---------------------------------------------------------------------------
# two-partition B mb_type 4..21: (shape16x8?, mode_part0, mode_part1)
# modes: 0=L0, 1=L1, 2=BI
_B_TWOPART_MODES = [(0, 0), (1, 1), (0, 1), (1, 0), (0, 2), (1, 2),
                    (2, 0), (2, 1), (2, 2)]
# B sub_mb_type (Table 7-18): (mode, n_parts, pw, ph) ; mode -1 = direct
_B_SUB = {0: (-1, 4, 1, 1), 1: (0, 1, 2, 2), 2: (1, 1, 2, 2), 3: (2, 1, 2, 2),
          4: (0, 2, 2, 1), 5: (0, 2, 1, 2), 6: (1, 2, 2, 1), 7: (1, 2, 1, 2),
          8: (2, 2, 2, 1), 9: (2, 2, 1, 2), 10: (0, 4, 1, 1),
          11: (1, 4, 1, 1), 12: (2, 4, 1, 1)}


def apply_direct(ctx: SliceDecodeContext, mb_idx: int, gx0: int, gy0: int,
                 nblk: int) -> None:
    """Fill motion grids for a direct region: whole MB (nblk=4, at MB
    corner) or one 8x8 (nblk=2)."""
    dctx = ctx.direct
    mvc = ctx.mvctx
    fs = ctx.fs
    mbx, mby = mb_idx % ctx.mb_w, mb_idx // ctx.mb_w
    mb_gx, mb_gy = mbx * 4, mby * 4
    if nblk == 4:
        # GetColocatedMb promotion (mv_pred.cpp:342): whole-direct MB
        # becomes 16x16-class when the col MB is 16x16/intra/skip.
        # Feeds deblock interior-bS mode (WelsDeblockingMb: IS_SKIP ->
        # no interior edges, IS_INTER_16x16 -> nz-only) and the
        # recursive promotion record for future col use.
        col16 = getattr(dctx.col, "col_mb16", None)
        promoted = bool(col16[mb_idx]) if col16 is not None else False
        fs.mb16[mb_idx] = promoted
        # clause 8.7.2.1 takes the mv term on every edge (ibs_mode 0)
        if fs.openh264_compat:
            if fs.mb_type[mb_idx] == MB_BSKIP:
                fs.ibs_mode[mb_idx] = 2
            else:
                fs.ibs_mode[mb_idx] = 1 if promoted else 0
    else:
        fs.sub_direct[mb_idx] = True
    if dctx.spatial:
        ref0, ref1, mv0, mv1, use0, use1 = ctx.spatial_direct_mb(mb_idx)
        step = 2 if dctx.direct_8x8 else 1
        for oy in range(0, nblk, step):
            for ox in range(0, nblk, step):
                bx, by = gx0 + ox, gy0 + oy
                cz = dctx.col_zero(bx, by) if dctx.col is not None else False
                m0 = np.zeros(2, np.int32) if (cz and ref0 == 0) else mv0
                m1 = np.zeros(2, np.int32) if (cz and ref1 == 0) else mv1
                mvc.set_partition(bx, by, step, step, 0,
                                  ref0 if use0 else -1, m0 if use0 else 0)
                mvc.set_partition(bx, by, step, step, 1,
                                  ref1 if use1 else -1, m1 if use1 else 0)
    else:
        step = 2 if dctx.direct_8x8 else 1
        for oy in range(0, nblk, step):
            for ox in range(0, nblk, step):
                bx, by = gx0 + ox, gy0 + oy
                r0, r1, mv0, mv1 = dctx.temporal_direct(bx, by)
                mvc.set_partition(bx, by, step, step, 0, r0, mv0)
                mvc.set_partition(bx, by, step, step, 1, r1, mv1)


def decode_b_skip_mb(ctx: SliceDecodeContext, mb_idx: int) -> None:
    fs = ctx.fs
    _mb_common_init(ctx, mb_idx)
    mbx, mby = mb_idx % ctx.mb_w, mb_idx // ctx.mb_w
    fs.mb_type[mb_idx] = MB_BSKIP
    apply_direct(ctx, mb_idx, mbx * 4, mby * 4, 4)
    fs.cbp[mb_idx] = 0
    fs.qp[mb_idx] = ctx.qp
    _finish_inter_mb(ctx, mb_idx)


def decode_b_mb_cavlc(br: BitReader, ctx: SliceDecodeContext, mb_idx: int,
                      mb_type_raw: int) -> None:
    fs, sh = ctx.fs, ctx.sh
    if mb_type_raw >= 23:
        _mb_common_init(ctx, mb_idx)
        decode_i_mb_cavlc(br, ctx, mb_idx, mb_type_raw - 23)
        _mark_intra_in_grids(ctx, mb_idx)
        return
    _mb_common_init(ctx, mb_idx)
    mbx, mby = mb_idx % ctx.mb_w, mb_idx // ctx.mb_w
    gx, gy = mbx * 4, mby * 4
    mvc = ctx.mvctx
    n0, n1 = sh.num_ref_idx_l0_active, sh.num_ref_idx_l1_active

    if mb_type_raw == 0:  # B_Direct_16x16
        fs.mb_type[mb_idx] = MB_BDIRECT
        apply_direct(ctx, mb_idx, gx, gy, 4)
    elif mb_type_raw <= 3:  # B_X_16x16
        fs.mb_type[mb_idx] = MB_B16x16
        mode = mb_type_raw - 1  # 0=L0,1=L1,2=BI
        lists = (0,) if mode == 0 else (1,) if mode == 1 else (0, 1)
        refs = {}
        for lx in lists:
            refs[lx] = _read_ref_idx(br, n0 if lx == 0 else n1,
                                      ctx.ref_list0 if lx == 0 else ctx.ref_list1)
        # unused lists become final (ref -1, mv 0) as soon as refs are known
        for lx in (0, 1):
            if lx not in lists:
                mvc.set_partition(gx, gy, 4, 4, lx, -1, np.zeros(2, np.int32))
        for lx in lists:
            mvd = np.array([br.se(), br.se()], np.int32)
            mv = mvc.pred_mv(gx, gy, 4, 4, lx, refs[lx], mb_idx) + mvd
            mvc.set_partition(gx, gy, 4, 4, lx, refs[lx], mv)
    elif mb_type_raw <= 21:  # two partitions
        t = mb_type_raw - 4
        is16x8 = (t % 2) == 0
        modes = _B_TWOPART_MODES[t // 2]
        fs.mb_type[mb_idx] = MB_B16x8 if is16x8 else MB_B8x16
        pw, ph = (4, 2) if is16x8 else (2, 4)
        part_pos = [(gx, gy), (gx, gy + 2) if is16x8 else (gx + 2, gy)]
        refs = [[-1, -1], [-1, -1]]
        for lx in (0, 1):
            for part in range(2):
                if modes[part] == lx or modes[part] == 2:
                    refs[part][lx] = _read_ref_idx(br, n0 if lx == 0 else n1,
                                                   ctx.ref_list0 if lx == 0 else ctx.ref_list1)
        # unused lists become final immediately (visible to later MVPs)
        for part in range(2):
            px, py = part_pos[part]
            for lx in (0, 1):
                if refs[part][lx] < 0:
                    mvc.set_partition(px, py, pw, ph, lx, -1, np.zeros(2, np.int32))
        for lx in (0, 1):
            for part in range(2):
                px, py = part_pos[part]
                if refs[part][lx] >= 0:
                    mvd = np.array([br.se(), br.se()], np.int32)
                    mv = mvc.pred_mv(px, py, pw, ph, lx, refs[part][lx], mb_idx) + mvd
                    mvc.set_partition(px, py, pw, ph, lx, refs[part][lx], mv)
    else:  # 22: B_8x8
        fs.mb_type[mb_idx] = MB_B8x8
        sub_types = [br.ue() for _ in range(4)]
        if any(t > 12 for t in sub_types):
            raise ValueError(f"invalid B sub_mb_type {sub_types}")
        subs = [_B_SUB[t] for t in sub_types]
        refs = [[-1, -1] for _ in range(4)]
        for lx in (0, 1):
            for q in range(4):
                mode = subs[q][0]
                if mode == lx or mode == 2:
                    refs[q][lx] = _read_ref_idx(br, n0 if lx == 0 else n1,
                                                ctx.ref_list0 if lx == 0 else ctx.ref_list1)
        # direct sub-blocks resolved before any mvd parse uses neighbors
        for q in range(4):
            if subs[q][0] == -1:
                apply_direct(ctx, mb_idx, gx + (q % 2) * 2, gy + (q // 2) * 2, 2)
        # CAVLC quirk (parse_mb_syn_cavlc.cpp: ref_idx_list memset to
        # REF_NOT_IN_LIST and never assigned for temporal-direct
        # quadrants, then written into the MVP ref cache in the mv
        # loop): same-MB MVPs see temporal-direct quadrants as ref -1
        # while their MVs stay visible for the median.  CABAC writes
        # the true refs (UpdateP8x8RefCacheIdxCabac in the direct
        # fill), so this masking is CAVLC-only.
        _dmask = []
        if ctx.direct is not None and not ctx.direct.spatial:
            for q in range(4):
                if subs[q][0] == -1:
                    q_gx, q_gy = gx + (q % 2) * 2, gy + (q // 2) * 2
                    for lx in (0, 1):
                        _dmask.append(
                            (lx, q_gx, q_gy,
                             fs.gref[lx, q_gy:q_gy + 2, q_gx:q_gx + 2].copy()))
                        fs.gref[lx, q_gy:q_gy + 2, q_gx:q_gx + 2] = -1
        # unused lists of non-direct sub-blocks become final immediately
        for q in range(4):
            if subs[q][0] == -1:
                continue
            q_gx, q_gy = gx + (q % 2) * 2, gy + (q // 2) * 2
            for lx in (0, 1):
                if refs[q][lx] < 0:
                    mvc.set_partition(q_gx, q_gy, 2, 2, lx, -1,
                                      np.zeros(2, np.int32))
        for lx in (0, 1):
            for q in range(4):
                mode, n_parts, pw, ph = subs[q]
                if mode == -1 or (mode != lx and mode != 2):
                    continue
                q_gx, q_gy = gx + (q % 2) * 2, gy + (q // 2) * 2
                for part in range(n_parts):
                    if (pw, ph) == (2, 1):
                        px, py = q_gx, q_gy + part
                    elif (pw, ph) == (1, 2):
                        px, py = q_gx + part, q_gy
                    elif (pw, ph) == (1, 1):
                        px, py = q_gx + (part % 2), q_gy + (part // 2)
                    else:
                        px, py = q_gx, q_gy
                    mvd = np.array([br.se(), br.se()], np.int32)
                    mv = mvc.pred_mv(px, py, pw, ph, lx, refs[q][lx], mb_idx) + mvd
                    mvc.set_partition(px, py, pw, ph, lx, refs[q][lx], mv)
        # restore the true refs of temporal-direct quadrants so later
        # MBs (and recon) see them
        for lx, q_gx, q_gy, vals in _dmask:
            fs.gref[lx, q_gy:q_gy + 2, q_gx:q_gx + 2] = vals
    _finish_inter_mb(ctx, mb_idx)

    # NoSubMbPartSizeLessThan8x8Flag for B (7.3.5): B_8x8 keeps it true
    # only for 8x8-shaped subs (direct counts as 8x8 under the reference's
    # part-count table, wels_common_basis.h g_ksInterBSubMbTypeInfo);
    # B_Direct_16x16 stays allowed (decode_slice.cpp:2825 "|| noSub")
    t8_allowed = (mb_type_raw != 22) or all(t <= 3 for t in sub_types)
    cbp_code = br.ue()
    if cbp_code >= 48:
        raise ValueError("invalid inter cbp")
    cbp = int(CBP_INTER[cbp_code])
    fs.cbp[mb_idx] = cbp
    if (cbp & 15) and sh.pps.transform_8x8_mode and t8_allowed:
        fs.transform8[mb_idx] = bool(br.u(1))
    if cbp:
        parse_mb_residual_cavlc(br, ctx, mb_idx, cbp, is_i16=False)
    else:
        fs.qp[mb_idx] = ctx.qp
        fs.nzc_l[mby * 4:mby * 4 + 4, mbx * 4:mbx * 4 + 4] = 0
        fs.nzc_c[:, mby * 2:mby * 2 + 2, mbx * 2:mbx * 2 + 2] = 0


def decode_slice_mbs_cavlc(br: BitReader, ctx: SliceDecodeContext) -> int:
    """The per-MB Python parser: all MBs of an I, P or B CAVLC slice, in
    raster order or along ctx.fmo_next. Returns the index one past the
    last MB."""
    sh = ctx.sh
    fs = ctx.fs
    mb_idx = sh.first_mb_in_slice
    n_mb = ctx.mb_w * ctx.mb_h
    nxt = ((lambda i: int(ctx.fmo_next[i])) if ctx.fmo_next is not None
           else (lambda i: i + 1))
    if sh.slice_type == I_SLICE:
        while True:
            mb_type_raw = br.ue()
            _mb_common_init(ctx, mb_idx)
            decode_i_mb_cavlc(br, ctx, mb_idx, mb_type_raw)
            fs.mb_correct[mb_idx] = True
            mb_idx = nxt(mb_idx)
            if mb_idx >= n_mb or not br.more_rbsp_data():
                break
        return mb_idx
    is_b = sh.slice_type == B_SLICE
    skip_mb = decode_b_skip_mb if is_b else decode_p_skip_mb
    coded_mb = decode_b_mb_cavlc if is_b else decode_p_mb_cavlc
    while mb_idx < n_mb:
        skip_run = br.ue()
        for _ in range(skip_run):
            if mb_idx >= n_mb:
                raise ValueError("mb_skip_run past end of picture")
            skip_mb(ctx, mb_idx)
            fs.mb_correct[mb_idx] = True
            mb_idx = nxt(mb_idx)
        if mb_idx >= n_mb or not br.more_rbsp_data():
            break
        mb_type_raw = br.ue()
        coded_mb(br, ctx, mb_idx, mb_type_raw)
        fs.mb_correct[mb_idx] = True
        mb_idx = nxt(mb_idx)
    return mb_idx
