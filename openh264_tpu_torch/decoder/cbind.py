"""Host C of the decoder, bound with ctypes: the CAVLC slice parser of I
and P slices (parse_cavlc_slice_native, csrc/parse_cavlc.c), the CABAC
slice parser of I, P and B slices (parse_cabac_slice_native,
csrc/parse_cabac.c), the CABAC residual-block bins of the per-MB Python
CABAC parser (cabac_residual_lib, csrc/cabac_residual.c) and the intra
reconstruction (recon_intra_mbs_native, csrc/host_native.c).
_build.SIGNATURES declares their C signatures; this module packs
FrameSymbols into their pointer and parameter arrays.

Which slices the two parsers take is slice_dec.c_parses, the decoder's
one routing rule (decoder.py's parse_slice_data): each parser refuses
any other slice with NotImplementedError, which the decoder never
conceals.

Port of the functions of openh264_tpu/native/__init__.py that these
paths run, and the CABAC slice parser, which the JAX package does not
have (its CABAC syntax elements run per bin in Python). Unlike the JAX
package, which falls back to its Python parser or to Python CABAC bins
when its C does not build, this module has no fallback: a failed build
raises.
"""

from __future__ import annotations

import functools

import numpy as np

from .. import _build
from ..tables import CHROMA_QP_TABLE, ZIGZAG_4x4, ZIGZAG_8x8
from ..tables.cavlc import (CBP_I16x16, CBP_INTER, CBP_INTRA,
                            COEFF_TOKEN_LUTS, RUN_BEFORE_LUTS,
                            TOTAL_ZEROS_CDC_LUTS, TOTAL_ZEROS_LUTS)
from ..utils import trace
from .cabac import CTX_INIT_MN, RANGE_LPS, STATE_TRANS
from .mvpred import ensure_motion_grids
from .slice_dec import c_parses
from .slicehdr import B_SLICE, I_SLICE, P_SLICE


@functools.lru_cache(maxsize=None)
def _cavlc_tables() -> dict:
    """The CAVLC parser's VLC LUTs and tables as contiguous arrays."""

    def stack(luts, n, size):
        return np.ascontiguousarray(np.stack(
            [luts[i] if i < len(luts) and luts[i] is not None
             else np.zeros(size, np.uint32) for i in range(n)]), np.uint32)
    return {
        "ct": np.ascontiguousarray(np.stack(COEFF_TOKEN_LUTS), np.uint32),
        "tz": stack(TOTAL_ZEROS_LUTS, 16, 512),
        "tzc": stack(TOTAL_ZEROS_CDC_LUTS, 4, 8),
        "rb": stack(RUN_BEFORE_LUTS, 8, 2048),
        "cbp_inter": np.ascontiguousarray(CBP_INTER, np.int32),
        "cbp_intra": np.ascontiguousarray(CBP_INTRA, np.int32),
        "cbp_i16": np.ascontiguousarray(CBP_I16x16, np.int32),
        "cqp": np.ascontiguousarray(CHROMA_QP_TABLE, np.int32),
        "zz": np.ascontiguousarray(ZIGZAG_4x4, np.int32),
    }


def parse_cavlc_slice_native(br, ctx) -> int:
    """Parses one CAVLC slice that c_parses gives the C (I or P, no 8x8
    transform, no FMO) from br's bit position into ctx.fs, and returns
    the index one past its last MB. Raises EOFError on a bitstream
    overrun and ValueError on an invalid code, with br.pos and the MBs
    parsed so far left as the C left them (the decoder conceals the
    rest). Any other slice is a caller's fault, NotImplementedError,
    which the decoder never conceals."""
    sh, fs = ctx.sh, ctx.fs
    if sh.pps.entropy_coding_mode or not c_parses(sh):
        raise NotImplementedError("parse_cavlc_slice_native: the CAVLC "
                                  "slices of slice_dec.c_parses only")
    ensure_motion_grids(fs)
    t = _cavlc_tables()
    n_mb = fs.n_mb
    ipcm_buf = np.zeros((n_mb, 384), np.uint8)
    ipcm_flag = np.zeros(n_mb, np.uint8)
    l0_ids = np.array(
        [p.pic_id if p is not None else -1 for p in ctx.ref_list0],
        np.int32)
    if len(l0_ids) == 0:
        l0_ids = np.zeros(1, np.int32)
    rbsp = np.frombuffer(br.data, np.uint8)
    t8 = np.zeros(n_mb, np.uint8)
    arrs = [rbsp, t["ct"], t["tz"], t["tzc"], t["rb"], t["cbp_inter"],
            t["cbp_intra"], t["cbp_i16"], ctx.dq.eff4(), t["cqp"], t["zz"],
            fs.mb_type, fs.slice_id, fs.i4_grid, fs.i16_mode, fs.i4_modes,
            fs.chroma_mode, fs.cbp, fs.qp, fs.nzc_l, fs.nzc_c,
            fs.coeffs_l, fs.coeffs_c, fs.mv, fs.refidx, fs.ref_pic,
            fs.pred_mode, fs.gmv, fs.gref, fs.gwritten, fs.grefw,
            l0_ids, fs.disable_deblock, fs.alpha_offset, fs.beta_offset,
            fs.mb_correct, ipcm_buf, ipcm_flag, t8]
    for a in arrs:
        if not a.flags["C_CONTIGUOUS"]:
            raise ValueError("parse_cavlc_slice_native: non-contiguous "
                             "symbol array")
    ptrs = np.array([a.ctypes.data for a in arrs], np.uint64)
    params = np.array([
        br.nbits, br.pos, 0 if sh.slice_type == P_SLICE else 2,
        sh.first_mb_in_slice, fs.mb_w, fs.mb_h, ctx.slice_idx, ctx.qp,
        sh.num_ref_idx_l0_active, int(ctx.constrained_intra),
        sh.disable_deblocking_filter_idc, sh.slice_alpha_c0_offset,
        sh.slice_beta_offset, sh.pps.chroma_qp_index_offset,
        sh.pps.second_chroma_qp_index_offset, len(l0_ids)], np.int32)
    out = np.zeros(4, np.int32)
    _build.bind("parse_cavlc").parse_cavlc_slice(
        ptrs.ctypes.data, params.ctypes.data, out.ctypes.data)
    br.pos = int(out[1])
    if out[2] == 1:
        raise EOFError("bitstream overrun (native CAVLC parse)")
    if out[2] != 0:
        raise ValueError("invalid CAVLC bitstream (native parse)")
    fs.chroma_qp_offsets = (sh.pps.chroma_qp_index_offset,
                            sh.pps.second_chroma_qp_index_offset)
    for idx in np.nonzero(ipcm_flag)[0]:
        raw = ipcm_buf[idx]
        fs.ipcm[int(idx)] = (raw[:256].reshape(16, 16).copy(),
                             raw[256:320].reshape(8, 8).copy(),
                             raw[320:].reshape(8, 8).copy())
    return int(out[0])


@functools.lru_cache(maxsize=None)
def _cabac_tables() -> dict:
    """The CABAC parser's tables as contiguous arrays."""
    return {
        "init_mn": np.ascontiguousarray(CTX_INIT_MN, np.int32),
        "range_lps": np.ascontiguousarray(RANGE_LPS, np.int32),
        "state_trans": np.ascontiguousarray(STATE_TRANS, np.int32),
        "cqp": np.ascontiguousarray(CHROMA_QP_TABLE, np.int32),
        "zz": np.ascontiguousarray(ZIGZAG_4x4, np.int32),
        "cbp_i16": np.ascontiguousarray(CBP_I16x16, np.int32),
        "zz8": np.ascontiguousarray(ZIGZAG_8x8, np.int32),
    }


# parse_cabac_slice's error codes (out[2]) and the exception each is
_CABAC_ERRORS = {2: (ValueError, "invalid CABAC bitstream (native parse)"),
                 3: (IndexError, "slice QP outside the dequant tables "
                                 "(native CABAC parse)"),
                 4: (OverflowError, "CABAC offset past int64 at a residual "
                                    "block (native parse)"),
                 5: (AttributeError, "temporal direct without a colocated "
                                     "picture (native CABAC parse)"),
                 6: (OverflowError, "temporal direct MV past int32 "
                                    "(native CABAC parse)")}


def parse_cabac_slice_native(rbsp: bytes, bitpos: int, ctx) -> tuple:
    """Parses one CABAC slice that c_parses gives the C (I, P or B, with
    or without the 8x8 transform, no FMO) from bit `bitpos` of its RBSP
    (the end of its header) into ctx.fs, as
    slice_dec_cabac.decode_slice_mbs_cabac does, array for array, B
    direct prediction included (ctx.direct's
    colocated picture and DistScaleFactors go in as arrays, once per
    slice). Returns (one past the last MB, the engine's end bit). Raises
    what the Python parser raises: ValueError on a runaway code or
    truncated IPCM samples, IndexError on a QP outside the dequant
    tables or a colocated block outside the colocated picture,
    OverflowError where a broken stream grows the engine's offset past
    int64 before a residual block or a temporal-direct MV past int32,
    AttributeError on temporal direct without a colocated picture, with
    the MBs parsed so far marked in fs.mb_correct and every array as the
    Python parser leaves it. Counts cabac_c_mbs and cabac_bins on the
    open span while the recorder is on. Any other slice is a caller's
    fault, NotImplementedError."""
    sh, fs = ctx.sh, ctx.fs
    if not sh.pps.entropy_coding_mode or not c_parses(sh):
        raise NotImplementedError("parse_cabac_slice_native: the CABAC "
                                  "slices of slice_dec.c_parses only")
    fs.ensure_cabac_state()
    is_i = sh.slice_type == I_SLICE
    is_b = sh.slice_type == B_SLICE
    if not is_i and not 0 <= sh.cabac_init_idc <= 2:
        # CabacContexts indexes the m,n table by cabac_init_idc + 1
        raise IndexError(f"cabac_init_idc {sh.cabac_init_idc} out of 0..2")
    t = _cabac_tables()
    n_mb = fs.n_mb
    ipcm_buf = np.empty((n_mb, 384), np.uint8)
    ipcm_flag = np.zeros(n_mb, np.uint8)
    ids = [np.array([p.pic_id if p is not None else -1 for p in rl] or [-1],
                    np.int32) for rl in (ctx.ref_list0, ctx.ref_list1)]
    # the 8x8 coefficients: an MB reaches them only through transform8,
    # which only a transform_8x8_mode PPS sets
    coeffs8 = fs.coeffs8
    if coeffs8 is None:
        coeffs8 = (np.zeros((n_mb, 4, 64), np.int32)
                   if sh.pps.transform_8x8_mode or fs.transform8.any()
                   else _NO_COEFFS8)
    col_arrays, col_params = _direct_inputs(ctx, is_b)
    i32, i8, u8, b = np.int32, np.int8, np.uint8, np.bool_
    typed = [
        (np.frombuffer(rbsp, u8), u8), (t["init_mn"], i32),
        (t["range_lps"], i32), (t["state_trans"], i32),
        (ctx.dq.eff4(), np.int64), (t["cqp"], i32), (t["zz"], i32),
        (t["cbp_i16"], i32), (ids[0], i32), (fs.mb_type, i32),
        (fs.slice_id, i32), (fs.transform8, b), (fs.i16_mode, i32),
        (fs.chroma_mode, i32), (fs.i4_modes, i32), (fs.cbp, i32),
        (fs.qp, i32), (fs.mv, i32), (fs.refidx, i8), (fs.ref_pic, i32),
        (fs.pred_mode, i8), (fs.coeffs_l, i32), (fs.coeffs_c, i32),
        (fs.nzc_l, i32), (fs.nzc_c, i32), (fs.disable_deblock, i32),
        (fs.alpha_offset, i32), (fs.beta_offset, i32), (fs.mb_correct, b),
        (fs.i4_grid, i32), (fs.gmv, i32), (fs.gref, i32),
        (fs.gwritten, b), (fs.grefw, b), (fs.cbf_dc, i32), (fs.gmvd, i32),
        (fs.gdirect, i8), (ipcm_buf, u8), (ipcm_flag, u8), (ids[1], i32),
        (ctx.dq.eff8(), np.int64), (t["zz8"], i32), (coeffs8, i32),
        (fs.mb16, b), (fs.sub_direct, b), (fs.ibs_mode, u8),
        *col_arrays]
    for a, dt in typed:
        if a.dtype != dt or not a.flags["C_CONTIGUOUS"]:
            raise ValueError("parse_cabac_slice_native: a symbol array of "
                             f"{a.dtype} (contiguous: "
                             f"{a.flags['C_CONTIGUOUS']}) where {dt} is due")
    ptrs = np.array([a.ctypes.data for a, _dt in typed], np.uint64)
    params = np.array([
        8 * len(rbsp), bitpos, int(is_i), sh.first_mb_in_slice, fs.mb_w,
        fs.mb_h, ctx.slice_idx, ctx.qp, sh.cabac_init_idc,
        sh.num_ref_idx_l0_active, len(ctx.ref_list0),
        int(ctx.constrained_intra), sh.disable_deblocking_filter_idc,
        sh.slice_alpha_c0_offset, sh.slice_beta_offset,
        sh.pps.chroma_qp_index_offset, sh.pps.second_chroma_qp_index_offset,
        int(is_b), int(bool(sh.pps.transform_8x8_mode)),
        sh.num_ref_idx_l1_active if is_b else 0, len(ctx.ref_list1),
        *col_params, int(bool(fs.openh264_compat))], np.int64)
    out = np.zeros(7, np.int64)
    _build.bind("parse_cabac").parse_cabac_slice(
        ptrs.ctypes.data, params.ctypes.data, out.ctypes.data)
    end_mb, end_pos, err, bins, n_done, residual, used8 = (int(v) for v in out)
    # the Python parser sets the deblock's chroma offsets at the first MB
    # that reaches its residual, allocates the 8x8 coefficients at the
    # first MB that reaches an 8x8 residual, and keeps each IPCM MB's
    # samples as it parses it, also in a slice that fails later
    if residual:
        fs.chroma_qp_offsets = (sh.pps.chroma_qp_index_offset,
                                sh.pps.second_chroma_qp_index_offset)
    if used8 and fs.coeffs8 is None:
        fs.coeffs8 = coeffs8
    for idx in np.nonzero(ipcm_flag)[0]:
        raw = ipcm_buf[idx]
        fs.ipcm[int(idx)] = (raw[:256].reshape(16, 16).copy(),
                             raw[256:320].reshape(8, 8).copy(),
                             raw[320:].reshape(8, 8).copy())
    trace.count("cabac_c_mbs", n_done)
    trace.count("cabac_bins", bins)
    if err:
        exc, msg = _CABAC_ERRORS[err]
        raise exc(msg)
    return end_mb, end_pos


_NO_COEFFS8 = np.zeros((1, 4, 64), np.int32)
# the colocated grids of a slice without a colocated picture
_NO_COL = ([(np.zeros(2, np.int32), np.int32)] * 6 +
           [(np.zeros(1, np.bool_), np.bool_)] * 2 +
           [(np.zeros(1, np.int32), np.int32)])


def _direct_inputs(ctx, is_b: bool) -> tuple:
    """A slice's direct prediction for parse_cabac_slice as (arrays,
    params): the motion grids of its colocated picture
    (direct.DirectContext.col, list 1's first picture, as
    H264Decoder._attach_col_motion saved them) and the DistScaleFactor
    of each list 0 index, placeholders where it has none; params:
    spatial, direct_8x8_inference, a colocated picture, long term, its
    grids' width and height in 4x4 blocks, its col_mb16's length (0:
    none)."""
    d = ctx.direct if is_b else None
    col = d.col if d is not None else None
    flags = [int(bool(d and d.spatial)), int(bool(d and d.direct_8x8))]
    if col is None:
        return _NO_COL, flags + [0, 0, 0, 0, 0]
    i32 = np.int32
    grids = [np.ascontiguousarray(g, dt) for g, dt in (
        (col.col_mv0, i32), (col.col_mv1, i32), (col.col_ref0, i32),
        (col.col_ref1, i32), (col.col_refpic0, i32), (col.col_refpic1, i32),
        (col.col_intra, np.bool_))]
    h4, w4 = grids[-1].shape
    if any(g.shape[:2] != (h4, w4) for g in grids):
        raise ValueError("_direct_inputs: colocated grids of unequal shapes")
    mb16 = getattr(col, "col_mb16", None)
    n16 = 0 if mb16 is None else len(mb16)
    mb16 = (_NO_COL[6][0] if mb16 is None
            else np.ascontiguousarray(mb16, np.bool_))
    dsf = np.ascontiguousarray(d.dsf or [0], i32)
    arrays = [(g, g.dtype) for g in grids] + [(mb16, np.bool_), (dsf, i32)]
    return arrays, flags + [1, int(bool(col.is_long_term)), w4, h4, n16]


def recon_intra_mbs_native(y, u, v, fs, intra_list, constrained: bool):
    """Intra recon of the I4x4 / I8x8 / I16x16 / IPCM MBs `intra_list`
    (raster order) into the host uint8 planes y, u, v in place (MB
    aligned, C-contiguous), as decoder/recon_oracle.recon_intra_mb."""
    n_mb = fs.n_mb
    ipcm_flag = np.zeros(n_mb, np.uint8)
    ipcm_buf = np.zeros((1, 384), np.uint8)
    if fs.ipcm:
        ipcm_buf = np.zeros((n_mb, 384), np.uint8)
        for idx, (py, pu, pv) in fs.ipcm.items():
            ipcm_flag[idx] = 1
            ipcm_buf[idx, :256] = np.asarray(py, np.uint8).reshape(-1)
            ipcm_buf[idx, 256:320] = np.asarray(pu, np.uint8).reshape(-1)
            ipcm_buf[idx, 320:] = np.asarray(pv, np.uint8).reshape(-1)
    mb_list = np.ascontiguousarray(intra_list, np.int32)
    coeffs8 = (fs.coeffs8 if fs.coeffs8 is not None
               else np.zeros((1, 4, 64), np.int32))
    arrs = [y, u, v, fs.mb_type, fs.slice_id, fs.i16_mode, fs.i4_modes,
            fs.chroma_mode, fs.coeffs_l, fs.coeffs_c, ipcm_buf, ipcm_flag,
            mb_list, coeffs8]
    if y.shape != (16 * fs.mb_h, 16 * fs.mb_w) or \
            u.shape != (8 * fs.mb_h, 8 * fs.mb_w) or v.shape != u.shape or \
            any(p.dtype != np.uint8 for p in (y, u, v)):
        raise ValueError("recon_intra_mbs_native: MB-aligned uint8 planes")
    for a in arrs:
        if not a.flags["C_CONTIGUOUS"]:
            raise ValueError("recon_intra_mbs_native: non-contiguous array")
    ptrs = np.array([a.ctypes.data for a in arrs], np.uint64)
    params = np.array([fs.mb_w, fs.mb_h, len(mb_list), int(constrained)],
                      np.int32)
    _build.bind("host_native").recon_intra_mbs(ptrs.ctypes.data,
                                               params.ctypes.data)


def cabac_residual_lib():
    """csrc/cabac_residual.c: `cabac_residual(data, nbits, st, cstate,
    cmps, range_lps, state_trans, params, sig_out)` decodes one residual
    block's bins over the Python engine's state (st: pos, range, offset)
    and context arrays, and returns its coefficient count (-1 on a
    runaway exp-Golomb code)."""
    return _build.bind("cabac_residual")
