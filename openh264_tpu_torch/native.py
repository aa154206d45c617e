"""Host C of the host encoder and the decoder, bound with ctypes: the
I-frame intra mode decision and encode (`enc_intra_frame_native`), the
token bit packer (`bitpack`), the decoder's CAVLC slice parser
(`parse_cavlc_slice_native`), its CABAC slice parser of I, P and B
slices (`parse_cabac_slice_native`), the CABAC residual-block bins of
its per-MB Python parser (`cabac_residual_lib`) and its intra
reconstruction (`recon_intra_mbs_native`).

Port of the functions of openh264_tpu/native/__init__.py that these
paths run, and the CABAC slice parser, which the JAX package does not
have (its CABAC syntax elements run per bin in Python); the C is
csrc/host_native.c, csrc/parse_cavlc.c, csrc/parse_cabac.c and
csrc/cabac_residual.c, built with the host compiler by _build.py at
first use. Unlike the JAX package, which falls back to numpy, to
I16-only intra, to its Python parser or to Python CABAC bins when its C
does not build, this module has no fallback: a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from . import _build
from .tables import (CHROMA_QP_TABLE, DEQUANT_4x4, QUANT_MF_4x4,
                     ZIGZAG_4x4, ZIGZAG_8x8)
from .utils import trace


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("host_native")
    lib.bitpack.restype = ctypes.c_size_t
    lib.bitpack.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.c_size_t, ctypes.c_void_p,
                            ctypes.c_size_t]
    lib.enc_intra_frame.restype = None
    lib.enc_intra_frame.argtypes = [ctypes.c_void_p] * 2
    lib.recon_intra_mbs.restype = None
    lib.recon_intra_mbs.argtypes = [ctypes.c_void_p] * 2
    return lib


@functools.lru_cache(maxsize=None)
def _parse_lib() -> ctypes.CDLL:
    lib = _build.load("parse_cavlc")
    lib.parse_cavlc_slice.restype = ctypes.c_int
    lib.parse_cavlc_slice.argtypes = [ctypes.c_void_p] * 3
    return lib


@functools.lru_cache(maxsize=None)
def _cabac_parse_lib() -> ctypes.CDLL:
    lib = _build.load("parse_cabac")
    lib.parse_cabac_slice.restype = ctypes.c_longlong
    lib.parse_cabac_slice.argtypes = [ctypes.c_void_p] * 3
    return lib


@functools.lru_cache(maxsize=None)
def cabac_residual_lib() -> ctypes.CDLL:
    """csrc/cabac_residual.c: `cabac_residual(data, nbits, st, cstate,
    cmps, range_lps, state_trans, params, sig_out)` decodes one residual
    block's bins over the Python engine's state (st: pos, range, offset)
    and context arrays, and returns its coefficient count (-1 on a
    runaway exp-Golomb code)."""
    lib = _build.load("cabac_residual")
    lib.cabac_residual.restype = ctypes.c_int
    lib.cabac_residual.argtypes = [ctypes.c_void_p, ctypes.c_longlong] + \
        [ctypes.c_void_p] * 7
    return lib


def bitpack(vals: np.ndarray, lens: np.ndarray, out: np.ndarray,
            start_bit: int) -> int:
    """Append MSB-first tokens into `out` (zeroed uint8 from start_bit
    on); returns the new bit position."""
    v = np.ascontiguousarray(vals.reshape(-1), np.uint32)
    ln = np.ascontiguousarray(lens.reshape(-1), np.uint8)
    if out.dtype != np.uint8 or out.ndim != 1 or \
            not out.flags["C_CONTIGUOUS"]:
        raise ValueError("bitpack: out must be a contiguous uint8 vector")
    # a token may be longer than its 32-bit value (leading zeros), but
    # the C accumulator holds at most 7 pending bits plus 56
    if len(v) != len(ln) or (ln > 56).any():
        raise ValueError("bitpack: one length of at most 56 per value")
    if start_bit + int(ln.sum(dtype=np.int64)) > 8 * out.size:
        raise ValueError("bitpack: the tokens overrun `out`")
    return _lib().bitpack(v.ctypes.data, ln.ctypes.data, len(v),
                          out.ctypes.data, start_bit)


def enc_intra_frame_native(y, u, v, qp: int, qp_c: int, lam: int,
                           enable_i4: bool = True) -> dict:
    """I-frame MD + encode in C (I16x16 vs I4x4 per MB). y/u/v: host
    uint8 planes, MB aligned. Returns the encoder's symbol dict, numpy,
    with the recon planes."""
    y = np.ascontiguousarray(y, np.uint8)
    u = np.ascontiguousarray(u, np.uint8)
    v = np.ascontiguousarray(v, np.uint8)
    mb_h, mb_w = y.shape[0] // 16, y.shape[1] // 16
    if y.shape != (16 * mb_h, 16 * mb_w) or mb_h == 0 or mb_w == 0 or \
            u.shape != (8 * mb_h, 8 * mb_w) or v.shape != u.shape:
        raise ValueError("enc_intra_frame_native: y must be MB aligned and "
                         "u, v half its size")
    if not (0 <= qp <= 51 and 0 <= qp_c <= 51):
        raise ValueError("enc_intra_frame_native: QP out of 0..51")
    n = mb_w * mb_h
    qmf = np.ascontiguousarray(np.asarray(QUANT_MF_4x4).reshape(52, 16),
                               np.int32)
    dqt = np.ascontiguousarray(np.asarray(DEQUANT_4x4).reshape(52, 16),
                               np.int32)
    kind = np.zeros(n, np.int32)
    i16m = np.zeros(n, np.int32)
    i4m = np.zeros((n, 16), np.int32)
    i4prev = np.zeros((n, 16), np.int32)
    i4rem = np.zeros((n, 16), np.int32)
    cmode = np.zeros(n, np.int32)
    ldc = np.zeros((n, 16), np.int32)
    lac = np.zeros((n, 16, 16), np.int32)
    cdc = np.zeros((n, 2, 4), np.int32)
    cac = np.zeros((n, 2, 4, 16), np.int32)
    ry, ru, rv = y.copy(), u.copy(), v.copy()
    arrs = [y, u, v, qmf, dqt, kind, i16m, i4m, i4prev, i4rem, cmode,
            ldc, lac, cdc, cac, ry, ru, rv]
    ptrs = np.array([a.ctypes.data for a in arrs], np.uint64)
    params = np.array([mb_w, mb_h, qp, qp_c, lam, int(enable_i4)],
                      np.int32)
    _lib().enc_intra_frame(ptrs.ctypes.data, params.ctypes.data)
    return {"kind": kind, "i16_mode": i16m, "i4_modes": i4m,
            "i4_prev": i4prev, "i4_rem": i4rem, "chroma_mode": cmode,
            "luma_dc": ldc.reshape(n, 4, 4), "luma_ac": lac,
            "chroma_dc": cdc, "chroma_ac": cac,
            "recon_y": ry, "recon_u": ru, "recon_v": rv}


# ---------------------------------------------------------------------------
# The decoder: CAVLC slice parser and intra recon
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _cavlc_tables() -> dict:
    """The parser's VLC LUTs and tables as contiguous arrays."""
    from .tables.cavlc import (CBP_I16x16, CBP_INTER, CBP_INTRA,
                               COEFF_TOKEN_LUTS, RUN_BEFORE_LUTS,
                               TOTAL_ZEROS_CDC_LUTS, TOTAL_ZEROS_LUTS)

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
    """Parses one I or P CAVLC slice's data (no 8x8 transform, no FMO:
    the caller routes those elsewhere or refuses them) from br's bit
    position into ctx.fs, and returns the index one past its last MB.
    Raises EOFError on a bitstream overrun and ValueError on an invalid
    code, with br.pos and the MBs parsed so far left as the C left them
    (the decoder conceals the rest). A slice outside that scope is a
    caller's fault, NotImplementedError, which the decoder never
    conceals."""
    from .decoder.mvpred import ensure_motion_grids
    from .decoder.slicehdr import I_SLICE, P_SLICE
    sh, fs = ctx.sh, ctx.fs
    if sh.slice_type not in (I_SLICE, P_SLICE) or \
            sh.pps.transform_8x8_mode or sh.pps.num_slice_groups > 1:
        raise NotImplementedError("parse_cavlc_slice_native: I/P slices "
                                  "without the 8x8 transform or FMO only")
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
    _parse_lib().parse_cavlc_slice(ptrs.ctypes.data, params.ctypes.data,
                                   out.ctypes.data)
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
    from .decoder.cabac import CTX_INIT_MN, RANGE_LPS, STATE_TRANS
    from .tables.cavlc import CBP_I16x16
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
    """Parses one CABAC I, P or B slice's data (with or without the 8x8
    transform; no FMO: decoder/slice_dec_cabac.py routes FMO slices to
    its Python parser) from bit `bitpos` of its RBSP (the end of its
    header) into ctx.fs, as slice_dec_cabac.decode_slice_mbs_cabac does,
    array for array, B direct prediction included (ctx.direct's
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
    open span while the recorder is on."""
    from .decoder.slice_dec_cabac import ensure_cabac_state
    from .decoder.slicehdr import B_SLICE, I_SLICE, P_SLICE
    sh, fs = ctx.sh, ctx.fs
    if sh.slice_type not in (I_SLICE, P_SLICE, B_SLICE) or \
            sh.pps.num_slice_groups > 1:
        raise NotImplementedError("parse_cabac_slice_native: I, P and B "
                                  "slices without FMO only")
    ensure_cabac_state(fs)
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
    _cabac_parse_lib().parse_cabac_slice(ptrs.ctypes.data, params.ctypes.data,
                                         out.ctypes.data)
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
    _lib().recon_intra_mbs(ptrs.ctypes.data, params.ctypes.data)
