"""H.264 host encoder: the device core plus host entropy assembly.

Port of openh264_tpu/encoder/encoder.py (H264Encoder, _RefEntry,
_NcTracker, encode_yuv_file), byte-identical with it. Per frame the core
(core_torch: motion search, quarter-pel refine, skip, transforms, the
I16 wavefront, intra-in-P), VAA, scroll and scene-change detection run
as torch on the encoder's device, and the reference planes of the DPB
stay there. In-loop deblocking runs through the port's deblock kernel
(deblock_host). Only the symbol arrays that the host writers read are
fetched: the host writes the headers and the slice bodies from them,
per MB or vectorised (cavlc_vec), as the JAX encoder does. I frames
with enable_i4x4 run the I16x16-vs-I4x4 decision in host C (cbind.py).
With entropy_cabac the slice bodies are written per bin by the CABAC
slice writer (cabac_enc.py), on the one-slice and fixed-slice paths;
the profile rises to Main (77) and I frames take the I16 wavefront.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..bitstream import (BitWriter, make_annexb_nal, NAL_SPS, NAL_PPS,
                         NAL_IDR, NAL_SLICE)
from ..decoder.cabac import CHROMA_AC, CHROMA_DC, I16_AC, I16_DC, LUMA_4x4
from ..decoder.framedata import (FrameSymbols, MB_I4x4, MB_I16x16,
                                 MB_P16x16)
from ..decoder.mvpred import MvContext
from ..device import resolve_device
from ..tables import CHROMA_QP_TABLE, ZIGZAG_4x4, ZSCAN_TO_RASTER
from ..tables.cavlc import CBP_INTER_INV, CBP_INTRA_INV
from ..utils import trace
from . import core_torch
from .cabac_enc import CabacSliceWriter
from .cbind import enc_intra_frame_native
from .cavlc_enc import write_residual_block
from .cavlc_vec import assemble_rbsp, p_skip_mask, write_p_slice_tokens
from .config import EncoderConfig
from .core_np import pad_to_mb
from .deblock_host import deblock_frame
from .headers import write_pps, write_slice_header, write_sps
from .ratectl import RC_OFF_MODE, RateControl

__all__ = ["EncoderConfig", "H264Encoder", "encode_yuv_file"]

# the symbol arrays that the host writers and FrameSymbols read
_I_KEYS = ("i16_mode", "chroma_mode", "luma_dc", "luma_ac", "chroma_dc",
           "chroma_ac")
_P_KEYS = ("mv", "luma_ac", "chroma_dc", "chroma_ac")


def _fetch(out: dict, keys) -> dict:
    """The device tensors out[k] for k in keys as numpy arrays, in one
    device-to-host copy (the host's wait for the core: span
    encoder.fetch); bool tensors come back as bool."""
    ts = [out[k] for k in keys]
    with trace.span("encoder.fetch"):
        flat = torch.cat([t.reshape(-1).to(torch.int32) for t in ts]).cpu()
    flat = flat.numpy()
    res, pos = {}, 0
    for k, t in zip(keys, ts):
        n = t.numel()
        a = flat[pos:pos + n].reshape(tuple(t.shape))
        res[k] = a.astype(bool) if t.dtype == torch.bool else a
        pos += n
    return res


@dataclass
class _RefEntry:
    """Encoder-side DPB record (mirrors SPicture essentials)."""
    frame_num: int
    coding_idx: int
    temporal_id: int
    planes: tuple  # (y, u, v) deblocked recon on the device, MB aligned
    # early-skip state (pMbSkipSad analog, WelsMdPSkipEnc): per-MB skip
    # flags + skip-prediction SAD of this picture, device tensors
    skip_map: object = None
    skip_sad: object = None
    # long-term reference state (WelsMarkPic, ref_list_mgr_svc.h:75)
    is_ltr: bool = False
    ltr_idx: int = -1


class _NcTracker:
    """nzc bookkeeping for CAVLC nC contexts (single slice)."""

    def __init__(self, mb_w, mb_h):
        self.mb_w, self.mb_h = mb_w, mb_h
        self.nzc_l = np.full((mb_h * 4, mb_w * 4), -1, np.int32)
        self.nzc_c = np.full((2, mb_h * 2, mb_w * 2), -1, np.int32)

    def nc_luma(self, gx, gy):
        na = self.nzc_l[gy, gx - 1] if gx > 0 else -1
        nb = self.nzc_l[gy - 1, gx] if gy > 0 else -1
        return self._comb(na, nb)

    def nc_chroma(self, comp, cx, cy):
        na = self.nzc_c[comp, cy, cx - 1] if cx > 0 else -1
        nb = self.nzc_c[comp, cy - 1, cx] if cy > 0 else -1
        return self._comb(na, nb)

    @staticmethod
    def _comb(na, nb):
        if na >= 0 and nb >= 0:
            return (na + nb + 1) >> 1
        if na >= 0:
            return int(na)
        if nb >= 0:
            return int(nb)
        return 0


def _cbp_luma_p(luma_ac) -> int:
    """cbp bits of the 8x8 quadrants with a coded 4x4 block (raster)."""
    cbp_luma = 0
    for b8 in range(4):
        blocks = [(b8 // 2) * 8 + (b8 % 2) * 2 + (i // 2) * 4 + (i % 2)
                  for i in range(4)]
        if luma_ac[blocks].any():
            cbp_luma |= 1 << b8
    return cbp_luma


class H264Encoder:
    """CAVLC or CABAC H.264 encoder on `device` (default "cuda"; without
    a GPU the default raises, and device="cpu" runs the plain PyTorch
    path)."""

    def __init__(self, cfg: EncoderConfig, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        if cfg.entropy_cabac and cfg.profile_idc == 66:
            # CABAC is prohibited in Baseline (Annex A.2.1): Main, like the
            # reference (encoder_ext.cpp:655-662)
            cfg.profile_idc = 77
        if cfg.slice_size_constraint > 0 and cfg.entropy_cabac:
            raise ValueError("SM_SIZELIMITED slicing is CAVLC-only here")
        if cfg.slice_size_constraint > 0 and cfg.num_slices > 1:
            raise ValueError("slice_size_constraint and num_slices are "
                             "mutually exclusive slice modes")
        if cfg.temporal_layers > 1:
            # DPB depth so each dyadic layer's anchor survives until the
            # next lower-layer frame arrives
            cfg.num_ref_frames = max(cfg.num_ref_frames,
                                     1 << max(0, cfg.temporal_layers - 2))
        self.frame_num = 0           # next frame_num to write
        self.idr_pic_id = 0
        self.dpb: list[_RefEntry] = []
        self.frame_count = 0         # input frames seen
        self.coding_idx = 0          # coded frames since last IDR (GOP pos)
        self.qp = cfg.qp
        self.qp_c = int(CHROMA_QP_TABLE[np.clip(
            self.qp + cfg.chroma_qp_offset, 0, 51)])
        self._force_idr = False
        # padded input luma of the previous frame (scene change) and of
        # the one before the current frame (scroll), on the device
        self._prev_input = None
        self._scroll_prev = None
        # LTR state (ref_list_mgr_svc.cpp marking/recovery protocol)
        self._ltr_capacity_added = 0
        self._ltr_next_idx = 0
        self._ltr_acked: set[int] = set()   # acked (idx) via feedback
        self._ltr_pending: dict[int, int] = {}  # ltr_idx -> frame_num
        self._need_ltr_recovery = False
        self.setup_ltr()
        self.reconfigure_rc()

    # ------------------------------------------------------------------
    # Long-term reference protocol (codec_app_def.h:239-263,
    # ref_list_mgr_svc.cpp WelsMarkPic / recovery strategies)
    def setup_ltr(self):
        """Reserve DPB capacity for the LTR slots (the SPS
        max_num_ref_frames covers short-term + long-term)."""
        cfg = self.cfg
        if cfg.enable_ltr:
            want = max(1, cfg.ltr_ref_num)
            cfg.num_ref_frames += want - self._ltr_capacity_added
            self._ltr_capacity_added = want
            if self.frame_count > 0:
                # mid-stream enable changes the SPS DPB size: start a
                # fresh coded video sequence so the decoder re-sizes
                self._force_idr = True

    @property
    def _st_capacity(self) -> int:
        """Sliding-window budget for short-term refs."""
        return max(1, self.cfg.num_ref_frames - self._ltr_capacity_added)

    def ltr_recovery_request(self, req=None) -> None:
        """SLTRRecoverRequest: the next P frame re-anchors on an LTR
        (acked if any feedback arrived, else the newest marked LTR); with
        no LTR the next frame is forced IDR."""
        if not self.cfg.enable_ltr or not any(e.is_ltr for e in self.dpb):
            self._force_idr = True
            return
        self._need_ltr_recovery = True

    def ltr_marking_feedback(self, fb) -> None:
        """SLTRMarkingFeedback: the receiver confirms (or denies) that a
        marked frame arrived. fb may be the struct (uiFeedbackType,
        iLTRFrameNum), a dict with those keys, or a plain frame_num."""
        ok = True
        frame_num = fb
        if hasattr(fb, "uiFeedbackType"):
            ok = int(fb.uiFeedbackType) != 2   # 2 = LTR_MARKING_FAILED
            frame_num = int(fb.iLTRFrameNum)
        elif isinstance(fb, dict):
            ok = int(fb.get("uiFeedbackType", 1)) != 2
            frame_num = int(fb.get("iLTRFrameNum", -1))
        for idx, fn in list(self._ltr_pending.items()):
            if fn == int(frame_num):
                del self._ltr_pending[idx]
                if ok:
                    self._ltr_acked.add(idx)
                else:
                    self._ltr_acked.discard(idx)

    def _ltr_mark_ops(self, tid: int, is_ref: bool):
        """MMCO ops marking the current frame as the next LTR slot (op 4
        caps max_long_term_frame_idx, op 6 marks current)."""
        cfg = self.cfg
        if not (cfg.enable_ltr and is_ref and tid == 0
                and cfg.ltr_mark_period > 0
                and self.coding_idx > 0
                and self.coding_idx % cfg.ltr_mark_period == 0):
            return None, -1
        idx = self._ltr_next_idx
        self._ltr_next_idx = (idx + 1) % max(1, cfg.ltr_ref_num)
        return [(4, max(1, cfg.ltr_ref_num)), (6, idx)], idx

    def _pick_ltr_recovery_ref(self) -> _RefEntry:
        ltrs = [e for e in self.dpb if e.is_ltr]
        acked = [e for e in ltrs if e.ltr_idx in self._ltr_acked]
        pool = acked or ltrs
        return max(pool, key=lambda e: e.coding_idx)

    def reconfigure_rc(self):
        cfg = self.cfg
        self.rc = RateControl(cfg.rc_mode, cfg.target_bitrate,
                              cfg.max_frame_rate, self.qp,
                              cfg.min_qp, cfg.max_qp, cfg.enable_frame_skip,
                              n_pixels=cfg.width * cfg.height,
                              honor_init_qp=cfg.rc_honor_init_qp,
                              max_bitrate=cfg.max_bitrate)

    def force_idr(self):
        self._force_idr = True

    # ------------------------------------------------------------------
    def headers_annexb(self) -> bytes:
        return (make_annexb_nal(3, NAL_SPS, write_sps(self.cfg)) +
                make_annexb_nal(3, NAL_PPS, write_pps(self.cfg)))

    def _temporal_id(self) -> int:
        t = self.cfg.temporal_layers
        if t <= 1:
            return 0
        gop = 1 << (t - 1)
        i = self.coding_idx % gop
        if i == 0:
            return 0
        return t - 1 - (i & -i).bit_length() + 1

    def _pick_ref(self, tid: int) -> _RefEntry:
        """Dyadic reference: newest DPB entry of a strictly lower layer
        (layer 0 chains to the previous layer-0 frame)."""
        cands = [e for e in self.dpb if e.temporal_id < max(1, tid)]
        return max(cands, key=lambda e: e.coding_idx)

    def _upload(self, plane: np.ndarray) -> torch.Tensor:
        """A device copy of a host plane (never a view of the caller's
        array, which may be reused or read-only)."""
        return torch.tensor(np.ascontiguousarray(plane), device=self.device)

    def encode_frame(self, y: np.ndarray, u: np.ndarray,
                     v: np.ndarray) -> bytes:
        """Encode one frame (host uint8 planes); returns Annex-B bytes
        (headers on IDR, b"" when rate control skips the frame). The
        frame's span, encoder.frame (utils/trace.py), carries the input
        index as its frame id, attrs idr and skipped, and counters of
        the bits written and, on the one-slice path, of its MBs by
        type."""
        with trace.span("encoder.frame", frame=self.frame_count) as sp:
            bs = self._encode_frame(y, u, v, sp)
            sp.count("bits", 8 * len(bs))
        return bs

    def _encode_frame(self, y, u, v, sp) -> bytes:
        cfg = self.cfg
        yp = pad_to_mb(y)
        yd = self._upload(yp)
        is_idr = self.frame_count == 0 or self._force_idr or (
            cfg.idr_interval > 0 and self.frame_count % cfg.idr_interval == 0)
        if (not is_idr and cfg.enable_scene_change_detect
                and self._prev_input is not None):
            from ..processing.scenechange import detect_scene_change
            # the reference tests the truth of detect_scene_change's
            # (idc, result) tuple, which always holds: every non-first
            # frame becomes an IDR (ROADMAP.md, queue C)
            if bool(detect_scene_change(yd, self._prev_input)):
                is_idr = True
        self._scroll_prev = self._prev_input
        self._prev_input = yd
        self.frame_count += 1
        sp.set(idr=is_idr, skipped=False)
        if not is_idr and self.rc.should_skip():
            self.rc.skipped()
            sp.set(skipped=True)
            return b""
        self._force_idr = False

        up = pad_to_mb(u, 8)
        vp = pad_to_mb(v, 8)
        planes = (yp, up, vp), (yd, self._upload(up), self._upload(vp))
        tid = 0 if is_idr else self._temporal_id()
        self.qp = self.rc.frame_qp(is_idr, tid)
        self.qp_c = int(CHROMA_QP_TABLE[np.clip(
            self.qp + cfg.chroma_qp_offset, 0, 51)])
        is_ref = is_idr or cfg.temporal_layers <= 1 or \
            tid < cfg.temporal_layers - 1

        if cfg.slice_size_constraint > 0:
            return self._encode_frame_sizelimited(planes[1], is_idr, tid,
                                                  is_ref)
        if cfg.num_slices > 1:
            return self._encode_frame_multislice(planes[1], is_idr, tid,
                                                 is_ref)
        is_ltr, ltr_idx = False, -1
        if is_idr:
            self.frame_num = 0
            self.coding_idx = 0
            self.dpb.clear()
            self._ltr_pending.clear()
            self._ltr_acked.clear()
            self._need_ltr_recovery = False
            out, rbsp = self._encode_i(*planes)
            nal = make_annexb_nal(3, NAL_IDR, rbsp)
            prefix = self.headers_annexb()
            self.idr_pic_id = (self.idr_pic_id + 1) % 16
            fs = self._frame_symbols_i(out)
            if cfg.enable_ltr:
                # long_term_reference_flag marks the IDR as LTR idx 0
                is_ltr, ltr_idx = True, 0
                self._ltr_next_idx = 1 % max(1, cfg.ltr_ref_num)
        else:
            mmco_ops, ltr_idx = self._ltr_mark_ops(tid, is_ref)
            is_ltr = mmco_ops is not None
            if self._need_ltr_recovery:
                ref = self._pick_ltr_recovery_ref()
                self._need_ltr_recovery = False
            else:
                ref = self._pick_ref(tid)
            out, rbsp = self._encode_p(planes[1], ref, is_ref,
                                       mmco_ops=mmco_ops)
            nal = make_annexb_nal(2 if is_ref else 0, NAL_SLICE, rbsp)
            prefix = b""
            fs = self._frame_symbols_p(out)
        if trace.enabled():
            self._count_mbs(out, is_idr)

        recon = self._deblock(out, fs)
        if is_ref:
            if is_ltr:
                # marking replaces any existing LTR with the same index
                # (MMCO 6 semantics)
                self.dpb = [e for e in self.dpb
                            if not (e.is_ltr and e.ltr_idx == ltr_idx)]
                self._ltr_pending[ltr_idx] = self.frame_num
            self.dpb.append(_RefEntry(
                self.frame_num, self.coding_idx, tid, recon,
                skip_map=out.get("skip_mask"),
                skip_sad=out.get("skip_sad"),
                is_ltr=is_ltr, ltr_idx=ltr_idx))
            self._slide_window()
            self.frame_num = (self.frame_num + 1) % \
                (1 << cfg.log2_max_frame_num)
        self.coding_idx += 1
        bs = prefix + nal
        self.rc.update(8 * len(bs), self.qp, is_idr)
        return bs

    def _count_mbs(self, out, is_idr: bool) -> None:
        """Counts the frame's MBs by type on the open span (a one-slice
        frame): i4 and i16 in an IDR; skip, inter and intra_p (I16x16
        intra-in-P) in a P frame."""
        n = self.cfg.mb_width * self.cfg.mb_height
        if is_idr:
            kind = out.get("kind")
            i4 = 0 if kind is None else int(np.count_nonzero(
                np.asarray(kind) == 0))
            trace.count("i4", i4)
            trace.count("i16", n - i4)
            return
        intra = int(np.count_nonzero(out["intra_mask"]))
        skip = int(np.count_nonzero(p_skip_mask(
            out, self.cfg.mb_width, self.cfg.mb_height)))
        trace.count("skip", skip)
        trace.count("intra_p", intra)
        trace.count("inter", n - skip - intra)

    def _deblock(self, out, fs) -> tuple:
        """The frame's recon planes (device), deblocked unless the
        config turns the filter off."""
        recon = (out["recon_y"], out["recon_u"], out["recon_v"])
        if self.cfg.deblock_idc != 1:
            with trace.span("encoder.deblock"):
                recon = deblock_frame(*recon, fs)
        return recon

    # ------------------------------------------------------------------
    def _band_rows(self):
        """MB-row ranges of the frame's slices (SM_FIXEDSLCNUM split: as
        even as possible, like AssignMbMapMultipleSlices,
        svc_enc_slice_segment.cpp:70 for row-aligned maps)."""
        cfg = self.cfg
        n = min(cfg.num_slices, cfg.mb_height)
        base = cfg.mb_height // n
        extra = cfg.mb_height % n
        rows = []
        r0 = 0
        for sidx in range(n):
            r1 = r0 + base + (1 if sidx < extra else 0)
            rows.append((r0, r1))
            r0 = r1
        return rows

    def _encode_frame_multislice(self, planes, is_idr, tid, is_ref):
        """N slices per frame: each horizontal MB-row band is an
        independent slice (own NAL, own entropy state); inter prediction
        still reaches the whole reference frame (the core's row_off band
        mode). Mirrors SM_FIXEDSLCNUM_SLICE output
        (slice_multi_threading.cpp AppendSliceToFrameBs:429)."""
        cfg = self.cfg
        yp, up, vp = planes
        bands = self._band_rows()
        nals = []
        outs = []
        if is_idr:
            self.frame_num = 0
            self.coding_idx = 0
            self.dpb.clear()
            prefix = self.headers_annexb()
            self.idr_pic_id = (self.idr_pic_id + 1) % 16
        else:
            prefix = b""
            ref = self._pick_ref(tid)
            reorder, _reorder_lt = self._reorder_for(ref)
            ry, ru, rv = ref.planes
        for (r0, r1) in bands:
            bh = r1 - r0
            yb = yp[r0 * 16:r1 * 16]
            ub = up[r0 * 8:r1 * 8]
            vb = vp[r0 * 8:r1 * 8]
            if is_idr:
                with trace.span("encoder.dispatch", core="i"):
                    d = core_torch.encode_i_frame(yb, ub, vb, self.qp,
                                                  self.qp_c,
                                                  mb_w=cfg.mb_width, mb_h=bh)
                out = _fetch(d, _I_KEYS)
                rbsp = self._write_i_slice(out, mb_h=bh,
                                           first_mb=r0 * cfg.mb_width)
                nals.append(make_annexb_nal(3, NAL_IDR, rbsp))
            else:
                with trace.span("encoder.dispatch", core="p"):
                    d = core_torch.encode_p_frame(
                        yb, ub, vb, ry, ru, rv, self.qp, self.qp_c,
                        mb_w=cfg.mb_width, mb_h=bh, sr=cfg.search_range,
                        row_off=r0 * 16)
                out = _fetch(d, _P_KEYS)
                out["intra_mask"] = np.zeros(cfg.mb_width * bh, bool)
                rbsp = self._write_p_slice(out, is_ref, reorder, mb_h=bh,
                                           first_mb=r0 * cfg.mb_width)
                nals.append(make_annexb_nal(2 if is_ref else 0, NAL_SLICE,
                                            rbsp))
            for k in ("recon_y", "recon_u", "recon_v"):
                out[k] = d[k]
            outs.append(out)
        # merge the bands' symbols for deblock and recon
        out_m = {k: (torch.cat if k.startswith("recon") else np.concatenate)(
            [o[k] for o in outs]) for k in outs[0]}
        fs = (self._frame_symbols_i(out_m) if is_idr
              else self._frame_symbols_p(out_m))
        for sidx, (r0, r1) in enumerate(bands):
            fs.slice_id[r0 * cfg.mb_width:r1 * cfg.mb_width] = sidx
        recon = self._deblock(out_m, fs)
        if is_ref:
            # multi-slice frames are never MMCO-marked, but an IDR with
            # LTR enabled is implicitly LTR idx 0 (long_term_ref_flag)
            self.dpb.append(_RefEntry(self.frame_num, self.coding_idx, tid,
                                      recon,
                                      is_ltr=is_idr and cfg.enable_ltr,
                                      ltr_idx=0 if cfg.enable_ltr else -1))
            self._slide_window()
            self.frame_num = (self.frame_num + 1) % \
                (1 << cfg.log2_max_frame_num)
        self.coding_idx += 1
        bs = prefix + b"".join(nals)
        self.rc.update(8 * len(bs), self.qp, is_idr)
        return bs

    # ------------------------------------------------------------------
    def _encode_frame_sizelimited(self, planes, is_idr, tid, is_ref):
        """SM_SIZELIMITED dynamic slicing (WelsCodeOnePicPartition,
        encoder_ext.cpp:4534): a slice closes as soon as its written
        payload reaches cfg.slice_size_constraint bytes. As in the JAX
        encoder, the boundary check runs after a macroblock is written
        (bounded one-MB overshoot), intra-in-P is off, and IDR slices are
        found by a probe pass and then coded as bands of MB rows."""
        cfg = self.cfg
        yp, up, vp = planes
        mb_w, mb_h = cfg.mb_width, cfg.mb_height
        n_mb = mb_w * mb_h
        limit_bits = cfg.slice_size_constraint * 8
        reorder = reorder_lt = None
        idr_bands = None
        if is_idr:
            self.frame_num = 0
            self.coding_idx = 0
            self.dpb.clear()
            # probe pass over a frame-wide core: row-aligned boundaries
            # by size; then each slice re-encodes as its own band
            probe = _fetch(core_torch.encode_i_frame(
                yp, up, vp, self.qp, self.qp_c, mb_w=mb_w, mb_h=mb_h),
                _I_KEYS)
            idr_bands = []
            r0 = 0
            w = BitWriter()
            nc = _NcTracker(mb_w, mb_h)
            for r in range(mb_h):
                for i in range(mb_w):
                    self._write_i16_mb(w, probe, r * mb_w + i, nc,
                                       p_slice=False)
                if w.bit_length() >= limit_bits and r + 1 < mb_h:
                    idr_bands.append((r0, r + 1))
                    r0 = r + 1
                    w = BitWriter()
                    nc = _NcTracker(mb_w, mb_h)
            idr_bands.append((r0, mb_h))
            outs = [core_torch.encode_i_frame(
                yp[r0 * 16:r1 * 16], up[r0 * 8:r1 * 8], vp[r0 * 8:r1 * 8],
                self.qp, self.qp_c, mb_w=mb_w, mb_h=r1 - r0)
                for (r0, r1) in idr_bands]
            d = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
            out = _fetch(d, _I_KEYS)
            prefix = self.headers_annexb()
        else:
            ref = self._pick_ref(tid)
            reorder, reorder_lt = self._reorder_for(ref)
            ry, ru, rv = ref.planes
            d = core_torch.encode_p_frame(
                yp, up, vp, ry, ru, rv, self.qp, self.qp_c,
                mb_w=mb_w, mb_h=mb_h, sr=cfg.search_range)
            out = _fetch(d, _P_KEYS)
            out["intra_mask"] = np.zeros(n_mb, bool)
            prefix = b""
        for k in ("recon_y", "recon_u", "recon_v"):
            out[k] = d[k]

        idr_cuts = (set(r1 * mb_w for _r0, r1 in idr_bands[:-1])
                    if idr_bands else set())
        wfs = FrameSymbols(mb_w, mb_h)
        wfs.slice_id[:] = -1
        nals = []
        mb = 0
        sidx = 0
        while mb < n_mb:
            w = BitWriter()
            write_slice_header(
                w, cfg, 2 if is_idr else 0, self.frame_num, mb, self.qp,
                is_idr, self.idr_pic_id, disable_deblock=cfg.deblock_idc,
                is_ref=is_ref, reorder_abs_diff=reorder,
                reorder_long_term=reorder_lt)
            nc = _NcTracker(mb_w, mb_h)   # fresh: prior slices unavailable
            mvc = MvContext(wfs, sidx)
            skip_run = 0
            while mb < n_mb:
                wfs.slice_id[mb] = sidx
                mbx, mby = mb % mb_w, mb // mb_w
                gx, gy = mbx * 4, mby * 4
                if is_idr:
                    self._write_i16_mb(w, out, mb, nc, p_slice=False)
                else:
                    wfs.gwritten[gy:gy + 4, gx:gx + 4] = False
                    mv = out["mv"][mb].astype(np.int32)
                    luma_ac = out["luma_ac"][mb]
                    cbp_luma = _cbp_luma_p(luma_ac)
                    cac = out["chroma_ac"][mb]
                    cdc = out["chroma_dc"][mb]
                    cbp_chroma = 2 if cac.any() else (1 if cdc.any() else 0)
                    cbp = cbp_luma | (cbp_chroma << 4)
                    skip_mv = mvc.pred_skip_mv(gx, gy, mb)
                    if cbp == 0 and mv[0] == skip_mv[0] and \
                            mv[1] == skip_mv[1]:
                        skip_run += 1
                        mvc.set_partition(gx, gy, 4, 4, 0, 0, mv)
                        nc.nzc_l[gy:gy + 4, gx:gx + 4] = 0
                        nc.nzc_c[:, mby * 2:mby * 2 + 2,
                                 mbx * 2:mbx * 2 + 2] = 0
                        mb += 1
                        continue
                    w.ue(skip_run)
                    skip_run = 0
                    w.ue(0)                     # P_L0_16x16
                    mvp = mvc.pred_mv(gx, gy, 4, 4, 0, 0, mb)
                    w.se(int(mv[0] - mvp[0]))
                    w.se(int(mv[1] - mvp[1]))
                    mvc.set_partition(gx, gy, 4, 4, 0, 0, mv)
                    w.ue(int(CBP_INTER_INV[cbp]))
                    if cbp:
                        w.se(0)                 # mb_qp_delta
                    for k in range(16):
                        r = int(ZSCAN_TO_RASTER[k])
                        bx, by = r % 4, r // 4
                        b8 = (by >> 1) * 2 + (bx >> 1)
                        if cbp_luma & (1 << b8):
                            tc = write_residual_block(
                                w, luma_ac[r][ZIGZAG_4x4],
                                nc.nc_luma(gx + bx, gy + by), 16)
                        else:
                            tc = 0
                        nc.nzc_l[gy + by, gx + bx] = tc
                    self._write_chroma_residual(w, out, mb, nc, cbp_chroma)
                mb += 1
                if is_idr:
                    if mb in idr_cuts:
                        break
                elif w.bit_length() >= limit_bits and mb < n_mb:
                    break
            if not is_idr and skip_run:
                w.ue(skip_run)
            w.rbsp_trailing_bits()
            nals.append(make_annexb_nal(
                3 if is_idr else (2 if is_ref else 0),
                NAL_IDR if is_idr else NAL_SLICE, w.get_bytes()))
            sidx += 1
        if is_idr:
            self.idr_pic_id = (self.idr_pic_id + 1) % 16

        fs = (self._frame_symbols_i(out) if is_idr
              else self._frame_symbols_p(out))
        fs.slice_id[:] = wfs.slice_id
        recon = self._deblock(out, fs)
        if is_ref:
            self.dpb.append(_RefEntry(self.frame_num, self.coding_idx, tid,
                                      recon))
            self._slide_window()
            self.frame_num = (self.frame_num + 1) % \
                (1 << cfg.log2_max_frame_num)
        self.coding_idx += 1
        bs = prefix + b"".join(nals)
        self.rc.update(8 * len(bs), self.qp, is_idr)
        return bs

    def _frame_symbols_i(self, out) -> FrameSymbols:
        cfg = self.cfg
        fs = FrameSymbols(cfg.mb_width, cfg.mb_height)
        fs.mb_type[:] = MB_I16x16
        kind = out.get("kind")
        if kind is not None:
            fs.mb_type[np.asarray(kind) == 0] = MB_I4x4
        fs.slice_id[:] = 0
        fs.qp[:] = self.qp
        fs.disable_deblock[:] = 0 if cfg.deblock_idc != 1 else 1
        return fs

    def _frame_symbols_p(self, out) -> FrameSymbols:
        cfg = self.cfg
        fs = FrameSymbols(cfg.mb_width, cfg.mb_height)
        n = fs.n_mb
        nz = out["luma_ac"].reshape(n, 16, 16) != 0
        # P16x16 vs PSKIP is irrelevant for bS (both inter, same mv/nzc)
        fs.mb_type[:] = MB_P16x16
        fs.slice_id[:] = 0
        mb_qp = out.get("mb_qp")
        if mb_qp is None:
            fs.qp[:] = self.qp
        else:
            # decoder-visible qp: mb_qp_delta is only signaled on MBs
            # with coded residual; others keep the running value
            nzmb = (out["luma_ac"].reshape(n, -1) != 0).any(1) | \
                   (out["chroma_dc"].reshape(n, -1) != 0).any(1) | \
                   (out["chroma_ac"].reshape(n, -1) != 0).any(1)
            lastr = np.maximum.accumulate(
                np.where(nzmb, np.arange(n), -1))
            fs.qp[:] = np.where(lastr >= 0,
                                mb_qp[np.clip(lastr, 0, None)], self.qp)
        fs.disable_deblock[:] = 0 if cfg.deblock_idc != 1 else 1
        fs.mv[:, 0, :, :] = out["mv"][:, None, :].astype(np.int32)
        fs.refidx[:, 0, :] = 0
        fs.ref_pic[:, 0, :] = 0
        im = out.get("intra_mask")
        if im is not None and im.any():
            fs.mb_type[im] = MB_I16x16
            fs.mv[im] = 0
            fs.refidx[im] = -1
            fs.ref_pic[im] = -1
        # per-4x4 coeff counts in raster grid layout
        cnt = nz.sum(-1).reshape(cfg.mb_height, cfg.mb_width, 4, 4)
        fs.nzc_l[:] = cnt.transpose(0, 2, 1, 3).reshape(cfg.mb_height * 4,
                                                        cfg.mb_width * 4)
        return fs

    # ------------------------------------------------------------------
    def _encode_i(self, host, dev):
        """One single-slice IDR: I16x16-vs-I4x4 in host C with
        enable_i4x4 under CAVLC, else the device I16 wavefront. Returns
        the symbols (numpy) with the recon planes (device) and the slice
        RBSP."""
        cfg = self.cfg
        if cfg.enable_i4x4 and not cfg.entropy_cabac:
            with trace.span("encoder.i4x4"):
                out = enc_intra_frame_native(
                    *host, self.qp, self.qp_c,
                    int(core_torch.QP_COST_TABLE[np.clip(self.qp, 0, 51)]))
            for k in ("recon_y", "recon_u", "recon_v"):
                out[k] = self._upload(out[k])
        else:
            with trace.span("encoder.dispatch", core="i"):
                d = core_torch.encode_i_frame(*dev, self.qp, self.qp_c,
                                              mb_w=cfg.mb_width,
                                              mb_h=cfg.mb_height)
            out = _fetch(d, _I_KEYS)
            for k in ("recon_y", "recon_u", "recon_v"):
                out[k] = d[k]
        return out, self._write_i_slice(out)

    def _write_i_slice(self, out, mb_h: int | None = None,
                       first_mb: int = 0) -> bytes:
        """One I slice's RBSP: header and body (span encoder.write)."""
        with trace.span("encoder.write", entropy=self._entropy) as sp:
            rbsp = self._write_i_slice_rbsp(out, mb_h, first_mb)
            sp.set(bits=8 * len(rbsp))
        return rbsp

    @property
    def _entropy(self) -> str:
        return "cabac" if self.cfg.entropy_cabac else "cavlc"

    def _write_i_slice_rbsp(self, out, mb_h, first_mb) -> bytes:
        cfg = self.cfg
        mb_h = cfg.mb_height if mb_h is None else mb_h
        w = BitWriter()
        write_slice_header(w, cfg, 2, self.frame_num, first_mb, self.qp,
                           True, self.idr_pic_id,
                           disable_deblock=cfg.deblock_idc,
                           long_term_ref_flag=cfg.enable_ltr)
        if cfg.entropy_cabac:
            self._write_i_slice_cabac(w, out, mb_h)
            return w.get_bytes()
        nc = _NcTracker(cfg.mb_width, mb_h)
        kind = out.get("kind")
        for idx in range(cfg.mb_width * mb_h):
            if kind is not None and kind[idx] == 0:
                self._write_i4_mb(w, out, idx, nc, p_slice=False)
            else:
                self._write_i16_mb(w, out, idx, nc, p_slice=False)
        w.rbsp_trailing_bits()
        return w.get_bytes()

    def _write_i4_mb(self, w, out, idx, nc: _NcTracker, p_slice: bool):
        """I_4x4 macroblock syntax (mb_type 0; spec 7.3.5 and 7.4.5.1
        Intra4x4PredMode signalling; parity: WelsSpatialWriteMbSyn
        intra4x4 branch, svc_set_mb_syn_cavlc.cpp:260)."""
        cfg = self.cfg
        mbx, mby = idx % cfg.mb_width, idx // cfg.mb_width
        luma_ac = out["luma_ac"][idx]          # [16 raster][16] full
        cbp_luma = _cbp_luma_p(luma_ac)
        cac = out["chroma_ac"][idx]
        cdc = out["chroma_dc"][idx]
        cbp_chroma = 2 if cac.any() else (1 if cdc.any() else 0)
        cbp = cbp_luma | (cbp_chroma << 4)
        w.ue(5 if p_slice else 0)              # mb_type I_4x4
        prev = out["i4_prev"][idx]
        rem = out["i4_rem"][idx]
        for kz in range(16):
            w.flag(bool(prev[kz]))
            if not prev[kz]:
                w.u(3, int(rem[kz]))
        w.ue(int(out["chroma_mode"][idx]))
        w.ue(int(CBP_INTRA_INV[cbp]))
        if cbp:
            w.se(0)                            # mb_qp_delta
        gx, gy = mbx * 4, mby * 4
        for k in range(16):
            r = int(ZSCAN_TO_RASTER[k])
            bx, by = r % 4, r // 4
            b8 = (by >> 1) * 2 + (bx >> 1)
            if cbp_luma & (1 << b8):
                coeffs = luma_ac[r][ZIGZAG_4x4]
                tc = write_residual_block(
                    w, coeffs, nc.nc_luma(gx + bx, gy + by), 16)
            else:
                tc = 0
            nc.nzc_l[gy + by, gx + bx] = tc
        self._write_chroma_residual(w, out, idx, nc, cbp_chroma)

    def _write_i16_mb(self, w, out, idx, nc: _NcTracker, p_slice: bool):
        cfg = self.cfg
        mbx, mby = idx % cfg.mb_width, idx // cfg.mb_width
        luma_ac = out["luma_ac"][idx]          # [16,16] raster blk/coef
        cbp_luma = 15 if luma_ac.any() else 0
        cdc = out["chroma_dc"][idx]
        cac = out["chroma_ac"][idx]
        cbp_chroma = 2 if cac.any() else (1 if cdc.any() else 0)
        mb_type = 1 + int(out["i16_mode"][idx]) + 4 * cbp_chroma + \
            12 * (1 if cbp_luma else 0)
        if p_slice:
            mb_type += 5
        w.ue(mb_type)
        w.ue(int(out["chroma_mode"][idx]))
        w.se(0)  # mb_qp_delta (I16 always codes it)
        # luma DC: scan order over the Hadamard block
        dc = out["luma_dc"][idx].reshape(-1)[ZIGZAG_4x4]
        gx, gy = mbx * 4, mby * 4
        write_residual_block(w, dc, nc.nc_luma(gx, gy), 16)
        # luma AC blocks in zscan order
        for k in range(16):
            r = int(ZSCAN_TO_RASTER[k])
            bx, by = r % 4, r // 4
            if cbp_luma:
                coeffs = luma_ac[r][ZIGZAG_4x4][1:]
                tc = write_residual_block(w, coeffs,
                                          nc.nc_luma(gx + bx, gy + by), 15)
            else:
                tc = 0
            nc.nzc_l[gy + by, gx + bx] = tc
        self._write_chroma_residual(w, out, idx, nc, cbp_chroma)

    def _write_chroma_residual(self, w, out, idx, nc, cbp_chroma):
        cfg = self.cfg
        mbx, mby = idx % cfg.mb_width, idx // cfg.mb_width
        cx, cy = mbx * 2, mby * 2
        if cbp_chroma:
            for comp in range(2):
                write_residual_block(w, out["chroma_dc"][idx, comp], -1, 4)
        if cbp_chroma == 2:
            for comp in range(2):
                for k in range(4):
                    bx, by = k % 2, k // 2
                    coeffs = out["chroma_ac"][idx, comp, k][ZIGZAG_4x4][1:]
                    tc = write_residual_block(
                        w, coeffs, nc.nc_chroma(comp, cx + bx, cy + by), 15)
                    nc.nzc_c[comp, cy + by, cx + bx] = tc
        else:
            nc.nzc_c[:, cy:cy + 2, cx:cx + 2] = 0

    # --- CABAC paths ---------------------------------------------------
    def _mb_coeff_views(self, out, idx):
        """CBP + scan-order coefficient views for one MB."""
        luma_ac = out["luma_ac"][idx]
        cdc = out["chroma_dc"][idx]
        cac = out["chroma_ac"][idx]
        cbp_chroma = 2 if cac.any() else (1 if cdc.any() else 0)
        return luma_ac, cdc, cac, cbp_chroma

    def _cabac_luma_ac(self, sw: CabacSliceWriter, out, idx, cbp_luma,
                       is_i16: bool):
        """Luma 4x4 AC/residual blocks in zscan order with per-block cbf."""
        cfg = self.cfg
        mbx, mby = idx % cfg.mb_width, idx // cfg.mb_width
        gx, gy = mbx * 4, mby * 4
        luma_ac = out["luma_ac"][idx]
        prop = I16_AC if is_i16 else LUMA_4x4
        for k in range(16):
            r = int(ZSCAN_TO_RASTER[k])
            bx, by = r % 4, r // 4
            b8 = (by >> 1) * 2 + (bx >> 1)
            if not (cbp_luma & (1 << b8)):
                sw.nzc_l[gy + by, gx + bx] = 0
                continue
            coeffs = luma_ac[r][ZIGZAG_4x4]
            if is_i16:
                coeffs = coeffs[1:]
            nz = int(np.count_nonzero(coeffs))
            sw.cbf(idx, prop, 1 if nz else 0, gx + bx, gy + by)
            if nz:
                sw.residual_levels(prop, coeffs)
            sw.nzc_l[gy + by, gx + bx] = nz

    def _cabac_chroma(self, sw: CabacSliceWriter, out, idx, cbp_chroma):
        cfg = self.cfg
        mbx, mby = idx % cfg.mb_width, idx // cfg.mb_width
        cx, cy = mbx * 2, mby * 2
        if cbp_chroma:
            for comp in range(2):
                dc = out["chroma_dc"][idx, comp]
                nz = dc.any()
                sw.cbf(idx, CHROMA_DC, 1 if nz else 0, comp=comp,
                       dc_bit=1 + comp)
                if nz:
                    sw.residual_levels(CHROMA_DC, dc)
        if cbp_chroma == 2:
            for comp in range(2):
                for k in range(4):
                    bx, by = k % 2, k // 2
                    coeffs = out["chroma_ac"][idx, comp, k][ZIGZAG_4x4][1:]
                    nz = int(np.count_nonzero(coeffs))
                    sw.cbf(idx, CHROMA_AC, 1 if nz else 0, cx + bx, cy + by,
                           comp=comp)
                    if nz:
                        sw.residual_levels(CHROMA_AC, coeffs)
                    sw.nzc_c[comp, cy + by, cx + bx] = nz
        else:
            sw.nzc_c[:, cy:cy + 2, cx:cx + 2] = 0

    def _write_i16_mb_cabac(self, sw: CabacSliceWriter, out, idx,
                            p_slice: bool):
        cfg = self.cfg
        mbx, mby = idx % cfg.mb_width, idx // cfg.mb_width
        luma_ac, cdc, cac, cbp_chroma = self._mb_coeff_views(out, idx)
        cbp_luma = 15 if luma_ac.any() else 0
        sw.mb_type_i16(idx, int(out["i16_mode"][idx]), bool(cbp_luma),
                       cbp_chroma, p_slice)
        sw.intra_chroma_pred_mode(idx, int(out["chroma_mode"][idx]))
        sw.record_cbp(idx, cbp_luma | (cbp_chroma << 4))
        sw.delta_qp(0)
        dc = out["luma_dc"][idx].reshape(-1)[ZIGZAG_4x4]
        nz_dc = dc.any()
        sw.cbf(idx, I16_DC, 1 if nz_dc else 0, dc_bit=0)
        if nz_dc:
            sw.residual_levels(I16_DC, dc)
        self._cabac_luma_ac(sw, out, idx, cbp_luma, is_i16=True)
        self._cabac_chroma(sw, out, idx, cbp_chroma)
        gx, gy = mbx * 4, mby * 4
        sw.mvd[gy:gy + 4, gx:gx + 4] = 0
        sw.mb_coded[idx] = True

    def _write_i_slice_cabac(self, w: BitWriter, out, mb_h: int | None = None):
        cfg = self.cfg
        mb_h = cfg.mb_height if mb_h is None else mb_h
        n_mb = cfg.mb_width * mb_h
        w.byte_align(1)   # cabac_alignment_one_bit
        sw = CabacSliceWriter(cfg.mb_width, mb_h, self.qp, is_i=True)
        for idx in range(n_mb):
            self._write_i16_mb_cabac(sw, out, idx, p_slice=False)
            sw.end_of_slice(idx == n_mb - 1)
        sw.eng.write_to(w)

    def _write_p_slice_cabac(self, w: BitWriter, out, mb_h: int | None = None):
        cfg = self.cfg
        mb_w = cfg.mb_width
        mb_h = cfg.mb_height if mb_h is None else mb_h
        n_mb = mb_w * mb_h
        w.byte_align(1)
        sw = CabacSliceWriter(mb_w, mb_h, self.qp, is_i=False)
        fs = FrameSymbols(mb_w, mb_h)
        fs.slice_id[:] = 0
        mvc = MvContext(fs, 0)
        mb_qp_arr = out.get("mb_qp")
        run_qp = self.qp
        intra_mask = out.get("intra_mask")
        for idx in range(n_mb):
            mbx, mby = idx % mb_w, idx // mb_w
            gx, gy = mbx * 4, mby * 4
            fs.gwritten[gy:gy + 4, gx:gx + 4] = False
            if intra_mask is not None and intra_mask[idx]:
                sw.skip_flag(idx, 0)
                self._write_i16_mb_cabac(sw, out, idx, p_slice=True)
                fs.gmv[:, gy:gy + 4, gx:gx + 4] = 0
                fs.gref[:, gy:gy + 4, gx:gx + 4] = -1
                fs.gwritten[gy:gy + 4, gx:gx + 4] = True
                fs.mb_type[idx] = MB_I16x16
                sw.end_of_slice(idx == n_mb - 1)
                continue
            mv = out["mv"][idx].astype(np.int32)
            luma_ac, cdc, cac, cbp_chroma = self._mb_coeff_views(out, idx)
            cbp_luma = _cbp_luma_p(luma_ac)
            cbp = cbp_luma | (cbp_chroma << 4)
            skip_mv = mvc.pred_skip_mv(gx, gy, idx)
            if cbp == 0 and mv[0] == skip_mv[0] and mv[1] == skip_mv[1]:
                sw.skip_flag(idx, 1)
                mvc.set_partition(gx, gy, 4, 4, 0, 0, mv)
                sw.mvd[gy:gy + 4, gx:gx + 4] = 0
                sw.nzc_l[gy:gy + 4, gx:gx + 4] = 0
                sw.nzc_c[:, mby * 2:mby * 2 + 2, mbx * 2:mbx * 2 + 2] = 0
                sw.record_cbp(idx, 0)
                sw.mb_skip[idx] = True
                sw.mb_coded[idx] = True
                sw.last_dqp = 0
                sw.end_of_slice(idx == n_mb - 1)
                continue
            sw.skip_flag(idx, 0)
            sw.mb_type_p16x16()
            mvp = mvc.pred_mv(gx, gy, 4, 4, 0, 0, idx)
            mvd = (int(mv[0] - mvp[0]), int(mv[1] - mvp[1]))
            sw.mvd_comp(idx, 0, gx, gy, mvd[0])
            sw.mvd_comp(idx, 1, gx, gy, mvd[1])
            sw.mvd[gy:gy + 4, gx:gx + 4] = mvd
            mvc.set_partition(gx, gy, 4, 4, 0, 0, mv)
            sw.write_cbp(idx, cbp)
            if cbp:
                want = int(mb_qp_arr[idx]) if mb_qp_arr is not None \
                    else self.qp
                sw.delta_qp(want - run_qp)
                run_qp = want
                self._cabac_luma_ac(sw, out, idx, cbp_luma, is_i16=False)
                self._cabac_chroma(sw, out, idx, cbp_chroma)
            else:
                sw.last_dqp = 0
                sw.nzc_l[gy:gy + 4, gx:gx + 4] = 0
                sw.nzc_c[:, mby * 2:mby * 2 + 2, mbx * 2:mbx * 2 + 2] = 0
            sw.mb_coded[idx] = True
            sw.end_of_slice(idx == n_mb - 1)
        sw.eng.write_to(w)

    # ------------------------------------------------------------------
    def _slide_window(self):
        """Sliding window over short-term refs only; LTR entries live
        until replaced by a same-index marking (spec 8.2.5.3,
        ref_list_mgr_svc.cpp WelsUpdateRefList)."""
        st = [e for e in self.dpb if not e.is_ltr]
        while len(st) > self._st_capacity:
            victim = st.pop(0)
            self.dpb.remove(victim)

    def _reorder_cmd(self, ref: _RefEntry) -> int | None:
        """abs_diff_pic_num_minus1 when `ref` isn't already first in the
        default P list (spec 8.2.4.2.1 descending-PicNum order)."""
        mx = 1 << self.cfg.log2_max_frame_num
        cur = self.frame_num

        def picnum(fn):
            return fn if fn <= cur else fn - mx
        default = sorted((e.frame_num for e in self.dpb if not e.is_ltr),
                         key=picnum, reverse=True)
        if default and default[0] == ref.frame_num:
            return None
        return (cur - ref.frame_num + mx) % mx - 1

    def _reorder_for(self, ref: _RefEntry):
        """(reorder_abs_diff, reorder_long_term) pinning `ref` first in
        L0: an LTR target always gets an explicit idc-2 command, a
        short-term one only when it isn't already the default head."""
        if ref.is_ltr:
            return None, ref.ltr_idx
        return self._reorder_cmd(ref), None

    def _aq_qp(self, yp, ry):
        """Per-MB QP arrays (numpy) from adaptive quant and GOM rate
        control, or (None, None)."""
        cfg = self.cfg
        if not (cfg.enable_adaptive_quant or cfg.enable_gom_rc):
            return None, None
        from ..processing.vaa import vaa_calc
        vaa = _fetch(vaa_calc(yp, ry), ("sad8x8", "sum16x16", "sqsum16x16",
                                         "sqdiff16x16"))
        dqp = np.zeros((cfg.mb_height, cfg.mb_width), np.int32)
        if cfg.enable_adaptive_quant:
            from ..processing.adaptivequant import adaptive_quant_map
            dqp += adaptive_quant_map(vaa).astype(np.int32)
        if cfg.enable_gom_rc:
            # per-MB-row (GOM) offset from relative complexity
            # (WelsRcMbInitGom analog at GOM granularity)
            sad = vaa["sad8x8"].sum(-1).astype(np.int64)  # [mh,mw]
            gom = sad.sum(-1)                              # [mh]
            avg = max(1, int(gom.mean()))
            off = np.where(gom > 2 * avg, 1,
                           np.where(4 * gom < avg, -1, 0)).astype(np.int32)
            dqp += off[:, None]
        if cfg.rc_mode != RC_OFF_MODE:
            # keep AQ zero-mean under rate control so the frame-level
            # budget model stays calibrated
            dqp = dqp - int(round(float(dqp.mean())))
        mb_qp = np.clip(self.qp + dqp.reshape(-1),
                        cfg.min_qp, cfg.max_qp).astype(np.int32)
        mb_qp_c = CHROMA_QP_TABLE[np.clip(
            mb_qp + cfg.chroma_qp_offset, 0, 51)].astype(np.int32)
        return mb_qp, mb_qp_c

    def _encode_p(self, planes, ref: _RefEntry, is_ref: bool,
                  mmco_ops=None):
        cfg = self.cfg
        yp, up, vp = planes
        ry, ru, rv = ref.planes
        mb_w, mb_h = cfg.mb_width, cfg.mb_height
        n_mb = mb_w * mb_h
        dev = self.device
        mb_qp, mb_qp_c = self._aq_qp(yp, ry)
        prev_sad = (ref.skip_sad if ref.skip_sad is not None
                    else torch.zeros(n_mb, dtype=torch.int32, device=dev))
        prev_skip = (ref.skip_map if ref.skip_map is not None
                     else torch.zeros(n_mb, dtype=torch.bool, device=dev))
        extra_mv = None
        if cfg.usage_type == 1 and self._scroll_prev is not None:
            # screen content: a detected global scroll becomes a whole-MB
            # candidate for every MB; detection compares input frames
            from ..processing.scroll import detect_scroll
            flag, mv_y = detect_scroll(yp, self._scroll_prev)
            if flag and mv_y != 0:
                extra_mv = np.array([0, 4 * mv_y], np.int32)
        with trace.span("encoder.dispatch", core="p"):
            d = core_torch.encode_p_frame(
                yp, up, vp, ry, ru, rv,
                self.qp if mb_qp is None else mb_qp,
                self.qp_c if mb_qp is None else mb_qp_c,
                mb_w=mb_w, mb_h=mb_h, sr=cfg.search_range,
                prev_skip_sad=prev_sad, prev_skip=prev_skip,
                extra_mv=extra_mv)
            # intra-in-P mode decision (parity: WelsMdIntraMb vs
            # WelsMdInterMb, svc_base_layer_md.cpp:956/1858): the SATD
            # intra proxy is biased by ~lambda; promoted skips stay
            # inter; the chain-free demotion matches the device session's
            intra_mask = torch.zeros(n_mb, dtype=torch.bool, device=dev)
            if cfg.enable_intra_in_p and mb_qp is None:
                lam = max(self.qp - 12, 1)
                intra_mask = ((d["intra_cost_proxy"].to(torch.int64)
                               + 8 * lam < d["inter_cost"].to(torch.int64))
                              & ~d["skip_mask"])
                intra_mask = core_torch.chainfree_intra_mask(intra_mask,
                                                             mb_w, mb_h)
        d["intra_mask"] = intra_mask
        keys = _P_KEYS + ("intra_mask",)
        with trace.span("encoder.fetch"):       # waits for the core
            any_intra = bool(intra_mask.any())
        if any_intra:
            with trace.span("encoder.dispatch", core="intra_in_p"):
                iout = core_torch.encode_i_frame(
                    yp, up, vp, self.qp, self.qp_c, mb_w=mb_w, mb_h=mb_h,
                    intra_mask=intra_mask,
                    init_recon=(d["recon_y"], d["recon_u"], d["recon_v"]))
                for k in ("recon_y", "recon_u", "recon_v", "i16_mode",
                          "chroma_mode", "luma_dc"):
                    d[k] = iout[k]
                for k, dims in (("luma_ac", 2), ("chroma_dc", 2),
                                ("chroma_ac", 3)):
                    m = intra_mask.reshape((-1,) + (1,) * dims)
                    d[k] = torch.where(m, iout[k], d[k])
            keys += ("i16_mode", "chroma_mode", "luma_dc")
        out = _fetch(d, keys)
        for k in ("recon_y", "recon_u", "recon_v", "skip_mask", "skip_sad"):
            out[k] = d[k]
        if mb_qp is not None:
            out["mb_qp"] = mb_qp
        reorder, reorder_lt = self._reorder_for(ref)
        rbsp = self._write_p_slice(out, is_ref, reorder,
                                   mmco_ops=mmco_ops, reorder_lt=reorder_lt)
        return out, rbsp

    def _write_p_slice(self, out, is_ref: bool = True,
                       reorder_abs_diff: int | None = None,
                       mb_h: int | None = None, first_mb: int = 0,
                       mmco_ops=None, reorder_lt=None) -> bytes:
        """Slice header, then the CABAC body, or the whole-slice
        vectorised CAVLC body (cavlc_vec.py) packed by the host C bit
        packer (span encoder.write)."""
        with trace.span("encoder.write", entropy=self._entropy) as sp:
            rbsp = self._write_p_slice_rbsp(out, is_ref, reorder_abs_diff,
                                            mb_h, first_mb, mmco_ops,
                                            reorder_lt)
            sp.set(bits=8 * len(rbsp))
        return rbsp

    def _write_p_slice_rbsp(self, out, is_ref, reorder_abs_diff, mb_h,
                            first_mb, mmco_ops, reorder_lt) -> bytes:
        cfg = self.cfg
        mb_w = cfg.mb_width
        mb_h = cfg.mb_height if mb_h is None else mb_h
        w = BitWriter()
        write_slice_header(w, cfg, 0, self.frame_num, first_mb, self.qp,
                           False, 0, disable_deblock=cfg.deblock_idc,
                           is_ref=is_ref, reorder_abs_diff=reorder_abs_diff,
                           reorder_long_term=reorder_lt, mmco_ops=mmco_ops)
        if cfg.entropy_cabac:
            self._write_p_slice_cabac(w, out, mb_h)
            return w.get_bytes()
        out = dict(out)
        out["slice_qp"] = self.qp
        hdr_bits = w.bit_array()
        av, al, tv, tl = write_p_slice_tokens(out, mb_w, mb_h)
        groups = [(av, al)]
        if tv is not None:
            groups.append((tv, tl))
        return assemble_rbsp(hdr_bits, groups)

    # ------------------------------------------------------------------
    def export_state(self) -> dict:
        """The state that the next frame depends on, as numpy arrays and
        plain ints: counters, the DPB (planes, skip maps, LTR flags and
        indexes), the LTR protocol's sets, the rate-control state and the
        previous inputs of scene-change and scroll detection."""
        def host(t):
            return None if t is None else t.cpu().numpy().copy()
        st = {"frame_num": self.frame_num, "idr_pic_id": self.idr_pic_id,
              "coding_idx": self.coding_idx,
              "frame_count": self.frame_count, "qp": self.qp,
              "num_ref_frames": self.cfg.num_ref_frames,
              "force_idr": self._force_idr,
              "ltr_capacity_added": self._ltr_capacity_added,
              "ltr_next_idx": self._ltr_next_idx,
              "ltr_acked": sorted(self._ltr_acked),
              "ltr_pending": dict(self._ltr_pending),
              "need_ltr_recovery": self._need_ltr_recovery,
              "prev_input": host(self._prev_input),
              "scroll_prev": host(self._scroll_prev), "dpb": []}
        for e in self.dpb:
            y, u, v = (host(p) for p in e.planes)
            st["dpb"].append({
                "frame_num": e.frame_num, "coding_idx": e.coding_idx,
                "temporal_id": e.temporal_id, "y": y, "u": u, "v": v,
                "skip_map": host(e.skip_map), "skip_sad": host(e.skip_sad),
                "is_ltr": e.is_ltr, "ltr_idx": e.ltr_idx})
        r = self.rc.st
        st["rc"] = {"qp": r.qp, "buffer_fullness": r.buffer_fullness,
                    "model_x": r.model_x, "frames": r.frames,
                    "window": list(self.rc._win)}
        return st

    @classmethod
    def from_state(cls, cfg: EncoderConfig, state: dict, device="cuda"):
        """An encoder that continues from `state` (see export_state) under
        `cfg`; the DPB size (num_ref_frames) and the LTR capacity come
        from the state."""
        enc = cls(cfg, device=device)
        cfg.num_ref_frames = int(state["num_ref_frames"])
        enc._ltr_capacity_added = int(state["ltr_capacity_added"])
        for k in ("frame_num", "idr_pic_id", "coding_idx", "frame_count",
                  "qp"):
            setattr(enc, k, int(state[k]))
        enc.qp_c = int(CHROMA_QP_TABLE[np.clip(
            enc.qp + cfg.chroma_qp_offset, 0, 51)])
        enc._force_idr = bool(state["force_idr"])
        enc._ltr_next_idx = int(state["ltr_next_idx"])
        enc._ltr_acked = {int(i) for i in state["ltr_acked"]}
        enc._ltr_pending = {int(k): int(v)
                            for k, v in state["ltr_pending"].items()}
        enc._need_ltr_recovery = bool(state["need_ltr_recovery"])

        def dev(a, dtype):
            # torch.tensor copies: the encoder never shares the caller's
            # arrays
            return None if a is None else torch.tensor(
                np.asarray(a, dtype), device=enc.device)
        enc._prev_input = dev(state["prev_input"], np.uint8)
        enc._scroll_prev = dev(state["scroll_prev"], np.uint8)
        for e in state["dpb"]:
            enc.dpb.append(_RefEntry(
                int(e["frame_num"]), int(e["coding_idx"]),
                int(e["temporal_id"]),
                tuple(dev(e[p], np.uint8) for p in "yuv"),
                skip_map=dev(e["skip_map"], bool),
                skip_sad=dev(e["skip_sad"], np.int32),
                is_ltr=bool(e["is_ltr"]), ltr_idx=int(e["ltr_idx"])))
        rc = state["rc"]
        enc.rc.st.qp = int(rc["qp"])
        enc.rc.st.buffer_fullness = float(rc["buffer_fullness"])
        enc.rc.st.model_x = float(rc["model_x"])
        enc.rc.st.frames = int(rc["frames"])
        enc.rc._win.clear()
        enc.rc._win.extend(rc["window"])
        return enc


def encode_yuv_file(cfg: EncoderConfig, yuv_path: str, n_frames: int,
                    out_path: str | None = None, device="cuda") -> bytes:
    """Encode a raw YUV420 file; returns the Annex-B stream."""
    w, h = cfg.width, cfg.height
    fsz = w * h * 3 // 2
    enc = H264Encoder(cfg, device=device)
    chunks = []
    with open(yuv_path, "rb") as f:
        for _ in range(n_frames):
            raw = f.read(fsz)
            if len(raw) < fsz:
                break
            y = np.frombuffer(raw[:w * h], np.uint8).reshape(h, w)
            u = np.frombuffer(raw[w * h:w * h + w * h // 4],
                              np.uint8).reshape(h // 2, w // 2)
            v = np.frombuffer(raw[w * h + w * h // 4:],
                              np.uint8).reshape(h // 2, w // 2)
            chunks.append(enc.encode_frame(y, u, v))
    stream = b"".join(chunks)
    if out_path:
        with open(out_path, "wb") as f:
            f.write(stream)
    return stream
