"""Top-level H.264 decoder session.

Port of openh264_tpu/decoder/decoder.py, which mirrors the reference's
decode entry flow (welsDecoderExt.cpp DecodeFrameNoDelay → WelsDecodeBs
→ ConstructAccessUnit, SURVEY.md §3.3): Annex-B in, YUV420 frames out.

Per picture: the slices are parsed on the host (parse_slice_data),
each by the one routing rule slice_dec.c_parses: CABAC slices without
FMO (I, P and B, with the 8x8 transform and B direct motion) whole in
host C (csrc/parse_cabac.c), CAVLC I/P slices without FMO or the 8x8
transform whole in host C (csrc/parse_cavlc.c), both bound in cbind.py;
CAVLC B slices, the CAVLC 8x8 transform and FMO by the per-MB Python
parsers (slice_dec.py; slice_dec_cabac.py, per bin with their residual
bins in C), whose B direct motion is derived on the host (direct.py);
inter MBs are predicted (L0, L1, bi, weighted) and get their 4x4 or 8x8
residual on the decoder's device and intra MBs run in host C, or, under
openh264_compat only, in host Python in a picture with I8x8 MBs
(recon_batch.py); the frame is deblocked by
the port's Hopper kernel on CUDA, or its plain version on the CPU
(encoder/deblock_host.py); the planes come to the host once, for
output and for error concealment, which fills the MBs of broken slices
after the deblock (ec.py). A concealed picture's device planes are
refreshed from the concealed host planes before the picture enters the
DPB, where every later P picture reads them.

Scope: I, P and B slices, CAVLC or CABAC, one or several per picture,
spatial and temporal direct, explicit and implicit weights
(weighted_bipred_idc 0-2), the 8x8 transform (I8x8, 8x8 inter residual),
FMO (slice group map types 0-6), 4x4 and 8x8 scaling lists, IPCM, LTR /
MMCO / ref-list modification of both lists, POC-order output of streams
with B slices or whose SPS declares reordering (VUI
max_num_reorder_frames), every deblocking_filter_idc with its offsets, both
chroma QP offsets, error concealment. SP and SI slices raise
NotImplementedError out of decode_annexb / feed_annexb / flush; they
are never concealed.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace

import numpy as np
import torch

from ..bitstream import (BitReader, split_annexb, NAL_SPS, NAL_PPS, NAL_IDR,
                         NAL_SLICE, NAL_SLICE_EXT, NAL_SUBSET_SPS, NalUnit)
from ..device import DEFAULT_DEVICE, resolve_device
from ..encoder.deblock_host import deblock_frame
from ..utils import trace
from .dpb import DPB, Picture, PocContext
from .ec import ERROR_CON_DISABLE, ERROR_CON_SLICE_COPY, implement_error_con
from .fmo import build_mb_to_slice_group, next_mb_lut
from .framedata import (FrameSymbols, MB_BDIRECT, MB_BSKIP, MB_I4x4,
                        MB_I8x8, MB_I16x16, MB_IPCM, MB_PSKIP)
from .params import parse_pps, parse_sps
from . import cbind
from .recon_batch import recon_frame_batch
from .slice_dec import (SliceDecodeContext, c_parses, check_scope,
                        decode_slice_mbs_cavlc)
from .slice_dec_cabac import decode_slice_mbs_cabac
from .slicehdr import parse_slice_header, P_SLICE, B_SLICE
from .wpred import WP_B_IMPLICIT, WP_NONE, build_slice_wp, implicit_weights

# the stages whose seconds H264Decoder(stage_times=True) adds up, each
# the sum of its spans' times (decoder.parse is one span per slice)
STAGES = ("parse", "inter_intra_recon", "deblock", "output", "conceal")
STAGE_SPANS = {"parse": ("decoder.prepare", "decoder.parse"),
               "inter_intra_recon": ("decoder.recon",),
               "deblock": ("decoder.deblock",),
               "output": ("decoder.output",),
               "conceal": ("decoder.conceal",)}


def parse_slice_data(br: BitReader, ctx: SliceDecodeContext) -> int:
    """Parses the MBs of slice ctx.sh, from the end of its header (br's
    position) into ctx.fs; returns one past its last MB. The one routing
    rule, slice_dec.c_parses, sends the slice whole to the host C
    (cbind) or to the per-MB Python parser of its entropy mode. SP and
    SI slices raise NotImplementedError (check_scope)."""
    sh = ctx.sh
    check_scope(sh)
    c = c_parses(sh)
    if sh.pps.entropy_coding_mode:
        parse = cbind.parse_cabac_slice_native if c else \
            decode_slice_mbs_cabac
        return parse(br.data, sh.header_bits, ctx)[0]
    parse = cbind.parse_cavlc_slice_native if c else decode_slice_mbs_cavlc
    return parse(br, ctx)


# Picture fields carried by export_state (the planes travel as numpy)
_PIC_INTS = ("pic_id", "frame_num", "poc", "is_ref", "is_long_term",
             "long_term_frame_idx", "is_idr", "pic_num", "long_term_pic_num")
_PIC_GRIDS = ("col_mv0", "col_mv1", "col_ref0", "col_ref1", "col_refpic0",
              "col_refpic1", "col_intra", "col_mb16")


@dataclass
class DecodedFrame:
    y: np.ndarray
    u: np.ndarray
    v: np.ndarray
    poc: int = 0
    frame_num: int = 0
    is_idr: bool = False
    cvs: int = 0  # coded-video-sequence counter (for output ordering)

    def planes(self):
        return self.y, self.u, self.v


class H264Decoder:
    """Session-style decoder: feed Annex-B bytes, collect frames.

    device: where the pictures live and the inter recon and the deblock
    run ("cuda" by default; "cpu" runs the plain versions). ec_mode:
    ERROR_CON_IDC analog (decoder/ec.py). The default matches the
    reference console's `h264dec in out` invocation
    (ERROR_CON_SLICE_COPY, h264dec.cpp:564). Incomplete (EC'd) pictures
    are concealed and kept as references but NOT emitted: in the
    reference's no-delay flow their output lands in the data call of a
    DecodeFrame2 pair and the follow-up flush call memsets it away
    (welsDecoderExt.cpp DecodeFrameNoDelay:695-733). stage_times: add
    up the seconds of each stage of STAGES in `stage_seconds`, the
    times of the stage's spans (STAGE_SPANS, utils/trace.py), each
    ended by a synchronization of the device (off by default: it costs
    the device's overlap with the host). openh264_compat: decode B
    pictures as the OpenH264 decoder (and the JAX package) does where it
    departs from clause 8: the BI partitions of B 16x8 / 8x16 MBs
    (recon_batch.py) and no motion term in the bS of the interior edges
    of B_Skip and B_Direct_16x16 MBs (slice_dec.apply_direct); and it
    sends the intra MBs of a picture with I8x8 MBs to the Python recon,
    whose fault on modes that predict from a missing neighbour it
    shares (ROADMAP C7). Off by default, when B pictures follow clause 8
    and every intra MB takes the host C recon.
    """

    def __init__(self, device=DEFAULT_DEVICE, ec_mode: int | None = None,
                 stage_times: bool = False, openh264_compat: bool = False):
        self.device = resolve_device(device)
        self.openh264_compat = openh264_compat
        self.sps_map: dict[int, object] = {}
        self.subset_sps_map: dict[int, object] = {}
        self.pps_map: dict[int, object] = {}
        self.ec_mode = ERROR_CON_SLICE_COPY if ec_mode is None else ec_mode
        self.dpb: DPB | None = None
        self.poc_ctx: PocContext | None = None
        self.active_sps = None
        self.prev_decoded: Picture | None = None
        self._cvs_counter = -1
        self._has_b_slices = False
        # incremental-mode state (feed_annexb/flush)
        self._in_buf = b""
        self._pending: list[tuple] = []
        self._reorder_q: list[DecodedFrame] = []
        self.stage_times = stage_times
        self.stage_seconds = dict.fromkeys(STAGES, 0.0)
        self._pictures = 0          # decode index, the pictures' frame id

    def _stage_end(self) -> None:
        """With stage_times, the last step inside a stage's span: wait
        for the device's queued work."""
        if self.stage_times and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _stage_add(self, stage: str, sp) -> None:
        """With stage_times, adds the time of the stage's span."""
        if self.stage_times:
            self.stage_seconds[stage] += sp.seconds

    @staticmethod
    def _is_au_boundary(prev_sh, sh) -> bool:
        """CheckAccessUnitBoundary (au_parser.cpp:495) for frame coding,
        plus the universal first_mb_in_slice==0 new-picture rule."""
        if sh.first_mb_in_slice == 0:
            return True
        if prev_sh is None:
            return False
        if prev_sh.sps is not sh.sps:
            return True
        if prev_sh.frame_num != sh.frame_num:
            return True
        if prev_sh.pps_id != sh.pps_id:
            return True
        if (prev_sh.nal.nal_ref_idc != 0) != (sh.nal.nal_ref_idc != 0):
            return True
        if prev_sh.is_idr != sh.is_idr:
            return True
        if sh.is_idr and prev_sh.idr_pic_id != sh.idr_pic_id:
            return True
        if sh.sps.pic_order_cnt_type == 0:
            if prev_sh.pic_order_cnt_lsb != sh.pic_order_cnt_lsb:
                return True
        elif sh.sps.pic_order_cnt_type == 1:
            if prev_sh.delta_pic_order_cnt != sh.delta_pic_order_cnt:
                return True
        if prev_sh.redundant_pic_cnt > sh.redundant_pic_cnt:
            return True
        return False

    def _handle_nal(self, nal) -> DecodedFrame | None:
        """Process one NAL unit; returns the decoded picture when this
        NAL begins a new access unit (completing the pending one)."""
        if nal.nal_unit_type == NAL_SPS:
            sps = parse_sps(nal.rbsp)
            self.sps_map[sps.sps_id] = sps
        elif nal.nal_unit_type == NAL_SUBSET_SPS:
            sps = parse_sps(nal.rbsp, is_subset=True)
            self.subset_sps_map[sps.sps_id] = sps
        elif nal.nal_unit_type == NAL_PPS:
            pps = parse_pps(nal.rbsp, self.sps_map)
            pps.raw = bytes(nal.rbsp)       # carried by export_state
            self.pps_map[pps.pps_id] = pps
        elif nal.nal_unit_type in (NAL_SLICE, NAL_IDR, NAL_SLICE_EXT):
            br = BitReader(nal.rbsp)
            try:
                sh = parse_slice_header(br, nal, self.sps_map, self.pps_map,
                                        self.subset_sps_map)
            except ValueError as e:
                if nal.nal_unit_type == NAL_SLICE_EXT:
                    # unsupported SVC enhancement slice: skip it and keep
                    # decoding the AVC base layer (parity: the reference
                    # decodes the base layer of multi-layer streams)
                    return None
                if self.ec_mode != ERROR_CON_DISABLE:
                    from ..utils import wels_log, WELS_LOG_WARNING
                    wels_log(WELS_LOG_WARNING,
                             f"dropping slice NAL with bad header: {e}")
                    return None
                raise
            done = None
            prev_sh = self._pending[-1][1] if self._pending else None
            if self._pending and self._is_au_boundary(prev_sh, sh):
                done = self._decode_picture(self._pending)
                self._pending = []
            self._pending.append((nal, sh, br))
            return done
        # SEI, AUD, filler etc. skipped
        return None

    def decode_annexb(self, data: bytes) -> list[DecodedFrame]:
        """Decode a whole Annex-B stream (batch mode)."""
        frames: list[DecodedFrame] = []
        for nal in split_annexb(data):
            frames.append(self._handle_nal(nal))
        if self._pending:
            # trailing AU: the reference decodes it at EOS flush; if it
            # is incomplete there is no later boundary to trigger EC, so
            # it is decoded but never output either way
            frames.append(self._decode_picture(self._pending))
            self._pending = []
        frames = [f for f in frames if f is not None]
        # Output (display) order mirrors the reference's reorder policy
        # (welsDecoderExt.cpp:992-1137): baseline profile and B-free
        # streams release in decode order; streams that carry B-slices
        # or declare reordering reorder by POC within each coded video
        # sequence.
        if self._reorders():
            frames.sort(key=lambda f: (f.cvs, f.poc))
        return frames

    # ------------------------------------------------------------------
    # Incremental input (fragmented-NAL feeding, welsDecoderExt.cpp
    # DecodeFrame2's per-call buffering): callers may deliver partial
    # NALs; complete NALs decode as soon as the NEXT start code proves
    # them complete, and access units spanning calls stay pending.
    def feed_annexb(self, data: bytes) -> list[DecodedFrame]:
        from .nalbuf import split_complete
        with trace.span("decoder.feed"):
            self._in_buf += bytes(data)
            complete, self._in_buf = split_complete(self._in_buf)
            out = []
            if complete:
                for nal in split_annexb(complete):
                    f = self._handle_nal(nal)
                    if f is not None:
                        self._reorder_q.append(f)
                out = self._release(eos=False)
        return out

    def flush(self) -> list[DecodedFrame]:
        """End of stream: decode everything still buffered and release
        the reorder queue (ISVCDecoder FlushFrame semantics)."""
        for nal in split_annexb(self._in_buf):
            f = self._handle_nal(nal)
            if f is not None:
                self._reorder_q.append(f)
        self._in_buf = b""
        if self._pending:
            f = self._decode_picture(self._pending)
            self._pending = []
            if f is not None:
                self._reorder_q.append(f)
        return self._release(eos=True)

    def _reorder_depth(self) -> int | None:
        """The active SPS's VUI max_num_reorder_frames, where its
        bitstream_restriction gives it."""
        vui = getattr(self.active_sps, "vui", None) or {}
        return vui.get("max_num_reorder_frames")

    def _reorders(self) -> bool:
        """Whether pictures leave in POC order: once a B slice was
        seen, and from the first picture of a stream whose SPS declares
        reordering (the picture after an IDR may precede a B picture
        in decode order and follow it in output order)."""
        return self._has_b_slices or bool(self._reorder_depth())

    def _release(self, eos: bool) -> list[DecodedFrame]:
        """Bounded-latency reorder release (the reference's
        ReleaseBufferedReadyPictureReorder holds at most the DPB depth
        before emitting the smallest-POC buffered picture; the SPS's
        max_num_reorder_frames, where given, is the depth)."""
        q = self._reorder_q
        if not self._reorders():
            self._reorder_q = []
            return q
        q.sort(key=lambda f: (f.cvs, f.poc))
        if eos:
            self._reorder_q = []
            return q
        depth = self._reorder_depth()
        if not depth:
            depth = 1 + (self.active_sps.max_num_ref_frames
                         if self.active_sps is not None else 1)
        max_cvs = max((f.cvs for f in q), default=0)
        out = []
        while q and (len(q) > depth or q[0].cvs < max_cvs):
            out.append(q.pop(0))
        return out

    def _activate_sps(self, sps) -> None:
        # a re-transmitted identical SPS is NOT a new coded video
        # sequence and must not flush the DPB (the reference keeps
        # decoding; only content change triggers new-seq handling,
        # decoder_core.cpp DecodeFrameConstruction new-seq path)
        if self.active_sps is not None and (
                self.active_sps is sps
                or getattr(self.active_sps, "raw", None) == getattr(sps, "raw", 1)):
            self.active_sps = sps
            return
        self.active_sps = sps
        self.dpb = DPB(sps.max_num_ref_frames, 1 << sps.log2_max_frame_num)
        self.poc_ctx = PocContext(sps)

    def _decode_picture(self, slices) -> DecodedFrame | None:
        _, sh0, _ = slices[0]
        inter = sh0.slice_type in (P_SLICE, B_SLICE)
        with trace.span("decoder.picture", frame=self._pictures,
                        idr=sh0.is_idr, slice_type=sh0.slice_type,
                        entropy=("cabac" if sh0.pps.entropy_coding_mode
                                 else "cavlc"),
                        refs_l0=sh0.num_ref_idx_l0_active if inter else 0,
                        refs_l1=(sh0.num_ref_idx_l1_active
                                 if sh0.slice_type == B_SLICE else 0)):
            self._pictures += 1
            return self._decode_picture_in(slices)

    def _decode_picture_in(self, slices) -> DecodedFrame | None:
        _, sh0, _ = slices[0]
        sps = sh0.sps
        timed = self.stage_times
        with trace.span("decoder.prepare", clock=timed) as sp:
            self._activate_sps(sps)
            poc = self.poc_ctx.compute(sh0, sh0.nal.nal_ref_idc)
            fs = FrameSymbols(sps.mb_width, sps.mb_height)
            fs.mb_correct[:] = False
            fs.openh264_compat = self.openh264_compat
            if any(sh.slice_type == B_SLICE for _, sh, _ in slices):
                self._has_b_slices = True
            if sh0.slice_type in (P_SLICE, B_SLICE) and \
                    not any(p.is_ref for p in self.dpb.pics):
                self._recover_lost_ref(sps, sh0)
            fs.wp_by_slice = []
            fmo_next = None
            if sh0.pps.num_slice_groups > 1:
                # FMO: MBs iterate within their slice group (fmo.cpp
                # FmoNextMb); the map may depend on the per-picture
                # slice_group_change_cycle (map types 3-5)
                fmo_next = next_mb_lut(build_mb_to_slice_group(
                    sh0.pps, sps, sh0.slice_group_change_cycle))
            self._stage_end()
        self._stage_add("parse", sp)
        ref_pics: dict[int, Picture] = {}
        last_l0 = None      # last slice's L0 for EC MV-copy modes
        for si, (nal, sh, br) in enumerate(slices):
            with trace.span("decoder.parse", clock=timed,
                            bytes=len(nal.rbsp),
                            slice_type=sh.slice_type) as sp:
                last_l0 = self._parse_slice(fs, si, sh, br, poc,
                                            ref_pics, fmo_next, last_l0)
                if trace.enabled():
                    sp.set(mbs=int(np.count_nonzero(fs.slice_id == si)))
                self._stage_end()
            self._stage_add("parse", sp)
        complete = bool(fs.mb_correct.all())
        if trace.enabled():
            _count_mb_classes(fs)
        with trace.span("decoder.recon", clock=timed) as sp:
            st = recon_frame_batch(fs, ref_pics,
                                   sh0.pps.constrained_intra_pred,
                                   self.device)
            self._stage_end()
        self._stage_add("inter_intra_recon", sp)
        with trace.span("decoder.deblock", clock=timed) as sp:
            planes = deblock_frame(st.y, st.u, st.v, fs)
            self._stage_end()
        self._stage_add("deblock", sp)
        with trace.span("decoder.output", clock=timed) as sp:
            host = tuple(p.cpu().numpy() for p in planes)
            self._stage_end()
        self._stage_add("output", sp)
        if not complete:
            with trace.span("decoder.conceal", clock=timed) as sp:
                implement_error_con(self.ec_mode,
                                    SimpleNamespace(y=host[0], u=host[1],
                                                    v=host[2]), fs,
                                    fs.mb_correct, self.prev_decoded,
                                    sh0.is_idr, ref_list0=last_l0,
                                    cur_poc=poc)
                # the DPB's planes must be the concealed ones
                planes = tuple(torch.from_numpy(p).to(self.device)
                               for p in host)
                self._stage_end()
            self._stage_add("conceal", sp)
        # store into DPB (full uncropped planes; refs must keep MB grid)
        pic = Picture(0, *planes, frame_num=sh0.frame_num, poc=poc,
                      is_ref=sh0.nal.nal_ref_idc != 0, is_idr=sh0.is_idr,
                      host=host)
        self._attach_col_motion(pic, fs)
        self.dpb.store_picture(pic, sh0)
        self.prev_decoded = pic
        if sh0.is_idr:
            self._cvs_counter += 1
        if not complete:
            # EC'd pictures stay in the DPB as refs but are not emitted
            # (see class docstring for the reference-flow reason)
            return None
        y, u, v = self._crop(sps, *host)
        return DecodedFrame(y, u, v, poc=poc, frame_num=sh0.frame_num,
                            is_idr=sh0.is_idr,
                            cvs=max(self._cvs_counter, 0))

    def _parse_slice(self, fs, si, sh, br, poc, ref_pics, fmo_next,
                     last_l0):
        """Builds slice si's reference lists and weights and parses its
        MBs into fs (a parse error is concealed unless ec_mode is
        ERROR_CON_DISABLE); returns the L0 list that EC's MV-copy modes
        read."""
        l0 = l1 = i0 = i1 = []
        if sh.slice_type in (P_SLICE, B_SLICE):
            mods = sh.ref_pic_list_modification
            if sh.slice_type == P_SLICE:
                i0 = self.dpb.build_list_p(sh.frame_num)
            else:
                i0, i1 = self.dpb.build_lists_b(poc, sh.frame_num)
            l0 = self.dpb.reorder_list(i0, mods[0], sh.frame_num,
                                       sh.num_ref_idx_l0_active)
            if sh.slice_type == B_SLICE:
                l1 = self.dpb.reorder_list(i1, mods[1], sh.frame_num,
                                           sh.num_ref_idx_l1_active)
            for p in l0 + l1:
                if p is not None:
                    ref_pics[p.pic_id] = p
            last_l0 = l0
        fs.wp_by_slice.append(build_slice_wp(sh, i0, i1, cur_poc=poc))
        ctx = SliceDecodeContext(fs, sh, si, ref_list0=l0, ref_list1=l1,
                                 poc=poc, fmo_next=fmo_next)
        try:
            parse_slice_data(br, ctx)
        except NotImplementedError:
            raise               # out of scope: never concealed
        except Exception as e:
            if self.ec_mode == ERROR_CON_DISABLE:
                raise
            from ..utils import wels_log, WELS_LOG_WARNING
            wels_log(WELS_LOG_WARNING,
                     f"slice {si} (first_mb {sh.first_mb_in_slice}) parse "
                     f"error, concealing rest: {type(e).__name__}: {e}")
        return last_l0

    def _recover_lost_ref(self, sps, sh0) -> None:
        """P/B slice with an empty DPB (lost IDR): synthesize a ref so
        decoding can continue (manage_dec_ref.cpp:151
        WelsCheckAndRecoverForFutureDecoding). With a cross-IDR EC mode
        and a previous decoded picture of the same size, copy it;
        otherwise mid-gray."""
        H, W = sps.mb_height * 16, sps.mb_width * 16
        prev = self.prev_decoded
        if prev is not None and prev.host[0].shape == (H, W):
            host = tuple(p.copy() for p in prev.host)
        else:
            host = (np.full((H, W), 128, np.uint8),
                    np.full((H // 2, W // 2), 128, np.uint8),
                    np.full((H // 2, W // 2), 128, np.uint8))
        from ..utils import wels_log, WELS_LOG_WARNING
        prev_fn = (sh0.frame_num - 1) % (1 << sps.log2_max_frame_num)
        wels_log(WELS_LOG_WARNING,
                 "P/B slice with empty DPB: synthesizing lost reference "
                 f"(frame_num={prev_fn}) for error concealment")
        pic = Picture(0, *(torch.from_numpy(p).to(self.device) for p in host),
                      frame_num=prev_fn, poc=0, is_ref=True, host=host)
        h4, w4 = sps.mb_height * 4, sps.mb_width * 4
        pic.col_mv0 = np.zeros((h4, w4, 2), np.int32)
        pic.col_mv1 = np.zeros((h4, w4, 2), np.int32)
        pic.col_ref0 = np.full((h4, w4), -1, np.int32)
        pic.col_ref1 = np.full((h4, w4), -1, np.int32)
        pic.col_refpic0 = np.full((h4, w4), -1, np.int32)
        pic.col_refpic1 = np.full((h4, w4), -1, np.int32)
        pic.col_intra = np.ones((h4, w4), bool)
        pic.pic_id = self.dpb._next_id
        self.dpb._next_id += 1
        self.dpb.pics.append(pic)

    @staticmethod
    def _attach_col_motion(pic: Picture, fs: FrameSymbols) -> None:
        """Save the picture's motion field, which B slices' temporal and
        spatial direct read from their colocated picture
        (decoder.py:345-375)."""
        from .mvpred import ensure_motion_grids
        from .framedata import INTRA_CLASSES, MB_P16x16, MB_PSKIP, MB_B16x16
        ensure_motion_grids(fs)
        pic.col_mv0 = fs.gmv[0].copy()
        pic.col_mv1 = fs.gmv[1].copy()
        pic.col_ref0 = fs.gref[0].copy()
        pic.col_ref1 = fs.gref[1].copy()
        # expand per-quadrant resolved DPB pic ids to the 4x4 grid
        rp = fs.ref_pic.reshape(fs.mb_h, fs.mb_w, 2, 2, 2)
        grids = []
        for lx in range(2):
            g = rp[:, :, lx]  # [mby][mbx][qy][qx]
            g = g.transpose(0, 2, 1, 3).reshape(fs.mb_h * 2, fs.mb_w * 2)
            grids.append(np.repeat(np.repeat(g, 2, axis=0), 2, axis=1))
        pic.col_refpic0, pic.col_refpic1 = grids
        intra_mb = np.isin(fs.mb_type.reshape(fs.mb_h, fs.mb_w),
                           INTRA_CLASSES)
        pic.col_intra = np.repeat(np.repeat(intra_mb, 4, axis=0), 4, axis=1)
        # per-MB 16x16-class for GetColocatedMb's IS_INTER_16x16 test
        # (mv_pred.cpp:341)
        explicit16 = np.isin(fs.mb_type, (MB_P16x16, MB_PSKIP, MB_B16x16))
        pic.col_mb16 = fs.mb16 | explicit16 | intra_mb.reshape(-1)

    @staticmethod
    def _crop(sps, y, u, v):
        w, h = sps.width, sps.height
        cl, ct = 2 * sps.crop_left, 2 * sps.crop_top
        return (y[ct:ct + h, cl:cl + w],
                u[ct // 2:ct // 2 + h // 2, cl // 2:cl // 2 + w // 2],
                v[ct // 2:ct // 2 + h // 2, cl // 2:cl // 2 + w // 2])

    # ------------------------------------------------------------------
    # State carried across processes or devices
    def export_state(self) -> dict:
        """The session's state as numpy arrays and plain values: the
        parameter sets as their raw RBSP bytes, the DPB's pictures with
        their planes, the POC context, the previous decoded picture, and
        what incremental input is still buffered. from_state rebuilds a
        decoder that continues byte for byte."""
        def pic_state(p):
            d = {k: getattr(p, k) for k in _PIC_INTS}
            d["planes"] = [a.copy() for a in p.host]
            for k in _PIC_GRIDS:
                a = getattr(p, k, None)
                d[k] = None if a is None else a.copy()
            return d
        dpb = None
        if self.dpb is not None:
            dpb = {"max_ref": self.dpb.max_ref,
                   "max_frame_num": self.dpb.max_frame_num,
                   "max_long_term_idx": self.dpb.max_long_term_idx,
                   "next_id": self.dpb._next_id,
                   "pics": [pic_state(p) for p in self.dpb.pics]}
        prev = self.prev_decoded
        in_dpb = [i for i, p in enumerate(self.dpb.pics) if p is prev] \
            if (self.dpb is not None and prev is not None) else []
        poc = None if self.poc_ctx is None else {
            k: getattr(self.poc_ctx, k) for k in (
                "prev_poc_msb", "prev_poc_lsb", "prev_frame_num",
                "prev_frame_num_offset")}
        return {
            "sps": [s.raw for s in self.sps_map.values()],
            "subset_sps": [s.raw for s in self.subset_sps_map.values()],
            "pps": [p.raw for p in self.pps_map.values()],
            "active_sps": (None if self.active_sps is None
                           else self.active_sps.raw),
            "dpb": dpb, "poc": poc,
            "prev_decoded": (None if prev is None else
                             {"dpb_index": in_dpb[0]} if in_dpb else
                             pic_state(prev)),
            "ec_mode": self.ec_mode, "cvs_counter": self._cvs_counter,
            "openh264_compat": self.openh264_compat,
            "has_b_slices": self._has_b_slices, "in_buf": self._in_buf,
            "pending": [(n.nal_ref_idc, n.nal_unit_type, n.rbsp, n.svc_ext)
                        for n, _sh, _br in self._pending],
            "reorder_q": [dict(vars(f)) for f in self._reorder_q],
        }

    @classmethod
    def from_state(cls, state: dict, device=DEFAULT_DEVICE) -> "H264Decoder":
        """A decoder on `device` that continues where the exporting one
        stopped (see export_state)."""
        dec = cls(device=device, ec_mode=state["ec_mode"],
                  openh264_compat=state.get("openh264_compat", False))
        for raw in state["sps"]:
            s = parse_sps(raw)
            dec.sps_map[s.sps_id] = s
        for raw in state["subset_sps"]:
            s = parse_sps(raw, is_subset=True)
            dec.subset_sps_map[s.sps_id] = s
        for raw in state["pps"]:
            p = parse_pps(raw, dec.sps_map)
            p.raw = raw
            dec.pps_map[p.pps_id] = p
        if state["active_sps"] is not None:
            dec.active_sps = next(s for s in dec.sps_map.values()
                                  if s.raw == state["active_sps"])
            dec.poc_ctx = PocContext(dec.active_sps)
            for k, v in state["poc"].items():
                setattr(dec.poc_ctx, k, v)

        def pic_of(d):
            host = tuple(a.copy() for a in d["planes"])
            p = Picture(0, *(torch.from_numpy(a).to(dec.device)
                             for a in host), host=host)
            for k in _PIC_INTS:
                setattr(p, k, d[k])
            for k in _PIC_GRIDS:
                if d[k] is not None:
                    setattr(p, k, d[k].copy())
            return p
        if state["dpb"] is not None:
            s = state["dpb"]
            dec.dpb = DPB(1, s["max_frame_num"])
            dec.dpb.max_ref = s["max_ref"]
            dec.dpb.max_long_term_idx = s["max_long_term_idx"]
            dec.dpb._next_id = s["next_id"]
            dec.dpb.pics = [pic_of(d) for d in s["pics"]]
        prev = state["prev_decoded"]
        if prev is not None:
            dec.prev_decoded = (dec.dpb.pics[prev["dpb_index"]]
                                if "dpb_index" in prev else pic_of(prev))
        dec._cvs_counter = state["cvs_counter"]
        dec._has_b_slices = state["has_b_slices"]
        dec._in_buf = state["in_buf"]
        dec._reorder_q = [DecodedFrame(**f) for f in state["reorder_q"]]
        for ref_idc, typ, rbsp, ext in state["pending"]:
            nal = NalUnit(ref_idc, typ, rbsp, ext)
            br = BitReader(rbsp)
            sh = parse_slice_header(br, nal, dec.sps_map, dec.pps_map,
                                    dec.subset_sps_map)
            dec._pending.append((nal, sh, br))
        return dec


# counters of decoder.picture: its MBs by class (framedata mb_type)
_MB_CLASSES = (("skip", (MB_PSKIP, MB_BSKIP)), ("i4x4", (MB_I4x4,)),
               ("i8x8", (MB_I8x8,)), ("i16x16", (MB_I16x16,)),
               ("pcm", (MB_IPCM,)))


def _count_mb_classes(fs: FrameSymbols) -> None:
    """Counts the picture's decoded MBs by class on the open span; every
    decoded MB of no other class is "inter". Besides: "direct" (B_Skip,
    B_Direct_16x16, B_8x8 with a direct sub-MB), "bipred" (a BI
    partition), "t8x8" (transform_size_8x8_flag) and "weighted" (a
    partition predicted with weights other than the default ones)."""
    ok = fs.mb_type >= 0
    t = fs.mb_type[ok]
    rest = len(t)
    for name, types in _MB_CLASSES:
        n = int(np.isin(t, types).sum())
        trace.count(name, n)
        rest -= n
    trace.count("inter", rest)
    direct = np.isin(fs.mb_type, (MB_BSKIP, MB_BDIRECT)) | fs.sub_direct
    trace.count("direct", int((ok & direct).sum()))
    trace.count("bipred", int((ok & (fs.pred_mode == 2).any(1)).sum()))
    trace.count("t8x8", int((ok & fs.transform8).sum()))
    trace.count("weighted", int((ok & _weighted(fs)).sum()))


def _weighted(fs: FrameSymbols) -> np.ndarray:
    """Per MB: whether a partition's prediction takes weights other than
    the default: explicit weights or offsets other than 1 << denom and
    0 for a list it uses, or implicit bi-weights other than 32 / 32."""
    out = np.zeros(fs.n_mb, bool)
    for si, wp in enumerate(fs.wp_by_slice or []):
        if wp is None or wp.mode == WP_NONE:
            continue
        mbs = np.nonzero((fs.slice_id == si) & (fs.mb_type >= 4))[0]
        r = fs.refidx[mbs].astype(np.int64)          # [M, list, quadrant]
        used = r >= 0
        if wp.mode == WP_B_IMPLICIT:
            w0 = np.array([[implicit_weights(wp, a, b)[0] for b in range(32)]
                           for a in range(32)])
            hit = used.all(1) & (w0[r[:, 0].clip(0, 31),
                                    r[:, 1].clip(0, 31)] != 32)
        else:
            odd = np.array([[_explicit_weighted(wp, lx, k) for k in range(32)]
                            for lx in (0, 1)])
            hit = (used & odd[np.arange(2)[None, :, None],
                              r.clip(0, 31)]).any(1)
        out[mbs] = hit.any(1)
    return out


def _explicit_weighted(wp, lx: int, r: int) -> bool:
    return (wp.luma_w(lx, r) != (1 << wp.luma_denom, 0)
            or any(wp.chroma_w(lx, r, c) != (1 << wp.chroma_denom, 0)
                   for c in (0, 1)))


def write_yuv(frames, path):
    with open(path, "wb") as f:
        for fr in frames:
            f.write(fr.y.tobytes())
            f.write(fr.u.tobytes())
            f.write(fr.v.tobytes())
