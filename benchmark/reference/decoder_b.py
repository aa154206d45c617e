"""The plain decoder of chains from an IDR: I, P and B pictures with
several reference pictures, for the streams that x264 writes.

Scope: frames (frame_mbs_only), CABAC, one or more slices, no FMO, POC
types 0-2, reference lists with their modification, marking by sliding
window or by MMCO 1-4 and 6, spatial and temporal direct, explicit and
implicit weights, the 8x8 transform, the deblocking filter as the slice
headers set it. CAVLC B slices and MMCO 5 raise NotImplementedError.
Unlike decoder.PlainDecoder it never steps from another decoder's
picture: a chain starts at an IDR, and each picture comes out with its
POC, so that pictures are matched by POC rather than by call.

Its departures from the port's decoder, each to follow clause 8: a B
16x8 or 8x16 MB predicts each bi-predicted partition from both lists
(8.4.2); implicit weights come from the final lists (8.4.2.3.1); the
deblocking filter takes the bS rules of 8.7.2.1 on every edge of skipped
and direct MBs; a temporal-direct block whose colocated block uses list
1 maps that block's reference into list 0 (8.4.1.2.3).
"""

from __future__ import annotations

import numpy as np

from .bits import BitReader
from .deblock import deblock_picture
from .direct import DirectContext
from .dpb import DPB, Picture, PocContext
from .framedata import INTRA_CLASSES, FrameSymbols
from .inter_b import SliceRefs, recon_picture_b
from .nal import split_annexb
from .params import parse_pps, parse_sps
from .slice_dec import SliceDecodeContext
from .slice_dec_cabac_b import decode_slice_data_cabac_b
from .slicehdr import B_SLICE, P_SLICE, parse_slice_header

NAL_SLICE, NAL_IDR, NAL_SPS, NAL_PPS = 1, 5, 7, 8


class ChainDecoder:
    """deblock=False leaves out the in-loop filter: the control."""

    def __init__(self, deblock: bool = True):
        self.deblock = deblock
        self.sps_map: dict = {}
        self.pps_map: dict = {}
        self.dpb: DPB | None = None
        self.poc_ctx: PocContext | None = None
        self._ids = 0

    def decode_au(self, au: bytes):
        """(poc, (y, u, v)) of one access unit's picture, the planes
        cropped as its SPS says."""
        slices = []
        for nal in split_annexb(au):
            t = nal.nal_unit_type
            if t == NAL_SPS:
                sps = parse_sps(nal.rbsp)
                self.sps_map[sps.sps_id] = sps
            elif t == NAL_PPS:
                pps = parse_pps(nal.rbsp, self.sps_map)
                self.pps_map[pps.pps_id] = pps
            elif t in (NAL_SLICE, NAL_IDR):
                br = BitReader(nal.rbsp)
                slices.append((nal, parse_slice_header(
                    br, nal, self.sps_map, self.pps_map)))
        if not slices:
            raise ValueError("access unit without a slice")
        nal0, sh0 = slices[0]
        sps = sh0.sps
        if not sps.frame_mbs_only:
            raise NotImplementedError("field coding")
        if sh0.is_idr:
            self.dpb = DPB(sps.max_num_ref_frames, 1 << sps.log2_max_frame_num)
            self.poc_ctx = PocContext(sps)
        elif self.dpb is None:
            raise ValueError("a chain starts at an IDR")
        is_ref = nal0.nal_ref_idc != 0
        poc = self.poc_ctx.compute(sh0, is_ref)
        fs = FrameSymbols(sps.mb_width, sps.mb_height)
        fs.mb_correct[:] = False
        refs, pics = [], {}
        for si, (nal, sh) in enumerate(slices):
            if sh.pps.num_slice_groups > 1:
                raise NotImplementedError("FMO")
            if not sh.pps.entropy_coding_mode:
                raise NotImplementedError("CAVLC slices")
            l0 = l1 = []
            if sh.slice_type == P_SLICE:
                l0 = self.dpb.modify(self.dpb.list_p(sh.frame_num),
                                     sh.ref_pic_list_modification[0],
                                     sh.frame_num, sh.num_ref_idx_l0_active)
            elif sh.slice_type == B_SLICE:
                i0, i1 = self.dpb.lists_b(poc, sh.frame_num)
                mods = sh.ref_pic_list_modification
                l0 = self.dpb.modify(i0, mods[0], sh.frame_num,
                                     sh.num_ref_idx_l0_active)
                l1 = self.dpb.modify(i1, mods[1], sh.frame_num,
                                     sh.num_ref_idx_l1_active)
            for p in l0 + l1:
                if p is not None:
                    pics[p.pic_id] = p
            ctx = SliceDecodeContext(fs, sh, si, ref_list0=l0, ref_list1=l1,
                                     poc=poc)
            if sh.slice_type == B_SLICE:
                if l1[0] is None:
                    raise ValueError("B slice without RefPicList1[0]")
                ctx.direct = DirectContext(sh, l0, l1, poc)
            decode_slice_data_cabac_b(nal.rbsp, sh.header_bits, ctx)
            refs.append(SliceRefs(sh, l0, l1, poc))
        planes = recon_picture_b(fs, pics, refs,
                                 bool(sh0.pps.constrained_intra_pred))
        if self.deblock:
            planes = deblock_picture(*planes, fs)
        pic = Picture(self._ids, planes, sh0.frame_num, poc, is_ref)
        self._ids += 1
        _keep_motion(pic, fs)
        self.dpb.store(pic, sh0, sh0.is_idr)
        w, h = sps.width, sps.height
        cl, ct = 2 * sps.crop_left, 2 * sps.crop_top
        y, u, v = planes
        return poc, (y[ct:ct + h, cl:cl + w],
                     u[ct // 2:ct // 2 + h // 2, cl // 2:cl // 2 + w // 2],
                     v[ct // 2:ct // 2 + h // 2, cl // 2:cl // 2 + w // 2])


def _keep_motion(pic: Picture, fs: FrameSymbols) -> None:
    """The picture's motion per 4x4 block, as a later B picture's direct
    prediction reads it from its colocated picture (8.4.1.2.1)."""
    h4, w4 = fs.mb_h * 4, fs.mb_w * 4

    def grid(per_quadrant):          # [n, 4] -> [h4, w4]
        g = per_quadrant.reshape(fs.mb_h, fs.mb_w, 2, 2)
        g = g.transpose(0, 2, 1, 3).reshape(fs.mb_h * 2, fs.mb_w * 2)
        return np.repeat(np.repeat(g, 2, 0), 2, 1)
    pic.mv = np.stack([fs.mv[:, lx].reshape(fs.mb_h, fs.mb_w, 4, 4, 2)
                       .transpose(0, 2, 1, 3, 4).reshape(h4, w4, 2)
                       for lx in (0, 1)])
    pic.ref_idx = np.stack([grid(fs.refidx[:, lx].astype(np.int32))
                            for lx in (0, 1)])
    pic.ref_id = np.stack([grid(fs.ref_pic[:, lx]) for lx in (0, 1)])
    intra = np.isin(fs.mb_type, INTRA_CLASSES).reshape(fs.mb_h, fs.mb_w)
    pic.intra = np.repeat(np.repeat(intra, 4, 0), 4, 1)
    pic.ref_idx[:, pic.intra] = -1

