"""The plain decoder: H.264 access units in, decoded pictures out.

Scope: what the benchmark's streams carry. I and P pictures, CAVLC or
CABAC, one or more slices, no FMO, P pictures predicting from one
reference picture (the previous decoded picture), no weighted
prediction, the deblocking filter as the slice headers set it. Anything
else raises. It decodes one access unit at a time, either from its own
previous picture or, where a check steps from another decoder's state,
from reference planes handed in.
"""

from __future__ import annotations

from dataclasses import dataclass

from .bits import BitReader
from .deblock import deblock_picture
from .framedata import FrameSymbols
from .nal import split_annexb
from .params import parse_pps, parse_sps
from .recon import recon_picture
from .slice_dec import SliceDecodeContext, decode_slice_data_cavlc
from .slice_dec_cabac import decode_slice_data_cabac
from .slicehdr import I_SLICE, P_SLICE, parse_slice_header

NAL_SLICE, NAL_IDR, NAL_SPS, NAL_PPS = 1, 5, 7, 8


@dataclass
class _Ref:
    pic_id: int


class PlainDecoder:
    """deblock=False leaves out the in-loop filter: the benchmark's
    control, which breaks the configurations' deblocking guarantee."""

    def __init__(self, deblock: bool = True):
        self.deblock = deblock
        self.sps_map: dict = {}
        self.pps_map: dict = {}
        self.prev = None          # the last picture's MB-aligned planes

    def decode_au(self, au: bytes, ref=None):
        """The (y, u, v) uint8 planes of one access unit's picture,
        cropped as its SPS says. ref: the reference picture's planes for
        a P picture; by default the previous picture this decoder made."""
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
                sh = parse_slice_header(br, nal, self.sps_map, self.pps_map)
                slices.append((nal, sh, br))
        if not slices:
            raise ValueError("access unit without a slice")
        sh0 = slices[0][1]
        sps = sh0.sps
        if ref is None:
            ref = self.prev
        fs = FrameSymbols(sps.mb_width, sps.mb_height)
        fs.mb_correct[:] = False
        fs.wp_by_slice = []
        for si, (nal, sh, br) in enumerate(slices):
            if sh.slice_type not in (I_SLICE, P_SLICE):
                raise NotImplementedError(f"slice type {sh.slice_type}")
            if sh.pps.num_slice_groups > 1:
                raise NotImplementedError("FMO")
            if sh.slice_type == P_SLICE and sh.pps.weighted_pred:
                raise NotImplementedError("weighted prediction")
            l0 = [_Ref(0)] if sh.slice_type == P_SLICE else []
            fs.wp_by_slice.append(None)
            ctx = SliceDecodeContext(fs, sh, si, ref_list0=l0)
            if sh.pps.entropy_coding_mode:
                decode_slice_data_cabac(nal.rbsp, sh.header_bits, ctx)
            else:
                decode_slice_data_cavlc(br, ctx)
        planes = recon_picture(fs, ref, bool(sh0.pps.constrained_intra_pred))
        if self.deblock:
            planes = deblock_picture(*planes, fs)
        self.prev = planes
        w, h = sps.width, sps.height
        cl, ct = 2 * sps.crop_left, 2 * sps.crop_top
        y, u, v = planes
        return (y[ct:ct + h, cl:cl + w],
                u[ct // 2:ct // 2 + h // 2, cl // 2:cl // 2 + w // 2],
                v[ct // 2:ct // 2 + h // 2, cl // 2:cl // 2 + w // 2])
