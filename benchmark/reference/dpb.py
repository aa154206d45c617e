"""The decoded picture buffer of frames: picture order count (clause
8.2.1), reference picture lists with their initialisation and
modification (8.2.4) and reference marking, by sliding window or by
MMCO (8.2.5).

A frozen copy, for the benchmark's plain reference, of the state code of
the port's decoder/dpb.py (PocContext, list construction and
modification, marking); a Picture here holds numpy planes and the
motion that a later B picture's direct prediction reads from it
(direct.py). Frames only: no fields, no gaps in frame_num.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Picture:
    pic_id: int                 # decode counter, unique in a decoder
    planes: tuple               # (y, u, v) uint8, MB-aligned, deblocked
    frame_num: int = 0
    poc: int = 0
    is_ref: bool = True
    is_long_term: bool = False
    long_term_frame_idx: int = -1
    pic_num: int = 0
    long_term_pic_num: int = 0
    # motion per 4x4 block, for direct prediction (clause 8.4.1.2.1):
    # mv [2, H4, W4, 2], ref_idx [2, H4, W4] (-1: list unused), ref_id
    # [2, H4, W4] (pic_id of the picture referred to), intra [H4, W4]
    mv: np.ndarray = None
    ref_idx: np.ndarray = None
    ref_id: np.ndarray = None
    intra: np.ndarray = None


class DPB:
    def __init__(self, max_ref_frames: int, max_frame_num: int):
        self.max_ref = max(1, max_ref_frames)
        self.max_frame_num = max_frame_num
        self.pics: list[Picture] = []
        self.max_long_term_idx = -1

    def short_term(self):
        return [p for p in self.pics if p.is_ref and not p.is_long_term]

    def long_term(self):
        return [p for p in self.pics if p.is_ref and p.is_long_term]

    def _update_pic_nums(self, cur_frame_num: int):
        """FrameNumWrap as PicNum (8.2.4.1), LongTermPicNum."""
        for p in self.short_term():
            p.pic_num = p.frame_num - (self.max_frame_num
                                       if p.frame_num > cur_frame_num else 0)
        for p in self.long_term():
            p.long_term_pic_num = p.long_term_frame_idx

    def list_p(self, cur_frame_num: int) -> list[Picture]:
        """8.2.4.2.1: short-term by descending PicNum, then long-term by
        ascending LongTermPicNum."""
        self._update_pic_nums(cur_frame_num)
        st = sorted(self.short_term(), key=lambda p: -p.pic_num)
        lt = sorted(self.long_term(), key=lambda p: p.long_term_pic_num)
        return st + lt

    def lists_b(self, cur_poc: int, cur_frame_num: int):
        """8.2.4.2.3: short-term by POC, those before the current
        picture first in list 0 and those after first in list 1, then
        long-term; list 1 with its first two entries switched where it
        equals list 0 and has more than one."""
        self._update_pic_nums(cur_frame_num)
        st = self.short_term()
        before = sorted([p for p in st if p.poc < cur_poc],
                        key=lambda p: -p.poc)
        after = sorted([p for p in st if p.poc > cur_poc],
                       key=lambda p: p.poc)
        lt = sorted(self.long_term(), key=lambda p: p.long_term_pic_num)
        l0 = before + after + lt
        l1 = after + before + lt
        if len(l1) > 1 and l0 == l1:
            l1 = [l1[1], l1[0]] + l1[2:]
        return l0, l1

    def modify(self, lst: list, mods, cur_frame_num: int,
               num_active: int) -> list:
        """8.2.4.3: the initial list cut to num_active entries (None
        where the buffer holds fewer), then each modification inserts
        its picture at the next index and drops its later duplicate."""
        L = lst[:num_active] + [None] * max(0, num_active - len(lst))
        pred = cur_frame_num
        idx = 0
        for op, val in mods:
            if op in (0, 1):
                if op == 0:
                    pred = pred - (val + 1)
                    if pred < 0:
                        pred += self.max_frame_num
                else:
                    pred = pred + (val + 1)
                    if pred >= self.max_frame_num:
                        pred -= self.max_frame_num
                pic_num = pred - (self.max_frame_num
                                  if pred > cur_frame_num else 0)
                target = next((p for p in self.short_term()
                               if p.pic_num == pic_num), None)
                lt = False
            else:
                target = next((p for p in self.long_term()
                               if p.long_term_pic_num == val), None)
                lt = True
            if target is None:
                raise ValueError("ref_pic_list_modification names no "
                                 "reference picture")
            L.insert(idx, target)
            idx += 1
            tail = [p for p in L[idx:]
                    if not (p is not None and p.is_long_term == lt
                            and p is target)]
            L = (L[:idx] + tail)[:num_active]
        return L

    def store(self, pic: Picture, sh, is_idr: bool) -> None:
        """8.2.5: marks the decoded picture and the buffer's; a picture
        that is no reference leaves the buffer (output is the caller's)."""
        if is_idr:
            self.pics.clear()
            self.max_long_term_idx = -1
            if sh.long_term_reference_flag:
                pic.is_long_term = True
                pic.long_term_frame_idx = 0
                self.max_long_term_idx = 0
            self.pics.append(pic)
            return
        if not pic.is_ref:
            return
        if sh.adaptive_ref_pic_marking:
            self._mmco(pic, sh.mmco_ops, sh.frame_num)
        else:
            st = self.short_term()
            if st and len(st) + len(self.long_term()) >= self.max_ref:
                self._update_pic_nums(sh.frame_num)
                min(st, key=lambda p: p.pic_num).is_ref = False
        self.pics.append(pic)
        self.pics = [p for p in self.pics if p.is_ref]

    def _mmco(self, cur: Picture, ops, cur_frame_num: int) -> None:
        self._update_pic_nums(cur_frame_num)
        for op, a, b in ops:
            if op == 1:
                for p in self.short_term():
                    if p.pic_num == cur_frame_num - (a + 1):
                        p.is_ref = False
            elif op == 2:
                for p in self.long_term():
                    if p.long_term_pic_num == a:
                        p.is_ref = False
            elif op == 3:
                for p in self.long_term():
                    if p.long_term_frame_idx == b:
                        p.is_ref = False
                for p in self.short_term():
                    if p.pic_num == cur_frame_num - (a + 1):
                        p.is_long_term = True
                        p.long_term_frame_idx = b
            elif op == 4:
                self.max_long_term_idx = a - 1
                for p in self.long_term():
                    if p.long_term_frame_idx > self.max_long_term_idx:
                        p.is_ref = False
            elif op == 5:
                raise NotImplementedError("memory_management_control_"
                                          "operation 5")
            elif op == 6:
                for p in self.long_term():
                    if p.long_term_frame_idx == b:
                        p.is_ref = False
                cur.is_long_term = True
                cur.long_term_frame_idx = b
        self.pics = [p for p in self.pics if p.is_ref]


class PocContext:
    """Picture order count of frames (8.2.1), types 0, 1 and 2."""

    def __init__(self, sps):
        self.sps = sps
        self.prev_msb = self.prev_lsb = 0
        self.prev_frame_num = self.prev_offset = 0

    def compute(self, sh, is_ref: bool) -> int:
        sps = self.sps
        if sps.pic_order_cnt_type == 0:
            max_lsb = 1 << sps.log2_max_pic_order_cnt_lsb
            if sh.is_idr:
                self.prev_msb = self.prev_lsb = 0
            lsb = sh.pic_order_cnt_lsb
            if lsb < self.prev_lsb and self.prev_lsb - lsb >= max_lsb // 2:
                msb = self.prev_msb + max_lsb
            elif lsb > self.prev_lsb and lsb - self.prev_lsb > max_lsb // 2:
                msb = self.prev_msb - max_lsb
            else:
                msb = self.prev_msb
            if is_ref:
                self.prev_msb, self.prev_lsb = msb, lsb
            return msb + lsb + min(0, sh.delta_pic_order_cnt_bottom)
        max_fn = 1 << sps.log2_max_frame_num
        if sh.is_idr:
            offset = 0
        elif self.prev_frame_num > sh.frame_num:
            offset = self.prev_offset + max_fn
        else:
            offset = self.prev_offset
        self.prev_offset, self.prev_frame_num = offset, sh.frame_num
        abs_fn = offset + sh.frame_num
        if sps.pic_order_cnt_type == 2:
            return 2 * abs_fn - (0 if is_ref else 1)
        n = len(sps.offset_for_ref_frame)
        if not is_ref and abs_fn > 0:
            abs_fn -= 1
        expected = 0
        if abs_fn > 0 and n:
            cycle, in_cycle = divmod(abs_fn - 1, n)
            expected = cycle * sum(sps.offset_for_ref_frame) + sum(
                sps.offset_for_ref_frame[:in_cycle + 1])
        if not is_ref:
            expected += sps.offset_for_non_ref_pic
        top = expected + sh.delta_pic_order_cnt[0]
        bottom = top + sps.offset_for_top_to_bottom_field \
            + sh.delta_pic_order_cnt[1]
        return min(top, bottom)
