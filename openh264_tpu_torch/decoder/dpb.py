"""Decoded picture buffer + reference list management (§8.2.4/8.2.5).

Parity anchor: codec/decoder/core/src/manage_dec_ref.cpp
(WelsInitRefList:359, WelsReorderRefList:385, WelsMarkAsRef:585,
MMCO:664, SlidingWindow:763). Pure-host state machine (SURVEY.md §7
"DPB state machine: keep on host").

Copied from openh264_tpu/decoder/dpb.py. A Picture of this package
holds its planes as uint8 tensors on the decoder's device, which the
motion compensation of recon_batch.py reads in place; `host` carries the
same planes as numpy arrays once the decoder has fetched them (for
output and error concealment), so that they are fetched once.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Picture:
    pic_id: int           # monotonically increasing decode counter
    y: torch.Tensor       # planes on the decoder's device
    u: torch.Tensor
    v: torch.Tensor
    frame_num: int = 0
    poc: int = 0
    is_ref: bool = False
    is_long_term: bool = False
    long_term_frame_idx: int = -1
    is_idr: bool = False
    # derived per current picture during list construction:
    pic_num: int = 0
    long_term_pic_num: int = 0
    # colocated motion info for B temporal/spatial direct (4x4 grids)
    col_mv0: np.ndarray = None
    col_mv1: np.ndarray = None
    col_ref0: np.ndarray = None
    col_ref1: np.ndarray = None
    col_refpic0: np.ndarray = None
    col_refpic1: np.ndarray = None
    col_intra: np.ndarray = None
    # the planes as host numpy arrays (y, u, v), once fetched
    host: tuple = None


class DPB:
    def __init__(self, max_ref_frames: int, max_frame_num: int):
        self.max_ref = max(1, max_ref_frames)
        self.max_frame_num = max_frame_num
        self.pics: list[Picture] = []
        self.max_long_term_idx = -1  # MMCO4 controlled
        self._next_id = 0

    # ---- helpers ----
    def short_term(self):
        return [p for p in self.pics if p.is_ref and not p.is_long_term]

    def long_term(self):
        return [p for p in self.pics if p.is_ref and p.is_long_term]

    def _update_pic_nums(self, cur_frame_num: int):
        for p in self.short_term():
            fnw = p.frame_num
            if fnw > cur_frame_num:
                fnw -= self.max_frame_num
            p.pic_num = fnw
        for p in self.long_term():
            p.long_term_pic_num = p.long_term_frame_idx

    # ---- reference list construction ----
    def build_list_p(self, cur_frame_num: int) -> list[Picture]:
        self._update_pic_nums(cur_frame_num)
        st = sorted(self.short_term(), key=lambda p: -p.pic_num)
        lt = sorted(self.long_term(), key=lambda p: p.long_term_pic_num)
        return st + lt

    def build_lists_b(self, cur_poc: int, cur_frame_num: int):
        self._update_pic_nums(cur_frame_num)
        st = self.short_term()
        before = sorted([p for p in st if p.poc < cur_poc], key=lambda p: -p.poc)
        after = sorted([p for p in st if p.poc > cur_poc], key=lambda p: p.poc)
        lt = sorted(self.long_term(), key=lambda p: p.long_term_pic_num)
        l0 = before + after + lt
        l1 = after + before + lt
        if len(l1) > 1 and l0 == l1:  # §8.2.4.2.3 final swap rule
            l1 = [l1[1], l1[0]] + l1[2:]
        return l0, l1

    def reorder_list(self, lst: list[Picture], mods, cur_frame_num: int,
                     num_active: int) -> list[Picture]:
        """§8.2.4.3 ref_pic_list_modification — the exact spec shifting
        algorithm. The same picture may legitimately appear MULTIPLE
        times in the final list (e.g. mods that name one picNum twice);
        entries may be None when the DPB holds fewer refs than
        num_active (callers clamp such ref_idx to 0 like the reference's
        EC path). Parity: manage_dec_ref.cpp WelsReorderRefList:385."""
        L: list = lst[:num_active]
        if not mods:
            return L
        while len(L) < num_active:
            L.append(None)
        max_pic_num = self.max_frame_num  # frame coding: MaxPicNum == MaxFrameNum
        pred = cur_frame_num              # CurrPicNum
        ref_idx = 0
        for op, val in mods:
            if op in (0, 1):
                diff = val + 1
                # §8.2.4.3.1 picNumLXNoWrap with explicit wraparound
                if op == 0:
                    no_wrap = pred - diff
                    if no_wrap < 0:
                        no_wrap += max_pic_num
                else:
                    no_wrap = pred + diff
                    if no_wrap >= max_pic_num:
                        no_wrap -= max_pic_num
                pred = no_wrap
                pic_num = no_wrap - (max_pic_num if no_wrap > cur_frame_num else 0)
                target = None
                for p in self.short_term():
                    if p.pic_num == pic_num:
                        target = p
                        break
                if target is None:
                    continue

                def same(p, t=target):
                    return (p is not None and p.is_ref and not p.is_long_term
                            and p.pic_num == t.pic_num)
            else:  # op == 2: long-term
                target = None
                for p in self.long_term():
                    if p.long_term_pic_num == val:
                        target = p
                        break
                if target is None:
                    continue

                def same(p, t=target):
                    return (p is not None and p.is_ref and p.is_long_term
                            and p.long_term_pic_num == t.long_term_pic_num)
            # §8.2.4.3.1/.2: insert at ref_idx (list temporarily
            # num_active+1 long), then drop later entries matching the
            # target's pic num, then truncate back to num_active
            L.insert(ref_idx, target)
            ref_idx += 1
            tail = [p for p in L[ref_idx:] if not same(p)]
            L = (L[:ref_idx] + tail)[:num_active]
        return L

    # ---- marking ----
    def store_picture(self, pic: Picture, sh) -> None:
        """Apply dec_ref_pic_marking for the just-decoded picture and
        insert it (§8.2.5)."""
        pic.pic_id = self._next_id
        self._next_id += 1
        if pic.is_idr:
            self.pics.clear()
            self.max_long_term_idx = -1
            if sh is not None and sh.long_term_reference_flag:
                pic.is_long_term = True
                pic.long_term_frame_idx = 0
                self.max_long_term_idx = 0
            pic.is_ref = True
            self.pics.append(pic)
            return
        if pic.is_ref and sh is not None and sh.adaptive_ref_pic_marking:
            self._apply_mmco(pic, sh.mmco_ops, sh.frame_num)
        elif pic.is_ref:
            # sliding window (§8.2.5.3)
            while len(self.short_term()) + len(self.long_term()) >= self.max_ref:
                st = self.short_term()
                if not st:
                    break
                self._update_pic_nums(sh.frame_num if sh else pic.frame_num)
                oldest = min(st, key=lambda p: p.pic_num)
                oldest.is_ref = False
        self.pics.append(pic)
        self._gc()

    def _apply_mmco(self, cur: Picture, ops, cur_frame_num: int) -> None:
        self._update_pic_nums(cur_frame_num)
        cur_pic_num = cur_frame_num
        for (op, a, b) in ops:
            if op == 1:
                pic_num_x = cur_pic_num - (a + 1)
                for p in self.short_term():
                    if p.pic_num == pic_num_x:
                        p.is_ref = False
                        break
            elif op == 2:
                for p in self.long_term():
                    if p.long_term_pic_num == a:
                        p.is_ref = False
                        break
            elif op == 3:
                pic_num_x = cur_pic_num - (a + 1)
                for p in self.long_term():
                    if p.long_term_frame_idx == b:
                        p.is_ref = False
                for p in self.short_term():
                    if p.pic_num == pic_num_x:
                        p.is_long_term = True
                        p.long_term_frame_idx = b
                        break
            elif op == 4:
                self.max_long_term_idx = a - 1
                for p in self.long_term():
                    if p.long_term_frame_idx > self.max_long_term_idx:
                        p.is_ref = False
            elif op == 5:
                for p in self.pics:
                    p.is_ref = False
                self.max_long_term_idx = -1
                cur.frame_num = 0
                cur.poc = 0
            elif op == 6:
                for p in self.long_term():
                    if p.long_term_frame_idx == b:
                        p.is_ref = False
                cur.is_long_term = True
                cur.long_term_frame_idx = b
        self._gc()

    def _gc(self):
        """Drop pictures that are neither refs nor pending output.
        (Output is immediate in the current decode loop, so non-refs go.)"""
        self.pics = [p for p in self.pics if p.is_ref]


class PocContext:
    """Picture order count computation (§8.2.1)."""

    def __init__(self, sps):
        self.sps = sps
        self.prev_poc_msb = 0
        self.prev_poc_lsb = 0
        self.prev_frame_num = 0
        self.prev_frame_num_offset = 0

    def compute(self, sh, nal_ref_idc: int, mmco5: bool = False) -> int:
        sps = self.sps
        if sps.pic_order_cnt_type == 0:
            max_lsb = 1 << sps.log2_max_pic_order_cnt_lsb
            if sh.is_idr:
                self.prev_poc_msb = 0
                self.prev_poc_lsb = 0
            lsb = sh.pic_order_cnt_lsb
            if lsb < self.prev_poc_lsb and \
               (self.prev_poc_lsb - lsb) >= max_lsb // 2:
                msb = self.prev_poc_msb + max_lsb
            elif lsb > self.prev_poc_lsb and \
                 (lsb - self.prev_poc_lsb) > max_lsb // 2:
                msb = self.prev_poc_msb - max_lsb
            else:
                msb = self.prev_poc_msb
            poc = msb + lsb
            if nal_ref_idc:
                self.prev_poc_msb = msb
                self.prev_poc_lsb = lsb
            return poc
        max_frame_num = 1 << sps.log2_max_frame_num
        if sh.is_idr:
            frame_num_offset = 0
        elif self.prev_frame_num > sh.frame_num:
            frame_num_offset = self.prev_frame_num_offset + max_frame_num
        else:
            frame_num_offset = self.prev_frame_num_offset
        self.prev_frame_num_offset = frame_num_offset
        self.prev_frame_num = sh.frame_num
        abs_frame_num = frame_num_offset + sh.frame_num
        if sps.pic_order_cnt_type == 2:
            poc = 2 * abs_frame_num
            if not nal_ref_idc:
                poc -= 1
            return poc
        # type 1
        n_ref = len(sps.offset_for_ref_frame)
        if not nal_ref_idc and abs_frame_num > 0:
            abs_frame_num -= 1
        expected = 0
        if abs_frame_num > 0 and n_ref > 0:
            cycle = (abs_frame_num - 1) // n_ref
            in_cycle = (abs_frame_num - 1) % n_ref
            expected = cycle * sum(sps.offset_for_ref_frame)
            for i in range(in_cycle + 1):
                expected += sps.offset_for_ref_frame[i]
        if not nal_ref_idc:
            expected += sps.offset_for_non_ref_pic
        return expected + sh.delta_pic_order_cnt[0]
