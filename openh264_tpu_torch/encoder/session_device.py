"""Device-resident encoder session in PyTorch: the port's main path.

Port of openh264_tpu/encoder/session_device.py, byte-identical with it.
Per frame the device runs

  input frame (one upload) -> P/I core -> CAVLC tokenize -> bit pack ->
  deblock -> reference planes stay on the device

and the only per-frame download is the packed slice body, fetched in
batches of several frames. The host writes the slice headers, the NAL
framing and emulation prevention, and runs rate control.

Feature matrix (as the JAX session): CAVLC; constant QP or frame-level
rate control (modes 0/1/2) with the bits feedback lagging by up to
`fetch_batch` frames; dyadic temporal layers 1..4 with a device-resident
mini-DPB; multi-slice row bands (one full-frame core pass, per-band
tokenize + pack, one frame-wide deblock); deblock idc 0/1/2; repack of
an overflowing slice body into a doubled buffer; intra-in-P.

On a CUDA device the deblock runs as the hand-written Hopper kernel
(deblock_cuda.py); on the CPU it runs as its plain version. Every entry
point takes `device`, "cuda" by default, and raises without a GPU.
Uploads use pinned host buffers and non-blocking copies on CUDA.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ..bitstream import BitWriter, make_annexb_nal, NAL_SPS, NAL_PPS, \
    NAL_IDR, NAL_SLICE
from ..device import resolve_device
from ..tables import CHROMA_QP_TABLE
from . import core_torch, entropy_torch, deblock_torch
from .headers import write_pps, write_slice_header, write_sps
from .ratectl import RateControl, RC_OFF_MODE

MAX_BYTES = 1 << 17          # 128 KB packed body per slice (default)
MAX_TOK = 1 << 18
I32 = torch.int32


def _p_symbols(y, u, v, ry, ru, rv, prev_skip_sad, prev_skip, qp, qp_c,
               mb_w, mb_h, sr, intra_in_p, intra_allowed=None):
    """P core + intra-in-P fold. Returns (sym, rec_y, rec_u, rec_v,
    skip_sad, skip_mask); recon is pre-deblock."""
    n_mb = mb_w * mb_h
    dev = y.device
    out = core_torch.encode_p_frame(y, u, v, ry, ru, rv, qp, qp_c,
                                    mb_w=mb_w, mb_h=mb_h, sr=sr,
                                    prev_skip_sad=prev_skip_sad,
                                    prev_skip=prev_skip)
    if intra_in_p:
        lam = max(qp - 12, 1)
        raw = (out["intra_cost_proxy"] + 8 * lam) < out["inter_cost"]
        raw = raw & ~out["skip_mask"]     # promoted skips stay inter
        if intra_allowed is not None:
            raw = raw & intra_allowed
        intra_mask = core_torch.chainfree_intra_mask(raw, mb_w, mb_h)
        iout = core_torch.encode_i16_flat(
            y, u, v, qp, qp_c, mb_w=mb_w, mb_h=mb_h, intra_mask=intra_mask,
            init_recon=(out["recon_y"], out["recon_u"], out["recon_v"]))
        m = intra_mask
        rec_y, rec_u, rec_v = (iout["recon_y"], iout["recon_u"],
                               iout["recon_v"])
        luma_ac = torch.where(m[:, None, None], iout["luma_ac"],
                              out["luma_ac"])
        chroma_dc = torch.where(m[:, None, None], iout["chroma_dc"],
                                out["chroma_dc"])
        chroma_ac = torch.where(m[:, None, None, None], iout["chroma_ac"],
                                out["chroma_ac"])
        i16_mode, chroma_mode, luma_dc = (iout["i16_mode"],
                                          iout["chroma_mode"],
                                          iout["luma_dc"])
    else:
        intra_mask = torch.zeros(n_mb, dtype=torch.bool, device=dev)
        rec_y, rec_u, rec_v = (out["recon_y"], out["recon_u"],
                               out["recon_v"])
        luma_ac, chroma_dc, chroma_ac = (out["luma_ac"], out["chroma_dc"],
                                         out["chroma_ac"])
        i16_mode = torch.zeros(n_mb, dtype=I32, device=dev)
        chroma_mode = torch.zeros(n_mb, dtype=I32, device=dev)
        luma_dc = torch.zeros((n_mb, 4, 4), dtype=I32, device=dev)

    sym = {"mv": out["mv"], "luma_ac": luma_ac, "chroma_dc": chroma_dc,
           "chroma_ac": chroma_ac, "intra_mask": intra_mask,
           "i16_mode": i16_mode, "chroma_mode": chroma_mode,
           "luma_dc": luma_dc}
    return sym, rec_y, rec_u, rec_v, out["skip_sad"], out["skip_mask"]


def _deblock_ms(rec_y, rec_u, rec_v, nz, intra_mask, mv, qp, qp_c,
                mb_w, mb_h, zero_bsh_rows=()):
    """bS from the frame's symbols, then the frame-wide in-loop filter.
    zero_bsh_rows: band-top MB rows whose horizontal MB edge must NOT be
    filtered (deblock idc 2 = on except slice boundaries)."""
    n_mb = mb_w * mb_h
    dev = rec_y.device
    BSV, BSH = deblock_torch.encoder_bs(nz, intra_mask, mv, mb_w, mb_h)
    for r in zero_bsh_rows:
        BSH[4 * r, :] = 0
    qp_mb = torch.full((n_mb,), qp, dtype=I32, device=dev)
    cqp_mb = torch.full((n_mb,), qp_c, dtype=I32, device=dev)
    # on CUDA the recon planes are filtered in place: every caller drops
    # its pre-deblock recon for the planes returned here
    return deblock_torch.deblock_frame_auto(
        rec_y.contiguous(), rec_u.contiguous(), rec_v.contiguous(), BSV, BSH,
        qp_mb, cqp_mb, mb_w, mb_h)


def _nz_blocks(luma_ac, n_mb):
    return luma_ac.reshape(n_mb, 16, 16).bool().any(2)


def _step_i(y, u, v, qp, qp_c, start_bit, mb_w, mb_h, do_deblock,
            max_bytes=MAX_BYTES):
    n_mb = mb_w * mb_h
    dev = y.device
    out = core_torch.encode_i_frame(y, u, v, qp, qp_c, mb_w=mb_w, mb_h=mb_h)
    av, al = entropy_torch.i_slice_tokens(out, mb_w, mb_h)
    packed, nbits, ovf = entropy_torch.pack_tokens_device(
        av, al, start_bit, max_bytes)
    ry, ru, rv = out["recon_y"], out["recon_u"], out["recon_v"]
    if do_deblock:
        ry, ru, rv = _deblock_ms(
            ry, ru, rv, _nz_blocks(out["luma_ac"], n_mb),
            torch.ones(n_mb, dtype=torch.bool, device=dev),
            torch.zeros((n_mb, 2), dtype=I32, device=dev), qp, qp_c,
            mb_w, mb_h)
    return packed, nbits, ovf, ry, ru, rv, av, al


def _step_p(y, u, v, ry, ru, rv, prev_skip_sad, prev_skip,
            qp, qp_c, start_bit, mb_w, mb_h, sr, do_deblock, intra_in_p,
            max_bytes=MAX_BYTES):
    n_mb = mb_w * mb_h
    sym, rec_y, rec_u, rec_v, skip_sad, skip_mask = _p_symbols(
        y, u, v, ry, ru, rv, prev_skip_sad, prev_skip, qp, qp_c,
        mb_w, mb_h, sr, intra_in_p)
    av, al = entropy_torch.p_slice_tokens(sym, mb_w, mb_h)
    packed, nbits, ovf = entropy_torch.pack_tokens_device(
        av, al, start_bit, max_bytes)
    if do_deblock:
        rec_y, rec_u, rec_v = _deblock_ms(
            rec_y, rec_u, rec_v, _nz_blocks(sym["luma_ac"], n_mb),
            sym["intra_mask"], sym["mv"], qp, qp_c, mb_w, mb_h)
    return (packed, nbits, ovf, rec_y, rec_u, rec_v,
            skip_sad, skip_mask, av, al)


# ---------------------------------------------------------------------------
# Multi-slice steps: one full-frame core, per-band entropy, frame deblock
# ---------------------------------------------------------------------------
def _step_p_ms(y, u, v, ry, ru, rv, prev_skip_sad, prev_skip, qp, qp_c,
               intra_allowed, idx, n_valid, start_bits,
               mb_w, mb_h, sr, intra_in_p, B, n_bands, max_bytes,
               do_deblock, zero_bsh_rows):
    """Multi-slice P step: full-frame core + per-band entropy +
    frame-wide deblock."""
    n_mb = mb_w * mb_h
    sym, rec_y, rec_u, rec_v, skip_sad, skip_mask = _p_symbols(
        y, u, v, ry, ru, rv, prev_skip_sad, prev_skip, qp, qp_c,
        mb_w, mb_h, sr, intra_in_p, intra_allowed=intra_allowed)
    packed, nbits, ovf, av, al = _tok_p_bands(
        sym, idx, n_valid, start_bits, mb_w, B, n_bands, max_bytes)
    if do_deblock:
        rec_y, rec_u, rec_v = _deblock_ms(
            rec_y, rec_u, rec_v, _nz_blocks(sym["luma_ac"], n_mb),
            sym["intra_mask"], sym["mv"], qp, qp_c, mb_w, mb_h,
            zero_bsh_rows)
    return (packed, nbits, ovf, av, al, rec_y, rec_u, rec_v,
            skip_sad, skip_mask)


def _tok_p_bands(sym, idx, n_valid, start_bits, mb_w, B, n_bands,
                 max_bytes):
    """Tokenize + pack every slice band of a P frame. Entropy contexts
    (nC, MVP, skip runs) are band-local: each band grid has no rows above
    its own top, which is H.264 slice availability. Unequal band heights
    are padded to B rows; n_valid ([n_bands] tensor) masks the padding
    out of each band's token stream. The band axis of the JAX vmap is a
    batch axis of the tokenizer; each band is packed on its own."""
    flat = idx.reshape(-1)
    bsym = {k: a[flat].reshape((n_bands, B * mb_w) + a.shape[1:])
            for k, a in sym.items()}
    av, al = entropy_torch.p_slice_tokens_bands(bsym, mb_w, B,
                                                n_valid=n_valid)
    packs = [entropy_torch.pack_tokens_device(av[i], al[i], start_bits[i],
                                              max_bytes)
             for i in range(n_bands)]
    packed, nbits, ovf = (torch.stack(t) for t in zip(*packs))
    return packed, nbits, ovf, av, al


def _step_i_band(y, u, v, qp, qp_c, start_bit, r0, mb_w, band_h, max_bytes):
    """One IDR slice band: band-local intra core (slice availability)
    + tokenize + pack. Returns band recon (pre-deblock) + nz for bS."""
    yb = y[r0 * 16:(r0 + band_h) * 16]
    ub = u[r0 * 8:(r0 + band_h) * 8]
    vb = v[r0 * 8:(r0 + band_h) * 8]
    out = core_torch.encode_i_frame(yb, ub, vb, qp, qp_c,
                                    mb_w=mb_w, mb_h=band_h)
    av, al = entropy_torch.i_slice_tokens(out, mb_w, band_h)
    packed, nbits, ovf = entropy_torch.pack_tokens_device(
        av, al, start_bit, max_bytes)
    nz = _nz_blocks(out["luma_ac"], band_h * mb_w)
    return (packed, nbits, ovf, out["recon_y"], out["recon_u"],
            out["recon_v"], nz, av, al)


def _split_frame(buf, h, w):
    """One packed uploaded buffer -> (y, u, v) planes (views)."""
    y = buf[:h * w].reshape(h, w)
    cs = (h // 2) * (w // 2)
    u = buf[h * w:h * w + cs].reshape(h // 2, w // 2)
    v = buf[h * w + cs:h * w + 2 * cs].reshape(h // 2, w // 2)
    return y, u, v


def _pack_frame(y, u, v) -> np.ndarray:
    return np.concatenate([np.asarray(y, np.uint8).ravel(),
                           np.asarray(u, np.uint8).ravel(),
                           np.asarray(v, np.uint8).ravel()])


@dataclass
class _DevRef:
    """Device-resident DPB record (planes never leave the device)."""
    frame_num: int
    coding_idx: int
    temporal_id: int
    planes: tuple          # (y, u, v) deblocked recon, device tensors
    skip_sad: torch.Tensor  # [n_mb] int32 luma skip SAD (zeros after IDR)
    skip_map: torch.Tensor  # [n_mb] bool skip flags


class DeviceSessionEncoder:
    """CAVLC encoder with the whole per-frame pipeline on the device.

    Use `encode_stream(frames)` for pipelined throughput (uploads run in
    a background thread, packed bodies are fetched in batches), or
    `encode_frame` for the one-frame-in / bytes-out contract.
    """

    def __init__(self, cfg, fetch_batch: int = 8,
                 max_body_bytes: int = MAX_BYTES, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        if cfg.entropy_cabac:
            raise ValueError("DeviceSessionEncoder: CAVLC only")
        if not (1 <= cfg.temporal_layers <= 4):
            raise ValueError("temporal_layers must be 1..4")
        if cfg.temporal_layers > 1:
            cfg.num_ref_frames = max(cfg.num_ref_frames,
                                     1 << max(0, cfg.temporal_layers - 2))
        self.rc = None
        if cfg.rc_mode != RC_OFF_MODE:
            self.rc = RateControl(cfg.rc_mode, cfg.target_bitrate,
                                  cfg.max_frame_rate, cfg.qp,
                                  cfg.min_qp, cfg.max_qp,
                                  cfg.enable_frame_skip,
                                  n_pixels=cfg.width * cfg.height,
                                  honor_init_qp=cfg.rc_honor_init_qp,
                                  max_bitrate=cfg.max_bitrate)
        self.fetch_batch = fetch_batch
        self.max_body_bytes = max_body_bytes
        # download window: grows to 2x the largest body seen; frames that
        # overrun it re-fetch in full
        self._fetch_window = min(1 << 14, max_body_bytes)
        self.frame_num = 0
        self.idr_pic_id = 0
        self.frame_count = 0
        self.coding_idx = 0
        self.qp = cfg.qp
        self.dpb: list[_DevRef] = []
        self._bands = self._band_rows()
        mbw, n_mb = cfg.mb_width, cfg.mb_width * cfg.mb_height
        if len(self._bands) > 1:
            # padded band -> global MB index map for the band tokenizer
            B = max(r1 - r0 for r0, r1 in self._bands)
            idx = np.zeros((len(self._bands), B * mbw), np.int64)
            for i, (r0, r1) in enumerate(self._bands):
                rows = np.arange(B * mbw) + r0 * mbw
                idx[i] = np.clip(rows, 0, n_mb - 1)
            self._band_B = B
            self._band_idx = torch.as_tensor(idx, device=self.device)
            self._band_nvalid = torch.as_tensor(
                [(r1 - r0) * mbw for r0, r1 in self._bands],
                dtype=I32, device=self.device)
            # intra-in-P must not predict across a slice boundary: ban
            # intra on every band-top row except the picture top
            allowed = np.ones(n_mb, bool)
            for (r0, _r1) in self._bands[1:]:
                allowed[r0 * mbw:(r0 + 1) * mbw] = False
            self._intra_allowed = torch.as_tensor(allowed,
                                                  device=self.device)
        self._zero_sad = torch.zeros(n_mb, dtype=I32, device=self.device)
        self._zero_map = torch.zeros(n_mb, dtype=torch.bool,
                                     device=self.device)
        self.last_stats = {}

    # ------------------------------------------------------------------
    def _band_rows(self):
        cfg = self.cfg
        n = min(max(1, cfg.num_slices), cfg.mb_height)
        base, extra = divmod(cfg.mb_height, n)
        rows, r0 = [], 0
        for s in range(n):
            r1 = r0 + base + (1 if s < extra else 0)
            rows.append((r0, r1))
            r0 = r1
        return rows

    def headers_annexb(self) -> bytes:
        return (make_annexb_nal(3, NAL_SPS, write_sps(self.cfg)) +
                make_annexb_nal(3, NAL_PPS, write_pps(self.cfg)))

    def _slice_header(self, is_idr: bool, qp: int, first_mb: int = 0,
                      is_ref: bool = True, reorder=None):
        cfg = self.cfg
        w = BitWriter()
        write_slice_header(w, cfg, 2 if is_idr else 0, self.frame_num,
                           first_mb, qp, is_idr, self.idr_pic_id,
                           disable_deblock=cfg.deblock_idc,
                           is_ref=is_ref, reorder_abs_diff=reorder)
        bits = w.bit_array()
        return np.packbits(bits), len(bits)

    def _temporal_id(self) -> int:
        t = self.cfg.temporal_layers
        if t <= 1:
            return 0
        gop = 1 << (t - 1)
        i = self.coding_idx % gop
        if i == 0:
            return 0
        return t - 1 - (i & -i).bit_length() + 1

    def _pick_ref(self, tid: int) -> _DevRef:
        cands = [e for e in self.dpb if e.temporal_id < max(1, tid)]
        return max(cands, key=lambda e: e.coding_idx)

    def _reorder_cmd(self, ref: _DevRef):
        """abs_diff_pic_num_minus1 when `ref` isn't already first in the
        default P list (8.2.4.2.1 descending-PicNum order)."""
        mx = 1 << self.cfg.log2_max_frame_num
        cur = self.frame_num

        def picnum(fn):
            return fn if fn <= cur else fn - mx
        default = sorted((e.frame_num for e in self.dpb),
                         key=picnum, reverse=True)
        if default and default[0] == ref.frame_num:
            return None
        return (cur - ref.frame_num + mx) % mx - 1

    # ------------------------------------------------------------------
    def _launch(self, buf):
        """Queue the device work for one frame without synchronizing;
        returns a pending record, or None when rate control skips the
        frame."""
        cfg = self.cfg
        is_idr = self.frame_count == 0 or (
            cfg.idr_interval > 0 and
            self.frame_count % cfg.idr_interval == 0)
        self.frame_count += 1
        if self.rc is not None and not is_idr and self.rc.should_skip():
            self.rc.skipped()
            return None
        tid = 0 if is_idr else self._temporal_id()
        qp = (self.rc.frame_qp(is_idr, tid) if self.rc is not None
              else cfg.qp)
        self.qp = qp
        qp_c = int(CHROMA_QP_TABLE[np.clip(qp + cfg.chroma_qp_offset,
                                           0, 51)])
        is_ref = is_idr or cfg.temporal_layers <= 1 or \
            tid < cfg.temporal_layers - 1
        y, u, v = _split_frame(buf, cfg.mb_height * 16, cfg.mb_width * 16)
        if is_idr:
            self.frame_num = 0
            self.coding_idx = 0
            self.dpb.clear()
        if len(self._bands) == 1:
            rec = self._launch_single(y, u, v, is_idr, is_ref, tid, qp,
                                      qp_c)
        else:
            rec = self._launch_multislice(y, u, v, is_idr, is_ref, tid,
                                          qp, qp_c)
        if is_idr:
            self.idr_pic_id = (self.idr_pic_id + 1) % 16
        if is_ref:
            if len(self.dpb) >= cfg.num_ref_frames:
                self.dpb.pop(0)   # sliding window: oldest out
            self.dpb.append(self._pending_ref)
            self.frame_num = (self.frame_num + 1) % \
                (1 << cfg.log2_max_frame_num)
        self.coding_idx += 1
        rec.update({"is_idr": is_idr, "is_ref": is_ref, "qp": qp})
        return rec

    def _launch_single(self, y, u, v, is_idr, is_ref, tid, qp, qp_c):
        cfg = self.cfg
        do_deblock = cfg.deblock_idc != 1
        mb = self.max_body_bytes
        if is_idr:
            hdr, hdr_len = self._slice_header(True, qp)
            packed, nbits, ovf, ry, ru, rv, av, al = _step_i(
                y, u, v, qp, qp_c, hdr_len % 8, cfg.mb_width,
                cfg.mb_height, do_deblock, mb)
            sk_sad, sk_map = self._zero_sad, self._zero_map
        else:
            ref = self._pick_ref(tid)
            hdr, hdr_len = self._slice_header(
                False, qp, is_ref=is_ref, reorder=self._reorder_cmd(ref))
            packed, nbits, ovf, ry, ru, rv, sk_sad, sk_map, av, al = \
                _step_p(y, u, v, *ref.planes, ref.skip_sad, ref.skip_map,
                        qp, qp_c,
                        hdr_len % 8, cfg.mb_width, cfg.mb_height,
                        cfg.search_range, do_deblock,
                        cfg.enable_intra_in_p, mb)
        self._pending_ref = _DevRef(self.frame_num, self.coding_idx, tid,
                                    (ry, ru, rv), sk_sad, sk_map)
        return {"slices": [{"hdr": hdr, "hdr_len": hdr_len,
                            "packed": packed, "nbits": nbits, "ovf": ovf,
                            "av": av, "al": al,
                            "start_bit": hdr_len % 8}]}

    def _launch_multislice(self, y, u, v, is_idr, is_ref, tid, qp, qp_c):
        cfg = self.cfg
        mb_w, mb_h = cfg.mb_width, cfg.mb_height
        n_mb = mb_w * mb_h
        mb = self.max_body_bytes
        bands = self._bands
        zero_rows = (tuple(r0 for r0, _ in bands[1:])
                     if cfg.deblock_idc == 2 else ())
        slices = []
        if is_idr:
            recs, nzs = [], []
            for (r0, r1) in bands:
                hdr, hdr_len = self._slice_header(True, qp,
                                                  first_mb=r0 * mb_w)
                packed, nbits, ovf, by, bu, bv, nz, av, al = _step_i_band(
                    y, u, v, qp, qp_c, hdr_len % 8, r0, mb_w, r1 - r0, mb)
                slices.append({"hdr": hdr, "hdr_len": hdr_len,
                               "packed": packed, "nbits": nbits,
                               "ovf": ovf, "av": av, "al": al,
                               "start_bit": hdr_len % 8})
                recs.append((by, bu, bv))
                nzs.append(nz)
            rec_y, rec_u, rec_v = (torch.cat(p, 0) for p in zip(*recs))
            if cfg.deblock_idc != 1:
                rec_y, rec_u, rec_v = _deblock_ms(
                    rec_y, rec_u, rec_v, torch.cat(nzs, 0),
                    torch.ones(n_mb, dtype=torch.bool, device=self.device),
                    torch.zeros((n_mb, 2), dtype=I32, device=self.device),
                    qp, qp_c, mb_w, mb_h, zero_rows)
            sk_sad, sk_map = self._zero_sad, self._zero_map
        else:
            ref = self._pick_ref(tid)
            reorder = self._reorder_cmd(ref)
            hdrs = [self._slice_header(False, qp, first_mb=r0 * mb_w,
                                       is_ref=is_ref, reorder=reorder)
                    for (r0, _r1) in bands]
            (packed, nbits, ovf, av, al, rec_y, rec_u, rec_v,
             sk_sad, sk_map) = _step_p_ms(
                y, u, v, *ref.planes, ref.skip_sad, ref.skip_map, qp, qp_c,
                self._intra_allowed, self._band_idx, self._band_nvalid,
                [hl % 8 for _h, hl in hdrs], mb_w, mb_h, cfg.search_range,
                cfg.enable_intra_in_p, self._band_B, len(bands), mb,
                cfg.deblock_idc != 1, zero_rows)
            for i, (hdr, hdr_len) in enumerate(hdrs):
                slices.append({"hdr": hdr, "hdr_len": hdr_len,
                               "packed": packed[i], "nbits": nbits[i],
                               "ovf": ovf[i], "av": av[i], "al": al[i],
                               "start_bit": hdr_len % 8})
        self._pending_ref = _DevRef(self.frame_num, self.coding_idx, tid,
                                    (rec_y, rec_u, rec_v), sk_sad, sk_map)
        return {"slices": slices}

    # ------------------------------------------------------------------
    def _finalize_slice(self, sl, packed_np, nbits, ovf) -> bytes:
        mb, mt = self.max_body_bytes, MAX_TOK
        while ovf:
            # repack the resident token grid into a doubled buffer (only
            # the packer re-runs, not the core)
            mb, mt = mb * 2, mt * 2
            if mb > (1 << 24):
                raise RuntimeError("slice body exceeds 16 MB")
            packed_d, nbits_d, ovf_d = entropy_torch.pack_tokens_device(
                sl["av"], sl["al"], sl["start_bit"], mb, mt)
            packed_np = packed_d.cpu().numpy()
            nbits, ovf = int(nbits_d), bool(ovf_d)
        hdr, hdr_len = sl["hdr"], sl["hdr_len"]
        nbits = int(nbits)               # end bit, pre-stop-bit
        nbytes = (nbits + 1 + 7) // 8    # + rbsp stop bit
        body = bytearray(packed_np[:nbytes].tobytes())
        body[nbits // 8] |= 0x80 >> (nbits % 8)
        full = bytearray(hdr[:hdr_len // 8].tobytes())
        if hdr_len % 8:
            full.append(int(hdr[hdr_len // 8]) | body[0])
            full += body[1:]
        else:
            full += body
        return bytes(full)

    def _finalize(self, rec, bodies) -> bytes:
        """bodies: list of (packed_np, nbits, ovf) per slice."""
        is_idr, is_ref = rec["is_idr"], rec["is_ref"]
        nri = 3 if is_idr else (2 if is_ref else 0)
        ntype = NAL_IDR if is_idr else NAL_SLICE
        nals = [make_annexb_nal(nri, ntype, self._finalize_slice(sl, *b))
                for sl, b in zip(rec["slices"], bodies)]
        prefix = self.headers_annexb() if is_idr else b""
        bs = prefix + b"".join(nals)
        if self.rc is not None:
            self.rc.update(8 * len(bs), rec["qp"], is_idr)
        return bs

    # ------------------------------------------------------------------
    def _upload(self, host: torch.Tensor) -> torch.Tensor:
        """Host frame buffer -> device (non-blocking from pinned memory)."""
        if self.device.type == "cpu":
            return host
        return host.to(self.device, non_blocking=True)

    def encode_frame(self, y, u, v) -> bytes:
        """Single-frame contract. Returns b"" when rate control skips
        the frame."""
        rec = self._launch(self._upload(torch.from_numpy(
            _pack_frame(y, u, v))))
        if rec is None:
            return b""
        bodies = [(sl["packed"].cpu().numpy(), int(sl["nbits"]),
                   bool(sl["ovf"])) for sl in rec["slices"]]
        return self._finalize(rec, bodies)

    def encode_stream(self, frames) -> list[bytes]:
        """Pipelined batch encode. `frames`: iterable of (y, u, v).

        A background thread packs (and on CUDA pins) the host frames
        while the device computes; packed bodies are downloaded in
        batches of `fetch_batch` frames. Under rate control the bits
        feedback therefore lags by up to `fetch_batch` frames, with small
        first batches so the model gets feedback early.
        """
        q: queue.Queue = queue.Queue(maxsize=8)
        pin = self.device.type == "cuda"

        failed: list = []

        def uploader():
            try:
                for f in frames:
                    host = torch.from_numpy(_pack_frame(*f))
                    q.put(host.pin_memory() if pin else host)
            except BaseException as e:       # re-raised by the caller
                failed.append(e)
            finally:
                q.put(None)

        t = threading.Thread(target=uploader, daemon=True)
        t.start()
        out: list[bytes] = []
        pending: list = []      # (position, rec)
        stats = {"launch_s": 0.0, "fetch_s": 0.0, "finalize_s": 0.0,
                 "wait_input_s": 0.0, "frames": 0}

        def flush():
            if not pending:
                return
            t0 = time.perf_counter()
            fw = self._fetch_window
            sls = [sl for _pos, r in pending for sl in r["slices"]]
            stackedh = torch.stack([sl["packed"][:fw] for sl in sls]).cpu(
                ).numpy()
            metah = torch.stack([torch.stack([sl["nbits"].to(I32),
                                              sl["ovf"].to(I32)])
                                 for sl in sls]).cpu().numpy()
            need = [(int(m[0]) + 8) // 8 + 8 for m in metah]
            want = max([self._fetch_window] + [2 * n for n in need])
            self._fetch_window = min(self.max_body_bytes,
                                     1 << (want - 1).bit_length())
            stats["fetch_s"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            k = 0
            for pos, r in pending:
                bodies = []
                for sl in r["slices"]:
                    body = stackedh[k]
                    if need[k] > fw and not metah[k, 1]:
                        # body overran the fetch window: pull it whole
                        body = sl["packed"].cpu().numpy()
                    bodies.append((body, int(metah[k, 0]),
                                   bool(metah[k, 1])))
                    k += 1
                out[pos] = self._finalize(r, bodies)
            stats["finalize_s"] += time.perf_counter() - t0
            pending.clear()

        try:
            while True:
                t0 = time.perf_counter()
                host = q.get()
                stats["wait_input_s"] += time.perf_counter() - t0
                if host is None:
                    break
                t0 = time.perf_counter()
                rec = self._launch(self._upload(host))
                stats["launch_s"] += time.perf_counter() - t0
                stats["frames"] += 1
                out.append(b"")       # placeholder (or an RC frame skip)
                if rec is None:
                    continue
                pending.append((len(out) - 1, rec))
                batch = self.fetch_batch
                if self.rc is not None and stats["frames"] <= batch:
                    batch = max(2, batch // 4)
                if len(pending) >= batch:
                    flush()
            if failed:
                raise failed[0]
            flush()
        finally:
            # let a stopped uploader finish so the thread always ends
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()
        self.last_stats = stats
        return out

    # ------------------------------------------------------------------
    def export_state(self) -> dict:
        """The session state that the next frame depends on, as numpy
        arrays and Python scalars: counters, the DPB (planes, skip-SAD
        chain) and the rate-control state."""
        st = {"frame_num": self.frame_num, "idr_pic_id": self.idr_pic_id,
              "frame_count": self.frame_count,
              "coding_idx": self.coding_idx, "qp": self.qp, "dpb": []}
        for e in self.dpb:
            y, u, v = (p.cpu().numpy().copy() for p in e.planes)
            st["dpb"].append({
                "frame_num": e.frame_num, "coding_idx": e.coding_idx,
                "temporal_id": e.temporal_id, "y": y, "u": u, "v": v,
                "skip_sad": e.skip_sad.cpu().numpy().astype(np.int32),
                "skip_map": e.skip_map.cpu().numpy().astype(bool)})
        st["rc"] = None
        if self.rc is not None:
            r = self.rc.st
            st["rc"] = {"qp": r.qp, "buffer_fullness": r.buffer_fullness,
                        "model_x": r.model_x, "frames": r.frames,
                        "window": list(self.rc._win)}
        return st

    @classmethod
    def from_state(cls, cfg, state: dict, device="cuda", **kwargs):
        """A session that continues from `state` (see export_state);
        `kwargs` go to the constructor."""
        enc = cls(cfg, device=device, **kwargs)
        for k in ("frame_num", "idr_pic_id", "frame_count", "coding_idx",
                  "qp"):
            setattr(enc, k, int(state[k]))
        dev = enc.device
        for e in state["dpb"]:
            # torch.tensor copies: the session never shares the caller's
            # arrays
            planes = tuple(torch.tensor(np.asarray(e[p], np.uint8),
                                        device=dev) for p in "yuv")
            enc.dpb.append(_DevRef(
                int(e["frame_num"]), int(e["coding_idx"]),
                int(e["temporal_id"]), planes,
                torch.tensor(np.asarray(e["skip_sad"], np.int32),
                             device=dev),
                torch.tensor(np.asarray(e["skip_map"], bool), device=dev)))
        rc = state.get("rc")
        if (rc is None) != (enc.rc is None):
            raise ValueError("state and cfg disagree on rate control")
        if rc is not None:
            enc.rc.st.qp = int(rc["qp"])
            enc.rc.st.buffer_fullness = float(rc["buffer_fullness"])
            enc.rc.st.model_x = float(rc["model_x"])
            enc.rc.st.frames = int(rc["frames"])
            enc.rc._win = deque(rc["window"], maxlen=enc.rc._win.maxlen)
        return enc
