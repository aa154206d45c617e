"""Slice-parallel encoding over a list of devices.

Port of openh264_tpu/parallel/slice_parallel.py (make_mesh,
sliced_i_step, sliced_p_step, SliceParallelEncoder), byte-identical with
it. The analog of the reference's slice-parallel multithreading
(codec/encoder/core/src/slice_multi_threading.cpp, SM_FIXEDSLCNUM_SLICE
mode): each H.264 slice is a horizontal band of MB rows; slices are
independent for intra prediction and entropy coding (spec §8.3, §9),
while inter prediction may cross slice boundaries. Band s runs on
devices[s]:

- I step: each band's device runs the wavefront intra encode on its own
  band, with no communication (has_top=False at the band's first MB row
  is exactly slice intra semantics).
- P step: every band's device gets the whole reference planes (the JAX
  step's all_gather along its "slices" mesh axis becomes one copy of
  each plane per band device, a no-op where the device is the
  reference's own), so motion search and compensation reach outside the
  band; everything else stays band-local.

Each step returns every symbol and recon array with a leading slice
axis, gathered onto devices[0]. The host then writes one NAL per band
and deblocks the merged frame on devices[0] (H264Encoder._deblock,
through deblock_host: the Hopper kernel on CUDA), which is multi-slice
Annex-B output.

One host thread dispatches the bands one after the other. The list of
devices may repeat a device: ["cuda:0"] * 3 runs the band split, the
gather and the merged deblock on one GPU, and ["cpu"] * 3 is the plain
PyTorch path of the tests. Nothing falls back to the CPU: a CUDA device
without a GPU raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bitstream import NAL_IDR, NAL_SLICE, make_annexb_nal
from ..device import resolve_device
from ..encoder import core_torch
from ..encoder.core_np import pad_to_mb
from ..encoder.encoder import (_I_KEYS, _P_KEYS, H264Encoder, _RefEntry,
                               _fetch)
from ..tables import CHROMA_QP_TABLE

__all__ = ["make_mesh", "sliced_i_step", "sliced_p_step",
           "SliceParallelEncoder"]

def make_mesh(n_devices: int | None = None, device: str = "cuda"):
    """The first `n_devices` devices of type `device` (all of them by
    default) as a tuple of torch.device: the JAX mesh's devices along
    its one axis, "slices". A type with no device raises."""
    dev = resolve_device(device)     # CUDA without a GPU raises
    devs = (tuple(torch.device("cuda", i)
                  for i in range(torch.cuda.device_count()))
            if dev.type == "cuda" else (dev,))
    return devs[:n_devices or len(devs)]


def _bands(plane: np.ndarray, rows: int, devices) -> list:
    """Band s of a host plane (rows [s*rows, (s+1)*rows)) as a copy on
    devices[s]."""
    return [torch.tensor(np.ascontiguousarray(plane[s * rows:(s + 1) * rows]),
                         device=d) for s, d in enumerate(devices)]


def _gather(outs: list, dev) -> dict:
    """The bands' output dicts as one dict of [n_slices, ...] tensors on
    `dev`."""
    return {k: torch.stack([o[k].to(dev) for o in outs]) for k in outs[0]}


def sliced_i_step(y, u, v, qp, qp_c, *, mb_w: int, mb_h_band: int,
                  devices):
    """I-frame encode of host planes y [H, W], u, v [H/2, W/2] (MB
    aligned) in len(devices) row bands, band s on devices[s], each an
    independent H.264 slice. Returns the symbol and recon arrays with a
    leading slice axis on devices[0]."""
    bh = mb_h_band
    outs = [core_torch.encode_i_frame(yb, ub, vb, qp, qp_c, mb_w=mb_w,
                                      mb_h=bh)
            for yb, ub, vb in zip(_bands(y, bh * 16, devices),
                                  _bands(u, bh * 8, devices),
                                  _bands(v, bh * 8, devices))]
    return _gather(outs, devices[0])


def sliced_p_step(y, u, v, ref_y, ref_u, ref_v, qp, qp_c, *, mb_w: int,
                  mb_h_band: int, sr: int = 8, devices):
    """P-frame encode of host planes y, u, v in bands as sliced_i_step;
    the reference planes (whole, host arrays or tensors on any device)
    are copied to every band's device, so ME/MC can cross band edges as
    the spec allows."""
    bh = mb_h_band
    outs = []
    for s, (yb, ub, vb) in enumerate(zip(_bands(y, bh * 16, devices),
                                         _bands(u, bh * 8, devices),
                                         _bands(v, bh * 8, devices))):
        ry, ru, rv = (torch.as_tensor(p, device=devices[s])
                      for p in (ref_y, ref_u, ref_v))
        outs.append(core_torch.encode_p_frame(
            yb, ub, vb, ry, ru, rv, qp, qp_c, mb_w=mb_w, mb_h=bh, sr=sr,
            row_off=s * bh * 16))
    return _gather(outs, devices[0])


class SliceParallelEncoder:
    """Multi-slice encoder session: band s of every frame on devices[s],
    then per-slice host entropy (one NAL per slice, SM_FIXEDSLCNUM
    semantics) and the deblock of the merged frame on devices[0].

    As the JAX module does, and unlike H264Encoder(num_slices=n) (ROADMAP
    C11): every frame is a reference coded from the newest DPB entry, P
    frames search ±8 whatever cfg.search_range says, and rate control
    never skips a frame; no scene-change detection, LTR marking or
    temporal layers."""

    def __init__(self, cfg, devices):
        self.cfg = cfg
        self.devices = [resolve_device(d) for d in devices]
        self.n_slices = len(self.devices)
        if cfg.mb_height % self.n_slices:
            raise ValueError(
                f"mb_height {cfg.mb_height} not divisible by "
                f"{self.n_slices} slices")
        self.mb_h_band = cfg.mb_height // self.n_slices
        self._host = H264Encoder(cfg, device=self.devices[0])

    def encode_i_symbols(self, y, u, v, qp, qp_c):
        return sliced_i_step(y, u, v, qp, qp_c, mb_w=self.cfg.mb_width,
                             mb_h_band=self.mb_h_band, devices=self.devices)

    def encode_p_symbols(self, y, u, v, ref, qp, qp_c):
        return sliced_p_step(y, u, v, *ref, qp, qp_c,
                             mb_w=self.cfg.mb_width,
                             mb_h_band=self.mb_h_band, devices=self.devices)

    def encode_frame(self, y, u, v) -> bytes:
        """Encode one frame (host uint8 planes); returns its Annex-B
        bytes, headers first on an IDR."""
        host, cfg = self._host, self.cfg
        is_idr = host.frame_count == 0 or (
            cfg.idr_interval > 0 and
            host.frame_count % cfg.idr_interval == 0)
        host.frame_count += 1
        host.qp = host.rc.frame_qp(is_idr, 0)
        host.qp_c = int(CHROMA_QP_TABLE[np.clip(
            host.qp + cfg.chroma_qp_offset, 0, 51)])
        yp, up, vp = pad_to_mb(y), pad_to_mb(u, 8), pad_to_mb(v, 8)
        bh, mb_w = self.mb_h_band, cfg.mb_width
        if is_idr:
            host.frame_num = 0
            host.coding_idx = 0
            host.dpb.clear()
            prefix = host.headers_annexb()
            host.idr_pic_id = (host.idr_pic_id + 1) % 16
            sym = self.encode_i_symbols(yp, up, vp, host.qp, host.qp_c)
            out_m = _fetch(sym, _I_KEYS)
        else:
            prefix = b""
            sym = self.encode_p_symbols(yp, up, vp, host.dpb[-1].planes,
                                        host.qp, host.qp_c)
            out_m = _fetch(sym, _P_KEYS)
            out_m["intra_mask"] = np.zeros((self.n_slices, bh * mb_w), bool)
        nals = []
        for sidx in range(self.n_slices):
            out = {k: a[sidx] for k, a in out_m.items()}
            if is_idr:
                rbsp = host._write_i_slice(out, mb_h=bh,
                                           first_mb=sidx * bh * mb_w)
                nals.append(make_annexb_nal(3, NAL_IDR, rbsp))
            else:
                rbsp = host._write_p_slice(out, True, None, mb_h=bh,
                                           first_mb=sidx * bh * mb_w)
                nals.append(make_annexb_nal(2, NAL_SLICE, rbsp))
        # the bands merged in MB order; the stacked recon planes are
        # already on devices[0], whole frames in row order
        out_m = {k: a.reshape((-1,) + a.shape[2:]) for k, a in out_m.items()}
        out_m.update({k: sym[k].reshape(-1, sym[k].shape[-1])
                      for k in ("recon_y", "recon_u", "recon_v")})
        fs = (host._frame_symbols_i(out_m) if is_idr
              else host._frame_symbols_p(out_m))
        fs.slice_id[:] = np.repeat(np.arange(self.n_slices), bh * mb_w)
        recon = host._deblock(out_m, fs)
        host.dpb.append(_RefEntry(host.frame_num, host.coding_idx, 0, recon))
        if len(host.dpb) > cfg.num_ref_frames:
            host.dpb.pop(0)
        host.frame_num = (host.frame_num + 1) % (1 << cfg.log2_max_frame_num)
        host.coding_idx += 1
        bs = prefix + b"".join(nals)
        host.rc.update(8 * len(bs), host.qp, is_idr)
        return bs

    @property
    def dpb(self):
        """The host encoder's DPB: deblocked recon planes on devices[0]."""
        return self._host.dpb
