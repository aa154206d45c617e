"""Spatial simulcast encoding (Simulcast AVC, BASELINE config #5).

Port of openh264_tpu/parallel/simulcast.py (SimulcastEncoder),
byte-identical with it. The reference's multi-spatial-layer loop
(encoder_ext.cpp:3533) encodes each resolution as an independent AVC
stream distinguished by parameter-set ids (EParameterSetStrategy
CONSTANT_ID per layer). Here each layer is the port's host encoder
(H264Encoder) over a dyadically downsampled input
(processing/downsample.py, run as torch on the layer's device),
producing one Annex-B stream per layer plus a combined stream whose
NALs carry distinct sps/pps ids like the reference's SFrameBSInfo layer
list.

Layers share no state, so `devices=[...]` pins layer k to
devices[k % len(devices)] and encodes the layers of a frame at once,
one host thread per layer; the streams equal the serial loop's. Without
`devices` every layer runs on `device` (default "cuda"), one after the
other. Layer sizes need not be multiples of 16 (720p gives 640x360 and
320x180): each layer encoder pads its input to whole MBs and crops in
its SPS, as the JAX package does.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import torch

from ..device import resolve_device
from ..encoder.config import EncoderConfig
from ..encoder.encoder import H264Encoder
from ..processing.downsample import dyadic_downsample


class SimulcastEncoder:
    """N-resolution simulcast: layer 0 = full size, layer k = 1/2^k."""

    def __init__(self, base_cfg, n_layers: int = 2, devices=None,
                 device="cuda"):
        if devices:
            self.devices = [resolve_device(d) for d in devices]
            self._pool = ThreadPoolExecutor(max_workers=n_layers)
        else:
            self.devices = [resolve_device(device)]
            self._pool = None
        self._init_layers(base_cfg, n_layers)

    def _init_layers(self, base_cfg, n_layers: int):
        if not (1 <= n_layers <= 4):
            raise ValueError("1..4 spatial layers (codec_app_def.h MAX)")
        self.n_layers = n_layers
        self.encoders = []
        for k in range(n_layers):
            w = base_cfg.width >> k
            h = base_cfg.height >> k
            if w < 16 or h < 16:
                raise ValueError(f"layer {k} too small: {w}x{h}")
            cfg = EncoderConfig(
                width=w, height=h, qp=base_cfg.qp,
                idr_interval=base_cfg.idr_interval,
                entropy_cabac=base_cfg.entropy_cabac,
                pic_init_qp=base_cfg.pic_init_qp,
                search_range=base_cfg.search_range,
                deblock_idc=base_cfg.deblock_idc,
                temporal_layers=base_cfg.temporal_layers,
                rc_mode=base_cfg.rc_mode,
                target_bitrate=base_cfg.target_bitrate >> (2 * k),
                max_frame_rate=base_cfg.max_frame_rate,
                sps_id=k, pps_id=k)
            self.encoders.append(H264Encoder(
                cfg, device=self.devices[k % len(self.devices)]))

    def _encode_layer(self, k, y, u, v):
        enc = self.encoders[k]
        if k == 0:
            yk, uk, vk = y, u, v
        else:
            yk, uk, vk = (dyadic_downsample(
                torch.tensor(p, device=enc.device), k).cpu().numpy()
                for p in (y, u, v))
        h, w = enc.cfg.height, enc.cfg.width
        return enc.encode_frame(yk[:h, :w], uk[:h // 2, :w // 2],
                                vk[:h // 2, :w // 2])

    def encode_frame(self, y, u, v):
        """Returns (combined_annexb, [per_layer_annexb...]); layer 0
        first, matching SFrameBSInfo.sLayerInfo ordering. With
        `devices`, all layers encode concurrently (one thread each)."""
        if self._pool is not None:
            futs = [self._pool.submit(self._encode_layer, k, y, u, v)
                    for k in range(self.n_layers)]
            layers = [f.result() for f in futs]
        else:
            layers = [self._encode_layer(k, y, u, v)
                      for k in range(self.n_layers)]
        return b"".join(layers), layers

    def close(self) -> None:
        """Ends the layer threads (with `devices`); encode_frame may not
        be called after."""
        if self._pool is not None:
            self._pool.shutdown()
