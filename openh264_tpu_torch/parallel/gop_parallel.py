"""GOP-level data parallelism across devices.

Port of openh264_tpu/parallel/gop_parallel.py (GopParallelEncoder),
byte-identical with it. Closed GOPs (each starting with an IDR) share
no prediction state, so they are the natural zero-communication sharding
axis for offline or multi-device encoding (BASELINE.md config #5: "GOPs
sharded across hosts"; the reference has no analog — it is a
single-process codec, SURVEY.md §2.6). Each GOP runs in its own
DeviceSessionEncoder on devices[g % len(devices)], one host thread per
device, and the host stitches the per-GOP Annex-B chunks back in input
order.

Because a closed GOP encodes independently of its neighbors, the
output is byte-identical to a single-session encode with the same
idr_interval.
"""

from __future__ import annotations

import copy
from concurrent.futures import ThreadPoolExecutor

import torch

from ..device import resolve_device
from ..encoder.session_device import DeviceSessionEncoder


class GopParallelEncoder:
    """Encode closed GOPs round-robin across `devices`.

    cfg.idr_interval defines the GOP length (must be > 0). RC state is
    per-GOP (each session starts fresh), matching the closed-GOP
    semantics; constant-QP output is byte-identical to serial encode.
    `devices` defaults to every CUDA device; without one that raises
    (pass devices=["cpu", ...] for the plain PyTorch path).
    """

    def __init__(self, cfg, devices=None):
        if cfg.idr_interval <= 0:
            raise ValueError("GOP parallelism needs idr_interval > 0 "
                             "(closed GOPs)")
        self.cfg = cfg
        if devices is None:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if n == 0:
                raise RuntimeError("GopParallelEncoder: no CUDA device; "
                                   "pass devices=['cpu', ...] to run the "
                                   "plain PyTorch path")
            devices = [f"cuda:{i}" for i in range(n)]
        self.devices = [resolve_device(d) for d in devices]

    def encode_stream(self, frames) -> list[bytes]:
        frames = list(frames)
        g = self.cfg.idr_interval
        gops = [frames[i:i + g] for i in range(0, len(frames), g)]

        def run(args):
            gi, gop = args
            dev = self.devices[gi % len(self.devices)]
            enc = DeviceSessionEncoder(copy.deepcopy(self.cfg), device=dev)
            # match the serial session's idr_pic_id sequence so the
            # stitched stream is byte-identical to serial encode
            enc.idr_pic_id = gi % 16
            return enc.encode_stream(iter(gop))

        # one host thread per device keeps every device's queue fed
        with ThreadPoolExecutor(max_workers=len(self.devices)) as ex:
            per_gop = list(ex.map(run, enumerate(gops)))
        return [b for chunks in per_gop for b in chunks]
