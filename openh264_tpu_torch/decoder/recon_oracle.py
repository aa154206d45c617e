"""The decoded picture's planes while the decoder reconstructs them.

Port of openh264_tpu/decoder/recon_oracle.py::ReconState. The JAX
module also holds the per-MB numpy reconstruction that its batched
recon falls back to for intra MBs; here intra MBs always run in the
host C (csrc/host_native.c recon_intra_mbs, through
native.recon_intra_mbs_native), so only the state is ported. Its
planes are uint8 tensors on the decoder's device.
"""

from __future__ import annotations

import torch

from .framedata import FrameSymbols


class ReconState:
    """Decoded picture planes (uint8 tensors on `device`, zero-filled,
    MB aligned) of the frame `fs` describes."""

    def __init__(self, fs: FrameSymbols, device: torch.device):
        self.fs = fs
        self.w = fs.mb_w * 16
        self.h = fs.mb_h * 16
        u8 = torch.uint8
        self.y = torch.zeros((self.h, self.w), dtype=u8, device=device)
        self.u = torch.zeros((self.h // 2, self.w // 2), dtype=u8,
                             device=device)
        self.v = torch.zeros((self.h // 2, self.w // 2), dtype=u8,
                             device=device)
