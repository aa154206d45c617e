"""Per-frame symbol tensors produced by entropy parsing.

This is the host↔device interface of the decoder: the serial entropy
phase (CAVLC/CABAC parse) fills dense numpy arrays over the whole MB
grid; the batched recon phase (intra pred wavefront, MC, IDCT, deblock)
consumes them as device tensors. It replaces the reference's per-MB
pointer web (pCurDqLayer->pScaledTCoeff / pMv / pNzc / ...,
decode_slice.cpp WelsTargetMbConstruction inputs) with flat tensors.

Block index conventions:
- luma 4x4 blocks are stored RASTER within the MB: blk = 4*by + bx.
  (The bitstream's z-scan order is converted during parse.)
- luma coeffs are stored in RASTER order within each 4x4 block,
  already dequantized ("scaled") like the reference's pScaledTCoeff.
- chroma blocks raster within the 8x8 plane: blk = 2*by + bx.

Copied from openh264_tpu/decoder/framedata.py (FrameSymbols and the MB
type constants); ZSCAN_TO_RASTER comes from the port's tables. The CABAC
parser's neighbour grids (cbf_dc, gmvd, gdirect), which the JAX parser
attaches to the object when it first needs them, are declared fields
here.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..tables import ZSCAN_TO_RASTER

# mb type classes
MB_I4x4, MB_I16x16, MB_IPCM, MB_I8x8 = 0, 1, 2, 3
MB_P16x16, MB_P16x8, MB_P8x16, MB_P8x8, MB_PSKIP = 4, 5, 6, 7, 8
MB_B16x16, MB_B16x8, MB_B8x16, MB_B8x8, MB_BSKIP, MB_BDIRECT = 9, 10, 11, 12, 13, 14

INTRA_CLASSES = (MB_I4x4, MB_I16x16, MB_IPCM, MB_I8x8)

# z-scan order -> raster index of luma 4x4 blocks
RASTER_TO_ZSCAN = np.argsort(ZSCAN_TO_RASTER).astype(np.int32)


@dataclass
class FrameSymbols:
    mb_w: int
    mb_h: int

    def __post_init__(self):
        n = self.mb_w * self.mb_h
        self.n_mb = n
        self.mb_type = np.full(n, -1, dtype=np.int32)  # -1 = not yet decoded
        self.slice_id = np.full(n, -1, dtype=np.int32)
        self.transform8 = np.zeros(n, dtype=bool)
        self.i16_mode = np.zeros(n, dtype=np.int32)
        self.chroma_mode = np.zeros(n, dtype=np.int32)
        # intra 4x4/8x8 pred modes, raster block order within MB
        self.i4_modes = np.zeros((n, 16), dtype=np.int32)
        self.cbp = np.zeros(n, dtype=np.int32)
        self.qp = np.zeros(n, dtype=np.int32)
        # motion: per list, per 4x4 block (raster), (mvx, mvy) in 1/4 pel
        self.mv = np.zeros((n, 2, 16, 2), dtype=np.int32)
        self.refidx = np.full((n, 2, 4), -1, dtype=np.int8)  # per 8x8 quadrant
        # decode B pictures as the OpenH264 decoder does where it departs
        # from clause 8 (H264Decoder's openh264_compat): the two
        # fields below, and recon_batch's B 16x8 / 8x16 BI partitions
        self.openh264_compat = False
        # deblock interior-edge bS mode (decoder deblocking.cpp
        # WelsDeblockingMb), set under openh264_compat only: 0 = normal
        # (mv+nz), 1 = nz-only (IS_INTER_16x16 incl. direct MBs promoted
        # by GetColocatedMb), 2 = zero (IS_SKIP)
        self.ibs_mode = np.zeros(n, dtype=np.uint8)
        # 16x16-class flag AFTER direct promotion (recursively recorded;
        # feeds GetColocatedMb's IS_INTER_16x16 test when this picture
        # becomes the colocated picture of a later B)
        self.mb16 = np.zeros(n, dtype=bool)
        # B_8x8 MBs with a direct sub-MB (the picture's `direct` counter)
        self.sub_direct = np.zeros(n, dtype=bool)
        self.pred_mode = np.zeros((n, 4), dtype=np.int8)  # 0=L0,1=L1,2=BI,-1=intra
        # scaled (dequantized) coefficients
        self.coeffs_l = np.zeros((n, 16, 16), dtype=np.int32)
        self.coeffs_c = np.zeros((n, 2, 4, 16), dtype=np.int32)
        self.coeffs8 = None  # lazily allocated [n, 4, 64] for 8x8 transform MBs
        # CABAC neighbour state, allocated by the CABAC slice parsers
        # (ensure_cabac_state): per MB the coded_block_flag
        # bits of I16 DC, Cb DC, Cr DC (bits 0..2); per list and 4x4 block
        # the mvd; per 4x4 block the direct / skip flag
        self.cbf_dc = None   # [n] int32
        self.gmvd = None     # [2, mb_h*4, mb_w*4, 2] int32
        self.gdirect = None  # [mb_h*4, mb_w*4] int8
        # IPCM raw samples
        self.ipcm = {}  # mb_idx -> (y[16,16], u[8,8], v[8,8])
        # non-zero count per luma 4x4 block (global grid) for nC/deblock
        self.nzc_l = np.zeros((self.mb_h * 4, self.mb_w * 4), dtype=np.int32)
        self.nzc_c = np.zeros((2, self.mb_h * 2, self.mb_w * 2), dtype=np.int32)
        # per-MB deblock controls (from owning slice header)
        self.disable_deblock = np.zeros(n, dtype=np.int32)
        self.alpha_offset = np.zeros(n, dtype=np.int32)
        self.beta_offset = np.zeros(n, dtype=np.int32)
        # mapping refidx -> DPB picture id, per list, per slice; recon uses
        # per-MB resolved picture indices:
        self.ref_pic = np.full((n, 2, 4), -1, dtype=np.int32)
        # per-slice weighted-prediction descriptors (decoder/wpred.py)
        self.wp_by_slice = None
        # per-MB correctly-decoded flags (pMbCorrectlyDecodedFlag analog).
        # Defaults to all-True (producers like the encoder fill every MB);
        # the decoder clears it per picture and marks MBs as slices land.
        self.mb_correct = np.ones(n, dtype=bool)

    def ensure_cabac_state(self):
        if self.cbf_dc is None:
            self.cbf_dc = np.zeros(self.n_mb, dtype=np.int32)
            h4, w4 = self.mb_h * 4, self.mb_w * 4
            self.gmvd = np.zeros((2, h4, w4, 2), dtype=np.int32)
            self.gdirect = np.zeros((h4, w4), dtype=np.int8)

    def ensure_coeffs8(self):
        if self.coeffs8 is None:
            self.coeffs8 = np.zeros((self.n_mb, 4, 64), dtype=np.int32)

    def is_intra(self, mb_idx: int) -> bool:
        return 0 <= self.mb_type[mb_idx] <= MB_I8x8
