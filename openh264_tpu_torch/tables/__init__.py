from .core import (
    ZIGZAG_4x4,
    ZSCAN_TO_RASTER,
    DEQUANT_4x4,
    QUANT_MF_4x4,
    CHROMA_QP_TABLE,
    ALPHA_TABLE,
    BETA_TABLE,
    TC0_TABLE,
)
