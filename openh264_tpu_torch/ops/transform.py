"""Batched 4x4 integer transforms, AoS layout [..., 4, 4] (int32 torch),
and the decoder's 8x8 inverse transform.

Port of openh264_tpu/ops/transform.py. Every function is batched over
arbitrary leading axes and bit-exact with its JAX twin:
- int32 throughout, like JAX without x64. The `int64` casts of the JAX
  quantizers are int32 there too; here they stay int32, and the largest
  product |coef| * mf (9180 * 13107 for a +-255 residual) is < 2**31.
- the small constant matrix products are written as broadcast
  multiply-sums: CUDA has no integer matmul.
- int16 stores of the reference are the explicit wrap `wrap_i16`. The
  8x8 pass wraps int32 sums to int16 where the numpy oracle wraps int64
  ones: both keep the low 16 bits, so they agree for any int32 input.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import constant_cache
from ..tables import DEQUANT_4x4, QUANT_MF_4x4

I32 = torch.int32

_CF = np.array([[1, 1, 1, 1],
                [2, 1, -1, -2],
                [1, -1, -1, 1],
                [1, -2, 2, -1]], dtype=np.int32)
_H4 = np.array([[1, 1, 1, 1],
                [1, 1, -1, -1],
                [1, -1, -1, 1],
                [1, -1, 1, -1]], dtype=np.int32)
_H2 = np.array([[1, 1], [1, -1]], dtype=np.int32)

_const = constant_cache({
    "cf": _CF, "h4": _H4, "h2": _H2,
    "dequant": DEQUANT_4x4.reshape(52, 4, 4),
    "quant_mf": QUANT_MF_4x4.reshape(52, 4, 4),
})


@functools.lru_cache(maxsize=None)
def _scalar(value: int, device: torch.device) -> torch.Tensor:
    return torch.tensor(value, dtype=I32, device=device)


def qp_tensor(qp, device) -> torch.Tensor:
    """QP (Python int, 0-d or per-MB tensor) as int32 on `device`. A
    Python int maps to a cached 0-d tensor, so a per-call QP costs no
    host-to-device copy."""
    if isinstance(qp, torch.Tensor):
        return qp.to(device=device, dtype=I32)
    if np.ndim(qp) == 0:
        return _scalar(int(qp), torch.device(device))
    return torch.as_tensor(qp, dtype=I32, device=device)


def lmul(name: str, x: torch.Tensor) -> torch.Tensor:
    """M @ x over the last two axes for a constant square matrix M."""
    m = _const(name, x.device)
    n = m.shape[0]
    return (m.view(n, n, 1) * x.unsqueeze(-3)).sum(-2, dtype=I32)


def rmul_t(x: torch.Tensor, name: str) -> torch.Tensor:
    """x @ M.T over the last two axes for a constant square matrix M."""
    m = _const(name, x.device)
    return (x.unsqueeze(-2) * m).sum(-1, dtype=I32)


def wrap_i16(x):
    return ((x + 0x8000) & 0xFFFF) - 0x8000


def dct4x4(res):
    return rmul_t(lmul("cf", res.to(I32)), "cf")


def hadamard4x4(x):
    t = rmul_t(lmul("h4", x.to(I32)), "h4")
    return (t + 1) >> 1


def ihadamard4x4(x):
    return rmul_t(lmul("h4", x.to(I32)), "h4")


def hadamard2x2(x):
    return rmul_t(lmul("h2", x.to(I32)), "h2")


def quant4x4(coef, qp, intra: bool):
    """qp may be a scalar or a tensor broadcastable over the leading axes
    (per-MB QP). intra is a static bool."""
    qp = qp_tensor(qp, coef.device)
    qbits = 15 + torch.div(qp, 6, rounding_mode="floor")
    f = torch.div(torch.ones_like(qbits) << qbits, 3 if intra else 6,
                  rounding_mode="floor")
    mf = _const("quant_mf", coef.device)[qp.long()]
    c = coef.to(I32)
    shift = qbits
    if mf.dim() > 2:  # per-block qp: align [..., 4, 4]
        f = f[..., None, None]
        shift = shift[..., None, None]
    lev = (c.abs() * mf + f) >> shift
    return (torch.sign(c) * lev).to(I32)


def quant_dc(coef, qp, intra: bool):
    qp = qp_tensor(qp, coef.device)
    qbits = 15 + torch.div(qp, 6, rounding_mode="floor")
    f = 2 * torch.div(torch.ones_like(qbits) << qbits, 3 if intra else 6,
                      rounding_mode="floor")
    mf = _const("quant_mf", coef.device)[qp.long()][..., 0, 0]
    c = coef.to(I32)
    shift = qbits + 1
    if mf.dim() > 0:
        f = f[..., None, None]
        shift = shift[..., None, None]
        mf = mf[..., None, None]
    lev = (c.abs() * mf + f) >> shift
    return (torch.sign(c) * lev).to(I32)


def dequant4x4(level, qp):
    d = _const("dequant", level.device)[qp_tensor(qp, level.device).long()]
    return level.to(I32) * d


def idct4x4_add(pred, coef):
    c = coef.to(I32)
    c0, c1, c2, c3 = c[..., 0], c[..., 1], c[..., 2], c[..., 3]
    t0 = c0 + c2
    t1 = c0 - c2
    t2 = (c1 >> 1) - c3
    t3 = c1 + (c3 >> 1)
    h = torch.stack([t0 + t3, t1 + t2, t1 - t2, t0 - t3], dim=-1)
    h = wrap_i16(h)
    h0, h1, h2, h3 = h[..., 0, :], h[..., 1, :], h[..., 2, :], h[..., 3, :]
    t0 = h0 + h2
    t1 = h0 - h2
    t2 = (h1 >> 1) - h3
    t3 = h1 + (h3 >> 1)
    r = torch.stack([t0 + t3, t1 + t2, t1 - t2, t0 - t3], dim=-2)
    out = pred.to(I32) + ((r + 32) >> 6)
    return out.clamp(0, 255).to(torch.uint8)


def _idct8_pass(m):
    """One 1-D pass of the 8x8 inverse transform along the last axis,
    each op stored int16 (wrap) like the reference's scalar code
    (oracle/intra8.py::_idct8_butterfly)."""
    p = [m[..., k] for k in range(8)]
    W = wrap_i16
    a0 = W(p[0] + p[4])
    a1 = W(p[0] - p[4])
    a2 = W(p[6] - (p[2] >> 1))
    a3 = W(p[2] + (p[6] >> 1))
    b0 = W(a0 + a3)
    b2 = W(a1 - a2)
    b4 = W(a1 + a2)
    b6 = W(a0 - a3)
    a0 = W(-p[3] + p[5] - p[7] - (p[7] >> 1))
    a1 = W(p[1] + p[7] - p[3] - (p[3] >> 1))
    a2 = W(-p[1] + p[7] + p[5] + (p[5] >> 1))
    a3 = W(p[3] + p[5] + p[1] + (p[1] >> 1))
    b1 = W(a0 + (a3 >> 2))
    b3 = W(a1 + (a2 >> 2))
    b5 = W(a2 - (a1 >> 2))
    b7 = W(a3 - (a0 >> 2))
    return torch.stack([W(b0 + b7), W(b2 - b5), W(b4 + b3), W(b6 + b1),
                        W(b6 - b1), W(b4 - b3), W(b2 + b5), W(b0 - b7)], -1)


def idct8x8_add(pred, coef):
    """8x8 inverse transform + add, batched: pred [..., 8, 8] uint8, coef
    [..., 64] or [..., 8, 8] int (dequantised, raster). Bit-exact with
    oracle/intra8.py::idct8x8_add (IdctResAddPred8x8_c, decode_mb_aux.cpp:80:
    int16 intermediates wrap); the row pass, then the column pass."""
    c = coef.to(I32).reshape(*coef.shape[:-1] if coef.shape[-1] == 64
                             else coef.shape[:-2], 8, 8)
    res = _idct8_pass(_idct8_pass(c).transpose(-1, -2)).transpose(-1, -2)
    out = pred.to(I32) + ((32 + res) >> 6)
    return out.clamp(0, 255).to(torch.uint8)


def luma_dc_dequant_ihadamard(dc, qp):
    qp = qp_tensor(qp, dc.device)
    qmul = (_const("dequant", dc.device)[qp.long()][..., 0, 0] << 4).to(I32)
    t = ihadamard4x4(dc)
    if qmul.dim() > 0:
        qmul = qmul[..., None, None]
    return wrap_i16((t * qmul + 32) >> 6)


def chroma_dc_dequant_ihadamard(dc, qp):
    qp = qp_tensor(qp, dc.device)
    qmul = _const("dequant", dc.device)[qp.long()][..., 0, 0]
    t = hadamard2x2(dc)
    if qmul.dim() > 0:
        qmul = qmul[..., None, None]
    return wrap_i16((t * qmul) >> 1)
