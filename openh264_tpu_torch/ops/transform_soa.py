"""Structure-of-arrays 4x4 transforms: coefficients leading, batch last.

Port of openh264_tpu/ops/transform_soa.py. Layout [4, 4, ..., N]: the
4x4 spatial axes lead and the batch (all blocks of a frame) trails.
Butterflies are written out; int32 throughout (the JAX int32 products
stay below 2**31 for +-255 residuals, see ops/transform.py).
"""

from __future__ import annotations

import torch

from ..device import constant_cache
from ..tables import DEQUANT_4x4, QUANT_MF_4x4
from .transform import I32, qp_tensor, wrap_i16

_const = constant_cache({
    "dequant": DEQUANT_4x4.reshape(52, 4, 4),
    "quant_mf": QUANT_MF_4x4.reshape(52, 4, 4),
})


def _fwd_butterfly(x0, x1, x2, x3):
    t0 = x0 + x3
    t1 = x1 + x2
    t2 = x1 - x2
    t3 = x0 - x3
    return t0 + t1, 2 * t3 + t2, t0 - t1, t3 - 2 * t2


def dct4x4_soa(x):
    """x: [4, 4, ...] int32 residual; returns coef [4, 4, ...]."""
    x = x.to(I32)
    v = torch.stack(_fwd_butterfly(x[0], x[1], x[2], x[3]), 0)   # vertical
    return torch.stack(_fwd_butterfly(v[:, 0], v[:, 1], v[:, 2], v[:, 3]),
                       1)                                      # horizontal


def _had_bf(a0, a1, a2, a3):
    t0, t1, t2, t3 = a0 + a3, a1 + a2, a1 - a2, a0 - a3
    return t0 + t1, t3 + t2, t0 - t1, t3 - t2


def hadamard4x4_soa(x):
    """(H @ x @ H.T + 1) >> 1 on [4, 4, ...]."""
    x = x.to(I32)
    v = torch.stack(_had_bf(x[0], x[1], x[2], x[3]), 0)
    h = torch.stack(_had_bf(v[:, 0], v[:, 1], v[:, 2], v[:, 3]), 1)
    return (h + 1) >> 1


def ihadamard4x4_soa(x):
    x = x.to(I32)

    def bf(a0, a1, a2, a3):
        t0, t1, t2, t3 = a0 + a2, a0 - a2, a1 - a3, a1 + a3
        return t0 + t3, t1 + t2, t1 - t2, t0 - t3

    v = torch.stack(bf(x[0], x[1], x[2], x[3]), 0)
    return torch.stack(bf(v[:, 0], v[:, 1], v[:, 2], v[:, 3]), 1)


def _qp_tables(qp, name, ndim, device):
    """table[qp] broadcastable against a [4, 4, ...] operand of rank
    `ndim`: qp scalar -> [4,4,1,..]; qp [N] (per-MB, trailing axis) ->
    [4,4,1,..,N]."""
    t = _const(name, device)[qp.long()]
    if t.dim() == 2:
        return t.reshape((4, 4) + (1,) * (ndim - 2))
    return torch.movedim(t, 0, -1).reshape(
        (4, 4) + (1,) * (ndim - 3) + (-1,))


def quant4x4_soa(coef, qp, intra: bool):
    """coef: [4, 4, ...]; qp scalar or [N] matching the trailing axis."""
    qp = qp_tensor(qp, coef.device)
    qbits = 15 + torch.div(qp, 6, rounding_mode="floor")
    f = torch.div(torch.ones_like(qbits) << qbits, 3 if intra else 6,
                  rounding_mode="floor")
    mf = _qp_tables(qp, "quant_mf", coef.dim(), coef.device)
    if qp.dim():
        bshape = (1, 1) + (1,) * (coef.dim() - 3) + (-1,)
        f = f.reshape(bshape)
        qbits = qbits.reshape(bshape)
    c = coef.to(I32)
    lev = (c.abs() * mf + f) >> qbits
    return torch.sign(c) * lev


def quant_dc_soa(coef, qp, intra: bool):
    """coef: [...] (DC grid, e.g. [4,4,N] luma or [2,2,N] chroma)."""
    qp = qp_tensor(qp, coef.device)
    qbits = 15 + torch.div(qp, 6, rounding_mode="floor")
    f = 2 * torch.div(torch.ones_like(qbits) << qbits, 3 if intra else 6,
                      rounding_mode="floor")
    mf = _const("quant_mf", coef.device)[qp.long()][..., 0, 0]
    c = coef.to(I32)
    lev = (c.abs() * mf + f) >> (qbits + 1)
    return torch.sign(c) * lev


def dequant4x4_soa(level, qp):
    qp = qp_tensor(qp, level.device)
    return level.to(I32) * _qp_tables(qp, "dequant", level.dim(),
                                      level.device)


def hadamard2x2_soa(x):
    """H2 @ x @ H2.T on [2, 2, ...]."""
    d = x.to(I32)
    v0, v1 = d[0] + d[1], d[0] - d[1]
    return torch.stack([torch.stack([v0[0] + v0[1], v0[0] - v0[1]], 0),
                        torch.stack([v1[0] + v1[1], v1[0] - v1[1]], 0)], 0)


def idct4x4_add_soa(pred, coef):
    """pred: [4,4,...] int, coef: [4,4,...] int32 dequantized; returns
    uint8-range int32 recon [4,4,...]."""
    c = coef.to(I32)

    def bf_i(a0, a1, a2, a3):
        t0 = a0 + a2
        t1 = a0 - a2
        t2 = (a1 >> 1) - a3
        t3 = a1 + (a3 >> 1)
        return t0 + t3, t1 + t2, t1 - t2, t0 - t3

    h = torch.stack(bf_i(c[:, 0], c[:, 1], c[:, 2], c[:, 3]), 1)
    h = wrap_i16(h)
    r = torch.stack(bf_i(h[0], h[1], h[2], h[3]), 0)
    out = pred.to(I32) + ((r + 32) >> 6)
    return out.clamp(0, 255)


def luma_dc_dequant_ihadamard_soa(dc, qp):
    """dc: [4,4,...]."""
    qp = qp_tensor(qp, dc.device)
    qmul = (_const("dequant", dc.device)[qp.long()][..., 0, 0] << 4).to(I32)
    t = ihadamard4x4_soa(dc)
    return wrap_i16((t * qmul + 32) >> 6)


def chroma_dc_dequant_ihadamard_soa(dc, qp):
    """dc: [2,2,...]."""
    qp = qp_tensor(qp, dc.device)
    qmul = _const("dequant", dc.device)[qp.long()][..., 0, 0]
    return wrap_i16((hadamard2x2_soa(dc) * qmul) >> 1)
