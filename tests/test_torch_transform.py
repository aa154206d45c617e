"""Port parity: ops/transform.py and ops/transform_soa.py, torch vs JAX.

Same numpy inputs through both packages; integer outputs must be equal
exactly. Inputs include +-255 residuals everywhere (the largest quant
products) and IDCT inputs large enough to exercise the int16 wrap.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from openh264_tpu.ops import transform as jt
from openh264_tpu.ops import transform_soa as js
from openh264_tpu_torch.ops import transform as tt
from openh264_tpu_torch.ops import transform_soa as ts


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))


def _residuals(rng, shape):
    r = rng.integers(-255, 256, shape).astype(np.int32)
    r[0] = 255                       # extreme blocks: largest products
    r[1] = -255
    return r


def _both(fn_j, fn_t, *args, **kw):
    want = fn_j(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                  for a in args], **kw)
    got = fn_t(*[torch.tensor(a) if isinstance(a, np.ndarray) else a
                 for a in args], **kw)
    _eq(got, want)


AOS_CASES = ["wrap_i16", "dct4x4", "hadamard4x4", "ihadamard4x4",
             "quant4x4_intra", "quant4x4_inter", "quant4x4_per_block_qp",
             "quant_dc", "quant_dc_per_mb_qp", "dequant4x4", "idct4x4_add",
             "luma_dc_dequant_ihadamard", "chroma_dc_dequant_ihadamard"]


@pytest.mark.parametrize("case", AOS_CASES)
def test_aos_matches_jax(case):
    rng = np.random.default_rng(AOS_CASES.index(case))
    res = _residuals(rng, (6, 16, 4, 4))
    coef = np.asarray(jt.dct4x4(jnp.asarray(res)))
    if case == "wrap_i16":
        _both(jt.wrap_i16, tt.wrap_i16,
              rng.integers(-(1 << 20), 1 << 20, (64,)).astype(np.int32))
    elif case == "dct4x4":
        _both(jt.dct4x4, tt.dct4x4, res)
    elif case in ("hadamard4x4", "ihadamard4x4"):
        dcs = coef[..., 0, 0].reshape(-1, 4, 4)
        _both(getattr(jt, case), getattr(tt, case), dcs)
    elif case == "quant4x4_intra":
        for qp in (0, 17, 28, 51):
            _both(jt.quant4x4, tt.quant4x4, coef, qp, True)
    elif case == "quant4x4_inter":
        for qp in (0, 22, 51):
            _both(jt.quant4x4, tt.quant4x4, coef, qp, False)
    elif case == "quant4x4_per_block_qp":
        qp = rng.integers(0, 52, (6, 16)).astype(np.int32)
        _both(jt.quant4x4, tt.quant4x4, coef, qp, False)
    elif case == "quant_dc":
        dcs = np.asarray(jt.hadamard4x4(jnp.asarray(
            coef[..., 0, 0].reshape(-1, 4, 4))))
        for qp, intra in ((0, True), (30, True), (51, False)):
            _both(jt.quant_dc, tt.quant_dc, dcs, qp, intra)
    elif case == "quant_dc_per_mb_qp":
        dcs = coef[..., 0, 0].reshape(-1, 4, 4)
        qp = rng.integers(0, 52, (6,)).astype(np.int32)
        _both(jt.quant_dc, tt.quant_dc, dcs, qp, True)
    elif case == "dequant4x4":
        lev = np.asarray(jt.quant4x4(jnp.asarray(coef), 10, True))
        for qp in (0, 10, 51):
            _both(jt.dequant4x4, tt.dequant4x4, lev, qp)
    elif case == "idct4x4_add":
        pred = rng.integers(0, 256, (6, 16, 4, 4)).astype(np.uint8)
        big = rng.integers(-40000, 40000, (6, 16, 4, 4)).astype(np.int32)
        _both(jt.idct4x4_add, tt.idct4x4_add, pred, big)
        deq = np.asarray(jt.dequant4x4(jt.quant4x4(jnp.asarray(coef), 20,
                                                   False), 20))
        _both(jt.idct4x4_add, tt.idct4x4_add, pred, deq)
    elif case == "luma_dc_dequant_ihadamard":
        dc = rng.integers(-3000, 3000, (6, 4, 4)).astype(np.int32)
        for qp in (0, 26, 51):
            _both(jt.luma_dc_dequant_ihadamard, tt.luma_dc_dequant_ihadamard,
                  dc, qp)
    elif case == "chroma_dc_dequant_ihadamard":
        dc = rng.integers(-3000, 3000, (6, 2, 2)).astype(np.int32)
        for qp in (0, 26, 51):
            _both(jt.chroma_dc_dequant_ihadamard,
                  tt.chroma_dc_dequant_ihadamard, dc, qp)


SOA_CASES = ["dct4x4_soa", "hadamard4x4_soa", "ihadamard4x4_soa",
             "quant4x4_soa", "quant4x4_soa_per_mb_qp", "quant_dc_soa",
             "dequant4x4_soa", "dequant4x4_soa_per_mb_qp", "hadamard2x2_soa",
             "idct4x4_add_soa", "luma_dc_dequant_ihadamard_soa",
             "chroma_dc_dequant_ihadamard_soa"]


@pytest.mark.parametrize("case", SOA_CASES)
def test_soa_matches_jax(case):
    rng = np.random.default_rng(100 + SOA_CASES.index(case))
    N = 24
    res = rng.integers(-255, 256, (4, 4, 16, N)).astype(np.int32)
    res[..., 0] = 255
    res[..., 1] = -255
    coef = np.asarray(js.dct4x4_soa(jnp.asarray(res)))
    qpn = rng.integers(0, 52, (N,)).astype(np.int32)
    if case == "dct4x4_soa":
        _both(js.dct4x4_soa, ts.dct4x4_soa, res)
    elif case in ("hadamard4x4_soa", "ihadamard4x4_soa"):
        _both(getattr(js, case), getattr(ts, case),
              np.ascontiguousarray(coef[0, 0].reshape(4, 4, N)))
    elif case == "quant4x4_soa":
        for qp, intra in ((0, True), (28, False), (51, True)):
            _both(js.quant4x4_soa, ts.quant4x4_soa, coef, qp, intra)
    elif case == "quant4x4_soa_per_mb_qp":
        _both(js.quant4x4_soa, ts.quant4x4_soa, coef, qpn, False)
    elif case == "quant_dc_soa":
        dcs = np.ascontiguousarray(coef[0, 0].reshape(2, 2, 4 * N))
        for qp, intra in ((0, False), (33, True)):
            _both(js.quant_dc_soa, ts.quant_dc_soa, dcs, qp, intra)
    elif case == "dequant4x4_soa":
        lev = np.asarray(js.quant4x4_soa(jnp.asarray(coef), 12, False))
        for qp in (0, 12, 51):
            _both(js.dequant4x4_soa, ts.dequant4x4_soa, lev, qp)
    elif case == "dequant4x4_soa_per_mb_qp":
        lev = np.asarray(js.quant4x4_soa(jnp.asarray(coef), 12, False))
        _both(js.dequant4x4_soa, ts.dequant4x4_soa, lev, qpn)
    elif case == "hadamard2x2_soa":
        _both(js.hadamard2x2_soa, ts.hadamard2x2_soa,
              rng.integers(-5000, 5000, (2, 2, N)).astype(np.int32))
    elif case == "idct4x4_add_soa":
        pred = rng.integers(0, 256, (4, 4, 16, N)).astype(np.int32)
        big = rng.integers(-40000, 40000, (4, 4, 16, N)).astype(np.int32)
        _both(js.idct4x4_add_soa, ts.idct4x4_add_soa, pred, big)
    elif case == "luma_dc_dequant_ihadamard_soa":
        dc = rng.integers(-3000, 3000, (4, 4, N)).astype(np.int32)
        _both(js.luma_dc_dequant_ihadamard_soa,
              ts.luma_dc_dequant_ihadamard_soa, dc, 30)
        _both(js.luma_dc_dequant_ihadamard_soa,
              ts.luma_dc_dequant_ihadamard_soa, dc, qpn)
    elif case == "chroma_dc_dequant_ihadamard_soa":
        dc = rng.integers(-3000, 3000, (2, 2, N)).astype(np.int32)
        _both(js.chroma_dc_dequant_ihadamard_soa,
              ts.chroma_dc_dequant_ihadamard_soa, dc, 45)
        _both(js.chroma_dc_dequant_ihadamard_soa,
              ts.chroma_dc_dequant_ihadamard_soa, dc, qpn)
