"""Port parity of the decoder's intra layer for the 8x8 transform, byte for
byte (tolerance 0), on the CPU:
- oracle/intra8.py (copied): predict_8x8 in all 9 modes under every
  availability pattern, and idct8x8_add, against the JAX package's
  openh264_tpu.oracle.intra8 on seeded samples and coefficients;
- oracle/intra.py (copied): predict_4x4, predict_16x16 and
  predict_chroma against openh264_tpu.oracle.intra;
- ops/transform.py::idct8x8_add, the batched torch 8x8 inverse
  transform of the inter recon, against the oracle on seeded int32
  coefficients, values that wrap int16 included;
- decoder/recon_oracle.py::recon_intra_mb, the per-MB Python intra
  recon of a picture with I8x8 MBs, against the JAX recon_oracle on
  seeded FrameSymbols of I8x8, I4x4, I16x16 and IPCM MBs in two slices;
- the host C intra recon (cbind.recon_intra_mbs_native), which takes
  I8x8 MBs too, against that Python recon on the same symbols, every
  8x8 mode at every neighbour pattern of a picture's and a slice's
  edges.
"""

import itertools

import numpy as np
import pytest
import torch

from openh264_tpu.decoder import recon_oracle as jro
from openh264_tpu.decoder.framedata import FrameSymbols as JFS
from openh264_tpu.oracle import intra as jintra
from openh264_tpu.oracle import intra8 as jintra8
from openh264_tpu_torch.decoder import recon_oracle as tro
from openh264_tpu_torch.decoder.framedata import FrameSymbols as TFS
from openh264_tpu_torch.ops.transform import idct8x8_add
from openh264_tpu_torch.oracle import intra as tintra
from openh264_tpu_torch.oracle import intra8 as tintra8

AVAIL = list(itertools.product((False, True), repeat=4))


@pytest.mark.parametrize("mode", range(9))
def test_predict_8x8_matches_jax(mode):
    """Every availability pattern of top, left, top-left, top-right, on
    seeded samples (the top row's right half random even where the
    top-right is missing, which the filter must ignore)."""
    rng = np.random.default_rng(mode)
    for at, al, atl, atr in AVAIL:
        for _ in range(3):
            top = rng.integers(0, 256, 16).astype(np.int32)
            left = rng.integers(0, 256, 8).astype(np.int32)
            tl = int(rng.integers(0, 256))
            args = (mode, top, left, tl, at, al, atl, atr)
            np.testing.assert_array_equal(tintra8.predict_8x8(*args),
                                          jintra8.predict_8x8(*args))


@pytest.mark.parametrize("kind", ["4x4", "16x16", "chroma"])
def test_intra_predictors_match_jax(kind):
    """The copied 4x4, 16x16 and chroma predictors, every mode under every
    availability pattern the mode can take."""
    rng = np.random.default_rng(len(kind))
    n, modes = {"4x4": (8, 9), "16x16": (16, 4), "chroma": (8, 4)}[kind]
    for mode in range(modes):
        for at, al, atl, atr in AVAIL:
            if kind != "4x4" and ((mode in (0, 3) and not at) or
                                  (mode in (1, 3) and not al)):
                continue            # 16x16 / chroma: the mode's neighbours
            top = rng.integers(0, 256, n).astype(np.int32)
            left = rng.integers(0, 256, n if kind != "4x4" else 4)
            tl = int(rng.integers(0, 256))
            if kind == "4x4":
                args = (mode, top, left, tl, at, al, atl, atr)
                fn = "predict_4x4"
            else:
                m = mode if kind == "16x16" else (2, 1, 0, 3)[mode]
                args = (m, top, left, tl, at, al)
                fn = "predict_16x16" if kind == "16x16" else "predict_chroma"
            np.testing.assert_array_equal(getattr(tintra, fn)(*args),
                                          getattr(jintra, fn)(*args))


@pytest.mark.parametrize("scale", [40, 3000, 1 << 16, 1 << 30])
def test_idct8x8_matches_jax(scale):
    """The copied oracle and the torch batch against the JAX oracle, with
    coefficients up to `scale`: from a residual's size to values whose
    sums wrap int16 (the reference's int16 intermediates) and int32."""
    rng = np.random.default_rng(scale % 97)
    n = 64
    pred = rng.integers(0, 256, (n, 8, 8)).astype(np.uint8)
    coef = rng.integers(-scale, scale, (n, 64)).astype(np.int32)
    coef[rng.random((n, 64)) < 0.5] = 0
    want = np.stack([jintra8.idct8x8_add(p, c) for p, c in zip(pred, coef)])
    got = np.stack([tintra8.idct8x8_add(p, c) for p, c in zip(pred, coef)])
    np.testing.assert_array_equal(got, want)
    batch = idct8x8_add(torch.from_numpy(pred), torch.from_numpy(coef))
    assert batch.dtype == torch.uint8 and batch.shape == (n, 8, 8)
    np.testing.assert_array_equal(batch.numpy(), want)
    # [..., 8, 8] coefficients and extra leading axes give the same
    np.testing.assert_array_equal(
        idct8x8_add(torch.from_numpy(pred).view(4, 16, 8, 8),
                    torch.from_numpy(coef).view(4, 16, 8, 8)).numpy(),
        want.reshape(4, 16, 8, 8))


def _intra_symbols(seed, fs_cls):
    """6x4 MBs in two slices (rows 0-1, 2-3): I8x8, I4x4, I16x16 and IPCM
    MBs, random modes (DC where a 16x16 or chroma mode would need a
    missing neighbour), random dequantized coefficients."""
    rng = np.random.default_rng(seed)
    fs = fs_cls(6, 4)
    n = fs.n_mb
    fs.mb_type[:] = rng.choice([3, 0, 1, 2], n, p=[0.5, 0.2, 0.2, 0.1])
    fs.slice_id[:] = np.repeat([0, 1], n // 2)
    fs.transform8[:] = fs.mb_type == 3
    mbx, mby = np.arange(n) % 6, np.arange(n) // 6
    edge = (mbx == 0) | (mby % 2 == 0)           # a neighbour missing
    fs.i4_modes[:] = rng.integers(0, 9, (n, 16))
    fs.i16_mode[:] = np.where(edge, 2, rng.integers(0, 4, n))
    fs.chroma_mode[:] = np.where(edge, 0, rng.integers(0, 4, n))
    fs.coeffs_l[:] = rng.integers(-60, 61, (n, 16, 16)) * \
        (rng.random((n, 16, 16)) < 0.2)
    fs.coeffs_c[:] = rng.integers(-40, 41, (n, 2, 4, 16)) * \
        (rng.random((n, 2, 4, 16)) < 0.3)
    fs.ensure_coeffs8()
    fs.coeffs8[:] = rng.integers(-200, 201, (n, 4, 64)) * \
        (rng.random((n, 4, 64)) < 0.15)
    for idx in np.nonzero(fs.mb_type == 2)[0]:
        fs.ipcm[int(idx)] = (rng.integers(0, 256, (16, 16), np.uint8),
                             rng.integers(0, 256, (8, 8), np.uint8),
                             rng.integers(0, 256, (8, 8), np.uint8))
    return fs


@pytest.mark.parametrize("seed,constrained", [(0, False), (1, False),
                                              (2, True)])
def test_recon_intra_mb_matches_jax(seed, constrained):
    """Raster-order recon of every MB into the same seeded planes (the
    inter samples an intra MB reads around it)."""
    rng = np.random.default_rng(100 + seed)
    planes = [rng.integers(0, 256, s, np.uint8)
              for s in ((64, 96), (32, 48), (32, 48))]
    jfs = _intra_symbols(seed, JFS)
    assert (jfs.mb_type == 3).any() and (jfs.mb_type == 0).any()
    st = jro.ReconState(jfs)
    st.y, st.u, st.v = (p.copy() for p in planes)
    hp = tro.HostPlanes(_intra_symbols(seed, TFS),
                        *(p.copy() for p in planes))
    for idx in range(jfs.n_mb):
        jro.recon_intra_mb(st, idx, constrained)
        tro.recon_intra_mb(hp, idx, constrained)
    for c in "yuv":
        np.testing.assert_array_equal(getattr(hp, c), getattr(st, c))
    assert not np.array_equal(hp.y, planes[0])


@pytest.mark.parametrize("seed,constrained", [(0, False), (1, False),
                                              (2, True), (3, False)])
def test_native_intra_recon_with_i8x8_matches_python(seed, constrained):
    """The host C recon of every intra MB, I8x8 included, equals the
    per-MB Python recon, into the same seeded planes."""
    from openh264_tpu_torch.decoder.cbind import recon_intra_mbs_native
    rng = np.random.default_rng(200 + seed)
    planes = [rng.integers(0, 256, s, np.uint8)
              for s in ((64, 96), (32, 48), (32, 48))]
    fs = _intra_symbols(seed, TFS)
    assert (fs.mb_type == 3).any()
    hp = tro.HostPlanes(fs, *(p.copy() for p in planes))
    for idx in range(fs.n_mb):
        tro.recon_intra_mb(hp, idx, constrained)
    got = [p.copy() for p in planes]
    recon_intra_mbs_native(*got, fs, np.arange(fs.n_mb), constrained)
    for g, w in zip(got, (hp.y, hp.u, hp.v)):
        np.testing.assert_array_equal(g, w)
